"""SO(3) machinery: real spherical harmonics, Clebsch-Gordan coefficients,
Wigner-D matrices: the substrate for NequIP (E(3) tensor products, l<=2)
and EquiformerV2 (eSCN SO(2) convolutions, l<=6).

The counterpart of ``repro.models.gnn.so3``.  Conventions: real spherical
harmonics WITHOUT the Condon-Shortley phase, flattened irrep index
``idx(l, m) = l*l + l + m``; the l=1 basis is then exactly proportional to
(y, z, x).

Coupling coefficients are *solved numerically* on the host (float64) from
the defining intertwiner equation ``(D1 (x) D2) W = W D3`` using Wigner-D
matrices extracted from the spherical harmonics themselves (least squares
over random directions).  The solver (``_rand_rot``, ``_wigner_np``,
``real_cg``, ``_cg_stack_matrix``) is JAX's code with JAX's seeds, numpy
float64 throughout, so its tables are bit-equal to JAX's.  SO(3)
multiplicity is 1, so W is unique up to sign/scale; it is normalized to
unit Frobenius norm with a deterministic sign.

``sph_harm``, ``wigner_d_from_rot`` and ``rot_to_align_z`` run on tensors
(differentiable, on the device); ``sph_harm(..., xp=np)`` is the solver's
float64 host form.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch


def n_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def sph_harm(l_max: int, vecs, xp=torch):
    """Real spherical harmonics for unit vectors.

    vecs: (..., 3) -> (..., (l_max+1)^2).  Evaluated in Cartesian form (no
    trig): A_m + i B_m = (x + i y)^m and the semi-normalized associated
    Legendre recurrence in z, so poles are exact.  ``xp=np`` runs the same
    computation on the host in float64 (used by the coefficient solver).
    """
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    if xp is torch:
        def full(v):
            return torch.full_like(z, v)

        def stack(ys):
            return torch.stack(ys, dim=-1)
    else:
        def full(v):
            return xp.full(z.shape, v, getattr(z, "dtype", None))

        def stack(ys):
            return xp.stack(ys, axis=-1)

    # A_m = Re (x+iy)^m, B_m = Im (x+iy)^m  (pure polynomials in x, y)
    A = [xp.ones_like(z), x]
    B = [xp.zeros_like(z), y]
    for m in range(2, l_max + 1):
        A.append(A[m - 1] * x - B[m - 1] * y)
        B.append(B[m - 1] * x + A[m - 1] * y)

    # shat[(l, m)] = P_l^m(z) / (1-z^2)^(m/2) (no Condon-Shortley phase)
    shat: dict[tuple[int, int], object] = {}
    for m in range(0, l_max + 1):
        mm = 1.0
        for k in range(1, m + 1):
            mm *= 2 * k - 1  # (2m-1)!!
        shat[(m, m)] = full(mm)
        if m + 1 <= l_max:
            shat[(m + 1, m)] = z * (2 * m + 1) * shat[(m, m)]
        for l in range(m + 2, l_max + 1):
            shat[(l, m)] = (
                (2 * l - 1) * z * shat[(l - 1, m)] - (l + m - 1) * shat[(l - 2, m)]
            ) / (l - m)

    ys = []
    for l in range(0, l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            nlm = sqrt(
                (2 * l + 1) / (4 * np.pi) * factorial(l - am) / factorial(l + am)
            )
            if m > 0:
                val = sqrt(2.0) * nlm * shat[(l, am)] * A[am]
            elif m < 0:
                val = sqrt(2.0) * nlm * shat[(l, am)] * B[am]
            else:
                val = nlm * shat[(l, 0)]
            ys.append(val)
    return stack(ys)


# --------------------------------------------------- host-side coefficients


def _rand_rot(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _wigner_np(l: int, R: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """D^l(R) extracted from the SH themselves: Y_l(Rv) = D Y_l(v) solved in
    least squares over random directions (exact up to float64 rounding)."""
    k = 4 * l + 12
    v = rng.normal(size=(k, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sl = slice(l * l, (l + 1) * (l + 1))
    Y0 = sph_harm(l, v, xp=np)[:, sl]
    YR = sph_harm(l, v @ R.T, xp=np)[:, sl]
    Dt, *_ = np.linalg.lstsq(Y0, YR, rcond=None)
    return Dt.T


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor W (2l1+1, 2l2+1, 2l3+1) with
    (D1 (x) D2) W = W D3, solved from the intertwiner null space."""
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((d1, d2, d3))
    rng = np.random.default_rng(1234 + 97 * l1 + 13 * l2 + l3)
    rows = []
    for _ in range(3):
        R = _rand_rot(rng)
        D1 = _wigner_np(l1, R, rng)
        D2 = _wigner_np(l2, R, rng)
        D3 = _wigner_np(l3, R, rng)
        # textbook intertwiner in matrix form (rows (a,b), cols c):
        #   (D1 (x) D2) M = M D3
        # which gives the contraction property the models rely on:
        #   einsum('abc,a,b->c', W, D1 x, D2 y) = D3 einsum('abc,a,b->c', W, x, y)
        A = np.kron(np.kron(D1, D2), np.eye(d3)) - np.kron(np.eye(d1 * d2), D3.T)
        rows.append(A)
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    w = vt[-1]
    assert s[-1] < 1e-8 and (len(s) < 2 or s[-2] > 1e-4), (
        f"CG({l1},{l2},{l3}): unexpected intertwiner spectrum {s[-3:]}"
    )
    W = w.reshape(d1, d2, d3)
    W /= np.linalg.norm(W)
    # deterministic sign: first entry with |.| > 1e-6 positive
    flat = W.reshape(-1)
    idx = np.argmax(np.abs(flat) > 1e-6)
    if flat[idx] < 0:
        W = -W
    return W


@lru_cache(maxsize=None)
def _cg_stack_matrix(l: int) -> np.ndarray:
    """Isometry C: ((2l-1)*3, 2l+1) mapping (l-1) (x) 1 -> l, columns
    orthonormalized (used by the Wigner-D recursion).  W^T W = c I by Schur,
    so normalizing one global scale suffices."""
    W = real_cg(l - 1, 1, l).reshape((2 * l - 1) * 3, 2 * l + 1)
    return W / np.linalg.norm(W[:, 0])


def wigner_d_from_rot(l_max: int, R: torch.Tensor) -> list[torch.Tensor]:
    """Real Wigner-D matrices for rotation matrices R (..., 3, 3).

    Returns [D^0, ..., D^l_max], D^l of shape (..., 2l+1, 2l+1), via the CG
    recursion D^l = C^T (D^{l-1} (x) D^1) C.  D^1 is R conjugated into the
    real-SH (y, z, x) ordering.  Tensors on R's device, differentiable.
    JAX contracts ``C^T kron C`` with one ``einsum`` (whose pairing XLA
    chooses); here it is ``(C^T @ kron) @ C``, equal to rounding.
    """
    batch = R.shape[:-2]
    perm = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
    Pm = torch.as_tensor(perm, dtype=R.dtype, device=R.device)
    D1 = Pm @ R @ Pm.T  # a permutation of R's entries: exact
    Ds = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device), D1]
    for l in range(2, l_max + 1):
        C = torch.as_tensor(_cg_stack_matrix(l), dtype=R.dtype, device=R.device)
        prev = Ds[l - 1]
        kron = torch.einsum("...ab,...cd->...acbd", prev, D1).reshape(
            batch + ((2 * l - 1) * 3, (2 * l - 1) * 3)
        )
        Ds.append((C.T @ kron) @ C)
    return Ds


def rot_to_align_z(vec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation R (..., 3, 3) with R @ v_hat = z_hat, deterministic frame.
    A zero vector gives R = 0 (and every D^l, l >= 1, from it 0), as JAX's."""
    v = vec / torch.clamp(torch.linalg.vector_norm(vec, dim=-1, keepdim=True), min=eps)
    x_hat = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    y_hat = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device)
    ref = torch.where(torch.abs(v[..., 0:1]) < 0.9, x_hat.expand(v.shape),
                      y_hat.expand(v.shape))
    b = torch.linalg.cross(v, ref, dim=-1)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=eps)
    c = torch.linalg.cross(v, b, dim=-1)
    return torch.stack([b, c, v], dim=-2)  # rows: (x', y', z'=v)
