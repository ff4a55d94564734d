"""AdamW — fp32 moments over parameters of any float dtype.

The counterpart of ``repro.train.optimizer``, with JAX's arithmetic in
JAX's order: the global norm summed leaf by leaf in leaf order, the clip
scale ``min(1, clip / (gnorm + 1e-12))``, the step an int32 tensor on the
device and the bias corrections ``1 - b**t`` in fp32 there, then ``m``,
``v``, ``mhat / (sqrt(vhat) + eps)``, ``+ wd * p`` and ``p - lr * delta``,
each operation rounded to fp32 on its own as an op-by-op JAX run rounds it
(``torch.optim.AdamW`` folds the corrections and the decay in another
order).  Nothing here syncs with the host.

``update`` works in place, as JAX's donated buffers would: the returned
params, ``m`` and ``v`` are the tensors that came in, overwritten.  A leaf
is updated in slices of ``CHUNK`` elements, so the temporaries of the
chain stay small beside a 5.37 GB embedding table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.sharding import P
from repro_torch.train.tree import leaves, tree_map

CHUNK = 1 << 24  # elements a slice of a leaf (64 MB of fp32)


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32[]
    m: Any  # pytree like params, fp32
    v: Any


def _slices(n: int):
    return ((s, min(s + CHUNK, n)) for s in range(0, n, CHUNK))


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    """``sum(g * g)`` in fp32, a slice at a time (one sum under ``CHUNK``)."""
    flat = g.reshape(-1)
    total = None
    for s, e in _slices(flat.numel()):
        x = flat[s:e].to(torch.float32)
        part = torch.sum(x * x)
        total = part if total is None else total + part
    return total if total is not None else torch.zeros((), device=g.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0

    def init(self, params) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        device = leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                          v=tree_map(torch.clone, zeros))

    def state_specs(self, param_specs) -> AdamWState:
        """The optimizer state's partition specs: the moments are laid out
        as the params (``param_specs``), the step whole."""
        return AdamWState(step=P(), m=param_specs, v=tree_map(lambda s: s, param_specs))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """-> (params', state', gnorm); params, m and v are updated in place."""
        gs = leaves(grads)
        if self.grad_clip is not None:
            sq = None
            for g in gs:
                s = self._leaf_sq(g)
                sq = s if sq is None else sq + s
            gnorm = torch.sqrt(sq)
            limit = torch.full_like(gnorm, self.grad_clip)
            scale = torch.clamp_max(limit / (gnorm + 1e-12), 1.0)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
            scale = None
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t
        for g, m, v, p in zip(gs, leaves(state.m), leaves(state.v), leaves(params),
                              strict=True):
            self._update_leaf(g, m, v, p, scale, c1, c2)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm

    def _leaf_sq(self, g: torch.Tensor) -> torch.Tensor:
        """A leaf's share of the squared gradient norm."""
        return _sum_sq(g)

    def _update_leaf(self, g, m, v, p, scale, c1, c2) -> None:
        gf, mf, vf, pf = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
        for s, e in _slices(pf.numel()):
            gc = gf[s:e].to(torch.float32)
            if scale is not None:
                gc = gc * scale
            mc = self.b1 * mf[s:e] + (1 - self.b1) * gc
            vc = self.b2 * vf[s:e] + (1 - self.b2) * gc * gc
            delta = (mc / c1) / (torch.sqrt(vc / c2) + self.eps)
            p32 = pf[s:e].to(torch.float32)
            if self.weight_decay:
                delta = delta + self.weight_decay * p32
            pf[s:e] = (p32 - self.lr * delta).to(p.dtype)
            mf[s:e] = mc
            vf[s:e] = vc
