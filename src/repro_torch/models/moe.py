"""Mixture-of-Experts FFN with sort-based capacity-bounded dispatch.

The counterpart of ``repro.models.moe``: top-k routing (mixtral 8 experts
top-2, dbrx 16 top-4), then one of two paths:

* ``_forward_local``, with no mesh: sort the (token, choice) pairs by
  expert, scatter them into capacity buffers, run one batched GLU over the
  expert axis, gather back;
* ``_forward_sharded``, which ``forward`` takes when a ``("data",
  "model")`` ``ProcessMesh`` is active (``sharding.set_mesh``): JAX's
  shard_map body on this rank.  The rank's tokens are dispatched locally
  (capacity sized on the local token count), the expert weights,
  ``gate``/``up`` ``P(None, "data", "model")`` and ``down`` ``P(None,
  "model", "data")``, are all-gathered over ``data`` on use (int8 on the
  wire with ``quantized_gather``), each expert runs tensor-parallel over
  ``model`` (d_ff sharded), the row-parallel output is psum'd over
  ``model`` and the aux loss pmean'd over the mesh.  A rank passes its
  block of the flattened tokens (``sharding.token_spec``: split over the
  data-parallel axes when they divide the token count, else the whole
  stream on every rank, JAX's branch for small decode batches) and gets
  its block of the output.  In a sharded trace the tokens and weights are
DTensors, entered by JAX's in-specs, and the output leaves as one.

JAX's idioms, mapped: ``lax.top_k`` keeps the lower index first among
equal probabilities, and ``torch.topk`` promises no order for ties, so the
top k are the first k of a stable descending sort; ``xe.at[e, slot].set(...,
mode="drop")`` is a scatter into a ``cap + 1`` buffer whose last row is the
drop row; ``zeros.at[order].set`` a scatter by the permutation.  Every
scatter is out of place, so gradients flow as JAX's autodiff gives them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers, sharding
from repro_torch.models.sharding import P


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # quantize the FSDP use-gather of expert weights to int8 (a scale an
    # expert), halving the sharded path's dominant collective
    quantized_gather: bool = False


def init(gen: torch.Generator, cfg: MoEConfig, dtype, device="cuda", lead: tuple = ()) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lim = 1.0 / math.sqrt(d)

    def uniform(shape):
        return torch.empty((*lead, *shape), dtype=dtype, device=device).uniform_(
            -lim, lim, generator=gen)

    return {
        "router": layers.dense_init(gen, d, E, torch.float32, device=device, lead=lead),
        "up": uniform((E, d, f)),
        "gate": uniform((E, d, f)),
        "down": uniform((E, f, d)).mul_((d / f) ** 0.5),
    }


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, cfg: MoEConfig, xt):
    """Router: top-k gates + aux loss terms.  xt (n, d)."""
    E, k = cfg.n_experts, cfg.top_k
    logits = layers.dense(p["router"], xt.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    # one-hot by comparison, as jax.nn.one_hot computes it: F.one_hot reads
    # the indices' range on the host, a sync on the card
    hot = gate_idx[..., None] == torch.arange(E, device=gate_idx.device)
    fe = torch.mean(hot.to(torch.float32).sum(dim=1), dim=0)
    aux = E * torch.sum(me * fe)
    return gate_vals, gate_idx.to(torch.int32), aux


def capacity(cfg: MoEConfig, n: int) -> int:
    """Slots an expert for ``n`` tokens (JAX's Python float expression)."""
    return int(cfg.capacity_factor * cfg.top_k * n / cfg.n_experts + 1)


def _dispatch_compute_combine(cfg: MoEConfig, xt, gate_vals, gate_idx, w_gate, w_up, w_down):
    """Sort-dispatch n tokens into (E, cap, d) buffers, run the batched GLU,
    combine."""
    n, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, n)

    flat_e = gate_idx.reshape(-1).to(torch.int64)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device))
    pos = torch.arange(n * k, device=xt.device) - starts[sorted_e]
    keep = pos < cap
    tok = torch.div(order, k, rounding_mode="floor")

    slot = torch.where(keep, pos, cap)  # row cap is the drop row
    xe = xt.new_zeros((E, cap + 1, d)).index_put((sorted_e, slot), xt[tok])[:, :cap]

    h = F.silu(xe @ w_gate) * (xe @ w_up)
    ye = h @ w_down  # (E, cap, d)

    y_sorted = torch.where(keep[:, None], ye[sorted_e, torch.clamp(pos, 0, cap - 1)], 0)
    y = torch.zeros_like(y_sorted).index_copy(0, order, y_sorted)
    return torch.sum(y.reshape(n, k, d) * gate_vals[..., None].to(xt.dtype), dim=1)


def _forward_local(p, cfg: MoEConfig, x):
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gate_vals, gate_idx, aux = _route(p, cfg, xt)
    out = _dispatch_compute_combine(cfg, xt, gate_vals, gate_idx, p["gate"], p["up"], p["down"])
    return out.reshape(b, s, d), aux


_RECIP_127 = float(torch.tensor(1.0) / 127.0)  # fp32 1/127, as a double
_EPS = float(torch.tensor(1e-12))  # fp32 1e-12, as a double


def quantize(w: torch.Tensor, axes):
    """int8 values and the fp32 scale (one an index of the other axes) of
    JAX's wire format, ``max|w| / 127 + 1e-12``, rounded as XLA compiles it:
    one fused multiply-add of the fp32 reciprocal of 127 (in float64, where
    the product is exact, then rounded once to fp32)."""
    amax = torch.amax(w.abs(), dim=axes, keepdim=True).to(torch.float64)
    scale = (amax * _RECIP_127 + _EPS).to(torch.float32)
    q = torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return q, scale


def fsdp_gather(w: torch.Tensor, axis: int, quantized: bool) -> torch.Tensor:
    """The FSDP use-gather of an expert weight's blocks over ``data`` along
    ``axis``; with ``quantized``, int8 on the wire, and (as in JAX) every
    block gathered dequantized with this rank's scales."""
    if not quantized:
        return sharding.all_gather(w, "data", axis=axis)
    q, scale = quantize(w, (1, 2))
    return (sharding.all_gather(q, "data", axis=axis).to(torch.float32) * scale).to(w.dtype)


# the expert weights' in-specs: d_ff over ``model``, d_model over ``data``
SHARDED_SPECS = {"gate": P(None, "data", "model"), "up": P(None, "data", "model"),
                 "down": P(None, "model", "data")}


def _forward_sharded(p, cfg: MoEConfig, x, with_aux: bool = True):
    """JAX's shard_map body on this rank: ``x`` (..., d) the rank's tokens,
    ``p`` its blocks of the weights (``router`` whole).  In a sharded trace
    ``x`` and ``p`` are DTensors, entered by JAX's in-specs, and ``y``
    leaves as one."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    tok = sharding.token_spec(xt.shape[0], sharding.current_mesh())[0]
    xt = sharding.enter(xt, P(tok, None))
    p = {"router": {k: sharding.enter(v, P()) for k, v in p["router"].items()},
         **{k: sharding.enter(p[k], SHARDED_SPECS[k]) for k in ("gate", "up", "down")}}
    q = cfg.quantized_gather
    gate_vals, gate_idx, aux = _route(p, cfg, xt)
    y_partial = _dispatch_compute_combine(
        cfg, xt, gate_vals, gate_idx, fsdp_gather(p["gate"], 1, q), fsdp_gather(p["up"], 1, q),
        fsdp_gather(p["down"], 2, q))
    # row-parallel combine over the d_ff shards
    y = sharding.psum(y_partial, "model")
    if with_aux:
        aux = sharding.leave(sharding.pmean(aux, sharding.active_axes()), P())
    return sharding.leave(y, P(tok, None)).reshape(x.shape), aux if with_aux else None


def forward(p, cfg: MoEConfig, x, with_aux: bool = True):
    """x: (B, S, d) -> ((B, S, d), aux_loss).  Takes the sharded path when a
    ``("data", "model")`` mesh is active, where ``with_aux=False`` skips the
    aux loss's pmean (None in its place), as XLA drops a collective whose
    result is unused."""
    if sharding.arms_active():
        return _forward_sharded(p, cfg, x, with_aux)
    return _forward_local(p, cfg, x)
