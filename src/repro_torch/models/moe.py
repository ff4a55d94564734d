"""Mixture-of-Experts FFN with sort-based capacity-bounded dispatch.

The counterpart of ``repro.models.moe``: top-k routing (mixtral 8 experts
top-2, dbrx 16 top-4), then the single-device path, ``_forward_local``:
sort the (token, choice) pairs by expert, scatter them into capacity
buffers, run one batched GLU over the expert axis, gather back.  The port
has no mesh, so ``forward`` always takes it; JAX's ``_forward_sharded``
(local dispatch on each data shard, FSDP gathers, a psum over ``model``)
waits for more than one card (``cfg.moe_quant_gather`` acts only there).

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

from repro_torch.models import layers


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


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


def forward(p, cfg: MoEConfig, x):
    """x: (B, S, d) -> ((B, S, d), aux_loss)."""
    return _forward_local(p, cfg, x)
