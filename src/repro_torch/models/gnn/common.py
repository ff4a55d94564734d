"""Shared GNN substrate: graph batches, segment ops, message passing.

The counterpart of ``repro.models.gnn.common``.  JAX aggregates with
``jax.ops.segment_sum``/``segment_max`` over an edge-index scatter; here a
segment sum is ``index_add`` into zeros, out of place so that autograd
sees it, and a segment max ``scatter_reduce(..., "amax",
include_self=False)``.  Neither adds in JAX's order (and on the card
``index_add`` is atomic, in no fixed order), so sums agree with JAX's to
fp32 rounding, not bit for bit.

Static-shape convention, as in JAX: graphs are padded to fixed (N, E);
padded edges carry ``edge_mask=False`` (src/dst clipped into range) and
every aggregation masks them out explicitly.  Edge indices are int32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models import layers, sharding


def shard_channels(x: torch.Tensor, axis: int | None = None) -> torch.Tensor:
    """JAX's channel-sharding constraint over a mesh's ``model`` axis: in a
    sharded trace (``models.sharding``), the feature axis (``axis``; by
    default axis 1 of an irreps tensor ``(N/E, C, m)``, else the last)
    split over ``model``, the leading axis left as it lies.  With no mesh
    the identity, as JAX's is without one."""
    if "model" not in sharding.active_axes():
        return x
    if axis is None:
        axis = 1 if x.dim() == 3 else x.dim() - 1
    return sharding.constrain_axis(x, "model", axis % x.dim())


class GraphBatch(NamedTuple):
    node_feat: torch.Tensor   # (N, F) float
    positions: torch.Tensor   # (N, 3) float
    edge_src: torch.Tensor    # (E,) int32
    edge_dst: torch.Tensor    # (E,) int32
    node_mask: torch.Tensor   # (N,) bool
    edge_mask: torch.Tensor   # (E,) bool
    labels: torch.Tensor      # (N,) int32 node labels | (G,) float targets
    graph_id: torch.Tensor    # (N,) int32 graph membership (0 when single)
    label_mask: torch.Tensor  # (N,) or (G,) bool: which labels count

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]


def to_device(batch: GraphBatch, device) -> GraphBatch:
    """A batch of numpy arrays (``data.graphs``) or tensors -> tensors on
    ``device`` of the same dtypes."""
    return GraphBatch(*(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                                        else a).to(device) for a in batch))


class Model(layers.ParamTree):
    """A GNN's params (``module.init(gen, cfg, device)``, drawn from a
    ``torch.Generator`` seeded with ``seed``) as parameters named by JAX's
    paths; ``module.forward``/``loss_fn`` take ``model.params()``."""

    def __init__(self, module, cfg, device="cuda", seed: int = 0):
        gen = torch.Generator(device=device).manual_seed(seed)
        super().__init__(module.init(gen, cfg, device))
        self.cfg = cfg


def _bcast(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row (E,) or (N,) vector shaped to broadcast against ``like``."""
    return m.reshape((-1,) + (1,) * (like.dim() - 1))


def gather_src(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return x.index_select(0, batch.edge_src)


def gather_dst(x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return x.index_select(0, batch.edge_dst)


def _mask_messages(msgs: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    return msgs * _bcast(batch.edge_mask, msgs).to(msgs.dtype)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` added into ``n`` segments."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def scatter_sum(msgs: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Aggregate edge messages at their destination (masked)."""
    return segment_sum(_mask_messages(msgs, batch), batch.edge_dst, batch.n_nodes)


def scatter_mean(msgs: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    s = scatter_sum(msgs, batch)
    deg = segment_sum(batch.edge_mask.to(msgs.dtype), batch.edge_dst, batch.n_nodes)
    return s / _bcast(torch.clamp_min(deg, 1.0), msgs)


def edge_softmax(logits: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Softmax over incoming edges per destination node (GAT).

    The segment max is ``scatter_reduce(..., "amax", include_self=False)``
    into zeros: a node with no incoming edge keeps 0 where JAX's
    ``segment_max`` gives -inf, and no edge ever reads it, since ``mx`` is
    read only at edges' destinations.  The gradient through ``mx`` is zero
    analytically (the softmax does not move with the shift), so the two
    libraries' rules for ties differ in it only by rounding."""
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    logits = torch.where(_bcast(batch.edge_mask, logits), logits, neg)
    idx = _bcast(batch.edge_dst.to(torch.int64), logits).expand_as(logits)
    mx = torch.zeros((batch.n_nodes,) + tuple(logits.shape[1:]), dtype=logits.dtype,
                     device=logits.device).scatter_reduce(0, idx, logits, "amax",
                                                          include_self=False)
    ex = torch.exp(logits - gather_dst(mx, batch))
    ex = _mask_messages(ex, batch)
    den = segment_sum(ex, batch.edge_dst, batch.n_nodes)
    return ex / torch.clamp_min(gather_dst(den, batch), 1e-20)


def graph_readout(node_scalars: torch.Tensor, batch: GraphBatch, n_graphs: int):
    """Sum-pool node scalars per graph (energy-style readout)."""
    vals = node_scalars * batch.node_mask.to(node_scalars.dtype)
    return segment_sum(vals, batch.graph_id, n_graphs)


def node_ce_loss(logits: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked node-classification cross entropy."""
    mask = batch.label_mask & batch.node_mask
    labels = torch.where(mask, batch.labels, 0).to(torch.int64)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1)


def graph_mse_loss(pred: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Per-graph regression MSE (labels are (G,) targets)."""
    err = (pred.to(torch.float32) - batch.labels.to(torch.float32)) ** 2
    m = batch.label_mask.to(torch.float32)
    return torch.sum(err * m) / torch.clamp_min(torch.sum(m), 1)


def edge_vectors(batch: GraphBatch, eps: float = 1e-9):
    """(vec, dist, unit) per edge from node positions.  A self-loop has
    ``vec`` 0, ``dist`` 0 and ``unit`` 0."""
    vec = gather_dst(batch.positions, batch) - gather_src(batch.positions, batch)
    dist = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    unit = vec / torch.clamp_min(dist, eps)
    return vec, dist[..., 0], unit


def bessel_rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Sine Bessel radial basis with smooth cosine cutoff (NequIP/DimeNet)."""
    d = torch.clamp(dist, 1e-6, cutoff)
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    scale = torch.sqrt(torch.tensor(2.0 / cutoff, dtype=d.dtype, device=d.device))
    basis = scale * torch.sin(n * math.pi * d[..., None] / cutoff) / d[..., None]
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist, 0, cutoff) / cutoff) + 1.0)
    return basis * env[..., None]
