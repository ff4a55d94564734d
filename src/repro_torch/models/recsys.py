"""Wide & Deep (Cheng et al., arXiv:1606.07792), serving and training on one
device.

The counterpart of ``repro.models.recsys``: 40 sparse fields, embed_dim 32,
deep MLP 1024-512-256, concat interaction.  The embedding lookup is the hot
path.  As in JAX it is a row fetch followed by a sum over the bag axis (not
``F.embedding_bag``, which sums in another order), with the paper-derived
``dedup_gather`` as an option for duplicate-heavy id streams.

With no mesh active the fetch is a plain (optionally deduplicated)
gather.  With a ``("data", "model")`` ``ProcessMesh`` active
(``sharding.set_mesh``), ``_fetch_rows`` takes JAX's vocab-parallel arm
(``_vocab_parallel_rows``) on this rank: the tables' vocab axis is sharded
over ``model`` (``param_specs``; ``WideDeep(..., mesh=)`` keeps this
rank's blocks), a masked local take and a psum over ``model`` fetch the
rank's ids, and with ``dedup_cap`` the rank's id stream is deduplicated
first (``_local_dedup``), so only the distinct rows ride the psum.  The
rest of the forward runs on the rank's data-parallel block of the batch
(``sharding.token_spec(B, mesh)``: split over ``data`` when it divides B,
else every rank holds the whole batch).  The mesh arm is forward only.
``param_specs`` also gives the dry-run's accounting.
Gradients flow through the fetch, plain or deduplicated: the backward of
each ``index_select`` is the mirrored scatter-add into a dense table
gradient, as JAX's autodiff gives it.  On the card that scatter-add uses
atomics, so its fp32 sums land in a varying order.
fp32 products are meant to run at "highest" precision (no TF32, PyTorch's
default): with TF32 the card's logits drift from the CPU's by more than
the tolerance the checks state.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.dedup_gather import gather_maybe_dedup
from repro_torch.models import layers, sharding
from repro_torch.models.sharding import P


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    vocab_per_field: int = 1_000_000
    n_dense: int = 13
    mlp: tuple[int, ...] = (1024, 512, 256)
    # multi-hot bag size per field (1 = one-hot); the embedding bag sums it
    bag_size: int = 1
    dedup_cap: int | None = None  # PTT-style unique-gather cap (None = off)
    dtype: torch.dtype = torch.float32


def param_specs(cfg: WideDeepConfig) -> dict:
    """JAX's partition specs, as ``WideDeep``'s parameters nest: the tables'
    vocab axis over ``model`` only (the lookup needs each model shard's full
    row range), the MLP and head whole."""
    mlp_specs = {f"fc{i}": {"w": P(None, None), "b": P(None)} for i in range(len(cfg.mlp))}
    return {
        "embed": P(None, "model", None),
        "wide": P(None, "model"),
        "mlp": mlp_specs,
        "head": {"w": P(None, None), "b": P(None)},
    }


def _local_dedup(flat_ids: torch.Tensor, cap: int):
    """Sort-based first-occurrence dedup (the PTT combiner, local to the
    rank).  Returns (unique_ids[cap], group_of_lane[n]); as in JAX, ids past
    the cap-th distinct one are dropped from ``unique_ids`` and their lanes
    point at slot cap - 1."""
    n = flat_ids.shape[0]
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1
    # row cap takes the lanes JAX's scatter drops
    uids = flat_ids.new_zeros(cap + 1).index_put_(
        (torch.where(first & (slot < cap), slot, cap),), sorted_ids)[:cap]
    group = slot.new_empty(n).index_copy_(0, order, slot.clamp(0, cap - 1))
    return uids, group


def _vocab_parallel_rows(table3: torch.Tensor, flat_ids: torch.Tensor, cfg) -> torch.Tensor:
    """JAX's shard_map row fetch on this rank: ``table3`` is the rank's
    (F, V/m, D) vocab block, ``flat_ids`` its global ids f*V + v; a masked
    local take and a psum over ``model``, after ``_local_dedup`` where
    ``cfg.dedup_cap`` is set.  In a sharded trace the arguments are
    DTensors, entered by JAX's in-specs, and the rows leave as one."""
    ids_spec = sharding.token_spec(flat_ids.shape[0], sharding.current_mesh())
    table3 = sharding.enter(table3, P(None, "model", None))
    flat_ids = sharding.enter(flat_ids, ids_spec)
    V, v_loc = cfg.vocab_per_field, table3.shape[1]
    lo = sharding.axis_index("model") * v_loc

    def fetch(ids):
        f = torch.div(ids, V, rounding_mode="floor")
        v = ids % V - lo
        ok = (v >= 0) & (v < v_loc)
        rows = table3[f, v.clamp(0, v_loc - 1)]
        return sharding.psum(torch.where(ok[:, None], rows, 0), "model")

    if cfg.dedup_cap is not None:
        uids, group = _local_dedup(flat_ids, cfg.dedup_cap)
        rows = fetch(uids).index_select(0, group)  # (cap, D): the only psum
    else:
        rows = fetch(flat_ids)
    return sharding.leave(rows, P(ids_spec[0], None))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits against 0/1 labels (JAX's
    ``loss_fn`` on the logits), in fp32."""
    logits = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs())))


class WideDeep(nn.Module):
    """Parameters ``embed`` (F, V, D), ``wide`` (F, V), ``mlp.fc{i}`` and
    ``head``, named as the JAX params dict flattens; drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.  With a
    ``ProcessMesh``, each parameter keeps this rank's block of the same
    draw by ``param_specs`` (the tables' vocab slice)."""

    def __init__(self, cfg: WideDeepConfig, device="cuda", seed: int = 0, mesh=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed = nn.Parameter(torch.empty((F, V, D), **kw).normal_(generator=gen).mul_(0.01))
        self.wide = nn.Parameter(torch.empty((F, V), **kw).normal_(generator=gen).mul_(0.01))
        self.mlp = layers.MLP(gen, (F * D + cfg.n_dense, *cfg.mlp), cfg.dtype, device=device)
        self.head = layers.Dense(gen, cfg.mlp[-1], 1, cfg.dtype, bias=True, device=device)
        if mesh is not None:
            for name, spec in layers.flatten(param_specs(cfg)).items():
                p = self.get_parameter(name)
                p.data = sharding.local_block(p.data, spec, mesh)

    def _fetch_rows(self, table: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
        """(B, F, G) ids -> (B*F*G, width) rows of the flattened (F*V, width)
        table, plain or (with ``dedup_cap``) deduplicated; the vocab-parallel
        arm when ``data`` and ``model`` are active."""
        F, V = self.cfg.n_sparse, self.cfg.vocab_per_field
        offs = torch.arange(F, dtype=sparse_ids.dtype, device=sparse_ids.device) * V
        global_ids = (sparse_ids + offs[None, :, None]).reshape(-1)
        table3 = table if table.dim() == 3 else table[..., None]
        if sharding.arms_active():
            return _vocab_parallel_rows(table3, global_ids, self.cfg)
        return gather_maybe_dedup(table3.reshape(F * V, -1), global_ids, self.cfg.dedup_cap)

    def embedding_bag(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """sparse_ids int (B, F, bag) -> (B, F*D) summed bag embeddings."""
        B, F, G = sparse_ids.shape
        rows = self._fetch_rows(self.embed, sparse_ids)
        return rows.reshape(B, F, G, self.cfg.embed_dim).sum(dim=2).reshape(B, -1)

    def wide_logit(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        B, F, G = sparse_ids.shape
        return self._fetch_rows(self.wide, sparse_ids).reshape(B, F * G).sum(dim=-1)

    def user_tower(self, sparse_ids: torch.Tensor, dense_feats: torch.Tensor) -> torch.Tensor:
        """Deep-tower representation (B, mlp[-1]) for retrieval scoring."""
        deep_in = torch.cat(
            [self.embedding_bag(sparse_ids), dense_feats.to(self.cfg.dtype)], dim=-1)
        return self.mlp(deep_in, final_act=True)

    def forward(self, sparse_ids: torch.Tensor, dense_feats: torch.Tensor) -> torch.Tensor:
        """-> logits (B,).  sparse_ids (B, F, bag), dense_feats (B, n_dense)."""
        deep_logit = self.head(self.user_tower(sparse_ids, dense_feats))[:, 0]
        return deep_logit + self.wide_logit(sparse_ids)

    def loss(self, sparse_ids, dense_feats, labels) -> torch.Tensor:
        """Binary cross-entropy (CTR objective)."""
        return bce_loss(self(sparse_ids, dense_feats), labels)

    def retrieval_scores(self, sparse_ids, dense_feats, candidates) -> torch.Tensor:
        """Score queries against a candidate matrix (n_cand, mlp[-1]) — one
        batched product, not a loop.  Returns (B, n_cand)."""
        u = self.user_tower(sparse_ids, dense_feats)
        return u @ candidates.T.to(u.dtype)
