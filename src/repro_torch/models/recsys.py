"""Wide & Deep (Cheng et al., arXiv:1606.07792), serving and training on one
device.

The counterpart of ``repro.models.recsys``: 40 sparse fields, embed_dim 32,
deep MLP 1024-512-256, concat interaction.  The embedding lookup is the hot
path.  As in JAX it is a row fetch followed by a sum over the bag axis (not
``F.embedding_bag``, which sums in another order), with the paper-derived
``dedup_gather`` as an option for duplicate-heavy id streams.

Only the single-device fetch is here (JAX's ``_fetch_rows`` with no mesh);
the vocab-parallel fetch (``_vocab_parallel_rows``, a shard_map over the
``model`` axis) waits for more than one card.  ``param_specs`` gives JAX's
partition specs for the dry-run's accounting.
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
from repro_torch.models import layers
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


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits against 0/1 labels (JAX's
    ``loss_fn`` on the logits), in fp32."""
    logits = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs())))


class WideDeep(nn.Module):
    """Parameters ``embed`` (F, V, D), ``wide`` (F, V), ``mlp.fc{i}`` and
    ``head``, named as the JAX params dict flattens; drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""

    def __init__(self, cfg: WideDeepConfig, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed = nn.Parameter(torch.empty((F, V, D), **kw).normal_(generator=gen).mul_(0.01))
        self.wide = nn.Parameter(torch.empty((F, V), **kw).normal_(generator=gen).mul_(0.01))
        self.mlp = layers.MLP(gen, (F * D + cfg.n_dense, *cfg.mlp), cfg.dtype, device=device)
        self.head = layers.Dense(gen, cfg.mlp[-1], 1, cfg.dtype, bias=True, device=device)

    def _fetch_rows(self, table: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
        """(B, F, G) ids -> (B*F*G, width) rows of the flattened (F*V, width)
        table, plain or (with ``dedup_cap``) deduplicated."""
        F, V = self.cfg.n_sparse, self.cfg.vocab_per_field
        offs = torch.arange(F, dtype=sparse_ids.dtype, device=sparse_ids.device) * V
        global_ids = (sparse_ids + offs[None, :, None]).reshape(-1)
        return gather_maybe_dedup(table.reshape(F * V, -1), global_ids, self.cfg.dedup_cap)

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
