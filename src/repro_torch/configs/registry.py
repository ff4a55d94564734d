"""Architecture registry of the port: the (arch x shape) cells it runs.

The counterpart of ``repro.configs.registry``: its 10 architectures x 4
shapes = 40 cells, in JAX's order.  The shapes are the JAX package's.  LM:
``train_4k`` a training step (the entry's ``train_shape``,
``configs.cells.lm_train_step``), ``prefill_32k`` a prefill,
``decode_32k`` and ``long_500k`` decode steps at a context; ``long_500k``
runs only for mixtral-8x7b, whose sliding window makes the cache
O(window), and the pure full-attention archs record JAX's skip reason.
GNN: every shape of ``GNN_SHAPES`` is a training step
(``configs.cells.gnn_train_step`` under ``gnn_cell_config``).  Recsys:
``serve_p99`` and ``serve_bulk`` forward batches, ``retrieval_cand`` the
candidates one query is scored against, ``train_batch`` a training step
(``configs.cells.recsys_train_step``).  ``build_cell`` (a lowerable cell
on a mesh) waits for the port's mesh work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import (
    command_r_plus_104b,
    dbrx_132b,
    equiformer_v2,
    gat_cora,
    gemma_2b,
    meshgraphnet,
    mixtral_8x7b,
    nequip,
    qwen2_5_3b,
    wide_deep,
)

# ---- LM shapes (assignment values)
LM_TRAIN = dict(batch=256, seq=4096)
LM_PREFILL = dict(batch=32, seq=32768)
LM_DECODE = dict(batch=128, ctx=32768)
LM_LONG = dict(batch=1, ctx=524288)

# ---- GNN shapes (assignment values)
GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, task="node_cls",
                          n_classes=7, n_graphs=1, shard_edges=False),
    # fanout 15-10 over 1024 seeds: node table 1024+15,360+153,600 (padded),
    # edges 15,360+153,600; features are reddit-like (602 dims, 41 classes)
    "minibatch_lg": dict(n=169984, e=168960, d_feat=602, task="node_cls",
                         n_classes=41, n_graphs=1, shard_edges=False),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, task="node_cls",
                         n_classes=47, n_graphs=1, shard_edges=True),
    "molecule": dict(n=128 * 30, e=128 * 64, d_feat=16, task="graph_reg",
                     n_classes=0, n_graphs=128, shard_edges=False),
}

# ---- recsys shapes
RECSYS_SHAPES = {
    "train_batch": 65536,
    "serve_p99": 512,
    "serve_bulk": 262144,
    "retrieval_cand": 1_000_000,
}


@dataclasses.dataclass
class ArchEntry:
    name: str
    family: str                      # lm | gnn | recsys
    config: Callable
    smoke_config: Callable
    shapes: tuple[str, ...]
    skips: dict[str, str]
    train_shape: str | None = None   # the shape a training step runs at


def _lm_entry(mod, name, long_ok: bool, long_reason: str = "") -> ArchEntry:
    skips = {}
    if not long_ok:
        skips["long_500k"] = long_reason
    return ArchEntry(
        name=name, family="lm", config=mod.config, smoke_config=mod.smoke_config,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skips=skips, train_shape="train_4k",
    )


_FULL_ATTN = (
    "pure full-attention arch: 524k-token full-attention decode has no "
    "sub-quadratic path; skipped per assignment (see DESIGN.md §5)"
)

ARCHS: dict[str, ArchEntry] = {
    "qwen2.5-3b": _lm_entry(qwen2_5_3b, "qwen2.5-3b", False, _FULL_ATTN),
    "gemma-2b": _lm_entry(gemma_2b, "gemma-2b", False, _FULL_ATTN),
    "command-r-plus-104b": _lm_entry(
        command_r_plus_104b, "command-r-plus-104b", False, _FULL_ATTN
    ),
    "dbrx-132b": _lm_entry(dbrx_132b, "dbrx-132b", False, _FULL_ATTN),
    "mixtral-8x7b": _lm_entry(mixtral_8x7b, "mixtral-8x7b", True),
    "gat-cora": ArchEntry(
        "gat-cora", "gnn", gat_cora.config, gat_cora.smoke_config,
        tuple(GNN_SHAPES), {},
    ),
    "meshgraphnet": ArchEntry(
        "meshgraphnet", "gnn", meshgraphnet.config, meshgraphnet.smoke_config,
        tuple(GNN_SHAPES), {},
    ),
    "nequip": ArchEntry(
        "nequip", "gnn", nequip.config, nequip.smoke_config,
        tuple(GNN_SHAPES), {},
    ),
    "equiformer-v2": ArchEntry(
        "equiformer-v2", "gnn", equiformer_v2.config, equiformer_v2.smoke_config,
        tuple(GNN_SHAPES), {},
    ),
    "wide-deep": ArchEntry(
        "wide-deep", "recsys", wide_deep.config, wide_deep.smoke_config,
        tuple(RECSYS_SHAPES), {}, train_shape="train_batch",
    ),
}


def get_arch(name: str) -> ArchEntry:
    return ARCHS[name]


def list_cells(include_skips: bool = False):
    """All (arch, shape, skip reason or None) cells.  JAX's ``list_cells``
    lists every cell with its reason whatever ``include_skips`` says, and so
    does this one."""
    return [(a.name, s, a.skips.get(s)) for a in ARCHS.values() for s in a.shapes]


def gnn_cell_config(arch: str, shape: str):
    """The config a GNN cell trains under: the arch's published one with the
    shape's ``d_in``, and its ``task`` and ``n_classes``; a ``shard_edges``
    shape (full-batch-large) also sets ``channel_shard`` and bf16, as JAX's
    ``build_cell`` does.  On one device ``channel_shard`` changes nothing."""
    entry = get_arch(arch)
    if entry.family != "gnn":
        raise ValueError(f"{arch} is not a GNN")
    p = GNN_SHAPES[shape]
    cfg = dataclasses.replace(entry.config(), d_in=p["d_feat"], n_classes=p["n_classes"],
                              task=p["task"])
    if p["shard_edges"]:
        cfg = dataclasses.replace(cfg, channel_shard=True, dtype=torch.bfloat16)
    return cfg
