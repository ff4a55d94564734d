"""Architecture registry of the port: the (arch x shape) cells it runs.

The counterpart of ``repro.configs.registry``, with the LM family and the
recsys entry (the GNNs are not ported yet).  The shapes are the JAX
package's.  LM: ``train_4k`` a training step (the entry's
``train_shape``), ``prefill_32k`` a prefill, ``decode_32k`` and
``long_500k`` decode steps at a context; ``long_500k`` runs only for
mixtral-8x7b, whose sliding window makes the cache O(window), and the
pure full-attention archs record JAX's skip reason.  Recsys:
``serve_p99`` and ``serve_bulk`` forward batches, ``retrieval_cand`` the
candidates one query is scored against, ``train_batch`` a training step
(``configs.cells.recsys_train_step``).  ``build_cell`` (a lowerable cell
on a mesh) waits for the port's mesh work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import (
    command_r_plus_104b,
    dbrx_132b,
    gemma_2b,
    mixtral_8x7b,
    qwen2_5_3b,
    wide_deep,
)

# ---- LM shapes (assignment values)
LM_TRAIN = dict(batch=256, seq=4096)
LM_PREFILL = dict(batch=32, seq=32768)
LM_DECODE = dict(batch=128, ctx=32768)
LM_LONG = dict(batch=1, ctx=524288)

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
    "wide-deep": ArchEntry(
        "wide-deep", "recsys", wide_deep.config, wide_deep.smoke_config,
        tuple(RECSYS_SHAPES), {}, train_shape="train_batch",
    ),
}


def get_arch(name: str) -> ArchEntry:
    return ARCHS[name]


def list_cells():
    """All (arch, shape, skip reason or None) cells, as JAX's ``list_cells``
    lists them (whatever its ``include_skips``)."""
    return [(a.name, s, a.skips.get(s)) for a in ARCHS.values() for s in a.shapes]
