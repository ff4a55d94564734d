"""Predicate Tuple Table — per-predicate duplicate-elimination table.

The counterpart of ``repro.core.ptt``.  One PTT exists per predicate, as in
the paper.  Here the PTT is the radix-partitioned table of
``kernels.ops``: a triple's key comes from the ``hash_mix`` kernel and its
insert goes through ``radix_dedup_insert`` and the ``bucket_dedup`` kernel.
``is_new`` marks exactly the lanes the flat ``hashset`` insert of the JAX
engine marks (the first lane of each key not yet in the table); only the
table layout differs, and the engine never emits the layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import EMPTY
from repro_torch.core.hashset import next_pow2
from repro_torch.kernels import ops
from repro_torch.kernels.bucket_dedup import SLICE


class PTT(NamedTuple):
    table: ops.RadixTable

    @property
    def capacity(self) -> int:
        return self.table.hi.numel()


def n_parts_for(capacity: int) -> int:
    """Partitions for a table of ``capacity`` slots: every slice holds at
    most ``SLICE`` slots, so it fits one CTA's shared memory."""
    return max(1, capacity // SLICE)


def make_capacity(capacity: int, device="cuda") -> PTT:
    """An empty PTT of ``capacity`` (a power of two) slots in all."""
    return PTT(ops.make_radix_table(capacity, n_parts_for(capacity), device=device))


def make(expected_distinct: int, load_factor: float = 0.6, device="cuda") -> PTT:
    """Size the table for an expected number of distinct triples."""
    return make_capacity(next_pow2(int(expected_distinct / load_factor) + 16), device)


class TripleInsertResult(NamedTuple):
    ptt: PTT
    is_new: torch.Tensor
    overflowed: torch.Tensor


def insert_triples(
    ptt: PTT,
    subj_tmpl,
    subj_vals: torch.Tensor,
    pred_id,
    obj_tmpl,
    obj_vals: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> TripleInsertResult:
    """Probe+insert a batch of candidate triples; ``is_new`` marks the ones
    that must be emitted to the knowledge graph (the paper's PTT check).
    The table is updated in place."""
    n = subj_vals.shape[0]
    dev = subj_vals.device

    def row(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.int32).expand(n)
        return torch.full((n,), int(x), dtype=torch.int32, device=dev)

    words = torch.stack([row(subj_tmpl), row(subj_vals), row(pred_id),
                         row(obj_tmpl), row(obj_vals)])
    hi, lo = ops.fused_hash_mix(words)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    table, is_new, ovf = ops.radix_dedup_insert(ptt.table, hi, lo, valid)
    return TripleInsertResult(ptt=PTT(table), is_new=is_new, overflowed=ovf)


def distinct_count(ptt: PTT) -> torch.Tensor:
    t = ptt.table
    return (~((t.hi == EMPTY) & (t.lo == EMPTY))).sum().to(torch.int32)
