"""Naive operator pieces — the paper's SDM-RDFizer⁻ baseline.

The counterpart of ``repro.core.naive``: sort-based duplicate elimination
over 64-bit keys (``sort_dedup``, ``sort_dedup_masked``), which the naive
engine runs once per predicate and the radix PTT insert uses as its
map-side combiner (``kernels.ops.radix_dedup_insert``), and the nested-loop
join of the naive OJM (``nested_loop_join``), which is the ``nested_join``
kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import EMPTY
from repro_torch.kernels import nested_join as _join


class SortDedupResult(NamedTuple):
    uniq_mask: torch.Tensor  # bool[n]  True on the first occurrence, in the
    #                          ORIGINAL order (scatter-back of the sorted mask)
    n_unique: torch.Tensor   # int32[]


def sort_dedup(key_hi: torch.Tensor, key_lo: torch.Tensor) -> SortDedupResult:
    """Merge-sort duplicate elimination over 64-bit keys (hi, lo lanes).

    The pair is packed into one int64 (a bijection of the two 32-bit
    patterns) and sorted once, stably, so "first occurrence" follows the
    original order.  Which lane is first within a group of equal keys does
    not depend on the order between groups, so the signed order of the
    packed key gives the same mask as the JAX version's two unsigned sorts.
    """
    key = (key_hi.to(torch.int64) << 32) | (key_lo.to(torch.int64) & 0xFFFFFFFF)
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    uniq_mask = torch.zeros_like(first)
    uniq_mask[order] = first
    return SortDedupResult(uniq_mask=uniq_mask, n_unique=first.sum().to(torch.int32))


def sort_dedup_masked(
    key_hi: torch.Tensor, key_lo: torch.Tensor, valid: torch.Tensor
) -> SortDedupResult:
    """sort_dedup over valid lanes only (invalid lanes are never unique)."""
    # Route invalid lanes to the reserved EMPTY pair, then intersect the
    # first-occurrence mask with validity.  A valid lane never carries the
    # EMPTY pair (mix64 remaps it), so it is unaffected.
    h = torch.where(valid, key_hi, EMPTY)
    l = torch.where(valid, key_lo, EMPTY)
    res = sort_dedup(h, l)
    uniq = res.uniq_mask & valid
    return SortDedupResult(uniq_mask=uniq, n_unique=uniq.sum().to(torch.int32))


class NestedJoinResult(NamedTuple):
    subjects: torch.Tensor   # int32[m, max_matches]
    valid: torch.Tensor      # bool[m, max_matches]
    truncated: torch.Tensor  # bool[]
    # the paper's |N_parent| x |N_child| cost term is derived from the input
    # sizes by the caller


def nested_loop_join(
    parent_keys: torch.Tensor,
    parent_subjects: torch.Tensor,
    child_keys: torch.Tensor,
    max_matches: int,
) -> NestedJoinResult:
    """All-pairs equality join (|N_parent| x |N_child| comparisons).  Output
    layout matches ``pjtt.ProbeResult``, so the two paths are drop-in
    interchangeable in the executor.  On the card this is the
    ``nested_join`` kernel; on the CPU its plain version, blocked over child
    rows to bound the comparison matrix."""
    return NestedJoinResult(
        *_join.nested_join(parent_keys, parent_subjects, child_keys, max_matches)
    )
