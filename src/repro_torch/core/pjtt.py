"""Predicate Join Tuple Table, sorted strategy, in plain PyTorch.

The counterpart of the sorted strategy of ``repro.core.pjtt``: the PJTT
maps ``value(join condition) -> {subjects of the parent triples map}`` so
that an Object Join Map becomes an index join (one probe per child row)
instead of a nested-loop join.  Parent ``(key, subject)`` pairs are sorted
once; a probe is a pair of ``searchsorted`` calls giving a ``[start, end)``
span, expanded into a padded-ragged ``(m, max_matches)`` block with a
validity mask.  Duplicate parent pairs stay in the span but are masked
with a ``-1`` subject (set semantics).

Join keys and subjects are dictionary ids (int32, >= 0), so signed order is
the JAX package's order.  The hash strategy arrives in a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SUBJ_MASKED = -1


class PJTTSorted(NamedTuple):
    skeys: torch.Tensor  # int32[n]  parent join-key values, sorted
    ssubj: torch.Tensor  # int32[n]  parent subject values, co-sorted; -1 = dup


class ProbeResult(NamedTuple):
    subjects: torch.Tensor   # int32[m, max_matches]  parent subjects (or junk)
    valid: torch.Tensor      # bool[m, max_matches]
    truncated: torch.Tensor  # bool[]  some span exceeded max_matches


def _lexsort_pairs(keys: torch.Tensor, subjects: torch.Tensor):
    """Stable sort by (key, subject): two stable argsorts."""
    o1 = torch.argsort(subjects, stable=True)
    k1, s1 = keys[o1], subjects[o1]
    o2 = torch.argsort(k1, stable=True)
    return k1[o2], s1[o2]


def _mask_dups(skeys: torch.Tensor, ssubj: torch.Tensor) -> torch.Tensor:
    """After lexsort, mask repeated (key, subject) pairs (set semantics)."""
    prev_same = torch.zeros_like(skeys, dtype=torch.bool)
    prev_same[1:] = (skeys[1:] == skeys[:-1]) & (ssubj[1:] == ssubj[:-1])
    return torch.where(prev_same, _SUBJ_MASKED, ssubj)


def build_sorted(keys: torch.Tensor, subjects: torch.Tensor) -> PJTTSorted:
    """Build the sorted-strategy PJTT from parent rows.  Cost: one sort —
    the paper's |N_parent| build term."""
    skeys, ssubj = _lexsort_pairs(keys, subjects)
    return PJTTSorted(skeys=skeys, ssubj=_mask_dups(skeys, ssubj))


def probe_sorted(
    pjtt: PJTTSorted, child_keys: torch.Tensor, max_matches: int
) -> ProbeResult:
    start = torch.searchsorted(pjtt.skeys, child_keys)
    end = torch.searchsorted(pjtt.skeys, child_keys, right=True)
    return _expand_spans(pjtt.ssubj, start, end - start, max_matches)


def _expand_spans(
    ssubj: torch.Tensor, start: torch.Tensor, count: torch.Tensor, max_matches: int
) -> ProbeResult:
    """Expand [start, start+count) spans into a padded (m, K) block."""
    n = ssubj.shape[0]
    offs = torch.arange(max_matches, dtype=torch.int64, device=start.device)[None, :]
    idx = start[:, None].to(torch.int64) + offs
    within = offs < count[:, None]
    if n:
        subjects = ssubj[idx.clamp(0, n - 1)]
    else:  # no parent rows: every span is empty
        subjects = torch.full(idx.shape, _SUBJ_MASKED, dtype=torch.int32,
                              device=start.device)
    valid = within & (subjects != _SUBJ_MASKED)
    truncated = (count > max_matches).any()
    return ProbeResult(subjects=subjects, valid=valid, truncated=truncated)
