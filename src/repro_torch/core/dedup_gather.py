"""dedup_gather — the PTT insight applied to embedding/feature lookups.

The counterpart of ``repro.core.dedup_gather``.  A batch of gather indices
with duplicate rate r fetches the same rows r times; the paper's
|N_p| -> |S_p| saving applies verbatim: deduplicate the index stream,
gather each distinct row once, and scatter results back through the
inverse map.

A configured ``unique_cap`` fixes the shapes; if a batch has more distinct
ids than the cap, the call reports overflow (its values are then wrong,
exactly as the JAX version's are) and the caller falls back to the plain
gather.

Differentiable through autograd: the backward of the two ``index_select``
calls is the mirrored scatter-add, so gradient traffic enjoys the same
dedup.  Nothing here syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DedupGatherResult(NamedTuple):
    values: torch.Tensor      # (n, d) gathered rows (valid iff not overflowed)
    n_unique: torch.Tensor    # int32[]
    overflowed: torch.Tensor  # bool[]


def dedup_gather(table: torch.Tensor, ids: torch.Tensor, unique_cap: int) -> DedupGatherResult:
    """table (V, d); ids int[n] -> rows (n, d), gathering only the distinct
    ids (up to unique_cap)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot = torch.cumsum(first, 0) - 1              # group id per sorted lane
    n_unique = slot[-1] + 1
    overflow = n_unique > unique_cap

    # lane ``unique_cap`` of the buffer is JAX's mode="drop": every lane that
    # is not the first of a group that fits writes there, and it is cut off
    lane = torch.where(first & (slot < unique_cap), slot, unique_cap)
    uids = torch.zeros(unique_cap + 1, dtype=ids.dtype, device=ids.device)
    uids = uids.scatter(0, lane, sorted_ids)[:unique_cap]
    rows = table.index_select(0, uids)             # (cap, d) — the only gather

    group_of_lane = torch.empty_like(slot).scatter_(0, order, slot)
    out = rows.index_select(0, group_of_lane.clamp(0, unique_cap - 1))
    return DedupGatherResult(
        values=out, n_unique=n_unique.to(torch.int32), overflowed=overflow
    )


def gather_maybe_dedup(table: torch.Tensor, ids: torch.Tensor, unique_cap: int | None):
    """Plain gather when dedup is disabled (cap None), else dedup_gather
    values (callers check overflow out-of-band in tests/benchmarks)."""
    if unique_cap is None:
        return table.index_select(0, ids)
    return dedup_gather(table, ids, unique_cap).values
