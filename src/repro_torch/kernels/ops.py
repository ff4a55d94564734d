"""Public wrappers around the kernels.

``radix_dedup_insert`` is the production entry point for the PTT insert: it
owns the radix partitioning (keys -> partition of their hash, so duplicates
always meet in the same shared-memory-resident table slice), invokes the
``bucket_dedup`` kernel, and un-permutes the verdicts back to the caller's
layout.  The combiner, partitioning, binning and un-permute are plain
PyTorch, as they sit outside the Pallas kernel in the JAX package too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, naive
from repro_torch.core.hashing import EMPTY
from repro_torch.kernels import bucket_dedup as _bucket
from repro_torch.kernels import hash_mix as _mix

PART_SLACK = 4


class RadixTable(NamedTuple):
    """PTT physically laid out as (n_parts, cap_per_part) radix slices."""

    hi: torch.Tensor  # int32[n_parts, cap]
    lo: torch.Tensor

    @property
    def n_parts(self) -> int:
        return self.hi.shape[0]


def make_radix_table(capacity_total: int, n_parts: int, device="cuda") -> RadixTable:
    cap = 1 << max(int(capacity_total / n_parts) - 1, 1).bit_length()
    return RadixTable(
        hi=torch.full((n_parts, cap), EMPTY, dtype=torch.int32, device=device),
        lo=torch.full((n_parts, cap), EMPTY, dtype=torch.int32, device=device),
    )


def _partition_of(key_hi: torch.Tensor, n_parts: int) -> torch.Tensor:
    # distinct salt from the hashset slot bits (key_lo) and the distributed
    # owner bits (0xA5A5A5A5)
    return hashing.fmix32(hashing.u32(key_hi) ^ 0x51ED270B) % n_parts


def radix_dedup_insert(
    table: RadixTable,
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    valid: torch.Tensor,
):
    """Map-side combine -> partition -> kernel insert -> un-permute.

    The combiner (an intra-batch first-occurrence dedup) forwards only one
    representative per distinct key, so partition load follows the
    *distinct*-key hash distribution, which is uniform; in-batch duplicates
    inherit ``is_new=False`` from first-wins semantics directly.  The table
    is updated in place (the JAX version donates it) and returned.

    Returns (table, is_new bool[n], overflow bool[]).
    """
    n = key_hi.shape[0]
    dev = key_hi.device
    if n == 0:
        return table, torch.zeros(0, dtype=torch.bool, device=dev), \
            torch.zeros((), dtype=torch.bool, device=dev)
    b = bin_lanes(key_hi, key_lo, valid, table.n_parts)
    thi, tlo, is_new_p, ovf_p = _bucket.bucket_dedup(b.khi, b.klo, b.kval, table.hi, table.lo)

    flat = is_new_p.view(-1)
    # only representatives can be new; in-batch duplicates are False by the
    # combiner's first-wins ordering
    is_new = (b.dest >= 0) & flat[b.dest.clamp(min=0)] & b.rep & valid
    return RadixTable(hi=thi, lo=tlo), is_new, ovf_p.any() | b.bin_ovf


class Bins(NamedTuple):
    khi: torch.Tensor      # int32[n_parts, part_len]  keys of each partition
    klo: torch.Tensor
    kval: torch.Tensor     # bool[n_parts, part_len]   lane holds a key
    rep: torch.Tensor      # bool[n]  the lane represents its key (combiner)
    dest: torch.Tensor     # int64[n] flat bin slot of each lane, or -1
    bin_ovf: torch.Tensor  # bool[]   a partition got more than part_len keys


def bin_lanes(key_hi, key_lo, valid, n_parts: int) -> Bins:
    """Combine, partition and bin the lanes of one insert into the
    ``(n_parts, part_len)`` layout the ``bucket_dedup`` kernel takes, with
    ``part_len = max(PART_SLACK * ceil(n / n_parts), 8)``."""
    n = key_hi.shape[0]
    dev = key_hi.device
    rep = naive.sort_dedup_masked(key_hi, key_lo, valid).uniq_mask  # combiner
    part = _partition_of(key_hi, n_parts)
    part_len = max(PART_SLACK * ((n + n_parts - 1) // n_parts), 8)

    # bin representative lanes into (n_parts, part_len), overflow detected
    pv = torch.where(rep, part, n_parts)
    order = torch.argsort(pv, stable=True)
    sorted_part = pv[order]
    starts = torch.searchsorted(
        sorted_part, torch.arange(n_parts + 1, dtype=pv.dtype, device=dev)
    )
    rank = torch.arange(n, device=dev) - starts[sorted_part]
    binned = sorted_part < n_parts
    ok = binned & (rank < part_len)
    dest = torch.where(ok, sorted_part * part_len + rank, -1)
    bin_ovf = (binned & (rank >= part_len)).any()

    send_index = torch.full((n_parts * part_len,), -1, dtype=torch.int64, device=dev)
    send_index[dest[ok]] = order[ok]
    sent = send_index >= 0
    safe = send_index.clamp(0, max(n - 1, 0))
    dest_by_lane = torch.full((n,), -1, dtype=torch.int64, device=dev)
    dest_by_lane[order] = dest
    return Bins(
        khi=torch.where(sent, key_hi[safe], EMPTY).view(n_parts, part_len),
        klo=torch.where(sent, key_lo[safe], EMPTY).view(n_parts, part_len),
        kval=sent.view(n_parts, part_len),
        rep=rep,
        dest=dest_by_lane,
        bin_ovf=bin_ovf,
    )


def fused_hash_mix(words: torch.Tensor, salt: int = 0):
    """words int32[W, n] -> (hi, lo) int32[n] via the hash_mix kernel."""
    return _mix.hash_mix(words, salt=salt)
