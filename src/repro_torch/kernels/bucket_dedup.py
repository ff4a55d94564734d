"""K2 ``bucket_dedup``: radix-partitioned open-addressing dedup-insert.

Partition ``p`` inserts ``keys[p, :]`` into its own table slice
``table[p, :]`` with exactly the arbitration of ``hashset.insert_masked``
(lowest lane wins an empty slot, losers re-read for a twin, at most
``MAX_PROBE_ROUNDS`` rounds).  The table is updated in place, where the
Pallas kernel aliases it input -> output, and returned.  For a CUDA tensor
the wrapper launches the hand-written kernel ``csrc/bucket_dedup.cu`` (one
CTA per partition: the table probed in place in device memory, the claims
in shared memory, only the partition's valid lanes walked); for a CPU
tensor it runs the plain version below.  It replaces the Pallas kernel
``repro.kernels.bucket_dedup``.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import EMPTY
from repro_torch.core.hashset import MAX_PROBE_ROUNDS, _I32_MAX, _probe_geometry
from repro_torch.kernels import _build

# Largest table slice (slots) one CTA takes: its claim array, one int32 a
# slot, lives in shared memory (64 KB).  Valid lanes a CTA keeps in shared
# memory (12 bytes each); the rest go to a scratch row of lane indices.  The
# same values are kSlice and kList in csrc/bucket_dedup.cu; tests hold them
# equal.
SLICE = 16384
LIST = 3072
launches = 0  # kernel launches by ``bucket_dedup`` since the last reset


def bucket_dedup_plain(keys_hi, keys_lo, valid, table_hi, table_lo, stats=None):
    """The plain PyTorch version.  All partitions run in one flat batched
    insert: slot indices carry the partition's offset, so only lanes of the
    same partition ever compete for a slot, and a partition whose lanes are
    all done simply idles until the others finish — the same tables,
    verdicts and per-partition overflow as inserting partition by partition.

    A ``stats`` dict, if given, receives the work this input needed:
    ``probes`` (active lanes summed over rounds), ``rounds``, and the
    distinct 32-byte sectors of one table word array that a probe read
    (``read_sectors``) and that a new key was written to (``write_sectors``).
    """
    n_parts, part_len = keys_hi.shape
    cap = table_hi.shape[1]
    dev = keys_hi.device
    th, tl = table_hi.view(-1), table_lo.view(-1)
    khi, klo = keys_hi.reshape(-1), keys_lo.reshape(-1)
    base, step, mask = _probe_geometry(khi, klo, cap)
    off = torch.arange(n_parts, device=dev).repeat_interleave(part_len) * cap
    lane = torch.arange(part_len, device=dev).repeat(n_parts)
    claim = torch.full((n_parts * cap,), _I32_MAX, dtype=torch.int64, device=dev)
    done = ~valid.reshape(-1)
    is_new = torch.zeros_like(done)
    rnd = probes = 0
    if stats is not None:  # 8 int32 slots to a sector
        read = torch.zeros((n_parts * cap + 7) // 8, dtype=torch.bool, device=dev)
        written = torch.zeros_like(read)
    while rnd < MAX_PROBE_ROUNDS and not bool(done.all()):
        slot = off + ((base + rnd * step) & mask)
        occ_hi, occ_lo = th[slot], tl[slot]
        active = ~done
        if stats is not None:
            probes += int(active.sum())
            read[slot[active] >> 3] = True
        found = active & (occ_hi == khi) & (occ_lo == klo)
        empty = active & (occ_hi == EMPTY) & (occ_lo == EMPTY)
        claim.scatter_reduce_(0, slot[empty], lane[empty], reduce="amin")
        won = empty & (claim[slot] == lane)
        claim[slot[empty]] = _I32_MAX
        th[slot[won]] = khi[won]
        tl[slot[won]] = klo[won]
        lost = active & ~found & ~won
        twin = lost & (th[slot] == khi) & (tl[slot] == klo)
        done = done | found | won | twin
        is_new = is_new | won
        if stats is not None:
            written[slot[won] >> 3] = True
        rnd += 1
    if stats is not None:
        stats.update(probes=probes, rounds=rnd, read_sectors=int(read.sum()),
                     write_sectors=int(written.sum()))
    return (
        table_hi, table_lo,
        is_new.view(n_parts, part_len),
        (~done).view(n_parts, part_len).any(dim=1),
    )


def bucket_dedup(keys_hi, keys_lo, valid, table_hi, table_lo):
    """keys int32[n_parts, part_len] x2, valid bool[n_parts, part_len],
    table int32[n_parts, cap] x2 (updated in place) -> (table_hi, table_lo,
    is_new bool[n_parts, part_len], overflow bool[n_parts])."""
    n_parts, part_len = keys_hi.shape
    cap = table_hi.shape[1]
    if table_hi.shape[0] != n_parts or cap & (cap - 1):
        raise ValueError(f"table {tuple(table_hi.shape)} does not fit keys "
                         f"{tuple(keys_hi.shape)} (n_parts rows, pow2 capacity)")
    if keys_hi.device.type == "cpu":
        return bucket_dedup_plain(keys_hi, keys_lo, valid, table_hi, table_lo)
    if keys_hi.device.type != "cuda":
        raise ValueError(f"bucket_dedup runs on cuda or cpu tensors, not {keys_hi.device}")
    if cap > SLICE:
        raise ValueError(f"a table slice of {cap} slots exceeds the {SLICE} whose "
                         "claims fit in one CTA's shared memory; use more partitions")
    ints = (keys_hi, keys_lo, table_hi, table_lo)
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in ints) or (
        valid.dtype != torch.bool or not valid.is_contiguous()
    ):
        raise ValueError("bucket_dedup takes contiguous int32 keys/tables and bool valid")
    if any(t.device != keys_hi.device for t in (keys_lo, valid, table_hi, table_lo)):
        raise ValueError("bucket_dedup operands must be on one device")
    is_new = torch.empty((n_parts, part_len), dtype=torch.bool, device=keys_hi.device)
    ovf = torch.empty(n_parts, dtype=torch.bool, device=keys_hi.device)
    if n_parts == 0 or part_len == 0:
        return table_hi, table_lo, is_new, ovf.fill_(False)
    # the valid lanes past the first LIST of a partition, as lane indices
    spill = torch.empty((n_parts, part_len - min(part_len, LIST)), dtype=torch.int32,
                        device=keys_hi.device)
    lib = _build.library("bucket_dedup")
    rc = lib.bucket_dedup_launch(
        keys_hi.data_ptr(), keys_lo.data_ptr(), valid.data_ptr(),
        table_hi.data_ptr(), table_lo.data_ptr(), is_new.data_ptr(),
        ovf.data_ptr(), spill.data_ptr(), n_parts, part_len, cap, spill.shape[1],
        torch.cuda.current_stream(keys_hi.device).cuda_stream,
        keys_hi.device.index or 0,
    )
    _build.check(lib, rc, "bucket_dedup")
    global launches
    launches += 1
    return table_hi, table_lo, is_new, ovf


def ctas_per_sm(part_len: int, cap: int, device=None) -> int:
    """CTAs of the kernel one SM holds at once at this shape (the CUDA
    occupancy calculator on the card)."""
    device = torch.device(device or "cuda")
    return _build.library("bucket_dedup").bucket_dedup_ctas_per_sm(
        part_len, cap, device.index or 0)
