"""Predicate Join Tuple Table, in plain PyTorch.

The counterpart of ``repro.core.pjtt``: the PJTT maps
``value(join condition) -> {subjects of the parent triples map}`` so that
an Object Join Map becomes an index join (one probe per child row) instead
of a nested-loop join.  Two interchangeable strategies:

* **sorted** — parent ``(key, subject)`` pairs are sorted once; a probe is
  a pair of ``searchsorted`` calls giving a ``[start, end)`` span.
* **hash** — an open-addressing int32 map ``key -> (start, count)`` into
  the same sorted subjects; a probe is a double-hash loop.

Both expand spans into a padded-ragged ``(m, max_matches)`` block with a
validity mask.  Duplicate parent pairs stay in the span but are masked
with a ``-1`` subject (set semantics).

Join keys and subjects are dictionary ids (int32, >= 0), so signed order is
the JAX package's order.  The hash map's slot arithmetic (uint32 in JAX)
runs on int64 lanes masked to the power-of-two capacity, as in
``hashset.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing
from repro_torch.core.hashset import next_pow2

MAX_PROBE_ROUNDS = 64
_KEY_EMPTY = -1  # join keys are dictionary ids >= 0
_SUBJ_MASKED = -1
_I32_MAX = 2**31 - 1


class PJTTSorted(NamedTuple):
    skeys: torch.Tensor  # int32[n]  parent join-key values, sorted
    ssubj: torch.Tensor  # int32[n]  parent subject values, co-sorted; -1 = dup


class PJTTHash(NamedTuple):
    tkey: torch.Tensor    # int32[cap]  join-key or -1 (empty)
    tstart: torch.Tensor  # int32[cap]  span start into ssubj
    tcount: torch.Tensor  # int32[cap]  span length
    ssubj: torch.Tensor   # int32[n]    sorted subjects; -1 = dup


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


def _slot_geometry(keys: torch.Tensor, cap: int):
    """(base, step, mask) of the double hash of int32 join keys, as int64
    lanes: the ``mix64`` key of each join key, as in the JAX version."""
    hi, lo = hashing.mix64([keys])
    mask = cap - 1
    base = hashing.u32(lo) & mask
    step = ((hashing.u32(hi) | 1) & mask) | 1
    return base, step, mask


def build_hash(keys: torch.Tensor, subjects: torch.Tensor) -> PJTTHash:
    """Build the hash-strategy PJTT: group via sort, then insert each unique
    key with its (start, count) span into an open-addressing map.  The
    lowest sorted position wins a contested empty slot (a scatter-min), and
    a key that finds no slot within ``MAX_PROBE_ROUNDS`` is left out, as in
    the JAX version."""
    n = keys.shape[0]
    dev = keys.device
    skeys, ssubj0 = _lexsort_pairs(keys, subjects)
    ssubj = _mask_dups(skeys, ssubj0)

    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = skeys[1:] != skeys[:-1]
    seg_id = torch.cumsum(is_start, 0) - 1  # group index per sorted row
    lane_count = torch.bincount(seg_id, minlength=n)[seg_id].to(torch.int32)
    pos = torch.arange(n, dtype=torch.int64, device=dev)

    cap = next_pow2(int(n / 0.7) + 1)
    tkey = torch.full((cap,), _KEY_EMPTY, dtype=torch.int32, device=dev)
    tstart = torch.zeros(cap, dtype=torch.int32, device=dev)
    tcount = torch.zeros(cap, dtype=torch.int32, device=dev)
    base, step, mask = _slot_geometry(skeys, cap)
    claim = torch.full((cap,), _I32_MAX, dtype=torch.int64, device=dev)
    done = ~is_start  # only span starts insert
    rnd = 0
    while rnd < MAX_PROBE_ROUNDS and not bool(done.all()):
        slot = (base + rnd * step) & mask
        empty = ~done & (tkey[slot] == _KEY_EMPTY)
        claim.scatter_reduce_(0, slot[empty], pos[empty], reduce="amin")
        won = empty & (claim[slot] == pos)
        claim[slot[empty]] = _I32_MAX
        w = slot[won]
        tkey[w] = skeys[won]
        tstart[w] = pos[won].to(torch.int32)
        tcount[w] = lane_count[won]
        # keys are unique among active lanes (only span starts are active),
        # so no same-key twin handling is needed here
        done = done | won
        rnd += 1
    return PJTTHash(tkey=tkey, tstart=tstart, tcount=tcount, ssubj=ssubj)


def probe_hash(
    pjtt: PJTTHash, child_keys: torch.Tensor, max_matches: int
) -> ProbeResult:
    cap = pjtt.tkey.shape[0]
    m = child_keys.shape[0]
    dev = child_keys.device
    base, step, mask = _slot_geometry(child_keys, cap)
    done = torch.zeros(m, dtype=torch.bool, device=dev)
    start = torch.zeros(m, dtype=torch.int32, device=dev)
    cnt = torch.zeros(m, dtype=torch.int32, device=dev)
    rnd = 0
    while rnd < MAX_PROBE_ROUNDS and not bool(done.all()):
        slot = (base + rnd * step) & mask
        occ = pjtt.tkey[slot]
        active = ~done
        hit = active & (occ == child_keys)
        empty = active & (occ == _KEY_EMPTY)
        done = done | hit | empty
        start = torch.where(hit, pjtt.tstart[slot], start)
        cnt = torch.where(hit, pjtt.tcount[slot], cnt)
        rnd += 1
    return _expand_spans(pjtt.ssubj, start, cnt, max_matches)


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
