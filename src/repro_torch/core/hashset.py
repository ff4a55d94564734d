"""Fixed-capacity open-addressing hash set, in plain PyTorch.

The counterpart of ``repro.core.hashset``: a *batched* insert over a flat
pair of 32-bit key arrays (int32 bit patterns, ``EMPTY`` = -1):

  round r:   slot_r(k) = (base(k) + r * step(k)) mod capacity      (double hash)
    1. gather occupants at every active key's slot
    2. keys whose occupant == key           -> done, duplicate
    3. keys whose occupant is EMPTY         -> try to claim: scatter-min the
       candidate's batch index into an arbitration array; exactly one winner
       per slot, the lowest lane.  Winners write their key and are done, new.
    4. losers re-read the slot after the winners' writes: if the new occupant
       equals their key (a same-key twin won), they are done, duplicate;
       otherwise they advance to round r+1.

JAX's out-of-range ``.at[...].set(mode="drop")`` becomes masking before the
index: an out-of-range index on CUDA is a device-side assert.  ``insert``
is functional like the JAX version (it returns a new table).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.hashing import EMPTY, u32

MAX_PROBE_ROUNDS = 64
_I32_MAX = 2**31 - 1


class HashSet(NamedTuple):
    """State of the set: parallel (hi, lo) int32 key arrays, power-of-two sized."""

    hi: torch.Tensor  # int32[capacity]
    lo: torch.Tensor  # int32[capacity]

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]


class InsertResult(NamedTuple):
    table: HashSet
    is_new: torch.Tensor      # bool[n]  True -> key was not present before
    overflowed: torch.Tensor  # bool[]   some key exhausted MAX_PROBE_ROUNDS


def next_pow2(n: int) -> int:
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


def make(capacity: int, device="cuda") -> HashSet:
    """Allocate an empty set.  ``capacity`` is rounded up to a power of two;
    keep load factor <= 0.7 (the planner enforces this)."""
    cap = next_pow2(capacity)
    return HashSet(
        hi=torch.full((cap,), EMPTY, dtype=torch.int32, device=device),
        lo=torch.full((cap,), EMPTY, dtype=torch.int32, device=device),
    )


def _probe_geometry(key_hi: torch.Tensor, key_lo: torch.Tensor, cap: int):
    """(base, step, mask) of the double hash, as int64 lanes."""
    mask = cap - 1
    base = u32(key_lo) & mask
    step = ((u32(key_hi) | 1) & mask) | 1  # odd -> coprime with pow2 capacity
    return base, step, mask


def _insert_impl(
    table: HashSet,
    key_hi: torch.Tensor,
    key_lo: torch.Tensor,
    done0: torch.Tensor,
) -> InsertResult:
    cap = table.capacity
    n = key_hi.shape[0]
    base, step, mask = _probe_geometry(key_hi, key_lo, cap)
    idx = torch.arange(n, dtype=torch.int64, device=key_hi.device)
    hi, lo = table.hi.clone(), table.lo.clone()
    claim = torch.full((cap,), _I32_MAX, dtype=torch.int64, device=key_hi.device)
    done = done0.clone()
    is_new = torch.zeros(n, dtype=torch.bool, device=key_hi.device)
    rnd = 0
    while True:  # a first round, then one more while a key still probes
        slot = (base + rnd * step) & mask
        occ_hi, occ_lo = hi[slot], lo[slot]
        active = ~done
        found = active & (occ_hi == key_hi) & (occ_lo == key_lo)
        empty = active & (occ_hi == EMPTY) & (occ_lo == EMPTY)

        # arbitrate empty-slot claims: scatter-min of the batch index, so
        # exactly one winner per slot — the lowest lane
        claim.scatter_reduce_(0, slot[empty], idx[empty], reduce="amin")
        won = empty & (claim[slot] == idx)
        claim[slot[empty]] = _I32_MAX
        hi[slot[won]] = key_hi[won]
        lo[slot[won]] = key_lo[won]

        # losers re-read: a same-key twin that won this round makes this key
        # a duplicate; without this re-check the twin would be inserted twice
        lost = active & ~found & ~won
        twin = lost & (hi[slot] == key_hi) & (lo[slot] == key_lo)

        done = done | found | won | twin
        is_new = is_new | won
        rnd += 1
        if rnd >= MAX_PROBE_ROUNDS or bool(done.all()):
            break
    return InsertResult(
        table=HashSet(hi=hi, lo=lo), is_new=is_new, overflowed=~done.all()
    )


def insert(table: HashSet, key_hi: torch.Tensor, key_lo: torch.Tensor) -> InsertResult:
    """Batched insert of n keys.  Returns the updated table, an ``is_new``
    mask, and an overflow flag (True if any key could not be placed within
    MAX_PROBE_ROUNDS — the caller must rebuild with a larger capacity)."""
    done0 = torch.zeros(key_hi.shape[0], dtype=torch.bool, device=key_hi.device)
    return _insert_impl(table, key_hi, key_lo, done0)


def insert_masked(
    table: HashSet, key_hi: torch.Tensor, key_lo: torch.Tensor, valid: torch.Tensor
) -> InsertResult:
    """Insert only lanes where ``valid``; invalid lanes report is_new=False."""
    return _insert_impl(table, key_hi, key_lo, ~valid)


def contains(table: HashSet, key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """Batched membership probe (no mutation)."""
    cap = table.capacity
    n = key_hi.shape[0]
    base, step, mask = _probe_geometry(key_hi, key_lo, cap)
    done = torch.zeros(n, dtype=torch.bool, device=key_hi.device)
    found = torch.zeros(n, dtype=torch.bool, device=key_hi.device)
    rnd = 0
    while rnd < MAX_PROBE_ROUNDS and not bool(done.all()):
        slot = (base + rnd * step) & mask
        occ_hi, occ_lo = table.hi[slot], table.lo[slot]
        active = ~done
        hit = active & (occ_hi == key_hi) & (occ_lo == key_lo)
        empty = active & (occ_hi == EMPTY) & (occ_lo == EMPTY)
        done = done | hit | empty
        found = found | hit
        rnd += 1
    return found


def count(table: HashSet) -> torch.Tensor:
    """Number of occupied slots (= number of distinct keys inserted)."""
    return (~((table.hi == EMPTY) & (table.lo == EMPTY))).sum().to(torch.int32)
