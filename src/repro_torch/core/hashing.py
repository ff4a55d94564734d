"""64-bit triple keys as (hi, lo) pairs of 32-bit words, in plain PyTorch.

The counterpart of ``repro.core.hashing``: every RDF triple is collapsed
to a 64-bit key ``h(subject, predicate, object)`` and all duplicate
elimination happens on those keys.  The mixer is murmur3's 32-bit
finalizer applied per lane with cross-lane feedback.

Storage form: a uint32 word is kept as the int32 with the same bits
(``EMPTY`` is ``-1``, i.e. ``0xFFFFFFFF``), so the CUDA kernels can read
the buffers as ``uint32_t*``.  PyTorch on the CPU has no ``>>`` for
``uint32``, so the arithmetic here runs on int64 lanes that hold values in
``[0, 2**32)`` ("u32 lanes"); products are split in 16-bit halves so that
no int64 product overflows.
"""

from __future__ import annotations

import torch

# Sentinel marking an empty hash-set slot, as an int32 bit pattern.
# ``mix64`` never returns the sentinel pair (it is explicitly remapped).
EMPTY: int = -1
_M32 = 0xFFFFFFFF

_M3_C1 = 0x85EBCA6B
_M3_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9  # 2^32 / phi — Weyl increment


def u32(x, device=None) -> torch.Tensor:
    """int32 bit patterns (or any integers) -> int64 u32 lanes."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 lanes -> int32 bit patterns (the storage form)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for u32 lanes ``h`` and a 32-bit constant ``c``."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix32(h) -> torch.Tensor:
    """murmur3 32-bit finalizer: full avalanche on u32 lanes."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, _M3_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M3_C2)
    h = h ^ (h >> 16)
    return h


def combine32(acc, word) -> torch.Tensor:
    """Fold one word into a running accumulator (boost::hash_combine style,
    with the murmur finalizer as the mixer).  u32 lanes in and out."""
    acc = u32(acc)
    word = fmix32(word)
    return fmix32(acc ^ ((word + _GOLDEN + (acc << 6) + (acc >> 2)) & _M32))


def _fmix32_int(h: int) -> int:
    """``fmix32`` of one Python int (the salt-derived seeds)."""
    h &= _M32
    h ^= h >> 16
    h = (h * _M3_C1) & _M32
    h ^= h >> 13
    h = (h * _M3_C2) & _M32
    h ^= h >> 16
    return h


def seeds(salt: int = 0) -> tuple[int, int]:
    """The two lane seeds of ``mix64`` for ``salt`` (shared with the CUDA
    kernel, which derives the same pair from the 64-bit salt)."""
    return (
        _fmix32_int(0x243F6A88 ^ (salt & _M32)),  # pi fractional
        _fmix32_int(0x13198A2E ^ ((salt >> 32) & _M32)),
    )


def mix64(words, salt: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash a sequence of broadcastable integer words to a 64-bit key
    ``(hi, lo)``, returned as int32 bit patterns.

    Two accumulator lanes are seeded differently and each absorbs every
    word; the lanes are cross-mixed at the end, and the EMPTY/EMPTY
    sentinel pair is remapped to keep it reserved for "unoccupied slot".
    """
    device = next((w.device for w in words if isinstance(w, torch.Tensor)), None)
    seed_hi, seed_lo = seeds(salt)
    hi = u32(seed_hi, device)
    lo = u32(seed_lo, device)
    for w in words:
        w = u32(w, device)
        hi = combine32(hi, w)
        lo = combine32(lo, w ^ _GOLDEN)
    # cross-lane avalanche — sequential (lo2 absorbs the *mixed* hi2) so the
    # (hi, lo) -> (hi2, lo2) map is a bijection on the full 64-bit state;
    # a parallel xor of shifted lanes collapses the key space
    hi2 = fmix32(hi ^ (lo >> 1))
    lo2 = fmix32(lo ^ hi2)
    # keep the sentinel reserved
    is_sent = (hi2 == _M32) & (lo2 == _M32)
    lo2 = torch.where(is_sent, torch.full_like(lo2, _M32 - 1), lo2)
    return to_i32(hi2), to_i32(lo2)


def triple_key(
    subj_tmpl, subj_val, pred_id, obj_tmpl, obj_val
) -> tuple[torch.Tensor, torch.Tensor]:
    """64-bit identity of an RDF triple from its dictionary-encoded parts:
    term-template ids, per-row value ids and the predicate's term id."""
    return mix64([subj_tmpl, subj_val, pred_id, obj_tmpl, obj_val])
