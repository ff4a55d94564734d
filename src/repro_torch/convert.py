"""Carry state between the JAX package and the port.

Each function takes numpy arrays (``np.asarray`` of a JAX ``HashSet``,
``RadixTable`` or ``PJTTSorted`` field) and returns the port's structure
with tensors on ``device``.  uint32 words become int32 tensors with the same
bits; ``u32_numpy`` goes back.  This lets an insert that one package began
continue in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashset import HashSet
from repro_torch.core.pjtt import PJTTSorted
from repro_torch.kernels.ops import RadixTable


def u32_tensor(a, device="cuda") -> torch.Tensor:
    """uint32 (or int32) numpy array -> int32 bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"expected uint32 or int32 words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 numpy array (the JAX form)."""
    return t.detach().cpu().numpy().view(np.uint32)


def hashset_from_numpy(hi, lo, device="cuda") -> HashSet:
    return HashSet(hi=u32_tensor(hi, device), lo=u32_tensor(lo, device))


def radix_table_from_numpy(hi, lo, device="cuda") -> RadixTable:
    hi, lo = u32_tensor(hi, device), u32_tensor(lo, device)
    if hi.dim() != 2 or hi.shape != lo.shape:
        raise ValueError(f"a radix table is two [n_parts, cap] arrays, got "
                         f"{tuple(hi.shape)} and {tuple(lo.shape)}")
    return RadixTable(hi=hi, lo=lo)


def pjtt_sorted_from_numpy(skeys, ssubj, device="cuda") -> PJTTSorted:
    return PJTTSorted(
        skeys=torch.from_numpy(np.asarray(skeys, dtype=np.int32).copy()).to(device),
        ssubj=torch.from_numpy(np.asarray(ssubj, dtype=np.int32).copy()).to(device),
    )
