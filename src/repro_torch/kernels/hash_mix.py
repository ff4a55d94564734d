"""K1 ``hash_mix``: fused 64-bit triple-key mixing.

``words`` int32[W, n] (uint32 bit patterns) -> ``(hi, lo)`` int32[n], the
``mix64`` key of each column.  For a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/hash_mix.cu``; for a CPU tensor it runs the plain
version below.  It replaces the Pallas kernel ``repro.kernels.hash_mix``.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build

MAX_WORDS = 8
launches = 0  # kernel launches by ``hash_mix`` since the last reset


def hash_mix_plain(words: torch.Tensor, salt: int = 0):
    """The plain PyTorch version: ``mix64`` over the W rows."""
    return hashing.mix64([words[i] for i in range(words.shape[0])], salt=salt)


def hash_mix(words: torch.Tensor, salt: int = 0):
    """words int32[W, n] -> (hi, lo) int32[n]."""
    if words.dim() != 2 or not 1 <= words.shape[0] <= MAX_WORDS:
        raise ValueError(f"hash_mix takes words[W, n] with 1 <= W <= {MAX_WORDS}, "
                         f"got shape {tuple(words.shape)}")
    if words.device.type == "cpu":
        return hash_mix_plain(words, salt)
    if words.device.type != "cuda":
        raise ValueError(f"hash_mix runs on cuda or cpu tensors, not {words.device}")
    if words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError("hash_mix takes a contiguous int32 tensor on the card")
    n_words, n = words.shape
    hi = torch.empty(n, dtype=torch.int32, device=words.device)
    lo = torch.empty(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return hi, lo
    lib = _build.library("hash_mix")
    rc = lib.hash_mix_launch(
        words.data_ptr(), n_words, n, salt & (2**64 - 1), hi.data_ptr(),
        lo.data_ptr(), torch.cuda.current_stream(words.device).cuda_stream,
        words.device.index or 0,
    )
    _build.check(lib, rc, "hash_mix")
    global launches
    launches += 1
    return hi, lo
