"""Gradient compression: int8 quantization with error feedback.

The counterpart of ``repro.train.compression``: each gradient leaf plus
the carried error is quantized to int8 with one fp32 scale, dequantized,
and the quantization error carried to the next step (error feedback keeps
SGD converging: Seide et al., 1-bit SGD; Karimireddy et al., EF-SGD).  The
int8 tensor is what a data-parallel reduce would move.  Both packages round
half to even, and every division here is a true division on either device,
so on the same gradients the result equals an op-by-op JAX run's bit for
bit.
"""

from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten


def _quantize_leaf(g: torch.Tensor):
    amax = torch.amax(torch.abs(g))
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_decompress(grads, error_fb=None):
    """Quantize each gradient leaf to int8 (and an fp32 scale), dequantize,
    and carry the quantization error to the next step.

    Returns (grads', error_fb'); ``error_fb=None`` starts from zeros.
    """
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
    deq, err = [], []
    for g, e in zip(leaves(grads), leaves(error_fb), strict=True):
        g32 = g.to(torch.float32) + e
        q, scale = _quantize_leaf(g32)
        d = _dequantize_leaf(q, scale)
        deq.append(d)
        err.append(g32 - d)
    return unflatten(grads, deq), unflatten(grads, err)
