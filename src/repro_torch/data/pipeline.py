"""Fixed-shape batching for jit-stable streaming execution.

The executor streams encoded columns through jitted operators; XLA requires
static shapes, so the tail batch is padded and carries a validity mask.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Batch(NamedTuple):
    arrays: dict[str, np.ndarray]  # each int32[batch_size]
    valid: np.ndarray              # bool[batch_size]
    start: int                     # global row offset of this batch


def batches(
    columns: dict[str, np.ndarray], batch_size: int
) -> Iterator[Batch]:
    if not columns:
        return
    n = len(next(iter(columns.values())))
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        size = end - start
        pad = batch_size - size
        arrays = {}
        for name, col in columns.items():
            chunk = col[start:end]
            if pad:
                chunk = np.concatenate([chunk, np.zeros(pad, dtype=chunk.dtype)])
            arrays[name] = chunk
        valid = np.zeros(batch_size, dtype=bool)
        valid[:size] = True
        yield Batch(arrays=arrays, valid=valid, start=start)


def pick_batch_size(n_rows: int, target: int = 1 << 16) -> int:
    """Batch size heuristic: one batch for small inputs, else the target."""
    if n_rows <= target:
        return max(int(np.int64(1) << int(np.ceil(np.log2(max(n_rows, 2))))), 2)
    return target
