"""K3 ``nested_join``: the naive engine's all-pairs equality join.

``child_keys`` int32[m] against ``parent_keys`` / ``parent_subjects``
int32[n] -> ``(subjects int32[m, K], valid bool[m, K], truncated bool[])``:
row ``i`` holds the first ``K`` parent subjects whose key equals
``child_keys[i]``, in parent index order, padded with ``-1``;
``valid = (col < count) & (subjects != -1)``; ``truncated`` is true where a
row has more than ``K`` matches.  For a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/nested_join.cu`` (one thread per child row,
parent tiles through shared memory); for a CPU tensor it runs the plain
version below.  It replaces the Pallas kernel ``repro.kernels.nested_join``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# The plain version compares one block of child rows with all parents at
# once; a block holds at most this many (row, parent) pairs.
PLAIN_BLOCK_PAIRS = 1 << 24
launches = 0  # kernel launches by ``nested_join`` since the last reset


def _finish(subjects: torch.Tensor, counts: torch.Tensor, max_matches: int):
    """(subjects, counts) -> (subjects, valid, truncated), as the JAX
    wrapper derives them after its ``pallas_call``."""
    offs = torch.arange(max_matches, device=subjects.device)[None, :]
    valid = (offs < counts[:, None]) & (subjects != -1)
    return subjects, valid, (counts > max_matches).any()


def nested_join_plain(parent_keys, parent_subjects, child_keys, max_matches: int):
    """The plain PyTorch version: the JAX ``nested_loop_join``, blocked over
    child rows.  Within a block, ``nonzero`` of the (rows, n) equality
    matrix lists each row's matches in parent order; a match's rank in its
    row is its column in the output."""
    m, n, K = child_keys.shape[0], parent_keys.shape[0], max_matches
    dev = child_keys.device
    subjects = torch.full((m, K), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    rows = max(1, PLAIN_BLOCK_PAIRS // max(n, 1))
    for s in range(0, m, rows):
        ck = child_keys[s:s + rows]
        eq = ck[:, None] == parent_keys[None, :]
        cnt = eq.sum(dim=1)
        counts[s:s + ck.shape[0]] = cnt
        r, c = eq.nonzero(as_tuple=True)
        rank = torch.arange(r.shape[0], device=dev) - (cnt.cumsum(0) - cnt)[r]
        keep = rank < K
        subjects[s + r[keep], rank[keep]] = parent_subjects[c[keep]].to(torch.int32)
    return _finish(subjects, counts, K)


def nested_join(parent_keys, parent_subjects, child_keys, max_matches: int):
    """parent_keys, parent_subjects int32[n], child_keys int32[m] ->
    (subjects int32[m, K], valid bool[m, K], truncated bool[])."""
    K = int(max_matches)
    if K < 1:
        raise ValueError(f"nested_join needs max_matches >= 1, got {max_matches}")
    ints = (parent_keys, parent_subjects, child_keys)
    if any(t.dim() != 1 for t in ints) or parent_keys.shape != parent_subjects.shape:
        raise ValueError("nested_join takes parent keys and subjects [n] and child keys [m]")
    if any(t.device != child_keys.device for t in ints):
        raise ValueError("nested_join operands must be on one device")
    if child_keys.device.type == "cpu":
        return nested_join_plain(parent_keys, parent_subjects, child_keys, K)
    if child_keys.device.type != "cuda":
        raise ValueError(f"nested_join runs on cuda or cpu tensors, not {child_keys.device}")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in ints):
        raise ValueError("nested_join takes contiguous int32 tensors on the card")
    m, n = child_keys.shape[0], parent_keys.shape[0]
    if n >= 2**31:
        raise ValueError(f"nested_join takes fewer than 2**31 parent rows, got {n}")
    dev = child_keys.device
    subjects = torch.empty((m, K), dtype=torch.int32, device=dev)
    counts = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return _finish(subjects, counts, K)
    lib = _build.library("nested_join")
    rc = lib.nested_join_launch(
        parent_keys.data_ptr(), parent_subjects.data_ptr(), child_keys.data_ptr(),
        n, m, K, subjects.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0,
    )
    _build.check(lib, rc, "nested_join")
    global launches
    launches += 1
    return _finish(subjects, counts, K)
