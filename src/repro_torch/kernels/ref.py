"""Plain-PyTorch oracles for the kernels, under the names of
``repro.kernels.ref``: each points at its kernel's plain version."""

from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels.bucket_dedup import bucket_dedup_plain
from repro_torch.kernels.nested_join import nested_join_plain


def hash_mix_ref(words: list[torch.Tensor], salt: int = 0):
    """Oracle for the hash_mix kernel: the reference mixer itself."""
    return hashing.mix64(words, salt=salt)


def bucket_dedup_ref(
    keys_hi: torch.Tensor,  # int32[n_parts, part_len]
    keys_lo: torch.Tensor,
    table_hi: torch.Tensor,  # int32[n_parts, cap]
    table_lo: torch.Tensor,
    valid: torch.Tensor,     # bool[n_parts, part_len]
):
    """Per-partition open-addressing insert -> (table_hi, table_lo, is_new);
    the tables passed in are left unchanged."""
    return bucket_dedup_plain(keys_hi, keys_lo, valid, table_hi.clone(), table_lo.clone())[:3]


def nested_join_ref(
    parent_keys: torch.Tensor,
    parent_subjects: torch.Tensor,
    child_keys: torch.Tensor,
    max_matches: int,
):
    """Oracle for the nested-loop join kernel -> (subjects, valid)."""
    return nested_join_plain(parent_keys, parent_subjects, child_keys, max_matches)[:2]
