"""mixtral-8x7b — MoE LM: 32L, d_model 4096, 32H GQA(kv=8), d_ff 14336,
8 experts top-2, sliding-window attention (4096) [arXiv:2401.04088].

The SWA window is what makes the long_500k decode cell sub-quadratic: the
KV cache is a ring buffer of 4096 slots regardless of logical position.

The JAX package's configuration, unchanged (``dtype`` is ``torch.bfloat16``
by ``LMConfig``'s default).
"""

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        head_dim=128,
        d_ff=14336,
        vocab=32000,
        moe=True,
        n_experts=8,
        top_k=2,
        window=4096,
        microbatches=4,
        gated_act="silu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=512, n_experts=4, top_k=2, window=8,
        dtype=torch.float32, sequence_parallel=False, attn_chunk=None, microbatches=1,
    )
