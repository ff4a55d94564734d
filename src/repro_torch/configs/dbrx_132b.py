"""dbrx-132b — MoE LM: 40L, d_model 6144, 48H GQA(kv=8), d_ff 10752/expert,
16 experts top-4 (fine-grained), vocab 100352 [hf:databricks/dbrx-base].

The JAX package's configuration, unchanged (``dtype`` is ``torch.bfloat16``
by ``LMConfig``'s default).
"""

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        head_dim=128,
        d_ff=10752,
        vocab=100352,
        moe=True,
        n_experts=16,
        top_k=4,
        microbatches=8,
        gated_act="silu",
        rope_theta=500_000.0,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=512, n_experts=4, top_k=2,
        dtype=torch.float32, sequence_parallel=False, attn_chunk=None, microbatches=1,
    )
