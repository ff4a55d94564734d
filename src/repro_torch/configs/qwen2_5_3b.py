"""qwen2.5-3b — dense LM: 36L, d_model 2048, 16H GQA(kv=2), d_ff 11008,
vocab 151936, QKV bias [hf:Qwen/Qwen2.5-3B].

The JAX package's configuration, unchanged (``dtype`` is ``torch.bfloat16``
by ``LMConfig``'s default).
"""

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv=2,
        head_dim=128,
        d_ff=11008,
        vocab=151936,
        qkv_bias=True,
        gated_act="silu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, dtype=torch.float32, sequence_parallel=False, attn_chunk=None, microbatches=1,
    )
