"""command-r-plus-104b — dense LM: 64L, d_model 12288, 96H GQA(kv=8),
d_ff 33792, vocab 256000, no bias, tied embeddings
[hf:CohereForAI/c4ai-command-r-plus].

The JAX package's configuration, unchanged (``dtype`` is ``torch.bfloat16``
by ``LMConfig``'s default).
"""

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="command-r-plus-104b",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv=8,
        head_dim=128,
        d_ff=33792,
        vocab=256000,
        microbatches=8,
        gated_act="silu",
        tie_embeddings=True,
        rope_theta=75_000_000.0,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=96, n_heads=6, n_kv=2, head_dim=16,
        d_ff=192, vocab=512, dtype=torch.float32, sequence_parallel=False, attn_chunk=None, microbatches=1,
    )
