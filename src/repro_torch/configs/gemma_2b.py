"""gemma-2b — dense LM: 18L, d_model 2048, 8H MQA(kv=1), head_dim 256,
d_ff 16384, vocab 256000, GeGLU, tied embeddings [arXiv:2403.08295].

The JAX package's configuration, unchanged (``dtype`` is ``torch.bfloat16``
by ``LMConfig``'s default).
"""

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma-2b",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        microbatches=2,
        gated_act="gelu",
        tie_embeddings=True,
    )


def smoke_config() -> LMConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=512, dtype=torch.float32, sequence_parallel=False, attn_chunk=None, microbatches=1,
    )
