"""wide-deep — recsys: 40 sparse fields, embed_dim 32, MLP 1024-512-256,
concat interaction [arXiv:1606.07792].  Vocab per field: 2^20 = 1,048,576
(hash-bucketed).  The JAX package's configuration, unchanged."""

import dataclasses

from repro_torch.models.recsys import WideDeepConfig


def config() -> WideDeepConfig:
    return WideDeepConfig(
        n_sparse=40, embed_dim=32, vocab_per_field=1 << 20,
        n_dense=13, mlp=(1024, 512, 256),
    )


def dedup_config() -> WideDeepConfig:
    """The paper-technique variant: PTT-style dedup-gather on the id
    stream (the cap is set per batch)."""
    return dataclasses.replace(config(), dedup_cap=None)


def smoke_config() -> WideDeepConfig:
    return dataclasses.replace(
        config(), n_sparse=6, vocab_per_field=1000, mlp=(64, 32, 16)
    )
