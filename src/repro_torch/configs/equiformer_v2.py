"""equiformer-v2 — SO(2)-eSCN equivariant graph attention: 12 layers,
128 channels, l_max 6, m_max 2, 8 heads [arXiv:2306.12059].

The JAX package's configuration, unchanged.
"""

import dataclasses

from repro_torch.models.gnn.equiformer import EquiformerConfig


def config() -> EquiformerConfig:
    return EquiformerConfig(
        n_layers=12, channels=128, l_max=6, m_max=2, n_heads=8
    )


def smoke_config() -> EquiformerConfig:
    return dataclasses.replace(
        config(), n_layers=2, channels=16, l_max=3, n_heads=4
    )
