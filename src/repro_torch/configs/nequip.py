"""nequip — E(3)-equivariant GNN: 5 layers, 32 channels, l_max 2, 8 RBFs,
cutoff 5 [arXiv:2101.03164].

The JAX package's configuration, unchanged.
"""

import dataclasses

from repro_torch.models.gnn.nequip import NequIPConfig


def config() -> NequIPConfig:
    return NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0)


def smoke_config() -> NequIPConfig:
    return dataclasses.replace(config(), n_layers=2, channels=8)
