"""meshgraphnet — GNN: 15 layers, d_hidden 128, sum aggregator, 2-layer MLPs
[arXiv:2010.03409].

The JAX package's configuration, unchanged.
"""

import dataclasses

from repro_torch.models.gnn.meshgraphnet import MGNConfig


def config() -> MGNConfig:
    return MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2)


def smoke_config() -> MGNConfig:
    return dataclasses.replace(config(), n_layers=3, d_hidden=32, d_in=16)
