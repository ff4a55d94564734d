"""gat-cora — GNN: 2 layers, 8 hidden, 8 heads, attention aggregation
[arXiv:1710.10903].

The JAX package's configuration, unchanged.
"""

import dataclasses

from repro_torch.models.gnn.gat import GATConfig


def config() -> GATConfig:
    return GATConfig(n_layers=2, d_hidden=8, n_heads=8)


def smoke_config() -> GATConfig:
    return dataclasses.replace(config(), d_in=32)
