"""The GNN family: GAT, MeshGraphNet, NequIP and EquiformerV2 over the
segment ops of :mod:`repro_torch.models.gnn.common` and the SO(3)
machinery of :mod:`repro_torch.models.gnn.so3`."""
