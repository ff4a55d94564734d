"""Host-side data layer: columnar sources, dictionary encoding, batching,
and the synthetic graphs and neighbor sampler of the GNNs (``graphs``)."""
