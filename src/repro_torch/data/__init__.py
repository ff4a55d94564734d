"""Host-side data layer: columnar sources, dictionary encoding, batching."""
