"""repro_torch.obs — the observability substrate: metrics + dispatch tracing.

One import surface for the three instrumented layers (``repro_torch.stream``
block ingestion, the ``repro_torch.serve`` fused executor, the batching query
server) and their consumers (the ``metrics`` wire op, ``--trace`` CLI
flags, the latency columns in ``BENCH_*.json``).

    from repro_torch import obs

    obs.get_registry().inc("serve.queries", 64)
    obs.get_registry().observe("serve.exec_ms", 1.9)
    with obs.span("dispatch", cat="serve", batch=64):
        ...
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SUBBUCKETS,
    bucket_bounds,
    bucket_index,
    get_registry,
)
from repro_torch.obs.trace import (
    Tracer,
    add_complete,
    enable_tracing,
    get_tracer,
    save_trace,
    span,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SUBBUCKETS",
    "Tracer",
    "add_complete",
    "bucket_bounds",
    "bucket_index",
    "enable_tracing",
    "get_registry",
    "get_tracer",
    "save_trace",
    "span",
    "tracing_enabled",
]
