"""Query-serving throughput measurement (shared by the CLI ``--bench`` mode
and ``benchmarks/run.py``).

The workload is single triple patterns derived from the store's own content
(every query has at least one answer): a mix of the four most common serving
masks — ``(s, p, ?)``, ``(?, p, o)``, ``(s, ?, ?)``, ``(?, ?, o)`` — executed
through the batched many-queries-per-dispatch path, which is the number that
matters for serving, not per-query Python overhead."""

from __future__ import annotations

import time

import numpy as np

from repro_torch.kg.query import match_counts
from repro_torch.kg.store import TripleStore
from repro_torch.obs import Histogram

_MASKS = ((1, 1, 0), (0, 1, 1), (1, 0, 0), (0, 0, 1))


def make_workload(store: TripleStore, n_queries: int, seed: int = 0) -> np.ndarray:
    """int32[n_queries, 3] patterns in (s, p, o) term ids, -1 = wildcard."""
    if store.n_triples == 0:
        raise ValueError("cannot build a query workload over an empty graph")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, store.n_triples, n_queries)
    spo = np.stack([store.s[rows], store.p[rows], store.o[rows]], axis=1)
    mask = np.asarray(_MASKS, np.int32)[rng.integers(0, len(_MASKS), n_queries)]
    return np.where(mask == 1, spo, np.int32(-1)).astype(np.int32)


def bench_single_pattern(
    store: TripleStore,
    n_queries: int = 50_000,
    batch: int = 4096,
    seed: int = 0,
) -> dict:
    """Time the batched single-pattern path; returns a json-ready report.
    An empty store reports a zero-query section instead of erroring, so
    the ``--bench`` CLI paths need no ad-hoc guards."""
    if store.n_triples == 0:
        return {
            "n_triples": 0,
            "n_terms": int(store.n_terms),
            "n_queries": 0,
            "batch": int(batch),
            "total_matches": 0,
            "wall_s": 0.0,
            "queries_per_s": 0.0,
            "latency_p50_ms": 0.0,
            "latency_p99_ms": 0.0,
            "empty_store": True,
        }
    workload = make_workload(store, n_queries, seed)
    # warm-up: compile every (mask-group, batch-shape) once
    total = 0
    for start in range(0, n_queries, batch):
        total += int(match_counts(store, workload[start : start + batch]).sum())
    lat = Histogram()  # per-dispatch latency -> p50/p99 for the CI gate
    t0 = time.perf_counter()
    for start in range(0, n_queries, batch):
        d0 = time.perf_counter_ns()
        match_counts(store, workload[start : start + batch])
        lat.observe((time.perf_counter_ns() - d0) / 1e6)
    dt = time.perf_counter() - t0
    return {
        "n_triples": int(store.n_triples),
        "n_terms": int(store.n_terms),
        "n_queries": int(n_queries),
        "batch": int(batch),
        "total_matches": total,
        "wall_s": dt,
        "queries_per_s": n_queries / dt,
        "latency_p50_ms": lat.percentile(50),
        "latency_p99_ms": lat.percentile(99),
        "latency_max_ms": lat.max,
    }
