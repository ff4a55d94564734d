"""Serving throughput for the fused query pipeline (``BENCH_serve.json``).

Six query classes over the paper's testbed store, each at batch sizes
1 / 64 / 4096 through the pre-encoded executor hot path (the same unit of
work ``repro_torch.kg.bench`` measures for single patterns, so the numbers are
directly comparable to ``BENCH_kg.json``):

* ``single``     — ``?s <p> <o>`` point lookups;
* ``bgp3``       — a 3-pattern star BGP anchored at a selective constant
  (two sorted-merge joins fused into the dispatch);
* ``opt_filter`` — 2 required patterns + ``OPTIONAL`` + ``FILTER`` (join,
  left-join backfill and side-table filtering in one dispatch);
* ``union``      — an anchored pattern joined with a 2-arm ``UNION``
  (shared required scan, fused concat-with-provenance);
* ``orderby``    — an anchored 2-pattern BGP under ``ORDER BY DESC``
  (value-typed rank sort on device);
* ``groupcount`` — an anchored 3-pattern BGP under ``GROUP BY`` +
  ``COUNT`` (key sort + segment-sum in the same dispatch).

Every query is derived from an existing triple, so every query has at
least one answer.  Constants vary per query; the plan (and the compiled
pipeline) is shared per class — exactly the server's steady state.

A separate ``smallbatch`` section times the interactive regime: the
``single`` and ``bgp3`` classes at batch 1 / 8 / 64, where dispatches
route through the fused scan-join fast path (``repro_torch.serve.fastpath``).
Its ``latency_p99_ms`` leaves are what the CI regression gate watches
for the per-dispatch constant, and ``fastpath_dispatches`` records the
routing share so a silently disabled fast path is visible in the report.

An empty store yields the zero-query report (:func:`empty_report`) —
sections exist, counts are zero — instead of erroring, so ``--bench``
CLI paths and CI never need ad-hoc guards.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.kg.store import TripleStore
from repro_torch.obs import Histogram
from repro_torch.serve import algebra as A
from repro_torch.serve import plan as P
from repro_torch.serve.exec import Executor, get_executor

BATCH_SIZES = (1, 64, 4096)

CLASS_NAMES = ("single", "bgp3", "opt_filter", "union", "orderby", "groupcount")

# the interactive regime: the small-batch fast path's own section
# (single and bgp3 are chain-eligible; batch sizes bracket the
# fast path's routing window)
SMALLBATCH_SIZES = (1, 8, 64)
SMALLBATCH_CLASSES = ("single", "bgp3")


def empty_report(
    store: TripleStore, batch_sizes: tuple[int, ...] = BATCH_SIZES
) -> dict:
    """The zero-query report for an empty store: every class/batch section
    present with zero counts, so downstream consumers (CI gate, json
    diffing) see the same shape as a real run."""
    zero = {
        "n_queries": 0,
        "n_batches": 0,
        "wall_s": 0.0,
        "queries_per_s": 0.0,
        "warm_matches": 0,
        "latency_p50_ms": 0.0,
        "latency_p99_ms": 0.0,
        "latency_max_ms": 0.0,
    }
    return {
        "n_triples": int(store.n_triples),
        "n_terms": int(store.n_terms),
        "empty_store": True,
        "classes": {
            name: {
                "query": None,
                "batches": {str(b): dict(zero) for b in batch_sizes},
            }
            for name in CLASS_NAMES
        },
        "smallbatch": {
            name: {
                "query": None,
                "batches": {str(b): dict(zero) for b in SMALLBATCH_SIZES},
            }
            for name in SMALLBATCH_CLASSES
        },
    }


def _workload_preds(store: TripleStore) -> list[int]:
    """Predicate term ids sorted by frequency (most common last)."""
    ids, counts = np.unique(store.p, return_counts=True)
    return [int(t) for t in ids[np.argsort(counts)]]


def _anchor_pool(store: TripleStore, p0: int, seed: int) -> np.ndarray:
    """Object ids of ``p0`` triples — each anchors a non-empty query."""
    rows = np.nonzero(store.p == p0)[0]
    rng = np.random.default_rng(seed)
    return store.o[rows[rng.integers(0, len(rows), 1 << 16)]]


def _classes(store: TripleStore):
    """(name, representative query text, anchor scan pattern_pos)."""
    preds = _workload_preds(store)
    if len(preds) < 3:
        raise ValueError("serve bench needs >= 3 predicates in the store")
    p0, p1, p2 = preds[0], preds[1], preds[2]
    t0, t1, t2 = (store.decode_term(p) for p in (p0, p1, p2))
    some_o = store.decode_term(int(_anchor_pool(store, p0, 0)[0]))
    return p0, [
        ("single", f"?s {t0} {some_o}"),
        ("bgp3", f"?m {t0} {some_o} . ?m {t1} ?b . ?m {t2} ?c"),
        (
            "opt_filter",
            f"SELECT * WHERE {{ ?m {t0} {some_o} . ?m {t1} ?b "
            f'OPTIONAL {{ ?m {t2} ?c }} FILTER(?b != "@none@") }}',
        ),
        (
            "union",
            f"SELECT * WHERE {{ ?m {t0} {some_o} "
            f"{{ ?m {t1} ?b }} UNION {{ ?m {t2} ?b }} }}",
        ),
        (
            "orderby",
            f"SELECT ?m ?b WHERE {{ ?m {t0} {some_o} . ?m {t1} ?b }} "
            "ORDER BY DESC(?b)",
        ),
        (
            "groupcount",
            f"SELECT ?b (COUNT(?c) AS ?n) WHERE {{ ?m {t0} {some_o} . "
            f"?m {t1} ?b . ?m {t2} ?c }} GROUP BY ?b",
        ),
    ]


def _encoded_batches(
    executor: Executor,
    qtext: str,
    p0: int,
    batch: int,
    n_batches: int,
    seed: int,
):
    """Pre-encode ``n_batches`` constants batches: the representative
    query's encoding tiled, with the anchor object id varied per query."""
    store = executor.store
    q = A.parse_select(qtext)
    plan = executor.plan(q)
    rep = P.encode_scan_consts(store, plan, q)
    # the anchor scan is the one reading pattern 0 (the only pattern whose
    # object slot holds a constant anchored at p0)
    anchor_scan = next(
        i for i, s in enumerate(plan.scans) if s.pattern_pos == 0
    )
    fops = None
    if plan.n_filter_ops:
        from repro_torch.serve.values import value_table

        f1 = P.encode_filter_ops(store, value_table(store), q.filters)
        fops = np.tile(f1, (batch, 1))
    pool = _anchor_pool(store, p0, seed)
    batches = []
    for b in range(n_batches):
        consts = np.tile(rep, (batch, 1, 1))
        consts[:, anchor_scan, 2] = pool[b * batch : (b + 1) * batch]
        batches.append(consts)
    return plan, batches, fops


def bench_serve(
    store: TripleStore,
    batch_sizes: tuple[int, ...] = BATCH_SIZES,
    target_queries: int = 50_000,
    seed: int = 0,
) -> dict:
    """Time every query class at every batch size; returns a json-ready
    report keyed ``{class: {batch: {queries_per_s, ...}}}``.  Empty
    stores report zero-query sections instead of erroring."""
    if store.n_triples == 0:
        return empty_report(store, batch_sizes)
    executor = get_executor(store)
    p0, classes = _classes(store)
    report: dict = {
        "n_triples": int(store.n_triples),
        "n_terms": int(store.n_terms),
        "classes": {},
    }
    for name, qtext in classes:
        per_batch = {}
        for batch in batch_sizes:
            n_batches = max(1, min(target_queries // batch, 64))
            plan, batches, fops = _encoded_batches(
                executor, qtext, p0, batch, n_batches, seed
            )
            # warm-up: compile + let the capacity feedback converge
            total = 0
            for consts in batches[: max(2, n_batches // 8)]:
                total += int(
                    executor.execute_encoded(plan, consts, fops).counts.sum()
                )
            # per-dispatch latency lands in an obs histogram: p50/p99 are
            # what the CI tail-latency gate consumes (<= 6.25% bucket
            # error, far inside the 50% gate threshold)
            lat = Histogram()
            t0 = time.perf_counter()
            for consts in batches:
                d0 = time.perf_counter_ns()
                executor.execute_encoded(plan, consts, fops)
                lat.observe((time.perf_counter_ns() - d0) / 1e6)
            dt = time.perf_counter() - t0
            n_queries = n_batches * batch
            per_batch[str(batch)] = {
                "n_queries": n_queries,
                "n_batches": n_batches,
                "wall_s": dt,
                "queries_per_s": n_queries / dt,
                "warm_matches": total,
                "latency_p50_ms": lat.percentile(50),
                "latency_p99_ms": lat.percentile(99),
                "latency_max_ms": lat.max,
            }
        report["classes"][name] = {"query": qtext, "batches": per_batch}

    # the interactive regime: per-dispatch p50/p99 at batch 1/8/64 for
    # the chain-eligible classes, where the small-batch fast path (one
    # fused scan-join launch, packed per-query staging row) carries the
    # dispatch.  Many more batches than the throughput loop above, so
    # the p99 is a real tail, and the fastpath share is recorded so a
    # routing regression (fast path silently disabled) shows up in the
    # report, not just in the latency gate.
    from repro_torch.obs import get_registry

    reg = get_registry()
    by_name = dict(classes)
    report["smallbatch"] = {}
    for name in SMALLBATCH_CLASSES:
        qtext = by_name[name]
        per_batch = {}
        for batch in SMALLBATCH_SIZES:
            n_batches = max(16, min(2048 // batch, 256))
            plan, batches, fops = _encoded_batches(
                executor, qtext, p0, batch, n_batches, seed
            )
            total = 0
            for consts in batches[: max(2, n_batches // 8)]:
                total += int(
                    executor.execute_encoded(plan, consts, fops).counts.sum()
                )
            fp0 = reg.counter("exec.fastpath_dispatches").value
            lat = Histogram()
            t0 = time.perf_counter()
            for consts in batches:
                d0 = time.perf_counter_ns()
                executor.execute_encoded(plan, consts, fops)
                lat.observe((time.perf_counter_ns() - d0) / 1e6)
            dt = time.perf_counter() - t0
            n_queries = n_batches * batch
            per_batch[str(batch)] = {
                "n_queries": n_queries,
                "n_batches": n_batches,
                "wall_s": dt,
                "queries_per_s": n_queries / dt,
                "warm_matches": total,
                "fastpath_dispatches":
                    reg.counter("exec.fastpath_dispatches").value - fp0,
                "latency_p50_ms": lat.percentile(50),
                "latency_p99_ms": lat.percentile(99),
                "latency_max_ms": lat.max,
            }
        report["smallbatch"][name] = {"query": qtext, "batches": per_batch}
    return report
