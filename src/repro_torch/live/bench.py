"""Live-store benchmark (``BENCH_live.json``): the mutable write path,
fused overlay queries at increasing delta fractions, and compaction.

Three axes over one testbed store:

* ``write``      — ``insert`` / ``delete`` rows/s through the overlay log
  (wire-batch sized calls: dict interning, dup/tombstone resolution, view
  invalidation — everything the server's mutation barrier pays except the
  socket);
* ``query``      — batched single-pattern + 2-pattern-join throughput and
  latency through the fused ``base ⊕ delta`` executor arm at delta
  fractions 0 (pure-read fast path), ~1% and ~10% (overlay scan + alive
  rank-select + provenance merge in the dispatch);
* ``compaction`` — one overlay merge back into a canonical sorted store.

Queries are filter-free on purpose: a filtered query forces a per-view
value-table rebuild (O(terms) host work) that would swamp the fused
dispatch being measured here.

The port's copy of ``repro.live.bench``: the same seeds, chunking, delta
fractions and report keys, over a store on any device.  A dispatch's
``BatchResult.counts`` is a host array, copied from the device with the
columns, so each timed ``execute`` includes the device's work."""

from __future__ import annotations

import time

import numpy as np

from repro_torch.kg.store import TripleStore
from repro_torch.live.delta import LiveStore
from repro_torch.obs import Histogram
from repro_torch.serve import algebra as A
from repro_torch.serve.exec import get_executor

WRITE_CHUNK = 64  # triples per insert/delete call — a wire-batch worth


def _rendered_rows(store: TripleStore, rows: np.ndarray) -> list:
    return [
        (
            store.decode_term(int(store.s[r])),
            store.decode_term(int(store.p[r])),
            store.decode_term(int(store.o[r])),
        )
        for r in rows
    ]


def _fresh_triples(store: TripleStore, rows: np.ndarray) -> list:
    """Triples guaranteed absent from the base: existing rows re-anchored
    at new subject IRIs, so inserts grow the overlay term table too."""
    return [
        (f"<http://live.bench/s{i}>", p, o)
        for i, (_, p, o) in enumerate(_rendered_rows(store, rows))
    ]


def _mutate_to_fraction(
    live: LiveStore, frac: float, rng: np.random.Generator
) -> None:
    """Insert/delete until ``delta_fraction`` is roughly ``frac`` (half
    inserts, half tombstones)."""
    if frac <= 0:
        return
    base = live.base
    k = max(1, int(base.n_triples * frac / 2))
    ins_rows = rng.choice(base.n_triples, size=k, replace=False)
    del_rows = rng.choice(base.n_triples, size=k, replace=False)
    live.insert(_fresh_triples(base, ins_rows))
    live.delete(_rendered_rows(base, del_rows))


def _time_queries(
    live: LiveStore, qtexts: list[str], batch: int, n_batches: int
) -> dict:
    ex = get_executor(live.base)
    queries = [A.parse_select(t) for t in qtexts]
    lat = Histogram()
    total = n_q = 0
    t_all = 0.0
    for q in queries:
        plan = ex.plan(q)
        qb = [q] * batch
        view = live.view()
        # warm-up: build this (plan, caps, overlay) pipeline and let the
        # capacity feedback converge, so regrowth stays out of the tail
        for _ in range(4):
            ex.execute(plan, qb, view=view)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            d0 = time.perf_counter_ns()
            res = ex.execute(plan, qb, view=view)
            lat.observe((time.perf_counter_ns() - d0) / 1e6)
            total += int(res.counts.sum())
        t_all += time.perf_counter() - t0
        n_q += n_batches * batch
    return {
        "n_queries": n_q,
        "wall_s": t_all,
        "queries_per_s": n_q / t_all,
        "warm_matches": total,
        "latency_p50_ms": lat.percentile(50),
        "latency_p99_ms": lat.percentile(99),
        "latency_max_ms": lat.max,
    }


def bench_live(
    store: TripleStore,
    batch: int = 256,
    n_batches: int = 32,
    n_write: int = 2048,
    seed: int = 0,
) -> dict:
    """Time the live write path, overlay queries at delta fractions
    0 / ~1% / ~10%, and one compaction over ``store``.  Returns the
    json-ready ``BENCH_live.json`` shape."""
    rng = np.random.default_rng(seed)
    # the two most common predicates plus a selective object anchor shape
    # the query classes (the same scheme repro_torch.serve.bench uses, minus
    # filters); unanchored scans would swamp the overlay arm under sheer
    # match volume
    ids, counts = np.unique(store.p, return_counts=True)
    by_freq = ids[np.argsort(counts)]
    p0, p1 = (int(p) for p in by_freq[-2:])
    t0_, t1_ = (store.decode_term(p) for p in (p0, p1))
    some_o = store.decode_term(int(store.o[np.nonzero(store.p == p0)[0][0]]))
    qtexts = [
        f"SELECT ?s WHERE {{ ?s {t0_} {some_o} }}",
        f"SELECT ?m ?b WHERE {{ ?m {t0_} {some_o} . ?m {t1_} ?b }}",
    ]

    report: dict = {
        "n_triples": int(store.n_triples),
        "n_terms": int(store.n_terms),
    }

    # --- write path -------------------------------------------------------
    live = LiveStore(store)
    n_write = min(n_write, store.n_triples)
    fresh = _fresh_triples(
        store, rng.choice(store.n_triples, size=n_write, replace=False)
    )
    t0 = time.perf_counter()
    for i in range(0, n_write, WRITE_CHUNK):
        live.insert(fresh[i : i + WRITE_CHUNK])
    dt_ins = time.perf_counter() - t0
    doomed = _rendered_rows(
        store, rng.choice(store.n_triples, size=n_write, replace=False)
    )
    t0 = time.perf_counter()
    for i in range(0, n_write, WRITE_CHUNK):
        live.delete(doomed[i : i + WRITE_CHUNK])
    dt_del = time.perf_counter() - t0
    report["write"] = {
        "insert": {
            "rows": n_write,
            "wall_s": dt_ins,
            "rows_per_s": n_write / dt_ins,
        },
        "delete": {
            "rows": n_write,
            "wall_s": dt_del,
            "rows_per_s": n_write / dt_del,
        },
    }

    # --- query path at increasing delta fractions -------------------------
    report["query"] = {}
    for label, frac in (("delta0", 0.0), ("delta1pct", 0.01),
                        ("delta10pct", 0.10)):
        lv = LiveStore(store)
        _mutate_to_fraction(lv, frac, np.random.default_rng(seed + 1))
        r = _time_queries(lv, qtexts, batch, n_batches)
        r["delta_fraction"] = lv.delta_fraction
        report["query"][label] = r

    # --- compaction -------------------------------------------------------
    lv = LiveStore(store)
    _mutate_to_fraction(lv, 0.10, np.random.default_rng(seed + 2))
    t0 = time.perf_counter()
    compacted = lv.compact()
    report["compaction"] = {
        "compact_ms": (time.perf_counter() - t0) * 1e3,
        "triples": int(compacted.n_triples),
    }
    return report
