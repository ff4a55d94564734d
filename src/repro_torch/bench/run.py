"""Benchmark entry point of the port — one section per paper table/figure.

    PYTHONPATH=src python -m repro_torch.bench.run [--device cuda|cpu] [--full] \
        [--only SECTION] [--json-dir DIR]

The port of ``benchmarks/run.py``, with its sections, sizes and report
shapes, on ``--device`` (default ``cuda``; no fallback: without a card pass
``--device cpu``).  Prints ``name,us_per_call,derived`` CSV rows, after a
``#`` line naming the device:

  fig56/*      — paper Figures 5/6: KG-creation wall time, engine vs baseline
                 (derived = naive/optimized speedup)
  opmodel/*    — §III.iv operation-count model (derived = φ̂/φ ratio)
  kernels/*    — K1 (hash_mix), K2 (radix_dedup_insert) and K3 (nested_join)
                 against the plain PyTorch paths they replace
  dedup/*      — dedup_gather time and traffic against the plain gather
  stream/*     — streamed vs eager ingestion (rows/s, peak traced alloc)
  kg/*         — store build + batched single-pattern queries/s
  serve/*      — the query classes through the executor and the fast path
  live/*       — the live write path, overlay queries vs delta fraction,
                 and compaction
  shard/*      — routed vs scatter-all query cost at 1/2/4 shards vs the
                 unsharded baseline
  roofline/*   — (when results/torch/dryrun.json exists) each dry-run cell's
                 bound at the H100's peaks (``bench.roofline``)

The ``stream``, ``kg``, ``serve``, ``live`` and ``shard`` sections write
``BENCH_*.json`` reports with the JAX package's keys into ``--json-dir``
(default ``bench-out/torch``), never into the repository's root, where the
JAX package's reports live.

``--full`` widens fig56 to the paper's 1M-row tier, as in JAX.  It also
widens ``live`` and ``shard`` from 20K rows to the paper's 1M SOM tier: on
the card a 20K-row store is no real size.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

ROWS_SMALL, ROWS_FULL = 20_000, 1_000_000  # live and shard testbeds


def _row(name: str, us: float, derived: str = "") -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


def _write_json(json_dir: str, name: str, payload: dict) -> None:
    os.makedirs(json_dir, exist_ok=True)
    path = os.path.join(json_dir, name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"# wrote {path}", flush=True)


def _som_store(n: int, device):
    """The paper's SOM testbed (75% duplicates, 2 maps, seed 0) as a store."""
    from repro_torch.core.executor import create_kg
    from repro_torch.rml import generator

    tb = generator.make_testbed("SOM", n, 0.75, n_poms=2, seed=0)
    return create_kg(tb.doc, tables={"csv:child.csv": tb.child},
                     device=device).to_store(device=device)


def _timeit_us(fn, device, repeats: int = 5) -> float:
    """Best of ``repeats`` calls after one warm-up, in µs: CUDA events on
    the card, the host clock on the CPU."""
    from repro_torch.bench.dedup_gather import best_time_s

    return best_time_s(fn, torch.device(device), repeats) * 1e6


def bench_fig56(full: bool, device) -> None:
    from repro_torch.bench import paper_figs

    sizes = (10_000, 100_000, 1_000_000) if full else (10_000, 100_000)
    n_poms = (1, 2, 4) if full else (1, 2)
    for kind in ("SOM", "ORM", "OJM"):
        for n in sizes:
            for dup in (0.25, 0.75):
                for npm in n_poms:
                    opt = paper_figs.run_cell(kind, n, dup, npm, "optimized", repeats=2,
                                              device=device)
                    nav = paper_figs.run_cell(kind, n, dup, npm, "naive", repeats=2,
                                              device=device)
                    name = f"fig56/{kind.lower()}{npm}-{n}-{int(dup*100)}"
                    if nav["status"] == "DNF":
                        _row(name, opt["time_s"] * 1e6, "naive=DNF")
                    else:
                        _row(
                            name, opt["time_s"] * 1e6,
                            f"speedup={nav['time_s']/opt['time_s']:.2f}x",
                        )
                    assert (
                        nav["status"] == "DNF"
                        or nav["n_triples"] == opt["n_triples"]
                    ), f"engine mismatch at {name}"


def bench_op_model(device) -> None:
    from repro_torch.bench import op_model

    for r in op_model.run(sizes=(10_000,), dups=(0.25, 0.75), device=device, log=False):
        _row(
            f"opmodel/{r['kind'].lower()}-{r['rows']}-{int(r['dup']*100)}",
            0.0,
            f"phi_ratio={r['ratio']:.1f}x",
        )


def bench_kernels(device) -> None:
    import numpy as np

    from repro_torch.core import hashing, hashset, pjtt
    from repro_torch.kernels import bucket_dedup, ops

    rng = np.random.default_rng(0)
    n = 1 << 16
    # JAX's 8 partitions would give K2 32,768-slot table slices; a CTA's
    # claims hold bucket_dedup.SLICE = 16,384, so the same 4n slots in 16
    n_parts = max(8, 4 * n // bucket_dedup.SLICE)

    def dev(a):
        return torch.from_numpy(a).to(device)

    words = dev(rng.integers(0, 2**31, (3, n)).astype(np.int32))
    t_kernel = _timeit_us(lambda: ops.fused_hash_mix(words), device)
    t_ref = _timeit_us(lambda: hashing.mix64([words[0], words[1], words[2]]), device)
    _row("kernels/hash_mix", t_kernel, f"torch_ref_us={t_ref:.1f}")

    vals = dev(rng.integers(0, 5000, n).astype(np.int32))
    hi, lo = hashing.mix64([vals])
    valid = torch.ones(n, dtype=torch.bool, device=device)
    t_radix = _timeit_us(
        lambda: ops.radix_dedup_insert(ops.make_radix_table(4 * n, n_parts, device=device),
                                       hi, lo, valid)[1], device)
    t_flat = _timeit_us(
        lambda: hashset.insert_masked(hashset.make(4 * n, device=device), hi, lo, valid).is_new,
        device)
    _row("kernels/radix_dedup", t_radix, f"flat_hashset_us={t_flat:.1f}")

    pk_np = rng.integers(0, 128, 4096).astype(np.int32)
    pk, ps = dev(pk_np), dev(rng.integers(0, 10**6, 4096).astype(np.int32))
    ck = dev(rng.integers(0, 128, 2048).astype(np.int32))
    K = int(np.bincount(pk_np).max()) + 1
    t_join = _timeit_us(lambda: ops.blocked_nested_join(pk, ps, ck, K)[0], device)
    idx = pjtt.build_sorted(pk, ps)
    t_pjtt = _timeit_us(lambda: pjtt.probe_sorted(idx, ck, K).subjects, device)
    _row("kernels/nested_join", t_join, f"pjtt_index_join_us={t_pjtt:.1f}")


def bench_dedup_gather(device) -> None:
    from repro_torch.bench import dedup_gather

    for r in dedup_gather.run(n=65_536, dup_factors=(1, 8, 64), device=device):
        _row(
            f"dedup/x{r['dup_factor']}",
            r["t_dedup_s"] * 1e6,
            f"plain_us={r['t_plain_s']*1e6:.1f};traffic={r['traffic_saving']:.1f}x",
        )


_WIDE_TTL = """
@prefix rr: <http://www.w3.org/ns/r2rml#> .
@prefix rml: <http://semweb.mmlab.be/ns/rml#> .
@prefix ql: <http://semweb.mmlab.be/ns/ql#> .
@prefix ex: <http://example.com/> .
ex:Wide a rr:TriplesMap ;
  rml:logicalSource [ rml:source "wide.csv" ; rml:referenceFormulation ql:CSV ] ;
  rr:subjectMap [ rr:template "http://example.com/r/{C0}" ] ;
  rr:predicateObjectMap [ rr:predicate ex:p1 ; rr:objectMap [ rml:reference "C1" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:p2 ; rr:objectMap [ rml:reference "C2" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:p3 ; rr:objectMap [ rml:reference "C3" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:p4 ; rr:objectMap [ rml:reference "C4" ] ] ;
  rr:predicateObjectMap [ rr:predicate ex:p5 ; rr:objectMap [ rml:reference "C5" ] ] .
"""


def bench_stream(json_dir: str, device) -> None:
    """Streaming vs eager ingestion over the generator's 10K/100K CSV
    testbeds: rows/s and peak traced host allocation (the reading and
    encoding run on the host); then full streamed ``create_kg`` on
    ``device`` over a 40-column/6-mapped CSV with the mapping planner's
    projection pushdown on vs off.  Writes ``BENCH_stream.json``."""
    import tempfile
    import tracemalloc

    from repro_torch.core.executor import create_kg
    from repro_torch.data.encoder import Dictionary
    from repro_torch.data.sources import load_csv
    from repro_torch.rml import generator
    from repro_torch.rml import parser as rml_parser
    from repro_torch.stream import read_csv

    report: dict[str, dict] = {}
    for n in (10_000, 100_000):
        tb = generator.make_testbed("SOM", n, 0.75, n_poms=2, seed=0)
        with tempfile.TemporaryDirectory() as d:
            tb.write(d)
            path = os.path.join(d, "child.csv")
            cols = list(tb.child)

            def eager():
                dct = Dictionary()
                table = load_csv(path)
                for c in cols:
                    dct.encode(table[c])

            def streamed():
                dct = Dictionary()
                ds = read_csv(path, block_rows=1 << 13).encode(dct)
                for block in ds.iter_blocks():
                    assert block.n_rows > 0

            for name, fn in (("stream", streamed), ("eager", eager)):
                tracemalloc.start()
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                _, peak = tracemalloc.get_traced_memory()
                tracemalloc.stop()
                _row(
                    f"stream/{name}-{n}",
                    dt * 1e6,
                    f"rows_per_s={n / dt:.0f};peak_alloc_mb={peak / 1e6:.1f}",
                )
                report[f"{name}-{n}"] = {
                    "rows": n,
                    "wall_s": dt,
                    "rows_per_s": n / dt,
                    "peak_alloc_mb": peak / 1e6,
                }

    n, n_cols = 40_000, 40
    doc = rml_parser.parse(_WIDE_TTL)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "wide.csv"), "w") as f:
            f.write(",".join(f"C{j}" for j in range(n_cols)) + "\n")
            for i in range(n):
                f.write(",".join(f"v{i % 997}_{j}" for j in range(n_cols)) + "\n")
        create_kg(doc, data_root=d, stream=True, device=device)  # warm-up, untimed
        for label, on in (("pushdown-off", False), ("pushdown-on", True)):
            tracemalloc.start()
            t0 = time.perf_counter()
            res = create_kg(doc, data_root=d, stream=True, mapping_plan=on, device=device)
            dt = time.perf_counter() - t0
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            _row(
                f"stream/wide40x6-{label}",
                dt * 1e6,
                f"rows_per_s={n / dt:.0f};peak_alloc_mb={peak / 1e6:.1f}",
            )
            report[f"wide40x6-{label}"] = {
                "rows": n,
                "n_triples": res.n_triples,
                "wall_s": dt,
                "rows_per_s": n / dt,
                "peak_alloc_mb": peak / 1e6,
            }
    report["wide40x6-pushdown-speedup"] = round(
        report["wide40x6-pushdown-on"]["rows_per_s"]
        / report["wide40x6-pushdown-off"]["rows_per_s"],
        2,
    )
    _write_json(json_dir, "BENCH_stream.json", report)


def bench_kg(json_dir: str, device) -> None:
    """The store benchmark on the paper's 100K-row testbed: KG creation ->
    ``to_store()`` -> batched single-pattern queries/s.  Writes
    ``BENCH_kg.json``."""
    import tracemalloc

    from repro_torch.core.executor import create_kg
    from repro_torch.kg.bench import bench_single_pattern
    from repro_torch.rml import generator

    n = 100_000
    tb = generator.make_testbed("SOM", n, 0.75, n_poms=2, seed=0)
    t0 = time.perf_counter()
    kg = create_kg(tb.doc, tables={"csv:child.csv": tb.child}, device=device)
    t_create = time.perf_counter() - t0
    tracemalloc.start()
    t0 = time.perf_counter()
    store = kg.to_store(device=device)
    t_build = time.perf_counter() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    report = bench_single_pattern(store, n_queries=50_000, batch=4096)
    report.update(
        {
            "testbed_rows": n,
            "create_s": t_create,
            "store_build_s": t_build,
            "store_build_peak_alloc_mb": peak / 1e6,
        }
    )
    _row(
        f"kg/build-{n}", t_build * 1e6,
        f"triples={store.n_triples};peak_alloc_mb={peak / 1e6:.1f}",
    )
    _row(
        f"kg/query-{n}",
        report["wall_s"] / report["n_queries"] * 1e6,
        f"queries_per_s={report['queries_per_s']:.0f};batch={report['batch']};"
        f"p99_ms={report['latency_p99_ms']:.3f}",
    )
    _write_json(json_dir, "BENCH_kg.json", report)


def bench_serve(json_dir: str, device) -> None:
    """The serving benchmark on the same 100K-row testbed store as the
    ``kg`` section: queries/s and per-dispatch latency p50/p99 for the six
    query classes at batch 1/64/4096, plus the ``smallbatch`` section (the
    chain-eligible classes at batch 1/8/64 through the fast path, K4 on
    the card).  Writes ``BENCH_serve.json``, the dispatch trace
    (``TRACE_serve.json``) and the metrics snapshot
    (``METRICS_serve.json``)."""
    from repro_torch import obs
    from repro_torch.serve.bench import bench_serve as run_serve_bench

    n = 100_000
    store = _som_store(n, device)
    obs.enable_tracing()
    report = run_serve_bench(store)
    obs.get_tracer().disable()
    report["testbed_rows"] = n
    for name, cls in report["classes"].items():
        for batch, r in cls["batches"].items():
            _row(
                f"serve/{name}-b{batch}",
                r["wall_s"] / r["n_queries"] * 1e6,
                f"queries_per_s={r['queries_per_s']:.0f};"
                f"p50_ms={r['latency_p50_ms']:.3f};"
                f"p99_ms={r['latency_p99_ms']:.3f}",
            )
    for name, cls in report["smallbatch"].items():
        for batch, r in cls["batches"].items():
            _row(
                f"serve/smallbatch-{name}-b{batch}",
                r["wall_s"] / r["n_queries"] * 1e6,
                f"p50_ms={r['latency_p50_ms']:.3f};"
                f"p99_ms={r['latency_p99_ms']:.3f};"
                f"fastpath={r['fastpath_dispatches']}",
            )
    _write_json(json_dir, "BENCH_serve.json", report)
    _write_json(json_dir, "TRACE_serve.json", obs.get_tracer().export())
    _write_json(json_dir, "METRICS_serve.json", obs.get_registry().snapshot())


def bench_live(json_dir: str, device, full: bool = False) -> None:
    """The live-store benchmark on the SOM testbed (20K rows, 1M with
    ``--full``): insert/delete rows/s through the overlay log, overlay
    query throughput and latency at delta fractions 0/1%/10%, and one
    compaction.  Writes ``BENCH_live.json``."""
    from repro_torch.live.bench import bench_live as run_live_bench

    n = ROWS_FULL if full else ROWS_SMALL
    report = run_live_bench(_som_store(n, device))
    report["testbed_rows"] = n
    for op in ("insert", "delete"):
        w = report["write"][op]
        _row(
            f"live/{op}", w["wall_s"] / w["rows"] * 1e6,
            f"rows_per_s={w['rows_per_s']:.0f}",
        )
    for label, r in report["query"].items():
        _row(
            f"live/query-{label}",
            r["wall_s"] / r["n_queries"] * 1e6,
            f"queries_per_s={r['queries_per_s']:.0f};"
            f"p50_ms={r['latency_p50_ms']:.3f};"
            f"p99_ms={r['latency_p99_ms']:.3f}",
        )
    _row(
        "live/compact", report["compaction"]["compact_ms"] * 1e3,
        f"triples={report['compaction']['triples']}",
    )
    _write_json(json_dir, "BENCH_live.json", report)


def bench_shard(json_dir: str, device, full: bool = False) -> None:
    """The scatter/gather benchmark on the SOM testbed (20K rows, 1M with
    ``--full``): routed bound-subject lookups and scatter-all 3-pattern
    star BGPs through the in-process shard session at 1/2/4 shards, against
    the unsharded baseline.  Writes ``BENCH_shard.json``."""
    from repro_torch.shard.bench import bench_shard as run_shard_bench

    n = ROWS_FULL if full else ROWS_SMALL
    report = run_shard_bench(_som_store(n, device))
    report["testbed_rows"] = n
    for name, cls in report["classes"].items():
        for config, r in cls["configs"].items():
            _row(
                f"shard/{name}-{config}",
                r["wall_s"] / r["n_queries"] * 1e6,
                f"queries_per_s={r['queries_per_s']:.0f};"
                f"p50_ms={r['latency_p50_ms']:.3f};"
                f"p99_ms={r['latency_p99_ms']:.3f};"
                f"fanout={r['fanout_per_query']:.1f}",
            )
    for key, v in report.get("criteria", {}).items():
        _row(f"shard/criteria-{key}", 0.0, f"ratio={v:.2f}")
    _write_json(json_dir, "BENCH_shard.json", report)


def bench_roofline() -> None:
    from repro_torch.bench import roofline

    path = os.path.join(roofline.RESULTS, "dryrun.json")
    if not os.path.exists(path):
        print("# roofline: results/torch/dryrun.json missing (run repro_torch.launch.dryrun)",
              flush=True)
        return
    for r in roofline.derive(path):
        if r.get("status") != "ok":
            continue
        _row(f"roofline/{r['cell']}", r["t_bound_s"] * 1e6,
             f"bound={r['bound']};frac={r.get('roofline_frac', 0) * 100:.1f}%")


SECTIONS = ("fig56", "opmodel", "kernels", "dedup", "stream", "kg", "serve", "live", "shard",
            "roofline")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every section runs (no fallback)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, choices=SECTIONS)
    ap.add_argument("--json-dir", default=os.path.join("bench-out", "torch"),
                    help="where BENCH_*.json reports are written")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev, jd = args.device, args.json_dir
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA card; pass --device cpu")

    name = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    print(f"# device: {dev} ({name})", flush=True)
    print("name,us_per_call,derived")
    sections = {
        "fig56": lambda: bench_fig56(args.full, dev),
        "opmodel": lambda: bench_op_model(dev),
        "kernels": lambda: bench_kernels(dev),
        "dedup": lambda: bench_dedup_gather(dev),
        "stream": lambda: bench_stream(jd, dev),
        "kg": lambda: bench_kg(jd, dev),
        "serve": lambda: bench_serve(jd, dev),
        "live": lambda: bench_live(jd, dev, args.full),
        "shard": lambda: bench_shard(jd, dev, args.full),
        "roofline": bench_roofline,
    }
    for section, fn in sections.items():
        if args.only and section != args.only:
            continue
        print(f"# --- {section} ---", flush=True)
        fn()


if __name__ == "__main__":
    main()
