"""Shard gather probe: in-process shards one after another against the same
requests on a thread pool.

    PYTHONPATH=src python -m repro_torch.bench.shard_gather [--device cuda|cpu] \
        [--rows 1000000] [--batch 16] [--rounds 3] [--out shard_gather.json]

It builds the OJM testbed (75% duplicates, 2 maps) as 4 shard stores in
process, opens them as ``api.connect(<manifest>)`` does, and times
``ShardGroup.execute_query_group`` for two ``serve/bench.py`` classes at
``--batch`` queries: ``single``, which takes the fast path (K4 on the card),
and ``union``, which takes the general executor.  Each round runs the modes
in turns (serial, pool, pool, serial) in one process, so both see the same
host, and every mode's replies must equal the first run's.  It is the
measurement behind ``_LocalBackend.concurrent = False`` in
:mod:`repro_torch.shard.coordinator`.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

CLASSES = ("single", "union")  # the fast path, the general executor
ORDER = ("serial", "pool", "pool", "serial")


def class_queries(store, batch: int, names=CLASSES, seed: int = 2) -> dict:
    """``serve/bench.py``'s classes as ``batch`` texts each, the anchor
    object varied per query as the bench varies it."""
    from repro_torch.serve import bench

    p0, classes = bench._classes(store)
    some_o = store.decode_term(int(bench._anchor_pool(store, p0, 0)[0]))
    anchors = [store.decode_term(int(a)) for a in bench._anchor_pool(store, p0, seed)[:batch]]
    return {name: [text.replace(some_o, a) for a in anchors]
            for name, text in classes if name in names}


def time_modes(group, texts, rounds: int = 3) -> dict:
    """``execute_query_group`` over ``texts`` with the group's shards run
    one after another and on a pool of one thread a shard, in turns; the
    milliseconds of each run by mode.  Raises if a run's replies (less
    their latencies) differ from the first, untimed run's."""
    from repro_torch.shard.coordinator import _Item

    def items():
        return [_Item(text=t, limit=None) for t in texts]

    def answers(replies):  # a reply less its latency
        return [{k: v for k, v in r.items() if k != "latency_ms"} for r in replies]

    rule = group._pool
    want = answers(group.execute_query_group(items()))
    times = {"serial": [], "pool": []}
    try:
        for _ in range(rounds):
            for mode in ORDER:
                group._pool = ThreadPoolExecutor(group.n_shards) if mode == "pool" else None
                t0 = time.perf_counter()
                got = group.execute_query_group(items())
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if group._pool is not None:
                    group._pool.shutdown()
                if answers(got) != want:
                    raise AssertionError(f"the {mode} run's replies differ")
    finally:
        group._pool = rule
    return times


def run(rows: int = 1_000_000, batch: int = 16, rounds: int = 3, device="cuda",
        n_shards: int = 4, log: bool = True) -> dict:
    from repro_torch import api
    from repro_torch.kg import persist
    from repro_torch.rml import generator, serializer
    from repro_torch.shard.ingest import ingest_mapping_sharded

    tb = generator.make_testbed("OJM", rows, 0.75, n_poms=2, seed=0)
    out = {"rows": rows, "batch": batch, "n_shards": n_shards, "device": str(device),
           "classes": {}}
    with tempfile.TemporaryDirectory() as d:
        tb.write(d)
        mapping = os.path.join(d, "map.ttl")
        serializer.write_turtle(tb.doc, mapping)
        with open(mapping, encoding="utf-8") as f:
            mapping_text = f.read()
        manifest = os.path.join(d, "kg.shards.json")
        ingest_mapping_sharded(mapping_text, d, manifest, n_shards, 0, device=device)
        shard0 = persist.open_store(persist.load_manifest(manifest)["shards"][0]["abs_path"],
                                    device=device)
        queries = class_queries(shard0, batch)
        with api.connect(manifest, read_only=True, device=device) as sess:
            out["rule"] = "pool" if sess.group._pool is not None else "serial"
            for name in CLASSES:
                times = time_modes(sess.group, queries[name], rounds)
                out["classes"][name] = {
                    "ms": times, **{f"{m}_median_ms": statistics.median(v)
                                    for m, v in times.items()}}
                if log:
                    print(f"  {name} batch {batch} over {n_shards} shards on {device}: "
                          f"serial {times['serial']} ms, pool {times['pool']} ms", flush=True)
    return out


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.shard_gather")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the shard stores live (no fallback)")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args(argv)
    res = run(rows=args.rows, batch=args.batch, rounds=args.rounds, device=args.device)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
