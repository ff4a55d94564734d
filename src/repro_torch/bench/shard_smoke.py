"""End-to-end sharding smoke of the port, the counterpart of
``scripts/shard_smoke.sh``: the same steps and assertions against
``repro_torch.launch.{rdfize,serve,query}`` and ``repro_torch.api``.

A tiny SOM testbed is rdfized unsharded and into 2 shards (2 spawned build
workers); then three access paths are held to the unsharded store:

  1. ``api.connect(<manifest>)``: the in-process scatter/gather session,
     byte-identical answers (plain, chain, GROUP BY-COUNT, DISTINCT), an
     insert routed to exactly one shard;
  2. ``launch.serve --kg <manifest>``: the coordinator server (port 0,
     parsed from its log), queried over the wire, its fan-out counters read
     through the metrics op;
  3. ``launch.query --kg <manifest>``: the CLI reads the manifest.

    PYTHONPATH=src python -m repro_torch.bench.shard_smoke [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

from repro_torch.bench.serve_smoke import (
    AN, GN, SmokeError, check, make_testbed, rdfize, run_module, start_module, stop,
    wait_for_port,
)

QUERIES = [
    f"SELECT * WHERE {{ ?m {GN} ?g }}",
    f"SELECT * WHERE {{ ?m {GN} ?g . ?m {AN} ?a }} LIMIT 10",
    f"SELECT ?g (COUNT(?m) AS ?n) WHERE {{ ?m {GN} ?g }} GROUP BY ?g ORDER BY DESC(?n)",
    f"SELECT DISTINCT ?g WHERE {{ ?m {GN} ?g }} ORDER BY ?g LIMIT 5",
]


def check_session(work: str, device: str) -> None:
    from repro_torch import api

    with api.connect(os.path.join(work, "kg.kgz"), device=device) as single, \
            api.connect(os.path.join(work, "kg.shards.json"), device=device) as sharded:
        for q in QUERIES:
            a, b = single.query(q), sharded.query(q)
            check(a.rows == b.rows, (q, a.rows[:3], b.rows[:3]))
            check(a.n_total == b.n_total, (q, a.n_total, b.n_total))
        r = sharded.insert([["<http://smoke/shard1>", GN, '"sharded-live"']])
        check(r["inserted"] == 1 and r["shards_touched"] == 1, r)
        got = sharded.query(f"SELECT ?g WHERE {{ <http://smoke/shard1> {GN} ?g }}")
        check(got.rows == [('"sharded-live"',)], got.rows)
    print(f"shard session smoke OK: {len(QUERIES)} queries byte-identical, insert routed "
          "to 1 shard", flush=True)


def check_coordinator(port: int) -> None:
    from repro_torch import api

    with api.connect(f"127.0.0.1:{port}", retry_s=30) as c:
        scattered = c.query(f"SELECT * WHERE {{ ?m {GN} ?g }}")
        check(scattered.n_total > 0 and scattered.rows, scattered)
        m0, _g0 = scattered.rows[0]
        routed = c.query(f"SELECT ?g WHERE {{ {m0} {GN} ?g }}")
        check(routed.n_total >= 1, routed)
        r = c.insert([["<http://smoke/wire1>", GN, '"wire-live"']])
        check(r["inserted"] == 1 and r["shards_touched"] == 1, r)
        got = c.query(f"SELECT ?g WHERE {{ <http://smoke/wire1> {GN} ?g }}")
        check(got.rows == [('"wire-live"',)], got.rows)
        met = c.metrics()["metrics"]
        cnt = met["counters"]
        # the scatter fanned out to both shards; the routed queries hit one
        check(cnt.get("shard.scattered", 0) >= 1, cnt)
        check(cnt.get("shard.routed", 0) >= 2, cnt)
        fanout = met["histograms"].get("shard.fanout", {})
        check(fanout.get("count", 0) >= 3 and fanout.get("max") == 2.0, fanout)
    print(f"coordinator wire smoke OK: {scattered.n_total} solutions, routed="
          f"{cnt['shard.routed']} scattered={cnt['shard.scattered']} shard_requests="
          f"{cnt['shard.shard_requests']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.shard_smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    work = tempfile.mkdtemp(prefix="shard_smoke_")
    server = None
    try:
        make_testbed(work)
        manifest = os.path.join(work, "kg.shards.json")
        rdfize(work, os.path.join(work, "kg.kgz"), args.device)
        rdfize(work, manifest, args.device, "--shards", "2", "--shard-workers", "2")
        check_session(work, args.device)
        log = os.path.join(work, "coord.log")
        server = start_module("repro_torch.launch.serve", "--kg", manifest, "--port", "0",
                              "--device", args.device, log=log)
        port = wait_for_port(log, server)
        print(f"[smoke] coordinator is up on port {port}", flush=True)
        check_coordinator(port)
        stop(server)
        server = None
        # the CLI reads the manifest and says so on its standard error
        out = run_module("repro_torch.launch.query", "--kg", manifest, "--device", args.device,
                         f"SELECT * WHERE {{ ?m {GN} ?g }} LIMIT 3", with_stderr=True)
        check("shards from" in out, out)
        print("shard smoke OK", flush=True)
    except SmokeError as e:
        print(f"shard smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        stop(server)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
