"""KG query server CLI — serve a ``.kgz`` snapshot to concurrent clients, on the card.

    # server: load once, micro-batch concurrent clients per dispatch
    PYTHONPATH=src python -m repro_torch.launch.serve --kg out.kgz --port 7077 \
        [--device cuda|cpu]

    # client one-shot (retries the connect while the server warms up)
    PYTHONPATH=src python -m repro_torch.launch.serve --connect 127.0.0.1:7077 \
        --query '?s <http://repro.org/vocab/gene_name> ?o' [--limit 5]

The protocol is newline-delimited JSON (see ``repro_torch.serve.server``); any
language can speak it with a plain TCP socket, and the JAX package's client
talks to this server as to its own.  The same flags as
``repro.launch.serve`` plus ``--device`` (default ``cuda``; a host without
a card fails rather than falling back): where the store, or every shard of
a manifest, is opened and queried.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--kg", default=None, help=".kgz snapshot to serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7077,
                    help="0 picks a free port (printed on stderr)")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--linger-ms", type=float, default=2.0,
                    help="how long the dispatcher waits for concurrent "
                         "clients to coalesce into one batch")
    ap.add_argument("--max-rows", type=int, default=1000,
                    help="decoded rows per answer when the request sets no "
                         "limit (n_total always reports the full count)")
    ap.add_argument("--read-only", action="store_true",
                    help="serve the snapshot immutably: insert/delete/"
                         "compact wire ops come back as structured "
                         "read_only errors instead of mutating")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the start-up plan/signature warm-up (the "
                         "server runs the common single-pattern and "
                         "star-join shapes once so first queries find "
                         "their pipelines cached)")
    ap.add_argument("--bench", action="store_true",
                    help="measure the batched-pipeline query classes over "
                         "--kg and exit (writes the BENCH_serve.json shape; "
                         "an empty store reports zero-query sections)")
    ap.add_argument("--json", default=None,
                    help="with --bench: also write the report to this path")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="client mode: send --query to a running server")
    ap.add_argument("--query", default=None, help="query text (client mode)")
    ap.add_argument("--limit", type=int, default=None,
                    help="max rows decoded per answer (client mode)")
    ap.add_argument("--metrics", action="store_true",
                    help="client mode: fetch the server's full metrics "
                         "snapshot (latency histograms, counters) instead "
                         "of sending a query")
    ap.add_argument("--retry-s", type=float, default=10.0,
                    help="client mode: keep retrying the connect this long")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="server mode: record queue-wait / dispatch / "
                         "redispatch spans and write a Chrome trace-event "
                         "JSON on shutdown (open in Perfetto)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="server mode: where the store (every shard of a "
                         "manifest) is opened and queried (no fallback)")
    args = ap.parse_args(argv)

    if args.connect:
        if not args.query and not args.metrics:
            ap.error("--connect needs --query (or --metrics)")
        from repro_torch import api

        host, _, port = args.connect.rpartition(":")
        target = f"{host or '127.0.0.1'}:{int(port)}"
        with api.connect(target, retry_s=args.retry_s) as s:
            if args.metrics:
                resp = s.metrics()
            else:
                resp = s.query(args.query, limit=args.limit).to_dict()
        print(json.dumps(resp, indent=2))
        return

    if not args.kg:
        ap.error("provide --kg to serve, or --connect/--query for client mode")
    from repro_torch import obs
    from repro_torch.kg.persist import is_manifest, open_store
    from repro_torch.serve.server import KGServer

    if args.trace:
        obs.enable_tracing()

    if is_manifest(args.kg):
        # a shard manifest: spawn one shard server process each and front
        # them with the scatter/gather coordinator — same wire protocol,
        # so client mode and every existing tool keep working
        from repro_torch.shard.coordinator import Coordinator

        signal.signal(signal.SIGTERM, signal.default_int_handler)
        coord = Coordinator.from_manifest(
            args.kg,
            host=args.host,
            port=args.port,
            read_only=args.read_only,
            max_rows=args.max_rows,
            max_batch=args.max_batch,
            linger_ms=args.linger_ms,
            device=args.device,
        )
        try:
            coord.serve_forever()
        finally:
            if args.trace:
                n_ev = obs.save_trace(args.trace)
                print(f"[serve] wrote {n_ev}-event trace to {args.trace}",
                      file=sys.stderr)
        return
    from repro_torch.kg.persist import KIND_DELTA, load_chain, peek_meta
    from repro_torch.live.delta import LiveStore

    _, _, _, kind = peek_meta(args.kg)
    kg_path = None
    if kind == KIND_DELTA:
        # a delta snapshot: resolve its parent chain into a live store
        # (compaction does not rewrite a delta file in place)
        served = load_chain(args.kg, device=args.device)
        store = served.base
    elif args.read_only:
        served = store = open_store(args.kg, device=args.device)
    else:
        store = open_store(args.kg, device=args.device)
        served = LiveStore(store)
        kg_path = args.kg
    print(f"[serve] {store.n_triples} triples, {store.n_terms} terms "
          f"from {args.kg} on {store.device}", file=sys.stderr)
    if args.bench:
        from repro_torch.serve.bench import bench_serve

        report = bench_serve(store)
        print(json.dumps(report, indent=2, sort_keys=True))
        if args.json:
            with open(args.json, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=2, sort_keys=True)
        if args.trace:
            n_ev = obs.save_trace(args.trace)
            print(f"[serve] wrote {n_ev}-event trace to {args.trace}",
                  file=sys.stderr)
        return
    # SIGTERM behaves like ^C so a supervised server (CI smoke, systemd)
    # still flushes its trace on shutdown
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        KGServer(
            served,
            host=args.host,
            port=args.port,
            max_batch=args.max_batch,
            linger_ms=args.linger_ms,
            max_rows=args.max_rows,
            read_only=args.read_only,
            kg_path=kg_path,
            warmup=not args.no_warmup,
        ).serve_forever()
    finally:
        if args.trace:
            n_ev = obs.save_trace(args.trace)
            print(f"[serve] wrote {n_ev}-event trace to {args.trace}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
