"""Query CLI — serve answers from a ``.kgz`` triple-store snapshot, on the card.

    PYTHONPATH=src python -m repro_torch.launch.query \
        --kg out.kgz '?s <http://repro_torch.org/vocab/gene_name> ?o' [--limit 20]

    # full SPARQL-lite (OPTIONAL / FILTER / DISTINCT / LIMIT)
    PYTHONPATH=src python -m repro_torch.launch.query --kg out.kgz \
        'SELECT ?m ?e WHERE { ?m <http://repro_torch.org/vocab/has_exon> ?e
                              FILTER(?e > 100) } LIMIT 10'

    # serving throughput (batched single-pattern path)
    PYTHONPATH=src python -m repro_torch.launch.query --kg out.kgz --bench

Build the snapshot with ``python -m repro_torch.launch.rdfize ... --emit kgz``
(or the JAX package's CLI: the files are the same bytes).  The same flags as
``repro.launch.query`` plus ``--device`` (default ``cuda``; a host without a
card fails rather than falling back).  The store is opened through the
``open_store`` cache, so a query phase and a ``--bench`` phase in one
process load and validate the snapshot once.  A shard manifest
(``rdfize --emit kgz --shards N``) is answered through the scatter/gather
session over every shard, each opened on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.query")
    ap.add_argument("--kg", required=True, help=".kgz snapshot or shard manifest path")
    ap.add_argument("query", nargs="*",
                    help="SPARQL-lite query, or bare triple pattern(s)")
    ap.add_argument("--limit", type=int, default=None, help="max rows printed")
    ap.add_argument("--explain", action="store_true",
                    help="print the planned operator tree instead of rows")
    ap.add_argument("--bench", action="store_true",
                    help="measure batched single-pattern queries/s")
    ap.add_argument("--bench-queries", type=int, default=50_000)
    ap.add_argument("--bench-batch", type=int, default=4096)
    ap.add_argument("--json", default=None,
                    help="also write the bench report to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the store's index and the queries run "
                         "(no fallback)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event JSON of the run "
                         "(dispatch / redispatch spans; open in Perfetto)")
    args = ap.parse_args(argv)

    from repro_torch import api, obs
    from repro_torch.kg import persist

    if args.trace:
        obs.enable_tracing()
    if persist.is_manifest(args.kg):
        # a sharded KG: connect() opens every shard behind the
        # scatter/gather session; --bench still needs one store, so
        # point it at shard 0
        manifest = persist.load_manifest(args.kg)
        store = persist.open_store(manifest["shards"][0]["abs_path"],
                                   device=args.device)
        session = api.connect(args.kg, device=args.device)
        print(
            f"[query] {manifest['dictionary']['n_triples']} triples across "
            f"{manifest['n_shards']} shards from {args.kg} on {store.device}",
            file=sys.stderr,
        )
    else:
        store = persist.open_store(args.kg, device=args.device)
        print(
            f"[query] {store.n_triples} triples, {store.n_terms} terms "
            f"from {args.kg} on {store.device}",
            file=sys.stderr,
        )
        session = api.connect(store)

    if args.query:
        text = " . ".join(args.query)
        if args.explain:
            print(session.explain(text))
        else:
            result = session.query(text, limit=args.limit)
            print("\t".join(result.vars))
            for row in result:
                # COUNT cells are plain ints, unbound cells are None
                print("\t".join("∅" if t is None else str(t) for t in row))
            shown = (
                f" (showing {len(result)})"
                if len(result) < result.n_total else ""
            )
            print(f"[query] {result.n_total} solutions{shown}",
                  file=sys.stderr)

    if args.bench:
        # an empty graph reports a zero-query section (the guard is unified
        # inside bench_single_pattern, not ad-hoc per CLI)
        from repro_torch.kg.bench import bench_single_pattern

        report = bench_single_pattern(
            store, n_queries=args.bench_queries, batch=args.bench_batch
        )
        print(f"[query] {report['queries_per_s']:.0f} single-pattern queries/s "
              f"({report['n_queries']} queries, batch={report['batch']})",
              file=sys.stderr)
        print(json.dumps(report, indent=2))
        if args.json:
            with open(args.json, "w", encoding="utf-8") as f:
                json.dump(report, f, indent=2)

    if not args.query and not args.bench:
        ap.error("provide a query (or --bench)")

    if args.trace:
        n_ev = obs.save_trace(args.trace)
        print(f"[query] wrote {n_ev}-event trace to {args.trace}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
