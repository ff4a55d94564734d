"""Knowledge-graph creation — the SDM-RDFizer CLI, on the card.

    PYTHONPATH=src python -m repro_torch.launch.rdfize \
        --mapping mappings.ttl --data-root data/ --out kg.nt \
        [--device cuda|cpu] [--engine optimized|naive] [--join sorted|hash] \
        [--stream] [--block-rows N] [--emit nt|kgz] [--explain-mapping] \
        [--no-mapping-plan] [--shards N [--shard-workers M]] [--trace OUT.json]

The same flags as ``repro.launch.rdfize`` plus ``--device`` (default
``cuda``; a host without a card fails rather than falling back).  It runs
the optimized engine (eager, or block-streamed with ``--stream``) or the
naive engine, with the sorted or the hash PJTT, and writes N-Triples or
(``--emit kgz``) a queryable ``.kgz`` store, byte-identical to the JAX
package's CLI.  ``--emit kgz --shards N`` partitions the KG by subject
hash into N shard stores plus a manifest at ``--out`` (same bytes as the
JAX package's); ``--shard-workers M`` builds rule groups, then shard
stores, in M spawned worker processes, each with its own CUDA context.

Mirrors the paper's tool: parse the RML document, plan, execute with the
PTT/PJTT operators, emit N-Triples, print the per-predicate φ statistics.
"""

from __future__ import annotations

import argparse

def _print_stats(stats) -> None:
    for pred, st in stats.items():
        print(
            f"  {st.kind:5s} {pred.rsplit('/', 1)[-1]:30s} "
            f"|N_p|={st.n_candidates:>9d} |S_p|={st.n_unique:>9d} "
            f"phi={int(st.phi_optimized()):>12d} "
            f"phi_naive={int(st.phi_naive()):>14d}"
        )


def main(argv=None):
    """Run the CLI; returns the ``KGResult`` (None for --explain-mapping)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rdfize")
    ap.add_argument("--mapping", required=True)
    ap.add_argument("--data-root", default=".")
    ap.add_argument("--out", default=None, help="output path (N-Triples or .kgz)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine's device steps run (no fallback)")
    ap.add_argument("--engine", default="optimized", choices=("optimized", "naive"))
    ap.add_argument("--join", default="sorted", choices=("sorted", "hash"))
    ap.add_argument("--batch-size", type=int, default=1 << 16)
    ap.add_argument("--stream", action="store_true",
                    help="block-streamed out-of-core ingestion (repro_torch.stream)")
    ap.add_argument("--block-rows", type=int, default=1 << 14,
                    help="rows per streamed block (with --stream)")
    ap.add_argument("--explain-mapping", action="store_true",
                    help="print the mapping planner's decisions (kept/"
                         "pruned columns, factored terms, rule groups) "
                         "and exit without building the KG")
    ap.add_argument("--no-mapping-plan", action="store_true",
                    help="disable the mapping-level planner (single flat "
                         "rule group)")
    ap.add_argument("--emit", default="nt", choices=("nt", "kgz"),
                    help="output format: N-Triples text or a queryable .kgz "
                         "snapshot (repro_torch.kg)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="with --emit kgz: partition the KG by subject "
                         "hash into N shard stores plus a manifest at "
                         "--out (serve it with launch.serve, query it "
                         "with repro_torch.api.connect)")
    ap.add_argument("--shard-workers", type=int, default=0, metavar="M",
                    help="build rule groups, then shard stores, across M "
                         "spawned worker processes (default: serial "
                         "in-process)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event JSON of the run")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.core.executor import create_kg
    from repro_torch.rml import parser

    if args.explain_mapping:
        from repro_torch import api

        print(api.explain_mapping(args.mapping, data_root=args.data_root))
        return None
    if args.trace:
        obs.enable_tracing()
    with obs.span("parse_mapping", cat="rdfize", path=args.mapping):
        doc = parser.parse_file(args.mapping)
    print(f"[rdfize] {len(doc.triples_maps)} triples maps from {args.mapping}")
    mapping_plan = not args.no_mapping_plan
    mplan = None
    if mapping_plan:
        from repro_torch.rml.plan import build_plan

        mplan = build_plan(doc)
        print(f"[rdfize] plan: {len(mplan.exec_plan.ops)} rules over "
              f"{len(mplan.sources)} sources -> {len(mplan.groups)} "
              f"groups ({len(mplan.shared)} shared terms factored)")

    if args.shards and args.emit != "kgz":
        ap.error("--shards needs --emit kgz (shard stores are .kgz snapshots)")

    group_parallel = (
        args.out is not None
        and args.emit == "kgz"
        and args.shards
        and args.shard_workers > 1
        and mplan is not None
        and len(mplan.groups) > 1
    )
    if group_parallel:
        # whole rule groups are the unit of multiprocess work: each
        # worker builds its group's sub-KG, the parent unions the
        # rendered triples and hash-partitions them into shard stores
        from repro_torch.shard.ingest import ingest_mapping_sharded

        with open(args.mapping, encoding="utf-8") as f:
            mapping_text = f.read()
        with obs.span("create_kg_grouped", cat="rdfize",
                      groups=len(mplan.groups), workers=args.shard_workers):
            manifest, stats, n_triples = ingest_mapping_sharded(
                mapping_text, args.data_root, args.out, args.shards,
                workers=args.shard_workers,
                engine_opts=dict(
                    engine=args.engine, join_strategy=args.join,
                    batch_size=args.batch_size, stream=args.stream,
                    block_rows=args.block_rows,
                ),
                device=args.device,
            )
        print(f"[rdfize] {n_triples} unique triples "
              f"({len(mplan.groups)} rule groups in parallel)")
        _print_stats(stats)
        sizes = ", ".join(str(s["n_triples"]) for s in manifest["shards"])
        print(f"[rdfize] wrote {n_triples}-triple sharded KG "
              f"({args.shards} shards: {sizes} triples) — manifest "
              f"at {args.out}")
        if args.trace:
            n_ev = obs.save_trace(args.trace)
            print(f"[rdfize] wrote {n_ev}-event trace to {args.trace}")
        return None

    with obs.span("create_kg", cat="rdfize", engine=args.engine,
                  stream=args.stream, device=args.device):
        result = create_kg(
            doc,
            data_root=args.data_root,
            engine=args.engine,
            join_strategy=args.join,
            batch_size=args.batch_size,
            stream=args.stream,
            block_rows=args.block_rows,
            mapping_plan=mapping_plan,
            device=args.device,
        )
    print(f"[rdfize] {result.n_triples} unique triples in "
          f"{result.wall_time_s:.2f}s ({result.engine} engine, {args.device})")
    _print_stats(result.stats)
    if args.out and args.emit == "kgz" and args.shards:
        from repro_torch.shard.ingest import shard_store

        with obs.span("emit_sharded", cat="rdfize", out=args.out,
                      shards=args.shards):
            store = result.to_store(device=args.device)
            manifest = shard_store(
                store, args.out, args.shards,
                workers=args.shard_workers,
            )
        sizes = ", ".join(str(s["n_triples"]) for s in manifest["shards"])
        print(f"[rdfize] wrote {store.n_triples}-triple sharded KG "
              f"({args.shards} shards: {sizes} triples) — manifest "
              f"at {args.out}")
    elif args.out and args.emit == "kgz":
        from repro_torch.kg import persist

        with obs.span("emit_kgz", cat="rdfize", out=args.out):
            store = result.to_store(device=args.device)
            persist.save(store, args.out)
        print(f"[rdfize] wrote {store.n_triples}-triple .kgz snapshot "
              f"({store.n_terms} terms) to {args.out}")
    elif args.out:
        with obs.span("emit_nt", cat="rdfize", out=args.out):
            n = result.write_ntriples(args.out)
        print(f"[rdfize] wrote {n} triples to {args.out}")
    if args.trace:
        n_ev = obs.save_trace(args.trace)
        print(f"[rdfize] wrote {n_ev}-event trace to {args.trace}")
    return result


if __name__ == "__main__":
    main()
