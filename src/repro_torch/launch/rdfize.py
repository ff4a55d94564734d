"""Knowledge-graph creation — the SDM-RDFizer CLI, on the card.

    PYTHONPATH=src python -m repro_torch.launch.rdfize \
        --mapping mappings.ttl --data-root data/ --out kg.nt \
        [--device cuda|cpu] [--explain-mapping] [--no-mapping-plan] \
        [--trace OUT.json]

The same flags as ``repro.launch.rdfize`` plus ``--device`` (default
``cuda``; a host without a card fails rather than falling back).  It runs
the eager optimized engine with the sorted PJTT and writes N-Triples,
byte-identical to the JAX package's CLI.  ``--stream``, ``--engine naive``,
``--join hash``, ``--emit kgz``, ``--shards`` and the options that only
modify them (``--block-rows``, ``--shard-workers``) arrive in slice 2 of
the port and exit with an error naming it.

Mirrors the paper's tool: parse the RML document, plan, execute with the
PTT/PJTT operators, emit N-Triples, print the per-predicate φ statistics.
"""

from __future__ import annotations

import argparse
import csv
import os

_LATER = "arrives in slice 2 of the PyTorch port (see ROADMAP.md); use repro.launch.rdfize"


def _print_stats(stats) -> None:
    for pred, st in stats.items():
        print(
            f"  {st.kind:5s} {pred.rsplit('/', 1)[-1]:30s} "
            f"|N_p|={st.n_candidates:>9d} |S_p|={st.n_unique:>9d} "
            f"phi={int(st.phi_optimized()):>12d} "
            f"phi_naive={int(st.phi_naive()):>14d}"
        )


def _peek_schemas(plan, data_root: str) -> dict[str, tuple[str, ...]]:
    """Header peek for fixed-schema CSV/TSV sources on disk, so the explain
    tree can show *pruned* columns, not just kept ones.  Sources that are
    missing, globbed, or schemaless (JSON) are omitted."""
    from repro_torch.rml.model import parse_source_key
    from repro_torch.rml.plan import is_sharded_path

    schemas: dict[str, tuple[str, ...]] = {}
    for skey in plan.sources:
        fmt, path, _ = parse_source_key(skey)
        if fmt not in ("csv", "tsv") or is_sharded_path(path):
            continue
        full = path if os.path.isabs(path) else os.path.join(data_root, path)
        if not os.path.exists(full):
            continue
        with open(full, newline="", encoding="utf-8") as f:
            delim = "\t" if fmt == "tsv" else ","
            header = next(csv.reader(f, delimiter=delim), None)
        if header:
            schemas[skey] = tuple(header)
    return schemas


def main(argv=None):
    """Run the CLI; returns the ``KGResult`` (None for --explain-mapping)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rdfize")
    ap.add_argument("--mapping", required=True)
    ap.add_argument("--data-root", default=".")
    ap.add_argument("--out", default=None, help="N-Triples output path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine's device steps run (no fallback)")
    ap.add_argument("--engine", default="optimized", choices=("optimized", "naive"))
    ap.add_argument("--join", default="sorted", choices=("sorted", "hash"))
    ap.add_argument("--batch-size", type=int, default=1 << 16)
    ap.add_argument("--stream", action="store_true",
                    help="block-streamed out-of-core ingestion")
    ap.add_argument("--block-rows", type=int, default=None,
                    help="rows per streamed block (with --stream; not ported yet)")
    ap.add_argument("--explain-mapping", action="store_true",
                    help="print the mapping planner's decisions (kept/"
                         "pruned columns, factored terms, rule groups) "
                         "and exit without building the KG")
    ap.add_argument("--no-mapping-plan", action="store_true",
                    help="disable the mapping-level planner (single flat "
                         "rule group)")
    ap.add_argument("--emit", default="nt", choices=("nt", "kgz"),
                    help="output format (N-Triples; kgz is not ported yet)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="sharded .kgz output (not ported yet)")
    ap.add_argument("--shard-workers", type=int, default=None, metavar="M",
                    help="worker processes for sharded builds (not ported yet)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record a Chrome trace-event JSON of the run")
    args = ap.parse_args(argv)

    for asked, what in (
        (args.stream, "--stream: the streamed engine"),
        (args.block_rows is not None, "--block-rows: the streamed engine"),
        (args.engine != "optimized", f"--engine {args.engine}: the naive engine"),
        (args.join != "sorted", f"--join {args.join}: the hash PJTT"),
        (args.emit != "nt", f"--emit {args.emit}: .kgz snapshots"),
        (bool(args.shards), "--shards: sharded stores"),
        (args.shard_workers is not None, "--shard-workers: sharded builds"),
    ):
        if asked:
            ap.error(f"{what} {_LATER}")

    from repro_torch import obs
    from repro_torch.core.executor import create_kg
    from repro_torch.rml import parser

    if args.explain_mapping:
        from repro_torch.rml.plan import build_plan, render_explain

        plan = build_plan(parser.parse_file(args.mapping))
        print(render_explain(plan, schemas=_peek_schemas(plan, args.data_root)))
        return None
    if args.trace:
        obs.enable_tracing()
    with obs.span("parse_mapping", cat="rdfize", path=args.mapping):
        doc = parser.parse_file(args.mapping)
    print(f"[rdfize] {len(doc.triples_maps)} triples maps from {args.mapping}")
    mapping_plan = not args.no_mapping_plan
    if mapping_plan:
        from repro_torch.rml.plan import build_plan

        mplan = build_plan(doc)
        print(f"[rdfize] plan: {len(mplan.exec_plan.ops)} rules over "
              f"{len(mplan.sources)} sources -> {len(mplan.groups)} "
              f"groups ({len(mplan.shared)} shared terms factored)")

    with obs.span("create_kg", cat="rdfize", device=args.device):
        result = create_kg(
            doc,
            data_root=args.data_root,
            batch_size=args.batch_size,
            mapping_plan=mapping_plan,
            device=args.device,
        )
    print(f"[rdfize] {result.n_triples} unique triples in "
          f"{result.wall_time_s:.2f}s ({result.engine} engine, {args.device})")
    _print_stats(result.stats)
    if args.out:
        with obs.span("emit_nt", cat="rdfize", out=args.out):
            n = result.write_ntriples(args.out)
        print(f"[rdfize] wrote {n} triples to {args.out}")
    if args.trace:
        n_ev = obs.save_trace(args.trace)
        print(f"[rdfize] wrote {n_ev}-event trace to {args.trace}")
    return result


if __name__ == "__main__":
    main()
