"""Quickstart: create an RDF knowledge graph from CSVs with the SDM-RDFizer
engine, the paper's motivating example in miniature.

The port of ``examples/quickstart.py``: the same testbed, mapping, plan and
knowledge graph, made by ``repro_torch`` on ``--device`` (``cuda`` by
default; no fallback).  Every line it prints but the time equals the JAX
example's.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import api
from repro_torch.core.executor import create_kg, resolve_device
from repro_torch.rml import generator, parser, serializer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (no fallback)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. A biomedical-style testbed: mutations (child) joined to exons
    #    (parent) on the ENST accession, the paper's Figure 1 scenario.
    tb = generator.make_ojm_testbed(n_rows=5000, dup_rate=0.25, n_poms=2)

    with tempfile.TemporaryDirectory() as tmp:
        tb.write(tmp)
        mapping_path = os.path.join(tmp, "mapping.ttl")
        serializer.write_turtle(tb.doc, mapping_path)
        print(f"mapping written to {mapping_path}:")
        print("\n".join(serializer.to_turtle(tb.doc).splitlines()[:12]), "\n...")

        # 2. Parse the RML document back, look at the mapping planner's
        #    decisions (what `rdfize --explain-mapping` prints: kept vs
        #    pruned columns, factored shared terms, rule groups), then
        #    create the knowledge graph.
        doc = parser.parse_file(mapping_path)
        print("\nmapping plan (rdfize --explain-mapping):")
        print(api.explain_mapping(doc, data_root=tmp))
        result = create_kg(doc, data_root=tmp, engine="optimized", device=dev)

        print(f"\ncreated {result.n_triples} unique RDF triples "
              f"in {result.wall_time_s:.2f}s")
        for pred, st in result.stats.items():
            print(f"  {st.kind:5s} {pred.rsplit('/', 1)[-1]:20s} "
                  f"|N_p|={st.n_candidates:>7} |S_p|={st.n_unique:>7} "
                  f"phi_naive/phi={st.phi_naive()/max(st.phi_optimized(),1):>8.1f}x")

        # 3. Serialize a sample.
        out = os.path.join(tmp, "kg.nt")
        result.write_ntriples(out)
        with open(out) as f:
            print("\nfirst three triples:")
            for _ in range(3):
                print(" ", f.readline().strip())


if __name__ == "__main__":
    main()
