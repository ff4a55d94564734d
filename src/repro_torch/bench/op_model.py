"""Operation-count model check (paper §III.iv), on the card.

Runs each operator on controlled data and verifies the measured candidate /
unique counts reproduce the φ expressions, then reports the φ̂/φ ratio — the
paper's analytical explanation for the observed two-orders-of-magnitude
speedups.  The same cells and seed as ``benchmarks/op_model.py``; the engine
runs on ``device``.
"""

from __future__ import annotations

from repro_torch.core.executor import create_kg
from repro_torch.rml import generator


def run(sizes=(10_000, 100_000), dups=(0.25, 0.75), device="cuda", log=True):
    rows = []
    for kind in ("SOM", "ORM", "OJM"):
        for n in sizes:
            for dup in dups:
                tb = generator.make_testbed(kind, n, dup, n_poms=1, seed=23)
                tables = {"csv:child.csv": tb.child}
                if tb.parent is not None:
                    tables["csv:parent.csv"] = tb.parent
                res = create_kg(tb.doc, tables=tables, device=device)
                st = [s for s in res.stats.values() if s.kind == kind][0]
                ratio = st.phi_naive() / max(st.phi_optimized(), 1)
                rows.append(
                    dict(kind=kind, rows=n, dup=dup, Np=st.n_candidates,
                         Sp=st.n_unique, phi=int(st.phi_optimized()),
                         phi_naive=int(st.phi_naive()), ratio=ratio)
                )
                if log:
                    print(f"  {kind} n={n} dup={int(dup*100)}%: |Np|={st.n_candidates} "
                          f"|Sp|={st.n_unique} phi={int(st.phi_optimized()):,} "
                          f"phi_naive={int(st.phi_naive()):,} ratio={ratio:.1f}x")
    return rows


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.op_model")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    run(device=ap.parse_args().device)
