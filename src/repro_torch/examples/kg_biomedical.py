"""End-to-end driver: the paper's evaluation in one script.

The port of ``examples/kg_biomedical.py``: creates the three testbed
families (SOM / ORM / OJM) at a chosen scale, runs BOTH engines
(SDM-RDFizer vs the naive SDM-RDFizer⁻ baseline) on ``--device`` (``cuda``
by default; no fallback), verifies the knowledge graphs are identical, and
prints the speedup + φ table, a miniature of the paper's Figures 5/6.
Every printed count and φ ratio equals the JAX example's; the times are
this run's.  ``main`` returns each testbed's two results.

    PYTHONPATH=src python -m repro_torch.examples.kg_biomedical --rows 20000 --dup 0.75
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core.executor import create_kg, resolve_device
from repro_torch.rml import generator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.kg_biomedical")
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--dup", type=float, default=0.75)
    ap.add_argument("--n-poms", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where both engines run (no fallback)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results = {}
    print(f"{'testbed':<10} {'engine':<10} {'time':>8} {'triples':>9}  speedup")
    for kind in ("SOM", "ORM", "OJM"):
        tb = generator.make_testbed(kind, args.rows, args.dup, n_poms=args.n_poms)
        tables = {"csv:child.csv": tb.child}
        if tb.parent is not None:
            tables["csv:parent.csv"] = tb.parent

        t0 = time.perf_counter()
        opt = create_kg(tb.doc, tables=tables, engine="optimized", device=dev)
        t_opt = time.perf_counter() - t0

        t0 = time.perf_counter()
        nav = create_kg(tb.doc, tables=tables, engine="naive", device=dev)
        t_nav = time.perf_counter() - t0

        if opt.as_set() != nav.as_set():
            raise AssertionError(f"{kind}: the engines disagree")
        print(f"{kind:<10} {'optimized':<10} {t_opt:>7.2f}s {opt.n_triples:>9}")
        print(f"{'':<10} {'naive':<10} {t_nav:>7.2f}s {nav.n_triples:>9}  "
              f"{t_nav/t_opt:.2f}x")
        for pred, st in opt.stats.items():
            if st.kind == kind:
                print(f"{'':<21}  phi ratio {pred.rsplit('/',1)[-1]}: "
                      f"{st.phi_naive()/max(st.phi_optimized(),1):.0f}x")
        results[kind] = (opt, nav)
    return results


if __name__ == "__main__":
    main()
