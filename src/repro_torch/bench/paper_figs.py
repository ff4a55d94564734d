"""Paper Figures 5 & 6: execution time of KG creation, on the card.

    PYTHONPATH=src python -m repro_torch.bench.paper_figs [--full] \
        [--out results/paper_figs_torch.json] [--device cuda|cpu]

Grid: dataset size x duplicate rate {25%, 75%} x operator {SOM, ORM, OJM} x
n predicate-object maps, engine (SDM-RDFizer) vs baseline (SDM-RDFizer⁻),
with the JAX package's seeds and statistics columns (``benchmarks/
paper_figs.py``).  The naive OJM is Θ(|N_parent|·|N_child|); the JAX
package caps it with a budget and reports the paper's "times out" cell as
DNF.  On the card the nested-loop join (kernel K3) runs the 1M × 1M cell,
so the budget applies only when ``device == "cpu"``, which keeps CPU runs
comparable with the JAX package's.
"""

from __future__ import annotations

import time

from repro_torch.core.executor import create_kg
from repro_torch.rml import generator

NAIVE_OJM_COMPARISON_BUDGET = 1.2e10  # |Np|x|Nc| above this -> DNF on the CPU
SEED = 17


def _testbed(kind: str, n_rows: int, dup: float, n_poms: int):
    return generator.make_testbed(kind, n_rows, dup, n_poms=n_poms, seed=SEED)


def run_cell(kind: str, n_rows: int, dup: float, n_poms: int, engine: str,
             repeats: int = 1, device="cuda", tb=None) -> dict:
    """One cell: ``create_kg`` on ``device``, the best of ``repeats``
    timings.  ``tb`` passes a testbed already made for this cell."""
    if engine == "naive" and kind == "OJM" and str(device) == "cpu":
        if n_rows * n_rows * n_poms > NAIVE_OJM_COMPARISON_BUDGET:
            return {"status": "DNF", "time_s": float("inf"), "n_triples": -1}
    tb = _testbed(kind, n_rows, dup, n_poms) if tb is None else tb
    tables = {"csv:child.csv": tb.child}
    if tb.parent is not None:
        tables["csv:parent.csv"] = tb.parent
    times = []
    res = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = create_kg(tb.doc, tables=tables, engine=engine, device=device)
        times.append(time.perf_counter() - t0)
    return {
        "status": "ok",
        "time_s": min(times),
        "n_triples": res.n_triples,
        "stats": {
            p: dict(kind=s.kind, Np=s.n_candidates, Sp=s.n_unique,
                    phi=int(s.phi_optimized()), phi_naive=int(s.phi_naive()))
            for p, s in res.stats.items()
        },
    }


def sweep(sizes=(10_000, 100_000), dups=(0.25, 0.75), kinds=("SOM", "ORM", "OJM"),
          n_poms_list=(1, 2, 4), engines=("optimized", "naive"), device="cuda",
          log=True):
    """Every cell of the grid on ``device``; one row each, with its
    statistics.  Each engine runs once untimed first on a small testbed,
    so no cell's time includes building the kernels or starting CUDA."""
    for eng in engines:
        run_cell(kinds[0], 1_000, dups[0], n_poms_list[0], eng, device=device)
    rows = []
    for kind in kinds:
        for n in sizes:
            for dup in dups:
                for npm in n_poms_list:
                    tb = _testbed(kind, n, dup, npm)
                    for eng in engines:
                        r = run_cell(kind, n, dup, npm, eng, device=device, tb=tb)
                        rows.append(
                            dict(kind=kind, rows=n, dup=dup, n_poms=npm,
                                 engine=eng, device=str(device),
                                 **{k: r[k] for k in ("status", "time_s", "n_triples")},
                                 stats=r.get("stats"))
                        )
                        if log:
                            t = "DNF" if r["status"] == "DNF" else f"{r['time_s']:.4f}s"
                            print(f"  {kind} n={n} dup={int(dup*100)}% poms={npm} "
                                  f"{eng:9s}: {t} triples={r['n_triples']}", flush=True)
    return rows


def main(argv=None):
    import argparse
    import json
    import os

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.paper_figs")
    ap.add_argument("--full", action="store_true", help="include the 1M-row tier")
    ap.add_argument("--out", default="results/paper_figs_torch.json")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (no fallback)")
    args = ap.parse_args(argv)
    sizes = (10_000, 100_000, 1_000_000) if args.full else (10_000, 100_000)
    rows = sweep(sizes=sizes, n_poms_list=(1, 2, 4) if args.full else (1, 2),
                 device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
