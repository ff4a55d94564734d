"""dedup_gather benchmark — the paper's PTT saving applied to embedding
lookups.

    PYTHONPATH=src python -m repro_torch.bench.dedup_gather [--device cuda|cpu]

The port of ``benchmarks/dedup_gather_bench.py``: the plain gather against
``dedup_gather`` across duplicate rates, with the same seed, sizes and row
keys, and the traffic model: rows fetched (|N| against the cap |S|), which
on a row-sharded table is the cross-device traffic.  On the card each call
is timed by CUDA events (the best of ``repeats`` after a warm-up); on the
CPU by the host clock.  Each row also says whether the dedup values equal
the plain gather's bit for bit (``values_exact``) and the distinct count
numpy finds (``n_unique_numpy``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.dedup_gather import dedup_gather


def best_time_s(fn, device: torch.device, repeats: int = 5) -> float:
    """Best of ``repeats`` calls of ``fn`` after one warm-up, in seconds:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts)
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3)
    return min(ts)


def run(vocab=1_000_000, dim=64, n=262_144, dup_factors=(1, 4, 16, 64), device="cuda",
        log=True):
    device = torch.device(device)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(vocab, dim)).astype(np.float32)).to(device)
    rows = []
    for f in dup_factors:
        n_distinct = max(n // f, 1)
        ids_np = rng.choice(n_distinct, size=n).astype(np.int32)
        ids = torch.from_numpy(ids_np).to(device)
        cap = int(n_distinct * 1.5)
        t_plain = best_time_s(lambda: table.index_select(0, ids), device)
        t_dedup = best_time_s(lambda: dedup_gather(table, ids, cap).values, device)
        res = dedup_gather(table, ids, cap)
        n_unique = int(res.n_unique)
        rows.append(
            dict(dup_factor=f, n=n, n_unique=n_unique,
                 t_plain_s=t_plain, t_dedup_s=t_dedup,
                 rows_fetched_plain=n, rows_fetched_dedup=cap,
                 traffic_saving=n / cap, device=str(device),
                 n_unique_numpy=len(np.unique(ids_np)),
                 values_exact=bool(torch.equal(res.values, table.index_select(0, ids))))
        )
        if log:
            print(f"  dup x{f:<3}: plain {t_plain*1e3:7.3f}ms  dedup {t_dedup*1e3:7.3f}ms  "
                  f"unique={n_unique:>7}  traffic |N|/|S|cap = {n/cap:.1f}x", flush=True)
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.dedup_gather")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the table lives (no fallback)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
