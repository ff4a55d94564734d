"""Bench-regression gate of the port: diff fresh ``BENCH_*.json`` against
baselines.

The port's copy of ``benchmarks/compare.py``, the same gate and table.
``python -m repro_torch.bench.run`` writes the port's reports into
``bench-out/torch``; then::

    python -m repro_torch.bench.compare --baseline-dir BASELINES \
        --commit-msg "$(git log -1 --pretty=%B)"

``--baseline-dir`` is required: the root ``BENCH_*.json`` are the JAX
package's numbers, and the port has no committed baseline of its own.

For every ``BENCH_*.json`` in ``--new-dir`` (default ``bench-out/torch``)
that also exists in ``--baseline-dir``, every ``queries_per_s`` leaf is
compared: the gate **fails** (exit 1) when a leaf regresses by more than
``--threshold`` (default 30%).  Every ``latency_p99_ms`` leaf fails the gate
when it grows by more than ``--latency-threshold`` (default 50%).
``rows_per_s`` and ``latency_p50_ms`` leaves are reported but never gated.
Leaves with a zero or missing baseline are reported as ``new`` and never
gated.

Baselines may come from another machine, so the gate computes one global
machine-speed factor, the median ``new/baseline`` ratio over every gated
leaf of every report, and gates each leaf on its deviation from it (with
fewer than 3 gated leaves the factor is 1).  ``--no-normalize`` compares
absolutely.  A commit message containing ``[bench-skip]`` makes the gate
report-only.  The markdown delta table is always printed, and appended to
``$GITHUB_STEP_SUMMARY`` when that is set.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

# throughput leaves: gated on a drop; latency leaves: gated on growth
# (machine speed cancels both ways — a slow runner divides throughput and
# multiplies latency by the same factor)
GATED_METRICS = ("queries_per_s",)
GATED_LATENCY_METRICS = ("latency_p99_ms",)
REPORTED_METRICS = (
    "queries_per_s", "rows_per_s", "latency_p50_ms", "latency_p99_ms"
)


def _leaves(obj, prefix: str = "") -> dict[str, float]:
    """Flatten a report to ``path -> value`` for the reported metrics."""
    out: dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in sorted(obj.items()):
            path = f"{prefix}/{k}" if prefix else str(k)
            if k in REPORTED_METRICS and isinstance(v, (int, float)):
                out[path] = float(v)
            else:
                out.update(_leaves(v, path))
    return out


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2


def gated_ratios(baseline: dict, fresh: dict) -> list[float]:
    """new/baseline ratios of the gated leaves present in both reports."""
    base = _leaves(baseline)
    new = _leaves(fresh)
    return [
        new[p] / base[p]
        for p in base
        if p in new and base[p] > 0.0
        and p.rsplit("/", 1)[-1] in GATED_METRICS
    ]


def speed_factor(ratios: list[float]) -> float:
    """The global machine-speed factor: the median gated ratio.  With
    fewer than 3 leaves the median IS (close to) each leaf — a regression
    would normalize itself away — so fall back to absolute comparison."""
    if len(ratios) < 3:
        return 1.0
    factor = _median(ratios)
    return factor if factor > 0.0 else 1.0


def compare_file(
    name: str, baseline: dict, fresh: dict, threshold: float,
    factor: float = 1.0, latency_threshold: float = 0.50,
) -> tuple[list[dict], list[str]]:
    """Rows for the delta table plus the failing leaf paths; each gated
    leaf is thresholded on its deviation from the machine-speed
    ``factor`` the caller divided out (latency leaves use the inverse
    factor: a uniformly slower box multiplies every latency)."""
    base = _leaves(baseline)
    new = _leaves(fresh)
    rows: list[dict] = []
    failures: list[str] = []
    for path in sorted(set(base) | set(new)):
        b = base.get(path)
        n = new.get(path)
        metric = path.rsplit("/", 1)[-1]
        latency = metric in GATED_LATENCY_METRICS or metric.startswith(
            "latency_"
        )
        gated = metric in GATED_METRICS or metric in GATED_LATENCY_METRICS
        if n is None:
            status = "gone"
            delta = None
        elif b is None or b == 0.0:
            status = "new"
            delta = None
        else:
            # deviation from the global median ratio: machine speed
            # cancels, a leaf regressing relative to the rest fails
            if latency:
                # expected latency on this machine is b / factor
                delta = n * factor / b - 1.0
                bad = delta > latency_threshold
            else:
                delta = n / (b * factor) - 1.0
                bad = delta < -threshold
            if gated and bad:
                status = "REGRESSION"
                failures.append(f"{name}:{path}")
            else:
                status = "ok" if gated else "info"
        rows.append(
            {
                "file": name,
                "path": path,
                "baseline": b,
                "new": n,
                "delta": delta,
                "status": status,
            }
        )
    return rows, failures


def _fmt(v: float | None) -> str:
    if v is None:
        return "—"
    return f"{v:,.0f}" if abs(v) >= 100 else f"{v:,.2f}"


def markdown_table(
    rows: list[dict], threshold: float, factor: float,
    latency_threshold: float = 0.50,
) -> str:
    lines = [
        f"### Bench gate (fail below −{threshold:.0%} queries_per_s or "
        f"above +{latency_threshold:.0%} latency_p99_ms, "
        "median-normalized)",
        "",
        f"machine-speed factor (median new/baseline over gated leaves): "
        f"×{factor:.2f}",
        "",
        "| report | metric | baseline | new | delta vs median | status |",
        "|---|---|---:|---:|---:|---|",
    ]
    for r in rows:
        delta = "—" if r["delta"] is None else f"{r['delta']:+.1%}"
        status = r["status"]
        if status == "REGRESSION":
            status = "❌ **REGRESSION**"
        elif status == "ok":
            status = "✅"
        lines.append(
            f"| {r['file']} | `{r['path']}` | {_fmt(r['baseline'])} "
            f"| {_fmt(r['new'])} | {delta} | {status} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.compare",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline-dir", required=True,
                    help="where the baseline BENCH_*.json live")
    ap.add_argument("--new-dir", default=os.path.join("bench-out", "torch"),
                    help="where the fresh BENCH_*.json reports were written")
    ap.add_argument("--threshold", type=float, default=0.30,
                    help="max allowed queries_per_s regression (fraction)")
    ap.add_argument("--latency-threshold", type=float, default=0.50,
                    help="max allowed latency_p99_ms growth (fraction)")
    ap.add_argument("--commit-msg", default="",
                    help="head commit message; '[bench-skip]' makes the "
                         "gate report-only")
    ap.add_argument("--no-normalize", action="store_true",
                    help="gate on raw cross-machine ratios instead of "
                         "deviation from the per-report median")
    args = ap.parse_args(argv)

    fresh_paths = sorted(glob.glob(os.path.join(args.new_dir, "BENCH_*.json")))
    if not fresh_paths:
        print(f"bench-gate: no BENCH_*.json under {args.new_dir}", flush=True)
        return 1
    pairs: list[tuple[str, dict, dict]] = []
    all_rows: list[dict] = []
    for path in fresh_paths:
        name = os.path.basename(path)
        with open(path, encoding="utf-8") as f:
            fresh = json.load(f)
        base_path = os.path.join(args.baseline_dir, name)
        if not os.path.exists(base_path):
            all_rows.append(
                {"file": name, "path": "(whole report)", "baseline": None,
                 "new": None, "delta": None, "status": "new"}
            )
            continue
        with open(base_path, encoding="utf-8") as f:
            baseline = json.load(f)
        pairs.append((name, baseline, fresh))

    ratios = [r for _, b, f in pairs for r in gated_ratios(b, f)]
    factor = 1.0 if args.no_normalize else speed_factor(ratios)
    failures: list[str] = []
    for name, baseline, fresh in pairs:
        rows, fails = compare_file(
            name, baseline, fresh, args.threshold, factor,
            args.latency_threshold,
        )
        all_rows.extend(rows)
        failures.extend(fails)

    skipped = "[bench-skip]" in args.commit_msg
    table = markdown_table(
        all_rows, args.threshold, factor, args.latency_threshold
    )
    if failures:
        verdict = (
            "⚠️ regressions present but gate skipped via `[bench-skip]`"
            if skipped
            else "❌ bench gate FAILED: " + ", ".join(failures)
        )
    else:
        verdict = "✅ bench gate passed"
    report = f"{table}\n\n{verdict}\n"
    print(report, flush=True)
    summary = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary:
        with open(summary, "a", encoding="utf-8") as f:
            f.write(report + "\n")
    return 1 if (failures and not skipped) else 0


if __name__ == "__main__":
    sys.exit(main())
