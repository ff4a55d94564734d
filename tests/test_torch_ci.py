"""The port's bench gate (``repro_torch.bench.compare``) against the JAX
package's (``benchmarks/compare.py``): the same synthetic report
directories give the same exit code, the same printed table and verdict and
the same job summary; the port's defaults (``--new-dir bench-out/torch``,
``--baseline-dir`` required) are its own.  The smoke drivers have their own
files (``test_torch_{serve,shard}_smoke.py``)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report(qps, p99, extra=None):
    classes = {name: {"batch_1": {"queries_per_s": q, "latency_p99_ms": l,
                                  "latency_p50_ms": l / 2, "rows_per_s": q * 3}}
               for name, q, l in zip(("single", "star", "chain", "bgp3"), qps, p99)}
    classes.update(extra or {})
    return {"classes": classes, "n_triples": 1000}


BASE = _report([1000.0, 800.0, 600.0, 400.0], [2.0, 3.0, 4.0, 5.0])
CASES = {
    # a uniformly slower machine: every leaf moves alike, the median cancels it
    "pass": ({"BENCH_serve.json": _report([800.0, 640.0, 480.0, 320.0], [2.5, 3.75, 5.0, 6.25])},
             ""),
    "regression": ({"BENCH_serve.json": _report([1000.0, 800.0, 200.0, 400.0],
                                                [2.0, 3.0, 4.0, 5.0])}, ""),
    "latency": ({"BENCH_serve.json": _report([1000.0, 800.0, 600.0, 400.0],
                                             [2.0, 3.0, 9.0, 5.0])}, ""),
    # a class and a whole report the baseline lacks: reported new, never gated
    "new": ({"BENCH_serve.json": _report([1000.0, 800.0, 600.0, 400.0], [2.0, 3.0, 4.0, 5.0],
                                         {"path3": {"batch_1": {"queries_per_s": 5.0}}}),
             "BENCH_kg.json": {"queries_per_s": 10.0}}, ""),
    "skip": ({"BENCH_serve.json": _report([1000.0, 800.0, 200.0, 400.0],
                                          [2.0, 3.0, 4.0, 5.0])}, "fix [bench-skip] later"),
    "empty": ({}, ""),
}


def _write(d, reports):
    os.makedirs(d, exist_ok=True)
    for name, rep in reports.items():
        with open(os.path.join(d, name), "w") as f:
            json.dump(rep, f)


def _run(cmd, cwd, summary=None):
    env = {k: v for k, v in os.environ.items() if k != "GITHUB_STEP_SUMMARY"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    if summary:
        env["GITHUB_STEP_SUMMARY"] = summary
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    return p.returncode, p.stdout


@pytest.mark.parametrize("case", list(CASES))
def test_compare_matches_jax(tmp_path, case):
    reports, msg = CASES[case]
    base, new = tmp_path / "base", tmp_path / "new"
    _write(base, {"BENCH_serve.json": BASE})
    _write(new, reports)
    args = ["--baseline-dir", str(base), "--new-dir", str(new), "--commit-msg", msg]
    sj, sp = str(tmp_path / "sum_jax.md"), str(tmp_path / "sum_port.md")
    jrc, jout = _run([sys.executable, os.path.join(ROOT, "benchmarks", "compare.py"), *args],
                     ROOT, sj)
    prc, pout = _run([sys.executable, "-m", "repro_torch.bench.compare", *args], ROOT, sp)
    assert (prc, pout) == (jrc, jout)
    want_rc = {"pass": 0, "regression": 1, "latency": 1, "new": 0, "skip": 0, "empty": 1}[case]
    assert prc == want_rc, pout
    if case != "empty":
        with open(sj) as a, open(sp) as b:
            assert a.read() == b.read()
    if case in ("regression", "latency"):
        assert "REGRESSION" in pout
    if case == "new":
        assert "| new |" in pout and "BENCH_kg.json" in pout


def test_compare_defaults_are_the_ports(tmp_path):
    _write(tmp_path / "base", {"BENCH_serve.json": BASE})
    _write(tmp_path / "bench-out" / "torch", {"BENCH_serve.json": BASE})
    rc, out = _run([sys.executable, "-m", "repro_torch.bench.compare", "--baseline-dir",
                    str(tmp_path / "base")], tmp_path)
    assert rc == 0 and "bench gate passed" in out
    # no baseline default: the root BENCH_*.json are the JAX package's numbers
    rc, _ = _run([sys.executable, "-m", "repro_torch.bench.compare"], tmp_path)
    assert rc == 2
