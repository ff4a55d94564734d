"""Roofline terms from the dry-run's records, with the H100's constants.

The counterpart of ``benchmarks/roofline.py``.  For each ``ok`` cell of
``results/torch/dryrun.json`` (``launch.dryrun``):

    compute term    = flops per device / PEAK_FLOPS
    memory term     = bytes accessed per device / HBM_BW
    collective term = collective bytes per device / LINK_BW

``flops`` and ``bytes_accessed`` are a fake-tensor trace's, split evenly
over the mesh's devices on the accounting meshes; the collective bytes are
the sharded trace's, one device's program (``collectives.total_bytes``, by
JAX's rule: each collective's larger of operand and result bytes).
``bytes_accessed`` is an unfused upper bound, so a second bound leaves the
memory term out (compute or collective), as ``benchmarks/roofline.py``
brackets it.  ``MODEL_FLOPS`` keeps JAX's accounting: train 6·N·D, prefill
2·N·D, decode 2·N·B (active params for MoE), D = global tokens.  The
constants are one NVIDIA H100 SXM's published peaks (dense bf16, HBM3,
NVLink 4: 900 GB/s both ways, 450 GB/s a direction), as ``chip_smoke.py``
bounds kernels with them; the record names no card, so a roofline share is
of the published peak.  The accounting meshes of 256 and 512 devices span
many NVLink domains (eight cards a node); one link figure stands for every
hop, as JAX's roofline uses one ICI figure.  The extra cell, which runs
rather than traces, gets no row.

    PYTHONPATH=src python -m repro_torch.bench.roofline [--results PATH] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os

PEAK_FLOPS = 989e12   # bf16 dense, one H100 SXM
HBM_BW = 3.35e12      # B/s
LINK_BW = 450e9       # B/s, NVLink 4 a direction (900 GB/s both ways), one H100 SXM

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                       "results", "torch"))

LM_SHAPE_TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128,
    "long_500k": 1,
}


def model_flops(arch: str, shape: str) -> float | None:
    """Paper-standard useful FLOPs for the LM family (global)."""
    from repro_torch.configs import registry

    entry = registry.ARCHS.get(arch)
    if entry is None or entry.family != "lm":
        return None
    n_active = entry.config().active_param_count()
    toks = LM_SHAPE_TOKENS[shape]
    if shape == "train_4k":
        return 6.0 * n_active * toks
    return 2.0 * n_active * toks  # forward only (prefill / one decode step)


def derive(results_path: str | None = None) -> list[dict]:
    path = results_path or os.path.join(RESULTS, "dryrun.json")
    with open(path) as f:
        results = json.load(f)

    rows = []
    for key, r in sorted(results.items()):
        if r.get("status") == "skipped":
            rows.append({"cell": key, "status": "skipped"})
        if r.get("status") != "ok" or "flops" not in r:
            continue
        cell, _mesh = key.split("@")
        arch, shape = (cell.split("/") + [""])[:2]
        n_dev = r["devices"]
        t_compute = r["flops"] / PEAK_FLOPS
        t_memory = r["bytes_accessed"] / HBM_BW
        if r.get("collectives") is None:  # the sharded trace failed: no link term
            rows.append({"cell": key, "status": "no_collectives",
                         "reason": r.get("collectives_error")})
            continue
        t_coll = r["collectives"]["total_bytes"] / LINK_BW
        terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
        bound = max(terms, key=terms.get)
        t_bound = terms[bound]
        # the memory term is an unfused upper bound: a second bound without it
        t_bound_nm = max(t_compute, t_coll)
        row = {
            "cell": key, "status": "ok", "devices": n_dev,
            "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
            "bound": bound, "t_bound_s": t_bound,
            "bound_excl_mem": "compute" if t_compute >= t_coll else "collective",
        }
        mf = model_flops(arch, shape)
        if mf is not None:
            t_ideal = mf / n_dev / PEAK_FLOPS
            row["model_flops_global"] = mf
            row["useful_flops_ratio"] = (mf / n_dev) / max(r["flops"], 1.0)
            row["roofline_frac"] = t_ideal / max(t_bound, 1e-30)
            row["roofline_frac_excl_mem"] = t_ideal / max(t_bound_nm, 1e-30)
        else:
            row["roofline_frac"] = t_compute / max(t_bound, 1e-30)
            row["roofline_frac_excl_mem"] = t_compute / max(t_bound_nm, 1e-30)
        rows.append(row)
    return rows


def render(rows: list[dict]) -> str:
    hdr = (f"{'cell':<46} {'bound':<10} {'t_comp(s)':>10} {'t_mem(s)':>10} "
           f"{'t_coll(s)':>10} {'roofl%':>7} {'xm%':>6} {'useful%':>8}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"{r['cell']:<46} {r['status']}")
            continue
        rf = r.get("roofline_frac", 0.0) * 100
        rx = r.get("roofline_frac_excl_mem", 0.0) * 100
        uf = r.get("useful_flops_ratio")
        out.append(
            f"{r['cell']:<46} {r['bound']:<10} {r['t_compute_s']:>10.4f} "
            f"{r['t_memory_s']:>10.4f} {r['t_collective_s']:>10.4f} "
            f"{rf:>6.1f}% {rx:>5.1f}% {('%7.1f%%' % (uf * 100)) if uf else '      —'}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.roofline")
    ap.add_argument("--results", default=None)
    ap.add_argument("--out", default=os.path.join(RESULTS, "roofline.json"))
    args = ap.parse_args(argv)
    rows = derive(args.results)
    print(render(rows))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
