"""The three hillclimb variants of ``benchmarks/hillclimb.py``, through the
port's dry-run: a baseline and a variant of each cell, traced (fake
tensors) and accounted on the single-pod mesh (16x16, an accounting mesh),
their roofline terms side by side in ``results/torch/hillclimb.json``.

  1. dbrx-132b/train_4k       — int8 FSDP expert-weight gathers
                                (``moe_quant_gather``)
  2. command-r-plus-104b/decode_32k — the serve-resident TP layout
                                (``serve_layout``)
  3. wide-deep/train_batch    — the PTT dedup-gather on the id stream
                                (``dedup_cap=40960``)

The LM variants are costed as JAX costs them: unrolled L=1 and L=2 traces
extrapolated to the whole depth (``launch.dryrun._extrapolate``); their
per-device argument bytes come from the whole-depth specs.  Each record
carries the collectives of one device's program (the sharded trace of
``launch.dryrun``, extrapolated likewise for the LMs) and their term at
the NVLink figure (``t_collective_s``).  dbrx's ``moe_quant_gather``
acts in the expert gathers of ``moe._forward_sharded``, which the sharded
trace runs, so its two variants differ in their all-gather bytes (int8
on the wire).  The two command-r layouts split the weights differently
but hold the same weight bytes a device, leaf for leaf; the serve layout
replicates the token batch where the baseline shards it, so the argument
bytes a device differ only by those tokens, and what the layout changes
is the collectives.
Wide & Deep's dedup runs on the whole batch in the flops trace (one
device) and on each rank's ids in the sharded trace, where JAX's cap of
40,960 is a data shard's.

Every trace runs on fake tensors: nothing is allocated and nothing runs on
a device, so no ``--device`` is asked for.

    PYTHONPATH=src python -m repro_torch.bench.hillclimb [--which 1 2 3] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.bench import roofline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

RESULTS = roofline.RESULTS
def _record(cost: dict, arg_bytes: int, mesh, method: str) -> dict:
    n = mesh.size
    flops, moved = cost["flops"] / n, cost["bytes_accessed"] / n
    coll = {k: cost["collectives"][k] for k in ("bytes_by_kind", "counts", "total_bytes")}
    return {
        "cost_method": method, "devices": n, "flops": flops, "flops_global": cost["flops"],
        "bytes_accessed": moved, "memory": {"argument_size_in_bytes": arg_bytes},
        "collectives": coll,
        "t_compute_s": flops / roofline.PEAK_FLOPS, "t_memory_s": moved / roofline.HBM_BW,
        "t_collective_s": coll["total_bytes"] / roofline.LINK_BW,
    }


def _costs(build, mesh) -> dict:
    """A cell's trace and, separately, its sharded trace's collectives."""
    return {**dryrun.trace(build()),
            "collectives": dryrun.sharded_collectives(build, mesh)}


def _lm(build, n_layers: int, mesh) -> dict:
    """Extrapolated costs of an LM cell, ``build(n_layers_or_None)``."""
    c1, c2 = (_costs(lambda n=n: build(n), mesh) for n in (1, 2))
    arg_bytes = dryrun._memory(build(None), [], mesh)["argument_size_in_bytes"]
    return _record(dryrun._extrapolate(c1, c2, n_layers), arg_bytes, mesh,
                   "unrolled L=1/L=2 marginal extrapolation")


def _line(rec: dict) -> str:
    coll = rec["collectives"]
    return (f"flops={rec['flops']:.3e}/dev coll={coll['total_bytes']:.3e}B/dev "
            f"{coll['bytes_by_kind']}")


def _unrolled(cfg, n_layers):
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, scan_layers=False)


def hc1_dbrx(mesh) -> dict:
    from repro_torch.configs import cells, dbrx_132b

    out = {}
    for name, quant in (("baseline", False), ("int8_gather", True)):
        cfg = dataclasses.replace(dbrx_132b.config(), moe_quant_gather=quant)

        def build(n_layers):
            return cells.lm_train_cell(_unrolled(cfg, n_layers), mesh, batch=256, seq=4096)

        out[name] = _lm(build, cfg.n_layers, mesh)
        print(f"  dbrx train {name}: {_line(out[name])}", flush=True)
    return out


def hc2_commandr_decode(mesh, cfg=None, batch: int = 128, ctx: int = 32768) -> dict:
    """``cfg`` defaults to command-r's published config; a smaller one
    (and ``batch``, ``ctx``) traces the same variants at a test's size."""
    from repro_torch.configs import cells, command_r_plus_104b

    cfg = cfg if cfg is not None else command_r_plus_104b.config()
    out = {}
    for name, serve in (("baseline_fsdp", False), ("serve_resident_tp", True)):
        def build(n_layers):
            return cells.lm_decode_cell(_unrolled(cfg, n_layers), mesh, batch, ctx,
                                        serve_layout=serve)

        out[name] = _lm(build, cfg.n_layers, mesh)
        args = out[name]["memory"]["argument_size_in_bytes"] / (1 << 30)
        print(f"  command-r decode {name}: {_line(out[name])} args={args:.2f}GiB/dev",
              flush=True)
    return out


def hc3_widedeep(mesh, cfg=None, batch: int = 65536, cap: int = 40960) -> dict:
    """``cfg`` defaults to Wide & Deep's published config, as in hc2."""
    from repro_torch.configs import cells, wide_deep

    base = cfg if cfg is not None else wide_deep.config()
    out = {}
    for name, dedup_cap in (("baseline", None), ("dedup_gather", cap)):
        cfg = dataclasses.replace(base, dedup_cap=dedup_cap)

        def build(cfg=cfg):
            return cells.recsys_train_cell(cfg, mesh, batch)

        t = _costs(build, mesh)
        out[name] = _record(t, dryrun._memory(build(), t["outputs"], mesh)[
            "argument_size_in_bytes"], mesh, "direct")
        print(f"  wide-deep train {name}: {_line(out[name])} "
              f"bytes={out[name]['bytes_accessed']:.3e}/dev", flush=True)
    return out


RUNS = {1: ("dbrx_train_int8_gather", hc1_dbrx),
        2: ("commandr_decode_serve_tp", hc2_commandr_decode),
        3: ("widedeep_dedup_gather", hc3_widedeep)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.hillclimb")
    ap.add_argument("--which", nargs="*", type=int, default=[1, 2, 3])
    ap.add_argument("--out", default=os.path.join(RESULTS, "hillclimb.json"))
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=False)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for i in args.which:
        name, fn = RUNS[i]
        print(f"[hillclimb {i}] {name}", flush=True)
        results[name] = fn(mesh)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
