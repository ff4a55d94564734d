"""Dry-run: trace every (arch x shape x mesh) cell and account its cost.

The counterpart of ``repro.launch.dryrun``.  JAX lowers and compiles each
cell on 512 forced host devices and reads XLA's cost and memory analyses.
Here each cell (``configs.registry.build_cell``: fake args at the cell's
global shapes) is traced once under ``FakeTensorMode``, with no memory
allocated, and the trace is read three ways:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``.  The trace runs
  every layer, so ``cost_method`` is ``"direct"``.  JAX's per-layer
  extrapolation from unrolled L=1 and L=2 builds (``_extrapolate``, for its
  scanned layers, which XLA costs once) is kept for ``bench.hillclimb``,
  where it spares tracing a deep LM; for a dense LM it equals the direct
  count;
- ``bytes_accessed``: every op's input and output tensor bytes summed (views
  move nothing; a gather reads as many bytes of its source as it writes).
  Like JAX's CPU ``bytes accessed`` it is an unfused upper bound on device
  traffic;
- the peak of live bytes: ``MemTracker``, the args included.

Per device, on the mesh: ``memory.argument_size_in_bytes`` and
``output_size_in_bytes`` from the args' specs (``sharding.local_shape``; an
output that is an arg updated in place keeps its spec, any other output is
counted whole).  On a one-device mesh ``peak_bytes`` is the traced peak.
On more devices (the accounting meshes of ``launch.mesh``: no cards stand
behind them) ``flops`` is ``flops_global`` split evenly and the peak is the
per-device args plus the trace's temporaries split evenly, both labelled.
``fits`` holds the peak against the card's ``total_memory`` (``--device
cuda``) or ``--hbm-bytes`` (``--device cpu``, which has no default).
Collectives across cards wait for more than one card, so ``collectives``
is null with the reason; JAX's ``collective_bytes`` parses XLA's HLO text
and has no counterpart.

``rdfizer/shuffle_dedup`` (``--extra``) syncs with the host in its probe
loop, so it is run for real on ``--device``: its time, peak (on a card) and
``is_new`` count against the distinct valid keys.

Results stream into ``--out`` one cell at a time, keyed
``"{arch}/{shape}@{mesh}"``; cached cells are skipped unless ``--force``.
A cell's trace is read on every mesh it is asked for (the args' global
shapes rarely change with the mesh); ``--jobs N`` traces N cells at once in
spawned processes (a trace is host work: Python dispatch, no device time).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--cell A/S] \\
        [--mesh single|multi|both|local|all] [--extra] [--force] [--jobs N] \\
        [--out results/torch/dryrun.json] [--device cuda|cpu] [--hbm-bytes N]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.sharding import local_shape
from repro_torch.train.tree import leaves

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                       "results", "torch"))
NO_COLLECTIVES = ("collectives across cards wait for more than one card: the port runs "
                  "in one process")


# gathers read as many rows of their source as they write, not all of it
_GATHERS = {torch.ops.aten.index_select.default, torch.ops.aten.gather.default,
            torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default}


class _BytesMoved(TorchDispatchMode):
    """Sums every op's input and output tensor bytes; views and metadata
    queries move none, and a gather's source counts as many bytes as its
    output."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.is_view or not outs:  # a view, or a metadata query (prim.device)
            return out
        inputs = (args[1:], kwargs, outs, outs) if func in _GATHERS else (args, kwargs, outs)
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor):
                self.total += t.numel() * t.element_size()
        return out


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


def _counted(spec) -> dict:
    """``spec.fn(*spec.args)`` under the three counters: flops, bytes
    accessed, the peak of live bytes (the args included), seconds, and
    ``outputs``: each output tensor's shape, dtype and the index of the arg
    it is (updated in place), or None."""
    from torch.distributed._tools.mem_tracker import MemTracker

    args = leaves(spec.args)
    flops, moved, mem = FlopCounterMode(display=False), _BytesMoved(), MemTracker()
    t0 = time.perf_counter()
    mem.track_external(*args)
    with flops, moved, mem:
        out = spec.fn(*spec.args)
    seconds = time.perf_counter() - t0
    peak = sum(d["Total"] for d in mem.get_tracker_snapshot("peak").values())
    index = {id(a): i for i, a in enumerate(args)}
    outputs = [(tuple(t.shape), t.dtype, index.get(id(t))) for t in tree_leaves(out)
               if isinstance(t, torch.Tensor)]
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(moved.total),
            "peak_bytes": int(peak), "trace_s": seconds, "outputs": outputs, "out": out}


def trace(spec) -> dict:
    """Trace ``spec`` on its fake args (``_counted`` inside their
    ``FakeTensorMode``): nothing runs and nothing is allocated."""
    with leaves(spec.args)[0].fake_mode:
        return _counted(spec)


def measure(spec) -> dict:
    """Run ``spec`` for real on its args under the same counters, for
    holding a trace to a run (``out`` is the real output)."""
    return _counted(spec)


def _memory(spec, outputs, mesh) -> dict:
    """Per-device argument, output and aliased (in place) bytes on ``mesh``."""
    args, specs = leaves(spec.args), leaves(spec.specs)
    if len(args) != len(specs):
        raise ValueError(f"{spec.name}: {len(args)} args but {len(specs)} specs")
    arg = sum(_nbytes(local_shape(a.shape, s, mesh), a.dtype) for a, s in zip(args, specs))
    outb = alias = 0
    for shape, dtype, i in outputs:
        if i is not None:
            shape = local_shape(shape, specs[i], mesh)
            alias += _nbytes(shape, dtype)
        outb += _nbytes(shape, dtype)
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": outb,
            "alias_size_in_bytes": alias}


def _extrapolate(c1: dict, c2: dict, n_layers: int) -> dict:
    """Whole-depth costs from unrolled L=1 and L=2 traces:
    total(L) = cost(1) + (L - 1) * (cost(2) - cost(1))."""

    def ext(a, b):
        return a + (n_layers - 1) * max(b - a, 0.0)

    return {k: ext(c1[k], c2[k]) for k in ("flops", "bytes_accessed")}


def _signature(spec) -> tuple:
    return (spec.name, tuple((tuple(t.shape), t.dtype) for t in leaves(spec.args)))


def run_cell(arch: str, shape: str, mesh, mesh_name: str, *, device="cpu",
             hbm_bytes: int, traces: dict | None = None) -> dict:
    """One cell's record on ``mesh``.  ``traces`` caches traces by the
    cell's arg shapes, so a cell whose args do not change with the mesh is
    traced once for every mesh."""
    from repro_torch.configs import registry

    spec = registry.build_cell(arch, shape, mesh, device=device)
    if isinstance(spec, str):
        return {"status": "skipped", "reason": spec}
    traces = {} if traces is None else traces
    key = _signature(spec)
    if key not in traces:
        traces[key] = trace(spec)
    base = traces[key]
    n = mesh.size
    mem = _memory(spec, base["outputs"], mesh)
    args_global = sum(_nbytes(a.shape, a.dtype) for a in leaves(spec.args))
    if n == 1:
        peak, peak_method = base["peak_bytes"], "traced"
    else:
        peak = mem["argument_size_in_bytes"] + (base["peak_bytes"] - args_global) // n
        peak_method = "per-device args + the trace's temporaries split evenly"
    mem["peak_bytes"] = int(peak)
    return {
        "status": "ok", "mesh": mesh_name, "devices": n, "kind": spec.kind,
        "note": spec.note, "trace_s": round(base["trace_s"], 3), "cost_method": "direct",
        "flops": base["flops"] / n, "flops_global": base["flops"],
        "bytes_accessed": base["bytes_accessed"] / n,
        "bytes_accessed_global": base["bytes_accessed"],
        "split": "even" if n > 1 else None,
        "peak_bytes_global": base["peak_bytes"], "memory": mem,
        "peak_method": peak_method, "hbm_bytes": hbm_bytes, "fits": peak <= hbm_bytes,
        "collectives": None, "collectives_reason": NO_COLLECTIVES,
    }


def run_extra(spec, mesh, mesh_name: str) -> dict:
    """Run an extra cell (real args) once: its time, peak on a card, and
    the shuffle's ``is_new`` count against the distinct valid keys.  A
    shuffle that loses keys (an overflow, or fewer new than distinct) is an
    error."""
    dev = leaves(spec.args)[0].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, n_new, ovf = spec.fn(*spec.args)
    if cuda:
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    _, _, hi, lo, valid = spec.args
    keys = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    n_distinct = int(torch.unique(keys[valid]).numel())
    res = {
        "status": "ok", "mesh": mesh_name, "devices": mesh.size, "kind": spec.kind,
        "note": spec.note, "cost_method": "run", "device": str(dev),
        "run_s": round(run_s, 4),
        "peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else None,
        "n_keys": int(hi.numel()), "n_new": int(n_new), "n_distinct": n_distinct,
        "overflow": bool(ovf), "collectives": None, "collectives_reason": NO_COLLECTIVES,
    }
    if res["overflow"] or res["n_new"] != n_distinct:
        # the cell's 2^22 slots a shard hold its keys on the production
        # meshes; on a mesh of few devices the table fills and keys are lost
        res["status"] = "error"
        res["error"] = (f"PTT insert lost keys: is_new {res['n_new']} of {n_distinct} "
                        f"distinct, overflow {res['overflow']}, {mesh.size} shard(s)")
    return res


def _cell_records(item) -> list:
    """Every mesh's record of one cell (a worker's unit with ``--jobs``)."""
    arch, shape, meshes, device, hbm = item
    traces: dict = {}
    out = []
    for mesh_name, mesh in meshes:
        try:
            res = run_cell(arch, shape, mesh, mesh_name, device=device, hbm_bytes=hbm,
                           traces=traces)
        except Exception as e:  # noqa: BLE001 - a failed cell is recorded, the run goes on
            res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        out.append((f"{arch}/{shape}@{mesh_name}", res))
    return out


def _meshes(which: str, device: str) -> list:
    out = []
    if which in ("local", "all"):
        out.append(("local", make_local_mesh() if device == "cuda" else make_local_mesh(1)))
    if which in ("single", "both", "all"):
        out.append(("single_pod_16x16", make_production_mesh(multi_pod=False)))
    if which in ("multi", "both", "all"):
        out.append(("multi_pod_2x16x16", make_production_mesh(multi_pod=True)))
    return out


def _line(res: dict) -> str:
    if res.get("cost_method") == "run":
        return (f" run={res['run_s']}s new={res['n_new']} distinct={res['n_distinct']}"
                f" overflow={res['overflow']}")
    if res["status"] == "ok":
        gib = res["memory"]["peak_bytes"] / (1 << 30)
        return (f" flops={res['flops_global']:.3e} peak={gib:.2f}GiB/dev"
                f" fits={res['fits']} trace={res['trace_s']}s")
    if res["status"] == "error":
        return " " + res["error"][:200]
    return ""


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None, help="arch/shape")
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both", "local", "all"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--extra", action="store_true", help="include the rdfizer cell (run)")
    ap.add_argument("--out", default=os.path.join(RESULTS, "dryrun.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a spawned process")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="the memory a device holds (--device cpu only: a card gives its own)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    from repro_torch.configs import registry

    if args.device == "cuda":
        if not torch.cuda.is_available():
            ap.error("--device cuda needs an NVIDIA card; pass --device cpu and --hbm-bytes")
        if args.hbm_bytes is not None:
            ap.error("--hbm-bytes is for --device cpu: on a card its total_memory is the limit")
        hbm = torch.cuda.get_device_properties(0).total_memory
    else:
        if args.hbm_bytes is None:
            ap.error("--device cpu needs --hbm-bytes: there is no card to read a limit from")
        hbm = args.hbm_bytes

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    def save(key, res):
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] {key}: {res['status']}{_line(res)}", flush=True)

    cells = [(a.name, s) for a in registry.ARCHS.values() for s in a.shapes
             if not args.arch or a.name == args.arch]
    if args.cell:
        cells = [tuple(args.cell.split("/"))]
    meshes = _meshes(args.mesh, args.device)
    todo = []
    for arch, shape in cells:
        keys = [f"{arch}/{shape}@{name}" for name, _ in meshes]
        if not args.force and all(results.get(k, {}).get("status") in ("ok", "skipped")
                                  for k in keys):
            print(f"[cached] {arch}/{shape}")
            continue
        todo.append((arch, shape, meshes, args.device, hbm))
    if args.jobs > 1:
        # the LM cells trace longest: start them first
        todo.sort(key=lambda it: registry.get_arch(it[0]).family != "lm")
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs) as pool:
            for records in pool.imap_unordered(_cell_records, todo):
                for key, res in records:
                    save(key, res)
    else:
        for item in todo:
            print(f"[dryrun] {item[0]}/{item[1]} ...", flush=True)
            for key, res in _cell_records(item):
                save(key, res)

    if args.extra:
        for mesh_name, mesh in meshes:
            key = f"rdfizer/shuffle_dedup@{mesh_name}"
            if results.get(key, {}).get("status") == "ok" and not args.force:
                print(f"[cached] {key}: ok")
                continue
            print(f"[dryrun] {key} ...", flush=True)
            try:
                for spec in registry.build_extra_cells(mesh, device=args.device, fake=False):
                    res = run_extra(spec, mesh, mesh_name)
                    del spec
            except Exception as e:  # noqa: BLE001
                res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            save(key, res)
            if args.device == "cuda":
                torch.cuda.empty_cache()

    n = {s: sum(1 for r in results.values() if r["status"] == s)
         for s in ("ok", "skipped", "error")}
    print(f"\ndry-run summary: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors")
    for k, r in results.items():
        if r["status"] == "error":
            print(f"  ERROR {k}: {r['error'][:300]}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
