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

``collectives``, per device, is JAX's record (``bytes_by_kind``,
``counts``, ``total_bytes``), from a second, separate pass: the sharded
trace.  Each cell is traced again as its per-device program on the mesh:
rank 0 of a fake process group of the mesh's size
(``launch.mesh.fake_process_mesh``, JAX's forced host devices), the args
DTensors laid out by their specs, every op propagated by DTensor's rules,
the shard_map arms on their local blocks (``models.sharding``).
``Collectives`` sees every collective that program issues and files it
under XLA's kind by JAX's byte rule: the larger of its operand and result
bytes, lists summed (``collective_bytes``'s rule); a group of one rank
moves nothing and is not counted, as XLA drops it.  An op DTensor has no
sharding rule for runs on replicated inputs, and ``replicated_for`` names
it with its calls.  A scanned LM counts from unrolled L=1 and L=2 sharded
traces, extrapolated as JAX does (``cost_method`` says so); every other
cell counts its whole program.

``rdfizer/shuffle_dedup`` (``--extra``) syncs with the host in its probe
loop, so it is run for real on ``--device``: its time, peak (on a card) and
``is_new`` count against the distinct valid keys.  Its collectives are its
rank program's (the process-mesh arm of ``core.distributed``) traced on the
fake group; the probe loop is local and its body is traced once, as XLA
counts a compiled while loop once.

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
import re
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import sharding
from repro_torch.models.sharding import local_shape
from repro_torch.train.tree import leaves, unflatten

RESULTS = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                       "results", "torch"))


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


# the collectives by op name, filed under XLA's kinds; a wait moves nothing
_KINDS = {
    "c10d::allreduce_": "all-reduce", "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::_allgather_base_": "all-gather", "c10d::allgather_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter", "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all", "c10d::alltoall_": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _KINDS.update({
        f"{_ns}::all_reduce": "all-reduce", f"{_ns}::all_reduce_": "all-reduce",
        f"{_ns}::all_reduce_coalesced": "all-reduce", f"{_ns}::all_reduce_coalesced_": "all-reduce",
        f"{_ns}::all_gather_into_tensor": "all-gather",
        f"{_ns}::all_gather_into_tensor_out": "all-gather",
        f"{_ns}::all_gather_into_tensor_coalesced": "all-gather",
        f"{_ns}::reduce_scatter_tensor": "reduce-scatter",
        f"{_ns}::reduce_scatter_tensor_coalesced": "reduce-scatter",
        f"{_ns}::all_to_all_single": "all-to-all",
    })
_MOVE_NOTHING = {"_c10d_functional::wait_tensor", "c10d::barrier", "c10d::monitored_barrier_"}
_COLLECTIVE_NS = ("c10d::", "_c10d_functional::", "_c10d_functional_autograd::")


def _tensor_bytes(x) -> int:
    """Bytes of a tensor, or of the tensors in a (nested) list or tuple."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_size(args) -> int | None:
    """The ranks of a collective's group: a process group argument, or a
    group's name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):  # a c10d op's boxed group (or reduce op)
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
        if isinstance(a, str) and not a.isidentifier():  # a group name, not a reduce op
            return _resolve_process_group(a).size()
    return None


class Collectives(TorchDispatchMode):
    """Counts the collectives a program issues, per device, by JAX's rule
    (``collective_bytes``): each one filed under XLA's kind, its bytes the
    larger of its operand and result bytes (lists summed).  A c10d op
    writes its results into its first argument and reads its second (the
    one tensor list of an all-reduce); a functional one returns them.  An
    op on DTensors passes to DTensor first, so the collectives it lowers
    to are the ones seen.  A collective over one rank moves nothing and is
    not counted (XLA drops it); one of no known kind raises."""

    def __init__(self):
        super().__init__()
        self.bytes_by_kind: dict[str, int] = {}
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in _MOVE_NOTHING or not (name in _KINDS or name.startswith(_COLLECTIVE_NS)):
            return out
        if name not in _KINDS:
            raise ValueError(f"collective {name} has no XLA kind to count it under")
        if _group_size(args) == 1:
            return out
        if name.startswith("c10d::"):
            operand, result = (args[1] if len(args) > 1 else None), args[0]
        else:
            operand, result = args[0], out
        kind = _KINDS[name]
        nbytes = max(_tensor_bytes(operand), _tensor_bytes(result))
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.counts[kind] = self.counts.get(kind, 0) + 1
        return out

    def record(self) -> dict:
        """JAX's record: ``bytes_by_kind``, ``counts``, ``total_bytes``."""
        return {"bytes_by_kind": dict(self.bytes_by_kind), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_kind.values())}


_RULE_MISSING = re.compile(r"Operator (\S+) does not have a sharding strategy registered")


def _op(name: str):
    """``aten.index_add.default`` -> the op."""
    op = torch.ops
    for part in name.split("."):
        op = getattr(op, part)
    return op


def sharded_collectives(build, mesh) -> dict:
    """The collectives of one device of ``mesh``: ``build()`` makes the cell
    (fake args at global shapes) inside a fake process group of the mesh's
    size, and its ``fn`` runs as rank 0's program on the args laid out by
    their specs.  An op DTensor
    has no rule for is run on replicated inputs and named in
    ``replicated_for``: the trace starts again with it handled."""
    from repro_torch.launch.mesh import fake_process_mesh

    handler, ops = sharding.Replicated(), []
    while True:
        try:
            with fake_process_mesh(mesh) as pm, sharding.sharded_trace(pm, handler, ops):
                spec = build()
                counter = Collectives()
                with leaves(spec.args)[0].fake_mode:
                    args = unflatten(spec.args, [
                        sharding.distribute(a, s, pm)
                        for a, s in zip(leaves(spec.args), leaves(spec.specs), strict=True)])
                    with counter:
                        sharding.materialize(spec.fn(*args))
            break
        except (NotImplementedError, RuntimeError) as e:
            missing = _RULE_MISSING.search(str(e))
            if missing is None or _op(missing.group(1)) in ops:
                raise
            ops.append(_op(missing.group(1)))
            handler.ops.clear()
    rec = counter.record()
    rec["replicated_for"] = dict(handler.ops)
    return rec


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
    total(L) = cost(1) + (L - 1) * (cost(2) - cost(1)), for the flops, the
    bytes and (where both traces carry them) the collectives' bytes and
    counts a kind, as JAX's ``_extrapolate`` carries them."""

    def ext(a, b):
        return a + (n_layers - 1) * max(b - a, 0.0)

    out = {k: ext(c1[k], c2[k]) for k in ("flops", "bytes_accessed") if k in c1 and k in c2}
    if "collectives" in c1 and "collectives" in c2:
        a, b = c1["collectives"], c2["collectives"]
        kinds = sorted(set(a["bytes_by_kind"]) | set(b["bytes_by_kind"]))
        coll = {k: int(ext(a["bytes_by_kind"].get(k, 0), b["bytes_by_kind"].get(k, 0)))
                for k in kinds}
        out["collectives"] = {
            "bytes_by_kind": coll, "total_bytes": sum(coll.values()),
            "counts": {k: int(ext(a["counts"].get(k, 0), b["counts"].get(k, 0)))
                       for k in kinds}}
    return out


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
        **_collectives_or_error(arch, shape, mesh),
    }


def _collectives_or_error(arch: str, shape: str, mesh) -> dict:
    """``cell_collectives``, or, where the sharded trace fails, ``collectives``
    None and the reason under ``collectives_error``: the first pass's
    flops, bytes, peak and ``fits`` stand either way."""
    try:
        return cell_collectives(arch, shape, mesh)
    except Exception as e:  # noqa: BLE001 - recorded beside the first pass's record
        return {"collectives": None, "collectives_error": f"{type(e).__name__}: {e}"[:2000],
                "collectives_trace": traceback.format_exc()[-2000:]}


def cell_collectives(arch: str, shape: str, mesh) -> dict:
    """``collectives`` of one cell on ``mesh`` (its sharded trace, separate
    from the counting trace), with ``replicated_for`` and the seconds it
    took.  A scanned LM counts from unrolled L=1 and L=2 sharded traces,
    extrapolated, and its ``cost_method`` says so."""
    from repro_torch.configs import registry

    t0 = time.perf_counter()
    entry = registry.get_arch(arch)
    if entry.family == "lm" and entry.config().scan_layers:
        c1, c2 = ({"collectives": sharded_collectives(
            lambda n=n: registry.build_cell(arch, shape, mesh, n_layers_override=n), mesh)}
            for n in (1, 2))
        coll = _extrapolate(c1, c2, entry.config().n_layers)["collectives"]
        coll["replicated_for"] = _merged(c1["collectives"]["replicated_for"],
                                         c2["collectives"]["replicated_for"])
        method = {"cost_method": "direct; collectives from unrolled L=1/L=2 sharded traces, "
                                 "extrapolated"}
    else:
        coll = sharded_collectives(lambda: registry.build_cell(arch, shape, mesh), mesh)
        method = {}
    replicated = coll.pop("replicated_for")
    return {"collectives": coll, "replicated_for": replicated, **method,
            "collectives_trace_s": round(time.perf_counter() - t0, 3)}


def _merged(a: dict, b: dict) -> dict:
    return {k: max(a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))}


def run_extra(spec, mesh, mesh_name: str) -> dict:
    """Run an extra cell (real args) once: its time, peak on a card, and
    the shuffle's ``is_new`` count against the distinct valid keys; its
    collectives are its rank program's on ``mesh``, traced on fake args of
    the same shapes.  A shuffle that loses keys (an overflow, or fewer new
    than distinct) is an error."""
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
        "overflow": bool(ovf),
        "collectives_method": ("the rank program of the process-mesh arm, sharded trace; "
                               "its probe loop's body once, as XLA counts a while loop"),
        **_extra_collectives(int(hi.numel()), mesh),
    }
    if res["overflow"] or res["n_new"] != n_distinct:
        # the cell's 2^22 slots a shard hold its keys on the production
        # meshes; on a mesh of few devices the table fills and keys are lost
        res["status"] = "error"
        res["error"] = (f"PTT insert lost keys: is_new {res['n_new']} of {n_distinct} "
                        f"distinct, overflow {res['overflow']}, {mesh.size} shard(s)")
    return res


def _extra_collectives(n_keys: int, mesh) -> dict:
    from repro_torch.configs import cells

    t0 = time.perf_counter()
    coll = sharded_collectives(lambda: cells.rdfizer_shuffle_cell(mesh, n_keys), mesh)
    return {"replicated_for": coll.pop("replicated_for"), "collectives": coll,
            "collectives_trace_s": round(time.perf_counter() - t0, 3)}


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
                f" overflow={res['overflow']} coll={res['collectives']['total_bytes']:.3e}B/dev")
    if res["status"] == "ok":
        gib = res["memory"]["peak_bytes"] / (1 << 30)
        coll = (f" coll={res['collectives']['total_bytes']:.3e}B/dev"
                f" sharded={res['collectives_trace_s']}s" if res["collectives"] is not None
                else f" coll=FAILED ({res['collectives_error'][:160]})")
        return (f" flops={res['flops_global']:.3e} peak={gib:.2f}GiB/dev"
                f" fits={res['fits']} trace={res['trace_s']}s{coll}")
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
    uncounted = [k for k, r in results.items() if r.get("collectives_error")]
    print(f"\ndry-run summary: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors")
    if uncounted:
        print(f"  {len(uncounted)} ok cells with no collective count: the sharded trace failed")
    for k, r in results.items():
        if r["status"] == "error":
            print(f"  ERROR {k}: {r['error'][:300]}")
        elif r.get("collectives_error"):
            print(f"  NO COLLECTIVES {k}: {r['collectives_error'][:300]}")
    return 1 if n["error"] or uncounted else 0


if __name__ == "__main__":
    raise SystemExit(main())
