"""The port's collective count against JAX's, cell by cell, on the CPU.

JAX compiles each cell in a subprocess on forced host devices
(``--xla_force_host_platform_device_count``) and reads the partitioned
HLO with ``repro.launch.dryrun.collective_bytes``; a scanned LM compiles
unrolled at L=1 and L=2 and is extrapolated, as both dry-runs do.  The
port traces the same cell over a fake process group of the mesh
(``repro_torch.launch.dryrun``), bf16 counted at 4 bytes as XLA's CPU
backend widens bf16 collectives to f32.  Prints each kind's bytes (counts)
a device, side by side, and the ratios of the totals and of the
all-gather bytes.

    PYTHONPATH=src python scripts/collectives_vs_jax.py [--mesh 4x2|2x4|1x8|single|multi] CELL...

CELL is one of:

* ``arch/shape``, a registry cell (``qwen2.5-3b/train_4k``);
* ``smoke/arch/prefill`` or ``smoke/arch/train``: an LM arch's smoke width
  (``smoke_config()``, one microbatch, layers unrolled) at batch 8 and
  sequence 64, as ``tests/test_torch_dryrun_collectives.py`` builds it;
* ``edge/arch``: a GNN at ``ogb_products``' widths with the edge split,
  2,048 nodes and 8,192 edges, ``--layers`` layers (default 2), as the
  tests build it.

``4x2``, ``2x4`` and ``1x8`` are ``("data", "model")`` meshes of 8 host
devices (``make_local_mesh(8, model=2|4|8)``; the two wider ``model``
axes split the smoke widths' heads unevenly); ``single`` and ``multi``
are the 16x16 and 2x16x16 accounting meshes (256 and 512 host devices:
JAX's compiles take seconds to minutes a cell).  ``--port-root`` traces
another checkout's ``src`` (a parent commit's, unpacked by ``git
archive``) against the same JAX compiles.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch
from torch.utils._pytree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICES = {"4x2": 8, "2x4": 8, "1x8": 8, "single": 256, "multi": 512}
LOCAL = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}  # (data, model)
SMOKE = dict(batch=8, seq=64)
EDGE = dict(n=2048, e=8192, d_feat=100, n_classes=47)

_JAX = r"""
import dataclasses, importlib, json, sys
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import cells as C, registry
from repro.launch.dryrun import collective_bytes
from repro.launch.mesh import make_local_mesh, make_production_mesh

which, layers, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
SMOKE, EDGE, todo = json.loads(sys.argv[4]), json.loads(sys.argv[5]), sys.argv[6:]
mesh = (make_local_mesh(8, model=int(which[-1])) if which[1] == "x"
        else make_production_mesh(multi_pod=which == "multi"))


def compiled(spec):
    with set_mesh(mesh):
        return collective_bytes(jax.jit(spec.fn, donate_argnums=spec.donate)
                                .lower(*spec.args).compile().as_text())


out = {}
for cell in todo:
    part = cell.split("/")
    if part[0] == "smoke":
        mod = importlib.import_module(registry.get_arch(part[1]).config.__module__)
        cfg = dataclasses.replace(mod.smoke_config(), microbatches=1, scan_layers=False)
        if part[2] == "prefill":
            spec = C.lm_prefill_cell(cfg, mesh, SMOKE["batch"], SMOKE["seq"], unroll_accum=True)
        else:
            spec = C.lm_train_cell(cfg, mesh, SMOKE["batch"], SMOKE["seq"])
        out[cell] = compiled(spec)
    elif part[0] == "edge":
        cfg = dataclasses.replace(registry.get_arch(part[1]).config(), d_in=EDGE["d_feat"],
                                  n_classes=EDGE["n_classes"], task="node_cls",
                                  channel_shard=True, dtype=jnp.bfloat16, n_layers=layers)
        out[cell] = compiled(C.gnn_train_cell(
            part[1], cfg, mesh, n=EDGE["n"], e=EDGE["e"], d_feat=EDGE["d_feat"],
            task="node_cls", n_classes=EDGE["n_classes"], shard_edges=True,
            shape_name="ogb_products"))
    else:
        lm = registry.get_arch(part[0]).family == "lm"
        for n in (1, 2) if lm else (None,):
            kw = {} if n is None else {"n_layers_override": n}
            out[f"{cell}/{n}"] = compiled(registry.build_cell(*part, mesh, **kw))
json.dump(out, open(out_path, "w"))
"""


def _xla_cpu_bytes(x) -> int:
    return sum(t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
               for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def _port(cell: str, mesh, layers: int) -> dict:
    """The port's record of ``cell`` on ``mesh`` (its sharded trace)."""
    import dataclasses
    import importlib

    from repro_torch.configs import cells, registry
    from repro_torch.launch import dryrun

    part = cell.split("/")
    if part[0] == "smoke":
        mod = importlib.import_module(registry.get_arch(part[1]).config.__module__)
        cfg = dataclasses.replace(mod.smoke_config(), microbatches=1, scan_layers=False)
        build = cells.lm_prefill_cell if part[2] == "prefill" else cells.lm_train_cell
        rec = dryrun.sharded_collectives(
            lambda: build(cfg, mesh, SMOKE["batch"], SMOKE["seq"]), mesh)
    elif part[0] == "edge":
        cfg = dataclasses.replace(registry.gnn_cell_config(part[1], "ogb_products"),
                                  n_layers=layers)
        rec = dryrun.sharded_collectives(lambda: cells.gnn_train_cell(
            part[1], cfg, mesh, n=EDGE["n"], e=EDGE["e"], d_feat=EDGE["d_feat"],
            task="node_cls", n_classes=EDGE["n_classes"], shard_edges=True,
            shape_name="ogb_products"), mesh)
    else:
        return dryrun.cell_collectives(*part, mesh)["collectives"]
    rec.pop("replicated_for")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(prog="python scripts/collectives_vs_jax.py")
    ap.add_argument("--mesh", default="4x2", choices=sorted(DEVICES))
    ap.add_argument("--layers", type=int, default=2, help="an edge/ cell's GNN layers")
    ap.add_argument("--port-root", default=ROOT, help="the checkout whose src the port runs")
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.port_root), "src"))
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES[args.mesh]}")
        subprocess.run([sys.executable, "-c", _JAX, args.mesh, str(args.layers), path,
                        json.dumps(SMOKE), json.dumps(EDGE), *args.cells], check=True, env=env)
        with open(path) as f:
            jax_counts = json.load(f)
    mesh = (Mesh(("data", "model"), LOCAL[args.mesh]) if args.mesh in LOCAL
            else make_production_mesh(multi_pod=args.mesh == "multi"))
    dryrun._tensor_bytes = _xla_cpu_bytes
    for cell in args.cells:
        if cell in jax_counts:
            want = jax_counts[cell]
        elif registry.get_arch(cell.split("/")[0]).family == "lm":
            want = dryrun._extrapolate(
                *({"collectives": jax_counts[f"{cell}/{n}"]} for n in (1, 2)),
                registry.get_arch(cell.split("/")[0]).config().n_layers)["collectives"]
        else:
            want = jax_counts[f"{cell}/None"]
        got = _port(cell, mesh, args.layers)
        ag = [r["bytes_by_kind"].get("all-gather", 0) for r in (got, want)]
        print(f"{cell} on {args.mesh}, a device (bf16 at XLA:CPU's 4 bytes): port / JAX "
              f"{got['total_bytes'] / max(want['total_bytes'], 1):.3f}, all-gather "
              f"{ag[0] / max(ag[1], 1):.3f}")
        for kind in sorted(set(want["bytes_by_kind"]) | set(got["bytes_by_kind"])):
            row = [(r["bytes_by_kind"].get(kind, 0), r["counts"].get(kind, 0)) for r in (want, got)]
            print(f"  {kind:18s} JAX {row[0][0]:>20,d} ({row[0][1]})  "
                  f"port {row[1][0]:>20,d} ({row[1][1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
