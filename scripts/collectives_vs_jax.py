"""The port's collective count against JAX's, cell by cell, on the CPU.

JAX compiles each cell in a subprocess on forced host devices
(``--xla_force_host_platform_device_count``) and reads the partitioned
HLO with ``repro.launch.dryrun.collective_bytes``; a scanned LM compiles
unrolled at L=1 and L=2 and is extrapolated, as both dry-runs do.  The
port traces the same cell over a fake process group of the mesh
(``repro_torch.launch.dryrun.cell_collectives``), bf16 counted at 4 bytes
as XLA's CPU backend widens bf16 collectives to f32.  Prints each kind's
bytes (counts) a device, side by side, and the ratio of the totals.

    PYTHONPATH=src python scripts/collectives_vs_jax.py [--mesh 4x2|single|multi] CELL...

CELL is ``arch/shape`` (``qwen2.5-3b/train_4k``).  ``4x2`` is the tests'
``("data", "model")`` mesh of 8; ``single`` and ``multi`` are the 16x16 and
2x16x16 accounting meshes (256 and 512 host devices: JAX's compiles take
seconds to minutes a cell).
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
DEVICES = {"4x2": 8, "single": 256, "multi": 512}

_JAX = r"""
import json, sys
import jax
from repro.compat import set_mesh
from repro.configs import registry
from repro.launch.dryrun import collective_bytes
from repro.launch.mesh import make_local_mesh, make_production_mesh

which, out_path, cells = sys.argv[1], sys.argv[2], sys.argv[3:]
mesh = (make_local_mesh(8, model=2) if which == "4x2"
        else make_production_mesh(multi_pod=which == "multi"))
out = {}
for cell in cells:
    arch, shape = cell.split("/")
    entry = registry.get_arch(arch)
    depths = (1, 2) if entry.family == "lm" else (None,)
    for n in depths:
        kw = {} if n is None else {"n_layers_override": n}
        spec = registry.build_cell(arch, shape, mesh, **kw)
        with set_mesh(mesh):
            txt = jax.jit(spec.fn, donate_argnums=spec.donate).lower(*spec.args).compile().as_text()
        out[f"{cell}/{n}"] = collective_bytes(txt)
json.dump(out, open(out_path, "w"))
"""


def _xla_cpu_bytes(x) -> int:
    return sum(t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
               for t in tree_leaves(x) if isinstance(t, torch.Tensor))


def main() -> int:
    ap = argparse.ArgumentParser(prog="python scripts/collectives_vs_jax.py")
    ap.add_argument("--mesh", default="4x2", choices=sorted(DEVICES))
    ap.add_argument("cells", nargs="+")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "jax.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES[args.mesh]}")
        subprocess.run([sys.executable, "-c", _JAX, args.mesh, path, *args.cells],
                       check=True, env=env)
        with open(path) as f:
            jax_counts = json.load(f)
    mesh = (Mesh(("data", "model"), (4, 2)) if args.mesh == "4x2"
            else make_production_mesh(multi_pod=args.mesh == "multi"))
    dryrun._tensor_bytes = _xla_cpu_bytes
    for cell in args.cells:
        arch, shape = cell.split("/")
        entry = registry.get_arch(arch)
        if entry.family == "lm":
            want = dryrun._extrapolate(*({"collectives": jax_counts[f"{cell}/{n}"]}
                                         for n in (1, 2)), entry.config().n_layers)["collectives"]
        else:
            want = jax_counts[f"{cell}/None"]
        got = dryrun.cell_collectives(arch, shape, mesh)["collectives"]
        print(f"{cell} on {args.mesh}, a device (bf16 at XLA:CPU's 4 bytes): port / JAX "
              f"{got['total_bytes'] / max(want['total_bytes'], 1):.3f}")
        for kind in sorted(set(want["bytes_by_kind"]) | set(got["bytes_by_kind"])):
            row = [(r["bytes_by_kind"].get(kind, 0), r["counts"].get(kind, 0)) for r in (want, got)]
            print(f"  {kind:18s} JAX {row[0][0]:>20,d} ({row[0][1]})  "
                  f"port {row[1][0]:>20,d} ({row[1][1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
