"""The port's collective records, a device, on this host's torch, as JSON:
for holding one torch version's sharded traces to another's (the card
host's against the CPU's) without JAX.

    PYTHONPATH=src python scripts/collectives_records.py OUT.json [CELL...]

Records qwen2.5-3b's and gemma-2b's smoke widths (batch 8, sequence 64,
prefill and train) on the ``("data", "model")`` meshes (4, 2), (2, 4) and
(1, 8), MeshGraphNet, NequIP and Equiformer with the edge split (2,048
nodes, 8,192 edges, two layers) on (4, 2) and (2, 4), and each registry
CELL (``arch/shape``) on the 16x16 mesh; bf16 counted at 4 bytes, as
``scripts/collectives_vs_jax.py`` counts it.  Prints each record's total
and its trace's seconds.
"""

import dataclasses
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = dict(n=2048, e=8192, d_feat=100, n_classes=47, layers=2)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import cells, registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, make_production_mesh

    print("torch", torch.__version__, flush=True)
    dryrun._tensor_bytes = lambda x: sum(
        t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
        for t in tree_leaves(x) if isinstance(t, torch.Tensor))
    out = {}

    def record(name, build, mesh):
        t0 = time.perf_counter()
        out[name] = dryrun.sharded_collectives(build, mesh)
        print(name, out[name]["total_bytes"], f"{time.perf_counter() - t0:.1f} s", flush=True)

    for data, model in ((4, 2), (2, 4), (1, 8)):
        mesh = Mesh(("data", "model"), (data, model))
        for arch in ("qwen2.5-3b", "gemma-2b"):
            mod = importlib.import_module(registry.get_arch(arch).config.__module__)
            cfg = dataclasses.replace(mod.smoke_config(), microbatches=1, scan_layers=False)
            for kind, build in (("prefill", cells.lm_prefill_cell),
                                ("train", cells.lm_train_cell)):
                record(f"{data}x{model}/{arch}/{kind}",
                       lambda build=build, cfg=cfg, mesh=mesh: build(cfg, mesh, 8, 64), mesh)
        if model == 8:
            continue
        for arch in ("meshgraphnet", "nequip", "equiformer-v2"):
            cfg = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"),
                                      n_layers=EDGE["layers"])
            record(f"{data}x{model}/edge/{arch}", lambda arch=arch, cfg=cfg, mesh=mesh:
                   cells.gnn_train_cell(arch, cfg, mesh, n=EDGE["n"], e=EDGE["e"],
                                        d_feat=EDGE["d_feat"], task="node_cls",
                                        n_classes=EDGE["n_classes"], shard_edges=True,
                                        shape_name="ogb_products"), mesh)
    pod = make_production_mesh()
    for cell in sys.argv[2:]:
        t0 = time.perf_counter()
        rec = dryrun.cell_collectives(*cell.split("/"), pod)
        out[f"16x16/{cell}"] = rec["collectives"]
        print(f"16x16/{cell}", rec["collectives"]["total_bytes"], rec["replicated_for"],
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
