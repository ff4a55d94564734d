"""The dry-run's collective count (``launch.dryrun``'s sharded trace)
against JAX's ``collective_bytes`` on a (4, 2) ``("data", "model")`` mesh.

JAX runs in a subprocess with ``--xla_force_host_platform_device_count=8``
(as ``tests/test_torch_dryrun.py`` runs it with 512): it compiles each cell
at full width on ``make_local_mesh(8, model=2)`` and reads the partitioned
HLO with ``collective_bytes``; for each kind it also sums the elements of
the tuple-shaped collectives.  The port traces the same cells as rank 0's
program over a fake process group of 8 (``dryrun.cell_collectives``).

Two effects of XLA's CPU compile are named where they act:

* the combiner merges collectives of one kind into one tuple-shaped op
  (the psums of the embedding and the wide table; the gradient all-reduce
  of every parameter and the loss): bytes are equal, and the port's count
  equals the tuples' elements, where XLA's counts the tuples.  An XLA
  all-to-all is one tuple of per-peer chunks, not a merge: counts equal;
* the CPU backend widens bf16 collectives to f32 (its bf16 float
  normalization): bf16 cells are held with bf16 counted at 4 bytes
  (``_xla_cpu_bytes``), and the port's own count is half of that for them.

Held exactly: Wide & Deep ``serve_p99`` and ``train_batch``, GAT on Cora
(none), the rdfizer shuffle at 2^14 keys, and the arms alone at a small
width (``vocab_parallel`` embed and tied logits, ``moe._forward_sharded``
in fp32 and bf16, each with the plain and the int8 gather); the decode
cells of qwen2.5-3b and mixtral-8x7b, extrapolated from L=1 and L=2 as
both dry-runs do, kind for kind but for one all-reduce a layer (the port
reads a slot's old position back before its write).  qwen2.5-3b
``train_4k`` and ``prefill_32k`` are printed side by side and held within
2x of JAX's in total, ``train_4k`` in each large kind too.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.cells import CellSpec, _Draw
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe, vocab_parallel
from repro_torch.models.sharding import P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = Mesh(("data", "model"), (4, 2))
CELLS = ["wide-deep/serve_p99", "wide-deep/train_batch", "gat-cora/full_graph_sm"]
LM_CELLS = ["qwen2.5-3b/decode_32k", "mixtral-8x7b/decode_32k", "qwen2.5-3b/train_4k",
            "qwen2.5-3b/prefill_32k"]
EXTRA_KEYS = 1 << 14
DECODE_BATCH = 128  # the decode_32k cells' batch
V, D = 64, 16
MOE = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
MOE_SPECS = [P(None, None), P(None, "data", "model"), P(None, "data", "model"),
             P(None, "model", "data"), P("data", None, None)]
ARMS = ["embed", "tied_logits"] + [f"moe_{dt}_{q}" for dt in ("float32", "bfloat16")
                                   for q in ("plain", "int8")]

_SCRIPT = f"""
CELLS, LM_CELLS, EXTRA_KEYS, V, D, MOE = {CELLS!r}, {LM_CELLS!r}, {EXTRA_KEYS!r}, {V!r}, {D!r}, {MOE!r}
""" + r"""
import json, re, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import cells, registry
from repro.launch.dryrun import _tensor_bytes, collective_bytes
from repro.launch.mesh import make_local_mesh
from repro.models import moe, vocab_parallel

mesh = make_local_mesh(8, model=2)
KIND = r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"


def record(fn, args, donate=()):
    with set_mesh(mesh):
        txt = jax.jit(fn, donate_argnums=donate).lower(*args).compile().as_text()
    rec = collective_bytes(txt)
    elements = {}
    for line in txt.splitlines():
        m = re.search(r"=\s*(\(?.*?)\s" + KIND + r"(?:-start)?[.\d]*\(", line.strip())
        if not m or re.search(KIND + "-done", line):
            continue
        n = len(re.findall(r"[a-z0-9]+\[[0-9,]*\]", m.group(1)))
        elements[m.group(2)] = elements.get(m.group(2), 0) + n
    rec["elements"] = elements
    return rec


def sds(shape, dtype, spec):
    return jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(mesh, spec))


out = {}
for c in CELLS:
    spec = registry.build_cell(*c.split("/"), mesh)
    out[c] = record(spec.fn, spec.args, spec.donate)
spec = cells.rdfizer_shuffle_cell(mesh, EXTRA_KEYS)
out["rdfizer/shuffle_dedup"] = record(spec.fn, spec.args, spec.donate)
for c in LM_CELLS:
    for n in (1, 2):
        spec = registry.build_cell(*c.split("/"), mesh, n_layers_override=n)
        out[f"{c}/{n}"] = record(spec.fn, spec.args, spec.donate)

f32 = jnp.float32
out["embed"] = record(vocab_parallel.embed, [sds((V, D), f32, P("model", "data")),
                                             sds((4, 6), jnp.int32, P("data", None))])
out["tied_logits"] = record(vocab_parallel.tied_logits, [
    sds((V, D), f32, P("model", "data")), sds((4, 6, D), f32, P("data", None, None))])
E, d, ff = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
specs = [P(None, None), P(None, "data", "model"), P(None, "data", "model"),
         P(None, "model", "data"), P("data", None, None)]
for dt in ("float32", "bfloat16"):
    for q in ("plain", "int8"):
        cfg = moe.MoEConfig(**MOE, quantized_gather=q == "int8")
        w = jnp.dtype(dt)
        shapes = [((d, E), f32), ((E, d, ff), w), ((E, d, ff), w), ((E, ff, d), w),
                  ((4, 6, d), w)]

        def fn(r, u, g, dn, x, cfg=cfg):
            return moe.forward({"router": {"w": r}, "up": u, "gate": g, "down": dn}, cfg, x)

        out[f"moe_{dt}_{q}"] = record(fn, [sds(s, t, p) for (s, t), p in zip(shapes, specs)])
json.dump(out, open(sys.argv[1], "w"))
"""


def _xla_cpu_bytes(x) -> int:
    """``dryrun._tensor_bytes`` at XLA:CPU's widths: bf16 collectives at 4
    bytes (the CPU backend widens them to f32)."""
    return sum(t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
               for t in tree_leaves(x) if isinstance(t, torch.Tensor))


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll") / "jax.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _extrapolated(jax_counts, cell: str) -> dict:
    """JAX's whole-depth count from its L=1 and L=2 compiles."""
    from repro_torch.configs import registry

    n = registry.get_arch(cell.split("/")[0]).config().n_layers
    c1, c2 = ({"collectives": jax_counts[f"{cell}/{k}"]} for k in (1, 2))
    return dryrun._extrapolate(c1, c2, n)["collectives"]


def _merged_equal(port: dict, jax: dict) -> None:
    """Bytes a kind equal; the port's counts equal XLA's tuple elements
    (a combiner merge), and for all-to-all XLA's ops."""
    assert port["bytes_by_kind"] == jax["bytes_by_kind"]
    assert port["total_bytes"] == jax["total_bytes"]
    for kind, n in port["counts"].items():
        want = jax["counts"][kind] if kind == "all-to-all" else jax["elements"][kind]
        assert n == want, (kind, port["counts"], jax["counts"], jax["elements"])
    assert set(port["counts"]) == set(jax["counts"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_collectives_equal_jax(jax_counts, cell):
    rec = dryrun.cell_collectives(*cell.split("/"), MESH)
    _merged_equal(rec["collectives"], jax_counts[cell])
    if cell == "gat-cora/full_graph_sm":  # every arg whole: nothing moves
        assert rec["collectives"]["total_bytes"] == 0
        # DTensor has no rule for the segment max: it runs on replicated inputs
        assert set(rec["replicated_for"]) == {"aten.scatter_reduce.two"}
    else:
        assert rec["replicated_for"] == {}


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_edge_split_gnn_traces(arch):
    """NequIP and Equiformer at ``ogb_products``' widths and layout (the
    edges split over the data-parallel axes), one layer, at 8,192 edges:
    the per-edge products (NequIP's ``bmm`` of the edge rows by a
    replicated factor, Equiformer's rotations, a constant times the
    edges' (E, 3, 3)) run on each rank's edge block, and the trace counts
    the collectives."""
    import dataclasses

    from repro_torch.configs import cells, registry

    cfg = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"), n_layers=1)

    def build():
        return cells.gnn_train_cell(arch, cfg, MESH, n=2048, e=8192, d_feat=100,
                                    task="node_cls", n_classes=47, shard_edges=True,
                                    shape_name="ogb_products")

    rec = dryrun.sharded_collectives(build, MESH)
    assert set(rec.pop("replicated_for")) <= {"aten.scatter_reduce.two"}
    assert rec["total_bytes"] > 0 and rec["counts"].get("all-reduce", 0) > 0, rec


def test_shuffle_collectives_equal_jax(jax_counts):
    """The rank program of the process-mesh arm: three all-to-alls (keys hi,
    lo, the flags back) and two scalar all-reduces (the overflow pmax, the
    is_new count), its probe loop's body once."""
    rec = dryrun._extra_collectives(EXTRA_KEYS, MESH)
    _merged_equal(rec["collectives"], jax_counts["rdfizer/shuffle_dedup"])
    assert rec["collectives"]["counts"] == {"all-to-all": 3, "all-reduce": 2}


def _arm(name: str):
    """A callable that makes the arm ``name`` as a cell of fake args at JAX's specs."""
    f32 = torch.float32
    if name == "embed":
        fn, shapes, specs = vocab_parallel.embed, [((V, D), f32), ((4, 6), torch.int32)], [
            P("model", "data"), P("data", None)]
    elif name == "tied_logits":
        fn, shapes, specs = vocab_parallel.tied_logits, [((V, D), f32), ((4, 6, D), f32)], [
            P("model", "data"), P("data", None, None)]
    else:
        _, dt, q = name.split("_")
        cfg = moe.MoEConfig(**MOE, quantized_gather=q == "int8")
        w = getattr(torch, dt)
        E, d, ff = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
        shapes = [((d, E), f32), ((E, d, ff), w), ((E, d, ff), w), ((E, ff, d), w),
                  ((4, 6, d), w)]
        specs = MOE_SPECS

        def fn(r, u, g, dn, x):
            return moe.forward({"router": {"w": r}, "up": u, "gate": g, "down": dn}, cfg, x)

    def build():
        with _Draw("cpu", True, 0):
            args = tuple(torch.zeros(s, dtype=t) for s, t in shapes)
        return CellSpec(name=name, kind="arm", fn=fn, args=args, specs=tuple(specs))

    return build


@pytest.mark.parametrize("arm", ARMS)
def test_arm_collectives_equal_jax(jax_counts, arm, monkeypatch):
    own = dryrun.sharded_collectives(_arm(arm), MESH)
    if "bfloat16" in arm:
        monkeypatch.setattr(dryrun, "_tensor_bytes", _xla_cpu_bytes)
    rec = dryrun.sharded_collectives(_arm(arm), MESH)
    assert rec.pop("replicated_for") == {}
    _merged_equal(rec, jax_counts[arm])
    if arm.startswith("moe"):
        # three expert-weight gathers over data, the psum over model, the aux pmean
        assert rec["counts"] == {"all-gather": 3, "all-reduce": 2}
    if arm == "moe_bfloat16_plain":  # the card moves bf16: half of XLA:CPU's widened bytes
        assert 2 * own["bytes_by_kind"]["all-gather"] == rec["bytes_by_kind"]["all-gather"]


def test_int8_gather_moves_a_quarter_of_fp32(jax_counts):
    plain, q = (dryrun.sharded_collectives(_arm(f"moe_float32_{k}"), MESH)
                for k in ("plain", "int8"))
    assert 4 * q["bytes_by_kind"]["all-gather"] == plain["bytes_by_kind"]["all-gather"]


@pytest.mark.parametrize("cell", LM_CELLS)
def test_lm_collectives_side_by_side(jax_counts, cell, monkeypatch):
    monkeypatch.setattr(dryrun, "_tensor_bytes", _xla_cpu_bytes)
    port = dryrun.cell_collectives(*cell.split("/"), MESH)
    got, want = port["collectives"], _extrapolated(jax_counts, cell)
    assert port["replicated_for"] == {}
    assert "L=1/L=2" in port["cost_method"]
    print(f"\n{cell} on (4, 2), per device, extrapolated (bf16 at XLA:CPU's 4 bytes)")
    for kind in sorted(set(got["bytes_by_kind"]) | set(want["bytes_by_kind"])):
        print(f"  {kind:15s} JAX {want['bytes_by_kind'].get(kind, 0):>16,d} "
              f"({want['counts'].get(kind, 0)})  port {got['bytes_by_kind'].get(kind, 0):>16,d} "
              f"({got['counts'].get(kind, 0)})")
    print(f"  {'total':15s} JAX {want['total_bytes']:>16,d}  port {got['total_bytes']:>16,d}")
    if "decode" in cell:
        # FSDP weight gathers, the cache-write and query gathers, the
        # flash-decoding max/sum/output reductions and the row-parallel
        # reductions, kind for kind; and one all-reduce a layer more: the
        # port reads each slot's old position back before writing it (JAX's
        # scatter drops a write out of range, torch has no such write), and
        # GSPMD's gather over the length-split cache sums the blocks' takes
        # of the batch's int32 positions
        from repro_torch.configs import registry

        n_layers = registry.get_arch(cell.split("/")[0]).config().n_layers
        read_back = DECODE_BATCH // MESH.shape["data"] * 4
        assert got["bytes_by_kind"] == {
            **want["bytes_by_kind"],
            "all-reduce": want["bytes_by_kind"]["all-reduce"] + n_layers * read_back}
        assert got["counts"] == {**want["counts"],
                                 "all-reduce": want["counts"]["all-reduce"] + n_layers}
        return
    total = got["total_bytes"] / want["total_bytes"]
    if "prefill" in cell:
        # the weight gathers, the sequence-parallel gathers and the row-parallel
        # reductions; XLA adds one collective-permute (64 KB) the port has not
        print(f"  port / JAX: total {total:.3f}")
        assert 0.5 <= total <= 2, total
        return
    # train: the total within 2x of JAX's, and each of the three large kinds:
    # the weight gathers (forward, rematerialized forward and backward), the
    # reductions (all-reduce and reduce-scatter together: XLA's CPU compile
    # reduces a gradient by all-reduce where the port reduce-scatters it to
    # its parameter's layout) and the backward's all-to-alls (the FFN and
    # attention cotangents resharded between sequence and feature splits)
    by = {k: got["bytes_by_kind"].get(k, 0) / want["bytes_by_kind"][k]
          for k in ("all-gather", "all-to-all")}
    by["reductions"] = (
        (got["bytes_by_kind"]["all-reduce"] + got["bytes_by_kind"].get("reduce-scatter", 0))
        / (want["bytes_by_kind"]["all-reduce"] + want["bytes_by_kind"].get("reduce-scatter", 0)))
    print(f"  port / JAX: total {total:.3f}, " + ", ".join(f"{k} {v:.3f}" for k, v in by.items()))
    assert 0.5 <= total <= 2, total
    assert all(0.5 <= v <= 2 for v in by.values()), by


# --------------------------------------------- traces equal live runs (gloo)

LIVE_MESH = (2, 2)
WD = dict(n_sparse=4, embed_dim=8, vocab_per_field=64, n_dense=3, mlp=(32, 16), bag_size=2)
SHUFFLE_KEYS = 1 << 12


def _live_inputs():
    """Each arm's fn, its args drawn from a seed at global shapes, and
    their specs, for a (2, 2) mesh."""
    from repro_torch.core import distributed, hashing
    from repro_torch.models import layers, recsys, sharding

    gen = torch.Generator().manual_seed(0)
    axes = ("data", "model")

    def ints(shape, high):
        return torch.randint(0, high, shape, generator=gen, dtype=torch.int32)

    def floats(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype)

    def shuffle(thi, tlo, hi, lo, v):
        blocks = [sharding.enter(x, P(axes)) for x in (thi, tlo, hi, lo, v)]
        return distributed.distributed_insert(
            sharding.current_mesh(), distributed.ShardedPTT(*blocks[:2]), *blocks[2:])[1]

    khi, klo = hashing.mix64([ints((SHUFFLE_KEYS,), SHUFFLE_KEYS // 4)])
    table = torch.full((4, 1 << 22), hashing.EMPTY, dtype=torch.int32)
    arms = {
        "shuffle": (shuffle, [table, table.clone(), khi, klo,
                              torch.ones(SHUFFLE_KEYS, dtype=torch.bool)], (P(axes),) * 5),
        "embed": (vocab_parallel.embed, [floats((V, D)), ints((4, 6), V)],
                  (P("model", "data"), P("data", None))),
        "tied_logits": (vocab_parallel.tied_logits, [floats((V, D)), floats((4, 6, D))],
                        (P("model", "data"), P("data", None, None))),
    }
    E, d, ff = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
    for q in ("plain", "int8"):
        cfg = moe.MoEConfig(**MOE, quantized_gather=q == "int8")

        def layer(r, u, g, dn, x, cfg=cfg):
            return moe.forward({"router": {"w": r}, "up": u, "gate": g, "down": dn}, cfg, x)

        arms[f"moe_{q}"] = (layer, [floats((d, E)), floats((E, d, ff)), floats((E, d, ff)),
                                    floats((E, ff, d)), floats((4, 6, d))], MOE_SPECS)
    for cap in (None, 12):
        cfg = recsys.WideDeepConfig(**WD, dedup_cap=cap)
        model = recsys.WideDeep(cfg, device="cpu", seed=1)

        def forward(params, sp, de, model=model):
            with torch.no_grad():
                return torch.func.functional_call(model, params, (sp, de))

        params = {k: v.detach() for k, v in model.named_parameters()}
        pspecs = layers.flatten(recsys.param_specs(cfg))
        arms[f"wide_deep_{cap}"] = (forward, [params, ints((8, 4, 2), 64), floats((8, 3))],
                                    (pspecs, P("data", None, None), P("data", None)))
    return arms


def _live_rank(mesh):
    """One of 4 gloo ranks: every arm on this rank's blocks under the
    counter; rank 0 returns the records."""
    from repro_torch.models import sharding
    from repro_torch.train.tree import leaves, unflatten

    out = {}
    with sharding.set_mesh(mesh):
        for name, (fn, args, specs) in _live_inputs().items():
            blocks = unflatten(args, [sharding.local_block(a, s, mesh) for a, s in
                                      zip(leaves(args), leaves(specs), strict=True)])
            with dryrun.Collectives() as counter:
                fn(*blocks)
            out[name] = counter.record()
    return out


@pytest.fixture(scope="module")
def live_counts():
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(_live_rank, LIVE_MESH, device="cpu", timeout=300)


def test_traces_equal_live_runs_arm_by_arm(live_counts):
    """Each rank's live collectives (gloo, the arms on its blocks) equal the
    sharded trace's of the same program on a (2, 2) accounting mesh."""
    from repro_torch.train.tree import leaves, unflatten

    acct = Mesh(("data", "model"), LIVE_MESH)
    for name, (fn, args, specs) in _live_inputs().items():
        def build(fn=fn, args=args, specs=specs):
            with _Draw("cpu", True, 0, dynamic=True):
                fakes = unflatten(args, [torch.empty(a.shape, dtype=a.dtype)
                                         for a in leaves(args)])
            return CellSpec(name=name, kind="arm", fn=fn, args=tuple(fakes), specs=specs)

        want = dryrun.sharded_collectives(build, acct)
        assert want.pop("replicated_for") == {}
        assert want["total_bytes"] > 0, name
        for rank, got in enumerate(live_counts):
            assert got[name] == want, (name, rank, got[name], want)
