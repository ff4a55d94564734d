"""The dry-run's collective count (``launch.dryrun``'s sharded trace)
against JAX's ``collective_bytes`` on ``("data", "model")`` meshes of 8:
(4, 2), and (2, 4) and (1, 8) where ``model`` is wider than the heads.

JAX runs in a subprocess with ``--xla_force_host_platform_device_count=8``
(as ``tests/test_torch_dryrun.py`` runs it with 512): it compiles each cell
on ``make_local_mesh(8, model=...)`` and reads the partitioned HLO with
``collective_bytes``; for each kind it also sums the elements of the
tuple-shaped collectives.  The port traces the same cells as rank 0's
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
both dry-runs do, kind for kind.  qwen2.5-3b ``train_4k`` and
``prefill_32k`` are printed side by side and held to JAX's in total
(``train_4k`` within 0.67-1.5, ``prefill_32k`` within 2x), ``train_4k``
in each large kind within 2x too.  qwen2.5-3b's and gemma-2b's smoke
widths, prefill and train, on (4, 2), (2, 4) and (1, 8) (the head views
with ``model`` factored as GSPMD factors it) are held within 0.9-1.1 of
JAX's total and 0.8-1.25 of its all-gather bytes; so is MeshGraphNet at
``ogb_products``' widths and edge split (two layers, 8,192 edges) on (4, 2)
and (2, 4), NequIP there in its all-gathers (its dead last-layer irreps
not counted, as XLA removes them), and NequIP and Equiformer within 2x of
the total.  The
prefill of qwen2.5-3b's smoke width at sequence 64 in batch waves
(batch / microbatches 8/1, 16/4 and 8/4: the 8/4 waves of 2 rows do not
split over the 4 ``data`` ranks) is held within 2x of JAX's in total, the
uneven waves no further from JAX's than the even ones.
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
# the edge-split GNN cells: ogb_products' widths, two layers (the last one's
# l > 0 irreps are dead code, which XLA drops, and so does the trace), 8,192
# edges, on (4, 2) and (2, 4)
EDGE = dict(n=2048, e=8192, d_feat=100, n_classes=47, layers=2)
EDGE_ARCHS, EDGE_MODELS = ["meshgraphnet", "nequip", "equiformer-v2"], [2, 4]
# the attention's head views with model factored: the smoke widths (4 heads;
# 2 kv heads for qwen, 1 for gemma) at batch 8 and sequence 64, prefill and
# train, on ("data", "model") meshes of 8 with model 2, 4 and 8
HEAD_ARCHS, HEAD_MODELS, HEAD_SIZE = ["qwen2.5-3b", "gemma-2b"], [2, 4, 8], (8, 64)
V, D = 64, 16
MOE = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
MOE_SPECS = [P(None, None), P(None, "data", "model"), P(None, "data", "model"),
             P(None, "model", "data"), P("data", None, None)]
ARMS = ["embed", "tied_logits"] + [f"moe_{dt}_{q}" for dt in ("float32", "bfloat16")
                                   for q in ("plain", "int8")]
# the smoke prefill in waves: (batch, microbatches) at sequence 64
WAVES, WAVE_SEQ = [(8, 1), (16, 4), (8, 4)], 64

_SCRIPT = f"""
CELLS, LM_CELLS, EXTRA_KEYS, V, D, MOE = {CELLS!r}, {LM_CELLS!r}, {EXTRA_KEYS!r}, {V!r}, {D!r}, {MOE!r}
EDGE, WAVES, WAVE_SEQ = {EDGE!r}, {WAVES!r}, {WAVE_SEQ!r}
EDGE_ARCHS, EDGE_MODELS = {EDGE_ARCHS!r}, {EDGE_MODELS!r}
HEAD_ARCHS, HEAD_MODELS, HEAD_SIZE = {HEAD_ARCHS!r}, {HEAD_MODELS!r}, {HEAD_SIZE!r}
""" + r"""
import dataclasses, importlib, json, re, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import cells, qwen2_5_3b, registry
from repro.launch.dryrun import _tensor_bytes, collective_bytes
from repro.launch.mesh import make_local_mesh
from repro.models import moe, vocab_parallel

mesh = make_local_mesh(8, model=2)
KIND = r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"


def record(fn, args, donate=(), on=mesh):
    with set_mesh(on):
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
for m in EDGE_MODELS:
    on = make_local_mesh(8, model=m)
    for arch in EDGE_ARCHS:
        cfg = dataclasses.replace(registry.get_arch(arch).config(), d_in=EDGE["d_feat"],
                                  n_classes=EDGE["n_classes"], task="node_cls", channel_shard=True,
                                  dtype=jnp.bfloat16, n_layers=EDGE["layers"])
        spec = cells.gnn_train_cell(arch, cfg, on, n=EDGE["n"], e=EDGE["e"], d_feat=EDGE["d_feat"],
                                    task="node_cls", n_classes=EDGE["n_classes"], shard_edges=True,
                                    shape_name="ogb_products")
        out[f"edge/{arch}/{8 // m}x{m}"] = record(spec.fn, spec.args, spec.donate, on=on)
for m in HEAD_MODELS:
    on = make_local_mesh(8, model=m)
    for arch in HEAD_ARCHS:
        mod = importlib.import_module(registry.get_arch(arch).config.__module__)
        cfg = dataclasses.replace(mod.smoke_config(), microbatches=1, scan_layers=False)
        spec = cells.lm_prefill_cell(cfg, on, *HEAD_SIZE, unroll_accum=True)
        out[f"heads/{arch}/prefill/{8 // m}x{m}"] = record(spec.fn, spec.args, on=on)
        spec = cells.lm_train_cell(cfg, on, *HEAD_SIZE)
        out[f"heads/{arch}/train/{8 // m}x{m}"] = record(spec.fn, spec.args, spec.donate, on=on)
for c in LM_CELLS:
    for n in (1, 2):
        spec = registry.build_cell(*c.split("/"), mesh, n_layers_override=n)
        out[f"{c}/{n}"] = record(spec.fn, spec.args, spec.donate)
# the layers unrolled, as the port runs them (a scanned compile holds the
# layer body once)
for b, mb in WAVES:
    cfg = dataclasses.replace(qwen2_5_3b.smoke_config(), microbatches=mb, scan_layers=False)
    spec = cells.lm_prefill_cell(cfg, mesh, b, WAVE_SEQ, unroll_accum=True)
    out[f"waves/{b}/{mb}"] = record(spec.fn, spec.args)

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


def _print_kinds(title: str, got: dict, want: dict) -> None:
    print(f"\n{title}")
    for kind in sorted(set(got["bytes_by_kind"]) | set(want["bytes_by_kind"])):
        print(f"  {kind:18s} JAX {want['bytes_by_kind'].get(kind, 0):>12,d} "
              f"({want['counts'].get(kind, 0)})  port {got['bytes_by_kind'].get(kind, 0):>12,d} "
              f"({got['counts'].get(kind, 0)})")


def _ratios(got: dict, want: dict) -> dict:
    """port / JAX: the total, the all-gather bytes and the reductions
    (all-reduce and reduce-scatter together)."""
    def red(r):
        return r["bytes_by_kind"].get("all-reduce", 0) + r["bytes_by_kind"].get("reduce-scatter", 0)

    return {"total": got["total_bytes"] / want["total_bytes"],
            "all-gather": (got["bytes_by_kind"].get("all-gather", 0)
                           / want["bytes_by_kind"]["all-gather"]),
            "reductions": red(got) / red(want)}


# port / JAX bands: the total, and the all-gather bytes (and a train cell's
# reductions) apart from it
TOTAL, KIND = (0.9, 1.1), (0.8, 1.25)


@pytest.mark.parametrize("model", EDGE_MODELS, ids=[f"{8 // m}x{m}" for m in EDGE_MODELS])
@pytest.mark.parametrize("arch", EDGE_ARCHS)
def test_edge_split_gnn_traces(jax_counts, arch, model, monkeypatch):
    """MeshGraphNet, NequIP and Equiformer at ``ogb_products``' widths and
    layout (the edges split over the data-parallel axes, the channels over
    ``model``), two layers, at 8,192 edges, on (4, 2) and (2, 4): the
    per-edge products (NequIP's ``bmm`` of the edge rows by a replicated
    factor, Equiformer's rotations, a constant times the edges' (E, 3, 3),
    the spherical harmonics and frames ``stack``ed) run on each rank's edge
    block, and the trace counts the collectives, printed beside JAX's (bf16
    at XLA:CPU's 4 bytes).  MeshGraphNet, whose dense layers carry the
    channel split as GSPMD carries it (the input gathered, the weight
    sliced along its output channels) and whose concatenated edge input
    moves by all-to-alls, is held within 0.9-1.1 of JAX's total and
    0.8-1.25 of its all-gather bytes.  NequIP's last layer's irreps of l >
    0, which the readout never reads, issue nothing (XLA's dead-code
    elimination, ``sharding._Liveness``): its all-gather bytes are held
    within 0.8-1.25 too.  NequIP and Equiformer are held within 2x of
    JAX's total: XLA partitions their backward and rematerialized
    node-level products otherwise than their forward (NequIP's
    recomputation reduces partial sums after the per-l linears where the
    forward gathers; Equiformer's recomputes without the channel gathers),
    which the trace does not."""
    import dataclasses

    from repro_torch.configs import cells, registry

    mesh = Mesh(("data", "model"), (8 // model, model))
    cfg = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"),
                              n_layers=EDGE["layers"])

    def build():
        return cells.gnn_train_cell(arch, cfg, mesh, n=EDGE["n"], e=EDGE["e"],
                                    d_feat=EDGE["d_feat"], task="node_cls",
                                    n_classes=EDGE["n_classes"], shard_edges=True,
                                    shape_name="ogb_products")

    monkeypatch.setattr(dryrun, "_tensor_bytes", _xla_cpu_bytes)
    rec = dryrun.sharded_collectives(build, mesh)
    assert set(rec.pop("replicated_for")) <= {"aten.scatter_reduce.two"}
    assert rec["total_bytes"] > 0 and rec["counts"].get("all-reduce", 0) > 0, rec
    want = jax_counts[f"edge/{arch}/{8 // model}x{model}"]
    _print_kinds(f"{arch} ogb_products, edge split, {EDGE['layers']} layers, "
                 f"({8 // model}, {model}), a device", rec, want)
    got = _ratios(rec, want)
    print("  port / JAX: " + ", ".join(f"{k} {v:.3f}" for k, v in got.items()))
    if arch == "meshgraphnet":
        assert TOTAL[0] <= got["total"] <= TOTAL[1], got
    else:
        assert 0.5 <= got["total"] <= 2, got
    if arch != "equiformer-v2":
        assert KIND[0] <= got["all-gather"] <= KIND[1], got


@pytest.mark.parametrize("model", HEAD_MODELS, ids=[f"{8 // m}x{m}" for m in HEAD_MODELS])
@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", HEAD_ARCHS)
def test_head_views_collectives(jax_counts, arch, kind, model, monkeypatch):
    """The attention's head views where the heads do not divide the
    ``model`` ranks, as GSPMD factors ``model`` over the viewed dims
    (``gcd(H, k)`` ways on the heads, the rest on the head dim): qwen2.5-3b
    and gemma-2b at their smoke widths (4 heads over 2 or 1 kv heads),
    batch 8 and sequence 64, prefill and train, on (4, 2), (2, 4) and
    (1, 8).  The trace's q, k and v views, the GQA regroup, RoPE's halves
    (collective-permutes, the concatenate's all-to-alls) and the output
    merge keep the factored splits; each cell is printed kind by kind
    beside JAX's and held within 0.9-1.1 of its total, 0.8-1.25 of its
    all-gather bytes, and a train cell's reductions within 0.8-1.25."""
    import dataclasses
    import importlib

    from repro_torch.configs import cells, registry

    mesh = Mesh(("data", "model"), (8 // model, model))
    mod = importlib.import_module(registry.get_arch(arch).config.__module__)
    cfg = dataclasses.replace(mod.smoke_config(), microbatches=1, scan_layers=False)
    build = cells.lm_prefill_cell if kind == "prefill" else cells.lm_train_cell
    monkeypatch.setattr(dryrun, "_tensor_bytes", _xla_cpu_bytes)
    rec = dryrun.sharded_collectives(lambda: build(cfg, mesh, *HEAD_SIZE), mesh)
    assert rec.pop("replicated_for") == {}
    want = jax_counts[f"heads/{arch}/{kind}/{8 // model}x{model}"]
    _print_kinds(f"{arch} smoke {kind}, batch {HEAD_SIZE[0]}, seq {HEAD_SIZE[1]}, "
                 f"({8 // model}, {model}), a device", rec, want)
    got = _ratios(rec, want)
    print("  port / JAX: " + ", ".join(f"{k} {v:.3f}" for k, v in got.items()))
    assert TOTAL[0] <= got["total"] <= TOTAL[1], got
    assert KIND[0] <= got["all-gather"] <= KIND[1], got
    if kind == "train":
        assert KIND[0] <= got["reductions"] <= KIND[1], got


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
        # reductions, kind for kind (the slot's position is written where
        # the row's slot mask holds, on the block that holds it: nothing is
        # read back)
        assert got["bytes_by_kind"] == want["bytes_by_kind"]
        assert got["counts"] == want["counts"]
        return
    total = got["total_bytes"] / want["total_bytes"]
    if "prefill" in cell:
        # the weight gathers, the sequence-parallel gathers and the row-parallel
        # reductions; XLA adds one collective-permute (64 KB) the port has not
        print(f"  port / JAX: total {total:.3f}")
        assert 0.5 <= total <= 2, total
        return
    # train: the total within 0.67-1.5 of JAX's, each of the three large kinds within 2x:
    # the weight gathers (forward, rematerialized forward and backward), the
    # reductions (all-reduce and reduce-scatter together: XLA's CPU compile
    # reduces a gradient by all-reduce where the port reduce-scatters it to
    # its parameter's layout) and the backward's all-to-alls (the FFN
    # cotangents resharded from the sequence split to the feature split, as
    # GSPMD reshards them; the attention's once, at its chunk loop's carry)
    by = {k: got["bytes_by_kind"].get(k, 0) / want["bytes_by_kind"][k]
          for k in ("all-gather", "all-to-all")}
    by["reductions"] = (
        (got["bytes_by_kind"]["all-reduce"] + got["bytes_by_kind"].get("reduce-scatter", 0))
        / (want["bytes_by_kind"]["all-reduce"] + want["bytes_by_kind"].get("reduce-scatter", 0)))
    print(f"  port / JAX: total {total:.3f}, " + ", ".join(f"{k} {v:.3f}" for k, v in by.items()))
    assert 0.67 <= total <= 1.5, total
    assert all(0.5 <= v <= 2 for v in by.values()), by


@pytest.fixture(scope="module")
def wave_ratios(jax_counts):
    """Each smoke wave cell's port / JAX ratios: the total and all-reduce."""
    import dataclasses

    from repro_torch.configs import cells, qwen2_5_3b

    out = {}
    for b, mb in WAVES:
        cfg = dataclasses.replace(qwen2_5_3b.smoke_config(), microbatches=mb)
        got = dryrun.sharded_collectives(
            lambda cfg=cfg, b=b: cells.lm_prefill_cell(cfg, MESH, b, WAVE_SEQ), MESH)
        assert got.pop("replicated_for") == {}
        want = jax_counts[f"waves/{b}/{mb}"]
        _print_kinds(f"qwen2.5-3b smoke prefill, batch {b} in {mb} waves, seq {WAVE_SEQ}, "
                     "(4, 2), a device", got, want)
        out[b, mb] = {k: got["bytes_by_kind"].get(k, 0) / want["bytes_by_kind"][k]
                      for k in ("all-reduce",)}
        out[b, mb]["total"] = got["total_bytes"] / want["total_bytes"]
        print(f"  port / JAX: total {out[b, mb]['total']:.3f}, "
              f"all-reduce {out[b, mb]['all-reduce']:.3f}")
    return out


@pytest.mark.parametrize("waves", WAVES, ids=[f"{b}/{mb}" for b, mb in WAVES])
def test_prefill_waves_collectives(wave_ratios, waves):
    """A wave of a data-split batch laid out as GSPMD lays it: each smoke
    cell within 2x of JAX's bytes in total, and the waves of 2 rows over 4
    ``data`` ranks (8/4; GSPMD splits their rows over 2 of the ranks and
    their sequence over the other 2) no further from JAX's, in total and
    in all-reduce bytes (the row-parallel reductions of each wave's
    block), than the even waves of 16/4 (beyond a tenth)."""
    got = wave_ratios[waves]
    assert 0.5 <= got["total"] <= 2, got
    if waves == (8, 4):
        even = wave_ratios[16, 4]
        assert got["total"] <= 1.1 * even["total"], (got, even)
        assert got["all-reduce"] <= 1.1 * even["all-reduce"], (got, even)


def _traced(fn):
    """``fn(mesh)``'s record and result on rank 0 of a fake (4, 2) group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_process_mesh
    from repro_torch.models import sharding

    with fake_process_mesh(MESH) as pm, sharding.sharded_trace(pm):
        with FakeTensorMode(), dryrun.Collectives() as counter:
            out = fn(pm)
    return counter.record(), out


def _last_position(pm):
    from repro_torch.models import sharding

    h = sharding.distribute(torch.empty(4, 64, 16), P("data", "model", None), pm)
    return h[:, -1:, :].to_local().shape


def _first_position(pm):
    from repro_torch.models import sharding

    h = sharding.distribute(torch.empty(4, 64, 16), P("data", "model", None), pm)
    return h[:, :1, :].to_local().shape


def _padded_rows(pm):
    from repro_torch.models import sharding

    x = sharding.distribute(torch.empty(2, 64, 16), P(None, None, None), pm)
    return sharding.constrain(x, P("data", "model", None)).to_local().shape


def _scatter_shard(pm):
    from repro_torch.models import sharding

    x = torch.empty(3, 16, requires_grad=True)
    y = sharding.all_gather(x, "data", mesh=pm)  # (12, 16)
    (g,) = torch.autograd.grad(y.sum(), x)
    return g.shape


@pytest.mark.parametrize("case, want_record, want_shape", [
    # the last position of a sequence split over model lives on model rank 1:
    # rank 0 receives it (XLA's collective-permute), 1 row x 1 x 16 floats
    (_last_position, {"collective-permute": (1, 64)}, (1, 1, 16)),
    # the first position is rank 0's own: nothing moves
    (_first_position, {}, (1, 1, 16)),
    # 2 rows over 4 data ranks: padded, rank 0 holds one (a slice, free)
    (_padded_rows, {}, (1, 32, 16)),
    # a reduce-scatter (the gather's transpose) counts its result, the shard
    (_scatter_shard, {"all-gather": (1, 768), "reduce-scatter": (1, 192)}, (3, 16)),
], ids=["last-position", "first-position", "padded-rows", "reduce-scatter-shard"])
def test_trace_moves_as_gspmd(case, want_record, want_shape):
    """The trace's pieces of GSPMD's layouts, on rank 0 of a (4, 2) mesh:
    one position of a split sequence moved to the axes' first rank by a
    collective-permute, a constraint whose axes outnumber a dim's rows
    padding it, and a reduce-scatter counted by its shard as JAX's
    ``collective_bytes`` reads XLA's text."""
    rec, shape = _traced(case)
    assert {k: (rec["counts"][k], rec["bytes_by_kind"][k]) for k in rec["counts"]} == want_record
    assert tuple(shape) == want_shape


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
