"""The port's dry-run and mesh work (``models/sharding.py``,
``launch/{mesh,dryrun}.py``, the specs, unrolled layers, the cell builders,
``registry.build_cell``, ``bench/{roofline,hillclimb}.py``) against the JAX
package on the CPU.

Specs are compared leaf for leaf with JAX's ``P`` read as a tuple.  Cells
are built by both packages on a 1x1 mesh at full width (JAX's
``ShapeDtypeStruct``s against the port's fake tensors; JAX's uint32 words
are the port's int32 bit patterns), and on the two production meshes, in a
subprocess with 512 host devices, each arg's per-device shape against
JAX's ``shard_shape`` (or JAX's error) for a subset that covers every
arch and every shape (``SHARD_CELLS``).  Unrolled layers are bit-equal to
stacked ones with the same weights.  A fake trace's flops, bytes and peak
equal a real CPU run's exactly, on the smoke configs of every family.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_local_mesh as jlocal_mesh
from repro.models import recsys as jrecsys
from repro.models import transformer as jtr
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.bench import hillclimb, roofline
from repro_torch.configs import cells, registry
from repro_torch.convert import state_from_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.models import layers, recsys, sharding, transformer
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ["qwen2.5-3b", "gemma-2b", "command-r-plus-104b", "dbrx-132b", "mixtral-8x7b"]
CELLS = [(a, s) for a, s, _ in jreg.list_cells()]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
          "bool": torch.bool, "uint32": torch.int32}  # uint32 words: int32 bit patterns
LOCAL = make_local_mesh(1)


def spec_tuple(s):
    return None if s is None else tuple(s)


def jax_spec_leaves(tree):
    out = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jax_path(p), tuple(s)) for p, s in out]


def jax_path(path) -> str:
    parts = []
    for k in path:
        parts.append(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))))
    return ".".join(parts)


def port_leaves(tree, prefix=""):
    """(path, leaf) in ``tree.leaves`` order, paths as JAX's key paths join."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        from repro_torch.train.tree import _key

        return [x for k in sorted(tree, key=_key) for x in port_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in port_leaves(v, f"{prefix}{f}.")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in port_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def port_spec_leaves(tree):
    return [(p, tuple(s)) for p, s in port_leaves(tree)]


# ------------------------------------------------------------------- specs


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_specs_equal_jax(arch, serve, scan):
    jc = dataclasses.replace(jreg.get_arch(arch).config(), scan_layers=scan)
    tc = dataclasses.replace(registry.get_arch(arch).config(), scan_layers=scan)
    want = jax_spec_leaves(jtr.param_specs(jc, serve=serve))
    got = port_spec_leaves(transformer.param_specs(tc, serve=serve))
    assert got == want


@pytest.mark.parametrize("dp", [("data",), ("pod", "data"), None])
def test_cache_specs_and_batch_axes_equal_jax(dp):
    cfg = registry.get_arch("qwen2.5-3b").config()
    jcfg = jreg.get_arch("qwen2.5-3b").config()
    assert port_spec_leaves(transformer.cache_specs(cfg, dp)) == jax_spec_leaves(
        jtr.cache_specs(jcfg, dp))
    for multi in (False, True):  # JAX's batch_axes reads only the axis names
        mesh = make_production_mesh(multi_pod=multi)
        assert transformer.batch_axes(mesh) == jtr.batch_axes(mesh)


def test_recsys_and_adamw_specs_equal_jax():
    cfg = registry.get_arch("wide-deep").config()
    jcfg = jreg.get_arch("wide-deep").config()
    jspecs, pspecs = jrecsys.param_specs(jcfg), recsys.param_specs(cfg)
    assert port_spec_leaves(pspecs) == jax_spec_leaves(jspecs)
    assert port_spec_leaves(AdamW().state_specs(pspecs)) == jax_spec_leaves(
        JAdamW().state_specs(jspecs))
    lm = dataclasses.replace(registry.get_arch("mixtral-8x7b").config(), scan_layers=False)
    jlm = dataclasses.replace(jreg.get_arch("mixtral-8x7b").config(), scan_layers=False)
    assert port_spec_leaves(AdamW().state_specs(transformer.param_specs(lm))) == \
        jax_spec_leaves(JAdamW().state_specs(jtr.param_specs(jlm)))


def test_partition_spec_reads_as_jax_reads_it():
    P = sharding.P
    js = jax.sharding.PartitionSpec(("data", "model"), None)
    assert P(("data", "model"), None) == tuple(js) and P(["data", "model"], None) == tuple(js)
    assert leaves({"a": P("x"), "b": [P(), P(None)]}) == [P("x"), P(), P(None)]
    assert sharding.active_axes() == () and sharding.constrain(js, P("x")) is js


def test_local_shape_rules():
    mesh = make_production_mesh()
    ls = sharding.local_shape
    assert ls((32, 64), sharding.P("data", "model"), mesh) == (2, 4)
    assert ls((512, 3), sharding.P(("data", "model")), mesh) == (2, 3)
    assert ls((7, 9), sharding.P(), mesh) == (7, 9)
    assert ls((), sharding.P(), mesh) == ()
    for shape, spec in (((10,), sharding.P("data")), ((4,), sharding.P(None, "data")),
                        ((16,), sharding.P("pod"))):
        with pytest.raises(ValueError):
            ls(shape, spec, mesh)


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    assert make_local_mesh(8, model=2).shape == {"data": 4, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_local_mesh()


# ------------------------------------------------------------------- cells


@pytest.fixture(scope="module")
def jax_cells():
    mesh = jlocal_mesh()
    out = {(a, s): jreg.build_cell(a, s, mesh) for a, s in CELLS}
    out["extra"] = jreg.build_extra_cells(mesh)
    return out


def _same_cell(j, t):
    assert (t.name, t.kind, t.donate, t.note) == (j.name, j.kind, tuple(j.donate), j.note)
    want = [(p, tuple(x.shape), DTYPES[str(x.dtype)])
            for p, x in ((jax_path(p), x) for p, x in
                         jax.tree_util.tree_flatten_with_path(j.args)[0])]
    got = [(p, tuple(x.shape), x.dtype) for p, x in port_leaves(t.args)]
    assert got == want
    # the specs tree parallels the args
    assert [p for p, _ in port_leaves(t.specs)] == [p for p, _ in port_leaves(t.args)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cells_equal_jax(jax_cells, arch, shape):
    j = jax_cells[(arch, shape)]
    t = registry.build_cell(arch, shape, LOCAL)
    if isinstance(j, str):
        assert t == j
        return
    _same_cell(j, t)
    assert all(isinstance(x, torch._subclasses.fake_tensor.FakeTensor) for x in leaves(t.args))


def test_extra_cells_equal_jax(jax_cells):
    (j,), (t,) = jax_cells["extra"], registry.build_extra_cells(LOCAL)
    _same_cell(j, t)


# every LM, Wide & Deep and GAT cell, and the other GNNs (whose JAX builds
# take most of the time) at one shape with ``channel_shard`` and one
# without: the graph arrays' specs follow the shape, which GAT covers whole
SHARD_CELLS = [(a, s) for a, s in CELLS if registry.get_arch(a).family != "gnn"
               or a == "gat-cora" or s in ("ogb_products", "molecule")]

_SHARD_SCRIPT = r"""
import json, sys
import jax
from repro.configs import registry
from repro.launch.mesh import make_production_mesh
out = {}
for name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    todo = [tuple(c) for c in json.loads(sys.argv[2])] + [("extra", "")]
    for a, s in todo:
        key = f"{a}/{s}@{name}"
        try:
            spec = (registry.build_extra_cells(mesh)[0] if a == "extra"
                    else registry.build_cell(a, s, mesh))
        except Exception as e:
            out[key] = "error: " + type(e).__name__
            continue
        if isinstance(spec, str):
            out[key] = "skip"
            continue
        shapes = []
        for x in jax.tree.leaves(spec.args):
            try:
                shapes.append(list(x.sharding.shard_shape(x.shape)))
            except Exception as e:
                shapes.append("error: " + type(e).__name__)
        out[key] = shapes
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_shard_shapes(tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "shapes.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _SHARD_SCRIPT, str(path),
                           json.dumps(SHARD_CELLS)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _port_shard_shapes(spec, mesh) -> list:
    out = []
    for (_, x), (_, s) in zip(port_leaves(spec.args), port_leaves(spec.specs)):
        try:
            out.append(list(sharding.local_shape(x.shape, s, mesh)))
        except ValueError:
            out.append("error")
    return out


@pytest.mark.parametrize("multi", [False, True])
def test_per_device_shapes_equal_jax_shard_shape(jax_shard_shapes, multi):
    name = "multi" if multi else "single"
    mesh = make_production_mesh(multi_pod=multi)
    checked = 0
    for a, s in SHARD_CELLS + [("extra", "")]:
        want = jax_shard_shapes[f"{a}/{s}@{name}"]
        spec = (registry.build_extra_cells(mesh)[0] if a == "extra"
                else registry.build_cell(a, s, mesh))
        if want == "skip":
            assert isinstance(spec, str)
            continue
        got = _port_shard_shapes(spec, mesh)
        if isinstance(want, str):  # JAX raised building the cell: the port's specs raise too
            assert "error" in got, (a, s, want)
            continue
        want = ["error" if isinstance(w, str) else w for w in want]
        assert got == want, (a, s)
        checked += 1
    assert checked == 31


# ----------------------------------------------------------- unrolled layers


def _unrolled_state(model, n):
    return _unrolled_state_of(model.state_dict(), n)


def _unrolled_state_of(state, n):
    sd = {}
    for k, v in state.items():
        if k.startswith("blocks."):
            for i in range(n):
                sd[f"blocks.{i}.{k[7:]}"] = v[i].clone()
        else:
            sd[k] = v
    return sd


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b", "mixtral-8x7b"])
def test_unrolled_layers_bit_equal_stacked(arch):
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), n_layers=3)
    ucfg = dataclasses.replace(cfg, scan_layers=False)
    stacked = transformer.Transformer(cfg, device="cpu")
    unrolled = transformer.Transformer(ucfg, device="cpu")
    unrolled.load_state_dict(_unrolled_state(stacked, cfg.n_layers))
    sp, up = stacked.params(), unrolled.params()
    assert isinstance(up["blocks"], list) and len(up["blocks"]) == 3
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))
    with torch.no_grad():
        assert torch.equal(transformer.forward(cfg, sp, tok), transformer.forward(ucfg, up, tok))
        assert torch.equal(transformer.prefill(cfg, sp, tok), transformer.prefill(ucfg, up, tok))
        c1, c2 = (transformer.make_cache(c, 2, 16, device="cpu") for c in (cfg, ucfg))
        for p in range(3):
            a, _ = transformer.decode_step(cfg, sp, c1, tok[:, p:p + 1], torch.tensor(p))
            b, _ = transformer.decode_step(ucfg, up, c2, tok[:, p:p + 1], torch.tensor(p))
            assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in zip(c1, c2))
    # gradients, element for element
    grads = []
    for c, model in ((cfg, stacked), (ucfg, unrolled)):
        named = dict(model.named_parameters())
        loss = transformer.loss_fn(c, layers.nest(named), tok, tok)
        grads.append(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    for k, g in _unrolled_state_of(grads[0], cfg.n_layers).items():
        assert torch.equal(grads[1][k], g), k
    # a train step: the global norm sums leaf by leaf, and the leaves differ
    # (one stacked leaf against one a layer), so it agrees to fp32 rounding
    mets = []
    for c, model in ((cfg, stacked), (ucfg, unrolled)):
        step, opt, params = cells.lm_train_step(c, model)
        mets.append(step(params, opt.init(params), tok, tok)[2])
    assert torch.equal(mets[0]["loss"], mets[1]["loss"])
    torch.testing.assert_close(mets[0]["grad_norm"], mets[1]["grad_norm"], rtol=1e-6, atol=0)
    got = unrolled.state_dict()
    for k, v in _unrolled_state(stacked, cfg.n_layers).items():
        torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7, msg=k)


def test_unrolled_jax_params_carry_across():
    arch = "qwen2.5-3b"
    jc = dataclasses.replace(jreg.get_arch(arch).smoke_config(), scan_layers=False)
    tc = dataclasses.replace(registry.get_arch(arch).smoke_config(), scan_layers=False)
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    model = transformer.Transformer(tc, device="cpu")
    model.load_state_dict(state_from_params(jp, device="cpu"))
    assert isinstance(model.params()["blocks"], list)
    toks = np.random.default_rng(1).integers(0, tc.vocab, (2, 8)).astype(np.int32)
    with torch.no_grad():
        got = transformer.forward(tc, model.params(), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(jtr.forward(jc, jp, toks)),
                               rtol=1e-5, atol=1e-5)


def test_nest_builds_lists_of_indexed_levels():
    flat = {"blocks.1.w": 1, "blocks.0.w": 0, "blocks.10.w": 10, "x": 5}
    flat.update({f"blocks.{i}.w": i for i in range(2, 10)})
    tree = layers.nest(flat)
    assert [b["w"] for b in tree["blocks"]] == list(range(11))
    assert leaves(flat) == leaves(tree) == list(range(11)) + [5]


# -------------------------------------------------------- traces and runs


def _smoke_cells():
    lm = registry.get_arch("qwen2.5-3b").smoke_config()
    moe = registry.get_arch("mixtral-8x7b").smoke_config()
    wd = registry.get_arch("wide-deep").smoke_config()
    out = [
        ("lm train", lambda f: cells.lm_train_cell(lm, LOCAL, 4, 16, fake=f)),
        ("lm prefill", lambda f: cells.lm_prefill_cell(lm, LOCAL, 2, 16, fake=f)),
        ("lm decode", lambda f: cells.lm_decode_cell(lm, LOCAL, 2, 32, fake=f)),
        ("moe train", lambda f: cells.lm_train_cell(moe, LOCAL, 2, 8, fake=f)),
        ("recsys train", lambda f: cells.recsys_train_cell(wd, LOCAL, 64, fake=f)),
        ("recsys serve", lambda f: cells.recsys_serve_cell(wd, LOCAL, 16, "serve_p99", fake=f)),
        ("recsys retrieval", lambda f: cells.recsys_retrieval_cell(wd, LOCAL, 100, fake=f)),
    ]
    tasks = {"node_cls": (5, 1), "graph_reg": (0, 4)}
    for arch, task in (("gat-cora", "node_cls"), ("meshgraphnet", "graph_reg"),
                       ("nequip", "node_cls"), ("equiformer-v2", "graph_reg")):
        n_classes, n_graphs = tasks[task]
        cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), d_in=12,
                                  n_classes=n_classes, task=task)
        out.append((f"{arch} {task}", lambda f, a=arch, c=cfg, t=task, k=n_classes, g=n_graphs:
                    cells.gnn_train_cell(a, c, LOCAL, n=24, e=96, d_feat=12, task=t,
                                         n_classes=k, n_graphs=g, shape_name="smoke",
                                         fake=f)))
    return out


@pytest.mark.parametrize("name,build", _smoke_cells(), ids=[n for n, _ in _smoke_cells()])
def test_trace_equals_a_real_run(name, build):
    """A fake trace and a real CPU run of the same cell count the same
    flops and bytes, and peak at the same live bytes; the trace that fills
    the models' constant caches counts no work for it."""
    from repro_torch.models import attention
    from repro_torch.models.gnn import equiformer

    attention._freq.cache_clear()
    equiformer._blocks.cache_clear()
    traced = dryrun.trace(build(True))
    real = dryrun.measure(build(False))
    assert traced["flops"] == real["flops"] > 0
    assert traced["bytes_accessed"] == real["bytes_accessed"] > 0
    assert traced["peak_bytes"] == real["peak_bytes"] > 0
    assert [o[:2] for o in traced["outputs"]] == [o[:2] for o in real["outputs"]]
    assert [o[2] for o in traced["outputs"]] == [o[2] for o in real["outputs"]]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolation_equals_direct_count_for_a_dense_lm(kind):
    base = dataclasses.replace(registry.get_arch("qwen2.5-3b").smoke_config(), n_layers=5)

    def build(cfg):
        if kind == "train":
            return cells.lm_train_cell(cfg, LOCAL, 2, 16)
        if kind == "prefill":
            return cells.lm_prefill_cell(cfg, LOCAL, 2, 16)
        return cells.lm_decode_cell(cfg, LOCAL, 2, 32)

    c1, c2 = (dryrun.trace(build(dataclasses.replace(base, n_layers=n, scan_layers=False)))
              for n in (1, 2))
    direct = dryrun.trace(build(base))
    assert dryrun._extrapolate(c1, c2, base.n_layers)["flops"] == direct["flops"] > 0


def test_rdfizer_cell_runs_exactly():
    mesh = Mesh(("data", "model"), (2, 1))  # 2 shards of 2^22 slots
    spec = cells.rdfizer_shuffle_cell(mesh, n_keys=1 << 14, fake=False)
    res = dryrun.run_extra(spec, mesh, "two")
    assert res["status"] == "ok"
    assert res["n_new"] == res["n_distinct"] > 0 and not res["overflow"]
    assert res["peak_bytes"] is None and res["collectives"] is None
    # lost keys, by an overflow or a short is_new count, make the run an error
    for lose in ({"overflow": True}, {"short": 1}):
        def fn(*a, lose=lose):
            thi, tlo, n_new, ovf = spec.fn(*a)
            return thi, tlo, n_new - lose.get("short", 0), ovf | lose.get("overflow", False)

        bad = dataclasses.replace(cells.rdfizer_shuffle_cell(mesh, n_keys=1 << 14, fake=False),
                                  fn=fn)
        res = dryrun.run_extra(bad, mesh, "two")
        assert res["status"] == "error" and "lost keys" in res["error"], res


def test_run_cell_accounts_per_device():
    hbm = 80 << 30
    local = dryrun.run_cell("wide-deep", "serve_p99", LOCAL, "local", hbm_bytes=hbm)
    pod = dryrun.run_cell("wide-deep", "serve_p99", make_production_mesh(), "single",
                          hbm_bytes=hbm)
    assert local["flops"] == local["flops_global"] == pod["flops_global"] == pod["flops"] * 256
    args = local["memory"]["argument_size_in_bytes"]
    spec = registry.build_cell("wide-deep", "serve_p99", LOCAL)
    assert args == sum(x.numel() * x.element_size() for x in leaves(spec.args))
    # the tables split 16 ways on the vocab axis, the MLP whole
    assert pod["memory"]["argument_size_in_bytes"] < args / 15
    assert local["fits"] and local["memory"]["peak_bytes"] >= args
    assert local["collectives"] is None and "more than one card" in local["collectives_reason"]
    assert dryrun.run_cell("qwen2.5-3b", "long_500k", LOCAL, "local", hbm_bytes=hbm) == {
        "status": "skipped", "reason": registry.get_arch("qwen2.5-3b").skips["long_500k"]}


def test_dryrun_cli_fits_and_hbm_bytes(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "dryrun.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--hbm-bytes",
         "85899345920", "--cell", "wide-deep/serve_p99", "--mesh", "local", "--out", out],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dry-run summary: 1 ok, 0 skipped, 0 errors" in proc.stdout
    with open(out) as f:
        rec = json.load(f)["wide-deep/serve_p99@local"]
    assert rec["fits"] and rec["hbm_bytes"] == 85899345920 and rec["cost_method"] == "direct"
    # cached unless --force; a small card does not hold the tables
    assert dryrun.main(["--device", "cpu", "--hbm-bytes", "1", "--cell",
                        "wide-deep/serve_p99", "--mesh", "local", "--out", out]) == 0
    with open(out) as f:
        assert json.load(f)["wide-deep/serve_p99@local"]["fits"]
    assert dryrun.main(["--device", "cpu", "--hbm-bytes", str(1 << 30), "--cell",
                        "wide-deep/serve_p99", "--mesh", "local", "--out", out, "--force"]) == 0
    with open(out) as f:
        rec = json.load(f)["wide-deep/serve_p99@local"]
    assert not rec["fits"] and rec["hbm_bytes"] == 1 << 30
    with pytest.raises(SystemExit):  # no default that pretends to be a card
        dryrun.main(["--device", "cpu", "--cell", "wide-deep/serve_p99", "--out", out])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            dryrun.main(["--cell", "wide-deep/serve_p99", "--out", out])
    # the roofline reads the record, at the H100's constants
    rows = roofline.derive(out)
    assert rows[0]["cell"] == "wide-deep/serve_p99@local" and rows[0]["t_collective_s"] is None
    assert rows[0]["t_compute_s"] == rec["flops"] / 989e12
    assert "wide-deep/serve_p99@local" in roofline.render(rows)
    # the runner's roofline section, over the same record
    from repro_torch.bench import run

    monkeypatch.setattr(roofline, "RESULTS", str(tmp_path))
    run.main(["--device", "cpu", "--only", "roofline"])
    assert "roofline/wide-deep/serve_p99@local," in capsys.readouterr().out


def test_roofline_model_flops_keep_jax_accounting():
    from benchmarks import roofline as jroof

    for arch in LM_ARCHS:
        for shape in roofline.LM_SHAPE_TOKENS:
            assert roofline.model_flops(arch, shape) == jroof.model_flops(arch, shape)
    assert roofline.model_flops("wide-deep", "serve_p99") is None


def test_hillclimb_variants(tmp_path, monkeypatch):
    """Variants 2 and 3 through ``hillclimb.main`` on the smoke configs, on
    a 4x4 accounting mesh whose axes divide the smoke widths."""
    mesh = Mesh(("data", "model"), (4, 4))
    cr_cfg = registry.get_arch("command-r-plus-104b").smoke_config()
    wd_cfg = registry.get_arch("wide-deep").smoke_config()
    batch = 32
    monkeypatch.setitem(hillclimb.RUNS, 2, (hillclimb.RUNS[2][0], lambda _: (
        hillclimb.hc2_commandr_decode(mesh, cr_cfg, batch=batch, ctx=64))))
    monkeypatch.setitem(hillclimb.RUNS, 3, (hillclimb.RUNS[3][0], lambda _: (
        hillclimb.hc3_widedeep(mesh, wd_cfg, batch=512, cap=320))))
    out = str(tmp_path / "hc.json")
    hillclimb.main(["--which", "2", "3", "--out", out])
    with open(out) as f:
        res = json.load(f)
    cr = res["commandr_decode_serve_tp"]
    assert cr["baseline_fsdp"]["flops"] == cr["serve_resident_tp"]["flops"] > 0
    # the layouts split the weights differently, into pieces of the same
    # bytes a device leaf for leaf; the serve layout replicates the
    # (batch, 1) int32 tokens where the baseline shards them over the 4 data
    # shards, and that is the whole difference in argument bytes
    specs = [cells.lm_decode_cell(cr_cfg, mesh, batch, 64, serve_layout=s) for s in (False, True)]
    shapes = [[sharding.local_shape(x.shape, p, mesh) for (_, x), (_, p) in
               zip(port_leaves(c.args[0]), port_leaves(c.specs[0]))] for c in specs]
    assert shapes[0] != shapes[1]
    weights = [[(x.dtype, math.prod(n)) for (_, x), n in zip(port_leaves(c.args[0]), sh)]
               for c, sh in zip(specs, shapes)]
    assert weights[0] == weights[1]
    arg_bytes = [cr[k]["memory"]["argument_size_in_bytes"]
                 for k in ("baseline_fsdp", "serve_resident_tp")]
    assert arg_bytes[1] - arg_bytes[0] == batch * 4 - batch // 4 * 4
    wd = res["widedeep_dedup_gather"]
    assert wd["baseline"]["bytes_accessed"] != wd["dedup_gather"]["bytes_accessed"]
    assert hillclimb.QUANT_NOTE
