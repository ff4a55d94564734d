"""The port's mesh of ranks and its shard_map arms against JAX's on a (2, 2)
``("data", "model")`` mesh.

JAX runs in a subprocess with ``--xla_force_host_platform_device_count=4``
(as ``tests/test_torch_distributed.py`` runs it with 8) and writes its
inputs, weights and outputs to an ``.npz``; every weight and input is drawn
with numpy from a seed.  The port runs the same on 4 gloo ranks of a (2, 2)
``ProcessMesh`` on the CPU, spawned once for the module: each rank takes
its blocks (``sharding.local_block``, ``convert.shard_state_from_params``),
runs the arm under ``sharding.set_mesh`` and gathers its output blocks
(``sharding.gather_block``).  Checked:

* the named-axis collectives (``all_to_all`` over the axis tuple and over
  one axis, bool on the wire, ``psum``, ``pmax``, ``pmean``, the tiled
  ``all_gather``, ``axis_index``) equal ``jax.lax``'s, exactly;
* exact: ``vocab_parallel.embed`` and the Wide & Deep row fetch, plain and
  with ``dedup_cap`` (one cap that truncates, as JAX's does);
* within rtol 1e-5 (fp32; the ranks sum in another order than XLA):
  ``tied_logits``, the Wide & Deep logits, and ``moe._forward_sharded``'s
  output and aux loss with the plain and the int8 gather;
* each with JAX's replicated branch (a token count the data axis does not
  divide) where the arm has one, and the mesh arms against the port's
  no-mesh forms (the MoE at a capacity that drops no token, where the two
  dispatch the same tokens).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ProcessMesh, run_ranks
from repro_torch.models import layers, moe, recsys, sharding, vocab_parallel
from repro_torch.models.sharding import P

RTOL, ATOL = 1e-5, 1e-6
V, D = 64, 16  # the vocab-parallel table
MOE = dict(d_model=16, d_ff=32, n_experts=4, top_k=2)
MOE_SPECS = {"router": {"w": P(None, None)}, "up": P(None, "data", "model"),
             "gate": P(None, "data", "model"), "down": P(None, "model", "data")}
WD = dict(n_sparse=4, embed_dim=8, vocab_per_field=64, n_dense=3, mlp=(32, 16), bag_size=2)
# (tag, dedup_cap, batch): a rank holds 4 x 4 x 2 = 32 ids at batch 8, so a
# cap of 32 never truncates and one of 5 does
WD_CASES = [("wd", None, 8), ("wd_dedup", 32, 8), ("wd_trunc", 5, 8), ("wd_one", None, 1)]
MOE_CASES = [("moe", False, 4), ("moe_q", True, 4), ("moe_one", False, 1),
             ("moe_q_one", True, 1)]  # (tag, quantized_gather, batch)

_SCRIPT = f"""
V, D, MOE, WD = {V!r}, {D!r}, {MOE!r}, {WD!r}
WD_CASES, MOE_CASES = {WD_CASES!r}, {MOE_CASES!r}
""" + r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import compat_make_mesh, set_mesh, shard_map
from repro.models import moe, recsys, vocab_parallel

mesh = compat_make_mesh((2, 2), ("data", "model"))
axes = ("data", "model")
rng = np.random.default_rng(0)
out = {}

def blockwise(fn, x):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=P(axes), out_specs=P(axes),
                                        check_vma=False))(x))

# the collectives: device k's block of x is rows 4k..4k+3
x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3) * 7 - 5
f = rng.standard_normal((16, 3)).astype(np.float32)
out["c_x"], out["c_f"] = x, f
out["c_a2a_all"] = blockwise(lambda b: jax.lax.all_to_all(b, axes, 0, 0), x)
# one axis: a block of as many rows as the axis has ranks
out["c_a2a_data"] = blockwise(lambda b: jax.lax.all_to_all(b, "data", 0, 0), x[:8])
out["c_a2a_model"] = blockwise(lambda b: jax.lax.all_to_all(b, "model", 0, 0), x[8:])
out["c_a2a_bool"] = blockwise(lambda b: jax.lax.all_to_all(b % 3 == 0, axes, 0, 0), x)
out["c_psum_data"] = blockwise(lambda b: jax.lax.psum(b, "data"), f)
out["c_pmax_model"] = blockwise(lambda b: jax.lax.pmax(b, "model"), x)
out["c_pmean_all"] = blockwise(lambda b: jax.lax.pmean(b, axes), f)
out["c_gather_data"] = blockwise(lambda b: jax.lax.all_gather(b, "data", axis=1, tiled=True), x)
out["c_gather_model"] = blockwise(lambda b: jax.lax.all_gather(b, "model", axis=0, tiled=True), x)
out["c_index"] = blockwise(
    lambda b: jnp.stack([jax.lax.axis_index("data"), jax.lax.axis_index("model")])[None]
    + 0 * b[:1, :2], x)

# the int8 FSDP gather of moe._forward_sharded, at 512 experts: 2,048 scales
def qgather(w):
    scale = jnp.max(jnp.abs(w), axis=(1, 2), keepdims=True).astype(jnp.float32) / 127.0 + 1e-12
    q = jnp.clip(jnp.round(w.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
    return (jax.lax.all_gather(q, "data", axis=1, tiled=True).astype(jnp.float32) * scale)
out["c_qw"] = (rng.uniform(-1, 1, (512, 8, 4)) * rng.uniform(0.01, 4, (512, 1, 1))).astype(np.float32)
out["c_qgather"] = np.asarray(jax.jit(shard_map(
    qgather, mesh=mesh, in_specs=P(None, "data", "model"),
    out_specs=P(None, "data", "model"), check_vma=False))(out["c_qw"]))

# vocab-parallel: 24 tokens split over data, 3 replicated
out["vp_table"] = rng.standard_normal((V, D)).astype(np.float32)
for tag, shape in (("", (4, 6)), ("_one", (1, 3))):
    out["vp_ids" + tag] = rng.integers(0, V, shape).astype(np.int32)
    out["vp_h" + tag] = rng.standard_normal((*shape, D)).astype(np.float32)

# Wide & Deep and the MoE, weights drawn with numpy in JAX's trees
F, Vw, Dw, nd, mlp = WD["n_sparse"], WD["vocab_per_field"], WD["embed_dim"], WD["n_dense"], WD["mlp"]
dims = (F * Dw + nd, *mlp)
wp = {"embed": rng.standard_normal((F, Vw, Dw)).astype(np.float32) * 0.1,
      "wide": rng.standard_normal((F, Vw)).astype(np.float32) * 0.1,
      "mlp": {f"fc{i}": {"w": rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(np.float32)
                         / np.sqrt(dims[i]).astype(np.float32),
                         "b": rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.1}
              for i in range(len(mlp))},
      "head": {"w": rng.uniform(-0.3, 0.3, (mlp[-1], 1)).astype(np.float32),
               "b": np.full((1,), 0.05, np.float32)}}
for k, v in {"embed": wp["embed"], "wide": wp["wide"], "head_w": wp["head"]["w"],
             "head_b": wp["head"]["b"]}.items():
    out["wd_p_" + k] = v
for i in range(len(mlp)):
    out[f"wd_p_fc{i}_w"], out[f"wd_p_fc{i}_b"] = wp["mlp"][f"fc{i}"]["w"], wp["mlp"][f"fc{i}"]["b"]
E, d, ff = MOE["n_experts"], MOE["d_model"], MOE["d_ff"]
mp = {"router": {"w": rng.standard_normal((d, E)).astype(np.float32)},
      "up": rng.uniform(-0.25, 0.25, (E, d, ff)).astype(np.float32),
      "gate": rng.uniform(-0.25, 0.25, (E, d, ff)).astype(np.float32),
      "down": rng.uniform(-0.18, 0.18, (E, ff, d)).astype(np.float32)}
out["moe_p_router_w"], out["moe_p_up"], out["moe_p_gate"], out["moe_p_down"] = (
    mp["router"]["w"], mp["up"], mp["gate"], mp["down"])
for b in (8, 1):
    out[f"wd_ids_{b}"] = (rng.zipf(1.5, (b, F, 2)) % Vw).astype(np.int32)
    out[f"wd_dense_{b}"] = rng.standard_normal((b, nd)).astype(np.float32)
for b in (4, 1):
    out[f"moe_x_{b}"] = rng.standard_normal((b, 6 if b > 1 else 3, d)).astype(np.float32)

with set_mesh(mesh):
    for tag in ("", "_one"):
        out["vp_embed" + tag] = np.asarray(jax.jit(vocab_parallel.embed)(
            out["vp_table"], out["vp_ids" + tag]))
        out["vp_logits" + tag] = np.asarray(jax.jit(vocab_parallel.tied_logits)(
            out["vp_table"], out["vp_h" + tag]))
    for tag, cap, b in WD_CASES:
        cfg = recsys.WideDeepConfig(**WD, dedup_cap=cap)
        ids, dense = out[f"wd_ids_{b}"], out[f"wd_dense_{b}"]
        out[tag + "_rows"] = np.asarray(jax.jit(
            lambda p, i: recsys._fetch_rows("embed", p, cfg, i))(wp, ids))
        out[tag + "_logits"] = np.asarray(jax.jit(
            lambda p, i, x: recsys.forward(p, cfg, i, x))(wp, ids, dense))
    for tag, quant, b in MOE_CASES:
        cfg = moe.MoEConfig(**MOE, quantized_gather=quant)
        y, aux = jax.jit(lambda p, x: moe.forward(p, cfg, x))(mp, out[f"moe_x_{b}"])
        out[tag + "_y"], out[tag + "_aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("coll") / "jax.npz"
    root = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.abspath(os.path.join(root, "src")))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(path)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path)), str(path)


def _wd_params(j) -> dict:
    mlp = {f"fc{i}": {"w": j[f"wd_p_fc{i}_w"], "b": j[f"wd_p_fc{i}_b"]}
           for i in range(len(WD["mlp"]))}
    return {"embed": j["wd_p_embed"], "wide": j["wd_p_wide"], "mlp": mlp,
            "head": {"w": j["wd_p_head_w"], "b": j["wd_p_head_b"]}}


def _moe_params(j) -> dict:
    return {"router": {"w": j["moe_p_router_w"]}, "up": j["moe_p_up"],
            "gate": j["moe_p_gate"], "down": j["moe_p_down"]}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _rank_arms(mesh, path):
    """Every arm on this rank; rank 0 returns the gathered outputs."""
    j = dict(np.load(path))
    axes = mesh.axis_names
    whole_spec = P(axes)
    out = {}

    def blockwise(fn, a):
        b = sharding.local_block(_t(a), whole_spec, mesh)
        return sharding.gather_block(fn(b), whole_spec, mesh).numpy()

    x, f = j["c_x"], j["c_f"]
    out["c_a2a_all"] = blockwise(lambda b: sharding.all_to_all(b, axes, mesh), x)
    out["c_a2a_data"] = blockwise(lambda b: sharding.all_to_all(b, "data", mesh), x[:8])
    out["c_a2a_model"] = blockwise(lambda b: sharding.all_to_all(b, "model", mesh), x[8:])
    out["c_a2a_bool"] = blockwise(lambda b: sharding.all_to_all(b % 3 == 0, axes, mesh), x)
    out["c_psum_data"] = blockwise(lambda b: sharding.psum(b, "data", mesh), f)
    out["c_pmax_model"] = blockwise(lambda b: sharding.pmax(b, "model", mesh), x)
    out["c_pmean_all"] = blockwise(lambda b: sharding.pmean(b, axes, mesh), f)
    out["c_gather_data"] = blockwise(lambda b: sharding.all_gather(b, "data", 1, mesh), x)
    out["c_gather_model"] = blockwise(lambda b: sharding.all_gather(b, "model", 0, mesh), x)
    out["c_index"] = blockwise(lambda b: torch.tensor(
        [[sharding.axis_index("data", mesh), sharding.axis_index("model", mesh)]],
        dtype=b.dtype), x)

    def tokens(a, spec):
        return sharding.local_block(_t(a), spec, mesh)

    with sharding.set_mesh(mesh):
        out["axes"] = sharding.active_axes()
        spec = P(None, "data", "model")
        qw = moe.fsdp_gather(sharding.local_block(_t(j["c_qw"]), spec, mesh), 1, True)
        out["c_qgather"] = sharding.gather_block(qw, spec, mesh).numpy()
        table = convert.shard_state_from_params(
            {"table": j["vp_table"]}, {"table": P("model", "data")}, mesh, "cpu")["table"]
        for tag in ("", "_one"):
            ids, h = j["vp_ids" + tag].reshape(-1), j["vp_h" + tag].reshape(-1, D)
            ts = sharding.token_spec(ids.shape[0], mesh)
            out["vp_spec" + tag] = ts
            rows = vocab_parallel.embed(table, tokens(ids, ts))
            out["vp_embed" + tag] = sharding.gather_block(rows, ts, mesh).numpy()
            logits = vocab_parallel.tied_logits(table, tokens(h, ts))
            out["vp_logits" + tag] = sharding.gather_block(logits, P(ts[0], "model"),
                                                           mesh).numpy()
        for tag, cap, b in WD_CASES:
            cfg = recsys.WideDeepConfig(**WD, dedup_cap=cap)
            model = recsys.WideDeep(cfg, "cpu", mesh=mesh)
            model.load_state_dict(convert.shard_state_from_params(
                _wd_params(j), recsys.param_specs(cfg), mesh, "cpu"))
            bs = sharding.token_spec(b, mesh)
            ids = tokens(j[f"wd_ids_{b}"], bs)
            with torch.no_grad():
                rows = model._fetch_rows(model.embed, ids)
                logits = model(ids, tokens(j[f"wd_dense_{b}"], bs))
            out[tag + "_rows"] = sharding.gather_block(rows, bs, mesh).numpy()
            out[tag + "_logits"] = sharding.gather_block(logits, bs, mesh).numpy()
        params = layers.nest(convert.shard_state_from_params(
            _moe_params(j), MOE_SPECS, mesh, "cpu"))
        for tag, quant, b in MOE_CASES:
            cfg = moe.MoEConfig(**MOE, quantized_gather=quant)
            xb = j[f"moe_x_{b}"].reshape(-1, MOE["d_model"])
            ts = sharding.token_spec(xb.shape[0], mesh)
            y, aux = moe.forward(params, cfg, tokens(xb, ts))
            out[tag + "_y"] = sharding.gather_block(y, ts, mesh).numpy()
            out[tag + "_aux"] = aux.numpy()
            out[tag + "_spec"] = ts
        # the MoE at a capacity that drops no token: the sharded arm equals the local one
        big = moe.MoEConfig(**MOE, capacity_factor=float(MOE["n_experts"]))
        xb = j["moe_x_4"].reshape(-1, MOE["d_model"])
        y, _ = moe.forward(params, big, tokens(xb, sharding.token_spec(xb.shape[0], mesh)))
        out["moe_nodrop_y"] = sharding.gather_block(y, P("data"), mesh).numpy()
    # a rank's module from a seed holds its blocks of the one-process draw
    model = recsys.WideDeep(recsys.WideDeepConfig(**WD), "cpu", seed=3, mesh=mesh)
    out["seeded"] = {k: sharding.gather_block(v.detach(), s, mesh).numpy() for k, (v, s) in
                     {"embed": (model.embed, P(None, "model", None)),
                      "wide": (model.wide, P(None, "model"))}.items()}
    out["seeded_local"] = tuple(model.embed.shape)
    out["axes_after"] = sharding.active_axes()
    out["local_shape"] = sharding.local_shape((8, 6), P("data", "model"), mesh)
    try:
        mesh.group(("model", "data"))
    except ValueError as e:
        out["bad_axes"] = str(e)
    return out if torch.distributed.get_rank() == 0 else None


@pytest.fixture(scope="module")
def rank_out(jax_out):
    res = run_ranks(_rank_arms, (2, 2), jax_out[1], device="cpu", timeout=300)
    assert res[1:] == [None] * 3
    return res[0]


COLLECTIVES = ["c_a2a_all", "c_a2a_data", "c_a2a_model", "c_a2a_bool", "c_pmax_model",
               "c_gather_data", "c_gather_model", "c_index"]


@pytest.mark.parametrize("key", COLLECTIVES)
def test_collective_equals_jax_exactly(jax_out, rank_out, key):
    want = jax_out[0][key]
    assert rank_out[key].dtype == want.dtype or key == "c_index"
    np.testing.assert_array_equal(rank_out[key], want)


@pytest.mark.parametrize("key", ["c_psum_data", "c_pmean_all"])
def test_float_collective_equals_jax(jax_out, rank_out, key):
    np.testing.assert_allclose(rank_out[key], jax_out[0][key], rtol=RTOL, atol=ATOL)


def test_mesh_is_active_only_inside_set_mesh(rank_out):
    assert rank_out["axes"] == ("data", "model") and rank_out["axes_after"] == ()
    assert sharding.active_axes() == () and sharding.current_mesh() is None
    assert not sharding.arms_active()


def test_process_mesh_reads_as_an_accounting_mesh(rank_out):
    """``local_shape`` reads a ``ProcessMesh`` as it reads a ``Mesh``; a
    tuple of axes is one axis or the whole mesh in axis order."""
    acct = mesh_mod.Mesh(("data", "model"), (2, 2))
    assert rank_out["local_shape"] == sharding.local_shape((8, 6), P("data", "model"), acct)
    assert "mesh order" in rank_out["bad_axes"]


@pytest.mark.parametrize("tag", ["", "_one"])
def test_vocab_parallel_equals_jax_and_no_mesh(jax_out, rank_out, tag):
    j = jax_out[0]
    assert rank_out["vp_spec" + tag] == (P("data") if tag == "" else P(None))
    ids, h = j["vp_ids" + tag], j["vp_h" + tag]
    want = j["vp_embed" + tag]
    np.testing.assert_array_equal(rank_out["vp_embed" + tag].reshape(want.shape), want)
    np.testing.assert_array_equal(
        vocab_parallel.embed(_t(j["vp_table"]), _t(ids)).numpy(), want)
    want = j["vp_logits" + tag]
    got = rank_out["vp_logits" + tag].reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    no_mesh = vocab_parallel.tied_logits(_t(j["vp_table"]), _t(h)).numpy()
    np.testing.assert_allclose(got, no_mesh, rtol=RTOL, atol=ATOL)


def _one_process_wd(j, b):
    """The no-mesh forward on the whole batch, without a cap: where no rank's
    cap truncates, the mesh arm's rows and logits are these."""
    cfg = recsys.WideDeepConfig(**WD)
    model = recsys.WideDeep(cfg, "cpu")
    model.load_state_dict(convert.state_from_params(_wd_params(j), "cpu"))
    ids = _t(j[f"wd_ids_{b}"])
    with torch.no_grad():
        return model._fetch_rows(model.embed, ids).numpy(), model(
            ids, _t(j[f"wd_dense_{b}"])).numpy()


@pytest.mark.parametrize("tag,cap,b", WD_CASES)
def test_wide_deep_equals_jax_and_one_process(jax_out, rank_out, tag, cap, b):
    j = jax_out[0]
    np.testing.assert_array_equal(rank_out[tag + "_rows"], j[tag + "_rows"])
    np.testing.assert_allclose(rank_out[tag + "_logits"], j[tag + "_logits"], rtol=RTOL,
                               atol=ATOL)
    rows, logits = _one_process_wd(j, b)
    if tag != "wd_trunc":
        np.testing.assert_array_equal(rank_out[tag + "_rows"], rows)
        np.testing.assert_allclose(rank_out[tag + "_logits"], logits, rtol=RTOL, atol=ATOL)
    else:  # a cap under a rank's distinct ids drops rows, as JAX's does
        assert not np.array_equal(rank_out[tag + "_rows"], rows)


def test_seeded_rank_module_holds_blocks_of_the_same_draw(rank_out):
    cfg = recsys.WideDeepConfig(**WD)
    one = recsys.WideDeep(cfg, "cpu", seed=3)
    assert rank_out["seeded_local"] == (WD["n_sparse"], WD["vocab_per_field"] // 2,
                                        WD["embed_dim"])
    np.testing.assert_array_equal(rank_out["seeded"]["embed"], one.embed.detach().numpy())
    np.testing.assert_array_equal(rank_out["seeded"]["wide"], one.wide.detach().numpy())


@pytest.mark.parametrize("tag,quant,b", MOE_CASES)
def test_moe_sharded_equals_jax(jax_out, rank_out, tag, quant, b):
    j = jax_out[0]
    assert rank_out[tag + "_spec"] == (P("data") if b > 1 else P(None))
    want = j[tag + "_y"]
    np.testing.assert_allclose(rank_out[tag + "_y"].reshape(want.shape), want, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rank_out[tag + "_aux"], j[tag + "_aux"], rtol=RTOL)


def test_moe_sharded_equals_local_when_nothing_drops(jax_out, rank_out):
    j = jax_out[0]
    params = layers.nest(convert.state_from_params(_moe_params(j), "cpu"))
    cfg = moe.MoEConfig(**MOE, capacity_factor=float(MOE["n_experts"]))
    x = _t(j["moe_x_4"])
    y, _ = moe._forward_local(params, cfg, x)
    np.testing.assert_allclose(rank_out["moe_nodrop_y"].reshape(x.shape), y.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_moe_specs_are_the_transformers():
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.models import transformer

    one = __import__("dataclasses").replace(mixtral_8x7b.config(), n_layers=1,
                                            scan_layers=False)
    assert transformer.param_specs(one)["blocks"][0]["moe"] == MOE_SPECS


def test_quantized_gather_bit_equal_jax(jax_out, rank_out):
    """int8 values and scales as XLA compiles ``max / 127 + 1e-12`` (one
    fused multiply-add of the reciprocal), each rank's gathered blocks
    dequantized with its own scales."""
    np.testing.assert_array_equal(rank_out["c_qgather"], jax_out[0]["c_qgather"])
    q, scale = moe.quantize(_t(jax_out[0]["c_qw"]), (1, 2))
    assert q.dtype == torch.int8 and scale.shape == (512, 1, 1) and int(q.abs().max()) == 127


def test_run_ranks_fails_when_a_rank_raises():
    """The failing rank's error is raised, and its peer, left waiting in a
    collective, is not left running."""
    with pytest.raises(RuntimeError, match="(?s)rank1 failed first.*rank 1 fails"):
        run_ranks(_fail_on_rank_one, (2, 1), device="cpu", timeout=120)
    assert not [p for p in __import__("multiprocessing").active_children()
                if p.name.startswith("SpawnProcess")]


def test_run_ranks_ends_ranks_past_its_timeout():
    t0 = __import__("time").monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(_sleep, (2, 1), device="cpu", timeout=5)
    assert __import__("time").monotonic() - t0 < 60
    assert not [p for p in __import__("multiprocessing").active_children()
                if p.name.startswith("SpawnProcess")]


def test_run_ranks_fails_when_a_rank_dies():
    """A rank that exits with no traceback is named, not its peer that
    fails after it in a collective."""
    with pytest.raises(RuntimeError, match="rank1 exited with code 3"):
        run_ranks(_die_on_rank_one, (2, 1), device="cpu", timeout=120)


def _die_on_rank_one(mesh):
    if mesh.axis_index("data") == 1:
        os._exit(3)
    sharding.psum(torch.ones(1), "data", mesh)


def _sleep(mesh):
    __import__("time").sleep(600)


def _fail_on_rank_one(mesh):
    if mesh.axis_index("data") == 1:
        raise ValueError("rank 1 fails")
    sharding.psum(torch.ones(1), "data", mesh)  # rank 0 waits in a collective


def test_transport_follows_the_layout():
    assert mesh_mod.transport(4, "cpu") == "gloo"
    n = torch.cuda.device_count()
    assert mesh_mod.transport(n + 1, "cuda") == "gloo"
    if n:
        assert mesh_mod.transport(n, "cuda") == "nccl"


def test_set_mesh_takes_only_a_mesh_of_ranks():
    with pytest.raises(TypeError, match="ProcessMesh"):
        with sharding.set_mesh(mesh_mod.make_production_mesh()):
            pass
    assert sharding.active_axes() == ()
    assert issubclass(ProcessMesh, mesh_mod.Mesh)  # read as an accounting mesh is
