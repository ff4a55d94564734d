"""The GNN family of the port (``models/gnn/*``, the four GNN configs,
``data/graphs.py``, the GNN registry entries and ``configs.cells.
gnn_train_step``) against the JAX package on the CPU.

JAX's params come from each module's ``init`` and are carried into the
port with ``convert.state_from_params``; graphs come from both packages'
``random_graph`` with one seed.  Tolerances:
- forward and loss: rtol 1e-5 of the output's largest magnitude.  The
  segment sums (``index_add`` against XLA's scatter-add) and NequIP's and
  Equiformer's contractions pair their operands in another order, so the
  two agree to fp32 rounding (about 4e-7 on these graphs), not bit for bit;
- one train step (AdamW lr 1e-3): loss and ``grad_norm`` within rtol 1e-5;
  each parameter within 1e-2 of its update in the 2-norm.  A leaf whose
  gradient is zero up to rounding (the bias of the attention logits, which
  shifts every score of a softmax alike) moves by rounding noise that
  AdamW scales up toward lr; where JAX's update of a leaf is under 1e-3 of
  a full step (lr * sqrt(size)), the port's must be under it too;
- the SO(3) coupling tables (``real_cg``, ``_cg_stack_matrix``) bit-equal;
  ``sph_harm`` and ``rot_to_align_z`` bit-equal on the same fp32 inputs;
  the Wigner-D matrices within 1e-6 (JAX's three-operand ``einsum``);
- ``random_graph``, ``CSRGraph.random`` and ``NeighborSampler`` arrays equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import registry as jreg
from repro.data import graphs as jgraphs
from repro.models.gnn import so3 as jso3
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import make_train_step as jmake_step
from repro_torch.configs import cells, registry
from repro_torch.convert import state_from_params
from repro_torch.data import graphs
from repro_torch.models import layers
from repro_torch.models.gnn import common, equiformer, meshgraphnet, so3

KEY = jax.random.PRNGKey(0)
ARCHS = ["gat-cora", "meshgraphnet", "nequip", "equiformer-v2"]
TASKS = ["node_cls", "graph_reg"]
RTOL = 1e-5
UPDATE_RTOL = 1e-2
LR = 1e-3
N, E, D_IN, CLASSES = 60, 200, 12, 5


def n_graphs(task):
    return 4 if task == "graph_reg" else 1


def cfgs(arch, task, **kw):
    """(JAX config, port config): the smoke config at the test graph's
    widths, as ``test_archs_smoke.py`` sets them."""
    kw = dict(d_in=D_IN, task=task, n_classes=CLASSES, **kw)
    return (dataclasses.replace(jreg.get_arch(arch).smoke_config(), **kw),
            dataclasses.replace(registry.get_arch(arch).smoke_config(), **kw))


@functools.lru_cache(maxsize=None)
def jparams(arch, task):
    jc, _ = cfgs(arch, task)
    return jcells.GNN_FAMILIES[arch][0].init(KEY, jc)


def port_model(arch, task, tc=None):
    module = cells.GNN_FAMILIES[arch][0]
    tc = tc or cfgs(arch, task)[1]
    model = common.Model(module, tc, device="cpu", seed=7)  # overwritten below
    model.load_state_dict(state_from_params(jparams(arch, task), device="cpu"))
    return model


def graph(task, seed=0, n=N, e=E):
    """(port batch of tensors, JAX batch of arrays) from one seed."""
    kw = dict(n_classes=CLASSES, task=task, n_graphs=n_graphs(task), seed=seed)
    tb = graphs.random_graph(n, e, D_IN, **kw)
    jb = jgraphs.random_graph(n, e, D_IN, **kw)
    return common.to_device(tb, "cpu"), jax.tree.map(jnp.asarray, jb)


def close_rel(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))
    assert err <= rtol, f"{what}: {err:.3g} of the largest"


def forward_both(arch, task, tb, jb, model=None, tc=None):
    module = cells.GNN_FAMILIES[arch][0]
    jmodule = jcells.GNN_FAMILIES[arch][0]
    jc, tc0 = cfgs(arch, task)
    tc = tc or tc0
    model = model or port_model(arch, task, tc)
    extra = () if arch == "gat-cora" else (n_graphs(task),)
    with torch.no_grad():
        got = module.forward(model.params(), tc, tb, *extra)
    return got, jmodule.forward(jparams(arch, task), jc, jb, *extra)


# -------------------------------------------------------------------- so3


@pytest.fixture(scope="module")
def rot():
    rng = np.random.default_rng(0)
    return so3._rand_rot(rng), so3._rand_rot(rng), rng


def _t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_real_cg_bit_equal_to_jax():
    """Every table the models read: NequIP's paths at l_max 2 (and the
    triangle rule's zero tables among them) and the Wigner recursion's
    (l-1) (x) 1 -> l tables up to Equiformer's l_max 6."""
    n = 0
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                got, want = so3.real_cg(l1, l2, l3), jso3.real_cg(l1, l2, l3)
                assert got.dtype == want.dtype == np.float64
                assert got.tobytes() == want.tobytes(), (l1, l2, l3)
                n += 1
    for l in range(2, 7):
        assert so3._cg_stack_matrix(l).tobytes() == jso3._cg_stack_matrix(l).tobytes(), l
        assert so3.real_cg(l - 1, 1, l).tobytes() == jso3.real_cg(l - 1, 1, l).tobytes(), l
    assert n == 27


def test_sph_harm_and_frames_match_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(300, 3)).astype(np.float32)
    v[:3] = 0.0  # self-loops' zero vectors
    v[3:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]  # the poles, and |x| >= 0.9
    close_rel(so3.sph_harm(6, _t32(v)), jso3.sph_harm(6, jnp.asarray(v)), rtol=0,
              what="sph_harm")
    np.testing.assert_array_equal(so3.sph_harm(4, v.astype(np.float64), xp=np),
                                  jso3.sph_harm(4, v.astype(np.float64), xp=np))
    R = so3.rot_to_align_z(_t32(v))
    close_rel(R, jso3.rot_to_align_z(jnp.asarray(v)), rtol=0, what="rot_to_align_z")
    Ds = so3.wigner_d_from_rot(6, R)
    jDs = jso3.wigner_d_from_rot(6, jnp.asarray(R.numpy()))
    for l, (d, jd) in enumerate(zip(Ds, jDs, strict=True)):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6, err_msg=l)


def test_sph_harm_orthonormal():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(200000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = so3.sph_harm(4, _t32(v)).numpy()
    G = (Y.T @ Y) / len(v) * 4 * np.pi
    assert np.abs(G - np.eye(G.shape[0])).max() < 0.06  # MC noise ~1/sqrt(N)


def test_sph_harm_equivariance(rot):
    R, _, rng = rot
    v = rng.normal(size=(256, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y0 = so3.sph_harm(4, _t32(v)).numpy()
    YR = so3.sph_harm(4, _t32(v @ R.T)).numpy()
    Ds = [d[0].numpy() for d in so3.wigner_d_from_rot(4, _t32(R[None]))]
    for l in range(5):
        sl = slice(l * l, (l + 1) * (l + 1))
        assert np.abs(YR[:, sl] - Y0[:, sl] @ Ds[l].T).max() < 2e-3


def test_wigner_homomorphism(rot):
    R1, R2, _ = rot
    Da = so3.wigner_d_from_rot(6, _t32((R1 @ R2)[None]))
    D1 = so3.wigner_d_from_rot(6, _t32(R1[None]))
    D2 = so3.wigner_d_from_rot(6, _t32(R2[None]))
    for l in range(7):
        prod = D1[l][0].numpy() @ D2[l][0].numpy()
        assert np.abs(prod - Da[l][0].numpy()).max() < 1e-3, l
        orth = D1[l][0].numpy() @ D1[l][0].numpy().T
        assert np.abs(orth - np.eye(2 * l + 1)).max() < 1e-3, l


@pytest.mark.parametrize(
    "l1,l2,l3",
    [(1, 1, 0), (1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 1, 2), (2, 2, 2),
     (2, 2, 0), (3, 1, 4), (5, 2, 4), (6, 1, 6)],
)
def test_cg_contraction_equivariance(l1, l2, l3, rot):
    R, _, rng = rot
    W = so3.real_cg(l1, l2, l3)
    assert np.abs(W).max() > 0
    Ds = [d[0].numpy() for d in so3.wigner_d_from_rot(max(l1, l2, l3), _t32(R[None]))]
    x = rng.normal(size=2 * l1 + 1)
    y = rng.normal(size=2 * l2 + 1)
    m0 = np.einsum("abc,a,b->c", W, x, y)
    m1 = np.einsum("abc,a,b->c", W, Ds[l1] @ x, Ds[l2] @ y)
    assert np.abs(m1 - Ds[l3] @ m0).max() < 1e-3 * max(np.abs(m0).max(), 1.0)


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 3), (0, 2, 1), (2, 0, 3), (3, 1, 1)])
def test_cg_triangle_rule(l1, l2, l3):
    W = so3.real_cg(l1, l2, l3)
    assert W.shape == (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1) and np.abs(W).max() == 0


def test_rot_to_align_z(rot):
    _, _, rng = rot
    v = rng.normal(size=(128, 3)).astype(np.float32)
    R = so3.rot_to_align_z(_t32(v)).numpy()
    vhat = v / np.linalg.norm(v, axis=1, keepdims=True)
    out = np.einsum("nij,nj->ni", R, vhat)
    assert np.abs(out - np.array([0.0, 0.0, 1.0])).max() < 1e-4
    assert np.abs(R @ np.transpose(R, (0, 2, 1)) - np.eye(3)).max() < 1e-4


# ------------------------------------------------------------ the models


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, task):
    tb, jb = graph(task, seed=1)
    got, want = forward_both(arch, task, tb, jb)
    close_rel(got, want, what="forward")
    module = cells.GNN_FAMILIES[arch][0]
    jc, tc = cfgs(arch, task)
    with torch.no_grad():
        loss = module.loss_fn(port_model(arch, task).params(), tc, tb, n_graphs(task))
    jloss = jcells.GNN_FAMILIES[arch][0].loss_fn(jparams(arch, task), jc, jb, n_graphs(task))
    close_rel(loss, jloss, what="loss")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, task):
    """One ``gnn_train_step`` against JAX's jitted ``make_train_step``."""
    tb, jb = graph(task, seed=2)
    jc, tc = cfgs(arch, task)
    ng = n_graphs(task)
    jmodule = jcells.GNN_FAMILIES[arch][0]
    jopt = JAdamW(lr=LR)
    jstep = jax.jit(jmake_step(lambda p, b: jmodule.loss_fn(p, jc, b, ng), jopt))
    jp, _, jm = jstep(jparams(arch, task), jopt.init(jparams(arch, task)), jb)
    model = port_model(arch, task)
    step, opt, params = cells.gnn_train_step(arch, tc, model, n_graphs=ng)
    assert dataclasses.asdict(opt) == dataclasses.asdict(JAdamW(lr=LR))
    p0 = {k: v.detach().clone() for k, v in params.items()}
    params, state, m = step(params, opt.init(params), tb)
    assert int(state.step) == 1
    for k in ("loss", "grad_norm"):
        close_rel(m[k], jm[k], what=k)
    want = state_from_params(jp, device="cpu")
    assert sorted(params) == sorted(want)
    for k, w in want.items():
        floor = 1e-3 * LR * w.numel() ** 0.5
        moved, diff = float((w - p0[k]).norm()), float((params[k].detach() - w).norm())
        if moved < floor:  # a gradient zero up to rounding
            assert float((params[k].detach() - p0[k]).norm()) < floor, k
        else:
            assert diff <= UPDATE_RTOL * moved, f"{k}: {diff / moved:.3g} of the update"
    assert all(p is model.get_parameter(k) for k, p in params.items())  # in place


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_edges_change_nothing(arch):
    """Padding edges (``edge_mask`` False, src/dst clipped into range) leave
    the output as it was; JAX's smoke test holds GAT to this."""
    task = "node_cls"
    tb, jb = graph(task, seed=3)
    pad = 10
    bad = tb._replace(
        edge_src=torch.cat([tb.edge_src, torch.zeros(pad, dtype=torch.int32)]),
        edge_dst=torch.cat([tb.edge_dst, torch.arange(pad, dtype=torch.int32)]),
        edge_mask=torch.cat([tb.edge_mask, torch.zeros(pad, dtype=torch.bool)]),
    )
    model = port_model(arch, task)
    module = cells.GNN_FAMILIES[arch][0]
    with torch.no_grad():
        a = module.forward(model.params(), model.cfg, tb)
        b = module.forward(model.params(), model.cfg, bad)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def _self_loop_graph(task, seed=4):
    tb, jb = graph(task, seed=seed)
    loops = torch.arange(0, E, 7)
    src = tb.edge_src.clone()
    src[loops] = tb.edge_dst[loops]
    jsrc = np.asarray(jb.edge_src).copy()
    jsrc[loops.numpy()] = np.asarray(jb.edge_dst)[loops.numpy()]
    return tb._replace(edge_src=src), jb._replace(edge_src=jnp.asarray(jsrc)), loops


def test_self_loops_give_zero_frames():
    """``random_graph`` draws src and dst apart, so self-loops occur: their
    vector is 0, ``rot_to_align_z`` gives R = 0, and every D^l (l >= 1)
    from it is 0 (D^0 is 1), as in JAX, with no NaN."""
    tb, jb, loops = _self_loop_graph("node_cls")
    _, dist, unit = common.edge_vectors(tb)
    assert bool((dist[loops] == 0).all()) and bool((unit[loops] == 0).all())
    R = so3.rot_to_align_z(unit)
    Ds = so3.wigner_d_from_rot(6, R)
    assert bool((R[loops] == 0).all())
    assert all(bool((d[loops] == 0).all()) for d in Ds[1:]) and bool((Ds[0] == 1).all())
    assert all(bool(torch.isfinite(d).all()) for d in Ds)
    jR = jso3.rot_to_align_z(jnp.asarray(unit.numpy()))
    np.testing.assert_array_equal(R.numpy(), np.asarray(jR))


@pytest.mark.parametrize("arch", ARCHS)
def test_self_loops_forward_and_step_match_jax(arch):
    task = "graph_reg"
    tb, jb, _ = _self_loop_graph(task)
    got, want = forward_both(arch, task, tb, jb)
    assert bool(torch.isfinite(got).all())
    close_rel(got, want, what="forward")
    _, tc = cfgs(arch, task)
    step, opt, params = cells.gnn_train_step(arch, tc, port_model(arch, task),
                                             n_graphs=n_graphs(task))
    params, _, m = step(params, opt.init(params), tb)
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
    assert all(bool(torch.isfinite(p).all()) for p in params.values())


def _grads(arch, task, remat):
    module = cells.GNN_FAMILIES[arch][0]
    _, tc = cfgs(arch, task)
    if hasattr(tc, "remat"):
        tc = dataclasses.replace(tc, remat=remat)
    model = common.Model(module, tc, device="cpu", seed=3)
    tb, _ = graph(task, seed=5)
    xs = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
    loss = module.loss_fn(layers.nest(xs), tc, tb, n_graphs(task))
    return loss, torch.autograd.grad(loss, list(xs.values()), allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_bit_equal(arch, task):
    """The recomputation runs the same operations: the loss and every
    gradient are bit-equal with and without remat (GAT has no remat)."""
    (l1, g1), (l2, g2) = _grads(arch, task, True), _grads(arch, task, False)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2, strict=True))


@pytest.mark.parametrize("remat,runs", [(True, 2), (False, 1), (None, 1)])
def test_remat_recomputes_each_block(monkeypatch, remat, runs):
    """With remat each MGN block runs again in the backward pass (its one
    ``scatter_sum`` counted); without it, or under no_grad, once."""
    calls = []
    real = common.scatter_sum
    monkeypatch.setattr(common, "scatter_sum", lambda m, b: calls.append(1) or real(m, b))
    _, tc = cfgs("meshgraphnet", "node_cls", remat=bool(remat))
    model = common.Model(meshgraphnet, tc, device="cpu")
    tb, _ = graph("node_cls")
    if remat is None:
        with torch.no_grad():
            meshgraphnet.loss_fn(model.params(), tc, tb)
    else:
        xs = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
        torch.autograd.grad(meshgraphnet.loss_fn(layers.nest(xs), tc, tb), list(xs.values()))
    assert len(calls) == runs * tc.n_layers


def test_equiformer_truncates_above_m_max():
    """Components with m > m_max leave the SO(2) conv exactly zero, and the
    rest equal JAX's ``.at[...].set`` layout."""
    from repro.models.gnn import equiformer as jeq

    jc, tc = cfgs("equiformer-v2", "node_cls")
    x = np.random.default_rng(6).normal(size=(9, tc.channels, tc.n_sph)).astype(np.float32)
    p = port_model("equiformer-v2", "node_cls").params()["layer0"]
    with torch.no_grad():  # the port's layout is (E, n_sph, C)
        got = equiformer._so2_conv(p, tc, torch.from_numpy(x).transpose(1, 2)).transpose(
            1, 2).numpy()
    want = np.asarray(jeq._so2_conv(jparams("equiformer-v2", "node_cls")["layer0"], jc,
                                    jnp.asarray(x)))
    ms = np.array([m for l in range(tc.l_max + 1) for m in range(-l, l + 1)])
    assert (got[:, :, np.abs(ms) > tc.m_max] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- the data


@pytest.mark.parametrize("task,ng", [("node_cls", 1), ("graph_reg", 1), ("graph_reg", 5)])
def test_random_graph_equals_jax(task, ng):
    kw = dict(n_classes=7, seed=11, task=task, n_graphs=ng)
    got, want = graphs.random_graph(50, 300, 9, **kw), jgraphs.random_graph(50, 300, 9, **kw)
    assert type(got).__name__ == "GraphBatch" and got._fields == want._fields
    for f, a, b in zip(got._fields, got, want, strict=True):
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_neighbor_sampler_equals_jax():
    g, jg = graphs.CSRGraph.random(2000, 12, seed=3), jgraphs.CSRGraph.random(2000, 12, seed=3)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    s, js = graphs.NeighborSampler(g, (5, 3), seed=4), jgraphs.NeighborSampler(jg, (5, 3), seed=4)
    seeds = np.arange(0, 2000, 31)
    for _ in range(2):  # the sampler's generator advances alike
        a, b = s.sample(seeds), js.sample(seeds)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["dedup_ratio"] > 1.0
    got, want = s.batch(seeds, 16), js.batch(seeds, 16)
    for f, x, y in zip(got._fields, got, want, strict=True):
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_sampled_batch_trains():
    """A ``NeighborSampler`` batch through ``to_device`` and a GAT step: the
    loss counts only the seeds."""
    g = graphs.CSRGraph.random(500, 8, seed=1)
    b = graphs.NeighborSampler(g, (4, 3), seed=2).batch(np.arange(16), D_IN, n_classes=CLASSES)
    tb = common.to_device(b, "cpu")
    assert tb.edge_src.dtype == torch.int32 and tb.label_mask.dtype == torch.bool
    assert int(tb.label_mask.sum()) == 16
    _, tc = cfgs("gat-cora", "node_cls")
    step, opt, params = cells.gnn_train_step("gat-cora", tc, common.Model(
        cells.GNN_FAMILIES["gat-cora"][0], tc, device="cpu"))
    _, _, m = step(params, opt.init(params), tb)
    assert bool(torch.isfinite(m["loss"]))


# ----------------------------------------------------------- the registry


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch):
    for get in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(jreg.get_arch(arch), get)())
        got = dataclasses.asdict(getattr(registry.get_arch(arch), get)())
        assert set(got) == set(want)
        for k in want:
            if k == "dtype":
                assert str(got[k]).removeprefix("torch.") == jnp.dtype(want[k]).name, k
            else:
                assert got[k] == want[k], k


@pytest.mark.parametrize("include_skips", [False, True])
def test_list_cells_equals_jax(include_skips):
    got = registry.list_cells(include_skips)
    assert got == jreg.list_cells(include_skips) == registry.list_cells()
    assert len(got) == 40 and list(registry.ARCHS) == list(jreg.ARCHS)
    assert sum(1 for c in got if c[2]) == 4


def test_gnn_entries_and_shapes_equal_jax():
    assert registry.GNN_SHAPES == jreg.GNN_SHAPES
    for arch in ARCHS:
        j, p = jreg.get_arch(arch), registry.get_arch(arch)
        assert (p.family, p.shapes, p.skips) == (j.family, j.shapes, j.skips) == (
            "gnn", tuple(jreg.GNN_SHAPES), {})


@pytest.mark.parametrize("shape", list(jreg.GNN_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_cell_config_is_build_cells(arch, shape):
    """``build_cell``'s GNN arm sets d_in, task and n_classes, and for a
    ``shard_edges`` shape channel sharding and bf16."""
    p = jreg.GNN_SHAPES[shape]
    want = dataclasses.replace(jreg.get_arch(arch).config(), d_in=p["d_feat"],
                               n_classes=p["n_classes"], task=p["task"])
    if p["shard_edges"]:
        want = dataclasses.replace(want, channel_shard=True, dtype=jnp.bfloat16)
    got = registry.gnn_cell_config(arch, shape)
    for k, w in dataclasses.asdict(want).items():
        g = getattr(got, k)
        if k == "dtype":
            assert str(g).removeprefix("torch.") == jnp.dtype(w).name
        else:
            assert g == w, k
    with pytest.raises(ValueError, match="not a GNN"):
        registry.gnn_cell_config("qwen2.5-3b", shape)


def test_gnn_train_step_checks_the_config():
    _, tc = cfgs("nequip", "node_cls")
    with pytest.raises(ValueError, match="MGNConfig"):
        cells.gnn_train_step("meshgraphnet", tc, port_model("nequip", "node_cls"))


def test_shard_channels_is_the_identity():
    x = torch.ones(3, 4)
    assert common.shard_channels(x) is x


def test_bf16_cell_trains():
    """An ogb_products-like cell (bf16, channel_shard) at a tiny size: a
    finite loss from bf16 weights, fp32 moments."""
    for arch in ARCHS:
        tc = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"), d_in=D_IN,
                                 **({"n_layers": 2} if arch != "gat-cora" else {}))
        if arch == "equiformer-v2":
            tc = dataclasses.replace(tc, channels=16, l_max=2, n_heads=4)
        model = common.Model(cells.GNN_FAMILIES[arch][0], tc, device="cpu")
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        tb, _ = graph("node_cls")
        tb = tb._replace(labels=tb.labels % tc.n_classes)
        step, opt, params = cells.gnn_train_step(arch, tc, model)
        state = opt.init(params)
        params, state, m = step(params, state, tb)
        assert bool(torch.isfinite(m["loss"])), arch
        assert all(v.dtype == torch.float32 for v in state.m.values())


# ------------------------------------------ full-width trajectories against JAX
#
# ``chip_smoke.py`` trains each GNN cell at its published config from the
# port's seed-0 weights drawn on the CPU.  At lr 1e-3 some small cells do
# not settle in 12 steps: MGN's ``molecule`` MSE swings by orders of
# magnitude and Equiformer's ``full_graph_sm`` loss jumps after falling for
# 8 steps.  ``cell_trajectories`` runs JAX's step and the port's from those
# weights on the same batch, so the card's losses can be held to JAX's.
# The cheap cells run here; every cell runs from the command line:
#
#     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_gnn.py \
#         equiformer-v2 full_graph_sm 12 [--jax-only | --port-only]
#
# (Equiformer at its published width: about 35 s a JAX step and 25 GB,
# 80 s a port step and 6 GB, on 4 CPU threads.)

TRAJ_RTOL = 2e-2  # a loss a step, port against JAX over 12 steps (measured: 3e-3)


def jax_params_from_state(like, state: dict):
    """JAX's params tree shaped as ``like`` with each leaf taken from the
    port's ``state`` (keys as ``convert.state_from_params`` names them)."""
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}{k}.", v) for k, v in node.items()}
        t = state[prefix[:-1]].detach().cpu()
        return jnp.asarray(t.float().numpy()).astype(node.dtype)

    return walk("", like)


def cell_trajectories(arch, shape, steps, run_jax=True, run_port=True, log=None):
    """(JAX's losses, the port's losses), ``steps`` each: both packages'
    train steps (AdamW lr 1e-3) at the cell's published config, from the
    port's seed-0 weights drawn on the CPU, on the shape's seed-0
    ``random_graph`` batch."""
    p = registry.GNN_SHAPES[shape]
    assert not p["shard_edges"], "the fp32 cells only"
    tc = registry.gnn_cell_config(arch, shape)
    jc = dataclasses.replace(jreg.get_arch(arch).config(), d_in=p["d_feat"],
                             n_classes=p["n_classes"], task=p["task"])
    kw = dict(n_classes=max(p["n_classes"], 1), seed=0, task=p["task"], n_graphs=p["n_graphs"])
    ng = p["n_graphs"]
    model = common.Model(cells.GNN_FAMILIES[arch][0], tc, device="cpu", seed=0)
    out = [], []
    if run_jax:
        jmodule = jcells.GNN_FAMILIES[arch][0]
        jp = jax_params_from_state(jmodule.init(KEY, jc), dict(model.named_parameters()))
        jb = jax.tree.map(jnp.asarray, jgraphs.random_graph(p["n"], p["e"], p["d_feat"], **kw))
        jopt = JAdamW(lr=LR)
        jstep = jax.jit(jmake_step(lambda q, b: jmodule.loss_fn(q, jc, b, ng), jopt))
        state = jopt.init(jp)
        for i in range(steps):
            jp, state, m = jstep(jp, state, jb)
            out[0].append(float(m["loss"]))
            if log:
                log(f"jax {i} {out[0][-1]!r}")
    if run_port:
        tb = common.to_device(graphs.random_graph(p["n"], p["e"], p["d_feat"], **kw), "cpu")
        step, opt, params = cells.gnn_train_step(arch, tc, model, n_graphs=ng)
        state = opt.init(params)
        for i in range(steps):
            params, state, m = step(params, state, tb)
            out[1].append(float(m["loss"]))
            if log:
                log(f"port {i} {out[1][-1]!r}")
    return out


@pytest.fixture
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread keeps torch's CPU thread pools from oversubscribing the host
    (MGN's ``molecule`` steps ran 12x slower beside another process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("arch,shape", [("gat-cora", "full_graph_sm"),
                                        ("gat-cora", "molecule"),
                                        ("meshgraphnet", "molecule")])
def test_full_width_trajectory_matches_jax(arch, shape):
    """12 steps at the published widths from one set of weights: the port's
    loss within ``TRAJ_RTOL`` of JAX's at every step, also where MGN's
    ``molecule`` MSE swings (JAX's does too)."""
    want, got = cell_trajectories(arch, shape, 12)
    assert np.all(np.isfinite(got))
    err = np.abs(np.array(got) - np.array(want)) / np.abs(np.array(want))
    assert float(err.max()) <= TRAJ_RTOL, (want, got)


if __name__ == "__main__":
    import sys

    torch.set_num_threads(4)
    arch_, shape_, steps_ = sys.argv[1], sys.argv[2], int(sys.argv[3])
    cell_trajectories(arch_, shape_, steps_, run_jax="--port-only" not in sys.argv,
                      run_port="--jax-only" not in sys.argv, log=lambda s: print(s, flush=True))
