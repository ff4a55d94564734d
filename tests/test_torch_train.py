"""repro_torch.train (AdamW, the train step, compression, checkpoints, fault
policies) and Wide & Deep training against the JAX package on the CPU.

The JAX params come from ``recsys.init`` and are carried into the port with
``convert.state_from_params``; every input is numpy-seeded.  Tolerances:
- ``AdamW.update`` against JAX's update run op by op (as it runs outside
  ``jit``): rtol 1e-6, atol 1e-8 for params, ``m`` and ``v``; ``step`` equal;
- ``compress_decompress`` against JAX's, op by op: bit-equal;
- Wide & Deep through each package's ``make_train_step`` (JAX's jitted):
  loss and ``grad_norm`` within rtol 1e-5 every step; params after 5 steps
  within atol 2e-5 at lr 1e-2.  XLA fuses multiply-adds and sums in another
  order, and AdamW turns a gradient's relative error into an absolute one
  of up to ``lr`` times it, so the params' bound is absolute.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as jwd
from repro.models import recsys as jrec
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import AdamWState as JState
from repro.train.trainer import make_train_step as jmake_step
from repro_torch.bench import train_precision
from repro_torch.configs import cells, registry, wide_deep
from repro_torch.convert import state_from_params
from repro_torch.examples import recsys_dedup
from repro_torch.models.recsys import WideDeep, bce_loss
from repro_torch.train import checkpoint, compression, fault, optimizer, tree
from repro_torch.train.optimizer import AdamW, AdamWState
from repro_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
STEPS = 5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_tree_close(got, want, rtol, atol):
    """``got``: the port's flat dict of tensors; ``want``: a JAX params tree."""
    want = state_from_params(want, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------------ AdamW


def _grad_tree(rng, params):
    return jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.3, params)


@pytest.mark.parametrize("clip,wd,chunk", [
    (1.0, 0.0, None), (None, 0.0, None), (1.0, 0.1, None), (None, 0.1, None),
    (0.5, 0.1, 7),  # every leaf in slices of 7 elements
])
def test_adamw_update_matches_jax(clip, wd, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.normal(size=(5, 9)).astype(np.float32),
                    "b": rng.normal(size=(9,)).astype(np.float32)},
              "z": rng.normal(size=(4, 3, 2)).astype(np.float32)}
    jopt = JAdamW(lr=3e-2, weight_decay=wd, grad_clip=clip)
    opt = AdamW(lr=3e-2, weight_decay=wd, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = {"a": {k: t(v) for k, v in params["a"].items()}, "z": t(params["z"])}
    ts = opt.init(tp)
    for _ in range(3):
        grads = _grad_tree(rng, params)
        jp, js, jn = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tg = {"a": {k: t(v) for k, v in grads["a"].items()}, "z": t(grads["z"])}
        tp, ts, tn = opt.update(tg, ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


def test_adamw_update_is_in_place():
    p = {"w": torch.ones(4)}
    opt = AdamW(lr=0.1)
    st = opt.init(p)
    w, m = p["w"], st.m["w"]
    p2, st2, _ = opt.update({"w": torch.full((4,), 0.5)}, st, p)
    assert p2["w"] is w and st2.m["w"] is m and not torch.equal(w, torch.ones(4))


# ------------------------------------------------------------ compression


def test_compression_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    shapes = {"e": (40, 8), "h": {"b": (3,), "w": (16, 5)}}
    jerr = terr = None
    for _ in range(3):
        g = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32) * 0.01, shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
        jg, jerr = jcomp.compress_decompress(jax.tree.map(jnp.asarray, g), jerr)
        tg, terr = compression.compress_decompress(tree.tree_map(t, g), terr)
        for got, want in ((tg, jg), (terr, jerr)):
            for a, b in zip(tree.leaves(got), jax.tree.leaves(want), strict=True):
                assert np.array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------- the substrate (test_train_substrate)


def _quad_loss(params, x, y):
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def _toy():
    rng = np.random.default_rng(0)
    x = t(rng.normal(size=(64, 4)).astype(np.float32))
    w_true = t(rng.normal(size=(4,)).astype(np.float32))
    y = x @ w_true + 0.3
    return {"w": torch.zeros(4), "b": torch.zeros(())}, x, y


def test_adamw_converges():
    params, x, y = _toy()
    opt = AdamW(lr=5e-2)
    step = make_train_step(_quad_loss, opt)
    state = opt.init(params)
    losses = []
    for _ in range(200):
        params, state, m = step(params, state, x, y)
        losses.append(float(m["loss"]))
    assert losses[-1] < 1e-3 < losses[0]


def test_grad_accum_matches_full_batch():
    opt = AdamW(lr=1e-2, grad_clip=None)
    p1, x, y = _toy()
    p1, _, m1 = make_train_step(_quad_loss, opt)(p1, opt.init(p1), x, y)
    p2, _, _ = _toy()
    p2, _, m2 = make_train_step(_quad_loss, opt, grad_accum=4)(
        p2, opt.init(p2), x.reshape(4, 16, 4), y.reshape(4, 16))
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)


def test_compression_error_feedback_converges():
    params, x, y = _toy()
    opt = AdamW(lr=5e-2)
    step = make_train_step(_quad_loss, opt, compress=True)
    state = opt.init(params)
    err = None
    for _ in range(300):
        params, state, m, err = step(params, state, x, y, error_fb=err)
    assert float(m["loss"]) < 1e-2


def test_compression_bounded_error():
    g = {"a": t(np.random.default_rng(0).normal(size=(128,)).astype(np.float32))}
    cg, _ = compression.compress_decompress(g)
    scale = float(g["a"].abs().max()) / 127.0
    assert float((cg["a"] - g["a"]).abs().max()) <= scale * 1.01


def test_checkpoint_roundtrip(tmp_path):
    params, _, _ = _toy()
    opt = AdamW(lr=1e-2)
    tr = {"params": params, "opt": opt.init(params)}
    path = os.path.join(tmp_path, "step_10")
    checkpoint.save(path, tr, step=10)
    like = tree.tree_map(torch.zeros_like, tr)
    restored, step = checkpoint.restore(path, like, device="cpu")
    assert step == 10 and isinstance(restored["opt"], AdamWState)
    for a, b in zip(tree.leaves(tr), tree.leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomic_and_latest(tmp_path):
    tr = {"w": torch.ones(3)}
    checkpoint.save(os.path.join(tmp_path, "step_1"), tr, step=1)
    th = checkpoint.save(os.path.join(tmp_path, "step_20"), tr, step=20, background=True)
    th.join(timeout=60)
    assert not th.is_alive()
    assert checkpoint.latest_step_dir(str(tmp_path)).endswith("step_20")
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert checkpoint.latest_step_dir(os.path.join(tmp_path, "none")) is None


def test_retry_policy_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("simulated preemption")
        return "ok"

    pol = fault.RetryPolicy(max_retries=3, backoff_s=0.0)
    restores = []
    assert pol.run(flaky, on_failure=lambda a, e: restores.append(a)) == "ok"
    assert calls["n"] == 3 and len(restores) == 2


def test_retry_policy_gives_up():
    pol = fault.RetryPolicy(max_retries=1, backoff_s=0.0)
    with pytest.raises(RuntimeError):
        pol.run(lambda: (_ for _ in ()).throw(RuntimeError("dead")))


def test_straggler_detector():
    det = fault.StragglerDetector(warmup_steps=2, threshold=2.0)
    flags = [det.observe(x) for x in [5.0, 5.0, 0.1, 0.1, 0.1, 0.1, 1.0]]
    assert flags[-1] is True and not any(flags[:-1])


# ------------------------------------------------------- Wide & Deep training


def _batches(cfg, n, batch, seed):
    rng = np.random.default_rng(seed)
    sp = (np.minimum(rng.zipf(1.3, size=(n, batch, cfg.n_sparse, 1)), cfg.vocab_per_field)
          - 1).astype(np.int32)
    de = rng.normal(size=(n, batch, cfg.n_dense)).astype(np.float32)
    y = (rng.random((n, batch)) > 0.5).astype(np.int32)
    return sp, de, y


def _cap(cfg, sp) -> int:
    """1.5x the most distinct (field, id) pairs of a batch: no overflow."""
    offs = (np.arange(cfg.n_sparse) * cfg.vocab_per_field)[None, :, None]
    return int(1.5 * max(len(np.unique(b + offs)) for b in sp.reshape(-1, *sp.shape[-3:])))


def _port_model(jparams, dedup_cap=None):
    cfg = dataclasses.replace(wide_deep.smoke_config(), dedup_cap=dedup_cap)
    model = WideDeep(cfg, device="cpu")
    model.load_state_dict(state_from_params(jparams, device="cpu"))
    return cfg, model


@pytest.mark.parametrize("mode", ["plain", "dedup", "accum2", "compress"])
def test_widedeep_train_steps_match_jax(mode):
    accum = 2 if mode == "accum2" else 1
    compress = mode == "compress"
    sp, de, y = _batches(jwd.smoke_config(), STEPS, 32, seed=7)
    cap = _cap(jwd.smoke_config(), sp) if mode == "dedup" else None
    jcfg = dataclasses.replace(jwd.smoke_config(), dedup_cap=cap)
    jparams = jrec.init(KEY, jcfg)
    cfg, model = _port_model(jparams, cap)
    if accum > 1:  # a leading microbatch axis
        sp, de, y = (a.reshape(a.shape[0], accum, a.shape[1] // accum, *a.shape[2:])
                     for a in (sp, de, y))
    jopt = JAdamW(lr=1e-2)
    jstep = jax.jit(jmake_step(lambda p, s, d, l: jrec.loss_fn(p, jcfg, s, d, l), jopt,
                               grad_accum=accum, compress=compress))
    step, opt, params = cells.recsys_train_step(cfg, model, AdamW(lr=1e-2),
                                                grad_accum=accum, compress=compress)
    js, ts, jerr, terr = jopt.init(jparams), opt.init(params), None, None
    for i in range(STEPS):
        if compress:
            jparams, js, jm, jerr = jstep(jparams, js, sp[i], de[i], y[i], error_fb=jerr)
            params, ts, tm, terr = step(params, ts, t(sp[i]), t(de[i]), t(y[i]), error_fb=terr)
        else:
            jparams, js, jm = jstep(jparams, js, sp[i], de[i], y[i])
            params, ts, tm = step(params, ts, t(sp[i]), t(de[i]), t(y[i]))
        for k in ("loss", "grad_norm"):
            assert tm[k].shape == () and tm[k].dtype == torch.float32
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert int(ts.step) == STEPS
    assert all(p is q for p, q in zip(params.values(), model.parameters()))
    assert_tree_close(params, jparams, rtol=0, atol=2e-5)


def test_dedup_gradients_equal_plain():
    """The gradient flows through the deduplicated fetch: the same dense
    table gradients as the plain fetch (padding lanes of the unique ids
    add nothing), and JAX's dedup gradients."""
    sp, de, y = (a[0] for a in _batches(jwd.smoke_config(), 1, 48, seed=9))
    cap = _cap(jwd.smoke_config(), sp)
    jcfg = dataclasses.replace(jwd.smoke_config(), dedup_cap=cap)
    jparams = jrec.init(KEY, jcfg)
    grads = {}
    for c in (None, cap):
        cfg, model = _port_model(jparams, c)
        params = dict(model.named_parameters())
        with torch.no_grad():
            grads[c] = torch.func.grad(lambda p: bce_loss(
                torch.func.functional_call(model, p, (t(sp), t(de))), t(y)))(params)
    jg = jax.grad(lambda p: jrec.loss_fn(p, jcfg, sp, de, y))(jparams)
    for k, g in grads[None].items():
        np.testing.assert_allclose(grads[cap][k].numpy(), g.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    assert_tree_close(grads[cap], jg, rtol=1e-5, atol=1e-8)
    assert float(grads[cap]["embed"].abs().sum()) > 0


def test_recsys_train_step_checks_widths():
    model = WideDeep(wide_deep.smoke_config(), device="cpu")
    with pytest.raises(ValueError, match="n_sparse"):
        cells.recsys_train_step(wide_deep.config(), model)
    step, opt, params = cells.recsys_train_step(
        dataclasses.replace(wide_deep.smoke_config(), dedup_cap=64), model)
    assert model.cfg.dedup_cap == 64 and opt == AdamW(lr=1e-3)
    entry = registry.get_arch("wide-deep")
    assert entry.train_shape == "train_batch" and entry.train_shape in entry.shapes
    assert registry.RECSYS_SHAPES[entry.train_shape] == 65536


# ------------------------------------------------------------ checkpoints


LEAF_ORDER = (["embed", "head.b", "head.w"]
              + [f"mlp.fc{i}.{x}" for i in range(3) for x in "bw"] + ["wide"])


def test_leaf_order_is_jax_order():
    jparams = jrec.init(KEY, jwd.smoke_config())
    jtree = (jparams, JAdamW(lr=1e-3).init(jparams))
    cfg, model = _port_model(jparams)
    _, opt, params = cells.recsys_train_step(cfg, model)
    ttree = (params, opt.init(params))
    flat_j, flat_t = jax.tree.leaves(jtree), tree.leaves(ttree)
    assert len(flat_t) == len(flat_j) == 31
    names = LEAF_ORDER + ["step"] + LEAF_ORDER + LEAF_ORDER
    for name, a, b in zip(names, flat_t, flat_j, strict=True):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        if name != "step" and a is params.get(name):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert [k for k in sorted(params, key=lambda k: tuple(k.split(".")))] == LEAF_ORDER
    assert tree.describe({"b": 1, "a": (2, None)}) == "{'a': (*, None), 'b': *}"


def _jax_run(jcfg, jparams, opt, batches, n):
    step = jax.jit(jmake_step(lambda p, s, d, l: jrec.loss_fn(p, jcfg, s, d, l), opt))
    state = opt.init(jparams)
    for i in range(n):
        jparams, state, m = step(jparams, state, *(a[i] for a in batches))
    return jparams, state, m


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains 2 steps and saves; the port restores and takes step 3,
    which equals JAX's own step 3."""
    jcfg = jwd.smoke_config()
    batches = _batches(jcfg, 3, 32, seed=11)
    opt = JAdamW(lr=1e-2)
    jp2, js2, _ = _jax_run(jcfg, jrec.init(KEY, jcfg), opt, batches, 2)
    path = os.path.join(tmp_path, "step_2")
    jckpt.save(path, (jp2, js2), step=2, extra={"by": "jax"})
    jp3, _, jm3 = _jax_run(jcfg, jrec.init(KEY, jcfg), opt, batches, 3)

    cfg, model = _port_model(jrec.init(KEY, jcfg))  # other weights: restore overwrites
    step, topt, params = cells.recsys_train_step(cfg, model, AdamW(lr=1e-2))
    (rp, rs), n = checkpoint.restore(path, (params, topt.init(params)), device="cpu")
    assert n == 2 and int(rs.step) == 2 and rs.step.dtype == torch.int32
    with torch.no_grad():
        for k, v in rp.items():
            params[k].copy_(v)
    params, rs, tm = step(params, rs, *(t(a[2]) for a in batches))
    np.testing.assert_allclose(float(tm["loss"]), float(jm3["loss"]), rtol=1e-5)
    assert_tree_close(params, jp3, rtol=0, atol=2e-5)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg = jwd.smoke_config()
    jparams = jrec.init(KEY, jcfg)
    cfg, model = _port_model(jparams)
    step, opt, params = cells.recsys_train_step(cfg, model, AdamW(lr=1e-2))
    state = opt.init(params)
    for i, b in enumerate(zip(*_batches(jcfg, 2, 32, seed=12))):
        params, state, _ = step(params, state, *(t(a) for a in b))
    path = os.path.join(tmp_path, "step_2")
    checkpoint.save(path, (params, state), step=2)
    like = (jparams, JAdamW().init(jparams))
    (jp, js), n = jckpt.restore(path, like)
    assert n == 2 and isinstance(js, JState) and int(js.step) == 2
    assert js.step.dtype == jnp.int32
    for got, want in ((jp, params), (js.m, state.m), (js.v, state.v)):
        want_np = {k: v.detach().numpy() for k, v in want.items()}
        for k, v in state_from_params(got, device="cpu").items():
            np.testing.assert_array_equal(v.numpy(), want_np[k], err_msg=k)


# ---------------------------------------------------------------- example


def test_example_id_stream_matches_jax():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "recsys_dedup.py")],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    lk, nu = map(int, re.search(r"id stream: (\d+) lookups, (\d+) distinct", out.stdout).groups())
    plain, cap, true_u = map(int, re.search(
        r"rows fetched: plain=(\d+)  dedup=(\d+) \(true unique (\d+)\)", out.stdout).groups())
    got = recsys_dedup.main(["--device", "cpu"])
    assert (got["lookups"], got["n_unique"], got["cap"]) == (lk, nu, cap)
    assert (got["rows_fetched_plain"], got["rows_fetched_dedup"], got["true_unique"]) == (
        plain, cap, true_u)
    for name, losses in got["losses"].items():
        assert len(losses) == recsys_dedup.STEPS and np.isfinite(losses).all(), name
        assert losses[-1] < losses[0], name


def test_train_precision_probe_on_the_cpu():
    """``bench.train_precision`` at a small vocab: fp32 against fp64 on the
    CPU, the report's numbers finite and the loss a forward's rounding."""
    rep = train_precision.run(device="cpu", vocab=256, batch=128, steps=2, log=False)
    (name, r), = rep["runs"].items()
    assert name == "fp32 cpu" and r["pre_activations"] == [128 * 1024, 128 * 512, 128 * 256]
    assert max(r["loss_rel_err"]) < 1e-5 and len(r["grad_norm_rel_err"]) == 2
    assert set(r["update_rel_err"]) == set(LEAF_ORDER)
    assert all(np.isfinite(v) for v in (*r["grad_rel_err"].values(),
                                        *r["update_rel_err"].values()))


def test_entry_points_need_a_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default runs")
    with pytest.raises(RuntimeError, match="cuda"):
        recsys_dedup.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        train_precision.main([])
    checkpoint.save(os.path.join(tmp_path, "step_0"), {"w": torch.ones(2)}, step=0)
    with pytest.raises(RuntimeError, match="cuda"):
        checkpoint.restore(os.path.join(tmp_path, "step_0"), {"w": torch.ones(2)})


# ----------------------------------------- gradients by torch.autograd.grad


def test_step_leaves_no_grad_and_no_graph():
    """The step differentiates detached copies of the leaves: parameters
    that require grad get no ``.grad``, the update stays in place, and it
    runs under an outer ``torch.no_grad()`` too."""
    w = torch.nn.Parameter(torch.zeros(4))
    params, x, y = {"w": w, "b": torch.nn.Parameter(torch.zeros(()))}, *_toy()[1:]
    opt = AdamW(lr=1e-2)
    step = make_train_step(_quad_loss, opt)
    with torch.no_grad():
        params, state, m = step(params, opt.init(params), x, y)
    assert params["w"] is w and w.grad is None and not m["loss"].requires_grad
    assert float(w.detach().abs().sum()) > 0


def test_leaf_the_loss_does_not_reach_gets_zeros():
    """As JAX's autodiff: a leaf outside the loss has a zero gradient, and
    AdamW moves it by weight decay alone."""
    params, x, y = _toy()
    params["unused"] = torch.ones(3)
    opt = AdamW(lr=1e-2, weight_decay=0.5)
    params, state, _ = make_train_step(_quad_loss, opt)(params, opt.init(params), x, y)
    assert torch.equal(state.m["unused"], torch.zeros(3))
    np.testing.assert_allclose(params["unused"].numpy(), 1 - 1e-2 * 0.5, rtol=1e-6)


def test_step_gradients_equal_torch_func():
    """``torch.autograd.grad`` over the detached leaves gives the gradients
    ``torch.func.grad`` gives, bit for bit, on Wide & Deep's loss."""
    cfg = wide_deep.smoke_config()
    model = WideDeep(cfg, device="cpu", seed=1)
    rng = np.random.default_rng(9)
    sp = t(rng.integers(0, cfg.vocab_per_field, size=(32, cfg.n_sparse, 1)).astype(np.int32))
    de = t(rng.normal(size=(32, cfg.n_dense)).astype(np.float32))
    y = t(rng.integers(0, 2, size=32).astype(np.int32))

    def loss(p):
        return bce_loss(torch.func.functional_call(model, p, (sp, de)), y)

    params = {k: v.detach() for k, v in model.named_parameters()}
    want = torch.func.grad(loss)(params)
    captured = {}

    class Capture(AdamW):
        def update(self, grads, state, p):
            captured.update(grads)
            return super().update(grads, state, p)

    opt = Capture(lr=1e-3)
    make_train_step(lambda p, *b: loss(p), opt)(dict(model.named_parameters()),
                                                opt.init(params))
    assert sorted(captured) == sorted(want)
    for k in want:
        assert torch.equal(captured[k], want[k]), k
