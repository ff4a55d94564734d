"""The LM family of the port (``models/{attention,moe,transformer,
vocab_parallel}.py``, the five LM configs and registry entries,
``convert.kv_cache_from_numpy``, ``launch.train`` and the LM examples)
against the JAX package on the CPU.

JAX's params come from ``transformer.init`` and are carried into the port
with ``convert.state_from_params``; token ids are numpy-seeded.  Every
comparison is in fp32 at rtol 1e-5, atol 1e-5, unless a test states
another tolerance with its reason.  JAX's scanned layers run compiled (XLA
may contract multiply-adds); the port rounds each operation, so the two
agree to fp32 rounding, not bit for bit.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.train import checkpoint as jckpt
from repro.train.optimizer import AdamW as JAdamW
from repro.train.trainer import make_train_step as jmake_step
from repro_torch.configs import registry
from repro_torch.convert import kv_cache_from_numpy, state_from_params
from repro_torch.examples import serve_lm, train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.models.transformer import Transformer
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
ARCHS = ["qwen2.5-3b", "gemma-2b", "mixtral-8x7b", "dbrx-132b", "command-r-plus-104b"]
RTOL = ATOL = 1e-5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def jcfg(arch, **kw):
    return dataclasses.replace(jreg.get_arch(arch).smoke_config(), **kw)


def tcfg(arch, **kw):
    return dataclasses.replace(registry.get_arch(arch).smoke_config(), **kw)


@functools.lru_cache(maxsize=None)
def jparams(arch):
    return jtr.init(KEY, jcfg(arch))


def port_params(arch, cfg=None) -> dict:
    model = Transformer(cfg or tcfg(arch), device="cpu")
    model.load_state_dict(state_from_params(jparams(arch), device="cpu"))
    return model.params()


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


# ------------------------------------------------------- the five smoke configs


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch):
    """Every field of the smoke and full configs, dtype by name."""
    for get in ("config", "smoke_config"):
        want = dataclasses.asdict(getattr(jreg.get_arch(arch), get)())
        got = dataclasses.asdict(getattr(registry.get_arch(arch), get)())
        assert set(got) == set(want)
        for k in want:
            if k == "dtype":
                assert str(got[k]).removeprefix("torch.") == jnp.dtype(want[k]).name, k
            else:
                assert got[k] == want[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jc, tc = jcfg(arch), tcfg(arch)
    toks = tokens(jc, 2, 12, seed=1)
    labels = tokens(jc, 2, 12, seed=2)
    params = port_params(arch)
    with torch.no_grad():
        h = transformer.forward(tc, params, t(toks))
        loss = transformer.loss_fn(tc, params, t(toks), t(labels))
    close(h, jtr.forward(jc, jparams(arch), toks), what="hidden")
    close(loss, jtr.loss_fn(jc, jparams(arch), toks, labels), what="loss")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    jc, tc = jcfg(arch), tcfg(arch)
    toks = tokens(jc, 3, 10, seed=3)
    with torch.no_grad():
        got = transformer.prefill(tc, port_params(arch), t(toks))
    want = jtr.prefill(jc, jparams(arch), toks)
    assert tuple(got.shape) == want.shape == (3, 1, jc.vocab)
    close(got, want)


def _decode_both(arch, steps, max_len, batch=2, positions=None, seed=4):
    """``steps`` decode steps from an empty cache in both packages, the
    same token each step; -> [(port logits, JAX logits)], port cache, JAX
    cache.  ``positions`` gives each step's position (0-d or (B,)); by
    default 0, 1, ..."""
    jc, tc = jcfg(arch), tcfg(arch)
    toks = tokens(jc, batch, steps, seed=seed)
    params = port_params(arch)
    jcache = jtr.make_cache(jc, batch, max_len)
    tcache = transformer.make_cache(tc, batch, max_len, device="cpu")
    out = []
    for i in range(steps):
        p = np.int32(i) if positions is None else np.asarray(positions[i], np.int32)
        jl, jcache = jtr.decode_step(jc, jparams(arch), jcache, toks[:, i:i + 1], jnp.asarray(p))
        with torch.no_grad():
            tl, tcache = transformer.decode_step(tc, params, tcache, t(toks[:, i:i + 1]), t(p))
        out.append((tl, jl))
    return out, tcache, jcache


def _close_cache(tcache, jcache):
    for name in ("k", "v"):
        close(getattr(tcache, name), getattr(jcache, name), what=name)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    assert tcache.pos.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """6 decode steps from an empty cache: each step's logits, and the
    cache's k, v and pos after the last."""
    steps, tcache, jcache = _decode_both(arch, 6, max_len=16)
    for i, (tl, jl) in enumerate(steps):
        assert tuple(tl.shape) == jl.shape == (2, 1, jcfg(arch).vocab)
        close(tl, jl, what=f"step {i}")
    _close_cache(tcache, jcache)


def test_decode_cache_is_written_in_place():
    tc = tcfg("qwen2.5-3b")
    cache = transformer.make_cache(tc, 2, 8, device="cpu")
    ptrs = [x.data_ptr() for x in cache]
    with torch.no_grad():
        _, out = transformer.decode_step(tc, port_params("qwen2.5-3b"), cache,
                                         torch.zeros((2, 1), dtype=torch.int32),
                                         torch.tensor(0, dtype=torch.int32))
    assert [x.data_ptr() for x in out] == ptrs
    assert int((cache.pos[:, :, 0] == 0).sum()) == 2 * tc.n_layers
    assert int((cache.pos[:, :, 1:] == -1).sum()) == 2 * tc.n_layers * 7


# ------------------------------------------------------------ attention paths


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_chunked_path_matches_jax_and_dense(arch):
    """``attn_chunk`` 8 at seq 32 takes the chunked path (4 chunks; with
    mixtral's window 8, whole chunks are masked and still computed): the
    port's equals JAX's chunked path and the port's dense path."""
    jc, tc = jcfg(arch, attn_chunk=8), tcfg(arch, attn_chunk=8)
    toks = tokens(jc, 2, 32, seed=5)
    params = port_params(arch)
    with torch.no_grad():
        chunked = transformer.forward(tc, params, t(toks))
        dense = transformer.forward(tcfg(arch), params, t(toks))
    close(chunked, jtr.forward(jc, jparams(arch), toks), what="vs JAX chunked")
    close(chunked, dense, what="vs the port's dense path")


def test_chunked_sdpa_pads_a_ragged_tail():
    """T = 13 keys in chunks of 5: the padded keys (pos -1) are masked."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 13, h, 8)).astype(np.float32) for h in (4, 2, 2))
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    for window in (None, 4):
        want = jattn._chunked_sdpa(q, k, v, pos, pos, window, 0.35, 5)
        got = attention._chunked_sdpa(t(q), t(k), t(v), t(pos), t(pos), window, 0.35, 5)
        close(got, want, what=f"window {window}")


def test_mixtral_ring_wraps_past_the_window():
    """mixtral's smoke window is 8: 13 decode steps wrap the 8-slot ring."""
    steps, tcache, jcache = _decode_both("mixtral-8x7b", 13, max_len=64)
    assert tcache.k.shape[2] == 8
    for i, (tl, jl) in enumerate(steps):
        close(tl, jl, what=f"step {i}")
    _close_cache(tcache, jcache)
    np.testing.assert_array_equal(tcache.pos[0, 0].numpy(), [8, 9, 10, 11, 12, 5, 6, 7])


def test_decode_clamp_edge_matches_jax():
    """Full attention at ``position >= T`` (cache of 4 slots): JAX's
    ``dynamic_update_slice`` clamps k/v into the last slot and ``.at[].set``
    drops the pos write; a per-row (B,) position mixes in-range and
    out-of-range rows, and a negative slot counts from the end."""
    positions = [0, 1, 2, 3, 5, 9, [1, 7], [6, 2], -1]
    steps, tcache, jcache = _decode_both("qwen2.5-3b", len(positions), max_len=4,
                                         positions=positions)
    for i, (tl, jl) in enumerate(steps):
        close(tl, jl, what=f"step {i} at position {positions[i]}")
    _close_cache(tcache, jcache)


# ------------------------------------------------------------------ MoE


def _moe_case(n=16, seed=7):
    cfg = jcfg("mixtral-8x7b").moe_cfg
    lp = jax.tree.map(lambda x: x[0], jparams("mixtral-8x7b")["blocks"]["moe"])
    xt = np.random.default_rng(seed).normal(size=(n, cfg.d_model)).astype(np.float32)
    return cfg, lp, xt


def _port_moe(lp):
    return {k: (t(v) if not isinstance(v, dict) else {kk: t(vv) for kk, vv in v.items()})
            for k, v in lp.items()}


def test_moe_zero_router_ties_pick_the_lower_index():
    """A zero router gives every expert the same probability: JAX's
    ``top_k`` picks experts [0, 1] for every token, and so must the port."""
    cfg, lp, xt = _moe_case()
    lp = {**lp, "router": {"w": np.zeros_like(lp["router"]["w"])}}
    jv, ji, jaux = jmoe._route(lp, cfg, xt)
    tv, ti, taux = moe._route(_port_moe(lp), cfg, t(xt))
    np.testing.assert_array_equal(np.asarray(ji), np.tile([0, 1], (len(xt), 1)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tv, jv)
    close(taux, jaux)
    probs = torch.tensor([[0.3, 0.1, 0.3, 0.3], [0.2, 0.2, 0.2, 0.4]])
    np.testing.assert_array_equal(moe.top_k(probs, 2)[1].numpy(),
                                  np.asarray(jax.lax.top_k(probs.numpy(), 2)[1]))


def test_moe_capacity_overflow_drops_tokens():
    """16 equal tokens all route to the same two experts; cap is
    int(1.25 * 2 * 16 / 4 + 1) = 11, so tokens 11-15 are dropped (zero
    output) on both, in JAX and in the port."""
    cfg, lp, xt = _moe_case()
    xt = np.repeat(xt[:1], 16, axis=0)
    assert moe.capacity(cfg, 16) == 11
    jout, jaux = jmoe._forward_local(lp, cfg, xt[None])
    tout, taux = moe.forward(_port_moe(lp), cfg, t(xt)[None])
    close(tout, jout)
    close(taux, jaux)
    assert float(np.abs(np.asarray(jout)[0, 11:]).max()) == 0
    assert float(tout[0, 11:].abs().max()) == 0 and float(tout[0, :11].abs().min()) > 0


def test_moe_routing_and_aux_loss_match_jax():
    cfg, lp, xt = _moe_case(n=40, seed=8)
    jv, ji, jaux = jmoe._route(lp, cfg, xt)
    tv, ti, taux = moe._route(_port_moe(lp), cfg, t(xt))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    close(tv, jv)
    close(taux, jaux)
    jout, _ = jmoe._forward_local(lp, cfg, xt.reshape(4, 10, -1))
    tout, _ = moe.forward(_port_moe(lp), cfg, t(xt).reshape(4, 10, -1))
    close(tout, jout)


# ------------------------------------------------------- gemma, bf16, counts


def test_gemma_geglu_is_the_tanh_gelu():
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    got = transformer._gelu_tanh(t(x))
    close(got, jax.nn.gelu(x), rtol=1e-6, atol=1e-6)
    assert float((got - F.gelu(t(x))).abs().max()) > 1e-4  # not the erf form
    assert tcfg("gemma-2b").gated_act == "gelu"


def test_tied_embedding_scale_is_bf16_like_jax():
    """gemma at its published d_model (2048): the embedding times
    ``sqrt(d)`` rounded to bf16 first (45.25), bit-equal to JAX's."""
    cfg = dataclasses.replace(registry.get_arch("gemma-2b").config(), vocab=64)
    rng = np.random.default_rng(9)
    table = jnp.asarray(rng.normal(size=(64, cfg.d_model)) * 0.02, jnp.bfloat16)
    ids = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    want = jnp.take(table, ids, axis=0) * jnp.asarray(np.sqrt(cfg.d_model), jnp.bfloat16)
    params = {"embed": {"table": state_from_params({"t": table}, "cpu")["t"]}}
    got = transformer._embed(cfg, params, t(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    by_float = params["embed"]["table"][t(ids).long()] * float(np.sqrt(cfg.d_model))
    assert not torch.equal(by_float, got)  # a Python float scales at fp32


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_table_bit_equal_to_jax(arch):
    """The frequency table (float64 numpy, cast to fp32) and the angles at
    positions up to 524,287 are bit-equal to JAX's; the rotation itself is
    held in bf16 at the published head_dim and theta."""
    cfg = registry.get_arch(arch).config()
    d = cfg.head_dim
    freq64 = 1.0 / (cfg.rope_theta ** (np.arange(0, d // 2) * 2.0 / d))
    want = np.asarray(jnp.ones((), jnp.float32) * freq64)
    np.testing.assert_array_equal(attention.rope_freq(d, cfg.rope_theta), want)
    pos = np.array([0, 1, 4095, 32767, 524287], np.int32)
    np.testing.assert_array_equal(
        (t(pos)[:, None].float() * t(want)).numpy(),
        np.asarray(jnp.asarray(pos)[:, None].astype(jnp.float32) * freq64))
    x = jnp.asarray(np.random.default_rng(10).normal(size=(1, 5, 2, d)), jnp.bfloat16)
    got = attention.rope(state_from_params({"x": x}, "cpu")["x"], t(pos)[None], cfg.rope_theta)
    # one bf16 rounding of an fp32 rotation whose cos/sin may differ by an ulp
    close(got.float(), np.asarray(jattn.rope(x, jnp.asarray(pos)[None], cfg.rope_theta),
                                  np.float32), rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_jax(arch):
    """The published configs' counts (no allocation), and the smoke model's
    tensors against its own count, which (as JAX's) leaves out the QKV
    biases."""
    j, p = jreg.get_arch(arch).config(), registry.get_arch(arch).config()
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    if arch == "qwen2.5-3b":
        assert p.param_count() == 3_397_011_456
    model = Transformer(tcfg(arch), device="cpu")
    assert sum(x.numel() for k, x in model.named_parameters()
               if not k.endswith(".b")) == tcfg(arch).param_count()


def test_prefill_microbatch_waves_match_jax():
    """gemma's smoke config with ``microbatches=2`` at batch 4: two waves."""
    jc, tc = jcfg("gemma-2b", microbatches=2), tcfg("gemma-2b", microbatches=2)
    toks = tokens(jc, 4, 9, seed=11)
    params = port_params("gemma-2b")
    with torch.no_grad():
        got = transformer.prefill(tc, params, t(toks))
        whole = transformer.prefill(tcfg("gemma-2b"), params, t(toks))
    close(got, jtr.prefill(jc, jparams("gemma-2b"), toks))
    close(got, whole)


def test_unscanned_layers_wait_for_the_mesh_work():
    """The mesh work is in: ``scan_layers=False`` builds JAX's list of
    per-layer dicts, takes JAX's unrolled params and runs as JAX's does
    (bit-equality with the stacked layers is in ``test_torch_dryrun.py``)."""
    jc, tc = jcfg("qwen2.5-3b", scan_layers=False), tcfg("qwen2.5-3b", scan_layers=False)
    jp = jtr.init(KEY, jc)
    model = Transformer(tc, device="cpu")
    model.load_state_dict(state_from_params(jp, device="cpu"))
    assert len(model.params()["blocks"]) == tc.n_layers
    toks = tokens(tc, 2, 7, seed=3)
    with torch.no_grad():
        got = transformer.forward(tc, model.params(), t(toks))
    close(got, jtr.forward(jc, jp, toks))


def test_registry_lm_entries_equal_jax():
    for arch in ARCHS:
        j, p = jreg.get_arch(arch), registry.get_arch(arch)
        assert (p.family, p.shapes, p.skips) == (j.family, j.shapes, j.skips)
        assert p.train_shape == "train_4k"
    for name in ("LM_TRAIN", "LM_PREFILL", "LM_DECODE", "LM_LONG"):
        assert getattr(registry, name) == getattr(jreg, name)
    archs = [a for a, e in registry.ARCHS.items() if e.family != "gnn"]
    want = [c for c in jreg.list_cells() if c[0] in archs]
    assert [c for c in registry.list_cells() if c[0] in archs] == want == [
        c for c in jreg.list_cells(True) if c[0] in archs]
    assert len(want) == 24 and sum(1 for c in want if c[2]) == 4


# ------------------------------------------------------------------ training


def _loss(cfg):
    return lambda p, toks, labels: transformer.loss_fn(cfg, layers.nest(p), toks, labels)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step through both packages: loss and
    grad_norm within rtol 1e-5; each params leaf within 1e-2 of its update
    in the 2-norm.  AdamW's first step moves a parameter by about
    ``lr * g / (|g| + eps)``, so a gradient near 0, rounded apart by the
    two packages, moves its parameter by up to 2 lr: elementwise the params
    agree only to lr.  The key bias's gradient nearly cancels (a bias on k
    shifts all of a query's scores alike, up to the rotation), which makes
    its update the most sensitive: 1.5e-3 of its norm here."""
    jc, tc = jcfg(arch), tcfg(arch)
    toks, labels = tokens(jc, 2, 16, seed=12), tokens(jc, 2, 16, seed=13)
    jopt, topt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jmake_step(lambda p, a, b: jtr.loss_fn(jc, p, a, b), jopt))
    jp, _, jm = jstep(jparams(arch), jopt.init(jparams(arch)), toks, labels)
    model = Transformer(tc, device="cpu")
    model.load_state_dict(state_from_params(jparams(arch), device="cpu"))
    params = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    params, state, tm = make_train_step(_loss(tc), topt)(params, topt.init(params),
                                                         t(toks), t(labels))
    for k in ("loss", "grad_norm"):
        close(tm[k], jm[k], rtol=1e-5, atol=0, what=k)
    _close_update(params, jp, p0)


def _close_update(params, jp, p0, rtol=1e-2):
    want = state_from_params(jp, device="cpu")
    assert sorted(params) == sorted(want)
    for k, w in want.items():
        err = float((params[k].detach() - w).norm() / (w - p0[k]).norm())
        assert err <= rtol, f"{k}: {err:.3g} of the update"


def test_jax_lm_checkpoint_continues_in_the_port(tmp_path):
    """JAX trains qwen's smoke config 2 steps and saves; the port restores
    and takes step 3, which equals JAX's own step 3."""
    jc, tc = jcfg("qwen2.5-3b"), tcfg("qwen2.5-3b")
    batches = [(tokens(jc, 2, 16, seed=20 + i), tokens(jc, 2, 16, seed=30 + i))
               for i in range(3)]
    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(jmake_step(lambda p, a, b: jtr.loss_fn(jc, p, a, b), jopt))
    jp, js = jparams("qwen2.5-3b"), jopt.init(jparams("qwen2.5-3b"))
    for i, b in enumerate(batches):
        if i == 2:
            path = os.path.join(tmp_path, "step_2")
            jckpt.save(path, (jp, js), step=2)
            jp2 = jp
        jp, js, jm = jstep(jp, js, *b)

    model = Transformer(tc, device="cpu", seed=5)  # other weights: restore overwrites
    params = dict(model.named_parameters())
    p0 = state_from_params(jp2, device="cpu")
    opt = AdamW(lr=1e-3)
    (rp, rs), n = checkpoint.restore(path, (params, opt.init(params)), device="cpu")
    assert n == 2 and int(rs.step) == 2
    with torch.no_grad():
        for k, v in rp.items():
            params[k].copy_(v)
    params, rs, tm = make_train_step(_loss(tc), opt)(params, rs, *(t(a) for a in batches[2]))
    close(tm["loss"], jm["loss"], rtol=1e-5, atol=0)
    _close_update(params, jp, p0)


def test_jax_decode_cache_continues_in_the_port():
    """JAX decodes 4 steps; its cache goes through ``kv_cache_from_numpy``
    and the port decodes steps 5 and 6, as JAX's own steps 5 and 6."""
    arch = "dbrx-132b"
    jc, tc = jcfg(arch), tcfg(arch)
    toks = tokens(jc, 2, 6, seed=14)
    jcache = jtr.make_cache(jc, 2, 8)
    for i in range(4):
        _, jcache = jtr.decode_step(jc, jparams(arch), jcache, toks[:, i:i + 1], jnp.int32(i))
    tcache = kv_cache_from_numpy(*(np.asarray(x) for x in jcache), device="cpu")
    params = port_params(arch)
    for i in (4, 5):
        jl, jcache = jtr.decode_step(jc, jparams(arch), jcache, toks[:, i:i + 1], jnp.int32(i))
        with torch.no_grad():
            tl, tcache = transformer.decode_step(tc, params, tcache, t(toks[:, i:i + 1]),
                                                 torch.tensor(i, dtype=torch.int32))
        close(tl, jl, what=f"step {i}")
    _close_cache(tcache, jcache)
    with pytest.raises(ValueError, match="KV cache"):
        kv_cache_from_numpy(np.asarray(jcache.k), np.asarray(jcache.v)[..., :1],
                            np.asarray(jcache.pos), device="cpu")


def test_launch_train_fails_resumes_and_continues(tmp_path, capsys):
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--batch", "2", "--seq", "16", "--out", out, "--log-every", "1"]
    first = launch_train.main([*common, "--steps", "6", "--ckpt-every", "2",
                               "--simulate-failure-at", "3"])
    assert first["failures"] == ["simulated node failure"]
    assert len(first["losses"]) == 6 and first["step"] == 6
    assert first["losses"][-1] < first["losses"][0]
    log = capsys.readouterr().out
    assert "[train] restored step 2 after failure: simulated node failure" in log
    assert sorted(os.listdir(out)) == ["step_2", "step_4", "step_6"]
    resumed = launch_train.main([*common, "--steps", "9", "--resume", "--compress-grads"])
    assert resumed["start_step"] == 6 and len(resumed["losses"]) == 3
    assert resumed["step"] == 9 and np.isfinite(resumed["losses"]).all()
    assert f"resumed from {os.path.join(out, 'step_6')} at step 6" in capsys.readouterr().out


def test_launch_train_refuses_other_families_as_jax_does(monkeypatch):
    from repro.launch import train as jlaunch

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "wide-deep"])
    with pytest.raises(SystemExit) as jexc:
        jlaunch.main()
    with pytest.raises(SystemExit) as texc:
        launch_train.main(["--arch", "wide-deep", "--device", "cpu"])
    assert str(texc.value) == str(jexc.value) and "trains the LM family" in str(jexc.value)


# ------------------------------------------------------------------ examples


def test_train_lm_example_tiny_loss_falls():
    out = train_lm.main(["--device", "cpu", "--size", "tiny", "--steps", "30"])
    assert len(out["losses"]) == 30 and out["losses"][-1] < out["losses"][0]
    assert out["params"] == jreg.get_arch("qwen2.5-3b").smoke_config().param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_example(arch):
    """Prefill and the cache path agree (fp32, ``serve_lm.TOL``) for the
    dense archs; the MoE archs' capacity drops differ between the two, so
    their difference is reported, not checked (the token test below holds
    MoE serving to JAX)."""
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--prompt-len", "10", "--gen", "4"])
    assert out["finite"] and out["checked"] == (not out["cfg"].moe)
    if out["checked"]:
        assert out["logits_err"] <= serve_lm.TOL[torch.float32]
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["prefill_tok_s"] > 0 and out["decode_tok_s"] > 0


def test_serve_lm_greedy_tokens_equal_jax():
    """The example's serve loop on converted weights against the same loop
    through JAX's prefill, make_cache and decode_step."""
    arch = "mixtral-8x7b"
    jc, tc = jcfg(arch), tcfg(arch)
    prompts = tokens(jc, 2, 12, seed=15)
    got = serve_lm.serve(tc, port_params(arch), t(prompts), gen=5)
    first = jtr.prefill(jc, jparams(arch), prompts)
    cache = jtr.make_cache(jc, 2, 17)
    for i in range(12):
        _, cache = jtr.decode_step(jc, jparams(arch), cache, prompts[:, i:i + 1], jnp.int32(i))
    tok, want = jnp.argmax(first[:, -1], axis=-1)[:, None], []
    for i in range(5):
        logits, cache = jtr.decode_step(jc, jparams(arch), cache, tok, jnp.int32(12 + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.concatenate(want, axis=1))


def test_jax_serve_lm_example_reaches_the_query_server():
    """The JAX package's ``examples/serve_lm.py`` hands LM flags to
    ``repro.launch.serve``, now the KG query server, which refuses them
    (a fault of the reference, left as it is); the port's example serves."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "serve_lm.py"),
                          "--batch", "1", "--gen", "1"], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "unrecognized arguments: --arch mixtral-8x7b" in out.stderr


def test_lm_entry_points_need_a_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the CUDA default runs")
    for main in (serve_lm.main, train_lm.main, launch_train.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])


# ----------------------------------------- lm_train_step and per-layer remat


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_grad_accum_matches_jax(arch):
    """``lm_train_step`` (the cell's AdamW(lr=1e-4, weight_decay=0.1),
    ``grad_accum = cfg.microbatches``) with 2 microbatches in JAX's
    ``(accum, B / accum, S)`` layout against ``lm_train_cell``'s step:
    loss and grad_norm within rtol 1e-5, params as ``_close_update``."""
    from repro_torch.configs import cells

    jc, tc = jcfg(arch, microbatches=2), tcfg(arch, microbatches=2)
    toks = tokens(jc, 4, 16, seed=40).reshape(2, 2, 16)
    labels = tokens(jc, 4, 16, seed=41).reshape(2, 2, 16)
    jopt = JAdamW(lr=1e-4, weight_decay=0.1)
    jstep = jax.jit(jmake_step(lambda p, a, b: jtr.loss_fn(jc, p, a, b), jopt,
                               grad_accum=jc.microbatches))
    jp, _, jm = jstep(jparams(arch), jopt.init(jparams(arch)), toks, labels)
    model = Transformer(tc, device="cpu")
    model.load_state_dict(state_from_params(jparams(arch), device="cpu"))
    step, opt, params = cells.lm_train_step(tc, model)
    assert dataclasses.asdict(opt) == dataclasses.asdict(JAdamW(lr=1e-4, weight_decay=0.1))
    p0 = {k: v.detach().clone() for k, v in params.items()}
    params, state, tm = step(params, opt.init(params), t(toks), t(labels))
    for k in ("loss", "grad_norm"):
        close(tm[k], jm[k], rtol=1e-5, atol=0, what=k)
    _close_update(params, jp, p0)
    assert int(state.step) == 1 and params["embed.table"] is model.embed.table


def _lm_grads(arch, remat):
    cfg = tcfg(arch, remat=remat)
    model = Transformer(cfg, device="cpu", seed=2)
    toks, labels = tokens(cfg, 2, 12, seed=42), tokens(cfg, 2, 12, seed=43)
    xs = {k: p.detach().requires_grad_() for k, p in model.named_parameters()}
    loss = transformer.loss_fn(cfg, layers.nest(xs), t(toks), t(labels))
    return loss, torch.autograd.grad(loss, list(xs.values()), allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_remat_on_and_off_bit_equal(arch):
    """Per-layer remat recomputes each block with the same operations: the
    loss and every gradient are bit-equal to a run that keeps them."""
    (l1, g1), (l2, g2) = _lm_grads(arch, True), _lm_grads(arch, False)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2, strict=True))


@pytest.mark.parametrize("remat,grad,runs", [(True, True, 2), (False, True, 1),
                                             (True, False, 1)])
def test_lm_remat_recomputes_each_block(monkeypatch, remat, grad, runs):
    """With ``cfg.remat`` and grad enabled each block runs again in the
    backward pass; without remat, or under no_grad (serving), once."""
    calls = []
    real = transformer._block_forward
    monkeypatch.setattr(transformer, "_block_forward",
                        lambda *a: calls.append(1) or real(*a))
    cfg = tcfg("qwen2.5-3b", remat=remat)
    model = Transformer(cfg, device="cpu")
    toks = t(tokens(cfg, 1, 8))
    if grad:
        loss = transformer.loss_fn(cfg, model.params(), toks, toks)
        loss.backward()
    else:
        with torch.no_grad():
            transformer.loss_fn(cfg, model.params(), toks, toks)
    assert len(calls) == runs * cfg.n_layers


def test_lm_train_step_checks_widths():
    from repro_torch.configs import cells

    model = Transformer(tcfg("qwen2.5-3b"), device="cpu")
    with pytest.raises(ValueError, match="d_model"):
        cells.lm_train_step(tcfg("qwen2.5-3b", d_model=32), model)
