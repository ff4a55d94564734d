"""repro_torch.models (layers, Wide & Deep) against repro.models on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the JAX package's
params are made by ``recsys.init`` / ``layers.*_init`` and carried into the
port with ``convert.state_from_params``; the inputs are numpy-seeded.
Every comparison is within rtol 1e-5 and atol 1e-6 (float32 sums whose
order may differ between XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import wide_deep as jwd
from repro.models import layers as jl
from repro.models import recsys as jrec
from repro_torch.configs import registry, wide_deep
from repro_torch.convert import state_from_params
from repro_torch.models import layers as tl
from repro_torch.models.recsys import WideDeep

RTOL, ATOL = 1e-5, 1e-6
KEY = jax.random.PRNGKey(0)


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def tparams(p) -> dict:
    """A JAX layer's params as the port's dict of CPU tensors."""
    if isinstance(p, dict):
        return {k: tparams(v) for k, v in p.items()}
    return torch.from_numpy(np.array(p))


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 7, 24)).astype(np.float32)
    tx = torch.from_numpy(x)
    dp = jl.dense_init(KEY, 24, 16, jnp.float32, bias=True)
    dp["b"] = jnp.asarray(rng.normal(size=16).astype(np.float32))
    close(tl.dense(tparams(dp), tx), jl.dense(dp, x))
    mp = jl.mlp_init(KEY, (24, 32, 8), jnp.float32)
    for final in (False, True):
        close(tl.mlp(tparams(mp), tx, final_act=final), jl.mlp(mp, x, final_act=final))
    gp = jl.glu_init(KEY, 24, 40, jnp.float32)
    close(tl.glu(tparams(gp), tx), jl.glu(gp, x))
    norm = {"scale": jnp.asarray(rng.normal(size=24).astype(np.float32)),
            "bias": jnp.asarray(rng.normal(size=24).astype(np.float32))}
    close(tl.rmsnorm(tparams(norm), tx), jl.rmsnorm(norm, x))
    close(tl.layernorm(tparams(norm), tx), jl.layernorm(norm, x))
    ep = jl.embedding_init(KEY, 50, 12, jnp.float32)
    ids = rng.integers(0, 50, (3, 5)).astype(np.int32)
    close(tl.embed(tparams(ep), torch.from_numpy(ids)), jl.embed(ep, ids))


def test_inits_match_jax_shapes():
    gen = torch.Generator().manual_seed(0)
    pairs = [
        (jl.dense_init(KEY, 24, 16, jnp.float32, bias=True),
         tl.dense_init(gen, 24, 16, bias=True, device="cpu")),
        (jl.mlp_init(KEY, (24, 32, 8), jnp.float32), tl.mlp_init(gen, (24, 32, 8), device="cpu")),
        (jl.glu_init(KEY, 24, 40, jnp.float32), tl.glu_init(gen, 24, 40, device="cpu")),
        (jl.rmsnorm_init(24, jnp.float32), tl.rmsnorm_init(24, device="cpu")),
        (jl.layernorm_init(24, jnp.float32), tl.layernorm_init(24, device="cpu")),
        (jl.embedding_init(KEY, 50, 12, jnp.float32), tl.embedding_init(gen, 50, 12, device="cpu")),
    ]
    for want, got in pairs:
        flat_w, flat_g = state_from_params(want, device="cpu"), state_from_params(got, device="cpu")
        assert {k: v.shape for k, v in flat_g.items()} == {k: v.shape for k, v in flat_w.items()}
    bound = 1 / np.sqrt(24)  # dense weights are uniform in +-1/sqrt(d_in), biases 0
    w = pairs[0][1]
    assert float(w["w"].abs().max()) <= bound and not w["b"].any()


def test_modules_hold_the_functions():
    gen = torch.Generator().manual_seed(1)
    m = tl.MLP(gen, (24, 32, 8), device="cpu")
    assert sorted(dict(m.named_parameters())) == ["fc0.b", "fc0.w", "fc1.b", "fc1.w"]
    x = torch.randn(5, 24, generator=gen)
    p = {n: dict(c.named_parameters()) for n, c in m.named_children()}
    assert torch.equal(m(x), tl.mlp(p, x))


@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_matches_jax(ignore):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 6, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 6)).astype(np.int32)
    if ignore:
        labels[rng.random((3, 6)) < 0.4] = -100
    close(tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
          jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    every = np.full((3, 6), -100, np.int32)  # nothing to average: 0, not NaN
    assert float(tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(every))) == 0.0


def _pair(cfg):
    """JAX params for ``cfg`` and the port's module with the same weights."""
    params = jrec.init(KEY, cfg)
    tcfg = dataclasses.replace(
        wide_deep.smoke_config(), bag_size=cfg.bag_size, dedup_cap=cfg.dedup_cap)
    model = WideDeep(tcfg, device="cpu")
    model.load_state_dict(state_from_params(params, device="cpu"))
    return params, model


def _inputs(cfg, batch, seed, high=None):
    rng = np.random.default_rng(seed)
    sp = rng.integers(0, high or cfg.vocab_per_field,
                      (batch, cfg.n_sparse, cfg.bag_size)).astype(np.int32)
    de = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
    y = rng.integers(0, 2, batch).astype(np.int32)
    return sp, de, y


def test_configs_match_jax():
    for name in ("config", "dedup_config", "smoke_config"):
        j, t = getattr(jwd, name)(), getattr(wide_deep, name)()
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd.pop("dtype") == jnp.float32 and td.pop("dtype") == torch.float32
        assert jd == td
    assert registry.RECSYS_SHAPES == {"train_batch": 65536, "serve_p99": 512,
                                      "serve_bulk": 262144, "retrieval_cand": 1_000_000}
    assert registry.get_arch("wide-deep").config() == wide_deep.config()


@pytest.mark.parametrize("bag", [1, 3])
def test_widedeep_matches_jax(bag):
    cfg = dataclasses.replace(jwd.smoke_config(), bag_size=bag)
    params, model = _pair(cfg)
    sp, de, y = _inputs(cfg, 16, seed=bag)
    tsp, tde, ty = (torch.from_numpy(a) for a in (sp, de, y))
    with torch.no_grad():
        close(model.embedding_bag(tsp), jrec.embedding_bag(params, cfg, sp))
        close(model.wide_logit(tsp), jrec.wide_logit(params, cfg, sp))
        close(model(tsp, tde), jrec.forward(params, cfg, sp, de))
        close(model.loss(tsp, tde, ty), jrec.loss_fn(params, cfg, sp, de, y))
        close(model.user_tower(tsp, tde), jrec.user_tower(params, cfg, sp, de))
        cand = np.random.default_rng(9).normal(size=(300, cfg.mlp[-1])).astype(np.float32)
        close(model.retrieval_scores(tsp[:1], tde[:1], torch.from_numpy(cand)),
              jrec.retrieval_scores(params, cfg, sp[:1], de[:1], cand))


def test_widedeep_dedup_matches_plain():
    """As ``tests/test_archs_smoke.py::test_widedeep_dedup_matches_plain``:
    few distinct ids, a cap of 64, the same logits with and without dedup
    (and JAX's dedup logits)."""
    cfg_d = dataclasses.replace(jwd.smoke_config(), dedup_cap=64)
    params, model_d = _pair(cfg_d)
    _, model = _pair(jwd.smoke_config())
    sp, de, _ = _inputs(cfg_d, 16, seed=1, high=8)
    tsp, tde = torch.from_numpy(sp), torch.from_numpy(de)
    with torch.no_grad():
        plain, dedup = model(tsp, tde), model_d(tsp, tde)
    np.testing.assert_allclose(dedup.numpy(), plain.numpy(), rtol=RTOL)
    close(dedup, jrec.forward(params, cfg_d, sp, de))


def test_init_is_seeded_and_named_as_jax():
    cfg = wide_deep.smoke_config()
    a, b = WideDeep(cfg, device="cpu", seed=3), WideDeep(cfg, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    want = state_from_params(jrec.init(KEY, jwd.smoke_config()), device="cpu")
    got = a.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in got)
