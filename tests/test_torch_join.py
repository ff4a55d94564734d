"""The port's joins and operators against the JAX package.

The nested-loop join (K3's plain version, which a wrapper runs for a CPU
tensor) against the Pallas kernel in interpret mode and the JAX oracle; the
hash PJTT against JAX's tables and probes; the SOM/ORM/OJM operators and
their naive counterparts against ``repro.core.operators``.  Inputs are made
with numpy from a seed; every output is an integer, so every comparison is
exact equality.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import naive as jnaive
from repro.core import operators as joperators
from repro.core import pjtt as jpjtt
from repro.core import ptt as jptt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import naive, operators, pjtt, ptt
from repro_torch.kernels import nested_join, ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps torch's CPU thread pools from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _join_inputs(m, n, n_keys, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, n_keys, size=n).astype(np.int32)
    ps = rng.integers(0, 10**6, size=n).astype(np.int32)
    ck = rng.integers(0, n_keys + 3, size=m).astype(np.int32)
    return pk, ps, ck


# ------------------------------------------------------------- nested_join


@pytest.mark.parametrize("m,n", [(10, 10), (300, 100), (1000, 2000), (257, 1025)])
@pytest.mark.parametrize("n_keys", [5, 50])
def test_nested_join_plain_matches_pallas_interpret_and_ref(m, n, n_keys):
    pk, ps, ck = _join_inputs(m, n, n_keys, m + n + n_keys)
    K = int(max(np.bincount(pk, minlength=n_keys).max(), 1))
    for k in (K, max(K // 2, 1)):  # the full span, and truncated
        j_subj, j_valid, j_trunc = jops.blocked_nested_join(
            jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(ck), k, interpret=True)
        r_subj, r_valid = jref.nested_join_ref(
            jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(ck), k)
        nested_join.launches = 0
        subj, valid, trunc = ops.blocked_nested_join(_t(pk), _t(ps), _t(ck), k)
        assert nested_join.launches == 0  # a CPU tensor runs the plain version
        o_subj, o_valid = ref.nested_join_ref(_t(pk), _t(ps), _t(ck), k)
        for s, v in ((subj, valid), (o_subj, o_valid)):
            np.testing.assert_array_equal(s.numpy(), np.asarray(j_subj))
            np.testing.assert_array_equal(v.numpy(), np.asarray(j_valid))
            np.testing.assert_array_equal(s.numpy(), np.asarray(r_subj))
            np.testing.assert_array_equal(v.numpy(), np.asarray(r_valid))
        spans = np.bincount(pk, minlength=n_keys + 3)[ck]
        assert bool(trunc) == bool(j_trunc) == bool((spans > k).any())


def test_nested_join_truncation_flag():
    pk = np.zeros(64, np.int32)  # all the same key
    ps = np.arange(64, dtype=np.int32)
    ck = np.zeros(4, np.int32)
    _, _, j_trunc = jops.blocked_nested_join(
        jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(ck), 8, interpret=True)
    subj, valid, trunc = nested_join.nested_join(_t(pk), _t(ps), _t(ck), 8)
    assert bool(trunc) and bool(j_trunc)
    assert subj.tolist() == [list(range(8))] * 4 and bool(valid.all())


def test_nested_join_keeps_parent_order():
    """Each row lists its matches in parent index order, as the naive
    engine's lane order (and so its N-Triples) depends on it."""
    rng = np.random.default_rng(7)
    pk = rng.permutation(np.repeat(np.arange(20), 9)).astype(np.int32)
    ps = rng.permutation(len(pk)).astype(np.int32)
    ck = rng.integers(0, 25, size=150).astype(np.int32)
    subj, valid, trunc = nested_join.nested_join(_t(pk), _t(ps), _t(ck), 9)
    assert not bool(trunc)
    for i, key in enumerate(ck.tolist()):
        want = ps[pk == key].tolist()
        assert subj[i][valid[i]].tolist() == want
        assert subj[i][len(want):].tolist() == [-1] * (9 - len(want))


@pytest.mark.parametrize("m,n", [(0, 5), (5, 0), (0, 0), (1, 1)])
def test_nested_join_empty_sides(m, n):
    pk, ps, ck = _join_inputs(m, n, 2, 3)
    subj, valid, trunc = nested_join.nested_join(_t(pk), _t(ps), _t(ck), 1)
    assert subj.shape == valid.shape == (m, 1) and subj.dtype == torch.int32
    want = [[int(ps[0]) if n and c == pk[0] else -1] for c in ck.tolist()]
    assert subj.tolist() == want and valid.tolist() == [[w[0] != -1] for w in want]
    assert not bool(trunc)


def test_nested_join_plain_blocks_do_not_change_the_result(monkeypatch):
    pk, ps, ck = _join_inputs(777, 300, 40, 11)
    whole = nested_join.nested_join_plain(_t(pk), _t(ps), _t(ck), 12)
    monkeypatch.setattr(nested_join, "PLAIN_BLOCK_PAIRS", 300 * 7)  # 7 rows a block
    blocked = nested_join.nested_join_plain(_t(pk), _t(ps), _t(ck), 12)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_nested_join_rejects_bad_inputs():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        nested_join.nested_join(k, k, k, 0)
    with pytest.raises(ValueError):
        nested_join.nested_join(k, k[:3], k, 2)
    with pytest.raises(ValueError):
        nested_join.nested_join(k.view(2, 2), k.view(2, 2), k, 2)


@pytest.mark.parametrize("m,n,n_keys", [(1, 1, 1), (500, 300, 30), (1500, 2500, 400)])
def test_nested_loop_join_matches_jax(m, n, n_keys):
    pk, ps, ck = _join_inputs(m, n, n_keys, 5 * m + n)
    K = int(max(np.bincount(pk, minlength=n_keys).max(), 1))
    j = jnaive.nested_loop_join(jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(ck), K)
    r = naive.nested_loop_join(_t(pk), _t(ps), _t(ck), K)
    assert isinstance(r, naive.NestedJoinResult)
    np.testing.assert_array_equal(r.subjects.numpy(), np.asarray(j.subjects))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(j.valid))
    assert bool(r.truncated) == bool(j.truncated)


# ----------------------------------------------------------- hash PJTT


def _pjtt_inputs(n_parent, n_child, n_keys, seed):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, n_keys, size=n_parent).astype(np.int32)
    ps = rng.integers(0, 50, size=n_parent).astype(np.int32)  # duplicate pairs too
    ck = rng.integers(0, n_keys + 5, size=n_child).astype(np.int32)
    return pk, ps, ck


def _assert_hash_equal(idx, jidx):
    for name in ("tkey", "tstart", "tcount", "ssubj"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(jidx, name)), err_msg=name)


@pytest.mark.parametrize("n_parent,n_child,n_keys", [
    (1, 5, 3), (300, 200, 40), (2000, 1500, 600), (3000, 100, 3000)])
def test_pjtt_hash_matches_jax(n_parent, n_child, n_keys):
    pk, ps, ck = _pjtt_inputs(n_parent, n_child, n_keys, n_parent + n_keys)
    jidx = jpjtt.build_hash(jnp.asarray(pk), jnp.asarray(ps))
    idx = pjtt.build_hash(_t(pk), _t(ps))
    _assert_hash_equal(idx, jidx)
    K = int(np.bincount(pk).max())
    for k in (K, max(K - 1, 1)):
        jp = jpjtt.probe_hash(jidx, jnp.asarray(ck), k)
        p = pjtt.probe_hash(idx, _t(ck), k)
        np.testing.assert_array_equal(p.subjects.numpy(), np.asarray(jp.subjects))
        np.testing.assert_array_equal(p.valid.numpy(), np.asarray(jp.valid))
        assert bool(p.truncated) == bool(jp.truncated)
    # the hash probe finds what the sorted probe finds
    s = pjtt.probe_sorted(pjtt.build_sorted(_t(pk), _t(ps)), _t(ck), K)
    p = pjtt.probe_hash(idx, _t(ck), K)
    assert torch.equal(p.subjects[p.valid], s.subjects[s.valid])


def test_probe_hash_of_a_pjtt_jax_built():
    """JAX builds the hash PJTT; convert carries it across; the port's
    probe answers as JAX's does."""
    pk, ps, ck = _pjtt_inputs(1200, 900, 300, 2)
    jidx = jpjtt.build_hash(jnp.asarray(pk), jnp.asarray(ps))
    carried = convert.pjtt_hash_from_numpy(
        *(np.asarray(a) for a in (jidx.tkey, jidx.tstart, jidx.tcount, jidx.ssubj)),
        device="cpu")
    K = int(np.bincount(pk).max())
    jp = jpjtt.probe_hash(jidx, jnp.asarray(ck), K)
    p = pjtt.probe_hash(carried, _t(ck), K)
    np.testing.assert_array_equal(p.subjects.numpy(), np.asarray(jp.subjects))
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(jp.valid))


def test_pjtt_hash_drops_keys_without_a_slot_as_jax_does(monkeypatch):
    """With one probe round most keys find no slot; both packages leave
    them out of the table silently, and probes of them find nothing."""
    monkeypatch.setattr(jpjtt, "MAX_PROBE_ROUNDS", 1)
    monkeypatch.setattr(pjtt, "MAX_PROBE_ROUNDS", 1)
    pk, ps, ck = _pjtt_inputs(500, 400, 400, 9)
    jidx = jpjtt.build_hash(jnp.asarray(pk), jnp.asarray(ps))
    idx = pjtt.build_hash(_t(pk), _t(ps))
    _assert_hash_equal(idx, jidx)
    assert int((idx.tkey != -1).sum()) < len(np.unique(pk))  # some were dropped
    jp = jpjtt.probe_hash(jidx, jnp.asarray(ck), 8)
    p = pjtt.probe_hash(idx, _t(ck), 8)
    np.testing.assert_array_equal(p.valid.numpy(), np.asarray(jp.valid))


# ------------------------------------------------------------- operators

P = (1, 2, 3)  # subject template, predicate and object template ids


def _params():
    return joperators.StaticTripleParams(*P), operators.StaticTripleParams(*P)


@pytest.mark.parametrize("op", ["som", "orm"])
def test_som_and_orm_match_jax(op):
    rng = np.random.default_rng(0)
    subj = rng.integers(0, 50, 500).astype(np.int32)
    obj = rng.integers(0, 20, 500).astype(np.int32)
    jp, p = _params()
    jr = getattr(joperators, op)(jptt.make(600), jnp.asarray(subj), jnp.asarray(obj), jp)
    r = getattr(operators, op)(ptt.make(600, device="cpu"), _t(subj), _t(obj), p)
    np.testing.assert_array_equal(r.is_new.numpy(), np.asarray(jr.is_new))
    assert bool(r.overflowed) == bool(jr.overflowed) is False
    assert int(r.is_new.sum()) == len(set(zip(subj.tolist(), obj.tolist())))


@pytest.mark.parametrize("strategy", ["sorted", "hash"])
def test_ojm_matches_jax_and_the_nested_loop(strategy):
    rng = np.random.default_rng(1)
    pk = rng.integers(0, 20, 200).astype(np.int32)
    psub = rng.integers(0, 500, 200).astype(np.int32)
    ck = rng.integers(0, 22, 150).astype(np.int32)
    csub = rng.integers(0, 100, 150).astype(np.int32)
    K = int(np.bincount(pk).max()) + 1
    jp, p = _params()
    jidx = getattr(jpjtt, f"build_{strategy}")(jnp.asarray(pk), jnp.asarray(psub))
    idx = getattr(pjtt, f"build_{strategy}")(_t(pk), _t(psub))
    jr = joperators.ojm(jptt.make(200 * K), jidx, jnp.asarray(csub), jnp.asarray(ck), jp, K)
    r = operators.ojm(ptt.make(200 * K, device="cpu"), idx, _t(csub), _t(ck), p, K)
    for name in ("is_new", "subjects", "valid"):
        np.testing.assert_array_equal(getattr(r, name).numpy(), np.asarray(getattr(jr, name)))
    assert bool(r.truncated) == bool(jr.truncated) is False
    n_opt = int((r.is_new & r.valid).sum())

    keys, subjects, trunc = operators.naive_ojm_keys(_t(pk), _t(psub), _t(csub), _t(ck), p, K)
    assert not bool(trunc)
    assert int(operators.naive_dedup(keys).n_unique) == n_opt
    pairs = {(s, q) for k, s in zip(ck.tolist(), csub.tolist())
             for kk, q in zip(pk.tolist(), psub.tolist()) if kk == k}
    assert n_opt == len(pairs)


def test_naive_som_keys_and_dedup_match_jax():
    rng = np.random.default_rng(2)
    subj = rng.integers(0, 50, 700).astype(np.int32)
    obj = rng.integers(0, 20, 700).astype(np.int32)
    jp, p = _params()
    jk = joperators.naive_som_keys(jnp.asarray(subj), jnp.asarray(obj), jp)
    k = operators.naive_som_keys(_t(subj), _t(obj), p)
    np.testing.assert_array_equal(convert.u32_numpy(k.key_hi), np.asarray(jk.key_hi))
    np.testing.assert_array_equal(convert.u32_numpy(k.key_lo), np.asarray(jk.key_lo))
    np.testing.assert_array_equal(k.valid.numpy(), np.asarray(jk.valid))
    jd, d = joperators.naive_dedup(jk), operators.naive_dedup(k)
    np.testing.assert_array_equal(d.uniq_mask.numpy(), np.asarray(jd.uniq_mask))
    assert int(d.n_unique) == int(jd.n_unique) == len(set(zip(subj.tolist(), obj.tolist())))


def test_naive_ojm_keys_match_jax():
    pk, ps, ck = _join_inputs(400, 300, 30, 4)
    csub = np.random.default_rng(5).integers(0, 90, 400).astype(np.int32)
    K = int(np.bincount(pk).max())
    jp, p = _params()
    jk, jsubj, jtrunc = joperators.naive_ojm_keys(
        jnp.asarray(pk), jnp.asarray(ps), jnp.asarray(csub), jnp.asarray(ck), jp, K)
    k, subj, trunc = operators.naive_ojm_keys(_t(pk), _t(ps), _t(csub), _t(ck), p, K)
    np.testing.assert_array_equal(subj.numpy(), np.asarray(jsubj))
    np.testing.assert_array_equal(convert.u32_numpy(k.key_hi), np.asarray(jk.key_hi))
    np.testing.assert_array_equal(convert.u32_numpy(k.key_lo), np.asarray(jk.key_lo))
    np.testing.assert_array_equal(k.valid.numpy(), np.asarray(jk.valid))
    assert bool(trunc) == bool(jtrunc) is False
    np.testing.assert_array_equal(operators.naive_dedup(k).uniq_mask.numpy(),
                                  np.asarray(joperators.naive_dedup(jk).uniq_mask))
