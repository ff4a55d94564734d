"""The port's kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel in interpret mode and against the
JAX oracles, on the same numpy inputs, with exact equality.  The CUDA
kernels against the plain versions on the card are in
``test_torch_cuda.py``.
"""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import hashing as jhashing
from repro.core import naive as jnaive
from repro.core import pjtt as jpjtt
from repro.core import ptt as jptt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bucket_dedup import bucket_dedup as jbucket_dedup
from repro.kernels.hash_mix import hash_mix as jhash_mix
from repro_torch import convert
from repro_torch.core import naive, pjtt, ptt
from repro_torch.kernels import _build, bucket_dedup, hash_mix, ops, ref

u32 = convert.u32_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps torch's CPU thread pools from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return convert.u32_tensor(np.asarray(a), device="cpu")


def _keys(seed: int, shape, n_distinct: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, n_distinct, size=int(np.prod(shape))).astype(np.int32)
    hi, lo = jhashing.mix64([jnp.asarray(vals)])
    return (np.array(hi).reshape(shape), np.array(lo).reshape(shape), rng)


# ---------------------------------------------------------------- hash_mix


@pytest.mark.parametrize("n_words", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 7, 4097])
def test_hash_mix_matches_pallas_interpret(n_words, n):
    rng = np.random.default_rng(n_words * 1000 + n)
    words = rng.integers(-2**31, 2**31, size=(n_words, n), dtype=np.int64).astype(np.int32)
    words[:, 0] = -1
    jhi, jlo = jhash_mix(jnp.asarray(words), salt=3, interpret=True)
    hash_mix.launches = 0
    hi, lo = ops.fused_hash_mix(torch.from_numpy(words), salt=3)
    assert hash_mix.launches == 0  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(u32(hi), np.asarray(jhi))
    np.testing.assert_array_equal(u32(lo), np.asarray(jlo))


@pytest.mark.parametrize("salt", [0, 2**32 + 1, -3])
def test_hash_mix_ref_matches_jax_ref(salt):
    rng = np.random.default_rng(salt & 0xFFFF)
    words = rng.integers(0, 2**31, size=(5, 999)).astype(np.int32)
    jhi, jlo = jref.hash_mix_ref([jnp.asarray(w) for w in words], salt=salt)
    hi, lo = ref.hash_mix_ref([torch.from_numpy(w) for w in words], salt=salt)
    np.testing.assert_array_equal(u32(hi), np.asarray(jhi))
    np.testing.assert_array_equal(u32(lo), np.asarray(jlo))


def test_hash_mix_rejects_bad_shapes():
    with pytest.raises(ValueError):
        hash_mix.hash_mix(torch.zeros(9, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        hash_mix.hash_mix(torch.zeros(4, dtype=torch.int32))


# ------------------------------------------------------------ bucket_dedup


BUCKET_CASES = {
    # name: (n_parts, part_len, cap, n_distinct, valid fraction, prefill)
    "empty_table": (4, 256, 1024, 300, 0.8, False),
    "prefilled": (8, 128, 512, 400, 0.9, True),
    "one_partition": (1, 1000, 2048, 700, 1.0, True),
    "overflow": (2, 200, 64, 10_000, 1.0, False),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucket_dedup_plain_matches_pallas_and_refs(case):
    n_parts, part_len, cap, n_distinct, vfrac, prefill = BUCKET_CASES[case]
    khi, klo, rng = _keys(len(case), (n_parts, part_len), n_distinct)
    valid = rng.random((n_parts, part_len)) < vfrac
    if case == "empty_table":  # a valid lane whose key is the EMPTY pair
        khi[0, 5] = klo[0, 5] = 0xFFFFFFFF
    thi = np.full((n_parts, cap), 0xFFFFFFFF, np.uint32)
    tlo = thi.copy()
    if prefill:
        phi, plo, _ = _keys(99, (n_parts, part_len // 2), n_distinct)
        thi, tlo, _, _ = (np.asarray(a) for a in jbucket_dedup(
            jnp.asarray(phi), jnp.asarray(plo), jnp.ones(phi.shape, bool),
            jnp.asarray(thi), jnp.asarray(tlo), interpret=True))
    j_thi, j_tlo, j_new, j_ovf = (np.asarray(a) for a in jbucket_dedup(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid),
        jnp.asarray(thi), jnp.asarray(tlo), interpret=True))
    r_thi, r_tlo, r_new = (np.asarray(a) for a in jref.bucket_dedup_ref(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(thi), jnp.asarray(tlo),
        jnp.asarray(valid)))

    p_thi, p_tlo = _t(thi), _t(tlo)
    out = bucket_dedup.bucket_dedup(_t(khi), _t(klo), torch.from_numpy(valid), p_thi, p_tlo)
    assert out[0] is p_thi  # the table is updated in place
    o_thi, o_tlo, o_new = ref.bucket_dedup_ref(
        _t(khi), _t(klo), _t(thi), _t(tlo), torch.from_numpy(valid))
    for got in ((out[0], out[1], out[2]), (o_thi, o_tlo, o_new)):
        np.testing.assert_array_equal(u32(got[0]), j_thi)
        np.testing.assert_array_equal(u32(got[1]), j_tlo)
        np.testing.assert_array_equal(got[2].numpy(), j_new)
        np.testing.assert_array_equal(got[2].numpy(), r_new)
    np.testing.assert_array_equal(u32(out[0]), r_thi)
    np.testing.assert_array_equal(out[3].numpy(), j_ovf)
    assert bool(j_ovf.any()) == (case == "overflow")


def test_bucket_dedup_plain_reports_its_work():
    khi, klo, _ = _keys(3, (2, 64), 50)
    stats = {}
    thi = torch.full((2, 128), -1, dtype=torch.int32)
    bucket_dedup.bucket_dedup_plain(
        _t(khi), _t(klo), torch.ones(2, 64, dtype=torch.bool), thi, thi.clone(), stats)
    assert stats["rounds"] >= 1 and stats["probes"] >= 128
    # the table started empty, so the sectors written are those now occupied
    occupied = torch.nonzero(thi.view(-1) != -1).view(-1)
    assert stats["write_sectors"] == len(torch.unique(occupied // 8))
    assert stats["write_sectors"] <= stats["read_sectors"] <= 2 * 128 // 8


def test_bucket_dedup_slice_matches_the_cuda_source():
    src = (_build.CSRC / "bucket_dedup.cu").read_text()
    assert re.search(r"constexpr int kSlice = (\d+);", src).group(1) == str(bucket_dedup.SLICE)


def test_bucket_dedup_rejects_a_table_that_does_not_fit():
    k = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        bucket_dedup.bucket_dedup(k, k, k.bool(), torch.zeros(3, 16, dtype=torch.int32),
                                  torch.zeros(3, 16, dtype=torch.int32))


# ------------------------------------------------------ radix_dedup_insert


@pytest.mark.parametrize("n_parts", [1, 4])
@pytest.mark.parametrize("n,n_distinct", [(64, 16), (1000, 500), (3000, 200)])
def test_radix_dedup_insert_matches_jax(n_parts, n, n_distinct):
    khi, klo, rng = _keys(n * n_parts + n_distinct, (n,), n_distinct)
    valid = rng.random(n) > 0.1
    jt = jops.make_radix_table(4 * n, n_parts)
    t = ops.make_radix_table(4 * n, n_parts, device="cpu")
    assert tuple(t.hi.shape) == tuple(jt.hi.shape)
    half = n // 2
    for sl in (slice(0, half), slice(half, n)):
        jt, j_new, j_ovf = jops.radix_dedup_insert(
            jt, jnp.asarray(khi[sl]), jnp.asarray(klo[sl]), jnp.asarray(valid[sl]))
        t, new, ovf = ops.radix_dedup_insert(
            t, _t(khi[sl]), _t(klo[sl]), torch.from_numpy(valid[sl]))
        np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
        np.testing.assert_array_equal(u32(t.hi), np.asarray(jt.hi))
        np.testing.assert_array_equal(u32(t.lo), np.asarray(jt.lo))
        assert bool(ovf) == bool(j_ovf)


def test_radix_insert_continues_a_table_jax_filled():
    """JAX inserts the first batch; convert carries its table across; the
    port inserts the second batch exactly as JAX does."""
    n, n_parts = 2000, 4
    khi, klo, rng = _keys(21, (n,), 900)
    valid = rng.random(n) > 0.05
    jt = jops.make_radix_table(4 * n, n_parts)
    jt, _, _ = jops.radix_dedup_insert(
        jt, jnp.asarray(khi[:1000]), jnp.asarray(klo[:1000]), jnp.asarray(valid[:1000]))
    t = convert.radix_table_from_numpy(np.asarray(jt.hi), np.asarray(jt.lo), device="cpu")
    jt, j_new, j_ovf = jops.radix_dedup_insert(
        jt, jnp.asarray(khi[1000:]), jnp.asarray(klo[1000:]), jnp.asarray(valid[1000:]))
    t, new, ovf = ops.radix_dedup_insert(
        t, _t(khi[1000:]), _t(klo[1000:]), torch.from_numpy(valid[1000:]))
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(u32(t.hi), np.asarray(jt.hi))
    np.testing.assert_array_equal(u32(t.lo), np.asarray(jt.lo))
    assert not bool(ovf) and not bool(j_ovf)


def test_radix_bin_overflow_matches_jax():
    """One partition, more distinct keys than the table holds: overflow."""
    khi, klo, _ = _keys(8, (300,), 10**6)
    jt, j_new, j_ovf = jops.radix_dedup_insert(
        jops.make_radix_table(64, 1), jnp.asarray(khi), jnp.asarray(klo), jnp.ones(300, bool))
    t, new, ovf = ops.radix_dedup_insert(
        ops.make_radix_table(64, 1, device="cpu"), _t(khi), _t(klo),
        torch.ones(300, dtype=torch.bool))
    assert bool(ovf) and bool(j_ovf)
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))


def test_convert_round_trips_a_hashset():
    hi = np.array([0, 0x80000000, 0xFFFFFFFF], np.uint32)
    hs = convert.hashset_from_numpy(hi, hi[::-1], device="cpu")
    np.testing.assert_array_equal(u32(hs.hi), hi)
    assert hs.hi.dtype == torch.int32 and int(hs.lo[0]) == -1


# ---------------------------------------------------------- sort_dedup


@pytest.mark.parametrize("n,n_distinct", [(1, 1), (500, 40), (4000, 3000)])
def test_sort_dedup_masked_matches_jax(n, n_distinct):
    khi, klo, rng = _keys(n, (n,), n_distinct)
    valid = rng.random(n) > 0.2
    j = jnaive.sort_dedup_masked(jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(valid))
    r = naive.sort_dedup_masked(_t(khi), _t(klo), torch.from_numpy(valid))
    np.testing.assert_array_equal(r.uniq_mask.numpy(), np.asarray(j.uniq_mask))
    assert int(r.n_unique) == int(j.n_unique)
    j = jnaive.sort_dedup(jnp.asarray(khi), jnp.asarray(klo))
    r = naive.sort_dedup(_t(khi), _t(klo))
    np.testing.assert_array_equal(r.uniq_mask.numpy(), np.asarray(j.uniq_mask))


# --------------------------------------------------------------- pjtt


@pytest.mark.parametrize("n_parent,n_child,n_keys", [(1, 5, 3), (300, 200, 40), (2000, 1500, 600)])
def test_pjtt_sorted_matches_jax(n_parent, n_child, n_keys):
    rng = np.random.default_rng(n_parent + n_child)
    pk = rng.integers(0, n_keys, size=n_parent).astype(np.int32)
    ps = rng.integers(0, 50, size=n_parent).astype(np.int32)  # duplicate pairs too
    ck = rng.integers(0, n_keys + 5, size=n_child).astype(np.int32)
    jidx = jpjtt.build_sorted(jnp.asarray(pk), jnp.asarray(ps))
    idx = pjtt.build_sorted(torch.from_numpy(pk), torch.from_numpy(ps))
    np.testing.assert_array_equal(idx.skeys.numpy(), np.asarray(jidx.skeys))
    np.testing.assert_array_equal(idx.ssubj.numpy(), np.asarray(jidx.ssubj))
    K = int(np.bincount(pk).max())
    for k in (K, max(K - 1, 1)):
        jp = jpjtt.probe_sorted(jidx, jnp.asarray(ck), k)
        p = pjtt.probe_sorted(idx, torch.from_numpy(ck), k)
        np.testing.assert_array_equal(p.valid.numpy(), np.asarray(jp.valid))
        np.testing.assert_array_equal(p.subjects.numpy(), np.asarray(jp.subjects))
        assert bool(p.truncated) == bool(jp.truncated)
    # a PJTT that JAX built, carried across
    carried = convert.pjtt_sorted_from_numpy(np.asarray(jidx.skeys), np.asarray(jidx.ssubj), "cpu")
    p = pjtt.probe_sorted(carried, torch.from_numpy(ck), K)
    np.testing.assert_array_equal(p.subjects.numpy(),
                                  np.asarray(jpjtt.probe_sorted(jidx, jnp.asarray(ck), K).subjects))


# ---------------------------------------------------------------- ptt


def test_ptt_insert_triples_matches_jax():
    rng = np.random.default_rng(4)
    sv = rng.integers(0, 300, size=2000).astype(np.int32)
    ov = rng.integers(0, 4, size=2000).astype(np.int32)
    valid = rng.random(2000) > 0.1
    jp = jptt.make(1200)
    p = ptt.make(1200, device="cpu")
    for sl in (slice(0, 700), slice(700, 2000)):
        jr = jptt.insert_triples(jp, 3, jnp.asarray(sv[sl]), 7, 5, jnp.asarray(ov[sl]),
                                 jnp.asarray(valid[sl]))
        r = ptt.insert_triples(p, 3, torch.from_numpy(sv[sl]), 7, 5,
                               torch.from_numpy(ov[sl]), torch.from_numpy(valid[sl]))
        np.testing.assert_array_equal(r.is_new.numpy(), np.asarray(jr.is_new))
        jp, p = jr.ptt, r.ptt
    assert int(ptt.distinct_count(p)) == int(jptt.distinct_count(jp))


def test_ptt_partitions_fit_one_cta():
    assert ptt.n_parts_for(1 << 21) == 128  # a 1M-row predicate
    assert ptt.make_capacity(1 << 21, device="cpu").table.hi.shape == (128, bucket_dedup.SLICE)
    assert ptt.make_capacity(1024, device="cpu").table.hi.shape == (1, 1024)


# ------------------------------------------------------------- the build


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_build_caches_by_source_hash(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    a, b = _build._target("hash_mix"), _build._target("bucket_dedup")
    assert a.parent == tmp_path and a.name.startswith("libhash_mix-") and a != b
