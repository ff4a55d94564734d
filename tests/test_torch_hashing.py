"""The port's hashing and hash set against the JAX package, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; every
output is an integer, so every comparison is exact equality.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import hashing as jhashing
from repro.core import hashset as jhashset
from repro_torch.core import hashing, hashset

SPECIAL = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 0x9E3779B9],
    dtype=np.uint32,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps torch's CPU thread pools from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(seed: int, shape) -> np.ndarray:
    """uint32 words: random, with the edge values up front."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    k = min(len(SPECIAL), flat.size)
    flat[:k] = SPECIAL[:k]
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    """The port's output (int32 patterns or int64 u32 lanes) -> uint32."""
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


@pytest.mark.parametrize("n", [1, 8, 1000])
def test_fmix32_matches_jax(n):
    w = _words(n, (n,))
    want = np.asarray(jhashing.fmix32(jnp.asarray(w)))
    np.testing.assert_array_equal(_u(hashing.fmix32(_t(w))), want)


def test_fmix32_and_combine32_take_negative_int32():
    rng = np.random.default_rng(7)
    a = rng.integers(-2**31, 2**31, size=500, dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, size=500, dtype=np.int64).astype(np.int32)
    a[:3] = [-1, -2**31, 0x7FFFFFFF]
    np.testing.assert_array_equal(
        _u(hashing.fmix32(torch.from_numpy(a))),
        np.asarray(jhashing.fmix32(jnp.asarray(a))),
    )
    np.testing.assert_array_equal(
        _u(hashing.combine32(torch.from_numpy(a), torch.from_numpy(b))),
        np.asarray(jhashing.combine32(jnp.asarray(a), jnp.asarray(b))),
    )


@pytest.mark.parametrize("n_words", [1, 2, 5])
@pytest.mark.parametrize("salt", [0, 3, 2**32, 2**32 + 7, 2**40 + 12345, -5])
def test_mix64_matches_jax(n_words, salt):
    w = _words(n_words * 100 + (salt & 0xFF), (n_words, 700))
    jhi, jlo = jhashing.mix64([jnp.asarray(r) for r in w], salt=salt)
    hi, lo = hashing.mix64([_t(r) for r in w], salt=salt)
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(lo), np.asarray(jlo))


def test_mix64_never_returns_the_empty_pair():
    hi, lo = hashing.mix64([torch.arange(200_000, dtype=torch.int32)], salt=9)
    assert not bool(((hi == hashing.EMPTY) & (lo == hashing.EMPTY)).any())
    # and the keys are distinct (the cross-lane avalanche is a bijection)
    key = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    assert torch.unique(key).numel() == 200_000


def test_triple_key_matches_jax_with_scalars():
    rng = np.random.default_rng(11)
    sv = rng.integers(0, 2**31, size=300).astype(np.int32)
    ov = rng.integers(0, 2**31, size=300).astype(np.int32)
    args = (np.int32(4), sv, np.int32(9), np.int32(0x7FFFFFFF), ov)
    jhi, jlo = jhashing.triple_key(*[jnp.asarray(a) for a in args])
    hi, lo = hashing.triple_key(
        args[0], torch.from_numpy(sv), args[2], args[3], torch.from_numpy(ov)
    )
    np.testing.assert_array_equal(_u(hi), np.asarray(jhi))
    np.testing.assert_array_equal(_u(lo), np.asarray(jlo))


def test_u32_lanes_round_trip():
    w = _words(3, (64,))
    t = _t(w)
    assert torch.equal(hashing.to_i32(hashing.u32(t)), t)
    np.testing.assert_array_equal(hashing.u32(t).numpy(), w.astype(np.int64))


# ---------------------------------------------------------------- hashset


def _keys(seed: int, n: int, n_distinct: int):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, n_distinct, size=n).astype(np.int32)
    jhi, jlo = jhashing.mix64([jnp.asarray(vals)])
    return np.asarray(jhi), np.asarray(jlo), rng


@pytest.mark.parametrize("cap,n,n_distinct", [(64, 40, 30), (1024, 600, 200), (4096, 3000, 2500)])
def test_hashset_insert_masked_matches_jax(cap, n, n_distinct):
    khi, klo, rng = _keys(cap + n, n, n_distinct)
    valid = rng.random(n) > 0.15
    jt = jhashset.make(cap)
    t = hashset.make(cap, device="cpu")
    half = n // 2
    for sl in (slice(0, half), slice(half, n)):
        jr = jhashset.insert_masked(
            jt, jnp.asarray(khi[sl]), jnp.asarray(klo[sl]), jnp.asarray(valid[sl])
        )
        r = hashset.insert_masked(
            t, _t(khi[sl]), _t(klo[sl]), torch.from_numpy(valid[sl])
        )
        np.testing.assert_array_equal(_u(r.table.hi), np.asarray(jr.table.hi))
        np.testing.assert_array_equal(_u(r.table.lo), np.asarray(jr.table.lo))
        np.testing.assert_array_equal(r.is_new.numpy(), np.asarray(jr.is_new))
        assert bool(r.overflowed) == bool(jr.overflowed)
        jt, t = jr.table, r.table
    assert int(hashset.count(t)) == int(jhashset.count(jt))
    probe_hi, probe_lo, _ = _keys(1, 500, 2 * n_distinct)
    np.testing.assert_array_equal(
        hashset.contains(t, _t(probe_hi), _t(probe_lo)).numpy(),
        np.asarray(jhashset.contains(jt, jnp.asarray(probe_hi), jnp.asarray(probe_lo))),
    )


def test_hashset_overflow_matches_jax():
    khi, klo, _ = _keys(5, 100, 10_000)
    jr = jhashset.insert(jhashset.make(32), jnp.asarray(khi), jnp.asarray(klo))
    r = hashset.insert(hashset.make(32, device="cpu"), _t(khi), _t(klo))
    assert bool(r.overflowed) and bool(jr.overflowed)
    np.testing.assert_array_equal(r.is_new.numpy(), np.asarray(jr.is_new))
    np.testing.assert_array_equal(_u(r.table.hi), np.asarray(jr.table.hi))


def test_hashset_make_defaults_to_the_card():
    import inspect

    assert inspect.signature(hashset.make).parameters["device"].default == "cuda"
    assert hashset.next_pow2(1000) == jhashset.next_pow2(1000) == 1024
