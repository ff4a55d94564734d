"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips on a host without an
NVIDIA card (a CUDA kernel has no CPU mode).  The file imports neither JAX
nor the JAX package, so it also runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hashing, ptt
from repro_torch.core.executor import create_kg
from repro_torch.kernels import bucket_dedup, hash_mix, ops
from repro_torch.rml import generator

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _keys(seed, shape, n_distinct, device):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(
        rng.integers(0, n_distinct, size=int(np.prod(shape))).astype(np.int32))
    hi, lo = hashing.mix64([vals.to(device)])
    return hi.view(shape), lo.view(shape), rng


@pytest.mark.parametrize("n", [1, 4097, 65536])
def test_hash_mix_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    words = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(5, n), dtype=np.int64).astype(np.int32)).to(dev)
    for salt in (0, 2**33 + 1, -3):
        before = hash_mix.launches
        hi, lo = hash_mix.hash_mix(words, salt)
        assert hash_mix.launches == before + 1
        phi, plo = hash_mix.hash_mix_plain(words, salt)
        assert torch.equal(hi, phi) and torch.equal(lo, plo)


@pytest.mark.parametrize("n_parts,part_len,cap,n_distinct,vfrac", [
    (4, 256, 1024, 300, 0.8),       # empty table
    (128, 2048, 16384, 16384, 0.95),  # the 1M-row SOM shape
    (2, 200, 64, 10_000, 1.0),      # overflow
])
def test_bucket_dedup_kernel_matches_plain(dev, n_parts, part_len, cap, n_distinct, vfrac):
    khi, klo, rng = _keys(part_len, (n_parts, part_len), n_distinct, dev)
    valid = torch.from_numpy(rng.random((n_parts, part_len)) < vfrac).to(dev)
    t = torch.full((n_parts, cap), -1, dtype=torch.int32, device=dev)
    k = bucket_dedup.bucket_dedup(khi, klo, valid, t.clone(), t.clone())
    p = bucket_dedup.bucket_dedup_plain(khi, klo, valid, t.clone(), t.clone())
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool(k[3].any()) == (cap == 64)


def test_radix_insert_on_card_matches_cpu(dev):
    hi, lo, rng = _keys(1, (65536,), 16384, dev)
    valid = torch.from_numpy(rng.random(65536) > 0.05).to(dev)
    g = ptt.make_capacity(1 << 21, device=dev).table
    c = ptt.make_capacity(1 << 21, device="cpu").table
    for sl in (slice(0, 30000), slice(30000, 65536)):
        g, gn, go = ops.radix_dedup_insert(g, hi[sl], lo[sl], valid[sl])
        c, cn, co = ops.radix_dedup_insert(c, hi[sl].cpu(), lo[sl].cpu(), valid[sl].cpu())
        assert torch.equal(gn.cpu(), cn) and bool(go) == bool(co) is False
    assert torch.equal(g.hi.cpu(), c.hi) and torch.equal(g.lo.cpu(), c.lo)


def test_kernel_rejects_a_slice_too_big_for_shared_memory(dev):
    k = torch.zeros(1, 8, dtype=torch.int32, device=dev)
    t = torch.zeros(1, 2 * bucket_dedup.SLICE, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        bucket_dedup.bucket_dedup(k, k, k.bool(), t, t.clone())


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_engine_on_card_matches_cpu(dev, kind, tmp_path):
    tb = generator.make_testbed(kind, 5000, 0.75, n_poms=2, seed=2)
    tb.write(str(tmp_path))
    hash_mix.launches = bucket_dedup.launches = 0
    got = create_kg(tb.doc, data_root=str(tmp_path), device="cuda")
    assert hash_mix.launches > 0 and bucket_dedup.launches > 0
    want = create_kg(tb.doc, data_root=str(tmp_path), device="cpu")
    assert list(got.iter_ntriples()) == list(want.iter_ntriples())
