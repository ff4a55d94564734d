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
from repro_torch.kernels import bucket_dedup, hash_mix, nested_join, ops
from repro_torch.kernels import scan_join as K
from repro_torch.kg import persist
from repro_torch.kg.store import TripleStore
from repro_torch.rml import generator
from repro_torch.serve import bench as serve_bench
from repro_torch.serve import fastpath as FP
from repro_torch.serve import parse_select
from repro_torch.serve.exec import get_executor

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


@pytest.mark.parametrize("m,n,n_keys,K", [
    (1, 1, 1, 1),           # one row, one parent
    (255, 2047, 30, 1),     # K = 1, truncated; m and n below a CTA and a tile
    (257, 2049, 30, 200),   # one past a CTA of rows and a tile of parents
    (1000, 6000, 40, 90),   # several tiles; some rows truncated
    (70_000, 33, 5, 16),    # many CTAs, a ragged single tile
    (0, 100, 5, 4),         # no child rows
    (100, 0, 5, 4),         # no parent rows
])
def test_nested_join_kernel_matches_plain(dev, m, n, n_keys, K):
    rng = np.random.default_rng(m + n)
    pk = torch.from_numpy(rng.integers(0, n_keys, size=n).astype(np.int32)).to(dev)
    ps = torch.from_numpy(rng.integers(0, 10**6, size=n).astype(np.int32)).to(dev)
    ck = torch.from_numpy(rng.integers(0, n_keys + 3, size=m).astype(np.int32)).to(dev)
    before = nested_join.launches
    got = nested_join.nested_join(pk, ps, ck, K)
    assert nested_join.launches == before + (m > 0)
    want = nested_join.nested_join_plain(pk, ps, ck, K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if m and n:
        spans = torch.bincount(pk.long(), minlength=n_keys + 3)[ck.long()]
        assert bool(got[2]) == bool((spans > K).any())


@pytest.mark.parametrize("kind,cfg", [
    ("SOM", dict(engine="naive")), ("OJM", dict(engine="naive")),
    ("OJM", dict(join_strategy="hash")),
    ("SOM", dict(stream=True, block_rows=1000)), ("OJM", dict(stream=True, block_rows=1000)),
])
def test_slice_two_paths_on_card_match_cpu(dev, kind, cfg, tmp_path):
    tb = generator.make_testbed(kind, 5000, 0.75, n_poms=2, seed=2)
    tb.write(str(tmp_path))
    nested_join.launches = 0
    got = create_kg(tb.doc, data_root=str(tmp_path), device="cuda", **cfg)
    assert (nested_join.launches > 0) == (cfg.get("engine") == "naive" and kind == "OJM")
    want = create_kg(tb.doc, data_root=str(tmp_path), device="cpu", **cfg)
    assert list(got.iter_ntriples()) == list(want.iter_ntriples())


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_engine_on_card_matches_cpu(dev, kind, tmp_path):
    tb = generator.make_testbed(kind, 5000, 0.75, n_poms=2, seed=2)
    tb.write(str(tmp_path))
    hash_mix.launches = bucket_dedup.launches = 0
    got = create_kg(tb.doc, data_root=str(tmp_path), device="cuda")
    assert hash_mix.launches > 0 and bucket_dedup.launches > 0
    want = create_kg(tb.doc, data_root=str(tmp_path), device="cpu")
    assert list(got.iter_ntriples()) == list(want.iter_ntriples())


def _chain_store(device):
    """A rare anchor p0 over 7 subjects and common p1/p2: 1-, 2- and
    3-reader chains (as in ``test_torch_scan_join.py``)."""
    t = [(f"<http://ex/s{i}>", "<http://ex/p1>", f'"v{i % 7}"') for i in range(300)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p1>", f'"w{i % 3}"') for i in range(0, 300, 4)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p2>", f"<http://ex/o{i % 5}>")
          for i in range(300)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p0>", '"anchor"') for i in range(0, 35, 5)]
    return TripleStore.from_ntriples(sorted(set(t)), device=device)


CHAINS = [
    "SELECT * WHERE { ?s <http://ex/p1> ?o }",
    "SELECT * WHERE { ?s ?p ?o }",
    "SELECT * WHERE { ?s <http://ex/p0> ?a . ?s <http://ex/p1> ?b }",
    "SELECT ?s ?b ?c ?z WHERE { ?s <http://ex/p0> ?a . ?s <http://ex/p1> ?b . "
    "?s <http://ex/p2> ?c }",
]


@pytest.mark.parametrize("text", CHAINS)
@pytest.mark.parametrize("caps_scale", [0, 1, 8])
@pytest.mark.parametrize("bsz", [1, 5, 64])
def test_scan_join_kernel_matches_plain(dev, text, caps_scale, bsz):
    store = _chain_store(dev)
    ex = get_executor(store)
    fp = FP.build(ex, ex.plan(parse_select(text)))
    assert fp is not None
    R = len(fp.spec.readers)
    caps = tuple(2 if caps_scale == 0 else 1 << (9 + caps_scale // 8) for _ in range(R))
    rng = np.random.default_rng(bsz * 10 + caps_scale)
    q = np.zeros((bsz, K.qrow_width(R)), np.int32)
    from repro_torch.serve import plan as P

    rep = P.encode_scan_consts(store, ex.plan(parse_select(text)), parse_select(text))
    for i in range(bsz):
        c = rep.copy()
        if c[0, 2] >= 0:
            c[0, 2] = [int(rng.integers(0, store.n_terms)), -2, int(rep[0, 2])][i % 3]
        q[i, : 3 * R] = c.reshape(-1)
        q[i, 3 * R] = 0 if i % 7 == 6 else 1
        q[i, 3 * R + 1] = [-1, -1, 0, 2][i % 4]
    qd = torch.from_numpy(q).to(dev)
    before = K.launches
    got = K.scan_join(fp.spec, caps, *fp.operands, qd)
    assert K.launches == before + 1
    want = K.scan_join_plain(fp.spec, caps, *fp.operands, qd)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)


def test_fastpath_on_card_matches_cpu(dev):
    gpu, cpu = _chain_store(dev), _chain_store("cpu")
    for text in CHAINS:
        q = parse_select(text)
        for bsz in (1, 8, 64):
            before = K.launches
            g = get_executor(gpu)
            got = g.execute(g.plan(q), [q] * bsz)
            assert K.launches > before  # the card's fast path is the kernel
            c = get_executor(cpu)
            want = c.execute(c.plan(q), [q] * bsz)
            assert np.array_equal(got.counts, want.counts)
            for i in range(bsz):
                assert got.ids(i) == want.ids(i)


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_serving_on_card_matches_cpu(dev, kind, tmp_path):
    """rdfize --emit kgz's store on the card and on the CPU: the same .kgz
    bytes, and the six bench classes answer the same rows at every batch."""
    tb = generator.make_testbed(kind, 5000, 0.75, n_poms=2, seed=2)
    tb.write(str(tmp_path))
    stores = {}
    for d in ("cuda", "cpu"):
        stores[d] = create_kg(tb.doc, data_root=str(tmp_path), device=d).to_store(device=d)
        persist.save(stores[d], str(tmp_path / f"{d}.kgz"))
    assert (tmp_path / "cuda.kgz").read_bytes() == (tmp_path / "cpu.kgz").read_bytes()
    p0, classes = serve_bench._classes(stores["cpu"])
    K.launches = 0
    for name, qtext in classes:
        for batch in (1, 8, 64, 200):
            res = {}
            for d, store in stores.items():
                ex = get_executor(store)
                plan, batches, fops = serve_bench._encoded_batches(ex, qtext, p0, batch, 1, 0)
                res[d] = ex.execute_encoded(plan, batches[0], fops)
            assert np.array_equal(res["cuda"].counts, res["cpu"].counts), (name, batch)
            for i in range(batch):
                assert res["cuda"].ids(i) == res["cpu"].ids(i), (name, batch, i)
    assert K.launches > 0
