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


@pytest.mark.parametrize("n_parts,part_len,cap,n_distinct,vfrac,extra", [
    (4, 256, 1024, 300, 0.8, None),       # empty table
    (128, 2048, 16384, 16384, 0.95, None),  # the 1M-row SOM shape
    (2, 200, 64, 10_000, 1.0, None),      # overflow
    # the OJM step's layout: part_len far above the keys, most lanes pads
    # (enough keys a partition for the kernel's sort by slot range)
    (16, 43_520, 16384, 10**6, 0.05, "empty_key"),
    # every lane valid and distinct, past the lanes a CTA keeps in shared
    # memory (the rest walk from the scratch row), many probe rounds
    (2, 12_000, 16384, 10**9, 1.0, None),
    (8, 1024, 2048, 600, 0.9, "prefill"),  # a table half full beforehand
    (3, 1001, 2048, 900, 0.9, "empty_key"),  # rows off 16-byte alignment
])
def test_bucket_dedup_kernel_matches_plain(dev, n_parts, part_len, cap, n_distinct, vfrac,
                                           extra):
    khi, klo, rng = _keys(part_len, (n_parts, part_len), n_distinct, dev)
    valid = torch.from_numpy(rng.random((n_parts, part_len)) < vfrac).to(dev)
    t = torch.full((n_parts, cap), -1, dtype=torch.int32, device=dev)
    if extra == "prefill":
        phi, plo, _ = _keys(7, (n_parts, cap // 2), n_distinct, dev)
        ones = torch.ones_like(phi, dtype=torch.bool)
        t2 = t.clone()
        bucket_dedup.bucket_dedup_plain(phi, plo, ones, t, t2)
        t = torch.stack([t, t2])
    else:
        t = torch.stack([t, t.clone()])
    if extra == "empty_key":  # valid lanes whose key is the EMPTY pair, twice
        for p, lane in ((0, 5), (0, 9), (2, 1000)):
            khi[p, lane] = klo[p, lane] = -1
            valid[p, lane] = True
    before = bucket_dedup.launches
    k = bucket_dedup.bucket_dedup(khi, klo, valid, t[0].clone(), t[1].clone())
    assert bucket_dedup.launches == before + 1
    p = bucket_dedup.bucket_dedup_plain(khi, klo, valid, t[0].clone(), t[1].clone())
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert bool(k[3].any()) == (cap == 64)
    if extra == "empty_key":
        assert bool(k[2][0, 5]) != bool(k[2][0, 9])  # one of the twins is new


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


# K3's register-blocked design: a CTA covers 64 * R child rows (R rows a
# thread, R picked from the row count), parents stream in tiles of 512
# scanned 4 at a time
NJ_CTA, NJ_TILE = nested_join.CTA_THREADS, 512


def _rows_for(R, dm):
    """A child row count the wrapper runs with R rows a thread on this card,
    dm rows from a multiple of a CTA's 64 * R rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    least = {4: 4, 2: 0}[R] * nested_join.CTAS_PER_SM * sms * NJ_CTA
    m = max(least, 3 * NJ_CTA * R) + (NJ_CTA * R if dm < 0 else 0) + dm
    assert nested_join.pick_rows_per_thread(m, sms) == R
    return m


def _nested_join_case(dev, m, n, n_keys, K, seed):
    rng = np.random.default_rng(seed)
    pk = torch.from_numpy(rng.integers(0, n_keys, size=n).astype(np.int32)).to(dev)
    ps = torch.from_numpy(rng.integers(0, 10**6, size=n).astype(np.int32)).to(dev)
    ck = torch.from_numpy(rng.integers(0, n_keys + 2, size=m).astype(np.int32)).to(dev)
    got = nested_join.nested_join(pk, ps, ck, K)
    want = nested_join.nested_join_plain(pk, ps, ck, K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("R", nested_join.ROWS_PER_THREAD)
@pytest.mark.parametrize("dm", [-1, 0, 1])
def test_nested_join_rows_at_a_cta_edge(dev, R, dm):
    _nested_join_case(dev, _rows_for(R, dm), 300, 50, 4, seed=R * 10 + dm + 1)


@pytest.mark.parametrize("R", nested_join.ROWS_PER_THREAD)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, NJ_TILE - 1, NJ_TILE, NJ_TILE + 1,
                               NJ_TILE + 2, NJ_TILE + 3, 2 * NJ_TILE, 2 * NJ_TILE + 1])
def test_nested_join_parent_tail_and_tiles(dev, R, n):
    # n = 1, 2, 3 (mod 4) leaves a ragged last group; a tile and two
    _nested_join_case(dev, _rows_for(R, 1), n, 9, 4, seed=n)


@pytest.mark.parametrize("R", nested_join.ROWS_PER_THREAD)
@pytest.mark.parametrize("n", [1, 7, NJ_TILE + 3])
@pytest.mark.parametrize("K_is_n", [False, True])
def test_nested_join_all_keys_equal(dev, R, n, K_is_n):
    """A match at every pair: every group takes the slow path; K = 1
    truncates every row, K = n keeps every parent in order."""
    K = n if K_is_n else 1
    m = _rows_for(R, 3) if K * R <= 64 else NJ_CTA * 2 + 3
    pk = torch.full((n,), 7, dtype=torch.int32, device=dev)
    ps = torch.arange(n, dtype=torch.int32, device=dev) * 3 + 1
    ck = torch.full((m,), 7, dtype=torch.int32, device=dev)
    subjects, valid, truncated = nested_join.nested_join(pk, ps, ck, K)
    want = nested_join.nested_join_plain(pk, ps, ck, K)
    assert torch.equal(subjects, want[0]) and torch.equal(valid, want[1])
    assert bool(truncated) == (K < n) == bool(want[2])
    assert torch.equal(subjects[:, :K], ps[:K].expand(m, K))


@pytest.mark.parametrize("R", nested_join.ROWS_PER_THREAD)
def test_nested_join_row_past_K_over_groups_and_tiles(dev, R):
    """One key matches parents spread over several 4-parent groups of three
    tiles: the first K in parent order are kept, the rest only counted."""
    n = 3 * NJ_TILE - 5
    rng = np.random.default_rng(R)
    keys = rng.integers(100, 200, size=n).astype(np.int32)
    hits = np.sort(rng.choice(n, size=60, replace=False))
    keys[hits] = 5
    pk = torch.from_numpy(keys).to(dev)
    ps = torch.from_numpy(rng.integers(0, 10**6, size=n).astype(np.int32)).to(dev)
    m = _rows_for(R, 0)
    ck = torch.tensor([5, 150, 5, -1], dtype=torch.int32, device=dev).repeat(m // 4)
    got = nested_join.nested_join(pk, ps, ck, 25)
    want = nested_join.nested_join_plain(pk, ps, ck, 25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2])
    assert torch.equal(got[0][0], ps[torch.from_numpy(hits[:25]).to(dev)])


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


def _kernel_vs_plain(store, text, caps, bsz, seed):
    """K4 against its plain version for one chain over ``store``: ``bsz``
    query rows built from the query's own constants, with the anchor varied
    over real ids, ``-2`` and its own id, pad rows and limits."""
    from repro_torch.serve import plan as P

    ex = get_executor(store)
    q = parse_select(text)
    fp = FP.build(ex, ex.plan(q))
    assert fp is not None
    spec = fp.spec
    R = len(spec.readers)
    caps = tuple(caps)[:R]
    rng = np.random.default_rng(seed)
    rep = P.encode_scan_consts(store, ex.plan(q), q)
    qb = np.zeros((bsz, K.qrow_width(R)), np.int32)
    for i in range(bsz):
        c = rep.copy()
        if c[0, 2] >= 0 and i % 3:
            c[0, 2] = [int(rng.integers(0, store.n_terms)), -2][i % 2]
        qb[i, : 3 * R] = c.reshape(-1)
        qb[i, 3 * R] = 0 if i % 7 == 6 else 1
        qb[i, 3 * R + 1] = [-1, -1, 0, 2][i % 4]
    qd = torch.from_numpy(qb).to(store.device)
    got = K.scan_join(spec, caps, *fp.operands, qd)
    want = K.scan_join_plain(spec, caps, *fp.operands, qd)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    return spec, want


WIDTHS = (1, 32, 33, 1024, 1025)


def _widths_store(device):
    """Predicates w<W> with exactly W triples each: their seeded stage-0
    windows are 1, 32, 33 (one 33-ary round more than 32), 1,024 and 1,025
    rows; a subject used as a predicate has an empty window."""
    t = []
    for w in WIDTHS:
        t += [(f"<http://ex/s{i}>", f"<http://ex/w{w}>", f'"v{i % 7}"') for i in range(w)]
    return TripleStore.from_ntriples(sorted(set(t)), device=device)


WINDOW_QUERIES = [f"SELECT * WHERE {{ ?s <http://ex/w{w}> ?o }}" for w in WIDTHS] + [
    'SELECT * WHERE { ?s <http://ex/w1025> "v3" }',   # a window inside the range
    "SELECT * WHERE { ?s <http://ex/s3> ?o }",         # width 0
    "SELECT * WHERE { ?s ?p ?o }",                     # the whole store
    "SELECT * WHERE { ?s <http://ex/w33> ?o . ?s <http://ex/w1025> ?b }",
    "SELECT ?o WHERE { ?s <http://ex/w1025> ?o }",    # equal output rows
]


@pytest.mark.parametrize("text", WINDOW_QUERIES)
@pytest.mark.parametrize("cap", [8, 32, 64, 128])
def test_scan_join_search_windows(dev, text, cap):
    _kernel_vs_plain(_widths_store(dev), text, (cap,) * 3, 9, seed=cap)


# stage 0's rounds (lower, upper) over a w-row window that lies wholly in
# the bound's range: the lower search's probes all fail and the upper's all
# pass, so the pivots lo + (l + 1) * w / 33 leave w / 33 rows to the lower
# search and w - 32 * w / 33 - 1 to the upper
STAGE0_ROUNDS = {1: (1, 1), 32: (1, 1), 33: (2, 1), 1024: (2, 2), 1025: (2, 2)}


@pytest.mark.parametrize("w", WIDTHS)
def test_scan_join_counts_stage0_loads(dev, w):
    """The kernel's own count of stage 0's dependent loads: the primary
    term's range, then one a 33-ary round; none for an unknown constant."""
    from repro_torch.serve import plan as P

    store = _widths_store(dev)
    ex = get_executor(store)
    q = parse_select(f"SELECT * WHERE {{ ?s <http://ex/w{w}> ?o }}")
    fp = FP.build(ex, ex.plan(q))
    assert len(fp.spec.readers) == 1 and fp.spec.readers[0].src[0][0] != "w"
    c = P.encode_scan_consts(store, ex.plan(q), q).reshape(-1)
    qb = np.zeros((2, K.qrow_width(1)), np.int32)
    qb[:, :3] = c
    qb[1, :3] = np.where(c >= 0, -2, c)
    qb[:, 3], qb[:, 4] = 1, -1
    loads = torch.full((2, 2), -7, dtype=torch.int32, device=dev)
    launch, _, n, _ = K.prepare_launch(fp.spec, (64,), *fp.operands,
                                       torch.from_numpy(qb).to(dev), stage0_loads=loads)
    launch()
    torch.cuda.synchronize()
    assert n.tolist() == [min(w, 64), 0]
    assert loads.tolist() == [[1 + r for r in STAGE0_ROUNDS[w]], [0, 0]]


@pytest.mark.parametrize("text", ["SELECT * WHERE { ?s ?p ?o }",
                                  "SELECT * WHERE { ?s <http://ex/p> ?o }",
                                  'SELECT ?s WHERE { ?s <http://ex/p> "x" }'])
def test_scan_join_one_row_store(dev, text):
    store = TripleStore.from_ntriples([("<http://ex/s>", "<http://ex/p>", '"x"')],
                                      device=dev)
    for cap in (2, 32, 64):
        _kernel_vs_plain(store, text, (cap,), 5, seed=cap)


def _wide_subject_store(device):
    """Subject s0 holds 42 triples, so a bind reader seeded by the subject
    has a primary range wider than 32 rows (prim_rounds 6)."""
    t = [(f"<http://ex/s{i}>", "<http://ex/p1>", f'"v{j}"')
         for i in range(6) for j in range(40 if i == 0 else 2)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p0>", '"anchor"') for i in range(6)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p2>", f"<http://ex/o{i % 5}>") for i in range(60)]
    return TripleStore.from_ntriples(sorted(set(t)), device=device)


@pytest.mark.parametrize("caps", [(8, 64, 64), (32, 128, 128), (8, 32, 32)])
def test_scan_join_bind_search_wide_primary_range(dev, caps):
    store = _wide_subject_store(dev)
    for text in ('SELECT * WHERE { ?s <http://ex/p0> "anchor" . ?s <http://ex/p1> ?b }',
                 'SELECT * WHERE { ?s <http://ex/p0> "anchor" . ?s <http://ex/p1> ?b . '
                 '?s <http://ex/p2> ?c }'):
        spec, _ = _kernel_vs_plain(store, text, caps, 6, seed=sum(caps))
        assert max(r.prim_rounds for r in spec.readers[1:]) > 5


@pytest.mark.parametrize("cap0", [8, 16, 32, 64, 128, 512])
def test_scan_join_bind_search_groups(dev, cap0):
    """Left row counts that give each bind row 32, 16, 8, 4 and 2 lanes,
    and 2 lanes over several passes of 128 rows."""
    text = "SELECT * WHERE { ?s <http://ex/p1> ?o . ?s <http://ex/p2> ?c }"
    spec, want = _kernel_vs_plain(_chain_store(dev), text, (cap0, 1024), 4, seed=cap0)
    assert len(spec.readers) == 2 and int(want[2][0]) > 128
    assert K.bind_search_lanes(min(int(want[2][0]), cap0)) == {
        8: 32, 16: 16, 32: 8, 64: 4, 128: 2, 512: 2}[cap0]


@pytest.mark.parametrize("n_unbound", [0, 4, 8])
@pytest.mark.parametrize("cap", [8, 16, 32])
def test_scan_join_rank_tail_columns(dev, n_unbound, cap):
    """The tail's ranks on one warp with 2, 6 and 10 output columns (each
    column bound of its loop), from a few rows up to 32."""
    extra = " ".join(f"?x{i}" for i in range(n_unbound))
    for text in (f"SELECT ?o ?s {extra} WHERE {{ ?s <http://ex/p1> ?o }}",
                 f"SELECT ?b ?s {extra} WHERE {{ ?s <http://ex/p0> ?a . ?s <http://ex/p1> ?b }}"):
        _kernel_vs_plain(_chain_store(dev), text, (cap, cap), 6, seed=cap + n_unbound)


@pytest.mark.parametrize("text,caps", [(CHAINS[3], (2048, 2048, 2048)),
                                       (CHAINS[3], (8, 4096, 4096)),
                                       (CHAINS[1], (4096,))])
def test_scan_join_chain_in_global_scratch(dev, text, caps):
    """(2 * n_cols + 2) * capmax past the kernel's shared memory: the
    chain's columns go through global scratch; the sort runs in shared
    memory up to 8,192 ints of output and in place in the outputs above."""
    spec, want = _kernel_vs_plain(_chain_store(dev), text, caps, 5, seed=3)
    assert (2 * spec.n_cols + 2) * max(caps) > K.CHAIN_SMEM_INTS


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


def _live_pair(tmp_path):
    """The same 5K-row OJM store on the card and on the CPU, each under a
    live overlay after the same inserts (new terms among them) and deletes
    (a re-insert and a duplicate among them)."""
    from repro_torch.live import LiveStore

    tb = generator.make_testbed("OJM", 5000, 0.75, n_poms=2, seed=4)
    tb.write(str(tmp_path))
    lives = {}
    for d in ("cuda", "cpu"):
        store = create_kg(tb.doc, data_root=str(tmp_path), device=d).to_store(device=d)
        live = LiveStore(store)
        trips = [tuple(store.decode_term(int(c[i])) for c in (store.s, store.p, store.o))
                 for i in range(0, store.n_triples, 7)]
        p = trips[0][1]
        live.insert([(f"<http://ex/live{i}>", p, t[2]) for i, t in enumerate(trips[:300])])
        live.delete(trips[:400] + trips[:20])
        live.insert(trips[:50])
        lives[d] = live
    return lives


def test_overlay_rows_on_card_match_cpu(dev, tmp_path):
    lives = _live_pair(tmp_path)
    base = lives["cpu"].base
    p0, classes = serve_bench._classes(base)
    for name, qtext in classes:
        for batch in (1, 64, 300):
            res = {}
            for d, live in lives.items():
                ex = get_executor(live.base)
                plan, batches, _ = serve_bench._encoded_batches(ex, qtext, p0, batch, 1, 0)
                qs = [parse_select(qtext)] * batch
                view = live.view()
                fops = None
                if plan.n_filter_ops:
                    from repro_torch.serve import plan as P
                    from repro_torch.serve.values import value_table

                    fops = np.tile(P.encode_filter_ops(view, value_table(view), qs[0].filters),
                                   (batch, 1))
                res[d] = ex.execute_encoded(plan, batches[0], fops, view=view)
            assert np.array_equal(res["cuda"].counts, res["cpu"].counts), (name, batch)
            for i in range(batch):
                assert res["cuda"].rows(i) == res["cpu"].rows(i), (name, batch, i)
    a, b = (_persist_bytes(lives[d].compact(), tmp_path / f"{d}-c.kgz") for d in ("cuda", "cpu"))
    assert a == b


def _persist_bytes(store, path):
    persist.save(store, str(path), generation=1)
    return path.read_bytes()


def test_sharded_ingest_in_spawned_workers_on_card_matches_cpu(dev, tmp_path):
    """``ingest_sharded`` with 2 spawned workers, each opening its own CUDA
    context: the bytes of the manifest and the shards equal the CPU's."""
    from repro_torch.shard import ingest_sharded

    tb = generator.make_testbed("SOM", 3000, 0.75, n_poms=2, seed=6)
    tb.write(str(tmp_path))
    store = create_kg(tb.doc, data_root=str(tmp_path), device="cpu").to_store(device="cpu")
    trips = [tuple(store.decode_term(int(c[i])) for c in (store.s, store.p, store.o))
             for i in range(store.n_triples)]
    blobs = {}
    for d in ("cuda", "cpu"):
        out = tmp_path / d
        out.mkdir()
        ingest_sharded(trips, str(out / "kg.shards.json"), 3, workers=2, device=d)
        blobs[d] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert len(blobs["cuda"]) == 4 and blobs["cuda"] == blobs["cpu"]


def test_server_on_card_answers_a_client(dev, tmp_path):
    from repro_torch.api import LocalSession
    from repro_torch.live import LiveStore
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve.client import connect
    from repro_torch.serve.server import KGServer

    gpu = _chain_store(dev)
    cpu = LocalSession(_chain_store("cpu"))
    srv = KGServer(LiveStore(gpu), port=0, log=False, registry=MetricsRegistry()).start()
    before = K.launches
    try:
        with connect("127.0.0.1", srv.port, timeout=60.0) as c:
            for text in CHAINS:
                r = c.query(text)
                want = cpu.query(text, limit=1000)
                assert [tuple(x) for x in r["rows"]] == want.rows and r["n_total"] == want.n_total
            assert K.launches > before  # batch 1 through the server is the kernel
            r = c.insert([["<http://ex/new>", "<http://ex/p0>", '"card"']])
            assert r["inserted"] == 1
            got = c.query("SELECT ?o WHERE { <http://ex/new> <http://ex/p0> ?o }")
            assert got["rows"] == [['"card"']]
    finally:
        srv.stop()


@pytest.mark.parametrize("dedup", [False, True])
def test_train_step_on_card_matches_cpu(dev, dedup):
    """Two Wide & Deep steps (``configs.cells.recsys_train_step``, AdamW lr
    1e-2) on the card against a CPU copy of the same weights, with
    ``chip_smoke.py`` phase 16's tolerances: loss within rtol 1e-5,
    grad_norm within 1e-3 (a pre-activation rounding to the other side of 0
    flips a ReLU for one sample), each leaf's params within 5% of its
    update's 2-norm (AdamW maps a gradient near eps to a step of up to lr,
    however it rounded)."""
    import dataclasses

    from repro_torch.configs import cells, wide_deep
    from repro_torch.models.recsys import WideDeep
    from repro_torch.train.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = wide_deep.smoke_config()
    rng = np.random.default_rng(5)
    sp = (np.minimum(rng.zipf(1.3, size=(2, 64, cfg.n_sparse, 1)), cfg.vocab_per_field)
          - 1).astype(np.int32)
    de = rng.normal(size=(2, 64, cfg.n_dense)).astype(np.float32)
    y = (rng.random((2, 64)) > 0.5).astype(np.int32)
    if dedup:
        offs = (np.arange(cfg.n_sparse) * cfg.vocab_per_field)[None, :, None]
        cfg = dataclasses.replace(cfg, dedup_cap=int(1.5 * max(
            len(np.unique(b + offs)) for b in sp)))
    p0 = {k: v.detach().clone()
          for k, v in WideDeep(cfg, device="cpu", seed=1).named_parameters()}
    runs = {}
    for device in ("cpu", dev):
        model = WideDeep(cfg, device="cpu", seed=1).to(device)
        step, opt, params = cells.recsys_train_step(cfg, model, AdamW(lr=1e-2))
        state = opt.init(params)
        ms = []
        for i in range(2):
            batch = (torch.from_numpy(a[i]).to(device) for a in (sp, de, y))
            params, state, m = step(params, state, *batch)
            ms.append([float(m["loss"]), float(m["grad_norm"])])
        runs[device.type if isinstance(device, torch.device) else device] = (
            np.array(ms), {k: v.detach().cpu() for k, v in params.items()})
    (mc, pc), (mh, ph) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(mc[:, 0], mh[:, 0], rtol=1e-5)
    np.testing.assert_allclose(mc[:, 1], mh[:, 1], rtol=1e-3)
    for k, v in p0.items():
        assert float((pc[k] - ph[k]).norm()) <= 0.05 * float((ph[k] - v).norm()), k


LM_ARCHS = ["qwen2.5-3b", "gemma-2b", "mixtral-8x7b", "dbrx-132b", "command-r-plus-104b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_prefill_and_decode_on_card_match_cpu(dev, arch):
    """An LM smoke config's prefill (on the chunked path, ``attn_chunk`` 4
    at seq 12) and 6 decode steps on the card against a CPU copy of the
    same weights, in fp32 without TF32: logits within 1e-4 of their largest
    magnitude (``chip_smoke.py`` phase 17's tolerance), the caches' k and v
    alike and pos equal."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import layers, transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), attn_chunk=4)
    model = transformer.Transformer(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32))
    def run(device):
        """-> the prefill's logits, each decode step's and the cache, on the CPU."""
        params = layers.nest({k: v.to(device) for k, v in model.state_dict().items()})
        with torch.inference_mode():
            outs = [transformer.prefill(cfg, params, toks.to(device)).cpu()]
            cache = transformer.make_cache(cfg, 2, 8, device)
            for i in range(6):
                logits, cache = transformer.decode_step(
                    cfg, params, cache, toks[:, i:i + 1].to(device),
                    torch.tensor(i, dtype=torch.int32, device=device))
                outs.append(logits.cpu())
        return outs, [x.cpu() for x in cache]

    (card, (ck, cv, cpos)), (host, (hk, hv, hpos)) = run(dev), run("cpu")
    for got, want in [*zip(card, host, strict=True), (ck, hk), (cv, hv)]:
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, err
    assert torch.equal(cpos, hpos)


def _update_err(pa, pb, p0, lr):
    """Largest over leaves of |pa - pb| over |pb - p0| (2-norm); a leaf
    whose update is under 1e-3 of a full step (lr * sqrt(size)), a gradient
    zero up to rounding, counts |pa - p0| against a full step instead."""
    worst = 0.0
    for k, w0 in p0.items():
        full = lr * w0.numel() ** 0.5
        moved = float((pb[k] - w0).norm())
        worst = max(worst, float((pa[k] - pb[k]).norm()) / moved if moved >= 1e-3 * full
                    else float((pa[k] - w0).norm()) / full)
    return worst


def _steps_on(step_fn, model, batches):
    """Steps of ``step_fn(model)``, one a batch (a tuple of the step's
    arguments); -> [[loss, grad_norm]] and the params on the CPU."""
    step, opt, params = step_fn(model)
    state = opt.init(params)
    ms = []
    for b in batches:
        params, state, m = step(params, state, *b)
        ms.append([float(m["loss"]), float(m["grad_norm"])])
    return np.array(ms), {k: v.detach().cpu() for k, v in params.items()}


@pytest.mark.parametrize("task", ["node_cls", "graph_reg"])
@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet", "nequip", "equiformer-v2"])
def test_gnn_train_step_on_card_matches_cpu(dev, arch, task):
    """A GNN smoke config's forward and two ``gnn_train_step`` steps (remat
    on) on the card against a CPU copy, fp32 without TF32, with
    ``chip_smoke.py`` phase 19's tolerances: forward within 1e-5 of its
    largest (the card's index_add is atomic, in no fixed order), loss rtol
    1e-5, grad_norm 1e-3, each leaf within 5% of its update."""
    import dataclasses

    from repro_torch.configs import cells, registry
    from repro_torch.data import graphs
    from repro_torch.models.gnn import common

    torch.backends.cuda.matmul.allow_tf32 = False
    ng = 4 if task == "graph_reg" else 1
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), d_in=12, task=task,
                              n_classes=5)
    module = cells.GNN_FAMILIES[arch][0]
    b = graphs.random_graph(300, 1200, 12, n_classes=5, seed=8, task=task, n_graphs=ng)
    p0 = {k: v.detach().clone()
          for k, v in common.Model(module, cfg, device="cpu", seed=2).named_parameters()}
    runs, fwd = {}, {}
    for device in ("cpu", dev):
        model = common.Model(module, cfg, device="cpu", seed=2).to(device)
        batch = common.to_device(b, device)
        with torch.no_grad():
            extra = () if arch == "gat-cora" else (ng,)
            fwd[str(device)] = module.forward(model.params(), cfg, batch, *extra).cpu()
        runs[str(device)] = _steps_on(
            lambda m: cells.gnn_train_step(arch, cfg, m, n_graphs=ng), model, [(batch,)] * 2)
    fc, fh = fwd["cuda"], fwd["cpu"]
    assert float((fc - fh).abs().max() / fh.abs().max()) <= 1e-5
    (mc, pc), (mh, ph) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(mc[:, 0], mh[:, 0], rtol=1e-5)
    np.testing.assert_allclose(mc[:, 1], mh[:, 1], rtol=1e-3)
    assert _update_err(pc, ph, p0, 1e-3) <= 0.05


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_card_matches_cpu(dev, arch):
    """Two ``lm_train_step`` steps of an LM smoke config (remat on, 2
    microbatches, on the chunked path) on the card against a CPU copy, fp32
    without TF32: loss rtol 1e-5, grad_norm 1e-3, each leaf within 5% of
    its update (``chip_smoke.py`` phase 18's tolerances)."""
    import dataclasses

    from repro_torch.configs import cells, registry
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(), attn_chunk=4,
                              microbatches=2)
    rng = np.random.default_rng(7)
    batches = [tuple(torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 2, 12)).astype(
        np.int32)) for _ in range(2)) for _ in range(2)]
    p0 = {k: v.detach().clone()
          for k, v in transformer.Transformer(cfg, device="cpu", seed=3).named_parameters()}
    runs = {}
    for device in ("cpu", dev):
        model = transformer.Transformer(cfg, device="cpu", seed=3).to(device)
        runs[str(device)] = _steps_on(lambda m: cells.lm_train_step(cfg, m), model,
                                      [tuple(x.to(device) for x in b) for b in batches])
    (mc, pc), (mh, ph) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(mc[:, 0], mh[:, 0], rtol=1e-5)
    np.testing.assert_allclose(mc[:, 1], mh[:, 1], rtol=1e-3)
    assert _update_err(pc, ph, p0, 1e-4) <= 0.05
