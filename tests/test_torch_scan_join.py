"""K4 ``scan_join``'s plain version against the JAX package's chain.

The port's batched plain version (``make_batched(use_kernel=False)``, which
the wrapper runs for CPU tensors) must equal ``repro.kernels.scan_join``'s
vmapped reference and its Pallas kernel in interpret mode, exactly: every
output is an integer.  Chains of 1, 2 and 3 readers over the same store in
both packages, with pad rows, limits, ``-2`` unknown constants, wildcard
primaries, and capacities both too small (the ``needed`` vector) and large
enough.  The kernel itself runs only on the card (``test_torch_cuda.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.kernels import scan_join as JK
from repro.kg.store import TripleStore as JStore
from repro.serve import fastpath as JFP
from repro.serve import parse_select as jparse
from repro.serve.exec import get_executor as jget
from repro_torch.kernels import scan_join as K
from repro_torch.kg.store import TripleStore
from repro_torch.serve import fastpath as FP
from repro_torch.serve import parse_select
from repro_torch.serve.exec import get_executor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triples():
    """A rare anchor predicate p0 over 7 subjects and common p1/p2 (some
    subjects with several objects), so the planner anchors on p0 and
    bind-joins p1 and p2: genuine 2- and 3-reader chains."""
    t = [(f"<http://ex/s{i}>", "<http://ex/p1>", f'"v{i % 7}"') for i in range(60)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p1>", f'"w{i % 3}"') for i in range(0, 60, 4)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p2>", f"<http://ex/o{i % 5}>")
          for i in range(60)]
    t += [(f"<http://ex/s{i}>", "<http://ex/p0>", '"anchor"') for i in range(0, 35, 5)]
    t += [("<http://ex/s3>", "<http://ex/p0>", '"other"')]
    return sorted(set(t))


@pytest.fixture(scope="module")
def stores():
    t = _triples()
    return JStore.from_ntriples(t), TripleStore.from_ntriples(t, device="cpu")


QUERIES = {
    1: "SELECT * WHERE { ?s <http://ex/p1> ?o }",
    "1w": "SELECT * WHERE { ?s ?p ?o }",
    2: "SELECT * WHERE { ?s <http://ex/p0> ?a . ?s <http://ex/p1> ?b }",
    3: ("SELECT ?s ?b ?c ?z WHERE { ?s <http://ex/p0> ?a . ?s <http://ex/p1> ?b . "
        "?s <http://ex/p2> ?c }"),
}


def _both_specs(stores, text):
    js, ts = stores
    jex, tex = jget(js), get_executor(ts)
    jfp = JFP.build(jex, jex.plan(jparse(text)))
    tfp = FP.build(tex, tex.plan(parse_select(text)))
    assert jfp is not None and tfp is not None
    return jfp, tfp


def _qbuf(spec, consts_rows, seed):
    """Packed rows: one per entry of ``consts_rows`` (an (R, 3) constants
    array; None is a pad row), limits drawn from -1/0/1/3."""
    rng = np.random.default_rng(seed)
    R = len(spec.readers)
    q = np.zeros((len(consts_rows), K.qrow_width(R)), np.int32)
    for i, c in enumerate(consts_rows):
        if c is None:  # a pad row, as the fast path writes it
            q[i, : 3 * R], q[i, 3 * R], q[i, 3 * R + 1] = -2, 0, -1
        else:
            q[i, : 3 * R] = np.asarray(c, np.int32).reshape(-1)
            q[i, 3 * R] = 1
            q[i, 3 * R + 1] = rng.choice([-1, -1, 0, 1, 3])
    return q


def _consts_rows(stores, text, n, seed):
    """The query's own constants, with the anchor (the first reader's
    object) varied over real ids, an unknown id (-2) and out-of-range ids."""
    js, _ = stores
    jex = jget(js)
    q = jparse(text)
    plan = jex.plan(q)
    from repro.serve import plan as JP

    rep = JP.encode_scan_consts(js, plan, q)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        c = rep.copy()
        if i % 5 == 4:
            rows.append(None)
            continue
        if c[0, 2] >= 0:
            c[0, 2] = [int(rng.integers(0, js.n_terms)), -2, int(c[0, 2]),
                       js.n_terms + 7][i % 4]
        rows.append(c)
    return rows


def _run_both(jfp, tfp, caps, qbuf, interpret=False):
    spec_j, spec_t = jfp.spec, tfp.spec
    ref = jax.jit(JK.make_batched(spec_j, caps, use_kernel=False))
    r_outs, r_n, r_need = ref(*jfp.operands, qbuf)
    got = K.make_batched(spec_t, caps, use_kernel=False)(
        *tfp.operands, torch.from_numpy(qbuf))
    wrapped = K.scan_join(spec_t, caps, *tfp.operands, torch.from_numpy(qbuf))
    outs, n, need = got
    assert np.array_equal(n.numpy(), np.asarray(r_n))
    assert np.array_equal(need.numpy(), np.asarray(r_need))
    assert len(outs) == len(r_outs)
    for a, b in zip(outs, r_outs):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))
    w_outs, w_n, w_need = wrapped  # CPU tensors: the wrapper runs the plain version
    assert torch.equal(w_n, n) and torch.equal(w_need, need)
    assert all(torch.equal(x, y) for x, y in zip(w_outs, outs))
    if interpret:
        ker = JK.make_batched(spec_j, caps, use_kernel=True, interpret=True)
        k_outs, k_n, k_need = ker(*jfp.operands, qbuf)
        assert np.array_equal(n.numpy(), np.asarray(k_n))
        assert np.array_equal(need.numpy(), np.asarray(k_need))
        for a, b in zip(outs, k_outs):
            assert np.array_equal(a.numpy(), np.asarray(b))
    return n.numpy(), need.numpy()


def test_specs_equal(stores):
    for key, text in QUERIES.items():
        jfp, tfp = _both_specs(stores, text)
        assert len(tfp.spec.readers) == (3 if key == 3 else 2 if key == 2 else 1)
        assert tfp.spec.readers == tuple(
            K.ReaderSpec(r.src, r.out, r.prim_rounds) for r in jfp.spec.readers)
        for f in ("n_cols", "out_cols", "key_bits", "rounds", "store_n"):
            assert getattr(tfp.spec, f) == getattr(jfp.spec, f)
        assert tfp.cap_names == jfp.cap_names and tfp.base_caps == jfp.base_caps
        for a, b in zip(tfp.operands, jfp.operands):
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("key", list(QUERIES))
@pytest.mark.parametrize("caps_kind", ["small", "large"])
def test_plain_chain_matches_jax(stores, key, caps_kind):
    jfp, tfp = _both_specs(stores, QUERIES[key])
    R = len(tfp.spec.readers)
    caps = (2,) * R if caps_kind == "small" else (256, 512, 1024)[:R]
    qbuf = _qbuf(tfp.spec, _consts_rows(stores, QUERIES[key], 16, seed=R), seed=R)
    n, need = _run_both(jfp, tfp, caps, qbuf)
    if caps_kind == "small":  # the capacity feedback must see the overflow
        assert need.max() > 2
    else:
        assert (need <= np.asarray(caps)).all() and n.max() > 0


@pytest.mark.parametrize("key", [1, 3])
def test_plain_chain_matches_pallas_interpret(stores, key):
    jfp, tfp = _both_specs(stores, QUERIES[key])
    R = len(tfp.spec.readers)
    caps = (8, 16, 64)[:R]
    qbuf = _qbuf(tfp.spec, _consts_rows(stores, QUERIES[key], 5, seed=7), seed=7)
    _run_both(jfp, tfp, caps, qbuf, interpret=True)


def test_pack_bound_and_search_match_jax(stores):
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.integers(-5, 1 << 22, size=200),
        [-2**31, -2, -1, 0, 1, (1 << 21) - 3, (1 << 21) - 2, (1 << 21) - 1, 2**31 - 1],
    ]).astype(np.int32)
    q = [rng.permutation(vals) for _ in range(3)]
    for bits in (21, 16):
        jh, jl = JK.pack_bound(*q, bits)
        th, tl = K.pack_bound(*(torch.from_numpy(x) for x in q), bits)
        assert th.dtype == tl.dtype == torch.int32
        assert np.array_equal(th.numpy(), np.asarray(jh))
        assert np.array_equal(tl.numpy(), np.asarray(jl))
    js, ts = stores
    khi_j, klo_j = js.device_keys("spo")
    khi, klo = ts.device_keys("spo")
    qh, ql = K.pack_bound(*(torch.from_numpy(x) for x in q), 21)
    for upper in (False, True):
        want = JK.lex_search2(khi_j, klo_j, jnp_of(qh), jnp_of(ql), upper, 12)
        got = K.lex_search2(khi, klo, qh, ql, upper, 12)
        assert np.array_equal(got.numpy(), np.asarray(want))


def jnp_of(t):
    import jax.numpy as jnp

    return jnp.asarray(t.numpy())


def test_wrapper_refuses_other_devices(stores):
    _, tfp = _both_specs(stores, QUERIES[1])
    meta = [t.to("meta") for t in tfp.operands]
    qbuf = torch.zeros((1, K.qrow_width(1)), dtype=torch.int32, device="meta")
    before = K.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.scan_join(tfp.spec, (2,), *meta, qbuf)
    assert K.launches == before


def test_cpu_wrapper_counts_no_launch(stores):
    _, tfp = _both_specs(stores, QUERIES[2])
    qbuf = torch.from_numpy(_qbuf(tfp.spec, _consts_rows(stores, QUERIES[2], 3, 1), 1))
    before = K.launches
    K.scan_join(tfp.spec, (8, 8), *tfp.operands, qbuf)
    assert K.launches == before


def test_launch_marshalling(stores, monkeypatch):
    """The argument tables the wrapper hands ``csrc/scan_join.cu`` (39
    pointers, 70 ints, as ``scan_join_launch`` reads them), checked with a
    stand-in library: the kernel itself runs only on the card."""
    _, tfp = _both_specs(stores, QUERIES[3])
    spec, caps = tfp.spec, (8, 16, 32)
    calls = []

    class Lib:
        def scan_join_launch(self, ptrs, n_ptrs, ints, n_ints, B, capmax, stream, dev):
            calls.append((list(ptrs), n_ptrs, list(ints), n_ints, B, capmax, stream, dev))
            return calls[-1][2][0] - 3  # 0 for three readers

        def kernel_error_string(self, code):
            return b"invalid argument"

    class Stream:
        cuda_stream = 77

    monkeypatch.setattr(K._build, "library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    qbuf = torch.from_numpy(_qbuf(spec, _consts_rows(stores, QUERIES[3], 4, 2), 2))
    before = K.launches
    launch, outs, n, needed = K.prepare_launch(spec, caps, *tfp.operands, qbuf)
    assert not calls and len(outs) == len(spec.out_cols) == 4
    assert outs[0].shape == (4, 32) and n.shape == (4,) and needed.shape == (4, 3)
    launch()
    assert K.launches == before
    ptrs, n_ptrs, ints, n_ints, B, capmax, stream, dev = calls[0]
    assert (n_ptrs, n_ints, B, capmax, stream) == (39, 70, 4, 32, 77)
    assert ptrs[:18] == [t.data_ptr() for t in tfp.operands]
    assert ptrs[18:21] == [qbuf.data_ptr(), n.data_ptr(), needed.data_ptr()]
    assert ptrs[23:27] == [o.data_ptr() for o in outs] and ptrs[27:] == [0] * 12
    # the chain's columns fit the kernel's shared memory: no scratch; past
    # CHAIN_SMEM_INTS the launch gets a global scratch buffer; no stage-0
    # load count unless one is asked for
    assert ptrs[21] == 0 and ptrs[22] == 0
    big = (8, 16, 2048)
    assert (2 * spec.n_cols + 2) * max(big) > K.CHAIN_SMEM_INTS
    K.prepare_launch(spec, big, *tfp.operands, qbuf)[0]()
    assert calls[1][0][21] != 0 and calls[1][5] == 2048
    loads = torch.zeros((4, 2), dtype=torch.int32)
    K.prepare_launch(spec, caps, *tfp.operands, qbuf, stage0_loads=loads)[0]()
    assert calls[2][0][22] == loads.data_ptr()
    for bad_loads in (torch.zeros((4, 3), dtype=torch.int32), torch.zeros((4, 2))):
        with pytest.raises(ValueError, match="stage0_loads"):
            K.prepare_launch(spec, caps, *tfp.operands, qbuf, stage0_loads=bad_loads)
    assert ints[:9] == [3, spec.n_cols, 4, 21, spec.rounds, spec.store_n, 8, 16, 32]
    kinds = {"c": 0, "b": 1, "w": 2}
    for k, r in enumerate(spec.readers):
        row = ints[9 + 15 * k: 24 + 15 * k]
        assert row[:6] == [kinds[a] for a, _ in r.src] + [b for _, b in r.src]
        assert row[6] == len(r.out) and row[13] == r.prim_rounds
        assert [(row[7 + i], row[10 + i]) for i in range(len(r.out))] == list(r.out)
        assert row[14] == tfp.operands[6 * k + 5].shape[0] - 1
    assert ints[54:58] == list(spec.out_cols) and ints[58:] == [0] * 12
    calls.clear()
    bad = dataclasses.replace(spec, readers=spec.readers[:2])
    with pytest.raises(ValueError, match="readers"):
        K.prepare_launch(bad, caps, *tfp.operands[:12], qbuf[:, :8])
    launch2 = K.prepare_launch(bad, caps[:2], *tfp.operands[:12],
                               torch.zeros((1, 8), dtype=torch.int32))[0]
    with pytest.raises(RuntimeError, match="invalid argument"):
        launch2()  # the stand-in refuses a two-reader launch


# ---------------------------------------------------------------------------
# the kernel's k-ary search, and the precondition that makes it exact
# ---------------------------------------------------------------------------


def _sorted_split_keys(rng, n):
    """A sorted index's split keys, as ``TripleStore.device_keys`` packs
    them: int64 keys, their high words, and their low words with the sign
    bit flipped (so int32 order is unsigned order)."""
    packed = np.sort(rng.integers(0, 1 << 62, size=n, dtype=np.int64))
    packed[n // 3: n // 3 + n // 4] = packed[n // 3]  # a run of equal keys
    khi = (packed >> 32).astype(np.int32)
    klo = ((packed & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return packed, khi, klo


def _group_search(khi, klo, qhi, qlo, upper, lo, hi, G):
    """``csrc/scan_join.cu::group_search`` with ``G`` pivots a round (its
    lanes times the pivots each lane probes): pivot k is
    ``lo + (k + 1) * w // (G + 1)``, the probes' ``before`` bits must be a
    prefix in k, and their count c leaves the window (pivot c-1, pivot c].
    Returns (point, rounds)."""
    rounds = 0
    while lo < hi:
        w = hi - lo
        piv = [lo + (k + 1) * w // (G + 1) for k in range(G)]
        bits = []
        for g in piv:
            tail = klo[g] <= qlo if upper else klo[g] < qlo
            bits.append(bool(khi[g] < qhi or (khi[g] == qhi and tail)))
        c = sum(bits)
        assert bits == [True] * c + [False] * (G - c)
        lo, hi = (piv[c - 1] + 1 if c else lo), (piv[c] if c < G else hi)
        rounds += 1
    return lo, rounds


def _kary_rounds(w: int, G: int) -> int:
    """The most rounds a (G + 1)-ary search takes over w rows: each round
    leaves at most w // (G + 1) of them (G = 1: bit_length(w))."""
    r = 0
    while w:
        w //= G + 1
        r += 1
    return r


@pytest.mark.parametrize("G", [32 * 32, 32, 16, 1])
def test_kary_search_finds_the_bisections_row(G):
    rng = np.random.default_rng(G)
    n = 3000
    packed, khi, klo = _sorted_split_keys(rng, n)
    windows = [(0, n), (5, 5), (7, 8), (100, 132), (100, 133), (0, 1024), (1, 1026),
               (n - 1, n)] + [tuple(sorted(rng.integers(0, n + 1, size=2))) for _ in range(6)]
    probes = np.concatenate([packed[rng.integers(0, n, size=6)], packed[[0, n // 3, n - 1]],
                             rng.integers(0, 1 << 62, size=4, dtype=np.int64), [0, (1 << 62)]])
    qhi = (probes >> 32).astype(np.int32)
    qlo = ((probes & 0xFFFFFFFF).astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    th, tl = torch.from_numpy(khi), torch.from_numpy(klo)
    for lo, hi in windows:
        lo, hi = int(lo), int(hi)
        w = hi - lo
        for upper in (False, True):
            want = K.lex_search2(th, tl, torch.from_numpy(qhi), torch.from_numpy(qlo), upper,
                                 max(1, w.bit_length()), torch.tensor(lo), torch.tensor(hi))
            for i in range(len(probes)):
                got, rounds = _group_search(khi, klo, int(qhi[i]), int(qlo[i]), upper,
                                            lo, hi, G)
                assert got == int(want[i]), (lo, hi, upper, i)
                assert rounds <= _kary_rounds(w, G)
    assert _kary_rounds(2**20, 32) == 4 and _kary_rounds(32, 32) == 1
    assert _kary_rounds(33, 32) == 2 and _kary_rounds(16, 16) == 1
    assert _kary_rounds(1025 * 1025 - 1, 1024) == 2 and _kary_rounds(2**20, 1) == 21


def _serve_template_texts():
    from test_fastpath import CHAIN_TEMPLATES
    from test_serve import OBJS, PREDS, SUBS, TEMPLATES

    texts = []
    for i in range(len(PREDS)):
        p = [PREDS[i], PREDS[(i + 1) % len(PREDS)]]
        texts += [t(p, [OBJS[i]], "2") for t in TEMPLATES]
        texts += [t(p, [SUBS[i]]) for t in CHAIN_TEMPLATES]
    return texts


def _template_stores():
    from test_serve import OBJS, PREDS, SUBS

    from repro_torch.core.executor import create_kg
    from repro_torch.rml import generator

    for seed, n in ((0, 1), (1, 12), (2, 40), (3, 90)):
        rng = np.random.default_rng(seed)
        yield TripleStore.from_ntriples(sorted({
            (SUBS[rng.integers(0, len(SUBS))], PREDS[rng.integers(0, len(PREDS))],
             OBJS[rng.integers(0, len(OBJS))]) for _ in range(n)}), device="cpu")
    for kind in ("SOM", "OJM"):
        tb = generator.make_testbed(kind, 300, 0.5, n_poms=2, seed=5)
        yield create_kg(tb.doc, tables={f"csv:{k}": v for k, v in (
            ("child.csv", tb.child), ("parent.csv", tb.parent)) if v is not None},
            device="cpu").to_store(device="cpu")


def test_search_rounds_cover_every_fastpath_window():
    """Every ChainSpec the fast path builds over the serve templates has
    rounds >= bit_length(store rows) and, per reader, prim_rounds >=
    bit_length(its widest primary-term range): the k-ary searches' answer
    is then the bisection's.  A spec one round short is refused."""
    import dataclasses

    built = 0
    for store in _template_stores():
        ex = get_executor(store)
        for text in _serve_template_texts():
            fp = FP.build(ex, ex.plan(parse_select(text)))
            if fp is None:
                continue
            built += 1
            spec = fp.spec
            assert spec.rounds >= int(store.n_triples).bit_length()
            for i, r in enumerate(spec.readers):
                prim = fp.operands[6 * i + 5].numpy()
                assert r.prim_rounds >= int(np.diff(prim).max()).bit_length()
            ops = [fp.operands[6 * i: 6 * i + 6] for i in range(len(spec.readers))]
            K.check_search_rounds(spec, ops)
            if spec.rounds > 1:
                with pytest.raises(ValueError, match="search rounds"):
                    K.check_search_rounds(dataclasses.replace(spec, rounds=spec.rounds - 1),
                                          ops)
            short = tuple(dataclasses.replace(r, prim_rounds=r.prim_rounds - 1)
                          for r in spec.readers)
            widest = [int(np.diff(o[5].numpy()).max()) for o in ops]
            if any(r.prim_rounds < w.bit_length() for r, w in zip(short, widest)):
                with pytest.raises(ValueError, match="seeded search rounds"):
                    K.check_search_rounds(dataclasses.replace(spec, readers=short), ops)
    assert built > 50
