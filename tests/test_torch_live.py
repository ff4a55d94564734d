"""repro_torch.live and the executor's overlay arm against the JAX package.

The same numpy-seeded base graphs and mutation sequences (``tests/test_live.py``'s
helpers) go through ``repro.live.LiveStore`` + ``repro.serve`` and through
``repro_torch.live.LiveStore`` + ``repro_torch.serve`` on the CPU.  Every
comparison is exact: overlay rows and term ids, batch counts and ``exec.*``
counters, compacted ``.kgz`` bytes, delta-snapshot bytes, and chains written
by one package and loaded by the other.
"""

import numpy as np
import pytest
import torch

from repro.kg import persist as jpersist
from repro.kg.store import TripleStore as JStore
from repro.live import LiveStore as JLive
from repro.obs import get_registry as jax_registry
from repro.serve import parse_select as jparse
from repro.serve.exec import get_executor as jax_executor
from repro_torch.kg import persist
from repro_torch.kg.query import parse_bgp, solve
from repro_torch.kg.store import TripleStore
from repro_torch.live import LiveStore
from repro_torch.obs import get_registry
from repro_torch.serve import oracle_select, parse_select
from repro_torch.serve.exec import get_executor
from test_live import TEMPLATES as LIVE_TEMPLATES
from test_live import NEW_LITS, NEW_SUBS, as_multiset, rand_base, rand_ops
from test_serve import OBJS, PREDS, SUBS
from test_serve import TEMPLATES as ALGEBRA_TEMPLATES
from test_fastpath import CHAIN_TEMPLATES

COUNTERS = ("exec.dispatches", "exec.fastpath_dispatches", "exec.cap_growth",
            "exec.redispatches", "exec.batches", "exec.queries",
            "exec.pipeline_cache_hit", "exec.pipeline_cache_miss")
SEEDS = (0, 1, 2, 3, 5, 8, 13, 21)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_live(base_trips):
    return (JLive(JStore.from_ntriples(base_trips)),
            LiveStore(TripleStore.from_ntriples(base_trips, device="cpu")))


def _apply(live, ops) -> list:
    """Apply ``ops``; the return value of every mutation, in order."""
    out = []
    for kind, trips in ops:
        if kind == "insert":
            out.append(live.insert(trips))
        elif kind == "delete":
            out.append(live.delete(trips))
        else:
            live.compact()
            out.append(None)
    return out


def _mutated(seed: int, n_ops=None):
    """The two live stores after the same random mutation sequence
    (``tests/test_live.py::test_live_matches_oracle``'s recipe)."""
    rng = np.random.default_rng(seed)
    base = rand_base(rng, int(rng.integers(0, 25)))
    jl, tl = _both_live(base)
    model = {t for t in base}
    ops = rand_ops(rng, model, n_ops=int(rng.integers(1, 7)) if n_ops is None else n_ops)
    assert _apply(jl, ops) == _apply(tl, ops)
    return jl, tl, ops


def _counts(reg) -> dict:
    return {k: reg.counter(k).value for k in COUNTERS}


def _run_view(ex, live, parse, texts):
    reg = jax_registry() if parse is jparse else get_registry()
    qs = [parse(t) for t in texts]
    before = _counts(reg)
    res = ex.execute(ex.plan(qs[0]), qs, view=live.view())
    after = _counts(reg)
    return res, {k: after[k] - before[k] for k in COUNTERS}


def _same(jres, tres, bsz: int) -> None:
    assert tres.vars == jres.vars and tres.agg_vars == jres.agg_vars
    assert np.array_equal(tres.counts, jres.counts)
    for i in range(bsz):
        assert tres.ids(i) == jres.ids(i), i
        assert tres.rows(i) == jres.rows(i), i


def _kgz_bytes(save, store, path) -> bytes:
    save(store, str(path), generation=7)
    return path.read_bytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_overlay_rows_match_jax(seed):
    jl, tl, _ = _mutated(seed)
    assert tl.rendered_triples() == jl.rendered_triples()
    assert (tl.n_triples, tl.n_terms, tl.generation, tl.n_delta, tl.n_tombstones) == (
        jl.n_triples, jl.n_terms, jl.generation, jl.n_delta, jl.n_tombstones)
    for text in LIVE_TEMPLATES:
        jres, tres = jl.solve(jparse(text)), tl.solve(parse_select(text))
        _same(jres, tres, 1)
        want = oracle_select(tl, parse_select(text))
        assert as_multiset(tres.rows(0)) == as_multiset(want), text
    view = tl.view()
    jview = jl.view()
    for order in ("spo", "pos", "osp"):
        a = view.alive(order)
        assert a.dtype == torch.int32 and a.device == tl.base.device
        assert a.tolist() == np.asarray(jview.alive(order)).tolist()
        assert view.alive(order) is a  # cached per order


def _batch(template, bsz: int, seed: int, chain: bool) -> list:
    """``bsz`` signature-equal queries over the widened (overlay) terms."""
    rng = np.random.default_rng(seed)
    out = []
    subs, objs = SUBS + NEW_SUBS, OBJS + NEW_LITS + NEW_SUBS
    for _ in range(bsz):
        p = [PREDS[rng.integers(0, len(PREDS))] for _ in range(2)]
        if chain:
            out.append(template(p, [subs[rng.integers(0, len(subs))]]))
        else:
            o = [objs[rng.integers(0, len(objs))]]
            x = ["-3", "1", "2.5", "100"][rng.integers(0, 4)]
            out.append(template(p, o, x))
    sig = jparse(out[0]).signature()
    return [t for t in out if jparse(t).signature() == sig]


def _check_overlay_batches(t: int, template, chain: bool) -> None:
    jl, tl, _ = _mutated(100 + t + 50 * chain, n_ops=6)
    extra = [(NEW_SUBS[0], PREDS[0], NEW_LITS[0]), (SUBS[0], PREDS[1], '"7.5"')]
    assert tl.insert(extra) == jl.insert(extra)
    assert jl.view().active and tl.view().active
    jex, tex = jax_executor(jl.base), get_executor(tl.base)
    for bsz in (1, 8):
        texts = _batch(template, bsz, 1000 * t + bsz, chain)
        jres, jd = _run_view(jex, jl, jparse, texts)
        tres, td = _run_view(tex, tl, parse_select, texts)
        _same(jres, tres, len(texts))
        assert td == jd, (texts[0], bsz)


@pytest.mark.parametrize("t", range(len(ALGEBRA_TEMPLATES)))
def test_overlay_algebra_batches_match_jax(t):
    """Every algebra template over an active overlay at batch 1 and 8: the
    same rows, counts and ``exec.*`` counters (so the same dispatches,
    capacity growth and pipeline-cache keys) as JAX's."""
    _check_overlay_batches(t, ALGEBRA_TEMPLATES[t], False)


@pytest.mark.parametrize("t", range(len(CHAIN_TEMPLATES)))
def test_overlay_chain_batches_match_jax(t):
    """The fast path's chain templates over an active overlay: the general
    pipeline answers them, as JAX's does."""
    _check_overlay_batches(t, CHAIN_TEMPLATES[t], True)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_compacted_bytes_match_jax(seed, tmp_path):
    jl, tl, _ = _mutated(seed + 77)
    jb = _kgz_bytes(jpersist.save, jl.compact(), tmp_path / "j.kgz")
    tb = _kgz_bytes(persist.save, tl.compact(), tmp_path / "t.kgz")
    assert tb == jb
    rebuilt = TripleStore.from_ntriples(sorted(tl.rendered_triples()), device="cpu")
    assert _kgz_bytes(persist.save, rebuilt, tmp_path / "r.kgz") == tb
    for text in LIVE_TEMPLATES:  # canonical ids again: the oracle's order
        q = parse_select(text)
        assert tl.solve(q).rows(0) == oracle_select(tl, q)


def _tiny(pkg_store, pkg_live):
    return pkg_live(pkg_store.from_ntriples(
        [("<http://ex/s0>", "<http://ex/p0>", '"1"'),
         ("<http://ex/s1>", "<http://ex/p0>", '"2"')],
        **({"device": "cpu"} if pkg_store is TripleStore else {})))


def _mutate_tiny(live):
    live.insert([("<http://ex/new0>", "<http://ex/p1>", '"9"'),
                 ("<http://ex/s0>", "<http://ex/p2>", "<http://ex/new1>")])
    live.delete([("<http://ex/s1>", "<http://ex/p0>", '"2"')])


def test_delta_snapshot_bytes_and_chains_cross_load(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jl, tl = _tiny(JStore, JLive), _tiny(TripleStore, LiveStore)
    jpersist.save(jl.base, str(jdir / "base.kgz"))
    persist.save(tl.base, str(tdir / "base.kgz"))
    assert (jdir / "base.kgz").read_bytes() == (tdir / "base.kgz").read_bytes()
    _mutate_tiny(jl)
    _mutate_tiny(tl)
    jsid = jpersist.save_delta(jl, str(jdir / "delta.kgz"), "base.kgz")
    tsid = persist.save_delta(tl, str(tdir / "delta.kgz"), "base.kgz")
    assert tsid == jsid
    assert (tdir / "delta.kgz").read_bytes() == (jdir / "delta.kgz").read_bytes()
    assert persist.peek_meta(str(tdir / "delta.kgz")) == jpersist.peek_meta(
        str(jdir / "delta.kgz"))
    # each package resolves the chain the other wrote
    t_from_j = persist.load_chain(str(jdir / "delta.kgz"), device="cpu")
    j_from_t = jpersist.load_chain(str(tdir / "delta.kgz"))
    assert t_from_j.rendered_triples() == jl.rendered_triples()
    assert j_from_t.rendered_triples() == tl.rendered_triples()
    assert t_from_j.generation == jl.generation == j_from_t.generation
    for text in LIVE_TEMPLATES:
        assert (t_from_j.solve(parse_select(text)).rows(0)
                == j_from_t.solve(jparse(text)).rows(0)), text
    # a full snapshot load_chains to an empty overlay; a delta file is not
    # a full store
    full = persist.load_chain(str(tdir / "base.kgz"), device="cpu")
    assert full.n_delta == full.n_tombstones == 0
    with pytest.raises(ValueError, match="delta snapshot"):
        persist.load(str(tdir / "delta.kgz"), device="cpu")


def test_delta_snapshot_lineage_errors(tmp_path):
    tl = _tiny(TripleStore, LiveStore)
    tl.insert([("<http://ex/new0>", "<http://ex/p1>", '"9"')])
    with pytest.raises(ValueError, match="snapshot id"):
        persist.save_delta(tl, str(tmp_path / "never.kgz"), "base.kgz")
    persist.save(tl.base, str(tmp_path / "base.kgz"))
    persist.save_delta(tl, str(tmp_path / "delta.kgz"), "base.kgz")
    other = TripleStore.from_ntriples(
        [("<http://ex/sX>", "<http://ex/p0>", '"1"')], device="cpu")
    persist.save(other, str(tmp_path / "base.kgz"))
    with pytest.raises(ValueError, match="snapshot id mismatch"):
        persist.load_chain(str(tmp_path / "delta.kgz"), device="cpu")


def test_empty_base_overlay_matches_jax():
    jl, tl = JLive(JStore.from_ntriples([])), LiveStore(TripleStore.from_ntriples([], device="cpu"))
    t = ("<http://ex/a>", "<http://ex/p>", '"1"')
    u = ("<http://ex/b>", "<http://ex/p>", "<http://ex/a>")
    assert tl.insert([t, u]) == jl.insert([t, u]) == 2
    texts = ["SELECT ?s ?o WHERE { ?s ?p ?o }",
             "SELECT * WHERE { ?s <http://ex/p> ?o . ?o <http://ex/p> ?x }",
             "SELECT ?s WHERE { <http://ex/b> ?p ?s }",
             "SELECT (COUNT(*) AS ?n) WHERE { ?s ?p ?o }"]
    for text in texts:
        _same(jl.solve(jparse(text)), tl.solve(parse_select(text)), 1)
    assert tl.solve(parse_select(texts[0])).rows(0) == [
        ("<http://ex/a>", '"1"'), ("<http://ex/b>", "<http://ex/a>")]
    tl.delete([t, u])
    jl.delete([t, u])
    for text in texts:
        _same(jl.solve(jparse(text)), tl.solve(parse_select(text)), 1)
    assert tl.compact().n_triples == 0


def test_tombstones_resurrect_and_dupes_match_jax():
    jl, tl = _tiny(JStore, JLive), _tiny(TripleStore, LiveStore)
    t = ("<http://ex/s0>", "<http://ex/p0>", '"1"')
    t2 = ("<http://ex/new1>", "<http://ex/p1>", '"5"')
    steps = [("insert", [t]), ("delete", [t]), ("insert", [t]),
             ("delete", [("<http://ex/zz>", "<http://ex/p0>", '"1"')]),
             ("insert", [t2, t2]), ("delete", [t2]), ("delete", [t, t])]
    for kind, trips in steps:
        assert getattr(tl, kind)(trips) == getattr(jl, kind)(trips), (kind, trips)
        assert (tl.n_triples, tl.n_delta, tl.n_tombstones, tl.generation) == (
            jl.n_triples, jl.n_delta, jl.n_tombstones, jl.generation)
        for text in LIVE_TEMPLATES[:3]:
            _same(jl.solve(jparse(text)), tl.solve(parse_select(text)), 1)
    assert (tl.n_tombstones, tl.n_triples) == (1, 1)


def test_overlay_falls_back_to_general():
    """``tests/test_fastpath.py::test_overlay_falls_back_to_general`` held
    for the port: an overlay view never takes the fast path (kernel K4 on
    the card), yet the answers reflect the mutation."""
    trips = [(SUBS[i % 5], PREDS[i % 3], OBJS[i % len(OBJS)]) for i in range(30)]
    store = TripleStore.from_ntriples(sorted(set(trips)), device="cpu")
    live = LiveStore(store)
    ex = get_executor(store)
    q = parse_select("SELECT * WHERE { ?s <http://ex/p0> ?o }")
    plan = ex.plan(q)
    reg = get_registry()
    before = reg.counter("exec.fastpath_dispatches").value
    base_n = ex.execute(plan, [q]).n(0)
    assert reg.counter("exec.fastpath_dispatches").value == before + 1
    live.insert([("<http://ex/new>", "<http://ex/p0>", '"live"')])
    before = reg.counter("exec.fastpath_dispatches").value
    res = ex.execute(plan, [q], view=live.view())
    assert reg.counter("exec.fastpath_dispatches").value == before
    assert res.n(0) == base_n + 1
    assert ("<http://ex/new>", '"live"') in res.rows(0)


def test_kg_solve_and_api_on_a_live_store(tmp_path):
    from repro_torch import api

    tl = _tiny(TripleStore, LiveStore)
    tl.insert([("<http://ex/s2>", "<http://ex/p0>", '"3"')])
    assert solve(tl, parse_bgp("?s <http://ex/p0> ?o")).n == 3
    path = str(tmp_path / "kg.kgz")
    persist.save(tl.base, path)
    with api.connect(path, device="cpu") as sess:  # mutable by default
        r = sess.insert([("<http://ex/s9>", "<http://ex/p0>", '"9"')])
        assert (r["inserted"], r["n_total"]) == (1, 3)
        d = sess.delete([("<http://ex/s0>", "<http://ex/p0>", '"1"')])
        assert (d["deleted"], d["tombstoned"], d["n_total"]) == (1, 1, 2)
        got = sess.query("SELECT ?s ?o WHERE { ?s <http://ex/p0> ?o }")
        assert sorted(got.rows) == [("<http://ex/s1>", '"2"'), ("<http://ex/s9>", '"9"')]
        c = sess.compact()
        assert c["compacted"] and c["n_total"] == 2
        assert sess.query("SELECT ?s ?o WHERE { ?s <http://ex/p0> ?o }").rows == [
            ("<http://ex/s1>", '"2"'), ("<http://ex/s9>", '"9"')]
