"""The port's ``.kgz`` stores and single-pattern queries against the JAX package.

Every comparison is exact: ``.kgz`` files byte for byte (eager and streamed
rdfize, planner on and off, both CLIs), the stores' device arrays, the
index ranges and counts of triple patterns, the value tables FILTER and
ORDER BY read, and the planner's ``explain()`` text.  The port runs with
``device="cpu"``; a snapshot written by either package opens in the other.
"""

import numpy as np
import pytest
import torch

from repro.core.executor import create_kg as jax_create_kg
from repro.kg import persist as jpersist
from repro.kg.bench import bench_single_pattern as jax_bench, make_workload
from repro.kg.query import match_counts as jax_match_counts
from repro.kg.query import match_ranges as jax_match_ranges
from repro.kg.store import TripleStore as JStore
from repro.launch import rdfize as jax_rdfize
from repro.rml import generator, serializer
from repro.serve import parse_select as jparse
from repro.serve.plan import plan_query as jax_plan_query
from repro.serve.values import value_table as jax_value_table
from repro_torch import convert
from repro_torch.core.executor import create_kg
from repro_torch.kg import persist
from repro_torch.kg.bench import bench_single_pattern
from repro_torch.kg.query import match_counts, match_ranges, match_pattern
from repro_torch.kg.store import ORDERS, TripleStore
from repro_torch.launch import rdfize
from repro_torch.rml import parser
from repro_torch.serve import parse_select
from repro_torch.serve.plan import plan_query
from repro_torch.serve.values import value_table

N_ROWS = 600
KINDS = ("SOM", "ORM", "OJM")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def testbeds(tmp_path_factory):
    out = {}
    for kind in KINDS:
        tb = generator.make_testbed(kind, N_ROWS, 0.5, n_poms=2, seed=3)
        d = tmp_path_factory.mktemp(kind)
        tb.write(str(d))
        serializer.write_turtle(tb.doc, str(d / "map.ttl"))
        out[kind] = (tb.doc, d)
    return out


@pytest.fixture(scope="module")
def stores(testbeds):
    """(JAX store, port store on the CPU) of each testbed's eager KG."""
    out = {}
    for kind, (doc, d) in testbeds.items():
        js = jax_create_kg(doc, data_root=str(d)).to_store()
        ts = create_kg(parser.parse_file(str(d / "map.ttl")), data_root=str(d),
                       device="cpu").to_store(device="cpu")
        out[kind] = (js, ts)
    return out


def _kgz(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mapping_plan", [True, False])
def test_kgz_bytes_equal_jax(testbeds, tmp_path, kind, stream, mapping_plan):
    doc, d = testbeds[kind]
    cfg = dict(stream=stream, mapping_plan=mapping_plan, block_rows=256)
    js = jax_create_kg(doc, data_root=str(d), **cfg).to_store()
    ts = create_kg(parser.parse_file(str(d / "map.ttl")), data_root=str(d),
                   device="cpu", **cfg).to_store(device="cpu")
    jpersist.save(js, str(tmp_path / "jax.kgz"))
    sid = persist.save(ts, str(tmp_path / "torch.kgz"))
    assert _kgz(tmp_path / "torch.kgz") == _kgz(tmp_path / "jax.kgz")
    assert sid == js._snapshot_id and ts.n_triples == js.n_triples > 0
    assert ts.device == torch.device("cpu")


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_rdfize_emit_kgz_cli_identical(testbeds, tmp_path, monkeypatch, kind):
    _, d = testbeds[kind]
    args = ["--mapping", str(d / "map.ttl"), "--data-root", str(d), "--emit", "kgz"]
    monkeypatch.setattr("sys.argv", ["rdfize", *args, "--out", str(tmp_path / "jax.kgz")])
    jax_rdfize.main()
    rdfize.main([*args, "--out", str(tmp_path / "torch.kgz"), "--device", "cpu"])
    assert _kgz(tmp_path / "torch.kgz") == _kgz(tmp_path / "jax.kgz")


def _same_store(a, b) -> None:
    """A JAX store and a port store (either way round) hold the same data."""
    for f in ("term_pat", "term_val", "s", "p", "o"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    assert a.dictionary.strings() == b.dictionary.strings()
    for order in ORDERS:
        assert np.array_equal(a.indexes[order].perm, b.indexes[order].perm)
        for x, y in zip(a.indexes[order].cols, b.indexes[order].cols):
            assert np.array_equal(x, y)
    assert [a.decode_term(t) for t in range(a.n_terms)] == [
        b.decode_term(t) for t in range(b.n_terms)]


def test_kgz_opens_across_packages(stores, tmp_path):
    js, ts = stores["OJM"]
    jpersist.save(js, str(tmp_path / "jax.kgz"))
    persist.save(ts, str(tmp_path / "torch.kgz"))
    from_jax = persist.load(str(tmp_path / "jax.kgz"), device="cpu")
    from_torch = jpersist.load(str(tmp_path / "torch.kgz"))
    _same_store(js, from_jax)
    _same_store(from_torch, ts)
    assert from_jax._snapshot_id == js._snapshot_id
    assert from_torch._snapshot_id == from_jax._snapshot_id
    # the open-store cache keys on the device as well as the file
    a = persist.open_store(str(tmp_path / "jax.kgz"), device="cpu")
    assert persist.open_store(str(tmp_path / "jax.kgz"), device="cpu") is a
    assert a.device == torch.device("cpu") and persist.peek_meta(
        str(tmp_path / "jax.kgz")) == jpersist.peek_meta(str(tmp_path / "jax.kgz"))


def test_store_from_arrays_matches(stores):
    js, ts = stores["SOM"]
    got = convert.store_from_arrays(
        js.dictionary.strings(), js.term_pat, js.term_val, js.s, js.p, js.o,
        perms={o: js.indexes[o].perm for o in ORDERS},
        cols={o: js.indexes[o].cols for o in ORDERS}, device="cpu")
    _same_store(js, got)
    bad = {o: js.indexes[o].cols for o in ORDERS}
    bad["spo"] = (bad["spo"][1], bad["spo"][0], bad["spo"][2])
    with pytest.raises(ValueError, match="spo"):
        convert.store_from_arrays(
            js.dictionary.strings(), js.term_pat, js.term_val, js.s, js.p, js.o,
            perms={o: js.indexes[o].perm for o in ORDERS}, cols=bad, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_device_arrays_equal(stores, kind):
    js, ts = stores[kind]
    for order in ORDERS:
        for a, b in zip(ts.device_cols(order), js.device_cols(order)):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(ts.device_keys(order), js.device_keys(order)):
            assert a.dtype == torch.int32 and np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(ts.device_primary_starts(order).numpy(),
                              np.asarray(js.device_primary_starts(order)))
        assert ts.primary_rounds(order) == js.primary_rounds(order)


def test_unpacked_store_has_no_keys(stores, monkeypatch):
    """A store with term ids past the packed key fields: both packages
    return no split keys and answer patterns with the 3-column search."""
    js, ts = stores["SOM"]
    monkeypatch.setattr(JStore, "KEY_BITS", 6)
    monkeypatch.setattr(TripleStore, "KEY_BITS", 6)
    assert ts.n_terms >= (1 << 6) - 2
    for order in ORDERS:
        assert ts.device_keys(order) is None and js.device_keys(order) is None
    w = make_workload(js, 300, seed=4)
    assert np.array_equal(match_counts(ts, w), jax_match_counts(js, w))


@pytest.mark.parametrize("kind", KINDS)
def test_match_ranges_and_counts_equal(stores, kind):
    js, ts = stores[kind]
    w = make_workload(js, 700, seed=1)
    rng = np.random.default_rng(2)
    # all 8 masks, unknown (-2 / past the last term) and all-wildcard rows
    extra = np.stack([rng.integers(-2, js.n_terms + 3, 64) for _ in range(3)], axis=1)
    extra[rng.random((64, 3)) < 0.4] = -1
    w = np.concatenate([w, extra.astype(np.int32), [[-1, -1, -1]]]).astype(np.int32)
    ws, we, wo = jax_match_ranges(js, w)
    gs, ge, go = match_ranges(ts, w)
    assert go == wo and np.array_equal(gs, ws) and np.array_equal(ge, we)
    assert np.array_equal(match_counts(ts, w), jax_match_counts(js, w))
    row = [int(x) for x in w[0]]
    from repro.kg.query import match_pattern as jax_match_pattern

    spo = [None if x < 0 else x for x in row]
    assert np.array_equal(match_pattern(ts, spo), jax_match_pattern(js, spo))


def test_bench_single_pattern_matches_jax(stores):
    js, ts = stores["OJM"]
    got = bench_single_pattern(ts, n_queries=512, batch=128, seed=5)
    want = jax_bench(js, n_queries=512, batch=128, seed=5)
    assert got["total_matches"] == want["total_matches"] > 0
    assert got["n_queries"] == 512


def _literal_store(device="cpu", cls=TripleStore):
    """IRIs, integers, decimals, strings, an empty literal and a literal
    with template braces: every class the value table ranks."""
    objs = ['"10"', '"9"', '"-3"', '"2.5"', '"1e3"', '"abc"', '"Abc"', '""',
            '"braces {} inside"', '"nan"', '"inf"', "<http://ex/o1>", "<http://ex/a>"]
    t = [(f"<http://ex/s{i % 4}>", f"<http://ex/p{i % 2}>", o) for i, o in enumerate(objs)]
    return cls.from_ntriples(t, device=device) if cls is TripleStore else cls.from_ntriples(t)


@pytest.mark.parametrize("which", ["literals", "OJM"])
def test_value_table_equal(stores, which):
    if which == "literals":
        js, ts = _literal_store(cls=JStore), _literal_store()
    else:
        js, ts = stores[which]
    jv, tv = jax_value_table(js), value_table(ts)
    for f in ("is_lit", "is_num", "str_rank", "num_rank", "order_rank"):
        got, want = getattr(tv, f), np.asarray(getattr(jv, f))
        assert got.device == ts.device and np.array_equal(got.numpy(), want), f
    assert tv.order_rank.dtype == torch.int32
    assert tv.order_is_tid == jv.order_is_tid
    assert list(tv.str_uniq) == list(jv.str_uniq)
    assert np.array_equal(tv.num_uniq, jv.num_uniq)
    for x in (-5.0, 2.5, 9.0, 10.0, 1e9):
        assert tv.num_bounds(x) == jv.num_bounds(x)
    for b in ("", "Abc", "abc", "zzz"):
        assert tv.str_bounds(b) == jv.str_bounds(b)


EXPLAIN_QUERIES = [
    "SELECT * WHERE {{ ?s {p0} ?o }}",
    "SELECT * WHERE {{ ?s {p0} ?o . ?s {p1} ?r }}",
    "SELECT * WHERE {{ ?s {p0} ?o . ?o {p1} ?r }}",
    "SELECT ?s WHERE {{ ?s {p0} ?o OPTIONAL {{ ?s {p1} ?r . ?r {p0} ?z }} }}",
    "SELECT * WHERE {{ {{ ?s {p0} ?o }} UNION {{ ?s {p1} ?o }} FILTER(?o > 3) }}",
    "SELECT ?o (COUNT(*) AS ?n) WHERE {{ ?s {p0} ?o }} GROUP BY ?o ORDER BY DESC(?n)",
    "SELECT DISTINCT ?o WHERE {{ ?s ?p ?o }} LIMIT 3",
    "SELECT * WHERE {{ ?x ?p ?x }}",
]


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_explain_text_equal(stores, kind):
    js, ts = stores[kind]
    preds = sorted({js.decode_term(int(p)) for p in np.unique(js.p)})
    for text in EXPLAIN_QUERIES:
        q = text.format(p0=preds[0], p1=preds[-1])
        assert plan_query(ts, parse_select(q)).explain() == jax_plan_query(
            js, jparse(q)).explain(), q


def test_from_ntriples_term_ids_equal():
    js, ts = _literal_store(cls=JStore), _literal_store()
    _same_store(js, ts)


def test_live_snapshots_over_a_testbed_store_match_jax(stores, tmp_path):
    """A delta snapshot over each package's testbed store: the full and the
    delta files are the same bytes, and each package resolves both chains
    to the same live triple set."""
    js, ts = stores["SOM"]
    rows = [tuple(ts.decode_term(int(c[i])) for c in (ts.s, ts.p, ts.o))
            for i in range(0, ts.n_triples, 9)]
    lives = {}
    for name, store, pkg in (("jax", js, jpersist), ("torch", ts, persist)):
        d = tmp_path / name
        d.mkdir()
        pkg.save(store, str(d / "p.kgz"))
        live = (pkg.load_chain(str(d / "p.kgz")) if pkg is jpersist
                else pkg.load_chain(str(d / "p.kgz"), device="cpu"))
        live.insert([(f"<http://ex/live{i}>", r[1], r[2]) for i, r in enumerate(rows[:40])])
        live.delete(rows[:60])
        pkg.save_delta(live, str(d / "d.kgz"), "p.kgz")
        lives[name] = live
    for f in ("p.kgz", "d.kgz"):
        assert _kgz(tmp_path / "torch" / f) == _kgz(tmp_path / "jax" / f), f
    want = set(lives["jax"].rendered_triples())
    assert set(persist.load_chain(str(tmp_path / "jax" / "d.kgz"),
                                  device="cpu").rendered_triples()) == want
    assert set(jpersist.load_chain(str(tmp_path / "torch" / "d.kgz")).rendered_triples()) == want
    assert set(lives["torch"].rendered_triples()) == want
