"""The port's query executor, fast path and entry points against the JAX package.

Rows must be identical — the same ids in the same order — for every
algebra template of ``tests/test_serve.py`` and every chain template of
``tests/test_fastpath.py``, and for the six query classes of
``serve/bench.py``, at batch 1, 8, 64 and 200, with the small-batch fast
path on and off; the executor's dispatch counters must move exactly as the
JAX executor's do.  Then the entry points: ``api.connect`` and
``python -m repro_torch.launch.query --device cpu`` print what the JAX CLI
prints on the same ``.kgz``, and asking for the card without one raises.
"""

import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.kg.query import solve_text as jax_solve_text
from repro.kg.store import TripleStore as JStore
from repro.launch import query as jax_query_cli
from repro.obs import get_registry as jax_registry
from repro.rml import generator, serializer
from repro.serve import bench as jax_bench
from repro.serve import parse_select as jparse
from repro.serve.exec import get_executor as jax_executor
from repro_torch import api
from repro_torch.api import ReadOnlyError
from repro_torch.core.executor import create_kg
from repro_torch.kg import persist
from repro_torch.kg.query import solve_text
from repro_torch.kg.store import TripleStore
from repro_torch.launch import query as query_cli
from repro_torch.obs import get_registry
from repro_torch.rml import parser
from repro_torch.serve import bench, oracle_select, parse_select
from repro_torch.serve.exec import get_executor
from test_fastpath import CHAIN_TEMPLATES
from test_serve import OBJS, PREDS, SUBS, TEMPLATES

COUNTERS = ("exec.dispatches", "exec.fastpath_dispatches", "exec.cap_growth",
            "exec.redispatches", "exec.batches", "exec.queries",
            "exec.pipeline_cache_hit", "exec.pipeline_cache_miss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_triples(seed: int, n: int) -> list:
    """``tests/test_serve.py::rand_store``'s triples."""
    rng = np.random.default_rng(seed)
    return sorted({
        (SUBS[rng.integers(0, len(SUBS))], PREDS[rng.integers(0, len(PREDS))],
         OBJS[rng.integers(0, len(OBJS))])
        for _ in range(n)
    })


def _both_stores(seed: int, n: int):
    t = _rand_triples(seed, n)
    return JStore.from_ntriples(t), TripleStore.from_ntriples(t, device="cpu")


def _counts(reg) -> dict:
    return {k: reg.counter(k).value for k in COUNTERS}


def _run(ex, parse, texts, fast: bool):
    """One micro-batch of signature-equal queries; (result, counter deltas)."""
    reg = jax_registry() if parse is jparse else get_registry()
    qs = [parse(t) for t in texts]
    before = _counts(reg)
    ex.fastpath_enabled = fast
    try:
        res = ex.execute(ex.plan(qs[0]), qs)
    finally:
        ex.fastpath_enabled = True
    after = _counts(reg)
    return res, {k: after[k] - before[k] for k in COUNTERS}


def _same_results(jres, tres, bsz: int) -> None:
    assert tres.vars == jres.vars and tres.agg_vars == jres.agg_vars
    assert np.array_equal(tres.counts, jres.counts)
    for i in range(bsz):
        assert tres.ids(i) == jres.ids(i), i


def _batch_texts(template, bsz: int, seed: int, chain: bool) -> list:
    """``bsz`` queries of one signature: the template over varying
    predicate / object / number constants."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(bsz):
        p = [PREDS[rng.integers(0, len(PREDS))] for _ in range(2)]
        if chain:
            out.append(template(p, [SUBS[rng.integers(0, len(SUBS))]]))
        else:
            o = [OBJS[rng.integers(0, len(OBJS))]]
            x = ["-3", "1", "2.5", "100"][rng.integers(0, 4)]
            out.append(template(p, o, x))
    sig = jparse(out[0]).signature()
    return [t for t in out if jparse(t).signature() == sig]


def _check_batches(seed, template, chain, batches):
    js, ts = _both_stores(seed, 10 + 3 * seed)
    jex, tex = jax_executor(js), get_executor(ts)
    for bsz in batches:
        texts = _batch_texts(template, bsz, seed * 1000 + bsz, chain)
        for fast in (True, False):
            jres, jd = _run(jex, jparse, texts, fast)
            tres, td = _run(tex, parse_select, texts, fast)
            _same_results(jres, tres, len(texts))
            assert td == jd, (texts[0], bsz, fast)
    assert tex.dispatches == jex.dispatches


@pytest.mark.parametrize("t", range(len(TEMPLATES)))
def test_algebra_templates_match_jax(t):
    _check_batches(t % 7, TEMPLATES[t], False, (1, 64))


@pytest.mark.parametrize("t", range(len(CHAIN_TEMPLATES)))
def test_chain_templates_match_jax(t):
    _check_batches(t + 3, CHAIN_TEMPLATES[t], True, (1, 8, 64, 200))


def test_rows_agree_with_the_oracle():
    _, ts = _both_stores(11, 30)
    for t in (1, 3, 6, 11, 14, 17):
        text = TEMPLATES[t](PREDS[:2], OBJS[:1], "1")
        q = parse_select(text)
        assert get_executor(ts).solve(q).rows(0) == oracle_select(ts, q), text


@pytest.fixture(scope="module")
def testbed_stores(tmp_path_factory):
    out = {}
    for kind in ("SOM", "OJM"):
        tb = generator.make_testbed(kind, 600, 0.5, n_poms=2, seed=9)
        d = tmp_path_factory.mktemp(kind)
        tb.write(str(d))
        serializer.write_turtle(tb.doc, str(d / "map.ttl"))
        from repro.core.executor import create_kg as jax_create_kg

        js = jax_create_kg(tb.doc, data_root=str(d)).to_store()
        ts = create_kg(parser.parse_file(str(d / "map.ttl")), data_root=str(d),
                       device="cpu").to_store(device="cpu")
        out[kind] = (js, ts, d)
    return out


@pytest.mark.parametrize("kind", ["SOM", "OJM"])
def test_bench_classes_match_jax(testbed_stores, kind):
    """The six query classes ``serve/bench.py`` drives, pre-encoded the
    same way in both packages: at batch 1, 8, 64 and 200 for the chain
    classes (the fast path's window and past it), 1, 64 and 200 for the
    rest, and 64 on the SOM store."""
    js, ts, _ = testbed_stores[kind]
    jp0, jclasses = jax_bench._classes(js)
    p0, classes = bench._classes(ts)
    assert classes == jclasses and p0 == jp0
    assert bench.CLASS_NAMES == jax_bench.CLASS_NAMES
    jex, tex = jax_executor(js), get_executor(ts)
    for name, qtext in classes:
        chain = name in bench.SMALLBATCH_CLASSES
        for batch in ((1, 8, 64, 200) if chain else (1, 64, 200)) if kind == "OJM" else (64,):
            jplan, jb, jfops = jax_bench._encoded_batches(jex, qtext, p0, batch, 1, 0)
            plan, tb, fops = bench._encoded_batches(tex, qtext, p0, batch, 1, 0)
            assert np.array_equal(tb[0], jb[0])
            assert (fops is None) == (jfops is None)
            for fast in (True, False):
                jex.fastpath_enabled = tex.fastpath_enabled = fast
                jb0, tb0 = _counts(jax_registry()), _counts(get_registry())
                jres = jex.execute_encoded(jplan, jb[0], jfops)
                tres = tex.execute_encoded(plan, tb[0], fops)
                jd = {k: v - jb0[k] for k, v in _counts(jax_registry()).items()}
                td = {k: v - tb0[k] for k, v in _counts(get_registry()).items()}
                jex.fastpath_enabled = tex.fastpath_enabled = True
                _same_results(jres, tres, batch)
                assert td == jd, (name, batch, fast)
                assert tres.counts.sum() > 0


def test_api_and_cli_print_the_jax_rows(testbed_stores, tmp_path, monkeypatch, capsys):
    js, ts, _ = testbed_stores["OJM"]
    path = str(tmp_path / "kg.kgz")
    persist.save(ts, path)
    _, classes = bench._classes(ts)
    texts = [q for _, q in classes] + ["?s ?p ?o"]
    jsession = jax_api.connect(path, read_only=True)
    session = api.connect(path, device="cpu")
    for text in texts:
        got, want = session.query(text, limit=7), jsession.query(text, limit=7)
        assert (got.vars, got.rows, got.n_total, got.agg_vars) == (
            want.vars, want.rows, want.n_total, want.agg_vars)
        assert session.explain(text) == jsession.explain(text)
    assert solve_text(ts, texts[1]).cols.keys() == jax_solve_text(js, texts[1]).cols.keys()
    for a, b in zip(solve_text(ts, texts[1]).cols.values(),
                    jax_solve_text(js, texts[1]).cols.values()):
        assert np.array_equal(a, b)
    for args in ([texts[2]], [texts[5], "--limit", "3"], [texts[1], "--explain"]):
        monkeypatch.setattr("sys.argv", ["query", "--kg", path, *args])
        jax_query_cli.main()
        want = capsys.readouterr().out
        query_cli.main(["--kg", path, "--device", "cpu", *args])
        assert capsys.readouterr().out == want and want


def test_cuda_without_a_card_raises(testbed_stores, tmp_path, monkeypatch):
    _, ts, _ = testbed_stores["SOM"]
    path = str(tmp_path / "kg.kgz")
    persist.save(ts, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query_cli.main(["--kg", path, "?s ?p ?o"])  # the default device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.connect(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TripleStore.from_ntriples(_rand_triples(0, 5))


def test_later_slice_surfaces_work(testbed_stores, tmp_path, capsys):
    """The surfaces that raised before the live, server and shard modules
    were ported: a shard manifest through the query CLI and ``connect``, a
    ``"host:port"`` session, mutations on a ``.kgz`` path and an active
    overlay view.  Read-only stores still reject mutations."""
    from repro_torch.live import LiveStore
    from repro_torch.serve.server import KGServer
    from repro_torch.shard import ShardSession, shard_store

    _, ts, _ = testbed_stores["SOM"]
    path = str(tmp_path / "kg.kgz")
    persist.save(ts, path)
    manifest = str(tmp_path / "kg.shards.json")
    shard_store(ts, manifest, 2)
    text = "SELECT ?s ?o WHERE { ?s ?p ?o } LIMIT 7"
    want = api.connect(ts).query(text)
    query_cli.main(["--kg", manifest, "--device", "cpu", text])
    assert "across 2 shards" in capsys.readouterr().err
    with api.connect(manifest, device="cpu") as sess:
        assert isinstance(sess, ShardSession)
        got = sess.query(text)
        assert (got.rows, got.n_total) == (want.rows, want.n_total)
    srv = KGServer(ts, port=0, log=False).start()
    try:
        with api.connect(f"127.0.0.1:{srv.port}") as sess:
            got = sess.query(text)
            assert (got.rows, got.n_total) == (want.rows, want.n_total)
            with pytest.raises(ReadOnlyError):
                sess.insert([("<a>", "<b>", "<c>")])
    finally:
        srv.stop()
    with api.connect(path, device="cpu") as sess:
        assert sess.insert([("<a>", "<b>", "<c>")])["inserted"] == 1
        assert sess.query("SELECT ?o WHERE { <a> <b> ?o }").rows == [("<c>",)]
    with pytest.raises(ReadOnlyError):
        api.connect(path, read_only=True, device="cpu").delete([("<a>", "<b>", "<c>")])
    with pytest.raises(ReadOnlyError):
        api.connect(ts).compact()

    live = LiveStore(ts)
    live.insert([("<a>", "<b>", "<c>")])
    ex = get_executor(ts)
    q = parse_select("SELECT * WHERE { ?s ?p ?o }")
    res = ex.execute(ex.plan(q), [q], view=live.view())
    assert res.n(0) == ts.n_triples + 1 and ("<a>", "<b>", "<c>") in res.rows(0)


def test_warmup_matches_jax(testbed_stores):
    js, ts, _ = testbed_stores["SOM"]
    assert get_executor(ts).warmup() == jax_executor(js).warmup() > 0
