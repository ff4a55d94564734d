"""repro_torch.shard against the JAX package's repro.shard.

Subject-hash partitioning, sharded ingestion (manifest and shard ``.kgz``
bytes, serial and across 2 spawned workers, on ``device="cpu"``), the
scatter/gather session and coordinator over ``tests/test_shard.py``'s
templates at 1, 2 and 4 shards, and the CLIs on a manifest: every
comparison with the JAX package is exact.
"""

import os
import sys
import zlib

import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.kg.store import TripleStore as JStore
from repro.launch import query as jax_query_cli
from repro.shard import build_shard_stores as jax_build_shard_stores
from repro.shard import ingest_sharded as jax_ingest_sharded
from repro.shard import partition_store as jax_partition_store
from repro.shard import partition_triples as jax_partition_triples
from repro.shard import shard_of_term as jax_shard_of_term
from repro.shard.ingest import ingest_mapping_sharded as jax_ingest_mapping_sharded
from repro_torch import api
from repro_torch.api import LocalSession
from repro_torch.kg import persist
from repro_torch.kg.store import TripleStore
from repro_torch.launch import query as query_cli
from repro_torch.obs import MetricsRegistry
from repro_torch.serve.client import connect
from repro_torch.shard import (
    build_shard_stores,
    ingest_sharded,
    partition_store,
    partition_triples,
    shard_of_term,
    shard_store,
)
from repro_torch.shard import merge as M
from repro_torch.shard.coordinator import (
    Coordinator,
    ShardGroup,
    ShardSession,
    _LocalBackend,
)
from repro_torch.shard.ingest import ingest_mapping_sharded
from test_mapping_plan import WIDE_TTL, _write_wide_testbed
from test_shard import OBJS, PREDS, SUBS, TEMPLATES, decoded_triples


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triples(seed: int, n: int) -> list:
    """``tests/test_shard.py::rand_store``'s triples."""
    rng = np.random.default_rng(seed)
    return sorted({
        (SUBS[rng.integers(0, len(SUBS))], PREDS[rng.integers(0, len(PREDS))],
         OBJS[rng.integers(0, len(OBJS))])
        for _ in range(n)
    })


def _both(seed: int, n: int):
    t = _triples(seed, n)
    return JStore.from_ntriples(t), TripleStore.from_ntriples(t, device="cpu")


def _session(store, n_shards: int) -> ShardSession:
    backends = [_LocalBackend(LocalSession(s)) for s in build_shard_stores(store, n_shards)]
    return ShardSession(ShardGroup(backends, registry=MetricsRegistry()))


def _jax_session(store, n_shards: int):
    from repro.api import LocalSession as JLocal
    from repro.obs import MetricsRegistry as JRegistry
    from repro.shard.coordinator import ShardGroup as JGroup
    from repro.shard.coordinator import ShardSession as JSession
    from repro.shard.coordinator import _LocalBackend as JBackend

    backends = [JBackend(JLocal(s)) for s in jax_build_shard_stores(store, n_shards)]
    return JSession(JGroup(backends, registry=JRegistry()))


def _files(directory, names) -> dict:
    return {n: (directory / n).read_bytes() for n in names}


# --------------------------------------------------------------------------
# partitioning
# --------------------------------------------------------------------------


def test_shard_of_term_and_partitions_match_jax():
    subjects = SUBS + ["<http://ex/é>", '_:b0', "<http://ex/" + "x" * 300 + ">"]
    for s in subjects:
        for n in (1, 2, 3, 4, 7):
            assert shard_of_term(s, n) == jax_shard_of_term(s, n)
    assert shard_of_term(SUBS[0], 4) == zlib.crc32(SUBS[0].encode()) % 4
    js, ts = _both(7, 60)
    triples = decoded_triples(ts)
    assert triples == decoded_triples(js)
    for n in (1, 2, 4):
        assert partition_triples(triples, n) == jax_partition_triples(triples, n)
        assert partition_store(ts, n) == jax_partition_store(js, n)
        for a, b in zip(build_shard_stores(ts, n), jax_build_shard_stores(js, n)):
            assert decoded_triples(a) == decoded_triples(b)
            assert a.device == ts.device


# --------------------------------------------------------------------------
# sharded ingestion: the same bytes, serial and in spawned workers
# --------------------------------------------------------------------------


def test_ingest_sharded_bytes_match_jax_serial_and_spawned(tmp_path):
    triples = decoded_triples(_both(31, 40)[1])
    dirs = {k: tmp_path / k for k in ("jax", "serial", "spawned")}
    for d in dirs.values():
        d.mkdir()
    jax_ingest_sharded(triples, str(dirs["jax"] / "kg.shards.json"), 3)
    ingest_sharded(triples, str(dirs["serial"] / "kg.shards.json"), 3, device="cpu")
    ingest_sharded(triples, str(dirs["spawned"] / "kg.shards.json"), 3,
                   workers=2, device="cpu")
    names = ["kg.shards.json"] + [f"kg.shard{i}.kgz" for i in range(3)]
    want = _files(dirs["jax"], names)
    assert _files(dirs["serial"], names) == want
    assert _files(dirs["spawned"], names) == want


def test_ingest_mapping_sharded_matches_jax_serial_and_spawned(tmp_path):
    """Group-parallel sharded KG creation over a two-group mapping: the
    port's manifest, shard bytes and statistics equal JAX's, serial and
    with each group built in a spawned worker on the CPU."""
    data = tmp_path / "data"
    data.mkdir()
    _write_wide_testbed(str(data), n_genes=60, n_muts=120)
    out = {k: tmp_path / k for k in ("jax", "serial", "spawned")}
    for d in out.values():
        d.mkdir()
    opts = dict(stream=True, block_rows=64)
    jm, jstats, jn = jax_ingest_mapping_sharded(
        WIDE_TTL, str(data), str(out["jax"] / "kg.shards.json"), 2,
        workers=0, engine_opts=opts)
    runs = {
        "serial": ingest_mapping_sharded(
            WIDE_TTL, str(data), str(out["serial"] / "kg.shards.json"), 2,
            workers=0, engine_opts=opts, device="cpu"),
        "spawned": ingest_mapping_sharded(
            WIDE_TTL, str(data), str(out["spawned"] / "kg.shards.json"), 2,
            workers=2, engine_opts=opts, device="cpu"),
    }
    names = ["kg.shards.json", "kg.shard0.kgz", "kg.shard1.kgz"]
    want = _files(out["jax"], names)
    for name, (m, stats, n) in runs.items():
        assert _files(out[name], names) == want, name
        assert n == jn and m["n_shards"] == jm["n_shards"] == 2
        assert {p: (s.kind, s.n_candidates, s.n_unique) for p, s in stats.items()} == {
            p: (s.kind, s.n_candidates, s.n_unique) for p, s in jstats.items()}


# --------------------------------------------------------------------------
# scatter/gather: the port's shard session answers JAX's rows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_all_templates_all_shard_counts_match_jax(n_shards):
    js, ts = _both(13, 40)
    single = LocalSession(ts)
    sess, jsess = _session(ts, n_shards), _jax_session(js, n_shards)
    try:
        for seed in range(3):
            rng = np.random.default_rng(seed)
            p = [PREDS[rng.integers(0, len(PREDS))] for _ in range(2)]
            s = SUBS[rng.integers(0, len(SUBS))]
            for tpl in TEMPLATES:
                text = tpl(p, s)
                got, want = sess.query(text), jsess.query(text)
                assert (got.vars, got.rows, got.n_total, got.agg_vars) == (
                    want.vars, want.rows, want.n_total, want.agg_vars), text
                one = single.query(text)
                assert (got.rows, got.n_total) == (one.rows, one.n_total), text
    finally:
        sess.close()
        jsess.close()


def test_empty_store_and_dispatch_modes_match_jax():
    from repro.serve.algebra import parse_select as jparse
    from repro.shard import choose_dispatch as jax_choose_dispatch
    from repro_torch.serve.algebra import parse_select

    empty = TripleStore.from_ntriples([], device="cpu")
    jempty = JStore.from_ntriples([])
    sess, jsess = _session(empty, 2), _jax_session(jempty, 2)
    for tpl in TEMPLATES:
        text = tpl(PREDS, SUBS[0])
        assert sess.query(text).rows == jsess.query(text).rows == LocalSession(
            empty).query(text).rows
        for n in (1, 4):
            assert M.choose_dispatch(parse_select(text), n) == jax_choose_dispatch(
                jparse(text), n)


def test_routed_query_touches_exactly_one_shard():
    _, ts = _both(5, 50)
    sess = _session(ts, 4)
    reg = sess.group.registry
    try:
        sess.query(f"SELECT ?o WHERE {{ {SUBS[0]} {PREDS[0]} ?o }}")
        assert reg.counter("shard.routed").value == 1
        assert reg.counter("shard.shard_requests").value == 1
        assert reg.histogram("shard.fanout").max == 1.0
        sess.query(f"?a {PREDS[0]} ?b . ?a {PREDS[1]} ?c")
        assert reg.counter("shard.scattered").value == 1
        assert reg.counter("shard.shard_requests").value == 1 + 4
    finally:
        sess.close()


def test_shard_gather_probe_times_both_modes_with_equal_replies():
    """The in-process gather rule's probe at a small size on the CPU: the
    group runs its shards one after another, and the pool runs (timed in
    turns with the serial ones) give the same replies."""
    from repro_torch.bench import shard_gather

    res = shard_gather.run(rows=2_000, batch=4, rounds=1, device="cpu", log=False)
    assert res["rule"] == "serial"
    assert set(res["classes"]) == {"single", "union"}
    for cls in res["classes"].values():
        assert [len(cls["ms"][m]) for m in ("serial", "pool")] == [2, 2]
        assert cls["serial_median_ms"] > 0 and cls["pool_median_ms"] > 0


# --------------------------------------------------------------------------
# manifests: api.connect, mutations, the coordinator, the CLIs
# --------------------------------------------------------------------------


def _manifest(tmp_path, seed=17, n=50, n_shards=2) -> tuple:
    js, ts = _both(seed, n)
    path = str(tmp_path / "kg.shards.json")
    shard_store(ts, path, n_shards)
    return js, ts, path


def test_connect_manifest_parity_and_mutations_match_jax(tmp_path):
    js, ts, path = _manifest(tmp_path)
    jpath = str(tmp_path / "jax.shards.json")
    from repro.shard import shard_store as jax_shard_store

    jax_shard_store(js, jpath, 2)
    mutations = [("insert", [("<http://ex/new>", PREDS[0], '"fresh"')]),
                 ("delete", [("<http://ex/new>", PREDS[0], '"fresh"'),
                             decoded_triples(ts)[0]]),
                 ("compact", None)]
    with api.connect(path, device="cpu") as sess, jax_api.connect(jpath) as jsess:
        assert isinstance(sess, ShardSession)
        for tpl in TEMPLATES:
            q = tpl(PREDS, SUBS[0])
            assert sess.query(q).rows == jsess.query(q).rows, q
        for op, trips in mutations:
            args = () if trips is None else (trips,)
            got, want = getattr(sess, op)(*args), getattr(jsess, op)(*args)
            got.pop("compact_ms", None)
            want.pop("compact_ms", None)
            assert got == want, op
            for tpl in TEMPLATES[:4]:
                q = tpl(PREDS, SUBS[0])
                assert sess.query(q).rows == jsess.query(q).rows, (op, q)
        with pytest.raises(api.QueryParseError):
            sess.query("SELECT nonsense {")
    with api.connect(path, read_only=True, device="cpu") as sess:
        with pytest.raises(api.ReadOnlyError):
            sess.insert([("<http://ex/x>", PREDS[0], '"v"')])


def test_coordinator_over_spawned_shard_servers(tmp_path):
    """``Coordinator.from_manifest`` with wire shards: one spawned server
    process per shard on the CPU, behind the NDJSON face; a JAX client's
    answers equal the unsharded store's."""
    from repro.serve.client import connect as jconnect

    _, ts, path = _manifest(tmp_path, seed=29, n=30)
    reg = MetricsRegistry()
    coord = Coordinator.from_manifest(path, port=0, wire_shards=True, registry=reg,
                                      log=False, linger_ms=1.0, device="cpu").start()
    single = LocalSession(ts)
    try:
        assert len(coord._servers) == 2
        assert all(s._proc.is_alive() and s._proc.pid != os.getpid()
                   for s in coord._servers)
        with jconnect("127.0.0.1", coord.port, retry_s=5.0) as c:
            for tpl in TEMPLATES:
                qt = tpl(PREDS, SUBS[0])
                want = single.query(qt)
                r = c.query(qt)
                assert [tuple(x) for x in r["rows"]] == want.rows, qt
                assert r["n_total"] == want.n_total, qt
            r = c.insert([["<http://ex/wire>", PREDS[0], '"w"']])
            assert r["inserted"] == 1 and r["shards_touched"] == 1
            got = c.query(f"SELECT ?o WHERE {{ <http://ex/wire> {PREDS[0]} ?o }}")
            assert [tuple(x) for x in got["rows"]] == [('"w"',)]
        assert reg.counter("shard.routed").value >= 2
    finally:
        coord.stop()
    assert not any(s._proc.is_alive() for s in coord._servers)


def test_coordinator_in_process_end_to_end(tmp_path):
    _, ts, path = _manifest(tmp_path, seed=23, n=60)
    reg = MetricsRegistry()
    coord = Coordinator.from_manifest(path, port=0, wire_shards=False, registry=reg,
                                      log=False, linger_ms=1.0, device="cpu").start()
    single = LocalSession(ts)
    try:
        with connect("127.0.0.1", coord.port, retry_s=5.0) as c:
            for tpl in TEMPLATES:
                qt = tpl(PREDS, SUBS[1])
                r = c.query(qt)
                assert [tuple(x) for x in r["rows"]] == single.query(qt).rows, qt
            met = c.metrics()
            assert met["metrics"]["gauges"]["shard.n_shards"] == 2
    finally:
        coord.stop()


def test_query_cli_on_a_manifest_prints_the_jax_cli_output(tmp_path, monkeypatch, capsys):
    _, _, path = _manifest(tmp_path, seed=3, n=40)
    for text in (f"SELECT * WHERE {{ ?a {PREDS[0]} ?b }}",
                 f"SELECT ?b (COUNT(?a) AS ?n) WHERE {{ ?a {PREDS[1]} ?b }} GROUP BY ?b"):
        monkeypatch.setattr(sys, "argv", ["query", "--kg", path, text, "--limit", "5"])
        jax_query_cli.main()
        want = capsys.readouterr().out
        query_cli.main(["--kg", path, "--device", "cpu", text, "--limit", "5"])
        assert capsys.readouterr().out == want and want
