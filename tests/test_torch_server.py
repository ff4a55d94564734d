"""repro_torch.serve.server / client against the JAX package's, both ways.

A JAX ``KGServer`` and a port ``KGServer`` (on the CPU) serve the same
numpy-seeded graph on ports the OS picks.  The JAX client gets the same
replies from both; the port client and ``repro_torch.api.connect
("host:port")`` get the JAX client's replies from the JAX server.  Live
mutations, the raw NDJSON wire, read-only rejection, a failed dispatch and
the adaptive linger windows are held to the JAX package's behaviour.
"""

import json
import socket
import sys

import numpy as np
import pytest
import torch

from repro.kg.store import TripleStore as JStore
from repro.live import LiveStore as JLive
from repro.obs import MetricsRegistry as JRegistry
from repro.serve import server as jserver
from repro.serve.client import connect as jconnect
from repro_torch import api
from repro_torch.api import ReadOnlyError, ServerError
from repro_torch.kg import persist
from repro_torch.kg.store import TripleStore
from repro_torch.launch import serve as serve_cli
from repro_torch.live import LiveStore
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import server
from repro_torch.serve.client import connect
from test_serve import OBJS, PREDS, SUBS, TEMPLATES

NOISE = ("latency_ms", "compact_ms", "id")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triples(seed: int = 11, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    return sorted({
        (SUBS[rng.integers(0, len(SUBS))], PREDS[rng.integers(0, len(PREDS))],
         OBJS[rng.integers(0, len(OBJS))])
        for _ in range(n)
    })


def _texts() -> list:
    rng = np.random.default_rng(5)
    out = []
    for t in TEMPLATES:
        p = [PREDS[rng.integers(0, len(PREDS))] for _ in range(2)]
        o = [OBJS[rng.integers(0, len(OBJS))]]
        out.append(t(p, o, ["-3", "1", "2.5", "100"][rng.integers(0, 4)]))
    return out


TEXTS = _texts()


def _clean(reply: dict) -> dict:
    return {k: v for k, v in reply.items() if k not in NOISE}


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) over the same read-only graph."""
    t = _triples()
    js = jserver.KGServer(JStore.from_ntriples(t), port=0, log=False,
                          linger_ms=1.0, registry=JRegistry()).start()
    ts = server.KGServer(TripleStore.from_ntriples(t, device="cpu"), port=0,
                         log=False, linger_ms=1.0, registry=MetricsRegistry()).start()
    yield js, ts
    js.stop()
    ts.stop()


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_jax_client_gets_the_jax_servers_replies_from_the_port_server(servers, i):
    js, ts = servers
    with jconnect("127.0.0.1", js.port) as a, jconnect("127.0.0.1", ts.port) as b:
        for limit in (None, 2):
            want = a.query(TEXTS[i], limit=limit)
            got = b.query(TEXTS[i], limit=limit)
            assert _clean(got) == _clean(want), TEXTS[i]
        assert b.explain(TEXTS[i]) == a.explain(TEXTS[i])


def test_port_client_and_remote_session_against_the_jax_server(servers):
    js, _ = servers
    with jconnect("127.0.0.1", js.port) as a, connect("127.0.0.1", js.port) as b:
        assert b.ping()
        for text in TEXTS:
            assert _clean(b.query(text)) == _clean(a.query(text)), text
        with pytest.raises(api.QueryParseError):
            b.query("SELECT WHERE {")
        with pytest.raises(api.BadRequestError, match="limit"):
            b.query(TEXTS[1], limit="abc")
        assert b.ping()
    with api.connect(f"127.0.0.1:{js.port}") as sess:
        assert isinstance(sess, api.RemoteSession)
        for text in TEXTS:
            want = jconnect("127.0.0.1", js.port).query(text)
            got = sess.query(text)
            assert got.rows == [tuple(r) for r in want["rows"]]
            assert (list(got.vars), got.n_total) == (want["vars"], want["n_total"])


def test_raw_socket_wire_protocol(servers):
    """Plain NDJSON, no client class: the port server's bytes decode to the
    JAX server's replies, malformed lines included."""
    replies = []
    for srv in servers:
        with socket.create_connection(("127.0.0.1", srv.port), 10) as s:
            f = s.makefile("r", encoding="utf-8")
            got = []
            for line in (b"not json\n",
                         json.dumps({"id": 42, "query": TEXTS[1]}).encode() + b"\n",
                         json.dumps({"id": 43}).encode() + b"\n",
                         json.dumps({"id": 44, "op": "ping"}).encode() + b"\n"):
                s.sendall(line)
                got.append(_clean(json.loads(f.readline())))
            replies.append(got)
    assert replies[1] == replies[0]
    assert replies[1][0]["code"] == "bad_request" and replies[1][1]["rows"]


def test_read_only_rejects_mutations_like_jax():
    t = _triples(3, 12)
    for read_only_store in ((JStore.from_ntriples(t), TripleStore.from_ntriples(t, device="cpu")),
                            (JLive(JStore.from_ntriples(t)),
                             LiveStore(TripleStore.from_ntriples(t, device="cpu")))):
        js = jserver.KGServer(read_only_store[0], port=0, log=False,
                              read_only=True, registry=JRegistry()).start()
        reg = MetricsRegistry()
        ts = server.KGServer(read_only_store[1], port=0, log=False,
                             read_only=True, registry=reg).start()
        try:
            with jconnect("127.0.0.1", js.port) as a, connect("127.0.0.1", ts.port) as b:
                for req in ({"op": "insert", "triples": [["<http://x/a>", PREDS[0], '"1"']]},
                            {"op": "delete", "triples": [["<http://x/a>", PREDS[0], '"1"']]},
                            {"op": "compact"}):
                    with pytest.raises(ReadOnlyError, match="read-only"):
                        b._roundtrip(dict(req))
                    with pytest.raises(RuntimeError, match="read-only"):
                        a._roundtrip(dict(req))
                assert _clean(b.query(TEXTS[1])) == _clean(a.query(TEXTS[1]))
            assert reg.counter("live.rejected").value == 3
        finally:
            js.stop()
            ts.stop()


def _live_session(client):
    """One live mutation round trip; the replies, noise removed."""
    q = f"SELECT ?s ?o WHERE {{ ?s {PREDS[0]} ?o }}"
    out = [client.query(q)]
    out.append(client.insert([["<http://ex/new0>", PREDS[0], '"3"'],
                              [SUBS[0], PREDS[1], "<http://ex/new1>"]]))
    out.append(client.query(q))
    out.append(client.query(f"SELECT * WHERE {{ ?s {PREDS[0]} ?o . ?s {PREDS[1]} ?r }}"))
    victim = [list(t) for t in _triples(7, 20) if t[1] == PREDS[0]][:2]
    out.append(client.delete(victim))
    out.append(client.query(q))
    out.append(client.compact())
    out.append(client.query(q))
    m = client.metrics()["metrics"]
    out.append({k: m["counters"].get(k) for k in (
        "live.inserts", "live.deletes", "live.tombstone_hits", "live.compactions")})
    return [_clean(r) for r in out]


def test_live_roundtrip_matches_the_jax_server(tmp_path):
    from repro.kg import persist as jpersist

    t = _triples(7, 20)
    jl, tl = JLive(JStore.from_ntriples(t)), LiveStore(TripleStore.from_ntriples(t, device="cpu"))
    jpath, tpath = str(tmp_path / "j.kgz"), str(tmp_path / "t.kgz")
    jpersist.save(jl.base, jpath)
    persist.save(tl.base, tpath)
    js = jserver.KGServer(jl, port=0, log=False, registry=JRegistry(), kg_path=jpath).start()
    ts = server.KGServer(tl, port=0, log=False, registry=MetricsRegistry(),
                         kg_path=tpath).start()
    try:
        with jconnect("127.0.0.1", js.port) as a, connect("127.0.0.1", ts.port) as b:
            assert _live_session(b) == _live_session(a)
    finally:
        js.stop()
        ts.stop()
    # compaction rewrote each served .kgz in place: the same bytes
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert persist.open_store(tpath, device="cpu").n_triples == tl.n_triples


def test_a_failed_dispatch_answers_a_typed_error_and_serving_goes_on(monkeypatch):
    """A dispatch that raises (a CUDA error on the card looks the same from
    the dispatcher thread) reaches each client of its group as the JAX
    server's ``internal`` error; the next query is served."""
    ts = server.KGServer(TripleStore.from_ntriples(_triples(), device="cpu"), port=0,
                         log=False, registry=MetricsRegistry()).start()
    real = ts.executor.execute
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(*a, **kw)

    monkeypatch.setattr(ts.executor, "execute", flaky)
    try:
        with connect("127.0.0.1", ts.port, timeout=30.0) as c:
            with pytest.raises(ServerError, match="illegal memory access"):
                c.query(TEXTS[1])
            assert c.query(TEXTS[1])["n_total"] > 0
        assert ts.stats_dict()["errors"] == 1
    finally:
        ts.stop()


def test_adaptive_linger_windows_match_jax():
    rng = np.random.default_rng(3)
    gaps_ns = rng.integers(1_000, 5_000_000, size=40)
    jreg, treg = JRegistry(), MetricsRegistry()
    jl = jserver._AdaptiveLinger(0.002, jreg)
    tl = server._AdaptiveLinger(0.002, treg)
    assert tl.window_s() == jl.window_s() == 0.002
    t = 0
    for k, gap in enumerate(gaps_ns):
        t += int(gap)
        jl.observe_arrival(t)
        tl.observe_arrival(t)
        if k % 7 == 3:
            jreg.observe("serve.exec_ms", 0.1 * k)
            treg.observe("serve.exec_ms", 0.1 * k)
        assert tl.window_s() == jl.window_s(), k


def test_serve_cli_client_mode_prints_the_jax_cli_reply(servers, monkeypatch, capsys):
    from repro.launch import serve as jax_serve_cli

    js, ts = servers
    args = ["--connect", f"127.0.0.1:{js.port}", "--query", TEXTS[4], "--limit", "3"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    jax_serve_cli.main()
    want = json.loads(capsys.readouterr().out)
    serve_cli.main(["--connect", f"127.0.0.1:{ts.port}", *args[2:]])
    got = json.loads(capsys.readouterr().out)
    assert _clean(got) == _clean(want) and want["rows"]


def test_track_sig_legend_is_capped():
    examples: dict = {}
    for i in range(server.MAX_TRACKED_SIGS):
        assert server.track_sig(examples, f"sig{i}", f"q{i}") == f"sig{i}"
    assert server.track_sig(examples, "new", "q") == "overflow"
    assert server.MAX_TRACKED_SIGS == jserver.MAX_TRACKED_SIGS
