"""Minimal client for the :mod:`repro_torch.serve.server` wire protocol.

This is the raw transport under :class:`repro_torch.api.RemoteSession` —
new code should use ``repro_torch.api.connect("host:port")`` and get the
unified :class:`~repro_torch.api.QueryResult` surface; this module stays for
callers that want the wire dicts verbatim.

Answers are plain dicts off the wire: ``vars`` / ``rows`` / ``n_total``.
Aggregate (COUNT) columns are listed in the answer's ``agg_vars`` and
their row cells are JSON numbers; every other cell is a rendered
N-Triples term, ``None`` when unbound (an OPTIONAL miss or a UNION arm
that does not bind the variable).  Error replies raise the typed
:mod:`repro_torch.api.errors` hierarchy (all ``RuntimeError`` subclasses)."""

from __future__ import annotations

import json
import socket
import time


class Client:
    """One connection; requests are correlated by an auto-incremented id
    (the server answers every request with exactly one line)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._next_id = 0

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _roundtrip(self, req: dict) -> dict:
        from repro_torch.api.errors import ProtocolError, error_from_reply

        self._next_id += 1
        req = {"id": self._next_id, **req}
        self._sock.sendall((json.dumps(req) + "\n").encode("utf-8"))
        line = self._rfile.readline()
        if not line:
            # ProtocolError is also a ConnectionError — old callers
            # that caught that still do
            raise ProtocolError("server closed the connection")
        resp = json.loads(line)
        if resp.get("error"):
            # the typed repro_torch.api.errors hierarchy, keyed by the reply's
            # structured "code" (every class is a RuntimeError and the
            # message keeps the "server error: ..." prefix)
            raise error_from_reply(resp)
        return resp

    def query(self, text: str, limit: int | None = None) -> dict:
        req: dict = {"query": text}
        if limit is not None:
            req["limit"] = limit
        return self._roundtrip(req)

    def explain(self, text: str) -> str:
        return self._roundtrip({"op": "explain", "query": text})["plan"]

    def ping(self) -> bool:
        return bool(self._roundtrip({"op": "ping"}).get("ok"))

    def stats(self) -> dict:
        return self._roundtrip({"op": "stats"})

    def insert(self, triples) -> dict:
        """Insert rendered ``(s, p, o)`` term-string triples; the answer
        reports ``inserted`` / ``n_total`` / ``generation`` (raises on a
        read-only server)."""
        return self._roundtrip(
            {"op": "insert", "triples": [list(t) for t in triples]}
        )

    def delete(self, triples) -> dict:
        """Delete triples; the answer reports ``deleted`` (how many were
        present and removed) and ``tombstoned`` (how many were base rows,
        now masked until compaction)."""
        return self._roundtrip(
            {"op": "delete", "triples": [list(t) for t in triples]}
        )

    def compact(self) -> dict:
        """Merge the overlay into a fresh base store; the answer reports
        ``compact_ms`` and, when the server owns the ``.kgz`` path,
        ``persisted``."""
        return self._roundtrip({"op": "compact"})

    def metrics(self) -> dict:
        """The server's full metrics snapshot: ``{"metrics": {"counters":
        ..., "gauges": ..., "histograms": ...}, "signatures": {...}}`` —
        latency histograms carry ``count``/``sum``/``max``/``p50``/``p90``
        /``p99`` (see ``repro_torch.obs.metrics``)."""
        return self._roundtrip({"op": "metrics"})


def connect(
    host: str, port: int, retry_s: float = 0.0, timeout: float = 30.0
) -> Client:
    """Connect, optionally retrying for ``retry_s`` seconds (the CI smoke
    path: the server may still be loading its snapshot)."""
    deadline = time.monotonic() + retry_s
    while True:
        try:
            return Client(host, port, timeout=timeout)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)
