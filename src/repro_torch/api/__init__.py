"""One query API over every store transport.

``connect(target)`` returns a :class:`Session` with the same seven
methods — ``query`` / ``explain`` / ``insert`` / ``delete`` /
``compact`` / ``metrics`` / ``close`` — whether the target is

* an in-process store object (:class:`~repro_torch.kg.store.TripleStore` or
  :class:`~repro_torch.live.delta.LiveStore`),
* a ``.kgz`` snapshot path (full or delta chain; opened mutable by
  default, immutable with ``read_only=True``) or a shard manifest, either
  on ``device`` (``cuda`` unless the caller asks for the CPU; no
  fallback), or
* a running :mod:`repro_torch.serve.server` at ``"host:port"``.

``query`` always answers with a :class:`QueryResult`; failures always
raise the typed :mod:`repro_torch.api.errors` hierarchy (same classes both
sides of the wire).  A local session runs the same planner/executor
pipeline the server runs — including the small-batch fast path — so
results, ordering, and error semantics are identical across transports
and equal the JAX package's ``repro.api`` on the same store.

``repro_torch.kg.query.solve`` / ``solve_text`` and
``repro_torch.serve.client.Client`` are thin layers over this module.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

from repro_torch.api.errors import (  # noqa: F401 — the API's error surface
    BadRequestError,
    KGError,
    ProtocolError,
    QueryParseError,
    ReadOnlyError,
    ServerError,
    error_from_reply,
)

_HOST_PORT = re.compile(r"^(?P<host>[\w.\-]+):(?P<port>\d{1,5})$")


@dataclasses.dataclass
class QueryResult:
    """One query's decoded answer, identical across transports.

    ``rows`` are tuples of rendered N-Triples terms in ``vars`` order,
    ``None`` for unbound (OPTIONAL-miss / UNION-arm) cells, plain ints
    for aggregate (COUNT) columns — the ones named in ``agg_vars``.
    ``n_total`` reports the full solution count even when a ``limit``
    capped the decoded rows.  ``raw`` carries the wire reply on a remote
    session (None locally)."""

    vars: tuple[str, ...]
    rows: list[tuple]
    n_total: int
    agg_vars: tuple[str, ...] = ()
    latency_ms: float = 0.0
    batch_size: int = 1
    raw: dict | None = None

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def to_dict(self) -> dict:
        """The wire-reply shape (what a remote server would answer)."""
        d = {
            "vars": list(self.vars),
            "rows": [list(r) for r in self.rows],
            "n_total": self.n_total,
            "batch_size": self.batch_size,
            "latency_ms": round(self.latency_ms, 3),
        }
        if self.agg_vars:
            d["agg_vars"] = list(self.agg_vars)
        return d


class Session:
    """The transport-independent surface; ``connect`` hands back one of
    the two concrete sessions below."""

    def query(self, text: str, limit: int | None = None) -> QueryResult:
        raise NotImplementedError

    def explain(self, text: str) -> str:
        raise NotImplementedError

    def insert(self, triples) -> dict:
        raise NotImplementedError

    def delete(self, triples) -> dict:
        raise NotImplementedError

    def compact(self) -> dict:
        raise NotImplementedError

    def metrics(self) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _check_limit(limit) -> None:
    if limit is not None and (
        not isinstance(limit, int) or isinstance(limit, bool) or limit < 0
    ):
        raise BadRequestError("'limit' must be a non-negative integer")


def _check_triples(triples) -> list[tuple]:
    ts = [tuple(t) for t in triples] if isinstance(triples, (list, tuple)) else None
    if (
        not ts
        or not all(
            len(t) == 3 and all(isinstance(x, str) for x in t) for t in ts
        )
    ):
        raise BadRequestError(
            "'triples' must be a non-empty list of [s, p, o] "
            "term-string triples"
        )
    return ts


class LocalSession(Session):
    """In-process execution over a store object — the same fused
    planner/executor pipeline (and small-batch fast path) the server
    dispatches through, at batch size 1.  Mutations need a
    :class:`~repro_torch.live.delta.LiveStore`; over a plain
    :class:`~repro_torch.kg.store.TripleStore` (or with ``read_only=True``)
    they raise :class:`ReadOnlyError` exactly like a read-only server."""

    def __init__(self, store, read_only: bool = False):
        self.store = store
        # a live store carries (base, view); a plain TripleStore is
        # immutable by construction — same duck test as kg.query.solve
        self._live = store if (
            hasattr(store, "view") and hasattr(store, "base")
        ) else None
        self.read_only = read_only or self._live is None

    def _base(self):
        return self._live.base if self._live is not None else self.store

    def _parse(self, text: str):
        from repro_torch.serve import algebra

        if not isinstance(text, str):
            raise BadRequestError("missing 'query'")
        try:
            return algebra.parse_select(text)
        except ValueError as e:
            raise QueryParseError(str(e)) from e

    def execute(self, q):
        """Low-level single-query execute: the parsed
        :class:`~repro_torch.serve.algebra.SelectQuery` through the planner/
        executor (overlay view captured for a live store), answered as
        the raw padded :class:`~repro_torch.serve.exec.BatchResult`.  This is
        the one local execution path — ``query`` and the legacy
        ``kg.query.solve`` shim both come through here."""
        from repro_torch.serve.exec import get_executor

        ex = get_executor(self._base())
        view = self._live.view() if self._live is not None else None
        return ex.execute(ex.plan(q), [q], view=view)

    def query(
        self, text: str, limit: int | None = None, *, parsed=None
    ) -> QueryResult:
        """``parsed`` short-circuits the parse with an already-built
        :class:`~repro_torch.serve.algebra.SelectQuery` — the shard fan-out
        hands each in-process backend the query it parsed once for
        routing, instead of re-parsing the text on every shard."""
        _check_limit(limit)
        q = parsed if parsed is not None else self._parse(text)
        t0 = time.perf_counter_ns()
        res = self.execute(q)
        lat_ms = (time.perf_counter_ns() - t0) / 1e6
        return QueryResult(
            vars=tuple(res.vars),
            rows=res.rows(0, limit=limit),
            n_total=res.n(0),
            agg_vars=tuple(res.agg_vars),
            latency_ms=lat_ms,
        )

    def explain(self, text: str) -> str:
        from repro_torch.serve.exec import get_executor

        q = self._parse(text)
        return get_executor(self._base()).plan(q).explain()

    def _writable(self):
        if self.read_only:
            raise ReadOnlyError("store is read-only: mutation rejected")
        return self._live

    def insert(self, triples) -> dict:
        live = self._writable()
        added = live.insert(_check_triples(triples))
        return {
            "inserted": added,
            "n_total": live.n_triples,
            "generation": live.generation,
        }

    def delete(self, triples) -> dict:
        live = self._writable()
        deleted, tombstoned = live.delete(_check_triples(triples))
        return {
            "deleted": deleted,
            "tombstoned": tombstoned,
            "n_total": live.n_triples,
            "generation": live.generation,
        }

    def compact(self) -> dict:
        live = self._writable()
        t0 = time.perf_counter_ns()
        live.compact()
        return {
            "compacted": True,
            "compact_ms": round((time.perf_counter_ns() - t0) / 1e6, 3),
            "n_total": live.n_triples,
            "generation": live.generation,
        }

    def metrics(self) -> dict:
        from repro_torch.obs import get_registry

        return {"metrics": get_registry().snapshot(), "signatures": {}}


class RemoteSession(Session):
    """A socket client to a running server, answers normalized into the
    same :class:`QueryResult` / typed-error surface as a local session.
    (The transport lives in :mod:`repro_torch.serve.client`, imported lazily —
    ``repro_torch.api`` stays importable below the serve layer.)"""

    def __init__(
        self, host: str, port: int, retry_s: float = 0.0, timeout: float = 30.0
    ):
        from repro_torch.serve.client import connect as _wire_connect

        self._c = _wire_connect(host, port, retry_s=retry_s, timeout=timeout)

    def query(self, text: str, limit: int | None = None) -> QueryResult:
        resp = self._c.query(text, limit=limit)
        return QueryResult(
            vars=tuple(resp.get("vars", ())),
            rows=[tuple(r) for r in resp.get("rows", ())],
            n_total=int(resp.get("n_total", 0)),
            agg_vars=tuple(resp.get("agg_vars", ())),
            latency_ms=float(resp.get("latency_ms", 0.0)),
            batch_size=int(resp.get("batch_size", 1)),
            raw=resp,
        )

    def explain(self, text: str) -> str:
        return self._c.explain(text)

    def insert(self, triples) -> dict:
        return self._c.insert(triples)

    def delete(self, triples) -> dict:
        return self._c.delete(triples)

    def compact(self) -> dict:
        return self._c.compact()

    def metrics(self) -> dict:
        return self._c.metrics()

    def close(self) -> None:
        self._c.close()


def connect(
    target,
    read_only: bool = False,
    retry_s: float = 0.0,
    timeout: float = 30.0,
    device="cuda",
) -> Session:
    """Open a :class:`Session` on anything query-shaped.

    * a store object → :class:`LocalSession` over it as-is;
    * ``"host:port"`` (when no such file exists) → :class:`RemoteSession`
      (``retry_s`` keeps retrying the TCP connect — the CI smoke path);
    * a shard-manifest path (``rdfize --shards N`` output) →
      :class:`~repro_torch.shard.coordinator.ShardSession` over every shard
      store, with scatter/gather merging that answers byte-identically
      to the unsharded store;
    * a ``.kgz`` path → :class:`LocalSession`; mutable
      (:class:`~repro_torch.live.delta.LiveStore` over the loaded chain, delta
      snapshots replayed) unless ``read_only=True``, which opens the
      immutable cached store.

    Manifests and ``.kgz`` paths open on ``device``.
    """
    if not isinstance(target, (str, os.PathLike)):
        if not (hasattr(target, "n_triples") and hasattr(target, "decode_term")):
            raise BadRequestError(
                f"cannot connect to {type(target).__name__}: expected a "
                "store object, a .kgz path, a shard manifest, or 'host:port'"
            )
        return LocalSession(target, read_only=read_only)
    target = os.fspath(target)
    m = _HOST_PORT.match(target)
    if m and not os.path.exists(target):
        return RemoteSession(
            m.group("host"), int(m.group("port")),
            retry_s=retry_s, timeout=timeout,
        )
    from repro_torch.kg import persist

    if persist.is_manifest(target):
        from repro_torch.shard.coordinator import ShardSession, open_shard_group

        return ShardSession(
            open_shard_group(target, read_only=read_only, device=device)
        )
    if read_only:
        return LocalSession(
            persist.open_store(target, device=device), read_only=True
        )
    return LocalSession(persist.load_chain(target, device=device))


def _peek_schemas(plan, data_root: str) -> "dict[str, tuple[str, ...]]":
    """Header peek for fixed-schema CSV/TSV sources on disk, so the
    explain tree can show *pruned* columns, not just kept ones.  Sources
    that are missing, globbed, or schemaless (JSON) are simply omitted —
    explain must work before the data exists."""
    import csv

    from repro_torch.rml.model import parse_source_key
    from repro_torch.stream.datasource import is_sharded_path

    schemas: dict[str, tuple[str, ...]] = {}
    for skey in plan.sources:
        fmt, path, _ = parse_source_key(skey)
        if fmt not in ("csv", "tsv") or is_sharded_path(path):
            continue
        full = path if os.path.isabs(path) else os.path.join(data_root, path)
        if not os.path.exists(full):
            continue
        with open(full, newline="", encoding="utf-8") as f:
            delim = "\t" if fmt == "tsv" else ","
            header = next(csv.reader(f, delimiter=delim), None)
        if header:
            schemas[skey] = tuple(header)
    return schemas


def explain_mapping(mapping, data_root: str = ".") -> str:
    """Render the mapping planner's decisions as a stable human-readable
    tree — per-source kept/pruned columns, factored shared terms, join
    indexes, and the rule-group execution DAG — without running the
    engine.  ``mapping`` is a :class:`~repro_torch.rml.model.MappingDocument`
    or a path to an RML ``.ttl`` file; when the CSV/TSV sources exist
    under ``data_root`` their headers are peeked so pruned columns are
    listed explicitly.  This is ``rdfize --explain-mapping``."""
    from repro_torch.rml import parser
    from repro_torch.rml.plan import build_plan, render_explain

    if isinstance(mapping, (str, os.PathLike)):
        doc = parser.parse_file(os.fspath(mapping))
    else:
        doc = mapping
    plan = build_plan(doc)
    return render_explain(plan, schemas=_peek_schemas(plan, data_root))
