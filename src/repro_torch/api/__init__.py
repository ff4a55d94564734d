"""One query API over a store: ``connect`` -> :class:`Session`.

``connect(target)`` returns a :class:`LocalSession` — ``query`` /
``explain`` / ``insert`` / ``delete`` / ``compact`` / ``metrics`` /
``close`` — when the target is

* an in-process :class:`~repro_torch.kg.store.TripleStore`, or
* a full ``.kgz`` snapshot path, opened on ``device`` (``cuda`` unless the
  caller asks for the CPU; no fallback) through the ``open_store`` cache.

``query`` answers with a :class:`QueryResult`; failures raise the typed
:mod:`repro_torch.api.errors` hierarchy.  A local session runs the
planner/executor pipeline — including the small-batch fast path, kernel
K4 on the card — so results, ordering and error semantics equal the JAX
package's ``repro.api`` on the same store.

Not ported yet, and raising ``NotImplementedError`` that names the
ROADMAP.md Queue 1 item: live stores and delta snapshots (mutations on a
session opened from a path; item 16), shard manifests (item 11), and a
running server at ``"host:port"`` (item 17).
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
    """The transport-independent surface; ``connect`` hands back a
    :class:`LocalSession`."""

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


_NOT_PORTED = (
    "{what} is not ported yet: it arrives with ROADMAP.md Queue 1 item "
    "{item}; use repro.api for it"
)


class LocalSession(Session):
    """In-process execution over a store object — the same
    planner/executor pipeline (and small-batch fast path) a server would
    dispatch through, at batch size 1.  Over a plain
    :class:`~repro_torch.kg.store.TripleStore` mutations raise
    :class:`ReadOnlyError`, as in the JAX package; a session opened from a
    ``.kgz`` path without ``read_only`` would be a live store there, which
    is not ported yet, so its mutations raise ``NotImplementedError``."""

    def __init__(self, store, read_only: bool = True):
        if hasattr(store, "view") and hasattr(store, "base"):
            raise NotImplementedError(_NOT_PORTED.format(what="a live store", item=16))
        self.store = store
        self.read_only = read_only

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
        executor, answered as the raw padded
        :class:`~repro_torch.serve.exec.BatchResult`.  This is the one local
        execution path — ``query`` and ``kg.query.solve`` both come through
        here."""
        from repro_torch.serve.exec import get_executor

        ex = get_executor(self.store)
        return ex.execute(ex.plan(q), [q])

    def query(
        self, text: str, limit: int | None = None, *, parsed=None
    ) -> QueryResult:
        """``parsed`` short-circuits the parse with an already-built
        :class:`~repro_torch.serve.algebra.SelectQuery`."""
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
        return get_executor(self.store).plan(q).explain()

    def _writable(self, triples=None):
        if triples is not None:
            _check_triples(triples)
        if self.read_only:
            raise ReadOnlyError("store is read-only: mutation rejected")
        raise NotImplementedError(_NOT_PORTED.format(what="a live store", item=16))

    def insert(self, triples) -> dict:
        self._writable(triples)

    def delete(self, triples) -> dict:
        self._writable(triples)

    def compact(self) -> dict:
        self._writable()

    def metrics(self) -> dict:
        from repro_torch.obs import get_registry

        return {"metrics": get_registry().snapshot(), "signatures": {}}


def connect(target, read_only: bool = False, device="cuda") -> Session:
    """Open a :class:`LocalSession` on a store object or a ``.kgz`` path
    (opened on ``device`` through the ``open_store`` cache).  A
    ``"host:port"`` target (a running server), a shard manifest and a
    delta snapshot raise ``NotImplementedError`` naming the ROADMAP item
    that brings each."""
    if not isinstance(target, (str, os.PathLike)):
        if not (hasattr(target, "n_triples") and hasattr(target, "decode_term")):
            raise BadRequestError(
                f"cannot connect to {type(target).__name__}: expected a "
                "store object, a .kgz path, a shard manifest, or 'host:port'"
            )
        return LocalSession(target, read_only=True)
    target = os.fspath(target)
    m = _HOST_PORT.match(target)
    if m and not os.path.exists(target):
        raise NotImplementedError(
            _NOT_PORTED.format(what="a remote query server session", item=17))
    from repro_torch.kg import persist

    if persist.is_manifest(target):
        raise NotImplementedError(_NOT_PORTED.format(what="a shard manifest", item=11))
    if persist.peek_meta(target)[3] != persist.KIND_FULL:
        persist.load_chain(target)  # a delta snapshot: raises (item 16)
    return LocalSession(persist.open_store(target, device=device), read_only=read_only)


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
