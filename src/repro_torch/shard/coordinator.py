"""Scatter/gather serving over N hash-partitioned shard stores.

Layers, bottom up:

* :class:`ShardLink` — one pipelined NDJSON socket to a shard server:
  ``request_many`` writes a whole micro-batch in one send and correlates
  the replies by ``id`` (the shard's dispatcher may answer signature
  groups out of order), so a scattered batch reaches the shard's linger
  window together and micro-batches *there* too.
* backends — one per shard, same contract either way:
  :class:`_SocketBackend` (a :class:`ShardLink`) or :class:`_LocalBackend`
  (an in-process :class:`repro_torch.api.LocalSession`); errors come back as
  structured ``{"error", "code"}`` dicts, never exceptions, so one bad
  query cannot abort a whole gathered batch.
* :class:`ShardGroup` — the dispatch/merge brain: per query it picks
  routed / scatter / decompose (:func:`repro_torch.shard.merge.choose_dispatch`),
  fans sub-requests out (socket shards run concurrently on a thread
  pool, in-process ones one after another),
  merges with :mod:`repro_torch.shard.merge`, routes mutations by subject hash,
  and counts fan-out in :mod:`repro_torch.obs`
  (``shard.routed`` / ``shard.scattered`` / ``shard.decomposed`` /
  ``shard.shard_requests``, ``shard.fanout`` + per-shard
  ``shard.request_ms.shard=K`` histograms).
* :class:`ShardSession` — the :class:`repro_torch.api.Session` face over a
  group, what ``repro_torch.api.connect(<manifest>)`` hands back.
* :class:`Coordinator` — the NDJSON TCP server face: accepts ordinary
  client requests, micro-batches them per plan signature exactly like
  ``serve.server.KGServer`` (mutations are ordering barriers), and
  answers through a :class:`ShardGroup`.  Clients cannot tell it from a
  single-store server.

Shard stores open on a device (``cuda`` unless the caller asks for the
CPU).  :func:`spawn_shard_servers` starts each shard's ``KGServer`` in a
process of its own, started with ``spawn`` (a forked CUDA context is
unusable), so each shard server holds its own CUDA context.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import queue
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.api import LocalSession, Session, QueryResult
from repro_torch.api.errors import KGError, ProtocolError, error_from_reply
from repro_torch.obs import MetricsRegistry, get_registry
from repro_torch.serve import algebra
from repro_torch.serve.server import track_sig
from repro_torch.shard import merge as M
from repro_torch.shard.partition import shard_of_term


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


class ShardLink:
    """One persistent connection to a shard server, pipelined: a batch of
    requests goes out as one write, replies are re-ordered by ``id``."""

    def __init__(
        self, host: str, port: int, timeout: float = 30.0, retry_s: float = 0.0
    ):
        deadline = time.monotonic() + retry_s
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, port), timeout=timeout
                )
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._lock = threading.Lock()
        self._next_id = 0

    def request_many(self, reqs: "list[dict]") -> "list[dict]":
        """Send every request, then collect exactly one reply each,
        matched by ``id`` — arrival order is the shard dispatcher's
        business, not ours."""
        if not reqs:
            return []
        with self._lock:
            ids = []
            lines = []
            for r in reqs:
                self._next_id += 1
                ids.append(self._next_id)
                # "_"-prefixed keys are in-process hints (the pre-parsed
                # query object for local backends) — never wire payload
                wire = {k: v for k, v in r.items() if not k.startswith("_")}
                lines.append(json.dumps({"id": self._next_id, **wire}))
            self._sock.sendall(("\n".join(lines) + "\n").encode("utf-8"))
            by_id: dict = {}
            for _ in reqs:
                line = self._rfile.readline()
                if not line:
                    raise ProtocolError("shard closed the connection")
                reply = json.loads(line)
                by_id[reply.get("id")] = reply
        try:
            return [by_id[i] for i in ids]
        except KeyError as e:
            raise ProtocolError(f"shard dropped request id {e}") from e

    def request(self, req: dict) -> dict:
        return self.request_many([req])[0]

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass


class _SocketBackend:
    concurrent = True  # the work runs in the shard server's process

    def __init__(self, link: ShardLink):
        self.link = link

    def run(self, reqs: "list[dict]") -> "list[dict]":
        return self.link.request_many(reqs)

    def close(self) -> None:
        self.link.close()


class _LocalBackend:
    """The same request/reply contract over an in-process session — what
    ``api.connect(<manifest>)`` serves through, no sockets involved.  Its
    work is this process's host-side launches, so shards run one after
    another: threads issuing the general executor's ~1,500 PyTorch
    operations a dispatch contend on the GIL, and four of them made a
    batch several times slower than one thread does, on the fast path and
    the general executor, on the card and on the CPU
    (``python -m repro_torch.bench.shard_gather``; PERF.md)."""

    concurrent = False

    def __init__(self, session: LocalSession):
        self.session = session

    def run(self, reqs: "list[dict]") -> "list[dict]":
        out = []
        for r in reqs:
            try:
                op = r.get("op")
                if op is None:
                    res = self.session.query(
                        r.get("query"),
                        limit=r.get("limit"),
                        parsed=r.get("_q"),
                    )
                    # to_dict() copies every row into a list for the json
                    # wire; in-process the tuples pass through untouched
                    # (json serializes tuples as arrays anyway)
                    reply = {
                        "vars": list(res.vars),
                        "rows": res.rows,
                        "n_total": res.n_total,
                        "batch_size": res.batch_size,
                        "latency_ms": round(res.latency_ms, 3),
                    }
                    if res.agg_vars:
                        reply["agg_vars"] = list(res.agg_vars)
                    out.append(reply)
                elif op == "explain":
                    out.append({"plan": self.session.explain(r.get("query"))})
                elif op == "insert":
                    out.append(self.session.insert(r.get("triples")))
                elif op == "delete":
                    out.append(self.session.delete(r.get("triples")))
                elif op == "compact":
                    out.append(self.session.compact())
                else:
                    out.append(
                        {"error": f"unknown op {op!r}", "code": "bad_request"}
                    )
            except KGError as e:
                out.append(
                    {"error": str(e), "code": e.code or "internal"}
                )
            except Exception as e:  # noqa: BLE001 — mirror the server's catch
                out.append(
                    {"error": f"{type(e).__name__}: {e}", "code": "internal"}
                )
        return out

    def close(self) -> None:
        self.session.close()


# ---------------------------------------------------------------------------
# the dispatch/merge brain
# ---------------------------------------------------------------------------


def _tuple_rows(rows) -> "list[tuple]":
    """Rows as tuples: socket replies carry json lists, in-process replies
    already carry tuples (left untouched — no per-row copy)."""
    if rows and not isinstance(rows[0], tuple):
        return [tuple(r) for r in rows]
    return rows if isinstance(rows, list) else list(rows)


@dataclasses.dataclass
class _Item:
    """One client query inside a gathered group."""

    text: str
    limit: int | None
    q: algebra.SelectQuery | None = None
    error: dict | None = None


class ShardGroup:
    """N shard backends behind one query/mutation surface with exact
    single-store semantics (see :mod:`repro_torch.shard.merge` for the modes
    and their correctness arguments)."""

    def __init__(
        self,
        backends: list,
        registry: MetricsRegistry | None = None,
        max_rows: int = 1000,
    ):
        if not backends:
            raise ValueError("a shard group needs at least one backend")
        self.backends = list(backends)
        self.n_shards = len(self.backends)
        self.registry = registry if registry is not None else get_registry()
        self.max_rows = max_rows
        self.registry.gauge("shard.n_shards").set(self.n_shards)
        self._req_ms = [
            f"shard.request_ms.shard={i}" for i in range(self.n_shards)
        ]
        self._pool = (
            ThreadPoolExecutor(
                max_workers=self.n_shards, thread_name_prefix="shard-gather"
            )
            if self.n_shards > 1 and all(b.concurrent for b in self.backends)
            else None
        )

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        for b in self.backends:
            b.close()

    # -- fan-out plumbing ---------------------------------------------------

    def _run_on(
        self, requests_by_shard: "dict[int, list[dict]]"
    ) -> "dict[int, list[dict]]":
        """Run each shard's request list (socket shards concurrently); every
        sub-request lands in the fan-out counters and the per-shard
        latency histograms."""
        reg = self.registry
        for sid, reqs in requests_by_shard.items():
            reg.inc("shard.shard_requests", len(reqs))

        def run_one(sid: int, reqs: "list[dict]") -> "list[dict]":
            t0 = time.perf_counter_ns()
            replies = self.backends[sid].run(reqs)
            reg.observe(
                self._req_ms[sid], (time.perf_counter_ns() - t0) / 1e6
            )
            return replies

        items = list(requests_by_shard.items())
        if self._pool is None or len(items) == 1:
            return {sid: run_one(sid, reqs) for sid, reqs in items}
        # the gather thread does one shard's work itself instead of idling
        # on futures — one fewer pool round-trip per fan-out
        futures = {
            sid: self._pool.submit(run_one, sid, reqs)
            for sid, reqs in items[1:]
        }
        out = {items[0][0]: run_one(*items[0])}
        out.update({sid: f.result() for sid, f in futures.items()})
        return out

    # -- queries ------------------------------------------------------------

    def execute_query(self, text: str, limit: int | None = None) -> dict:
        """One query -> one wire-shaped reply dict (``error``/``code`` on
        failure — callers pick exceptions or passthrough)."""
        return self.execute_query_group([_Item(text=text, limit=limit)])[0]

    def execute_query_group(self, items: "list[_Item]") -> "list[dict]":
        """A micro-batch (one plan signature, when called by the
        coordinator) -> one reply per item, order preserved.  Routed
        items sub-group by target shard; scattered items ship to every
        shard in a single pipelined batch per shard."""
        reg = self.registry
        t0 = time.perf_counter_ns()
        replies: "list[dict | None]" = [None] * len(items)
        routed: "dict[int, list[int]]" = {}
        scattered: "list[int]" = []
        decomposed: "list[int]" = []
        for i, it in enumerate(items):
            if it.error is not None:
                replies[i] = it.error
                continue
            if it.q is None:
                try:
                    it.q = algebra.parse_select(it.text)
                except ValueError as e:
                    replies[i] = {"error": str(e), "code": "parse"}
                    continue
            mode, target = M.choose_dispatch(it.q, self.n_shards)
            if mode == M.ROUTED:
                routed.setdefault(target, []).append(i)
            elif mode == M.SCATTER:
                scattered.append(i)
            else:
                decomposed.append(i)

        if routed:
            reg.inc("shard.routed", sum(len(v) for v in routed.values()))
            requests = {
                sid: [
                    {"query": items[i].text, "_q": items[i].q, **(
                        {"limit": items[i].limit}
                        if items[i].limit is not None else {}
                    )}
                    for i in idxs
                ]
                for sid, idxs in routed.items()
            }
            for sid, shard_replies in self._run_on(requests).items():
                for i, reply in zip(routed[sid], shard_replies):
                    replies[i] = reply  # single-shard truth: pass through
                    reg.observe("shard.fanout", 1)

        if scattered:
            reg.inc("shard.scattered", len(scattered))
            self._run_scattered(items, scattered, replies)

        for i in decomposed:
            reg.inc("shard.decomposed")
            replies[i] = self._run_decomposed(items[i])

        reg.observe("shard.gather_ms", (time.perf_counter_ns() - t0) / 1e6)
        return replies

    def _run_scattered(
        self,
        items: "list[_Item]",
        idxs: "list[int]",
        replies: "list[dict | None]",
    ) -> None:
        subs = []
        for i in idxs:
            q = items[i].q
            sub = M.scatter_query(q)
            cap = items[i].limit if items[i].limit is not None else self.max_rows
            subs.append({
                # an unchanged sub-query ships the client's own text
                "query": items[i].text if sub is q else algebra.to_text(sub),
                "_q": sub,
                "limit": M.scatter_decode_limit(q, cap),
            })
        per_shard = self._run_on(
            {sid: list(subs) for sid in range(self.n_shards)}
        )
        for pos, i in enumerate(idxs):
            q = items[i].q
            shard_replies = [per_shard[sid][pos] for sid in range(self.n_shards)]
            err = next((r for r in shard_replies if r.get("error")), None)
            if err is not None:
                replies[i] = {"error": err["error"], "code": err.get("code")}
                continue
            rows, n_total = M.merge_scatter(
                q,
                [
                    (_tuple_rows(rep.get("rows", ())),
                     int(rep.get("n_total", 0)))
                    for rep in shard_replies
                ],
            )
            cap = items[i].limit if items[i].limit is not None else self.max_rows
            reply = {
                "vars": shard_replies[0].get("vars", list(q.out_vars())),
                "rows": rows[:cap],
                "n_total": n_total,
                "batch_size": len(idxs),
                "latency_ms": max(
                    float(r.get("latency_ms", 0.0)) for r in shard_replies
                ),
            }
            if shard_replies[0].get("agg_vars"):
                reply["agg_vars"] = shard_replies[0]["agg_vars"]
            replies[i] = reply
            self.registry.observe("shard.fanout", self.n_shards)

    def _run_decomposed(self, item: _Item) -> dict:
        """Chains and friends: gather each pattern's matches (single
        patterns partition cleanly by their own subject), then run the
        oracle's algebra tail host-side."""
        q = item.q
        subs = M.decompose_queries(q)
        requests: "dict[int, list[dict]]" = {}
        slots: "list[list[tuple[int, int]]]" = []  # per sub: (shard, pos)
        for sub, subject in subs:
            targets = (
                [shard_of_term(subject, self.n_shards)]
                if subject is not None
                else range(self.n_shards)
            )
            placed = []
            for sid in targets:
                lst = requests.setdefault(sid, [])
                placed.append((sid, len(lst)))
                lst.append(
                    {"query": algebra.to_text(sub), "_q": sub,
                     "limit": M.BIG_LIMIT}
                )
            slots.append(placed)
        per_shard = self._run_on(requests)
        fanout = len(requests)
        pattern_sols = []
        for (sub, _subject), placed in zip(subs, slots):
            shard_rows = []
            for sid, pos in placed:
                rep = per_shard[sid][pos]
                if rep.get("error"):
                    return {"error": rep["error"], "code": rep.get("code")}
                shard_rows.append(_tuple_rows(rep.get("rows", ())))
            pattern_sols.append(M.pattern_rows_to_solutions(sub, shard_rows))
        rows, n_total = M.combine_decomposed(q, pattern_sols)
        cap = item.limit if item.limit is not None else self.max_rows
        reply = {
            "vars": list(q.out_vars()),
            "rows": rows[:cap],
            "n_total": n_total,
            "batch_size": 1,
            "latency_ms": 0.0,
        }
        if q.agg is not None:
            reply["agg_vars"] = [q.agg.alias]
        self.registry.observe("shard.fanout", fanout)
        return reply

    # -- mutations / misc ---------------------------------------------------

    def mutate(self, op: str, triples=None) -> dict:
        """insert/delete route each triple to its subject's shard;
        compact broadcasts.  The merged reply sums counts and reports the
        *total* triple count across shards."""
        if op == "compact":
            requests = {
                sid: [{"op": "compact"}] for sid in range(self.n_shards)
            }
        else:
            buckets: "dict[int, list[list[str]]]" = {}
            for t in triples:
                sid = shard_of_term(t[0], self.n_shards)
                buckets.setdefault(sid, []).append([t[0], t[1], t[2]])
            requests = {
                sid: [{"op": op, "triples": ts}]
                for sid, ts in buckets.items()
            }
        merged: dict = {}
        n_total = 0
        generation = 0
        for sid, reps in self._run_on(requests).items():
            rep = reps[0]
            if rep.get("error"):
                return {"error": rep["error"], "code": rep.get("code")}
            for key in ("inserted", "deleted", "tombstoned"):
                if key in rep:
                    merged[key] = merged.get(key, 0) + rep[key]
            if "compacted" in rep:
                merged["compacted"] = True
                merged["compact_ms"] = round(
                    merged.get("compact_ms", 0.0) + rep.get("compact_ms", 0.0),
                    3,
                )
            n_total += int(rep.get("n_total", 0))
            generation = max(generation, int(rep.get("generation", 0)))
        merged["n_total"] = n_total
        merged["generation"] = generation
        merged["shards_touched"] = len(requests)
        return merged

    def explain(self, text: str) -> dict:
        """The dispatch decision, plus the routed/first shard's own plan."""
        try:
            q = algebra.parse_select(text)
        except ValueError as e:
            return {"error": str(e), "code": "parse"}
        mode, target = M.choose_dispatch(q, self.n_shards)
        sid = target if mode == M.ROUTED else 0
        rep = self.backends[sid].run([{"op": "explain", "query": text}])[0]
        if rep.get("error"):
            return rep
        where = (
            f"shard {target}" if mode == M.ROUTED
            else f"all {self.n_shards} shards"
        )
        return {"plan": f"shard:{mode} -> {where}\n{rep.get('plan', '')}"}


# ---------------------------------------------------------------------------
# opening groups
# ---------------------------------------------------------------------------


def open_shard_group(
    manifest_path: str,
    read_only: bool = False,
    registry: MetricsRegistry | None = None,
    max_rows: int = 1000,
    device="cuda",
) -> ShardGroup:
    """In-process group over a manifest's shard stores (no sockets) — the
    ``api.connect(<manifest>)`` path.  Mutable by default: each shard
    loads as a :class:`~repro_torch.live.delta.LiveStore` chain, so inserts
    route and apply exactly like against a single live store.  Every
    shard opens on ``device``."""
    from repro_torch.kg import persist

    m = persist.load_manifest(manifest_path)
    # a long-lived coordinator holds every shard open; make sure the
    # open_store LRU is not evicting (and re-validating) them in a cycle
    _size, cap = persist.open_store_cache_info()
    if m["n_shards"] + 2 > cap:
        persist.set_open_store_cache_size(m["n_shards"] + 2)
    sessions = []
    for entry in m["shards"]:
        if read_only:
            sessions.append(
                LocalSession(
                    persist.open_store(entry["abs_path"], device=device),
                    read_only=True,
                )
            )
        else:
            sessions.append(LocalSession(
                persist.load_chain(entry["abs_path"], device=device)))
    return ShardGroup(
        [_LocalBackend(s) for s in sessions],
        registry=registry,
        max_rows=max_rows,
    )


def connect_shard_group(
    addresses: "list[str]",
    retry_s: float = 0.0,
    timeout: float = 30.0,
    registry: MetricsRegistry | None = None,
    max_rows: int = 1000,
) -> ShardGroup:
    """Group over already-running shard servers (``"host:port"`` each)."""
    backends = []
    for addr in addresses:
        host, _, port = addr.rpartition(":")
        backends.append(
            _SocketBackend(
                ShardLink(
                    host or "127.0.0.1", int(port),
                    timeout=timeout, retry_s=retry_s,
                )
            )
        )
    return ShardGroup(backends, registry=registry, max_rows=max_rows)


def _serve_shard(path: str, read_only: bool, device: str, conn) -> None:
    """A spawned shard server's process: open the shard store on
    ``device`` (its own CUDA context), serve it on a free local port, send
    the port to the parent, and stop when the parent says so (or goes)."""
    from repro_torch.kg import persist
    from repro_torch.live.delta import LiveStore
    from repro_torch.serve.server import KGServer

    try:
        store = persist.open_store(path, device=device)
        served = store if read_only else LiveStore(store)
        srv = KGServer(
            served, port=0, log=False, read_only=read_only,
            kg_path=None if read_only else path,
        ).start()
    except BaseException as e:  # the parent raises it: never hang its wait
        conn.send(("error", f"{type(e).__name__}: {e}"))
        raise
    conn.send(("ok", srv.port))
    try:
        conn.recv()  # "stop", or EOFError when the parent is gone
    except EOFError:
        pass
    srv.stop()


class ShardProcess:
    """One spawned shard server: its ``host``/``port`` and :meth:`stop`."""

    def __init__(self, proc, conn, host: str, port: int):
        self._proc = proc
        self._conn = conn
        self.host = host
        self.port = port

    def stop(self) -> None:
        try:
            self._conn.send("stop")
        except OSError:
            pass
        self._proc.join(timeout=10.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        self._conn.close()


# a spawned shard server's start: import torch, open a CUDA context, load
# the shard store and build its device index
SHARD_START_TIMEOUT_S = 600.0


def spawn_shard_servers(
    manifest_path: str,
    read_only: bool = False,
    device="cuda",
):
    """Start one :class:`~repro_torch.serve.server.KGServer` per shard store
    (port 0 each), each in a spawned process over its shard opened on
    ``device``, and return ``(servers, addresses)`` — the coordinator's
    self-hosting path, exercising the real wire protocol.  Each server's
    ``stop()`` ends its process."""
    from repro_torch.kg import persist

    m = persist.load_manifest(manifest_path)
    ctx = multiprocessing.get_context("spawn")
    started = []
    for entry in m["shards"]:
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_serve_shard,
            args=(entry["abs_path"], read_only, str(device), child),
            daemon=True,
        )
        proc.start()
        child.close()
        started.append((proc, parent))
    servers = []
    try:
        for proc, parent in started:
            if not parent.poll(SHARD_START_TIMEOUT_S):
                raise RuntimeError("a shard server did not start in time")
            status, value = parent.recv()
            if status != "ok":
                raise RuntimeError(f"a shard server failed to start: {value}")
            servers.append(ShardProcess(proc, parent, "127.0.0.1", value))
    except BaseException:
        for proc, parent in started:
            proc.terminate()
            proc.join(timeout=5.0)
            parent.close()
        raise
    return servers, [f"{s.host}:{s.port}" for s in servers]


# ---------------------------------------------------------------------------
# the api.Session face
# ---------------------------------------------------------------------------


class ShardSession(Session):
    """A :class:`repro_torch.api.Session` over a :class:`ShardGroup` — what
    ``api.connect()`` returns for a shard-manifest target.  Error replies
    surface as the same typed hierarchy every other session raises."""

    def __init__(self, group: ShardGroup):
        self.group = group

    @staticmethod
    def _raise_on_error(reply: dict) -> dict:
        if reply.get("error"):
            raise error_from_reply(reply)
        return reply

    def query(self, text: str, limit: int | None = None) -> QueryResult:
        from repro_torch.api import _check_limit

        _check_limit(limit)
        r = self._raise_on_error(self.group.execute_query(text, limit=limit))
        return QueryResult(
            vars=tuple(r.get("vars", ())),
            rows=_tuple_rows(r.get("rows", ())),
            n_total=int(r.get("n_total", 0)),
            agg_vars=tuple(r.get("agg_vars", ())),
            latency_ms=float(r.get("latency_ms", 0.0)),
            batch_size=int(r.get("batch_size", 1)),
            raw=r,
        )

    def explain(self, text: str) -> str:
        return self._raise_on_error(self.group.explain(text))["plan"]

    def insert(self, triples) -> dict:
        from repro_torch.api import _check_triples

        return self._raise_on_error(
            self.group.mutate("insert", _check_triples(triples))
        )

    def delete(self, triples) -> dict:
        from repro_torch.api import _check_triples

        return self._raise_on_error(
            self.group.mutate("delete", _check_triples(triples))
        )

    def compact(self) -> dict:
        return self._raise_on_error(self.group.mutate("compact"))

    def metrics(self) -> dict:
        return {"metrics": self.group.registry.snapshot(), "signatures": {}}

    def close(self) -> None:
        self.group.close()


# ---------------------------------------------------------------------------
# the NDJSON server face
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    item: _Item
    req_id: object
    reply: "callable"
    t_enq_ns: int
    op: str = "query"
    triples: list | None = None


class Coordinator:
    """A drop-in :class:`~repro_torch.serve.server.KGServer` lookalike whose
    store is a shard group: same wire protocol, same per-signature
    micro-batching (a gathered group scatters as ONE pipelined batch per
    shard), same mutation-barrier ordering."""

    def __init__(
        self,
        group: ShardGroup,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 4096,
        linger_ms: float = 2.0,
        log: bool = True,
        servers: list | None = None,
    ):
        self.group = group
        self.registry = group.registry
        self.max_batch = max_batch
        self.linger_s = linger_ms / 1e3
        self.log = log
        self._servers = servers or []  # spawned shard server processes
        self._sig_examples: dict[str, str] = {}
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]

    @classmethod
    def from_manifest(
        cls,
        manifest_path: str,
        host: str = "127.0.0.1",
        port: int = 0,
        read_only: bool = False,
        wire_shards: bool = True,
        registry: MetricsRegistry | None = None,
        max_rows: int = 1000,
        device="cuda",
        **kw,
    ) -> "Coordinator":
        """Self-hosting start: spawn the manifest's shards behind real
        NDJSON servers, one process each (``wire_shards=True``, the
        production shape), or open them in-process (False — fewer moving
        parts for tests); either way on ``device``."""
        if wire_shards:
            servers, addresses = spawn_shard_servers(
                manifest_path, read_only=read_only, device=device
            )
            group = connect_shard_group(
                addresses, registry=registry, max_rows=max_rows
            )
            return cls(group, host=host, port=port, servers=servers, **kw)
        group = open_shard_group(
            manifest_path, read_only=read_only,
            registry=registry, max_rows=max_rows, device=device,
        )
        return cls(group, host=host, port=port, **kw)

    # -- lifecycle (mirrors KGServer) ---------------------------------------

    def start(self) -> "Coordinator":
        for target in (self._accept_loop, self._dispatch_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        if self.log:
            print(
                f"[serve] listening on {self.host}:{self.port} "
                f"(coordinator, {self.group.n_shards} shards)",
                file=sys.stderr,
                flush=True,
            )
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)
        for s in self._servers:
            s.stop()
        self.group.close()

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()

    def _client_loop(self, conn: socket.socket) -> None:
        wlock = threading.Lock()

        def send(obj: dict) -> None:
            data = (json.dumps(obj) + "\n").encode("utf-8")
            with wlock:
                try:
                    conn.sendall(data)
                except OSError:
                    pass

        try:
            rfile = conn.makefile("r", encoding="utf-8")
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    self.registry.inc("shard.errors")
                    send({"error": f"bad json: {e}", "code": "bad_request"})
                    continue
                try:
                    self._handle(req, send)
                except Exception as e:  # noqa: BLE001 — keep the socket alive
                    self.registry.inc("shard.errors")
                    rid = req.get("id") if isinstance(req, dict) else None
                    send({"id": rid, "error": f"{type(e).__name__}: {e}",
                          "code": "internal"})
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stats_dict(self) -> dict:
        reg = self.registry
        queries = reg.counter("shard.queries").value
        batches = reg.counter("shard.batches").value
        return {
            "queries": queries,
            "batches": batches,
            "errors": reg.counter("shard.errors").value,
            "mean_batch": queries / batches if batches else 0.0,
            "n_shards": self.group.n_shards,
            "routed": reg.counter("shard.routed").value,
            "scattered": reg.counter("shard.scattered").value,
            "decomposed": reg.counter("shard.decomposed").value,
            "shard_requests": reg.counter("shard.shard_requests").value,
        }

    def _handle(self, req: dict, send) -> None:
        op = req.get("op")
        if op == "ping":
            send({"ok": True, "id": req.get("id")})
            return
        if op == "stats":
            send({"id": req.get("id"), **self.stats_dict()})
            return
        if op == "metrics":
            send({
                "id": req.get("id"),
                "metrics": self.registry.snapshot(),
                "signatures": dict(self._sig_examples),
            })
            return
        if op == "explain":
            reply = self.group.explain(req.get("query") or "")
            send({"id": req.get("id"), **reply})
            return
        if op in ("insert", "delete", "compact"):
            triples = req.get("triples")
            if op != "compact" and (
                not isinstance(triples, list)
                or not triples
                or not all(
                    isinstance(t, list) and len(t) == 3
                    and all(isinstance(x, str) for x in t)
                    for t in triples
                )
            ):
                self.registry.inc("shard.errors")
                send({
                    "id": req.get("id"),
                    "error": "'triples' must be a non-empty list of "
                             "[s, p, o] term-string triples",
                    "code": "bad_request",
                })
                return
            self._queue.put(_Pending(
                item=_Item(text="", limit=None),
                req_id=req.get("id"),
                reply=send,
                t_enq_ns=time.perf_counter_ns(),
                op=op,
                triples=triples,
            ))
            return
        text = req.get("query")
        if not isinstance(text, str):
            self.registry.inc("shard.errors")
            send({"id": req.get("id"), "error": "missing 'query'",
                  "code": "bad_request"})
            return
        limit = req.get("limit")
        if limit is not None and (
            not isinstance(limit, int) or isinstance(limit, bool) or limit < 0
        ):
            self.registry.inc("shard.errors")
            send({"id": req.get("id"),
                  "error": "'limit' must be a non-negative integer",
                  "code": "bad_request"})
            return
        item = _Item(text=text, limit=limit)
        try:
            item.q = algebra.parse_select(text)
        except ValueError as e:
            item.error = {"error": str(e), "code": "parse"}
        self._queue.put(_Pending(
            item=item,
            req_id=req.get("id"),
            reply=send,
            t_enq_ns=time.perf_counter_ns(),
        ))

    def _drain(self) -> "list[_Pending]":
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.linger_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            queries: "list[_Pending]" = []
            for p in batch:
                if p.op == "query":
                    queries.append(p)
                    continue
                self._flush_queries(queries)
                queries = []
                self._apply_mutation(p)
            self._flush_queries(queries)

    def _flush_queries(self, pending: "list[_Pending]") -> None:
        if not pending:
            return
        reg = self.registry
        groups: "dict[object, list[_Pending]]" = {}
        for p in pending:
            key = p.item.q.signature() if p.item.q is not None else ("<bad>",)
            groups.setdefault(key, []).append(p)
        for group in groups.values():
            t0 = time.perf_counter_ns()
            first_q = group[0].item.q
            if first_q is not None:
                label = track_sig(
                    self._sig_examples,
                    f"x{self.group.n_shards}:{hash(first_q.signature()) & 0xFFFFFF:06x}",
                    group[0].item.text,
                )
            replies = self.group.execute_query_group([p.item for p in group])
            lat_ms = (time.perf_counter_ns() - t0) / 1e6
            reg.inc("shard.queries", len(group))
            reg.inc("shard.batches")
            reg.observe("shard.exec_ms", lat_ms)
            if first_q is not None:
                reg.observe(f"shard.exec_ms.sig={label}", lat_ms)
            for p, reply in zip(group, replies):
                if reply.get("error"):
                    reg.inc("shard.errors")
                p.reply({"id": p.req_id, **reply})

    def _apply_mutation(self, p: _Pending) -> None:
        reply = self.group.mutate(p.op, p.triples)
        if reply.get("error"):
            self.registry.inc("shard.errors")
        p.reply({"id": p.req_id, **reply})
