"""Long-lived batching query server over one open ``.kgz`` store.

Wire protocol (newline-delimited JSON over a local TCP socket; one JSON
object per line, one response line per request, ``id`` echoed back):

    -> {"id": 1, "query": "SELECT ?g WHERE { ?m <p> ?g } LIMIT 5"}
    <- {"id": 1, "vars": ["?g"], "rows": [["<g0>"]], "n_total": 12,
        "batch_size": 3, "latency_ms": 1.9}

    -> {"id": 2, "query": "...", "limit": 10}     # decode at most 10 rows
       (without "limit", decoded rows are capped at ``max_rows`` — 1000 by
       default; "n_total" always reports the full solution count)

    -> {"id": 3, "query": "SELECT ?g (COUNT(*) AS ?n) WHERE { ?m <p> ?g }
                           GROUP BY ?g ORDER BY DESC(?n)"}
    <- {"id": 3, "vars": ["?g", "?n"], "agg_vars": ["?n"],
        "rows": [["<g1>", 7], ["<g0>", 3]], ...}
       (aggregate columns listed in "agg_vars" carry JSON numbers, not
       rendered terms; UNION / ORDER BY answers look like plain rows)
    -> {"op": "ping"}                              <- {"ok": true}
    -> {"op": "stats"}                             <- running counters
    -> {"op": "explain", "query": "..."}           <- the planned operator tree

Mutation ops (served stores wrapped in a :class:`repro_torch.live.delta.LiveStore`;
rejected with ``"code": "read_only"`` on a read-only or plain store):

    -> {"id": 4, "op": "insert", "triples": [["<s>", "<p>", "\"o\""]]}
    <- {"id": 4, "inserted": 1, "n_total": 101, "generation": 3,
        "delta_fraction": 0.01}
    -> {"id": 5, "op": "delete", "triples": [["<s>", "<p>", "\"o\""]]}
    <- {"id": 5, "deleted": 1, "tombstoned": 0, ...}
    -> {"id": 6, "op": "compact"}
    <- {"id": 6, "compacted": true, "compact_ms": 12.3, "persisted": true,
        "n_total": 100, "generation": 4}

Errors come back as ``{"id": ..., "error": "...", "code": "..."}`` where
``code`` is one of ``parse`` (bad query text), ``bad_request`` (malformed
request: missing ``query``, bad ``limit``/``triples``, bad json),
``read_only`` (mutation on a read-only store) or ``internal`` (handler
failure) — :mod:`repro_torch.api.errors` maps them to typed exceptions.
``rows`` hold rendered N-Triples terms with ``null`` for unbound
(OPTIONAL-miss) variables.

Batching: connection threads only parse and enqueue; a single dispatcher
thread drains the queue (a short linger lets concurrent clients pile up),
groups in-flight requests by plan *signature* — the structural identity of
a query with constants abstracted — and executes every group as ONE
batched dispatch through the ``repro_torch.serve.exec`` pipeline on the
store's device (``cuda`` unless the store was opened on the CPU).  A
dispatch that fails (a CUDA error included: every dispatch ends in a device→host
copy, so an asynchronous fault surfaces inside it) answers each request of
its group with a ``"code": "internal"`` error, and the dispatcher goes on
serving.

Mutations serialize on the same dispatcher thread, between query groups:
each query group captures one copy-on-write overlay snapshot
(``LiveStore.view()``) before dispatch, so an in-flight micro-batch never
observes a half-applied mutation; requests that arrived before a mutation
execute against the pre-mutation snapshot.  ``compact`` swaps in the
rebuilt base store (and rewrites the served ``.kgz`` in place when the
server owns a path).

Observability: every request's queue-wait and execute time land in
``repro_torch.obs`` latency histograms (global plus per plan signature), the
``stats`` op keeps its original flat-counter shape (now read from the
registry, whose single lock makes the accept/client/dispatch-thread
updates atomic — the old hand-rolled ``ServerStats`` counters raced), and
the ``metrics`` op returns the full registry snapshot:

    -> {"op": "metrics"}
    <- {"id": ..., "metrics": {"counters": ..., "gauges": ...,
        "histograms": {"serve.queue_wait_ms": {"count": ..., "p50": ...,
        "p99": ...}, ...}}, "signatures": {"<sig>": "<example query>"}}

With tracing enabled (``--trace`` on ``repro_torch.launch.serve``) each request
also records ``queue_wait`` / ``dispatch`` / ``redispatch`` spans into the
Chrome-trace ring buffer.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import socket
import sys
import threading
import time

from repro_torch.kg.store import TripleStore
from repro_torch.live.delta import LiveStore
from repro_torch.obs import MetricsRegistry, get_registry, get_tracer
from repro_torch.serve import algebra
from repro_torch.serve.exec import Executor, get_executor, plan_label
from repro_torch.serve.values import value_table


# per-signature observability is bounded: beyond this many distinct plan
# signatures, new ones collapse into one "overflow" bucket so an
# adversarial (or just very heterogeneous) query stream cannot grow the
# `metrics` snapshot and the legend without bound
MAX_TRACKED_SIGS = 64


def track_sig(examples: dict[str, str], label: str, text: str) -> str:
    """Register ``label`` in the signature legend (first example query
    wins) and return the label to tag metrics with — ``"overflow"`` once
    the legend is full.  Shared by the server and the shard coordinator."""
    if label in examples:
        return label
    if len(examples) >= MAX_TRACKED_SIGS:
        return "overflow"
    examples[label] = text
    return label


@dataclasses.dataclass
class _Pending:
    query: algebra.SelectQuery | None
    text: str
    req_id: object
    limit: int | None
    reply: "callable"
    t_enq_ns: int
    op: str = "query"
    triples: list | None = None


class _AdaptiveLinger:
    """Pick the micro-batch linger window from the live arrival rate.

    The fixed window trades every request's latency for batch size even
    when nobody else is queuing — the worst deal exactly where the
    small-batch fast path matters (interactive, batch-1 traffic).  This
    tracks an EWMA of the inter-arrival gap and sizes the window by the
    *expected coalesce gain*:

    * no rate estimate yet (cold start) → the full configured window,
      the previous fixed behavior;
    * expected arrivals within a full window below ``min_expected`` →
      zero linger: dispatch immediately, nobody was going to share the
      batch anyway;
    * otherwise scale the window with the fraction of a full batch
      (``full_batch``) a max-length linger would collect, floored at
      the executor's observed p50 execute time (batching finer than one
      dispatch can't help — requests pile up behind the dispatch
      regardless) and capped at the configured maximum.

    Arrival observation is a single EWMA update per request (connection
    threads; GIL-atomic enough — the window only needs to be roughly
    right).  Unit-testable deterministically via ``observe_arrival`` /
    ``window_s``.
    """

    def __init__(
        self,
        max_s: float,
        registry: MetricsRegistry,
        full_batch: int = 64,
        alpha: float = 0.2,
        min_expected: float = 1.5,
    ):
        self.max_s = max_s
        self.registry = registry
        self.full_batch = full_batch
        self.alpha = alpha
        self.min_expected = min_expected
        self._last_ns: int | None = None
        self._gap_s: float | None = None  # EWMA inter-arrival gap

    def observe_arrival(self, t_ns: int) -> None:
        last = self._last_ns
        self._last_ns = t_ns
        if last is None:
            return
        gap = max((t_ns - last) / 1e9, 1e-9)
        g = self._gap_s
        self._gap_s = gap if g is None else (1 - self.alpha) * g + self.alpha * gap

    def window_s(self) -> float:
        g = self._gap_s
        if g is None or self.max_s <= 0:
            return self.max_s
        expected = self.max_s / g  # arrivals a full linger would see
        if expected < self.min_expected:
            return 0.0
        w = self.max_s * min(1.0, expected / self.full_batch)
        p50_ms = self.registry.histogram("serve.exec_ms").percentile(50)
        if p50_ms:
            w = max(w, min(self.max_s, p50_ms / 1e3))
        return min(w, self.max_s)


class KGServer:
    """Serve one store — immutable, or mutable when wrapped in a
    :class:`LiveStore`; see the module docstring for protocol."""

    def __init__(
        self,
        store: TripleStore | LiveStore,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 4096,
        linger_ms: float = 2.0,
        max_rows: int = 1000,
        log: bool = True,
        registry: MetricsRegistry | None = None,
        read_only: bool = False,
        kg_path: str | None = None,
        warmup: bool = False,
        adaptive_linger: bool = True,
    ):
        if isinstance(store, LiveStore):
            self.live: LiveStore | None = store
            store = store.base
        else:
            self.live = None
        self.store = store
        self.read_only = read_only or self.live is None
        self.kg_path = kg_path  # compact rewrites this .kgz in place
        self.executor: Executor = get_executor(store)
        # build the value-typed rank side tables (FILTER / ORDER BY keys)
        # on device now, at server store-load time, so no client ever pays
        # the per-term decode loop on the first filtered or ordered query
        value_table(store)
        self.max_batch = max_batch
        self.max_rows = max_rows
        self.linger_s = linger_ms / 1e3
        self.log = log
        # the process-global registry by default (so the `metrics` op also
        # surfaces executor/stream metrics); tests pass their own
        self.registry = registry if registry is not None else get_registry()
        # adaptive micro-batch window: linger_ms is the MAXIMUM; the live
        # arrival rate shrinks it (to zero for sparse interactive traffic)
        self._linger = _AdaptiveLinger(
            max_s=self.linger_s, registry=self.registry, full_batch=max(
                1, min(self.max_batch, 64)
            ),
        )
        self._adaptive = adaptive_linger
        if warmup:
            # run the dominant small-batch shapes once so the first
            # interactive query after start finds its pipeline cached
            self.executor.warmup()
        # plan-signature label -> an example query text, so the `metrics`
        # op's per-signature histograms are interpretable
        self._sig_examples: dict[str, str] = {}
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._last_log = 0.0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "KGServer":
        for target in (self._accept_loop, self._dispatch_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        if self.log:
            src = self.live if self.live is not None else self.store
            mode = "read-only" if self.read_only else "live"
            print(
                f"[serve] listening on {self.host}:{self.port} ({mode}) — "
                f"{src.n_triples} triples, {src.n_terms} terms",
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

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- accept / per-connection ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed
            t = threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            )
            t.start()

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
                    self.registry.inc("serve.errors")
                    send({"error": f"bad json: {e}", "code": "bad_request"})
                    continue
                try:
                    self._handle(req, send)
                except Exception as e:  # noqa: BLE001 — never drop the socket
                    self.registry.inc("serve.errors")
                    rid = req.get("id") if isinstance(req, dict) else None
                    send({"id": rid, "error": f"{type(e).__name__}: {e}",
                          "code": "internal"})
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stats_dict(self) -> dict:
        """The ``stats`` op's original flat-counter shape, read from the
        registry (one lock: the counters are mutually consistent)."""
        queries = self.registry.counter("serve.queries").value
        batches = self.registry.counter("serve.batches").value
        exec_s = self.registry.counter("serve.exec_s").value
        return {
            "queries": queries,
            "batches": batches,
            "errors": self.registry.counter("serve.errors").value,
            "busiest_batch": self.registry.gauge("serve.busiest_batch").value,
            "mean_batch": queries / batches if batches else 0.0,
            "exec_queries_per_s": queries / exec_s if exec_s else 0.0,
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
        if op in ("insert", "delete", "compact"):
            self._enqueue_mutation(op, req, send)
            return
        text = req.get("query")
        if not isinstance(text, str):
            self.registry.inc("serve.errors")
            send({"id": req.get("id"), "error": "missing 'query'",
                  "code": "bad_request"})
            return
        try:
            q = algebra.parse_select(text)
        except ValueError as e:
            self.registry.inc("serve.errors")
            send({"id": req.get("id"), "error": str(e), "code": "parse"})
            return
        if op == "explain":
            plan = self.executor.plan(q)
            send({"id": req.get("id"), "plan": plan.explain()})
            return
        limit = req.get("limit")
        if limit is not None and (
            not isinstance(limit, int) or isinstance(limit, bool) or limit < 0
        ):
            self.registry.inc("serve.errors")
            send({"id": req.get("id"),
                  "error": "'limit' must be a non-negative integer",
                  "code": "bad_request"})
            return
        t_enq = time.perf_counter_ns()
        self._linger.observe_arrival(t_enq)
        self._queue.put(
            _Pending(
                query=q,
                text=text,
                req_id=req.get("id"),
                limit=limit,
                reply=send,
                t_enq_ns=t_enq,
            )
        )

    def _enqueue_mutation(self, op: str, req: dict, send) -> None:
        """Validate a mutation request on the connection thread; apply it
        on the dispatcher thread (one writer, serialized with queries)."""
        if self.read_only:
            # structured rejection — a read-only server keeps serving
            # queries, it never crashes the dispatch thread on a write
            self.registry.inc("serve.errors")
            self.registry.inc("live.rejected")
            send({
                "id": req.get("id"),
                "error": "store is read-only: mutation rejected",
                "code": "read_only",
            })
            return
        triples = None
        if op in ("insert", "delete"):
            triples = req.get("triples")
            if (
                not isinstance(triples, list)
                or not triples
                or not all(
                    isinstance(t, list)
                    and len(t) == 3
                    and all(isinstance(x, str) for x in t)
                    for t in triples
                )
            ):
                self.registry.inc("serve.errors")
                send({
                    "id": req.get("id"),
                    "error": "'triples' must be a non-empty list of "
                             "[s, p, o] term-string triples",
                    "code": "bad_request",
                })
                return
        t_enq = time.perf_counter_ns()
        self._linger.observe_arrival(t_enq)
        self._queue.put(
            _Pending(
                query=None,
                text="",
                req_id=req.get("id"),
                limit=None,
                reply=send,
                t_enq_ns=t_enq,
                op=op,
                triples=triples,
            )
        )

    # -- the micro-batching dispatcher ----------------------------------------

    def _drain(self) -> list[_Pending]:
        """Block for the first request, then linger briefly so concurrent
        clients coalesce into one batch."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        linger = (
            self._linger.window_s() if self._adaptive else self.linger_s
        )
        deadline = time.perf_counter() + linger
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
            # queries batch freely between mutations, but a mutation is an
            # ordering barrier: everything enqueued before it executes
            # against the pre-mutation snapshot, everything after sees it
            queries: list[_Pending] = []
            for p in batch:
                if p.op == "query":
                    queries.append(p)
                    continue
                self._flush_queries(queries)
                queries = []
                self._apply_mutation(p)
            self._flush_queries(queries)

    def _fail(self, group: "list[_Pending]", e: BaseException) -> None:
        """Answer every request of a failed group with the typed internal
        error (the client raises ``ServerError``); serving goes on."""
        self.registry.inc("serve.errors", len(group))
        for p in group:
            p.reply({"id": p.req_id, "error": f"{type(e).__name__}: {e}",
                     "code": "internal"})

    def _flush_queries(self, pending: list[_Pending]) -> None:
        if not pending:
            return
        groups: dict[tuple, list[_Pending]] = {}
        for p in pending:
            groups.setdefault(p.query.signature(), []).append(p)
        for group in groups.values():
            self._run_group(group)

    def _apply_mutation(self, p: _Pending) -> None:
        """Apply one insert/delete/compact on the dispatcher thread.  The
        overlay mutates copy-on-write: query groups snapshot a view before
        dispatch, so nothing in flight sees a half-applied change."""
        live = self.live
        reg = self.registry
        try:
            if p.op == "insert":
                added = live.insert([tuple(t) for t in p.triples])
                reg.inc("live.inserts", added)
                reply = {"id": p.req_id, "inserted": added}
            elif p.op == "delete":
                deleted, tombstoned = live.delete(
                    [tuple(t) for t in p.triples]
                )
                reg.inc("live.deletes", deleted)
                reg.inc("live.tombstone_hits", tombstoned)
                reply = {
                    "id": p.req_id,
                    "deleted": deleted,
                    "tombstoned": tombstoned,
                }
            else:  # compact
                t0 = time.perf_counter_ns()
                new_base = live.compact()
                # swap the served base copy-on-write: executor and value
                # tables rebuild against the new store before any later
                # query group runs
                self.store = new_base
                self.executor = get_executor(new_base)
                value_table(new_base)
                compact_ms = (time.perf_counter_ns() - t0) / 1e6
                reg.inc("live.compactions")
                reg.observe("live.compact_ms", compact_ms)
                reply = {
                    "id": p.req_id,
                    "compacted": True,
                    "compact_ms": round(compact_ms, 3),
                }
                if self.kg_path is not None:
                    from repro_torch.kg import persist

                    persist.save(
                        new_base, self.kg_path, generation=live.generation
                    )
                    reply["persisted"] = True
            reg.gauge("live.delta_fraction").set(live.delta_fraction)
            reply["n_total"] = live.n_triples
            reply["generation"] = live.generation
            reply["delta_fraction"] = round(live.delta_fraction, 6)
            p.reply(reply)
        except Exception as e:  # noqa: BLE001 — a bad write must not kill serving
            reg.inc("serve.errors")
            p.reply({"id": p.req_id, "error": f"{type(e).__name__}: {e}",
                          "code": "internal"})

    def _run_group(self, group: list[_Pending]) -> None:
        reg = self.registry
        tracer = get_tracer()
        t0_ns = time.perf_counter_ns()
        # queue wait: enqueue -> dispatch pickup, per request (what batching
        # linger + a busy dispatcher cost the client, separate from compute)
        for p in group:
            reg.observe("serve.queue_wait_ms", (t0_ns - p.t_enq_ns) / 1e6)
            if tracer.enabled:
                tracer.add_complete(
                    "queue_wait", "serve", p.t_enq_ns, t0_ns, req=p.req_id
                )
        try:
            plan = self.executor.plan(group[0].query)
            label = track_sig(
                self._sig_examples, plan_label(plan.sig), group[0].text
            )
            # snapshot the overlay (copy-on-write): this group answers over
            # exactly the mutations applied before it, whatever lands next
            view = self.live.view() if self.live is not None else None
            with tracer.span(
                "dispatch", cat="serve", plan=label, batch=len(group)
            ):
                result = self.executor.execute(
                    plan, [p.query for p in group], view=view
                )
        except Exception as e:  # noqa: BLE001 — a bad query must not kill serving
            self._fail(group, e)
            return
        dt = (time.perf_counter_ns() - t0_ns) / 1e9
        lat_ms = dt * 1e3
        reg.inc("serve.queries", len(group))
        reg.inc("serve.batches")
        reg.gauge("serve.busiest_batch").set_max(len(group))
        reg.inc("serve.exec_s", dt)
        reg.observe("serve.exec_ms", lat_ms)
        reg.observe(f"serve.exec_ms.sig={label}", lat_ms)
        for p in group:
            # the client-visible request latency: queue wait + execute
            reg.observe(
                "serve.request_ms", (time.perf_counter_ns() - p.t_enq_ns) / 1e6
            )
        try:
            replies = []
            for i, p in enumerate(group):
                # decoding runs on the dispatcher thread: cap undeclared row
                # counts so one huge answer cannot stall every other batch
                # (n_total still reports the full solution count)
                limit = p.limit if p.limit is not None else self.max_rows
                reply = {
                    "id": p.req_id,
                    "vars": list(result.vars),
                    "rows": [list(r) for r in result.rows(i, limit=limit)],
                    "n_total": result.n(i),
                    "batch_size": len(group),
                    "latency_ms": round(lat_ms, 3),
                }
                if result.agg_vars:
                    # aggregate (COUNT) columns: their row cells are JSON
                    # numbers, not rendered terms — name them for the client
                    reply["agg_vars"] = list(result.agg_vars)
                replies.append(reply)
        except Exception as e:  # noqa: BLE001 — a bad decode must not kill serving
            self._fail(group, e)
            return
        for p, reply in zip(group, replies):
            p.reply(reply)
        now = time.perf_counter()
        if self.log and now - self._last_log > 1.0:
            self._last_log = now
            print(
                f"[serve] batch={len(group)} {lat_ms:.1f}ms "
                f"({len(group) / dt:.0f} q/s in-batch; "
                f"totals: {reg.counter('serve.queries').value} queries, "
                f"{reg.counter('serve.batches').value} batches)",
                file=sys.stderr,
                flush=True,
            )
