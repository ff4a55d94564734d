"""Physical plan: lowering + pipelined execution with bounded prefetch.

Lowering first applies :func:`pushdown_projection` — a planner-marked
``Read -> Project`` prefix collapses into the datasource so pruned columns
are never materialized — then fuses each run of per-block logical ops
(Project / MapBlocks / Encode) into a single :class:`FusedMapOperator`;
``Batch`` becomes a :class:`RebatchOperator`.  Execution is a chain of generators with the read
stage handed off to a background thread through a bounded queue, so disk I/O
and parsing overlap the jitted compute of the consumer — the classic
two-stage pipeline — while the queue bound keeps at most
``prefetch + 1`` blocks in flight.

Every stage reports into ``repro_torch.obs``: per-block read / project / encode /
batch timings (``stream.<stage>_ms`` histograms), rows and bytes per stage
(``stream.<stage>_rows`` / ``stream.read_bytes`` counters), prefetch queue
depth (``stream.prefetch_depth`` gauge) and consumer starvation
(``stream.prefetch_wait_ms``).  With tracing enabled each block also
records a span, so an ingestion run exports as a flame graph of the
pipeline.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

from repro_torch.obs import get_registry, get_tracer
from repro_torch.stream.block import Block
from repro_torch.stream.datasource import Datasource
from repro_torch.stream.logical import Batch, Encode, LogicalOp, MapBlocks, Project, Read

_DONE = object()


def _block_nbytes(block: Block) -> int:
    """Buffer bytes across columns (object columns count pointer width —
    a cheap, consistent per-stage traffic proxy, not a deep string size)."""
    return sum(c.nbytes for c in block.columns.values())


class _Prefetcher:
    """Background-thread handoff with a bounded queue and clean shutdown.
    The pump thread starts lazily on first consumption, so an iterator that
    is created but never drained holds no thread and no open file."""

    def __init__(self, it: Iterator[Block], capacity: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(capacity, 1))
        self._stop = threading.Event()
        self._started = False
        self._thread = threading.Thread(target=self._pump, args=(it,), daemon=True)

    def _pump(self, it: Iterator[Block]) -> None:
        try:
            for item in it:
                if not self._put((False, item)):
                    return
            self._put((False, _DONE))
        except BaseException as exc:  # propagate to the consumer
            self._put((True, exc))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        reg = get_registry()
        try:
            if not self._started:
                self._started = True
                self._thread.start()
            while True:
                t0 = time.perf_counter_ns()
                is_err, item = self._q.get()
                # time blocked on the producer: >0 means the consumer
                # starves (I/O-bound), ~0 means the queue stays full
                # (compute-bound) — the tuning signal for `prefetch`
                reg.observe(
                    "stream.prefetch_wait_ms",
                    (time.perf_counter_ns() - t0) / 1e6,
                )
                reg.gauge("stream.prefetch_depth").set(self._q.qsize())
                if is_err:
                    raise item
                if item is _DONE:
                    return
                yield item
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()


def _read_blocks(source: Datasource) -> Iterator[Block]:
    reg = get_registry()
    tracer = get_tracer()
    for task in source.read_tasks():
        it = iter(task.read())
        while True:
            t0 = time.perf_counter_ns()
            try:
                block = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter_ns()
            reg.observe("stream.read_ms", (t1 - t0) / 1e6)
            reg.inc("stream.read_blocks")
            reg.inc("stream.read_rows", block.n_rows)
            reg.inc("stream.read_bytes", _block_nbytes(block))
            if tracer.enabled:
                tracer.add_complete(
                    "read_block", "stream", t0, t1, rows=block.n_rows
                )
            yield block


def _fused(
    fns: list[tuple[str, Callable[[Block], Block]]], it: Iterator[Block]
) -> Iterator[Block]:
    reg = get_registry()
    tracer = get_tracer()
    for block in it:
        for name, fn in fns:
            t0 = time.perf_counter_ns()
            block = fn(block)
            t1 = time.perf_counter_ns()
            reg.observe(f"stream.{name}_ms", (t1 - t0) / 1e6)
            reg.inc(f"stream.{name}_rows", block.n_rows)
            if tracer.enabled:
                tracer.add_complete(
                    name, "stream", t0, t1, rows=block.n_rows
                )
        yield block


def _rebatch(rows: int, it: Iterator[Block]) -> Iterator[Block]:
    reg = get_registry()

    def emit(blocks_or_block) -> Block:
        t0 = time.perf_counter_ns()
        out = (
            Block.concat(blocks_or_block)
            if isinstance(blocks_or_block, list)
            else blocks_or_block
        )
        reg.observe("stream.batch_ms", (time.perf_counter_ns() - t0) / 1e6)
        reg.inc("stream.batch_blocks")
        reg.inc("stream.batch_rows", out.n_rows)
        return out

    pending: list[Block] = []
    n = 0
    for block in it:
        if block.n_rows == 0:
            continue
        if not pending and block.n_rows == rows:  # fast path: already sized
            yield emit(block)
            continue
        pending.append(block)
        n += block.n_rows
        while n >= rows:
            take, filled, acc = [], 0, []
            for b in pending:
                need = rows - filled
                if need == 0:
                    acc.append(b)
                elif b.n_rows <= need:
                    take.append(b)
                    filled += b.n_rows
                else:
                    take.append(b.slice(0, need))
                    acc.append(b.slice(need, b.n_rows))
                    filled = rows
            yield emit(take if len(take) > 1 else take[0])
            pending = acc
            n -= rows
    if pending:
        yield emit(pending if len(pending) > 1 else pending[0])


def _op_fn(op: LogicalOp) -> tuple[str, Callable[[Block], Block]]:
    """(metric stage name, per-block fn) for a fusable logical op."""
    if isinstance(op, Project):
        cols, fill = op.columns, op.fill
        return "project", lambda b: b.select(cols, fill)
    if isinstance(op, MapBlocks):
        return "map", op.fn
    if isinstance(op, Encode):
        return "encode", op.apply
    raise TypeError(f"not a per-block op: {op!r}")


def pushdown_projection(plan: tuple[LogicalOp, ...]) -> tuple[LogicalOp, ...]:
    """Rewrite a leading ``Read -> Project(pushdown=True)`` pair so the
    datasource itself materializes only the projected columns.

    Strict projections (``fill=None``) are *replaced* by the reader when
    the source accepts strict pushdown — a missing mapped column then
    raises ``KeyError`` at read time, before a single row is built.
    Tolerant (union-fill) projections keep the ``Project`` node: the
    pruned reader emits whatever subset of the columns each shard/record
    has, and the Project still fills the gaps.  Sources without a
    ``with_columns`` hook (or that decline — e.g. strict pushdown into a
    per-record-schema JSON source) leave the plan untouched.
    """
    if (
        len(plan) < 2
        or not isinstance(plan[0], Read)
        or not isinstance(plan[1], Project)
        or not plan[1].pushdown
        or not plan[1].columns
    ):
        return plan
    prj = plan[1]
    hook = getattr(plan[0].source, "with_columns", None)
    if hook is None:
        return plan
    strict = prj.fill is None
    pushed = hook(prj.columns, strict)
    if pushed is None:
        return plan
    rest = plan[2:] if strict else plan[1:]
    return (Read(pushed),) + tuple(rest)


def execute(plan: tuple[LogicalOp, ...], prefetch: int = 2) -> Iterator[Block]:
    """Lower the logical plan and run it as a pipelined block iterator."""
    plan = pushdown_projection(plan)
    if not plan or not isinstance(plan[0], Read):
        raise ValueError("logical plan must start with a Read")
    it: Iterator[Block] = _read_blocks(plan[0].source)
    if prefetch > 0:  # overlap I/O + parsing with downstream compute
        it = iter(_Prefetcher(it, prefetch))
    fns: list[tuple[str, Callable[[Block], Block]]] = []
    for op in plan[1:]:
        if isinstance(op, Batch):
            if fns:
                it = _fused(fns, it)
                fns = []
            it = _rebatch(op.rows, it)
        else:
            fns.append(_op_fn(op))
    if fns:
        it = _fused(fns, it)
    return it
