"""Dispatch tracing: timed spans in a ring buffer, exported as Chrome
trace-event JSON (loadable in Perfetto / ``chrome://tracing``).

A :class:`Tracer` records *complete* events (``ph: "X"``): name, category,
start timestamp, duration, thread id, and free-form ``args``.  Events live
in a bounded ring buffer (old spans fall off; a long-lived server never
grows without bound) and are timestamped with ``perf_counter_ns`` relative
to the tracer's epoch, so nested spans from one thread render as a proper
flame graph.

Tracing is off by default and the disabled path is one attribute check —
instrumentation can stay inline on hot paths.  The global tracer is turned
on by the ``--trace out.json`` CLI flags (``rdfize`` / ``query`` /
``serve``); :func:`save_trace` writes the JSON at exit.

    with span("dispatch", cat="serve", plan="1f2e3d4c", batch=64):
        ...                       # timed; recorded only when enabled

    add_complete("queue_wait", "serve", t_enq_ns, t_start_ns, req=7)
        ...                       # retroactive span from raw timestamps
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

_DEFAULT_CAPACITY = 1 << 16


class Tracer:
    """Ring-buffered span recorder; one per process is the normal mode."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._t0_ns = time.perf_counter_ns()
        self.dropped = 0  # events pushed past a full ring

    # -- lifecycle -----------------------------------------------------------

    def enable(self, capacity: int | None = None) -> None:
        with self._lock:
            if capacity is not None:
                self._events = collections.deque(
                    self._events, maxlen=capacity
                )
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._t0_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------

    def add_complete(
        self, name: str, cat: str, t0_ns: int, t1_ns: int, **args
    ) -> None:
        """Record a span from raw ``perf_counter_ns`` endpoints — the form
        used for retroactive spans (queue wait is only known once the
        dispatcher picks the request up)."""
        if not self.enabled:
            return
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat or "default",
            "ts": (t0_ns - self._t0_ns) / 1e3,  # trace-event ts is µs
            "dur": max(t1_ns - t0_ns, 0) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Time a block; records on exit (exceptions included — the span
        still lands, so a failing dispatch is visible in the trace)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add_complete(name, cat, t0, time.perf_counter_ns(), **args)

    # -- export --------------------------------------------------------------

    def export(self) -> dict:
        """The Chrome trace-event JSON object (``traceEvents`` array form,
        which both Perfetto and ``chrome://tracing`` load directly)."""
        with self._lock:
            events = list(self._events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path: str) -> int:
        """Write the trace JSON; returns the number of events written."""
        doc = self.export()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER.enabled


def enable_tracing(capacity: int | None = None) -> None:
    _TRACER.enable(capacity)


def span(name: str, cat: str = "", **args):
    return _TRACER.span(name, cat, **args)


def add_complete(name: str, cat: str, t0_ns: int, t1_ns: int, **args) -> None:
    _TRACER.add_complete(name, cat, t0_ns, t1_ns, **args)


def save_trace(path: str) -> int:
    return _TRACER.save(path)
