"""Process metrics: counters, gauges, and log-bucketed latency histograms.

The substrate the ingest / executor / server layers report into — zero
dependencies, one lock, JSON-serializable end to end.

* :class:`Counter` / :class:`Gauge` — monotone totals and last-value
  samples (floats allowed: ``serve.exec_s`` accumulates seconds).
* :class:`Histogram` — fixed log2 major buckets, each split into
  ``SUBBUCKETS`` linear sub-buckets (HdrHistogram-style), so any recorded
  value lands in a bucket whose upper/lower edge ratio is at most
  ``1 + 1/SUBBUCKETS`` (6.25%).  Quantiles are nearest-rank over the
  bucket cumulative counts and return the bucket's upper edge — within
  one bucket's relative error of the exact sample quantile, at any
  magnitude (1µs and 10s latencies share one histogram).  Histograms
  merge associatively (bucket-count addition), which is what makes
  per-shard / per-signature metrics aggregatable.
* :class:`MetricsRegistry` — a named collection of the above behind a
  single lock, so updates from the server's accept/client/dispatch
  threads are atomic (the old hand-rolled ``ServerStats`` counters were
  racy).  ``snapshot()`` returns a plain-dict view that serves as the
  ``metrics`` wire op's payload and the benchmark's metrics artifact.

A process-global registry (:func:`get_registry`) is the default sink for
library instrumentation; tests and embedded servers can pass their own.
"""

from __future__ import annotations

import math
import threading

SUBBUCKETS = 16  # linear sub-buckets per power of two: <= 6.25% bucket width


def bucket_index(value: float) -> int:
    """The histogram bucket of a positive value.

    ``value = m * 2**e`` with ``m in [0.5, 1)`` (``math.frexp``); the
    mantissa picks one of ``SUBBUCKETS`` linear slices of the octave, so
    the flat index is ``e * SUBBUCKETS + slice``.
    """
    m, e = math.frexp(value)
    sub = int((m - 0.5) * 2 * SUBBUCKETS)
    if sub >= SUBBUCKETS:  # m == 1.0 - eps rounding
        sub = SUBBUCKETS - 1
    return e * SUBBUCKETS + sub


def bucket_bounds(idx: int) -> tuple[float, float]:
    """The value interval ``(lower, upper]`` of bucket ``idx``."""
    e, sub = divmod(idx, SUBBUCKETS)
    lo = math.ldexp(0.5 + sub / (2 * SUBBUCKETS), e)
    hi = math.ldexp(0.5 + (sub + 1) / (2 * SUBBUCKETS), e)
    return lo, hi


class Counter:
    """A monotone total (int or float increments)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0
        self._lock = lock

    def add(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """A last-value (or running-max) sample."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def set_max(self, v) -> None:
        with self._lock:
            if v > self.value:
                self.value = v


class Histogram:
    """Log-bucketed distribution; see the module docstring for the bucket
    layout.  Standalone histograms (no lock) are plain accumulators; the
    registry wires its lock in for thread-safe observation."""

    __slots__ = ("buckets", "count", "sum", "max", "zero", "_lock")

    def __init__(self, lock: threading.Lock | None = None):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self.zero = 0  # non-positive observations (a zero-length wait)
        self._lock = lock

    def observe(self, value: float) -> None:
        if self._lock is None:
            return self._observe(value)
        with self._lock:
            self._observe(value)

    def _observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero += 1
            return
        idx = bucket_index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate: the upper edge of the bucket
        holding the ``ceil(q/100 * count)``-th smallest observation (so
        exact_value <= estimate < exact_value * bucket_width).  ``None``
        on an empty histogram."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = self.zero
        if rank <= seen:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank <= seen:
                return bucket_bounds(idx)[1]
        return self.max  # rank beyond the last bucket: fp edge, cap at max

    def merge(self, other: "Histogram") -> "Histogram":
        """Pointwise bucket addition into ``self`` (associative and
        commutative up to float addition order in ``sum``/``max``)."""
        self.count += other.count
        self.sum += other.sum
        self.max = max(self.max, other.max)
        self.zero += other.zero
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        return self

    @staticmethod
    def merged(*hists: "Histogram") -> "Histogram":
        out = Histogram()
        for h in hists:
            out.merge(h)
        return out

    def to_dict(self) -> dict:
        d = {
            "count": self.count,
            "sum": self.sum,
            "max": self.max,
            "zero": self.zero,
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
        }
        for q in (50, 90, 99):
            d[f"p{q}"] = self.percentile(q)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Histogram":
        h = Histogram()
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.max = float(d["max"])
        h.zero = int(d.get("zero", 0))
        h.buckets = {int(i): int(n) for i, n in d["buckets"].items()}
        return h


class MetricsRegistry:
    """Named counters / gauges / histograms behind one lock.

    Names are dotted paths (``serve.queue_wait_ms``); per-key variants
    append ``.key=value`` (``serve.request_ms.sig=1f2e3d4c``).  Metrics
    are created on first touch, so instrumentation never needs
    registration order.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # -- access (create on first touch) --------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(self._lock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(self._lock))
        return h

    # -- shorthands ----------------------------------------------------------

    def inc(self, name: str, n=1) -> None:
        self.counter(name).add(n)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """A JSON-ready view of every metric (the ``metrics`` wire op
        payload and the benchmark metrics artifact)."""
        with self._lock:
            return {
                "counters": {
                    k: c.value for k, c in sorted(self._counters.items())
                },
                "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
                "histograms": {
                    k: h.to_dict() for k, h in sorted(self._hists.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry — the default sink for library
    instrumentation (stream readers, the fused executor, CLIs)."""
    return _REGISTRY
