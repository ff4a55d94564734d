"""Triple-pattern matching and BGP evaluation over a :class:`TripleStore`.

Single pattern
--------------
A pattern binds a subset of (s, p, o); each of the 8 bound-position masks is
a contiguous range of exactly one sort order (SPO / POS / OSP), found with a
*lexicographic binary search* over the three sorted int32 columns — tensor
ops on the store's device, vectorized over a whole batch of queries, so the serving path answers many
patterns per dispatch (`match_counts`).  Wildcard positions take ``-1`` for
the lower bound and ``INT32_MAX`` for the upper (term ids are dense and
strictly between the two).

BGP (conjunctive) queries
-------------------------
`solve` delegates to the ``repro_torch.serve`` planner/executor — the one query
path: the BGP becomes a :class:`~repro_torch.serve.algebra.SelectQuery`, the
cost-based planner orders scans by index-measured cardinality preferring
connected joins, and the batched executor runs the whole plan (range scans
feeding sorted-merge joins on padded binding tables) as one device
dispatch; bindings never materialize on host between joins.  Rows come
back deterministically ordered by term id — and term ids are ranks of
rendered terms, so the order is identical across eager / streamed /
``.kgz``-roundtripped stores.  Term ids decode to strings only at output
(`decode_bindings`).

Correctness is anchored by `oracle_solve`, a naive Python set-scan over the
same store, used by the tests as the reference semantics (the full-algebra
extension lives in ``repro_torch.serve.oracle``).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from repro_torch.core.hashset import next_pow2
from repro_torch.kg.store import ORDERS, TripleStore
from repro_torch.data.terms import canonical_term

I32_MAX = np.int32(np.iinfo(np.int32).max)

# bound-position mask (s, p, o) -> index order whose sort prefix covers it
_ORDER_FOR_MASK = {
    (False, False, False): "spo",
    (True, False, False): "spo",
    (True, True, False): "spo",
    (True, True, True): "spo",
    (False, True, False): "pos",
    (False, True, True): "pos",
    (False, False, True): "osp",
    (True, False, True): "osp",
}


# --------------------------------------------------------------------------
# pattern parsing
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    """One pattern; each slot is a variable name (``"?x"``) or a constant
    rendered-term string (``"<iri>"`` / ``'"literal"'``)."""

    s: str
    p: str
    o: str

    @property
    def slots(self) -> tuple[str, str, str]:
        return (self.s, self.p, self.o)

    @property
    def variables(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(t for t in self.slots if t.startswith("?")))


_PAT_TOKEN = re.compile(
    r'\s*(?P<var>\?[A-Za-z_]\w*)'
    r'|\s*(?P<iri><[^>]*>)'
    r'|\s*(?P<lit>"(?:[^"\\]|\\.)*")'
    r'|\s*(?P<dot>\.)'
)


def parse_bgp(text: str) -> list[TriplePattern]:
    """Parse ``'?s <p> ?o . ?o <q> "v"'`` into patterns (the ``.`` separator
    between patterns is optional; a trailing ``.`` is allowed)."""
    terms: list[str] = []
    patterns: list[TriplePattern] = []

    def flush():
        if not terms:
            return
        if len(terms) != 3:
            raise ValueError(
                f"triple pattern needs 3 terms, got {len(terms)}: {terms}"
            )
        s, p, o = terms
        patterns.append(
            TriplePattern(
                s if s.startswith("?") else canonical_term(s),
                p if p.startswith("?") else canonical_term(p),
                o if o.startswith("?") else canonical_term(o),
            )
        )
        terms.clear()

    pos = 0
    while pos < len(text):
        m = _PAT_TOKEN.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise ValueError(f"cannot parse pattern at: {text[pos:pos+40]!r}")
            break
        pos = m.end()
        if m.lastgroup == "dot":
            flush()
        else:
            terms.append(m.group().strip())
            if len(terms) == 3:
                flush()
    flush()
    if not patterns:
        raise ValueError("empty basic graph pattern")
    return patterns


# --------------------------------------------------------------------------
# batched lexicographic range scan
# --------------------------------------------------------------------------


def _lex_search(c0, c1, c2, q0, q1, q2, upper: bool):
    """Vectorized lexicographic binary search: for each query tuple, the
    count of sorted rows lex-< (lower bound) or lex-<= (upper bound) the
    tuple.  32 rounds cover any int32-indexable column."""
    n = c0.shape[0]
    lo = torch.zeros(q0.shape, dtype=torch.int32, device=q0.device)
    hi = torch.full(q0.shape, n, dtype=torch.int32, device=q0.device)
    for _ in range(32):
        # overflow-safe midpoint: lo + hi can exceed int32 at n > 2^30 rows
        mid = lo + ((hi - lo) >> 1)
        g = mid.clamp(0, max(n - 1, 0))
        m0, m1, m2 = c0[g], c1[g], c2[g]
        tail = (m2 <= q2) if upper else (m2 < q2)
        before = (m0 < q0) | ((m0 == q0) & ((m1 < q1) | ((m1 == q1) & tail)))
        open_ = lo < hi
        lo, hi = (
            torch.where(open_ & before, mid + 1, lo),
            torch.where(open_ & ~before, mid, hi),
        )
    return lo


def _lex_range(c0, c1, c2, lo0, lo1, lo2, hi0, hi1, hi2):
    """(start, end) row ranges for a batch of bound-prefix queries: a lower
    and an upper lexicographic search, the upper with INT32_MAX filling the
    wildcard slots (term ids are dense, strictly below it)."""
    return (
        _lex_search(c0, c1, c2, lo0, lo1, lo2, upper=False),
        _lex_search(c0, c1, c2, hi0, hi1, hi2, upper=True),
    )


def _query_bounds(ids_primary_order: np.ndarray):
    """int32[m, 3] columns in *index order* with -1 wildcards -> the six
    lower/upper query columns."""
    q = ids_primary_order
    wild = q < 0
    lo = np.where(wild, np.int32(-1), q).astype(np.int32)
    hi = np.where(wild, I32_MAX, q).astype(np.int32)
    return lo, hi


def match_ranges(
    store: TripleStore, patterns_spo: np.ndarray
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Batch of patterns as int32[m, 3] term ids in (s, p, o) order with -1
    for wildcards -> per-pattern (start, end) ranges plus the index order
    each range refers to.  Queries are grouped by *index order* — the
    wildcard bound encoding already distinguishes masks within an order, so
    a mixed batch takes at most 3 searches (a homogeneous serving batch is
    exactly one)."""
    q = np.asarray(patterns_spo, np.int32).reshape(-1, 3)
    m = len(q)
    starts = np.zeros(m, np.int64)
    ends = np.zeros(m, np.int64)
    bound = q >= 0
    orders = [_ORDER_FOR_MASK[tuple(bool(x) for x in row)] for row in bound]
    if len(store.s) == 0:
        # empty graph: every range is (0, 0) — the search cannot gather
        # from zero-length index columns
        return starts, ends, orders
    orders_arr = np.asarray(orders)
    for order in sorted(set(orders)):
        sel = np.nonzero(orders_arr == order)[0]
        a, b, c = (q[sel][:, i] for i in ORDERS[order])
        qcols = np.stack([a, b, c], axis=1)
        # pad each group to a power-of-two batch (O(log batch) distinct
        # shapes, as in the JAX package); pad rows are all-wildcard queries
        # whose results are sliced away
        k = len(sel)
        npad = next_pow2(max(k, 1))
        if npad > k:
            qcols = np.concatenate(
                [qcols, np.full((npad - k, 3), -1, np.int32)]
            )
        lo, hi = _query_bounds(qcols)
        c0, c1, c2 = store.device_cols(order)
        qlo = torch.from_numpy(np.ascontiguousarray(lo.T)).to(store.device)
        qhi = torch.from_numpy(np.ascontiguousarray(hi.T)).to(store.device)
        lo_i, hi_i = _lex_range(c0, c1, c2, *qlo, *qhi)
        starts[sel] = lo_i.cpu().numpy()[:k]
        ends[sel] = hi_i.cpu().numpy()[:k]
    return starts, ends, orders


def match_counts(store: TripleStore, patterns_spo: np.ndarray) -> np.ndarray:
    """Result cardinality per pattern — the batched serving/bench path."""
    starts, ends, _ = match_ranges(store, patterns_spo)
    return (ends - starts).astype(np.int64)


def match_pattern(store: TripleStore, spo_ids) -> np.ndarray:
    """One pattern (term ids, None = wildcard) -> matching row ids into
    ``store.s/p/o`` (host array, variable length)."""
    q = np.asarray(
        [[-1 if t is None else int(t) for t in spo_ids]], np.int32
    )
    starts, ends, orders = match_ranges(store, q)
    idx = store.indexes[orders[0]]
    return idx.perm[int(starts[0]) : int(ends[0])]


# --------------------------------------------------------------------------
# binding tables + BGP evaluation (delegated to the repro_torch.serve pipeline)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Bindings:
    """Encoded solution table: one int32 term-id column per variable.  A
    zero-variable table (all-constant pattern) is a pure existence filter
    and carries only its row count (0 or 1)."""

    cols: dict[str, np.ndarray]
    n: int

    @property
    def variables(self) -> tuple[str, ...]:
        return tuple(self.cols)


def solve(store: TripleStore, patterns: list[TriplePattern]) -> Bindings:
    """Conjunctive BGP evaluation — a shim over the unified query API:
    :class:`repro_torch.api.LocalSession` resolves the store (plain or
    live, overlay view captured per call) and runs the same
    planner/executor pipeline the query server dispatches through.
    Kept for callers that want *encoded* (term-id) binding tables; new
    code should use ``repro_torch.api.connect``.  (Lazy import: ``api`` layers
    on ``kg``, not the other way around.)"""
    from repro_torch.api import LocalSession
    from repro_torch.serve.algebra import SelectQuery

    res = LocalSession(store).execute(SelectQuery(patterns=tuple(patterns)))
    n = int(res.counts[0])
    cols = {
        v: np.asarray(res.cols[v][0, :n], np.int32) for v in res.vars
    }
    return Bindings(cols, n)


def solve_text(store: TripleStore, text: str) -> Bindings:
    return solve(store, parse_bgp(text))


def decode_bindings(
    store: TripleStore, b: Bindings, limit: int | None = None
) -> list[dict[str, str]]:
    """Term-id table -> rendered rows; the only string-producing step."""
    n = b.n if limit is None else min(b.n, limit)
    return [
        {v: store.decode_term(int(c[i])) for v, c in b.cols.items()}
        for i in range(n)
    ]


def binding_set(store: TripleStore, b: Bindings) -> set[tuple]:
    """Canonical comparable form: a set of ((var, rendered term), ...) rows
    sorted by variable name — what the tests compare against the oracle."""
    out = set()
    for i in range(b.n):
        out.add(
            tuple(
                (v, store.decode_term(int(b.cols[v][i])))
                for v in sorted(b.cols)
            )
        )
    return out


# --------------------------------------------------------------------------
# reference oracle — naive Python set scan (the tests' ground truth)
# --------------------------------------------------------------------------


def oracle_solve(store: TripleStore, patterns: list[TriplePattern]) -> set[tuple]:
    """Evaluate the BGP by brute force over the decoded triple list: match
    every pattern against every triple, then natural-join the per-pattern
    binding sets pairwise.  Quadratic and string-based on purpose — it
    shares no code with the indexed engine."""
    triples = [
        (
            store.decode_term(int(store.s[i])),
            store.decode_term(int(store.p[i])),
            store.decode_term(int(store.o[i])),
        )
        for i in range(store.n_triples)
    ]

    def match_one(pat: TriplePattern) -> list[dict[str, str]]:
        out = []
        for t in triples:
            env: dict[str, str] = {}
            for term, value in zip(pat.slots, t):
                if term.startswith("?"):
                    if env.get(term, value) != value:
                        env = None  # type: ignore[assignment]
                        break
                    env[term] = value
                elif term != value:
                    env = None  # type: ignore[assignment]
                    break
            if env is not None:
                out.append(env)
        return out

    solutions = [dict()]  # type: list[dict[str, str]]
    for pat in patterns:
        rows = match_one(pat)
        merged = []
        for env in solutions:
            for row in rows:
                if all(env.get(v, row[v]) == row[v] for v in row):
                    merged.append({**env, **row})
        solutions = merged
    return {
        tuple(sorted(env.items())) for env in solutions
    }
