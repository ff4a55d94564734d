"""Batched plan executor — a whole query batch in one dispatch.

The full operator tree — range scans, bind joins, sorted-merge joins,
OPTIONAL backfill, UNION concat, filters, group/count,
distinct/sort/order/limit — lowers to one sequence of tensor operations
on the store's device, written over a leading batch axis ``B`` (the JAX
package ``vmap``s a single-query pipeline; here every operator takes the
batch axis explicitly, so batch 4096 is one dispatch, not 4096).  Binding
tables stay on the device as power-of-two padded int32 columns ``[B,
cap]`` with a packed-valid-prefix row count ``[B]``; ``-1`` is the unbound
sentinel a ``LeftJoin`` (or a partial ``UNION`` arm) backfills for
maybe-unbound variables.

Every operator has a *capacity* (scan rows, join fan-out ``M``, join output
rows, union/backfill concat rows).  Capacities start from the planner's
estimates and are corrected by a feedback loop: the pipeline returns,
alongside the results, the *exact* size each point needed (one ``[n]``
vector, one device→host copy); if anything was truncated the executor
re-runs with capacities bumped to ``next_pow2(needed)`` (growth is
monotone, so the loop terminates; capacities are remembered per query
signature, so a serving workload converges to exactly one dispatch per
batch).  The names, floors and ``exec.*`` counters are the JAX package's,
and the small-batch fast path (``serve/fastpath.py``, kernel K4) shares
them.

The plan is a DAG, not a tree — UNION arms share the required subtree and
an OPTIONAL bind-join chain shares its tagged left side — so node
evaluation is memoized per dispatch.  GROUP BY counts with a device
segment-sum over the key-sorted table; ORDER BY sorts by the store's
value-typed ``order_rank`` side table (count columns by their integer
value) with a term-id tie-break.  A lexicographic sort is successive
stable argsorts, least significant key first (``lax.sort(num_keys=k,
is_stable=True)`` in the JAX package).

A live store's overlay view (``repro_torch.live.delta.OverlayView``) adds a
second scan arm: every reader range-scans the base index and the re-sorted
delta index with the same bounds, counts live base rows through the view's
per-order alive prefix sums (tombstones masked), rank-selects the j-th live
base row by a search over those sums, and emits base matches then delta
matches — all batched over ``B`` like the rest of the pipeline.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from repro_torch.core.hashset import next_pow2
from repro_torch.kernels.scan_join import lex_search2, lexsort_rows, pack_bound
from repro_torch.kg.query import _lex_search
from repro_torch.kg.store import ORDERS, TripleStore
from repro_torch.obs import get_registry, get_tracer
from repro_torch.serve import algebra as A
from repro_torch.serve import fastpath as FP
from repro_torch.serve import plan as P
from repro_torch.serve.values import value_table

I32_MAX = 2**31 - 1
UNBOUND = -1
_MAX_GROW_ROUNDS = 12
_FP_UNSET = object()  # fast-path cache sentinel (None = ineligible plan)


def plan_label(sig: tuple) -> str:
    """A short, process-stable label for a plan signature — what dispatch
    spans and per-signature latency histograms are tagged with (the raw
    signature tuple is too bulky for a metric name)."""
    return f"{zlib.crc32(repr(sig).encode('utf-8')) & 0xFFFFFFFF:08x}"


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchResult:
    """Padded, deterministically ordered solution tables for a whole batch."""

    store: TripleStore
    vars: tuple[str, ...]
    cols: dict[str, np.ndarray]   # int32[B, C] each (C >= max count)
    counts: np.ndarray            # int64[B]
    # aggregate output columns (COUNT aliases): their cells are plain
    # integers, not term ids — ``rows`` returns them as ints
    agg_vars: tuple[str, ...] = ()

    def n(self, i: int) -> int:
        return int(self.counts[i])

    def ids(self, i: int) -> list[tuple[int, ...]]:
        """Query ``i``'s rows as raw int tuples (term ids, -1 = unbound;
        counts stay counts)."""
        k = self.n(i)
        return [
            tuple(int(self.cols[v][i, r]) for v in self.vars) for r in range(k)
        ]

    def rows(self, i: int, limit: int | None = None) -> list[tuple]:
        """Query ``i``'s rows decoded to rendered terms (None = unbound);
        aggregate columns come back as plain ints."""
        k = self.n(i)
        if limit is not None:
            k = min(k, limit)
        out = []
        for r in range(k):
            row = []
            for v in self.vars:
                x = int(self.cols[v][i, r])
                if v in self.agg_vars:
                    row.append(x)
                elif x < 0:
                    row.append(None)
                else:
                    row.append(self.store.decode_term(x))
            out.append(tuple(row))
        return out


# ---------------------------------------------------------------------------
# batched operators (a leading batch axis on every table and count)
# ---------------------------------------------------------------------------


def _range_search(
    keys, c0, c1, c2, lo_q, hi_q, bits: int, rounds: int,
    primary_q=None, prim_start=None, prim_rounds: int | None = None,
):
    """(start, end) of the rows inside [lo_q, hi_q] — a 2-column split-key
    binary search when the store's ids fit the packed fields, else the
    general 3-column lexicographic search.  With a bound primary term
    (``primary_q``), the bisection is *seeded* to that term's row range
    (``prim_start``) and runs only ``prim_rounds`` rounds — for a bound
    subject that is the subject's degree, not the store size."""
    if keys is not None:
        khi, klo = keys
        qhi_l, qlo_l = pack_bound(*lo_q, bits)
        qhi_h, qlo_h = pack_bound(*hi_q, bits)
        if primary_q is not None:
            T = prim_start.shape[0] - 1
            g0 = primary_q.clamp(0, max(T - 1, 0))
            lo0 = prim_start[g0]
            hi0 = prim_start[g0 + 1]
            lo = lex_search2(khi, klo, qhi_l, qlo_l, False, prim_rounds, lo0, hi0)
            hi = lex_search2(khi, klo, qhi_h, qlo_h, True, prim_rounds, lo0, hi0)
            # a negative primary (unknown constant / padded row) is empty
            ok = primary_q >= 0
            zero = torch.zeros_like(lo)
            return torch.where(ok, lo, zero), torch.where(ok, hi, zero)
        lo = lex_search2(khi, klo, qhi_l, qlo_l, upper=False, rounds=rounds)
        hi = lex_search2(khi, klo, qhi_h, qlo_h, upper=True, rounds=rounds)
        return lo, hi
    lo = _lex_search(c0, c1, c2, lo_q[0], lo_q[1], lo_q[2], upper=False)
    hi = _lex_search(c0, c1, c2, hi_q[0], hi_q[1], hi_q[2], upper=True)
    return lo, hi


def _gather(col, idx):
    """``col[b, idx[b, ...]]`` for a ``[B, C]`` table."""
    return col.gather(1, idx.reshape(idx.shape[0], -1).long()).view(idx.shape)


def _scatter(out, idx, vals):
    """``out.at[idx].set(vals, mode="drop")`` per batch row: ``idx`` ==
    ``out.shape[1]`` (or beyond) drops the value."""
    B, cap = out.shape
    buf = torch.cat([out, out.new_empty(B, 1)], dim=1)
    buf.scatter_(1, idx.clamp(max=cap).long(), vals.to(out.dtype))
    return buf[:, :cap]


def _width(cols: dict) -> int:
    return next(iter(cols.values())).shape[1] if cols else 1


def _compact(cols: dict, mask, cap: int):
    """Scatter masked rows to a packed prefix of a ``cap``-row table.
    Returns (cols, valid_count, total_wanted) — ``total_wanted`` feeds the
    capacity feedback when it exceeds ``cap``."""
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, dim=1, dtype=torch.int32) - 1
    keep = mask & (pos < cap)
    idx = torch.where(keep, pos, cap)  # cap is out-of-range: dropped
    B = mask.shape[0]
    out = {
        v: _scatter(torch.full((B, cap), UNBOUND, dtype=torch.int32,
                               device=mask.device), idx, c)
        for v, c in cols.items()
    }
    total = m.sum(dim=1, dtype=torch.int32)
    return out, total.clamp(max=cap), total


def _sort_perm(cols: dict, order: tuple[str, ...], n, cap: int):
    """Permutation sorting the valid prefix lexicographically by ``order``
    columns (invalid rows, keyed all-I32_MAX, sort last; real ids are far
    below it), stably.  Term ids are dense ranks of rendered terms, so this
    order is identical across stores of the same graph."""
    valid = _arange(cap, n.device)[None, :] < n[:, None]
    keys = [torch.where(valid, cols[v], I32_MAX) for v in order]
    return lexsort_rows(keys), valid


def _arange(k: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=device)


def _rank_select(alive, start_rank, k, store_n: int):
    """Sorted positions of live base rows: the smallest ``r`` with
    ``alive[r + 1]`` past rank ``start_rank + k`` (``start_rank`` is
    ``alive[lo]`` of the row's range, ``k`` the match index within it)."""
    target = (start_rank + k + 1).contiguous()
    r = torch.searchsorted(alive, target, out_int32=True) - 1
    return r.clamp(0, store_n - 1)


def _same_prev(c):
    """Row r equals row r - 1 (False for the first row)."""
    return torch.cat([torch.zeros_like(c[:, :1], dtype=torch.bool),
                      c[:, 1:] == c[:, :-1]], dim=1)


class _Lowerer:
    """Runs one (plan, caps) pipeline over a batch."""

    def __init__(
        self,
        plan: P.Plan,
        caps: dict[str, int],
        store_n: int,
        key_bits: int,
        packed: bool,
        prim_rounds: dict[int, int] | None = None,
        order_is_tid: bool = False,
        overlay: bool = False,
        delta_cap: int = 1,
        delta_rounds: int = 1,
    ):
        self.plan = plan
        self.caps = caps
        self.store_n = store_n
        self.key_bits = key_bits
        self.packed = packed
        self.order_is_tid = order_is_tid
        self.rounds = max(1, int(store_n).bit_length())
        self.prim_rounds = prim_rounds or {}
        # live-overlay second scan arm (see repro_torch.live.delta.OverlayView):
        # every reader range-scans the base index AND the re-sorted delta
        # index, rank-selects non-tombstoned base rows through per-order
        # alive prefix sums, and emits base matches then delta matches
        self.overlay = overlay
        self.delta_cap = delta_cap
        self.delta_rounds = delta_rounds
        self.scan_index = {s.node_id: i for i, s in enumerate(plan.scans)}
        self.needed: dict[str, torch.Tensor] = {}
        # the column sequence each node's rows are known to be sorted by
        # (empty when unknown) — lets the tail skip redundant sorts
        self._sorted: dict[int, tuple[str, ...]] = {}
        # per-dispatch node memo: the plan is a DAG (shared union/optional
        # subtrees) and every shared node must be computed exactly once
        self._memo: dict[int, tuple] = {}
        # bound per dispatch
        self.scan_cols: dict[int, tuple] = {}
        self.scan_keys: dict[int, tuple | None] = {}
        self.scan_prim: dict[int, torch.Tensor | None] = {}
        self.dscan_cols: dict[int, tuple] = {}
        self.dscan_keys: dict[int, tuple | None] = {}
        self.alive: dict[int, torch.Tensor] = {}
        self.dn = 0
        self.vt_arrays: tuple | None = None
        self.consts = None
        self.fops = None
        self.qvalid = None
        self.qlimit = None
        self.dev = None

    def _search_args(self, node):
        """Per-reader seeding operands (packed path only)."""
        if not self.packed:
            return {}
        return {
            "prim_start": self.scan_prim[node.node_id],
            "prim_rounds": self.prim_rounds[node.node_id],
        }

    def _delta_arm(self, node, lo, hi, lo_q, hi_q):
        """The overlay's merged run per query (or per left row): live base
        rows in ``[lo, hi)`` counted through the alive prefix sums, and the
        delta index's rows inside the same bounds.  Returns ``(alive,
        alive[lo], nb, dlo, nd)``."""
        A = self.alive[node.node_id]
        top = A.shape[0] - 1  # an empty base's single dummy row: A = [0]
        a_lo = A[lo.clamp(max=top)]
        nb = A[hi.clamp(max=top)] - a_lo
        dc0, dc1, dc2 = self.dscan_cols[node.node_id]
        dlo, dhi = _range_search(
            self.dscan_keys[node.node_id], dc0, dc1, dc2,
            lo_q, hi_q, self.key_bits, self.delta_rounds,
        )
        # clamp to the live delta rows: the wildcard upper bound packs level
        # with the pad rows' sentinel id, so pads fall in range
        dlo = dlo.clamp(max=self.dn)
        nd = dhi.clamp(max=self.dn) - dlo
        return A, a_lo, nb, dlo, nd

    def _ar(self, k: int) -> torch.Tensor:
        return _arange(k, self.dev)

    def _full(self, cap: int, value: int = UNBOUND) -> torch.Tensor:
        return torch.full((self.qvalid.shape[0], cap), value, dtype=torch.int32,
                          device=self.dev)

    # -- scans ---------------------------------------------------------------

    def _scan(self, node: P.Scan):
        cap = self.caps.get(f"scan{node.node_id}", 1)
        c0, c1, c2 = self.scan_cols[node.node_id]
        q = self.consts[:, self.scan_index[node.node_id]]
        B = q.shape[0]
        perm3 = ORDERS[node.order]
        lo_q, hi_q = [], []
        for j in range(3):
            pos = perm3[j]
            if pos in node.const_slots:
                lo_q.append(q[:, pos])
                hi_q.append(q[:, pos])
            else:
                lo_q.append(torch.full((B,), -1, dtype=torch.int32, device=self.dev))
                hi_q.append(torch.full((B,), I32_MAX, dtype=torch.int32,
                                       device=self.dev))
        primary_q = q[:, perm3[0]] if perm3[0] in node.const_slots else None
        lo, hi = _range_search(
            self.scan_keys[node.node_id], c0, c1, c2,
            lo_q, hi_q, self.key_bits, self.rounds,
            primary_q=primary_q if self.packed else None,
            **self._search_args(node),
        )
        by_pos = {perm3[j]: (c0, c1, c2)[j] for j in range(3)}
        if self.overlay:
            # base rows are counted through the alive prefix sums (masking
            # tombstones), the delta index is range-scanned with the same
            # bounds, and output rows are base matches then delta matches
            A, a_lo, nb, dlo, nd = self._delta_arm(node, lo, hi, lo_q, hi_q)
            count = torch.where(self.qvalid, nb + nd, 0)
        else:
            count = torch.where(self.qvalid, hi - lo, 0)
        if not node.out_vars:  # all-constant pattern: pure existence filter
            return {}, count.clamp(max=1)
        self.needed[f"scan{node.node_id}"] = count
        # rows come out in index order: sorted by the variable positions in
        # the order's (primary, secondary, tertiary) sequence — except under
        # an overlay, where delta matches append after the base run (the
        # tail determinism sort restores output order)
        var_by_pos = dict(node.var_slots)
        self._sorted[node.node_id] = () if self.overlay else tuple(
            var_by_pos[pos] for pos in perm3 if pos in var_by_pos
        )
        ar = self._ar(cap)[None, :]
        valid = ar < count[:, None]
        if self.overlay:
            in_base = ar < nb[:, None]
            rb = _rank_select(A, a_lo[:, None], ar, self.store_n)
            rd = (dlo[:, None] + (ar - nb[:, None])).clamp(0, self.delta_cap - 1)
            dby_pos = {perm3[k]: self.dscan_cols[node.node_id][k] for k in range(3)}

            def gather(pos):
                return torch.where(in_base, by_pos[pos][rb], dby_pos[pos][rd])
        else:
            r = (lo[:, None] + ar).clamp(0, self.store_n - 1)

            def gather(pos):
                return by_pos[pos][r]

        cols = {v: gather(pos) for pos, v in node.var_slots}
        if node.eq_pairs:
            pat_vals = {pos: gather(pos) for pos in range(3)}
            for pa, pb in node.eq_pairs:
                valid = valid & (pat_vals[pa] == pat_vals[pb])
            return _compact(cols, valid, cap)[:2]
        cols = {v: torch.where(valid, c, UNBOUND) for v, c in cols.items()}
        return cols, count.clamp(max=cap)

    # -- joins ---------------------------------------------------------------

    def _bind_join(self, node: P.BindJoin):
        """Index nested-loop join: each left row's bound variables extend
        the bound prefix of the pattern's range scan — the pattern is
        never materialized independently."""
        lcols, ln = self._eval(node.left)
        cl = _width(lcols)
        c0, c1, c2 = self.scan_cols[node.node_id]
        q = self.consts[:, self.scan_index[node.node_id]]
        B = q.shape[0]
        perm3 = ORDERS[node.order]
        bound_by_pos = {pos: lcols[v] for pos, v in node.bound_slots}
        lvalid = self._ar(cl)[None, :] < ln[:, None]
        lo_q, hi_q = [], []
        for j in range(3):
            pos = perm3[j]
            if pos in node.const_slots:
                lo_q.append(q[:, pos, None].expand(B, cl))
                hi_q.append(q[:, pos, None].expand(B, cl))
            elif pos in bound_by_pos:
                # left-bound variable: an exact key for this row's lookup
                lo_q.append(bound_by_pos[pos])
                hi_q.append(bound_by_pos[pos])
            else:
                lo_q.append(self._full(cl, -1))
                hi_q.append(self._full(cl, I32_MAX))
        ppos = perm3[0]
        if ppos in node.const_slots:
            primary_q = q[:, ppos, None].expand(B, cl)
        else:  # bind-join orders put a bound slot first by construction
            primary_q = bound_by_pos[ppos]
        lo, hi = _range_search(
            self.scan_keys[node.node_id], c0, c1, c2,
            lo_q, hi_q, self.key_bits, self.rounds,
            primary_q=primary_q if self.packed else None,
            **self._search_args(node),
        )
        if self.overlay:
            # merged per-row match count: live base rows (alive-prefix
            # masked) plus delta rows in the same bounds — the second
            # range-scan arm, per left row
            A, a_lo, nb, dlo, nd = self._delta_arm(node, lo, hi, lo_q, hi_q)
            cnt = torch.where(lvalid, nb + nd, 0)
        else:
            A = a_lo = nb = dlo = None
            cnt = torch.where(lvalid, hi - lo, 0)

        left_sorted = self._sorted.get(node.left.node_id, ())
        # expansion preserves left row order and emits each row's matches
        # in index order, so sortedness extends iff the left rows were
        # totally ordered (sorted by every left column) — and the index
        # order claim fails under an overlay (delta matches append after
        # the base run per left row)
        if set(left_sorted) >= set(node.left.out_vars):
            free_by_pos = dict(node.free_slots)
            self._sorted[node.node_id] = () if self.overlay else (
                left_sorted + tuple(
                    free_by_pos[pos] for pos in perm3 if pos in free_by_pos
                )
            )
        if node.kind == "left" and node.free_slots:
            # backfill rows append after the matches: order lost
            self._sorted[node.node_id] = ()

        if not node.free_slots:  # pure (anti-)semijoin: no new bindings
            self._sorted[node.node_id] = left_sorted
            if node.kind == "left":
                return lcols, ln
            return _compact(lcols, lvalid & (cnt > 0), cl)[:2]

        by_pos = {perm3[j]: (c0, c1, c2)[j] for j in range(3)}
        dby_pos = (
            {perm3[j]: self.dscan_cols[node.node_id][j] for j in range(3)}
            if self.overlay else None
        )
        cap = self.caps[f"bindC{node.node_id}"]
        if node.eq_pairs:
            return self._bind_join_grid(
                node, lcols, lvalid, lo, cnt, by_pos, cap,
                A=A, a_lo=a_lo, nb=nb, dlo=dlo, dby_pos=dby_pos,
            )
        # packed expansion: out row j belongs to the left row whose count
        # prefix-sum passes j (a log-width searchsorted), so matches land
        # directly packed — no (rows x fan-out) grid, no fan-out capacity,
        # no compaction pass
        cum = torch.cumsum(cnt, dim=1, dtype=torch.int32)
        total = cum[:, cl - 1]
        j = self._ar(cap).expand(B, cap).contiguous()
        rowidx = torch.searchsorted(cum, j, right=True, out_int32=True)
        rowc = rowidx.clamp(0, cl - 1)
        prev = torch.where(rowc > 0, _gather(cum, (rowc - 1).clamp(min=0)), 0)
        k = j - prev  # match index within this left row's merged run
        if self.overlay:
            nb_r = _gather(nb, rowc)
            in_base = k < nb_r
            rb = _rank_select(A, _gather(a_lo, rowc), k, self.store_n)
            rd = (_gather(dlo, rowc) + (k - nb_r)).clamp(0, self.delta_cap - 1)
        else:
            r = (_gather(lo, rowc) + k).clamp(0, self.store_n - 1)
        valid_out = j < total.clamp(max=cap)[:, None]
        out_vals = {}
        for v in node.out_vars:
            if v in lcols:
                vals = _gather(lcols[v], rowc)
            else:
                pos = next(p for p, fv in node.free_slots if fv == v)
                if self.overlay:
                    vals = torch.where(in_base, by_pos[pos][rb], dby_pos[pos][rd])
                else:
                    vals = by_pos[pos][r]
            out_vals[v] = torch.where(valid_out, vals, UNBOUND)
        if node.kind == "left":
            # backfill: left rows with no match append after the matches,
            # their free variables staying at the unbound sentinel
            un = lvalid & (cnt == 0)
            upos_raw = total[:, None] + torch.cumsum(
                un.to(torch.int32), dim=1, dtype=torch.int32) - 1
            upos = torch.where(un & (upos_raw < cap), upos_raw, cap)
            for v in node.out_vars:
                if v in lcols:
                    out_vals[v] = _scatter(out_vals[v], upos, lcols[v])
            total = total + un.sum(dim=1, dtype=torch.int32)
        self.needed[f"bindC{node.node_id}"] = total
        return out_vals, total.clamp(max=cap)

    def _bind_join_grid(self, node, lcols, lvalid, lo, cnt, by_pos, cap,
                        A=None, a_lo=None, nb=None, dlo=None, dby_pos=None):
        """Grid expansion fallback for patterns with repeated free
        variables: pair validity depends on the gathered values, so the
        (rows x fan-out) grid plus a compaction pass is unavoidable.
        Under an overlay the grid covers each row's merged run — the
        first ``nb`` slots rank-select live base rows, the rest gather
        from the delta index."""
        B, cl = lvalid.shape
        m = self.caps[f"bindM{node.node_id}"]
        self.needed[f"bindM{node.node_id}"] = cnt.amax(dim=1).clamp(min=0)
        offs = self._ar(m)
        if self.overlay:
            in_base = offs[None, None, :] < nb[:, :, None]
            rb = _rank_select(A, a_lo[:, :, None], offs[None, None, :], self.store_n)
            rd = (dlo[:, :, None] + (offs[None, None, :] - nb[:, :, None])).clamp(
                0, self.delta_cap - 1)

            def grid(pos):
                return torch.where(in_base, by_pos[pos][rb], dby_pos[pos][rd])
        else:
            ridx = (lo[:, :, None] + offs[None, None, :]).clamp(0, self.store_n - 1)

            def grid(pos):
                return by_pos[pos][ridx]

        within = offs[None, None, :] < cnt[:, :, None]
        pairmask = within & lvalid[:, :, None]
        for pa, pb in node.eq_pairs:
            pairmask = pairmask & (grid(pa) == grid(pb))
        out_vals = {}
        for v in node.out_vars:
            if v in lcols:
                mat = lcols[v][:, :, None].expand(B, cl, m)
            else:
                pos = next(p for p, fv in node.free_slots if fv == v)
                mat = grid(pos)
            out_vals[v] = mat.reshape(B, -1)
        flat_mask = pairmask.reshape(B, -1)
        if node.kind == "left":
            matched = pairmask.sum(dim=2, dtype=torch.int32)
            unmatched = lvalid & (matched == 0)
            for v in node.out_vars:
                tail = lcols[v] if v in lcols else self._full(cl)
                out_vals[v] = torch.cat([out_vals[v], tail], dim=1)
            flat_mask = torch.cat([flat_mask, unmatched], dim=1)
        cols, n, total = _compact(out_vals, flat_mask, cap)
        self.needed[f"bindC{node.node_id}"] = total
        return cols, n

    def _join(self, node: P.Join):
        lcols, ln = self._eval(node.left)
        rcols, rn = self._eval(node.right)
        # zero-variable sides are existence filters: scale the other side
        if not node.left.out_vars and node.kind == "inner":
            return rcols, torch.where(ln > 0, rn, 0)
        if not node.right.out_vars:
            if node.kind == "inner":
                return lcols, torch.where(rn > 0, ln, 0)
            return lcols, ln  # OPTIONAL {} with no vars binds nothing
        if node.build_right:
            build_cols, bn, probe_cols, pn = rcols, rn, lcols, ln
        else:
            build_cols, bn, probe_cols, pn = lcols, ln, rcols, rn
        B = ln.shape[0]
        cb = _width(build_cols)
        cp = _width(probe_cols)
        cap = self.caps[f"joinC{node.node_id}"]
        pvalid = self._ar(cp)[None, :] < pn[:, None]

        if node.shared:
            m = self.caps[f"joinM{node.node_id}"]
            key = node.shared[0]
            bk = torch.where(self._ar(cb)[None, :] < bn[:, None],
                             build_cols[key], I32_MAX)
            order = torch.argsort(bk, dim=1, stable=True)
            skeys = bk.gather(1, order).contiguous()
            pk = torch.where(pvalid, probe_cols[key], -3).contiguous()
            start = torch.searchsorted(skeys, pk, out_int32=True)
            end = torch.searchsorted(skeys, pk, right=True, out_int32=True)
            cnt = end - start
            self.needed[f"joinM{node.node_id}"] = torch.where(
                pvalid, cnt, 0).amax(dim=1).clamp(min=0)
        else:  # cross join: every valid probe row spans the whole build side
            m = cb
            order = self._ar(cb).expand(B, cb)
            start = torch.zeros((B, cp), dtype=torch.int32, device=self.dev)
            cnt = torch.where(pvalid, bn[:, None], 0)

        offs = self._ar(m)
        bidx = start[:, :, None] + offs[None, None, :]
        within = offs[None, None, :] < cnt[:, :, None]
        brow = _gather(order, bidx.clamp(0, cb - 1))
        pairmask = within & pvalid[:, :, None]
        for v in node.shared[1:]:
            pairmask = pairmask & (
                _gather(build_cols[v], brow) == probe_cols[v][:, :, None]
            )

        out_vals: dict[str, torch.Tensor] = {}
        for v in node.out_vars:
            if probe_cols and v in probe_cols:
                mat = probe_cols[v][:, :, None].expand(B, cp, m)
            else:
                mat = _gather(build_cols[v], brow)
            out_vals[v] = mat.reshape(B, -1)
        flat_mask = pairmask.reshape(B, -1)

        if node.kind == "left":
            # unmatched-row backfill: preserved left rows with the optional
            # side's variables left at the unbound sentinel
            matched = pairmask.sum(dim=2, dtype=torch.int32)
            unmatched = pvalid & (matched == 0)
            cat_vals = {}
            for v in node.out_vars:
                if probe_cols and v in probe_cols:
                    tail = probe_cols[v]
                else:
                    tail = self._full(cp)
                cat_vals[v] = torch.cat([out_vals[v], tail], dim=1)
            flat_mask = torch.cat([flat_mask, unmatched], dim=1)
            out_vals = cat_vals

        cols, n, total = _compact(out_vals, flat_mask, cap)
        self.needed[f"joinC{node.node_id}"] = total
        return cols, n

    # -- union / optional-chain provenance ------------------------------------

    def _union(self, node: P.UnionNode):
        """Fused concat-with-provenance: every arm's packed rows scatter
        into one output table at that arm's running offset (arm-major
        order — a row's provenance is its arm's offset range); variables
        an arm does not bind stay at the unbound sentinel."""
        arm_results = [self._eval(a) for a in node.arms]
        cap = self.caps[f"unionC{node.node_id}"]
        out = {v: self._full(cap) for v in node.out_vars}
        offset = torch.zeros_like(self.qlimit)
        for acols, an in arm_results:
            j = self._ar(_width(acols))[None, :]
            pos = offset[:, None] + j
            keep = (j < an[:, None]) & (pos < cap)
            idx = torch.where(keep, pos, cap)
            for v in node.out_vars:
                if v in acols:
                    out[v] = _scatter(out[v], idx, acols[v])
            offset = offset + an.to(torch.int32)
        self.needed[f"unionC{node.node_id}"] = offset
        self._sorted[node.node_id] = ()
        return out, offset.clamp(max=cap)

    def _tag_rows(self, node: P.TagRows):
        """Append the packed row index as a synthetic column — the
        provenance an OPTIONAL bind-join chain joins back on.  Row ids are
        strictly increasing, so any known sort sequence extends by them."""
        cols, n = self._eval(node.child)
        cap = _width(cols)
        out = dict(cols)
        out[node.var] = self._ar(cap).expand(n.shape[0], cap)
        self._sorted[node.node_id] = (
            self._sorted.get(node.child.node_id, ()) + (node.var,)
        )
        return out, n

    def _left_finish(self, node: P.LeftFinish):
        """Finish a multi-pattern OPTIONAL chain: the chain's packed rows
        are the matches; left rows whose row id never reached the chain
        output append after them with the group's variables unbound."""
        lcols, ln = self._eval(node.left)
        rcols, rn = self._eval(node.right)
        capL = _width(lcols)
        capR = _width(rcols)
        cap = self.caps[f"leftC{node.node_id}"]
        lvalid = self._ar(capL)[None, :] < ln[:, None]
        rvalid = self._ar(capR)[None, :] < rn[:, None]
        rid = rcols[node.rowid]
        matched = _scatter(
            torch.zeros(lvalid.shape, dtype=torch.bool, device=self.dev),
            torch.where(rvalid, rid, capL),
            torch.ones(rid.shape, dtype=torch.bool, device=self.dev),
        )
        unmatched = lvalid & ~matched
        out = {v: self._full(cap) for v in node.out_vars}
        jr = self._ar(capR)[None, :]
        idx_r = torch.where(rvalid & (jr < cap), jr, cap)
        for v in node.out_vars:
            if v in rcols:
                out[v] = _scatter(out[v], idx_r, rcols[v])
        upos_raw = rn[:, None] + torch.cumsum(
            unmatched.to(torch.int32), dim=1, dtype=torch.int32) - 1
        upos = torch.where(unmatched & (upos_raw < cap), upos_raw, cap)
        for v in node.out_vars:
            if v in lcols:
                out[v] = _scatter(out[v], upos, lcols[v])
        total = rn + unmatched.sum(dim=1, dtype=torch.int32)
        self.needed[f"leftC{node.node_id}"] = total
        self._sorted[node.node_id] = ()
        return out, total.clamp(max=cap)

    # -- filters -------------------------------------------------------------

    def _gather_side(self, array, ids):
        return array[ids.clamp(0, array.shape[0] - 1)]

    def _cmp(self, c: P.LCmp, cols: dict, cap: int):
        is_lit, is_num, str_rank, num_rank = self.vt_arrays[:4]

        def var_ids(o: P.LOperand):
            if o.var in cols:
                return cols[o.var]
            return self._full(cap)  # never-bound variable

        def rank_of(o: P.LOperand, table, okmask):
            ids = var_ids(o)
            ok = (ids >= 0) & self._gather_side(okmask, ids)
            return self._gather_side(table, ids), ok

        op = c.op
        if c.mode in ("num", "str"):
            table, okmask = (
                (num_rank, is_num) if c.mode == "num" else (str_rank, is_lit)
            )
            rank, ok = rank_of(c.lhs, table, okmask)
            lo = self.fops[:, c.rhs.slot, None]
            hi = self.fops[:, c.rhs.slot + 1, None]
            present = lo < hi
            if op == "<":
                return ok & (rank < lo)
            if op == "<=":
                return ok & (rank < hi)
            if op == ">":
                return ok & (rank >= hi)
            if op == ">=":
                return ok & (rank >= lo)
            if op == "=":
                return ok & present & (rank == lo)
            return ok & ~(present & (rank == lo))  # !=
        if c.mode == "term":
            x = var_ids(c.lhs)
            if c.rhs.kind == "var":
                y = var_ids(c.rhs)
                both = (x >= 0) & (y >= 0)
                return both & ((x == y) if op == "=" else (x != y))
            cid = self.fops[:, c.rhs.slot, None]
            bound = x >= 0
            return bound & ((x == cid) if op == "=" else (x != cid))
        # mode 'vv': ordering between two variables — numeric when both
        # numeric, else literal-body order when both literals, else false
        x, y = var_ids(c.lhs), var_ids(c.rhs)
        bound = (x >= 0) & (y >= 0)
        xn = self._gather_side(num_rank, x)
        yn = self._gather_side(num_rank, y)
        xs = self._gather_side(str_rank, x)
        ys = self._gather_side(str_rank, y)
        both_num = self._gather_side(is_num, x) & self._gather_side(is_num, y)
        both_lit = self._gather_side(is_lit, x) & self._gather_side(is_lit, y)

        def rel(a, b):
            if op == "<":
                return a < b
            if op == "<=":
                return a <= b
            if op == ">":
                return a > b
            return a >= b

        return bound & torch.where(both_num, rel(xn, yn), both_lit & rel(xs, ys))

    def _expr(self, e: P.LExpr, cols: dict, cap: int):
        if isinstance(e, P.LCmp):
            return self._cmp(e, cols, cap)
        if isinstance(e, P.LBound):
            if e.var in cols:
                return cols[e.var] >= 0
            return torch.zeros((self.qvalid.shape[0], cap), dtype=torch.bool,
                               device=self.dev)
        if isinstance(e, P.LNot):
            return ~self._expr(e.expr, cols, cap)
        if isinstance(e, P.LAnd):
            return self._expr(e.lhs, cols, cap) & self._expr(e.rhs, cols, cap)
        return self._expr(e.lhs, cols, cap) | self._expr(e.rhs, cols, cap)

    def _filter(self, node: P.Filter):
        cols, n = self._eval(node.child)
        self._sorted[node.node_id] = self._sorted.get(node.child.node_id, ())
        if not cols:  # zero-variable table: expr sees only unbound vars
            keep = self._expr(node.expr, cols, 1)
            return cols, torch.where(keep[:, 0], n, 0)
        cap = _width(cols)
        mask = self._expr(node.expr, cols, cap) & (self._ar(cap)[None, :] < n[:, None])
        return _compact(cols, mask, cap)[:2]

    # -- tail ----------------------------------------------------------------

    def _already_ordered(self, node) -> bool:
        """True when the child's known sort sequence already starts with
        this node's output columns — the determinism sort is a no-op."""
        child_sorted = self._sorted.get(node.child.node_id, ())
        return child_sorted[: len(node.out_vars)] == node.out_vars

    def _project(self, node: P.Project):
        cols, n = self._eval(node.child)
        child_sorted = self._sorted.get(node.child.node_id, ())
        kept = []
        for v in child_sorted:  # dropping a sort column cuts the sequence
            if v not in node.out_vars:
                break
            kept.append(v)
        self._sorted[node.node_id] = tuple(kept)
        cap = _width(cols)
        out = {}
        for v in node.out_vars:
            out[v] = cols[v] if v in cols else self._full(cap)
        return out, n

    def _group(self, node: P.Group):
        """GROUP BY + COUNT via a device segment-sum: sort by the key
        columns, find segment boundaries, count each segment's
        contributions (1 per row for COUNT(*), boundness of the argument
        for COUNT(?v)), and emit one packed row per segment — output rows
        are unique in the key tuple, so they come out sorted by it."""
        cols, n = self._eval(node.child)
        cap = _width(cols)
        valid = self._ar(cap)[None, :] < n[:, None]
        if node.count_var is None:
            contrib = valid.to(torch.int32)
        else:
            cv = cols.get(node.count_var)
            contrib = (
                torch.zeros_like(valid, dtype=torch.int32)
                if cv is None
                else (valid & (cv >= 0)).to(torch.int32)
            )
        if not node.keys:
            # the global group: exactly one row, even over zero solutions
            total = contrib.sum(dim=1, dtype=torch.int32)[:, None]
            out = {v: total for v in node.out_vars}  # validation: only the alias
            self._sorted[node.node_id] = node.out_vars
            return out, torch.ones_like(n)
        key_cols = {k: cols.get(k, self._full(cap)) for k in node.keys}
        perm, _ = _sort_perm(key_cols, node.keys, n, cap)
        skeys = {k: c.gather(1, perm) for k, c in key_cols.items()}
        svalid = valid.gather(1, perm)
        scontrib = contrib.gather(1, perm)
        same_prev = torch.ones_like(svalid)
        for k in node.keys:
            same_prev = same_prev & _same_prev(skeys[k])
        boundary = svalid & ~same_prev
        gid_raw = torch.cumsum(boundary.to(torch.int32), dim=1, dtype=torch.int32) - 1
        gid = torch.where(svalid, gid_raw, cap)
        B = n.shape[0]
        counts = torch.zeros((B, cap + 1), dtype=torch.int32, device=self.dev)
        counts.scatter_add_(1, gid.long(), scontrib)
        counts = counts[:, :cap]
        n_groups = boundary.sum(dim=1, dtype=torch.int32)
        bidx = torch.where(boundary, gid_raw, cap)
        out = {}
        for v in node.out_vars:
            if v == node.alias:
                out[v] = counts
            else:  # a selected group key: its value at each segment head
                out[v] = _scatter(self._full(cap), bidx, skeys[v])
        # output rows are unique in the full key tuple and sorted by it,
        # so any column extension of the key sequence stays sorted
        seq: list[str] = []
        for k in node.keys:
            if k not in node.out_vars:
                break
            seq.append(k)
        if len(seq) == len(node.keys):
            seq += [v for v in node.out_vars if v not in seq]
        self._sorted[node.node_id] = tuple(seq)
        return out, n_groups

    def _distinct(self, node: P.Distinct):
        cols, n = self._eval(node.child)
        self._sorted[node.node_id] = node.out_vars
        if not cols:
            return cols, n.clamp(max=1)
        cap = _width(cols)
        if self._already_ordered(node):
            sorted_cols, svalid = cols, self._ar(cap)[None, :] < n[:, None]
        else:
            perm, valid = _sort_perm(cols, node.out_vars, n, cap)
            sorted_cols = {v: c.gather(1, perm) for v, c in cols.items()}
            svalid = valid.gather(1, perm)
        same_prev = torch.ones_like(svalid)
        for v in node.out_vars:
            same_prev = same_prev & _same_prev(sorted_cols[v])
        keep = svalid & ~same_prev
        return _compact(sorted_cols, keep, cap)[:2]

    def _sort(self, node: P.Sort):
        cols, n = self._eval(node.child)
        self._sorted[node.node_id] = node.out_vars
        if not cols:
            return cols, n
        if self._already_ordered(node):
            return cols, n
        cap = _width(cols)
        perm, _ = _sort_perm(cols, node.out_vars, n, cap)
        return {v: c.gather(1, perm) for v, c in cols.items()}, n

    def _order_by(self, node: P.OrderBy):
        """Value-typed ORDER BY: term columns key on ``order_rank`` (the
        store-wide value order permutation), count columns on their raw
        integer value; descending keys negate; every output column
        tie-breaks in term-id order so the result stays deterministic.
        Elided when the child's tracked sortedness already realizes the
        requested order (possible only when value order == term-id
        order, or when every key is a count column)."""
        cols, n = self._eval(node.child)
        self._sorted[node.node_id] = ()
        if not cols:
            return cols, n
        cap = _width(cols)
        keyvars = tuple(v for v, _, _ in node.keys)
        desired = keyvars + tuple(
            v for v in node.out_vars if v not in keyvars
        )
        elidable = all(asc for _, asc, _ in node.keys) and (
            self.order_is_tid
            or all(is_count for _, _, is_count in node.keys)
        )
        child_sorted = self._sorted.get(node.child.node_id, ())
        if elidable and child_sorted[: len(desired)] == desired:
            self._sorted[node.node_id] = child_sorted
            return cols, n
        valid = self._ar(cap)[None, :] < n[:, None]
        order_rank = self.vt_arrays[4]
        keys = []
        for v, asc, is_count in node.keys:
            c = cols.get(v, self._full(cap))
            if is_count:
                k = c
            else:
                # unbound (-1) keys below every rank: unbound-first
                # ascending, unbound-last descending
                k = torch.where(c >= 0, self._gather_side(order_rank, c), -1)
            if not asc:
                k = -k
            keys.append(torch.where(valid, k, I32_MAX))
        for v in node.out_vars:  # term-id tie-break: determinism
            c = cols.get(v, self._full(cap))
            keys.append(torch.where(valid, c, I32_MAX))
        perm = lexsort_rows(keys)
        return {v: c.gather(1, perm) for v, c in cols.items()}, n

    # -- dispatch ------------------------------------------------------------

    def _eval(self, node: P.Node):
        hit = self._memo.get(node.node_id)
        if hit is not None:
            return hit
        res = self._eval_inner(node)
        self._memo[node.node_id] = res
        return res

    def _eval_inner(self, node: P.Node):
        if isinstance(node, P.Scan):
            return self._scan(node)
        if isinstance(node, P.BindJoin):
            return self._bind_join(node)
        if isinstance(node, P.Join):
            return self._join(node)
        if isinstance(node, P.UnionNode):
            return self._union(node)
        if isinstance(node, P.TagRows):
            return self._tag_rows(node)
        if isinstance(node, P.LeftFinish):
            return self._left_finish(node)
        if isinstance(node, P.Filter):
            return self._filter(node)
        if isinstance(node, P.Project):
            return self._project(node)
        if isinstance(node, P.Group):
            return self._group(node)
        if isinstance(node, P.Distinct):
            return self._distinct(node)
        if isinstance(node, P.Sort):
            return self._sort(node)
        if isinstance(node, P.OrderBy):
            return self._order_by(node)
        if isinstance(node, P.Limit):
            cols, n = self._eval(node.child)
            self._sorted[node.node_id] = self._sorted.get(
                node.child.node_id, ()
            )
            # the limit value is per-query runtime data (plan sharing);
            # -1 marks a padded batch row, where the count is 0 anyway
            return cols, torch.where(
                self.qlimit >= 0, torch.minimum(n, self.qlimit), n
            )
        raise TypeError(f"unknown plan node {node!r}")

    def run(self, scan_cols_flat, scan_keys_flat, scan_prim_flat,
            dscan_cols_flat, dscan_keys_flat, alive_flat, dn,
            vt_arrays, consts, fops, qvalid, qlimit):
        """One dispatch over the batch: ``consts`` ``[B, n_scans, 3]``,
        ``fops`` ``[B, n_filter_ops]``, ``qvalid`` ``[B]``, ``qlimit``
        ``[B]``; the ``dscan_*`` / ``alive_flat`` / ``dn`` (live delta
        rows) operands feed the overlay arm.  Returns ``(out_cols, n,
        needed)``: the root's columns ``[B, cap]``, its counts ``[B]`` and
        each capacity's need ``[B]``."""
        self.scan_cols = {
            s.node_id: scan_cols_flat[3 * i: 3 * i + 3]
            for i, s in enumerate(self.plan.scans)
        }
        self.scan_keys = {
            s.node_id: scan_keys_flat[i] if self.packed else None
            for i, s in enumerate(self.plan.scans)
        }
        self.scan_prim = {
            s.node_id: scan_prim_flat[i] if self.packed else None
            for i, s in enumerate(self.plan.scans)
        }
        self.dscan_cols = {
            s.node_id: dscan_cols_flat[3 * i: 3 * i + 3]
            for i, s in enumerate(self.plan.scans)
        }
        self.dscan_keys = {
            s.node_id: dscan_keys_flat[i] if self.packed else None
            for i, s in enumerate(self.plan.scans)
        }
        self.alive = {
            s.node_id: alive_flat[i] for i, s in enumerate(self.plan.scans)
        }
        self.dn = dn
        self.vt_arrays = vt_arrays
        self.consts = consts
        self.fops = fops
        self.qvalid = qvalid
        self.qlimit = qlimit
        self.dev = consts.device
        self.needed = {}
        self._memo = {}
        cols, n = self._eval(self.plan.root)
        out_cols = tuple(cols.get(v) for v in self.plan.root.out_vars)
        return out_cols, n, dict(self.needed)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _initial_caps(plan: P.Plan, floors: dict[str, int]) -> dict[str, int]:
    caps: dict[str, int] = {}
    seen: set[int] = set()

    def walk(node: P.Node) -> None:
        if node.node_id in seen:  # the plan is a DAG: visit shared subtrees once
            return
        seen.add(node.node_id)
        if isinstance(node, P.Scan):
            if node.out_vars:
                caps[f"scan{node.node_id}"] = next_pow2(max(node.est, 1))
            return
        if isinstance(node, P.BindJoin):
            walk(node.left)
            if node.free_slots:
                if node.eq_pairs:  # grid fallback needs the fan-out cap
                    caps[f"bindM{node.node_id}"] = 8
                caps[f"bindC{node.node_id}"] = next_pow2(
                    min(max(node.est, 16), 1 << 22)
                )
            return
        if isinstance(node, P.Join):
            walk(node.left)
            walk(node.right)
            if node.right.out_vars and (
                node.left.out_vars or node.kind == "left"
            ):
                if node.shared:
                    caps[f"joinM{node.node_id}"] = 8
                # clamp the initial guess: a mis-estimated cross join must
                # not allocate a giant table up front (feedback grows it to
                # the exact need if the result really is that large)
                caps[f"joinC{node.node_id}"] = next_pow2(
                    min(max(node.est, 16), 1 << 22)
                )
            return
        if isinstance(node, P.UnionNode):
            for arm in node.arms:
                walk(arm)
            caps[f"unionC{node.node_id}"] = next_pow2(
                min(max(node.est, 16), 1 << 22)
            )
            return
        if isinstance(node, P.LeftFinish):
            walk(node.left)
            walk(node.right)
            caps[f"leftC{node.node_id}"] = next_pow2(
                min(max(node.est, 16), 1 << 22)
            )
            return
        for c in P._children(node):
            walk(c)

    walk(plan.root)
    for k, v in floors.items():
        if k in caps:
            caps[k] = max(caps[k], v)
    return caps


class Executor:
    """Per-store query executor: plan cache, capacity memory, pipeline
    cache.  Get one via :func:`get_executor`."""

    #: route eligible small batches through the fused scan-join chain
    #: (``repro_torch.serve.fastpath``); tests flip this off to force the
    #: general pipeline for equivalence checks
    fastpath_enabled = True

    def __init__(self, store: TripleStore):
        self.store = store
        self._plans: dict[tuple, P.Plan] = {}
        self._floors: dict[tuple, dict[str, int]] = {}
        self._pipelines: dict[tuple, _Lowerer] = {}
        self._fastpaths: dict[tuple, "FP.SigFastPath | None"] = {}
        self.dispatches = 0  # total pipeline dispatches (for tests)

    # -- plans ---------------------------------------------------------------

    def plan(self, q: A.SelectQuery) -> P.Plan:
        sig = q.signature()
        plan = self._plans.get(sig)
        if plan is None:
            plan = P.plan_query(self.store, q)
            self._plans[sig] = plan
        return plan

    # -- pipelines -------------------------------------------------------------

    def _pipeline(self, plan: P.Plan, caps: dict[str, int], bpad: int,
                  ov: tuple[int, bool] | None = None):
        """The pipeline for one (plan, capacities, batch pad, overlay):
        cached like the JAX package's compiled functions, so the cache
        counters agree.  ``ov`` switches on the overlay arm: ``(delta row
        capacity, delta index packable)``."""
        key = (plan.sig, tuple(sorted(caps.items())), bpad, ov)
        fn = self._pipelines.get(key)
        if fn is not None:
            get_registry().inc("exec.pipeline_cache_hit")
        else:
            get_registry().inc("exec.pipeline_cache_miss")
            if self.store.n_triples == 0:
                # overlay over an empty base: dummy single-row base
                # operands, every base range comes out empty
                base_packed = True
                prim_rounds = {s.node_id: 1 for s in plan.scans}
            else:
                base_packed = self.store.device_keys("spo") is not None
                prim_rounds = (
                    {s.node_id: self.store.primary_rounds(s.order)
                     for s in plan.scans}
                    if base_packed else None
                )
            # a combined term table that overflows the packed key fields
            # forces both arms onto the 3-column lexicographic fallback
            packed = base_packed and (ov is None or ov[1])
            if not packed:
                prim_rounds = None
            order_is_tid = (
                value_table(self.store).order_is_tid
                if plan.needs_values and ov is None
                else False  # overlay term ids append out of rendered order
            )
            delta_cap = ov[0] if ov else 1
            fn = _Lowerer(
                plan, caps, max(self.store.n_triples, 1), self.store.KEY_BITS,
                packed, prim_rounds, order_is_tid,
                overlay=ov is not None,
                delta_cap=delta_cap,
                delta_rounds=max(1, int(delta_cap).bit_length()),
            )
            self._pipelines[key] = fn
        return fn

    # -- execution -----------------------------------------------------------

    def execute(
        self, plan: P.Plan, queries: list[A.SelectQuery], view=None
    ) -> BatchResult:
        """Run signature-equal ``queries`` as one micro-batch: encode each
        query's constants, then dispatch through :meth:`execute_encoded`.
        ``view`` (a :class:`repro_torch.live.delta.OverlayView` over this
        executor's store) answers over ``base ⊕ delta``; an inactive view
        (empty overlay) takes the pure-read fast path untouched."""
        act = view is not None and view.active
        enc = view if act else self.store
        bsz = len(queries)
        consts = np.full((bsz, len(plan.scans), 3), -2, np.int32)
        fops = np.zeros((bsz, max(plan.n_filter_ops, 1)), np.int32)
        vt = value_table(enc) if plan.has_filters else None
        for i, q in enumerate(queries):
            consts[i] = P.encode_scan_consts(enc, plan, q)
            if plan.n_filter_ops:
                fops[i] = P.encode_filter_ops(enc, vt, q.filters)
        limits = np.asarray(
            [-1 if q.limit is None else q.limit for q in queries], np.int32
        )
        return self.execute_encoded(
            plan, consts, fops, limits, view=view if act else None
        )

    def execute_encoded(
        self,
        plan: P.Plan,
        consts: np.ndarray,
        fops: np.ndarray | None = None,
        limits: np.ndarray | None = None,
        view=None,
    ) -> BatchResult:
        """The pre-encoded hot path (the benchmark's unit of work): run a
        ``[B, n_scans, 3]`` int32 constants batch (``-1`` variable slot,
        ``-2`` unknown constant) plus optional ``[B, n_filter_ops]`` filter
        operands, padded to a power-of-two batch, re-dispatching only when
        a capacity was exceeded.  Batches of at most ``fastpath.MAX_BATCH``
        whose plan is a scan-join chain go to the fast path (kernel K4 on
        the card).  ``view`` (an *active* overlay view whose constants and
        filter operands were encoded against it) adds the second scan arm
        and always takes the general pipeline; its results decode against
        the view's combined terms."""
        store = self.store
        out_vars = plan.root.out_vars
        bsz = consts.shape[0]
        if store.n_triples == 0 and view is None:
            if plan.global_agg_alias is not None:
                # a global COUNT answers one zero row even over nothing
                lim = (
                    np.full(bsz, -1, np.int64)
                    if limits is None
                    else np.asarray(limits, np.int64)[:bsz]
                )
                counts = np.where(lim >= 0, np.minimum(lim, 1), 1)
                return BatchResult(
                    store=store,
                    vars=out_vars,
                    cols={v: np.zeros((bsz, 1), np.int32) for v in out_vars},
                    counts=counts.astype(np.int64),
                    agg_vars=plan.agg_vars,
                )
            return BatchResult(
                store=store,
                vars=out_vars,
                cols={v: np.full((bsz, 1), -1, np.int32) for v in out_vars},
                counts=np.zeros(bsz, np.int64),
                agg_vars=plan.agg_vars,
            )
        if view is None and self.fastpath_enabled and bsz <= FP.MAX_BATCH:
            fp = self._fastpaths.get(plan.sig, _FP_UNSET)
            if fp is _FP_UNSET:
                fp = FP.build(self, plan)
                self._fastpaths[plan.sig] = fp
            if fp is not None:
                res = fp.dispatch(consts, limits, bsz)
                if res is not None:  # None: outgrew the small-batch regime
                    fcols, counts = res
                    return BatchResult(
                        store=store,
                        vars=out_vars,
                        cols=dict(zip(out_vars, fcols)),
                        counts=counts,
                        agg_vars=plan.agg_vars,
                    )
        bpad = next_pow2(max(bsz, 1))
        if fops is None:
            fops = np.zeros((bsz, max(plan.n_filter_ops, 1)), np.int32)
        if limits is None:
            limits = np.full(bsz, -1, np.int32)
        if bpad > bsz:
            consts = np.concatenate(
                [consts, np.full((bpad - bsz, len(plan.scans), 3), -2, np.int32)]
            )
            fops = np.concatenate(
                [fops, np.zeros((bpad - bsz, fops.shape[1]), np.int32)]
            )
            limits = np.concatenate(
                [limits, np.full(bpad - bsz, -1, np.int32)]
            )
        qvalid = np.zeros(bpad, bool)
        qvalid[:bsz] = True
        dev = store.device
        enc = view if view is not None else store
        vt = value_table(enc) if plan.needs_values else None

        n_scans = len(plan.scans)
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        if store.n_triples == 0:
            # empty base under an active overlay: single-row dummies keep
            # every gather in range; the alive prefix sums (length 1) make
            # every base range empty, and two zero primary starts make
            # every seeded search window empty
            z2 = torch.zeros(2, dtype=torch.int32, device=dev)
            scan_cols_flat = (z,) * (3 * n_scans)
            scan_keys_flat = ((z, z),) * n_scans
            scan_prim_flat = (z2,) * n_scans
        else:
            scan_cols_flat = tuple(
                c for s in plan.scans for c in store.device_cols(s.order)
            )
            if store.device_keys("spo") is not None:
                scan_keys_flat = tuple(
                    store.device_keys(s.order) for s in plan.scans)
                scan_prim_flat = tuple(
                    store.device_primary_starts(s.order) for s in plan.scans
                )
            else:
                scan_keys_flat = ((z, z),) * n_scans
                scan_prim_flat = (z,) * n_scans
        if view is not None:
            delta = view.delta
            ov_packed = delta.device_keys("spo") is not None
            ov = (delta.n_triples, ov_packed)
            dscan_cols_flat = tuple(
                c for s in plan.scans for c in delta.device_cols(s.order)
            )
            if ov_packed:
                dscan_keys_flat = tuple(
                    delta.device_keys(s.order) for s in plan.scans)
            else:
                dscan_keys_flat = ((z, z),) * n_scans
            alive_flat = tuple(view.alive(s.order) for s in plan.scans)
            dn = int(view.n_delta)
        else:
            ov = None
            dscan_cols_flat = (z,) * (3 * n_scans)
            dscan_keys_flat = ((z, z),) * n_scans
            alive_flat = (z,) * n_scans
            dn = 0
        if plan.needs_values:
            vt_arrays = (
                vt.is_lit, vt.is_num, vt.str_rank, vt.num_rank, vt.order_rank
            )
        else:
            zb = torch.zeros(1, dtype=torch.bool, device=dev)
            vt_arrays = (zb, zb, z, z, z)

        floors = self._floors.setdefault(plan.sig, {})
        caps = _initial_caps(plan, floors)
        # the batch's per-query data, copied to the device once
        consts_d = torch.from_numpy(np.ascontiguousarray(consts, np.int32)).to(dev)
        fops_d = torch.from_numpy(np.ascontiguousarray(fops, np.int32)).to(dev)
        qvalid_d = torch.from_numpy(qvalid).to(dev)
        qlimit_d = torch.from_numpy(np.ascontiguousarray(limits, np.int32)).to(dev)
        reg = get_registry()
        tracer = get_tracer()
        label = plan_label(plan.sig)
        reg.inc("exec.batches")
        reg.inc("exec.queries", bsz)
        for round_i in range(_MAX_GROW_ROUNDS):
            t0 = time.perf_counter_ns()
            fn = self._pipeline(plan, caps, bpad, ov)
            out_cols, n, needed = fn.run(
                scan_cols_flat, scan_keys_flat, scan_prim_flat,
                dscan_cols_flat, dscan_keys_flat, alive_flat, dn,
                vt_arrays, consts_d, fops_d, qvalid_d, qlimit_d,
            )
            self.dispatches += 1
            # every capacity's need, max over the batch, in one copy
            names = list(needed)
            wants = (
                torch.stack([needed[k] for k in names]).amax(dim=1).cpu().tolist()
                if names else []
            )
            grown = False
            for k, want in zip(names, wants):
                if want > caps[k]:
                    caps[k] = next_pow2(want)
                    floors[k] = max(floors.get(k, 0), caps[k])
                    grown = True
                    # grow-only buffer growth: remembered per signature, so
                    # a steady workload stops paying this re-dispatch
                    reg.inc("exec.cap_growth")
            t1 = time.perf_counter_ns()
            reg.inc("exec.dispatches")
            reg.observe("exec.dispatch_ms", (t1 - t0) / 1e6)
            if round_i > 0:
                reg.inc("exec.redispatches")
            if tracer.enabled:
                tracer.add_complete(
                    "redispatch" if round_i > 0 else "dispatch",
                    "exec", t0, t1,
                    plan=label, batch=bsz, round=round_i,
                    grown=grown,
                )
            if not grown:
                break
        else:
            raise RuntimeError(
                "executor capacity feedback did not converge "
                f"(caps={caps}) — pathological query?"
            )
        # counts and columns come back in one copy
        flat = torch.cat([n[:bsz, None], *(c[:bsz] for c in out_cols)], dim=1)
        flat = flat.cpu().numpy()
        counts = flat[:, 0].astype(np.int64)
        cols, at = {}, 1
        for v, c in zip(out_vars, out_cols):
            cols[v] = flat[:, at: at + c.shape[1]]
            at += c.shape[1]
        return BatchResult(
            store=enc, vars=out_vars, cols=cols, counts=counts,
            agg_vars=plan.agg_vars,
        )

    def solve(self, q: A.SelectQuery) -> BatchResult:
        return self.execute(self.plan(q), [q])

    def warmup(self, top_k: int = 2) -> int:
        """Run the dominant interactive shapes once — the 1-, 2- and
        3-pattern star chains anchored on the store's ``top_k`` most
        frequent predicates — at batch pad 1, so the capacity floors and
        the pipeline and fast-path caches are warm before the first
        small-batch query.  Returns the number of signatures warmed."""
        store = self.store
        if store.n_triples == 0:
            return 0
        prim = np.asarray(store.indexes["pos"].cols[0])
        preds, cnts = np.unique(prim, return_counts=True)
        top = [
            store.decode_term(int(p))
            for p in preds[np.argsort(cnts)[::-1][: max(top_k, 1)]]
        ]
        texts = []
        for p in top:
            texts.append(f"SELECT * WHERE {{ ?s {p} ?o }}")
        if len(top) >= 2:
            p0, p1 = top[0], top[1]
            texts.append(
                f"SELECT * WHERE {{ ?s {p0} ?o0 . ?s {p1} ?o1 }}"
            )
            texts.append(
                "SELECT * WHERE { "
                + f"?s {p0} ?o0 . ?s {p1} ?o1 . ?s {p0} ?o2 "
                + "}"
            )
        warmed = 0
        for text in texts:
            try:
                q = A.parse_select(text)
                self.execute(self.plan(q), [q])
                warmed += 1
            except Exception:  # a shape the store can't serve: skip it
                continue
        return warmed


def get_executor(store: TripleStore) -> Executor:
    ex = getattr(store, "_serve_executor", None)
    if ex is None:
        ex = Executor(store)
        store._serve_executor = ex
    return ex


def solve_select(store: TripleStore, q: A.SelectQuery) -> BatchResult:
    """One-shot convenience: plan + execute a single query."""
    return get_executor(store).solve(q)
