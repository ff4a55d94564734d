"""Cost-based planner — SelectQuery -> operator tree for the fused executor.

Generalizes the join-ordering logic that used to live inline in
``repro_torch.kg.query.solve``: every scan's cardinality is *measured* from the
SPO/POS/OSP index statistics (a pattern is a contiguous range of one sort
order, so its exact count is two binary searches — the cheapest perfect
estimator there is), and the required BGP is folded greedily smallest-first
while always preferring a scan *connected* to the accumulated scope; a
disconnected scan cross-joins only when no connected one remains.

Placement rules:

* filters are pushed to the earliest point where every eventually-bound
  variable they mention is in scope (a filter over union- or optional-only
  variables waits until after that ``Union`` / ``LeftJoin``);
* ``UNION`` arms each fold *onto the shared required subtree* — the
  required scans are planned once and the executor evaluates them once
  (its node memo turns the plan tree into a DAG), so arms never re-scan
  the shared part; arm costs sum into the ``Union`` concat capacity;
* single-pattern ``OPTIONAL`` groups bind-join with unmatched-row
  backfill; multi-pattern groups are planned as *bind-join chains off the
  required scope*: the left rows are tagged with a synthetic row id, the
  group's patterns chain as inner (bind) joins anchored on the left
  bindings — the group is never materialized on its own — and a final
  ``LeftFinish`` appends the unmatched left rows with the group's
  variables unbound;
* aggregation (``GROUP BY`` + ``COUNT``) places after all joins and
  filters: ``Group`` sorts by the key columns and segment-counts on
  device, replacing the ``Project`` tail;
* the tail is ``Project|Group -> Distinct | Sort | OrderBy -> Limit`` —
  ``ORDER BY`` sorts by *value-typed* rank keys (``serve/values.py``) with
  a full term-id tie-break, so results stay deterministic; without it the
  engine sorts final binding tables by term id (and, because term ids are
  ranks of rendered terms, identically across eager / streamed /
  ``.kgz``-roundtripped stores).  The executor elides either sort when
  the pipeline's tracked sortedness already matches.

The plan is structure-only: constants live in per-query operand vectors
(:func:`encode_scan_consts` / :func:`encode_filter_ops`), so one plan (and
one compiled pipeline) serves every query with the same
:meth:`~repro_torch.serve.algebra.SelectQuery.signature` — the unit the server
micro-batches on.
"""

from __future__ import annotations

import dataclasses
from typing import Union as TUnion

import numpy as np

from repro_torch.kg.query import _ORDER_FOR_MASK, TriplePattern, match_counts
from repro_torch.kg.store import TripleStore
from repro_torch.serve import algebra as A
from repro_torch.serve.values import ValueTable

# ---------------------------------------------------------------------------
# lowered filter expressions (constants -> operand-vector slots)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LOperand:
    kind: str          # 'var' | 'const'
    var: str | None    # for kind == 'var'
    slot: int          # start index into the filter-operand vector
    width: int         # ints this operand occupies (0 for vars)


@dataclasses.dataclass(frozen=True)
class LCmp:
    op: str            # normalized: constants only ever on the rhs
    mode: str          # 'num' | 'str' | 'term' | 'vv'
    lhs: LOperand
    rhs: LOperand


@dataclasses.dataclass(frozen=True)
class LBound:
    var: str


@dataclasses.dataclass(frozen=True)
class LNot:
    expr: "LExpr"


@dataclasses.dataclass(frozen=True)
class LAnd:
    lhs: "LExpr"
    rhs: "LExpr"


@dataclasses.dataclass(frozen=True)
class LOr:
    lhs: "LExpr"
    rhs: "LExpr"


LExpr = TUnion[LCmp, LBound, LNot, LAnd, LOr]

_FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}


def _cmp_mode(c: A.Cmp) -> str:
    if isinstance(c.lhs, A.NumConst) or isinstance(c.rhs, A.NumConst):
        return "num"
    if c.op in ("=", "!="):
        return "term"
    if isinstance(c.lhs, A.TermConst) or isinstance(c.rhs, A.TermConst):
        return "str"
    return "vv"  # var-vs-var ordering: numeric if both numeric, else string


def _operand_width(op: A.Operand, mode: str) -> int:
    if isinstance(op, A.Var):
        return 0
    if mode in ("num", "str"):
        return 2  # (lo, hi) rank bounds
    return 1      # term id


def _lower_expr(e: A.Expr, cursor: list[int]) -> LExpr:
    if isinstance(e, A.Cmp):
        op, lhs, rhs = e.op, e.lhs, e.rhs
        if not isinstance(lhs, A.Var):  # normalize: constant to the rhs
            op, lhs, rhs = _FLIP[op], rhs, lhs
        mode = _cmp_mode(e)

        def low(x: A.Operand) -> LOperand:
            w = _operand_width(x, mode)
            slot = cursor[0]
            cursor[0] += w
            return LOperand(
                kind="var" if isinstance(x, A.Var) else "const",
                var=x.name if isinstance(x, A.Var) else None,
                slot=slot,
                width=w,
            )

        return LCmp(op=op, mode=mode, lhs=low(lhs), rhs=low(rhs))
    if isinstance(e, A.Bound):
        return LBound(e.var.name)
    if isinstance(e, A.Not):
        return LNot(_lower_expr(e.expr, cursor))
    if isinstance(e, A.And):
        return LAnd(_lower_expr(e.lhs, cursor), _lower_expr(e.rhs, cursor))
    return LOr(_lower_expr(e.lhs, cursor), _lower_expr(e.rhs, cursor))


def encode_filter_ops(
    store: TripleStore, vt: ValueTable | None, filters: tuple[A.Expr, ...]
) -> np.ndarray:
    """Per-query filter constants -> one int32 operand vector, in the same
    depth-first order :func:`_lower_expr` assigned slots (signature-equal
    queries produce identically-shaped vectors)."""
    out: list[int] = []

    def enc_operand(x: A.Operand, mode: str) -> None:
        if isinstance(x, A.Var):
            return
        assert vt is not None
        if mode == "num":
            assert isinstance(x, A.NumConst)
            out.extend(vt.num_bounds(x.value))
        elif mode == "str":
            assert isinstance(x, A.TermConst)
            out.extend(vt.str_bounds(x.body))
        else:  # term identity
            assert isinstance(x, A.TermConst)
            tid = store.term_id(x.term)
            out.append(-2 if tid is None else tid)

    def walk(e: A.Expr) -> None:
        if isinstance(e, A.Cmp):
            op, lhs, rhs = e.op, e.lhs, e.rhs
            if not isinstance(lhs, A.Var):
                lhs, rhs = rhs, lhs
            mode = _cmp_mode(e)
            enc_operand(lhs, mode)
            enc_operand(rhs, mode)
        elif isinstance(e, A.Not):
            walk(e.expr)
        elif isinstance(e, (A.And, A.Or)):
            walk(e.lhs)
            walk(e.rhs)

    for f in filters:
        walk(f)
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scan:
    node_id: int
    pattern_pos: int                         # index into query.all_patterns()
    order: str                               # spo | pos | osp
    const_slots: tuple[int, ...]             # triple positions bound by consts
    var_slots: tuple[tuple[int, str], ...]   # (position, var) first occurrences
    eq_pairs: tuple[tuple[int, int], ...]    # repeated-var position pairs
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Join:
    node_id: int
    left: "Node"
    right: "Node"
    shared: tuple[str, ...]
    kind: str                                # 'inner' | 'left'
    build_right: bool                        # which side the sorted build is
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class BindJoin:
    """Index nested-loop join: instead of scanning the pattern
    independently and merge-joining, each left-side row *binds* its shared
    variables into the pattern's range scan (they become part of the bound
    prefix of the index lookup).  This is what makes an anchored star BGP
    cheap — the unanchored pattern is never materialized."""

    node_id: int
    left: "Node"
    pattern_pos: int
    order: str
    const_slots: tuple[int, ...]
    bound_slots: tuple[tuple[int, str], ...]  # (position, left-bound var)
    free_slots: tuple[tuple[int, str], ...]   # (position, newly bound var)
    eq_pairs: tuple[tuple[int, int], ...]     # repeated free-var positions
    kind: str                                 # 'inner' | 'left'
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class UnionNode:
    """Bag union of the arms' solution tables: a fused concat preserving
    arm order (a row's provenance is its arm's offset range).  Arms share
    the required subtree — the executor's node memo evaluates it once."""

    node_id: int
    arms: tuple["Node", ...]
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class TagRows:
    """Append a synthetic row-id column (the packed row index) — the
    provenance a multi-pattern OPTIONAL chain joins back on."""

    node_id: int
    child: "Node"
    var: str                                 # synthetic, never a query var
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class LeftFinish:
    """Finish a multi-pattern OPTIONAL planned as a bind-join chain:
    ``right`` is the inner chain ``TagRows(left) |x| p1 |x| p2 ...`` — its
    rows are the matches, carrying every left column — and left rows whose
    row id never reached the chain output are appended with the group's
    variables left unbound."""

    node_id: int
    left: "Node"                             # the TagRows node
    right: "Node"                            # the inner chain
    rowid: str
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Filter:
    node_id: int
    child: "Node"
    expr: LExpr
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Project:
    node_id: int
    child: "Node"
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Group:
    """GROUP BY + COUNT: sort by the key columns, segment-count on device.
    ``keys == ()`` is the global group (always exactly one output row)."""

    node_id: int
    child: "Node"
    keys: tuple[str, ...]
    count_var: str | None                    # COUNT(?v) argument; None = *
    alias: str | None                        # None = no COUNT selected
    out_vars: tuple[str, ...]                # the SELECT order
    est: int


@dataclasses.dataclass(frozen=True)
class Distinct:
    node_id: int
    child: "Node"
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Sort:
    node_id: int
    child: "Node"
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class OrderBy:
    """Value-typed ORDER BY: each key column sorts by the store's
    ``order_rank`` side table (count columns by their integer value),
    descending keys negated; the remaining output columns tie-break in
    term-id order so the result is still deterministic."""

    node_id: int
    child: "Node"
    keys: tuple[tuple[str, bool, bool], ...]  # (var, ascending, is_count)
    out_vars: tuple[str, ...]
    est: int


@dataclasses.dataclass(frozen=True)
class Limit:
    node_id: int
    child: "Node"
    n: int
    out_vars: tuple[str, ...]
    est: int


Node = TUnion[
    Scan, BindJoin, Join, UnionNode, TagRows, LeftFinish, Filter,
    Project, Group, Distinct, Sort, OrderBy, Limit,
]


@dataclasses.dataclass(frozen=True)
class Plan:
    sig: tuple
    root: Node
    # pattern readers (Scan | BindJoin) in pipeline order; reader i takes
    # constants row i of the per-query consts matrix
    scans: tuple[TUnion[Scan, BindJoin], ...]
    n_filter_ops: int
    has_filters: bool
    # the value side tables are needed for filters and for ORDER BY over
    # term (non-count) columns
    needs_values: bool = False
    agg_vars: tuple[str, ...] = ()
    # a global COUNT (aggregate without GROUP BY) answers one row even
    # over an empty store — the empty-store shortcut needs to know
    global_agg_alias: str | None = None

    def explain(self, indent: str = "") -> str:
        """Human-readable operator tree (cost annotations included).  The
        plan is a DAG — union arms and optional chains share subtrees — so
        a subtree already printed shows as one ``(shared ...)`` line
        instead of being expanded again (also keeps explain linear, not
        exponential, in the number of optional groups)."""
        lines: list[str] = []
        seen: set[int] = set()

        def walk(node: Node, depth: int) -> None:
            pad = indent + "  " * depth
            if node.node_id in seen:
                lines.append(
                    f"{pad}(shared {type(node).__name__} "
                    f"node#{node.node_id} — expanded above)"
                )
                return
            seen.add(node.node_id)
            if isinstance(node, Scan):
                lines.append(
                    f"{pad}Scan[{node.order}] pattern#{node.pattern_pos} "
                    f"vars={list(node.out_vars)} est={node.est}"
                )
                return
            name = type(node).__name__
            extra = ""
            if isinstance(node, Join):
                extra = (
                    f" {node.kind} on={list(node.shared) or 'x'} "
                    f"build={'right' if node.build_right else 'left'}"
                )
            if isinstance(node, BindJoin):
                extra = (
                    f" {node.kind} pattern#{node.pattern_pos}[{node.order}] "
                    f"bind={[v for _, v in node.bound_slots]} "
                    f"+{[v for _, v in node.free_slots]}"
                )
            if isinstance(node, UnionNode):
                extra = f" arms={len(node.arms)}"
            if isinstance(node, TagRows):
                extra = f" +{node.var}"
            if isinstance(node, LeftFinish):
                extra = f" rowid={node.rowid}"
            if isinstance(node, Group):
                count = (
                    f" count({node.count_var or '*'}) as {node.alias}"
                    if node.alias
                    else ""
                )
                extra = f" by={list(node.keys) or 'all'}{count}"
            if isinstance(node, OrderBy):
                extra = " " + ",".join(
                    f"{'+' if asc else '-'}{v}" for v, asc, _ in node.keys
                )
            if isinstance(node, Limit):
                extra = f" n={node.n}"
            lines.append(f"{pad}{name}{extra} est={node.est}")
            for child in _children(node):
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


def _children(node: Node) -> tuple[Node, ...]:
    if isinstance(node, Scan):
        return ()
    if isinstance(node, Join):
        return (node.left, node.right)
    if isinstance(node, BindJoin):
        return (node.left,)
    if isinstance(node, UnionNode):
        return node.arms
    if isinstance(node, LeftFinish):
        return (node.left, node.right)
    return (node.child,)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def _scan_estimates(
    store: TripleStore, patterns: tuple[TriplePattern, ...]
) -> list[int]:
    """Exact per-pattern cardinalities from the index statistics.  A pattern
    holding a constant the store has never seen is 0 without touching the
    index."""
    ids = np.full((len(patterns), 3), -1, np.int32)
    resolvable = np.ones(len(patterns), bool)
    for i, pat in enumerate(patterns):
        for j, term in enumerate(pat.slots):
            if term.startswith("?"):
                continue
            tid = store.term_id(term)
            if tid is None:
                resolvable[i] = False
            else:
                ids[i, j] = tid
    ests = np.zeros(len(patterns), np.int64)
    live = np.nonzero(resolvable)[0]
    if len(live) and store.n_triples:
        ests[live] = match_counts(store, ids[live])
    return [int(e) for e in ests]


class _Builder:
    def __init__(self) -> None:
        self._next = 0

    def nid(self) -> int:
        n = self._next
        self._next += 1
        return n

    def scan(self, pattern_pos: int, pat: TriplePattern, est: int) -> Scan:
        const_slots, var_slots, eq_pairs = [], [], []
        first: dict[str, int] = {}
        for pos, term in enumerate(pat.slots):
            if not term.startswith("?"):
                const_slots.append(pos)
            elif term in first:
                eq_pairs.append((first[term], pos))
            else:
                first[term] = pos
                var_slots.append((pos, term))
        mask = tuple(not t.startswith("?") for t in pat.slots)
        return Scan(
            node_id=self.nid(),
            pattern_pos=pattern_pos,
            order=_ORDER_FOR_MASK[mask],
            const_slots=tuple(const_slots),
            var_slots=tuple(var_slots),
            eq_pairs=tuple(eq_pairs),
            out_vars=tuple(v for _, v in var_slots),
            est=est,
        )

    def join(self, left: Node, right: Node, kind: str) -> Join:
        shared = tuple(v for v in left.out_vars if v in right.out_vars)
        out = left.out_vars + tuple(
            v for v in right.out_vars if v not in left.out_vars
        )
        if shared:
            est = max(left.est, right.est)
        else:
            est = left.est * max(right.est, 1) if kind == "left" else (
                left.est * right.est
            )
        # the sorted build side is the smaller one; LeftJoin must probe with
        # the (preserved) left side, so its build is always the right
        build_right = True if kind == "left" else right.est <= left.est
        return Join(
            node_id=self.nid(),
            left=left,
            right=right,
            shared=shared,
            kind=kind,
            build_right=build_right,
            out_vars=out,
            est=max(int(est), 0),
        )

    def bind_join(self, left: Node, scan: Scan, kind: str) -> BindJoin:
        """Rewrite ``left JOIN scan`` as an index nested-loop join: the
        scan's variables already bound on the left become part of the
        index lookup's bound prefix."""
        const_slots = list(scan.const_slots)
        bound_slots, free_slots, eq_pairs = [], [], []
        first_free: dict[str, int] = {}
        for pos, v in scan.var_slots:
            if v in left.out_vars:
                bound_slots.append((pos, v))
            elif v in first_free:
                eq_pairs.append((first_free[v], pos))
            else:
                first_free[v] = pos
                free_slots.append((pos, v))
        # a repeated variable whose first slot is bound binds every slot
        for pa, pb in scan.eq_pairs:
            var = next(v for p, v in scan.var_slots if p == pa)
            if var in left.out_vars:
                bound_slots.append((pb, var))
            else:
                eq_pairs.append((pa, pb))
        mask = tuple(
            pos in const_slots or any(p == pos for p, _ in bound_slots)
            for pos in range(3)
        )
        return BindJoin(
            node_id=self.nid(),
            left=left,
            pattern_pos=scan.pattern_pos,
            order=_ORDER_FOR_MASK[mask],
            const_slots=tuple(const_slots),
            bound_slots=tuple(bound_slots),
            free_slots=tuple(free_slots),
            eq_pairs=tuple(eq_pairs),
            kind=kind,
            out_vars=left.out_vars + tuple(v for _, v in free_slots),
            est=max(left.est, 16),
        )

    def combine(self, left: Node, scan: Scan, kind: str = "inner") -> Node:
        """Pick the physical join: a scan sharing variables with the
        accumulated scope bind-joins when its independent cardinality
        exceeds the left side's (never materialize the big unanchored
        side); otherwise the sorted-merge join over both materialized
        sides wins."""
        shared = [v for v in scan.out_vars if v in left.out_vars]
        if (
            shared
            and left.out_vars
            and (kind == "left" or scan.est > left.est)
        ):
            return self.bind_join(left, scan, kind)
        return self.join(left, scan, kind)

    def union(self, arms: list[Node]) -> UnionNode:
        out: dict[str, None] = {}
        for a in arms:
            for v in a.out_vars:
                out.setdefault(v)
        return UnionNode(
            node_id=self.nid(),
            arms=tuple(arms),
            out_vars=tuple(out),
            est=max(sum(a.est for a in arms), 0),
        )

    def filter(self, child: Node, expr: LExpr) -> Filter:
        return Filter(
            node_id=self.nid(),
            child=child,
            expr=expr,
            out_vars=child.out_vars,
            est=child.est,
        )


def _fold_onto(b: _Builder, node: Node, scans: list[Scan], attach=None) -> Node:
    """Greedy smallest-first fold of ``scans`` onto an accumulated ``node``,
    preferring connected scans; optionally calls ``attach(node) -> node``
    after every step so filters apply as soon as their variables are in
    scope."""
    remaining = sorted(scans, key=lambda s: (s.est, s.node_id))
    while remaining:
        i = next(
            (
                j
                for j, s in enumerate(remaining)
                if not s.out_vars or not node.out_vars
                or any(v in node.out_vars for v in s.out_vars)
            ),
            0,  # nothing connected: cross-join the smallest remaining
        )
        node = b.combine(node, remaining.pop(i))
        if attach is not None:
            node = attach(node)
    return node


def _fold_bgp(b: _Builder, scans: list[Scan], attach=None) -> Node:
    """Greedy smallest-first fold of a whole BGP."""
    remaining = sorted(scans, key=lambda s: (s.est, s.node_id))
    node: Node = remaining.pop(0)
    if attach is not None:
        node = attach(node)
    return _fold_onto(b, node, remaining, attach)


def plan_query(store: TripleStore, q: A.SelectQuery) -> Plan:
    """Build the operator tree for ``q`` over ``store``.  Cardinalities come
    from the representative query's constants; signature-equal queries reuse
    the plan (the executor's capacity feedback absorbs the variance)."""
    b = _Builder()
    flat = q.all_patterns()
    ests = _scan_estimates(store, flat)

    # lower filters once (slot assignment is query-structure-deterministic)
    cursor = [0]
    lowered = tuple(_lower_expr(f, cursor) for f in q.filters)
    n_filter_ops = cursor[0]
    eventually_bound = set(q.scope())
    required_vars = {v for pat in q.patterns for v in pat.variables}
    pending = [
        (e, tuple(A.expr_variables(f))) for e, f in zip(lowered, q.filters)
    ]

    def ready(filter_vars: tuple[str, ...], scope: tuple[str, ...]) -> bool:
        return all(
            (v in scope) or (v not in eventually_bound) for v in filter_vars
        )

    def attach_required(node: Node) -> Node:
        # inside the required fold only filters that never touch union- or
        # optional-bound variables may run (those can still add
        # rows/bindings these filters must see)
        changed = True
        while changed:
            changed = False
            for i, (expr, fvars) in enumerate(pending):
                if all(
                    v in required_vars or v not in eventually_bound
                    for v in fvars
                ) and ready(fvars, node.out_vars):
                    node = b.filter(node, expr)
                    pending.pop(i)
                    changed = True
                    break
        return node

    def attach_ready(node: Node) -> Node:
        # filters whose variables just became bound attach now
        for i in range(len(pending) - 1, -1, -1):
            expr, fvars = pending[i]
            if ready(fvars, node.out_vars):
                node = b.filter(node, expr)
                pending.pop(i)
        return node

    node: Node | None = None
    if q.patterns:
        required_scans = [
            b.scan(pos, pat, ests[pos])
            for pos, pat in enumerate(q.patterns)
        ]
        node = _fold_bgp(b, required_scans, attach=attach_required)

    pos0 = len(q.patterns)
    if q.unions:
        arm_nodes: list[Node] = []
        for arm in q.unions:
            ascans = [
                b.scan(pos0 + k, pat, ests[pos0 + k])
                for k, pat in enumerate(arm)
            ]
            pos0 += len(arm)
            if node is None:
                arm_nodes.append(_fold_bgp(b, ascans))
            else:
                # shared-scan reuse: every arm folds onto the SAME required
                # subtree object; the executor memoizes it per dispatch
                arm_nodes.append(_fold_onto(b, node, ascans))
        node = b.union(arm_nodes)
        node = attach_ready(node)
    assert node is not None  # parse_select guarantees patterns or unions

    for group in q.optionals:
        gscans = [
            b.scan(pos0 + k, pat, ests[pos0 + k])
            for k, pat in enumerate(group)
        ]
        pos0 += len(group)
        if len(gscans) == 1:
            # the common OPTIONAL shape: one pattern, bind-joined with
            # unmatched-row backfill (never materialized on its own)
            node = b.combine(node, gscans[0], "left")
        else:
            # multi-pattern group: a bind-join chain off the required
            # scope — tag left rows, chain the group's patterns as inner
            # joins anchored on the left bindings, then append unmatched
            # left rows (group variables unbound)
            rowid = f"@row{node.node_id}"
            tagged = TagRows(
                node_id=b.nid(),
                child=node,
                var=rowid,
                out_vars=node.out_vars + (rowid,),
                est=node.est,
            )
            chain = _fold_onto(b, tagged, gscans)
            gvars = tuple(
                v for v in chain.out_vars
                if v not in tagged.out_vars
            )
            node = LeftFinish(
                node_id=b.nid(),
                left=tagged,
                right=chain,
                rowid=rowid,
                out_vars=node.out_vars + gvars,
                est=max(chain.est + node.est, 0),
            )
        node = attach_ready(node)

    # any filter still pending mentions only never-bound variables
    for expr, _ in pending:
        node = b.filter(node, expr)

    out_vars = q.out_vars()
    agg_vars = (q.agg.alias,) if q.agg else ()
    if q.agg is not None or q.group_by:
        node = Group(
            node_id=b.nid(),
            child=node,
            keys=q.group_by,
            count_var=q.agg.var if q.agg else None,
            alias=q.agg.alias if q.agg else None,
            out_vars=out_vars,
            est=node.est if q.group_by else 1,
        )
    else:
        node = Project(
            node_id=b.nid(), child=node, out_vars=out_vars, est=node.est
        )
        if q.distinct:
            node = Distinct(
                node_id=b.nid(), child=node, out_vars=out_vars, est=node.est
            )
    if q.order_by:
        node = OrderBy(
            node_id=b.nid(),
            child=node,
            keys=tuple((v, asc, v in agg_vars) for v, asc in q.order_by),
            out_vars=out_vars,
            est=node.est,
        )
    elif not q.distinct:
        # Distinct leaves rows sorted; otherwise sort explicitly so results
        # are deterministically ordered by term id (count columns by value);
        # the executor elides it when the tracked sortedness already matches
        node = Sort(node_id=b.nid(), child=node, out_vars=out_vars, est=node.est)
    if q.limit is not None:
        node = Limit(
            node_id=b.nid(),
            child=node,
            n=q.limit,
            out_vars=out_vars,
            est=min(node.est, q.limit),
        )
    # pattern readers must be listed in pipeline (fold) order for the
    # consts matrix; recover that order from the tree — which is a DAG
    # where union arms / optional chains share subtrees, so visit each
    # node once
    ordered: list[TUnion[Scan, BindJoin]] = []
    seen: set[int] = set()

    def collect(n: Node) -> None:
        if n.node_id in seen:
            return
        seen.add(n.node_id)
        for c in _children(n):
            collect(c)
        if isinstance(n, (Scan, BindJoin)):
            ordered.append(n)

    collect(node)
    term_order_keys = bool(q.order_by) and any(
        v not in agg_vars for v, _ in q.order_by
    )
    return Plan(
        sig=q.signature(),
        root=node,
        scans=tuple(ordered),
        n_filter_ops=n_filter_ops,
        has_filters=bool(q.filters),
        needs_values=bool(q.filters) or term_order_keys,
        agg_vars=agg_vars,
        global_agg_alias=(
            q.agg.alias if (q.agg is not None and not q.group_by) else None
        ),
    )


FASTPATH_MAX_READERS = 3


def fastpath_chain(plan: Plan) -> tuple | None:
    """Structural eligibility for the small-batch fused scan-join fast
    path (``repro_torch.serve.fastpath``): a pure ``Scan → BindJoin*`` chain of
    at most :data:`FASTPATH_MAX_READERS` readers — inner joins only, no
    repeated-variable patterns, no filters / aggregates / DISTINCT /
    ORDER BY / UNION / OPTIONAL — under the standard ``Project → Sort
    [→ Limit]`` tail.  Returns the reader nodes in pipeline order (they
    must coincide with ``plan.scans`` so consts rows line up), or None
    when the plan needs the general executor."""
    if plan.has_filters or plan.n_filter_ops or plan.agg_vars:
        return None
    node = plan.root
    if isinstance(node, Limit):
        node = node.child
    if not isinstance(node, Sort):
        return None
    node = node.child
    if not isinstance(node, Project):
        return None
    node = node.child
    readers: list = []
    while isinstance(node, BindJoin):
        if node.kind != "inner" or node.eq_pairs or not node.free_slots:
            return None
        readers.append(node)
        node = node.left
    if not isinstance(node, Scan):
        return None
    if node.eq_pairs or not node.out_vars:
        return None
    readers.append(node)
    readers.reverse()
    if len(readers) > FASTPATH_MAX_READERS:
        return None
    if tuple(r.node_id for r in readers) != tuple(
        s.node_id for s in plan.scans
    ):
        return None
    return tuple(readers)


def encode_scan_consts(
    store: TripleStore, plan: Plan, q: A.SelectQuery
) -> np.ndarray:
    """Per-query constant term ids, one (s, p, o) row per plan scan: ``-1``
    marks a variable slot, ``-2`` a constant the store has never seen (its
    range scan comes back empty).  ``store`` may be any store-like object
    with ``term_id`` — in particular a live ``OverlayView``, whose combined
    term table resolves overlay-only constants (planning itself always
    runs on the base store; the executor's capacity feedback absorbs the
    delta rows the estimates never saw)."""
    flat = q.all_patterns()
    out = np.full((len(plan.scans), 3), -1, np.int32)
    for i, scan in enumerate(plan.scans):
        pat = flat[scan.pattern_pos]
        for pos in scan.const_slots:
            tid = store.term_id(pat.slots[pos])
            out[i, pos] = -2 if tid is None else tid
    return out


# ---------------------------------------------------------------------------
# shard routing — which shards can answer a query (repro_torch.shard coordinator)
# ---------------------------------------------------------------------------


def routing_subject(q: A.SelectQuery) -> str | None:
    """The rendered constant subject every pattern of ``q`` is anchored on,
    or ``None``.  When every pattern (required, UNION arms, OPTIONAL
    groups) reads the *same constant* subject, every solution's matched
    triples share that subject — so under subject-hash partitioning the
    whole query lives on exactly one shard and the coordinator routes it
    there instead of scattering."""
    subjects = {p.slots[0] for p in q.all_patterns()}
    if len(subjects) == 1:
        s = next(iter(subjects))
        if not s.startswith("?"):
            return s
    return None


def colocated_subjects(q: A.SelectQuery) -> bool:
    """True when every solution of ``q`` matches triples that all share one
    subject value — the condition under which scatter/gather is exact:
    each solution is found on the one shard holding that subject, and on
    no other (so the gathered union is the unsharded bag).  Holds for a
    single pattern (one triple per solution) and for star shapes where
    every pattern reads the same subject variable or the same constant.
    Chains (``?s <p> ?o . ?o <q> ?r``) join across subjects and are NOT
    colocated — the coordinator answers them by gathering each pattern's
    matches and combining host-side instead."""
    pats = q.all_patterns()
    if len(pats) <= 1:
        return True
    return len({p.slots[0] for p in pats}) == 1
