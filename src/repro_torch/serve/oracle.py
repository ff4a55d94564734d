"""Naive full-algebra oracle — the tests' ground truth for ``repro_torch.serve``.

Extends the BGP-only set-scan oracle (``repro_torch.kg.query.oracle_solve``) to
the whole SPARQL-lite algebra: UNION, OPTIONAL, FILTER, projection,
GROUP BY + COUNT, DISTINCT, ORDER BY and LIMIT.  Everything is quadratic,
string-based Python over the *decoded* triple list — it deliberately
shares no code with the indexed, jitted engine (same philosophy as the kg
oracle), except the single number-parsing rule
(:func:`repro_torch.serve.values.parse_number`), which is a semantic
definition, not an implementation detail.

Rows come back deterministically ordered — sorted by rendered term per
column, unbound (``None``) first, COUNT columns by integer value — which
is exactly the engine's term-id order, because term ids are ranks of
rendered term strings.  ``ORDER BY`` sorts by the value-typed total order
(unbound < IRIs < numeric literals by value < other literals by body,
ties by rendered term), descending keys fully reversed, with the default
deterministic order as the tie-break — mirroring the engine's
``order_rank`` side table.
"""

from __future__ import annotations

from repro_torch.data.terms import unescape_literal
from repro_torch.kg.query import TriplePattern
from repro_torch.kg.store import TripleStore
from repro_torch.serve import algebra as A
from repro_torch.serve.values import parse_number


def _decoded_triples(store: TripleStore) -> list[tuple[str, str, str]]:
    rt = getattr(store, "rendered_triples", None)
    if rt is not None:  # a LiveStore: its surviving base ⊕ delta triples
        return list(rt())
    return [
        (
            store.decode_term(int(store.s[i])),
            store.decode_term(int(store.p[i])),
            store.decode_term(int(store.o[i])),
        )
        for i in range(store.n_triples)
    ]


def match_pattern(
    triples: list[tuple[str, str, str]], pat: TriplePattern
) -> list[dict[str, str]]:
    """One pattern against every triple: the solution mappings (variable ->
    rendered term), one per matching triple."""
    out = []
    for t in triples:
        env: dict[str, str] | None = {}
        for term, value in zip(pat.slots, t):
            if term.startswith("?"):
                if env.get(term, value) != value:
                    env = None
                    break
                env[term] = value
            elif term != value:
                env = None
                break
        if env is not None:
            out.append(env)
    return out


def _join_envs(
    solutions: list[dict[str, str]], rows: list[dict[str, str]]
) -> list[dict[str, str]]:
    """Pairwise compatible merge (the brute-force conjunctive join)."""
    return [
        {**env, **row}
        for env in solutions
        for row in rows
        if all(env.get(v, row[v]) == row[v] for v in row)
    ]


def _is_literal(term: str | None) -> bool:
    return term is not None and term.startswith('"')


def _body(term: str) -> str:
    return unescape_literal(term[1:-1])


def _numeric(term: str | None) -> float | None:
    if not _is_literal(term):
        return None
    return parse_number(_body(term))


def _operand_term(op: A.Operand, env: dict[str, str]) -> str | None:
    if isinstance(op, A.Var):
        return env.get(op.name)
    if isinstance(op, A.TermConst):
        return op.term
    raise TypeError(op)


def _eval_cmp(c: A.Cmp, env: dict[str, str]) -> bool:
    import operator

    rel = {
        "<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "=": operator.eq, "!=": operator.ne,
    }[c.op]
    # numeric comparison: any NumConst operand
    if isinstance(c.lhs, A.NumConst) or isinstance(c.rhs, A.NumConst):
        def num(op: A.Operand) -> float | None:
            if isinstance(op, A.NumConst):
                return op.value
            return _numeric(_operand_term(op, env))

        lv, rv = num(c.lhs), num(c.rhs)
        return lv is not None and rv is not None and rel(lv, rv)
    if c.op in ("=", "!="):
        # term identity (both sides must be bound; type errors are false)
        lt = _operand_term(c.lhs, env)
        rt = _operand_term(c.rhs, env)
        return lt is not None and rt is not None and rel(lt, rt)
    if isinstance(c.lhs, A.TermConst) or isinstance(c.rhs, A.TermConst):
        # string-order comparison against a quoted literal constant
        def body(op: A.Operand) -> str | None:
            t = _operand_term(op, env)
            return _body(t) if _is_literal(t) else None

        lb, rb = body(c.lhs), body(c.rhs)
        return lb is not None and rb is not None and rel(lb, rb)
    # var-vs-var ordering: numeric when both numeric, else literal-body
    # order when both are literals, else false
    lt = _operand_term(c.lhs, env)
    rt = _operand_term(c.rhs, env)
    ln, rn = _numeric(lt), _numeric(rt)
    if ln is not None and rn is not None:
        return rel(ln, rn)
    if _is_literal(lt) and _is_literal(rt):
        return rel(_body(lt), _body(rt))
    return False


def _eval_expr(e: A.Expr, env: dict[str, str]) -> bool:
    if isinstance(e, A.Cmp):
        return _eval_cmp(e, env)
    if isinstance(e, A.Bound):
        return env.get(e.var.name) is not None
    if isinstance(e, A.Not):
        return not _eval_expr(e.expr, env)
    if isinstance(e, A.And):
        return _eval_expr(e.lhs, env) and _eval_expr(e.rhs, env)
    if isinstance(e, A.Or):
        return _eval_expr(e.lhs, env) or _eval_expr(e.rhs, env)
    raise TypeError(e)


def _default_cell_key(cell):
    """The engine's per-column deterministic order: unbound first, then
    rendered-term (= term id) order; COUNT cells are plain ints and order
    by value.  Columns are homogeneous, so the mixed tuple never compares
    int against str within one column."""
    if cell is None:
        return (0, 0.0, "")
    if isinstance(cell, int):
        return (1, float(cell), "")
    return (1, 0.0, cell)


def _orderby_cell_key(cell):
    """The value-typed ORDER BY total order (``values.order_rank``):
    unbound < IRIs (rendered) < numeric literals (value, rendered tie) <
    other literals (body, rendered tie); COUNT cells by integer value."""
    if cell is None:
        return (-1, 0.0, ())
    if isinstance(cell, int):
        return (0, float(cell), ())
    if not _is_literal(cell):
        return (0, 0.0, (cell,))
    v = _numeric(cell)
    if v is not None:
        return (1, v, (cell,))
    return (2, 0.0, (_body(cell), cell))


def combine_pattern_solutions(
    q: A.SelectQuery, pattern_sols: "list[list[dict[str, str]]]"
) -> list[tuple]:
    """Everything past per-pattern matching: join the required BGP, fold
    UNION arms, left-join OPTIONAL groups, filter, group/aggregate,
    project, dedupe, order and limit.  ``pattern_sols`` holds each
    pattern's solution mappings, aligned with ``q.all_patterns()`` order.

    Factored out of :func:`oracle_select` because the shard coordinator
    reuses it: a query whose patterns do not share one subject cannot be
    answered by scattering the whole query (a solution's triples may span
    shards), but each *pattern's* matches partition cleanly — so the
    coordinator gathers per-pattern solutions from every shard and
    combines them here, host-side, with exactly the oracle's semantics."""
    it = iter(pattern_sols)
    sols: list[dict[str, str]] = [{}]
    for _pat in q.patterns:
        sols = _join_envs(sols, next(it))
    if q.unions:
        arm_sols: list[dict[str, str]] = []
        for arm in q.unions:
            asols: list[dict[str, str]] = [{}]
            for _pat in arm:
                asols = _join_envs(asols, next(it))
            arm_sols.extend(asols)
        sols = _join_envs(sols, arm_sols)
    for group in q.optionals:
        gsols: list[dict[str, str]] = [{}]
        for _pat in group:
            gsols = _join_envs(gsols, next(it))
        joined: list[dict[str, str]] = []
        for env in sols:
            hits = [
                g
                for g in gsols
                if all(env.get(v, g[v]) == g[v] for v in g)
            ]
            if hits:
                joined.extend({**env, **g} for g in hits)
            else:
                joined.append(env)
        sols = joined
    sols = [
        env for env in sols if all(_eval_expr(f, env) for f in q.filters)
    ]
    out_vars = q.out_vars()
    if q.agg is not None or q.group_by:
        groups: dict[tuple, list[dict[str, str]]] = {}
        for env in sols:
            key = tuple(env.get(k) for k in q.group_by)
            groups.setdefault(key, []).append(env)
        if not q.group_by and not groups:
            groups[()] = []  # the global group: one row over zero solutions
        alias = q.agg.alias if q.agg else None
        cvar = q.agg.var if q.agg else None
        rows = []
        for key, members in groups.items():
            by_key = dict(zip(q.group_by, key))
            row = []
            for v in out_vars:
                if v == alias:
                    row.append(
                        len(members)
                        if cvar is None
                        else sum(1 for m in members if m.get(cvar) is not None)
                    )
                else:
                    row.append(by_key.get(v))
            rows.append(tuple(row))
    else:
        rows = [tuple(env.get(v) for v in out_vars) for env in sols]
        if q.distinct:
            rows = list(dict.fromkeys(rows))
    # the default deterministic order doubles as the ORDER BY tie-break
    rows.sort(key=lambda r: tuple(_default_cell_key(c) for c in r))
    if q.order_by:
        # stable sorts applied last key first realize the multi-direction
        # lexicographic order (exactly the engine's variadic key sort)
        for var, asc in reversed(q.order_by):
            i = out_vars.index(var)
            rows.sort(key=lambda r: _orderby_cell_key(r[i]), reverse=not asc)
    if q.limit is not None:
        rows = rows[: q.limit]
    return rows


def oracle_select(store: TripleStore, q: A.SelectQuery) -> list[tuple]:
    """Evaluate ``q`` naively; rows are tuples of rendered terms (``None``
    for unbound, plain ints for COUNT columns) over ``q.out_vars()``,
    deterministically sorted, with GROUP BY / DISTINCT / ORDER BY / LIMIT
    applied — directly comparable to ``BatchResult.rows(i)``."""
    triples = _decoded_triples(store)
    return combine_pattern_solutions(
        q, [match_pattern(triples, pat) for pat in q.all_patterns()]
    )
