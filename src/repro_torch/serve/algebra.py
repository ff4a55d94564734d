"""SPARQL-lite query algebra — the IR between the wire and the planner.

A query is a :class:`SelectQuery`: a required basic graph pattern, an
optional multi-arm ``UNION`` block (each arm itself a BGP), zero or more
``OPTIONAL`` groups (each itself a BGP), zero or more ``FILTER``
expressions, a projection (``SELECT ?a ?b`` / ``SELECT *`` / aggregate
``(COUNT(?v) AS ?n)``), and optional ``DISTINCT`` / ``GROUP BY`` /
``ORDER BY`` / ``LIMIT n`` modifiers.  The planner (``repro_torch.serve.plan``)
turns it into an operator tree — ``Scan`` / ``Join`` / ``LeftJoin`` /
``Union`` / ``Filter`` / ``Project`` / ``Group`` / ``Distinct`` /
``OrderBy`` / ``Limit`` — and the executor (``repro_torch.serve.exec``) lowers
that tree to one fused jitted dispatch.

Semantics of the new operators over our untyped plain literals:

* ``{ A } UNION { B } [UNION { C } ...]`` — bag union of the arms' solution
  mappings, joined with the required BGP; a variable an arm does not bind
  is unbound in that arm's rows.  Variables bound in *some but not all*
  arms may not be re-used by OPTIONAL groups (plan-time error — joining on
  a maybe-unbound column needs SPARQL's full compatibility semantics).
* ``ORDER BY ?a DESC(?b)`` — *value-typed* ordering, not term-id order:
  unbound < IRIs (by rendered term) < numeric literals (by numeric value)
  < other literals (by raw body), ties broken by rendered term; ``DESC``
  reverses the whole key (so unbound sorts last).  Keys must be projected
  variables; remaining columns tie-break in term-id order, so results stay
  deterministic.
* ``GROUP BY ?g`` + ``(COUNT(?v) AS ?n)`` / ``(COUNT(*) AS ?n)`` — one row
  per distinct group-key tuple; ``COUNT(?v)`` counts rows where ``?v`` is
  bound, ``COUNT(*)`` counts all rows.  Every selected non-aggregate
  variable must be a group key.  An aggregate without ``GROUP BY`` is one
  global group (one row even over zero solutions).  Count values travel as
  plain integers, not terms — see ``BatchResult.agg_vars``.

Filter expressions cover the serving-relevant SPARQL core: comparisons
(``<  <=  >  >=  =  !=``) between variables and constants, ``bound(?x)``,
``!``, ``&&`` and ``||``.  Semantics over our untyped plain literals:

* an *unquoted number* operand compares numerically — a term participates
  iff its literal body parses as a float (else the comparison errors out to
  false, as SPARQL type errors do);
* a *quoted literal* operand compares by raw literal body (codepoint
  order) for the ordering operators, and by term identity for ``=``/``!=``;
* an ``<iri>`` operand compares by term identity (``=``/``!=`` only);
* variable-vs-variable ordering compares numerically when both terms are
  numeric, by literal body when both are literals, else false;
* any comparison over an unbound variable (a ``LeftJoin`` miss or a
  partial UNION arm) is false — only ``bound()`` / ``!bound()`` observe
  unboundness.

Everything here is host-side structure; no jax.  The structural
*signature* of a query (constants abstracted away) is what the server
batches on — see :func:`SelectQuery.signature`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Union

from repro_torch.data.terms import canonical_term, unescape_literal
from repro_torch.kg.query import TriplePattern, parse_bgp

# ---------------------------------------------------------------------------
# filter expression IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Var:
    name: str  # includes the '?'


@dataclasses.dataclass(frozen=True)
class NumConst:
    value: float


@dataclasses.dataclass(frozen=True)
class TermConst:
    term: str  # canonical rendered N-Triples term: <iri> or "literal"

    @property
    def is_literal(self) -> bool:
        return self.term.startswith('"')

    @property
    def body(self) -> str:
        """Raw (unescaped) literal body; only valid for literals."""
        return unescape_literal(self.term[1:-1])


Operand = Union[Var, NumConst, TermConst]

CMP_OPS = ("<=", ">=", "!=", "<", ">", "=")  # longest-match order


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str
    lhs: Operand
    rhs: Operand


@dataclasses.dataclass(frozen=True)
class Bound:
    var: Var


@dataclasses.dataclass(frozen=True)
class Not:
    expr: "Expr"


@dataclasses.dataclass(frozen=True)
class And:
    lhs: "Expr"
    rhs: "Expr"


@dataclasses.dataclass(frozen=True)
class Or:
    lhs: "Expr"
    rhs: "Expr"


Expr = Union[Cmp, Bound, Not, And, Or]


def expr_variables(e: Expr) -> tuple[str, ...]:
    """Variables an expression mentions, in first-appearance order."""
    out: dict[str, None] = {}

    def walk(x) -> None:
        if isinstance(x, Cmp):
            for side in (x.lhs, x.rhs):
                if isinstance(side, Var):
                    out.setdefault(side.name)
        elif isinstance(x, Bound):
            out.setdefault(x.var.name)
        elif isinstance(x, Not):
            walk(x.expr)
        elif isinstance(x, (And, Or)):
            walk(x.lhs)
            walk(x.rhs)

    walk(e)
    return tuple(out)


def _expr_signature(e: Expr):
    """Structure with constant *values* abstracted (kinds kept — a numeric
    and a string comparison lower differently)."""
    if isinstance(e, Cmp):
        def opsig(x):
            if isinstance(x, Var):
                return ("var", x.name)
            if isinstance(x, NumConst):
                return ("num",)
            return ("lit",) if x.is_literal else ("iri",)

        return ("cmp", e.op, opsig(e.lhs), opsig(e.rhs))
    if isinstance(e, Bound):
        return ("bound", e.var.name)
    if isinstance(e, Not):
        return ("not", _expr_signature(e.expr))
    return (
        "and" if isinstance(e, And) else "or",
        _expr_signature(e.lhs),
        _expr_signature(e.rhs),
    )


# ---------------------------------------------------------------------------
# the query
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Count:
    """``COUNT(?v)`` / ``COUNT(*)`` with its ``AS ?alias`` output name."""

    var: str | None  # None = COUNT(*)
    alias: str


@dataclasses.dataclass(frozen=True)
class SelectQuery:
    patterns: tuple[TriplePattern, ...]                   # required BGP
    optionals: tuple[tuple[TriplePattern, ...], ...] = ()
    filters: tuple[Expr, ...] = ()
    select: tuple[str, ...] | None = None                 # None = SELECT *
    distinct: bool = False
    limit: int | None = None
    unions: tuple[tuple[TriplePattern, ...], ...] = ()    # UNION arms (0 or >= 2)
    group_by: tuple[str, ...] = ()
    agg: Count | None = None                              # one COUNT, or None
    order_by: tuple[tuple[str, bool], ...] = ()           # (var, ascending)

    def scope(self) -> tuple[str, ...]:
        """All in-scope variables — required BGP first, then UNION arms,
        then optionals, in first-appearance order."""
        out: dict[str, None] = {}
        for pat in self.patterns:
            for v in pat.variables:
                out.setdefault(v)
        for arm in self.unions:
            for pat in arm:
                for v in pat.variables:
                    out.setdefault(v)
        for group in self.optionals:
            for pat in group:
                for v in pat.variables:
                    out.setdefault(v)
        return tuple(out)

    def union_always_vars(self) -> frozenset[str]:
        """Variables bound by *every* UNION arm — always bound in the
        union block's rows, so downstream joins may key on them."""
        if not self.unions:
            return frozenset()
        sets = [
            {v for pat in arm for v in pat.variables} for arm in self.unions
        ]
        return frozenset(set.intersection(*sets))

    def union_partial_vars(self) -> frozenset[str]:
        """Variables bound in some but not all UNION arms — maybe-unbound
        after the union, like OPTIONAL-only variables."""
        if not self.unions:
            return frozenset()
        all_vars = {v for arm in self.unions for pat in arm for v in pat.variables}
        return frozenset(all_vars - self.union_always_vars())

    def out_vars(self) -> tuple[str, ...]:
        """The projected variable list (``SELECT *`` = full scope); for
        aggregate queries the COUNT alias appears at its SELECT position."""
        return self.scope() if self.select is None else self.select

    def all_patterns(self) -> tuple[TriplePattern, ...]:
        """Required + union-arm + optional patterns flattened, in source
        order — the index space ``plan.Scan.pattern_pos`` refers to."""
        flat = list(self.patterns)
        for arm in self.unions:
            flat.extend(arm)
        for group in self.optionals:
            flat.extend(group)
        return tuple(flat)

    def signature(self):
        """Hashable structural identity with constants abstracted: queries
        with equal signatures share a plan, a compiled pipeline, and a
        server micro-batch — only their constant ids differ."""

        def patsig(p: TriplePattern):
            return tuple(t if t.startswith("?") else "<const>" for t in p.slots)

        return (
            tuple(patsig(p) for p in self.patterns),
            tuple(tuple(patsig(p) for p in a) for a in self.unions),
            tuple(tuple(patsig(p) for p in g) for g in self.optionals),
            tuple(_expr_signature(f) for f in self.filters),
            self.select,
            self.distinct,
            self.group_by,
            (self.agg.var, self.agg.alias) if self.agg else None,
            self.order_by,
            # only limit *presence* is structural: the value rides along as
            # a per-query runtime operand, so LIMIT 5 and LIMIT 50 share a
            # plan, a compiled pipeline, and a server micro-batch
            self.limit is not None,
        )


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<var>\?[A-Za-z_]\w*)
      | (?P<iri><[^>]*>)
      | (?P<lit>"(?:[^"\\]|\\.)*")
      | (?P<num>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
      | (?P<word>[A-Za-z]\w*)
      | (?P<op><=|>=|!=|&&|\|\||[<>=!(){}.*])
    )""",
    re.VERBOSE,
)

class _Tokens:
    def __init__(self, text: str):
        self.text = text
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise ValueError(f"cannot tokenize query at: {text[pos:pos+40]!r}")
                break
            pos = m.end()
            self.toks.append((m.lastgroup, m.group().strip()))
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of query")
        self.i += 1
        return t

    def take_word(self, word: str) -> bool:
        t = self.peek()
        if t and t[0] == "word" and t[1].lower() == word:
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: str | None = None) -> str:
        k, v = self.next()
        if k != kind or (value is not None and v != value):
            raise ValueError(f"expected {value or kind}, got {v!r}")
        return v

    def expect_var(self, what: str) -> str:
        k, v = self.next()
        if k != "var":
            raise ValueError(f"{what} takes a variable, got {v!r}")
        return v


def _parse_operand(tk: _Tokens) -> Operand:
    kind, v = tk.next()
    if kind == "var":
        return Var(v)
    if kind == "num":
        return NumConst(float(v))
    if kind == "iri":
        return TermConst(canonical_term(v))
    if kind == "lit":
        return TermConst(canonical_term(v))
    raise ValueError(f"expected a variable or constant in FILTER, got {v!r}")


def _parse_unary(tk: _Tokens) -> Expr:
    t = tk.peek()
    if t and t[1] == "!":
        tk.next()
        return Not(_parse_unary(tk))
    if t and t[1] == "(":
        tk.next()
        e = _parse_expr(tk)
        tk.expect("op", ")")
        return e
    if t and t[0] == "word" and t[1].lower() == "bound":
        tk.next()
        tk.expect("op", "(")
        v = tk.expect_var("bound()")
        tk.expect("op", ")")
        return Bound(Var(v))
    lhs = _parse_operand(tk)
    t = tk.peek()
    if not t or t[1] not in CMP_OPS:
        raise ValueError(f"expected a comparison operator after {lhs}")
    op = tk.next()[1]
    rhs = _parse_operand(tk)
    if not (isinstance(lhs, Var) or isinstance(rhs, Var)):
        raise ValueError("FILTER comparison needs at least one variable")
    if op in ("<", "<=", ">", ">="):
        for side in (lhs, rhs):
            if isinstance(side, TermConst) and not side.is_literal:
                raise ValueError("IRIs only support = / != comparisons")
    return Cmp(op, lhs, rhs)


def _parse_and(tk: _Tokens) -> Expr:
    e = _parse_unary(tk)
    while (t := tk.peek()) and t[1] == "&&":
        tk.next()
        e = And(e, _parse_unary(tk))
    return e


def _parse_expr(tk: _Tokens) -> Expr:
    e = _parse_and(tk)
    while (t := tk.peek()) and t[1] == "||":
        tk.next()
        e = Or(e, _parse_and(tk))
    return e


def _parse_triple(tk: _Tokens) -> TriplePattern:
    slots = []
    for _ in range(3):
        kind, v = tk.next()
        if kind == "var":
            slots.append(v)
        elif kind in ("iri", "lit"):
            slots.append(canonical_term(v))
        else:
            raise ValueError(f"expected a term in a triple pattern, got {v!r}")
    t = tk.peek()
    if t and t[1] == ".":
        tk.next()
    return TriplePattern(*slots)


def _parse_braced_bgp(tk: _Tokens, what: str) -> tuple[TriplePattern, ...]:
    """``{ triple* }`` — a UNION arm (already past the opening brace when
    called for the first arm; this helper expects the brace)."""
    tk.expect("op", "{")
    pats: list[TriplePattern] = []
    while (u := tk.peek()) and u[1] != "}":
        pats.append(_parse_triple(tk))
    tk.expect("op", "}")
    if not pats:
        raise ValueError(f"empty {what}")
    return tuple(pats)


def _parse_group(tk: _Tokens):
    patterns: list[TriplePattern] = []
    unions: tuple[tuple[TriplePattern, ...], ...] = ()
    optionals: list[tuple[TriplePattern, ...]] = []
    filters: list[Expr] = []
    while (t := tk.peek()) and t[1] != "}":
        if t[0] == "word" and t[1].lower() == "optional":
            tk.next()
            optionals.append(_parse_braced_bgp(tk, "OPTIONAL group"))
        elif t[0] == "word" and t[1].lower() == "filter":
            tk.next()
            tk.expect("op", "(")
            filters.append(_parse_expr(tk))
            tk.expect("op", ")")
        elif t[1] == "{":
            arms = [_parse_braced_bgp(tk, "UNION arm")]
            while tk.take_word("union"):
                arms.append(_parse_braced_bgp(tk, "UNION arm"))
            if len(arms) < 2:
                raise ValueError(
                    "a braced group must be a UNION of two or more arms"
                )
            if unions:
                raise ValueError("at most one UNION block per query")
            unions = tuple(arms)
        else:
            patterns.append(_parse_triple(tk))
    return tuple(patterns), unions, tuple(optionals), tuple(filters)


def _parse_select_clause(tk: _Tokens):
    """The projection: ``*``, or a mix of variables and one
    ``(COUNT(?v|*) AS ?alias)`` aggregate."""
    if (t := tk.peek()) and t[1] == "*":
        tk.next()
        return None, None
    names: list[str] = []
    agg: Count | None = None
    while (t := tk.peek()):
        if t[0] == "var":
            names.append(tk.next()[1])
        elif t[1] == "(":
            tk.next()
            if not tk.take_word("count"):
                raise ValueError("only (COUNT(...) AS ?x) aggregates are supported")
            tk.expect("op", "(")
            if (u := tk.peek()) and u[1] == "*":
                tk.next()
                cvar = None
            else:
                cvar = tk.expect_var("COUNT()")
            tk.expect("op", ")")
            if not tk.take_word("as"):
                raise ValueError("COUNT(...) needs AS ?alias")
            alias = tk.expect_var("AS")
            tk.expect("op", ")")
            if agg is not None:
                raise ValueError("at most one COUNT aggregate per query")
            agg = Count(var=cvar, alias=alias)
            names.append(alias)
        else:
            break
    if not names:
        raise ValueError("SELECT needs a variable list or *")
    return tuple(dict.fromkeys(names)), agg


def parse_select(text: str) -> SelectQuery:
    """Parse a SPARQL-lite query.  Two accepted forms:

    * ``SELECT [DISTINCT] ?a ?b|(COUNT(?v|*) AS ?n)|* WHERE { ... }
      [GROUP BY ?g ...] [ORDER BY ?a|ASC(?a)|DESC(?a) ...] [LIMIT n]``
      where the group holds triple patterns, one ``{ ... } UNION { ... }``
      block, ``OPTIONAL { ... }`` blocks and ``FILTER (...)`` expressions;
    * a bare BGP (``'?s <p> ?o . ?o <q> "v"'``) — shorthand for
      ``SELECT * WHERE { ... }``.
    """
    stripped = text.lstrip()
    if not re.match(r"(?i)select\b", stripped):
        return SelectQuery(patterns=tuple(parse_bgp(text)))
    tk = _Tokens(text)
    tk.take_word("select")
    distinct = tk.take_word("distinct")
    select, agg = _parse_select_clause(tk)
    if not tk.take_word("where"):
        raise ValueError("expected WHERE")
    tk.expect("op", "{")
    patterns, unions, optionals, filters = _parse_group(tk)
    tk.expect("op", "}")
    group_by: tuple[str, ...] = ()
    if tk.take_word("group"):
        if not tk.take_word("by"):
            raise ValueError("expected BY after GROUP")
        names: list[str] = []
        while (t := tk.peek()) and t[0] == "var":
            names.append(tk.next()[1])
        if not names:
            raise ValueError("GROUP BY needs at least one variable")
        group_by = tuple(dict.fromkeys(names))
    order_by: list[tuple[str, bool]] = []
    if tk.take_word("order"):
        if not tk.take_word("by"):
            raise ValueError("expected BY after ORDER")
        while (t := tk.peek()):
            if t[0] == "var":
                order_by.append((tk.next()[1], True))
            elif t[0] == "word" and t[1].lower() in ("asc", "desc"):
                asc = tk.next()[1].lower() == "asc"
                tk.expect("op", "(")
                v = tk.expect_var("ASC()/DESC()")
                tk.expect("op", ")")
                order_by.append((v, asc))
            else:
                break
        if not order_by:
            raise ValueError("ORDER BY needs at least one key")
    limit = None
    if tk.take_word("limit"):
        kind, v = tk.next()
        if kind != "num" or not re.fullmatch(r"\d+", v):
            raise ValueError(f"LIMIT takes a non-negative integer, got {v!r}")
        limit = int(v)
    if tk.peek() is not None:
        raise ValueError(f"trailing tokens after query: {tk.peek()[1]!r}")
    if not patterns and not unions:
        raise ValueError(
            "the required group needs at least one triple pattern or a UNION"
        )
    q = SelectQuery(
        patterns=patterns,
        optionals=optionals,
        filters=filters,
        select=select,
        distinct=distinct,
        limit=limit,
        unions=unions,
        group_by=group_by,
        agg=agg,
        order_by=tuple(order_by),
    )
    _validate(q)
    return q


def _validate(q: SelectQuery) -> None:
    """Plan-time rejections (an error here beats silently wrong answers):

    * optional groups may not join on variables that are maybe-unbound —
      bound only in *other* optional groups, or in some-but-not-all UNION
      arms — because that needs SPARQL's full compatibility semantics,
      which the fused pipeline deliberately does not implement;
    * aggregate queries must project only group keys and the COUNT alias;
    * ORDER BY keys must be projected variables.
    """
    required = set()
    for pat in q.patterns:
        required.update(pat.variables)
    always_bound = required | set(q.union_always_vars())
    partial_union = set(q.union_partial_vars())
    seen_optional: set[str] = set()
    for group in q.optionals:
        gvars = {v for pat in group for v in pat.variables}
        clash = (gvars & (seen_optional | partial_union)) - always_bound
        if clash:
            raise ValueError(
                "OPTIONAL groups may not share variables that are unbound in "
                f"the required pattern: {sorted(clash)}"
            )
        seen_optional |= gvars - always_bound
    scope = set(q.scope())
    if q.agg is not None or q.group_by:
        if q.select is None:
            raise ValueError("GROUP BY / aggregates need an explicit SELECT list")
        if q.distinct:
            raise ValueError("DISTINCT cannot be combined with GROUP BY / COUNT")
        alias = q.agg.alias if q.agg else None
        if alias is not None and alias in scope:
            raise ValueError(
                f"COUNT alias {alias} collides with an in-scope variable"
            )
        if alias is not None and alias in q.group_by:
            raise ValueError(f"COUNT alias {alias} cannot be a GROUP BY key")
        for v in q.select:
            if v != alias and v not in q.group_by:
                raise ValueError(
                    f"selected variable {v} must be a GROUP BY key "
                    "(or the COUNT alias)"
                )
    out = set(q.out_vars())
    for v, _asc in q.order_by:
        if v not in out:
            raise ValueError(f"ORDER BY key {v} is not a projected variable")


# ---------------------------------------------------------------------------
# serializer — SelectQuery -> parseable query text
# ---------------------------------------------------------------------------


def _operand_text(op: Operand) -> str:
    if isinstance(op, Var):
        return op.name
    if isinstance(op, NumConst):
        return repr(op.value)
    return op.term


def expr_text(e: Expr) -> str:
    """Serialize a filter expression back to FILTER grammar.  Fully
    parenthesized, so ``parse_select(to_text(q))`` rebuilds the same tree
    regardless of precedence."""
    if isinstance(e, Cmp):
        return f"{_operand_text(e.lhs)} {e.op} {_operand_text(e.rhs)}"
    if isinstance(e, Bound):
        return f"bound({e.var.name})"
    if isinstance(e, Not):
        return f"!({expr_text(e.expr)})"
    op = "&&" if isinstance(e, And) else "||"
    return f"({expr_text(e.lhs)}) {op} ({expr_text(e.rhs)})"


def _bgp_text(pats) -> str:
    return " . ".join(" ".join(p.slots) for p in pats)


def to_text(q: SelectQuery) -> str:
    """Serialize a query back to SPARQL-lite text; round-trips through
    :func:`parse_select` to an equal :class:`SelectQuery`.  The shard
    coordinator uses this to rewrite queries before scattering them
    (e.g. an aggregate query shards with ORDER BY / LIMIT stripped, so
    partial groups stay complete for the re-aggregating merge)."""
    sel = "*"
    if q.select is not None:
        parts = []
        for v in q.select:
            if q.agg is not None and v == q.agg.alias:
                cv = q.agg.var if q.agg.var is not None else "*"
                parts.append(f"(COUNT({cv}) AS {q.agg.alias})")
            else:
                parts.append(v)
        sel = " ".join(parts)
    body = []
    if q.patterns:
        body.append(_bgp_text(q.patterns))
    if q.unions:
        body.append(
            " UNION ".join("{ " + _bgp_text(arm) + " }" for arm in q.unions)
        )
    for group in q.optionals:
        body.append("OPTIONAL { " + _bgp_text(group) + " }")
    for f in q.filters:
        body.append(f"FILTER({expr_text(f)})")
    text = "SELECT "
    if q.distinct:
        text += "DISTINCT "
    text += sel + " WHERE { " + " ".join(body) + " }"
    if q.group_by:
        text += " GROUP BY " + " ".join(q.group_by)
    if q.order_by:
        keys = " ".join(
            (f"ASC({v})" if asc else f"DESC({v})") for v, asc in q.order_by
        )
        text += " ORDER BY " + keys
    if q.limit is not None:
        text += f" LIMIT {q.limit}"
    return text
