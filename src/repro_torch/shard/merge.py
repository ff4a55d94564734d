"""Deterministic scatter/gather merge — shard answers -> the unsharded answer.

Three dispatch modes, chosen per query by :func:`choose_dispatch`:

* ``routed`` — every pattern shares one *constant* subject
  (:func:`repro_torch.serve.plan.routing_subject`): all solution triples live on
  ``shard_of_term(subject)``, so the coordinator forwards the query to
  exactly one shard and passes its reply through untouched.
* ``scatter`` — all patterns (required + UNION arms + OPTIONAL groups)
  share one subject *slot* (:func:`repro_torch.serve.plan.colocated_subjects`):
  every solution's triples share a subject and therefore a shard, so the
  per-shard answers are disjoint and their union is the unsharded bag.
  The query scatters to all shards and the merge below re-sorts,
  re-deduplicates (DISTINCT), re-aggregates (GROUP BY / COUNT) and
  re-applies ORDER BY / LIMIT.
* ``decompose`` — anything else (e.g. subject-object chains): a solution's
  triples may span shards, so whole-query scatter would silently drop
  cross-shard joins.  Instead each *pattern* scatters on its own (a single
  pattern's matches partition cleanly — each matching triple lives on
  exactly one shard) and the host combines the per-pattern solutions with
  the oracle's own algebra tail
  (:func:`repro_torch.serve.oracle.combine_pattern_solutions`).

Why the merge can reproduce the engine's ordering byte-for-byte: term ids
are *ranks of rendered term strings*, so sorting merged rows by rendered
term (``_default_cell_key``) IS global term-id order, even though each
shard ranks only its own dictionary.  The ORDER BY passes reuse the
oracle's value-typed key (``_orderby_cell_key``) — the same total order
``values.order_rank`` realizes on device.

Per-shard LIMIT is kept for plain / DISTINCT / ORDER BY scatter (the
global top-k under a shared total order is contained in the union of
per-shard top-k), but **stripped for aggregates** — a shard-side LIMIT
would cut whole groups out of the partial counts the merge re-sums.
"""

from __future__ import annotations

import dataclasses

from repro_torch.serve import algebra as A
from repro_torch.serve import plan as P
from repro_torch.serve.oracle import (
    _default_cell_key,
    _orderby_cell_key,
    combine_pattern_solutions,
)
from repro_torch.shard.partition import shard_of_term

# decode cap for sub-queries whose merge needs COMPLETE shard rows
# (aggregate partials; DISTINCT without LIMIT; decomposed patterns)
BIG_LIMIT = 1 << 30

ROUTED = "routed"
SCATTER = "scatter"
DECOMPOSE = "decompose"


def choose_dispatch(q: A.SelectQuery, n_shards: int):
    """``(mode, target_shard)`` for a parsed query; ``target_shard`` is
    only set for ``routed``.  One shard degenerates to routed-to-0."""
    if n_shards <= 1:
        return ROUTED, 0
    subject = P.routing_subject(q)
    if subject is not None:
        return ROUTED, shard_of_term(subject, n_shards)
    if P.colocated_subjects(q):
        return SCATTER, None
    return DECOMPOSE, None


def _is_agg(q: A.SelectQuery) -> bool:
    return q.agg is not None or bool(q.group_by)


def scatter_query(q: A.SelectQuery) -> A.SelectQuery:
    """The per-shard sub-query for scatter mode.  Aggregates ship with
    ORDER BY / LIMIT stripped: the merge re-sums partial groups, and a
    shard-local LIMIT would truncate groups *before* their partials
    exist.  Everything else ships verbatim — per-shard LIMIT is safe
    under the shared total order (see module docstring)."""
    if _is_agg(q):
        return dataclasses.replace(q, order_by=(), limit=None)
    return q


def scatter_decode_limit(q: A.SelectQuery, reply_cap: int) -> int:
    """Rows the coordinator must decode *per shard* for an exact merge.
    ``reply_cap`` is the most rows the final answer will carry (the
    request's ``limit`` or the coordinator's ``max_rows``)."""
    if _is_agg(q):
        return BIG_LIMIT  # every partial group, always
    if q.distinct:
        # n_total = min(#distinct, LIMIT) needs the full per-shard
        # distinct row set (cross-shard duplicates collapse at the
        # merge, so shard counts cannot simply be summed)
        return q.limit if q.limit is not None else BIG_LIMIT
    # plain rows: global top-k ⊆ union of per-shard top-k, and n_total
    # comes from summing shard totals — decoded rows only need the cap
    return reply_cap


def _sorted_rows(q: A.SelectQuery, rows: list[tuple]) -> list[tuple]:
    """The oracle/engine ordering: default deterministic sort (rendered
    term = term-id order) as the base, then the stable ORDER BY passes,
    last key first."""
    out_vars = q.out_vars()
    rows.sort(key=lambda r: tuple(_default_cell_key(c) for c in r))
    for var, asc in reversed(q.order_by):
        i = out_vars.index(var)
        rows.sort(key=lambda r: _orderby_cell_key(r[i]), reverse=not asc)
    return rows


def merge_scatter(
    q: A.SelectQuery, shard_replies: "list[tuple[list[tuple], int]]"
) -> "tuple[list[tuple], int]":
    """Merge scatter-mode shard answers into ``(rows, n_total)`` equal to
    the unsharded engine's.  ``shard_replies`` holds each shard's
    ``(rows, n_total)`` for :func:`scatter_query`'s sub-query, decoded to
    at least :func:`scatter_decode_limit` rows."""
    if _is_agg(q):
        out_vars = q.out_vars()
        alias = q.agg.alias if q.agg is not None else None
        ai = out_vars.index(alias) if alias is not None else None
        # partial groups re-sum by their non-aggregate key cells; a
        # GROUP BY without COUNT is pure key dedup.  The global
        # aggregate (no GROUP BY) sums every shard's single row — each
        # shard reports its own count, zero included, under key ().
        groups: dict[tuple, int] = {}
        for rows, _n in shard_replies:
            for r in rows:
                if ai is None:
                    groups.setdefault(tuple(r), 0)
                else:
                    key = tuple(c for j, c in enumerate(r) if j != ai)
                    groups[key] = groups.get(key, 0) + int(r[ai])
        merged: list[tuple] = []
        for key, cnt in groups.items():
            if ai is None:
                merged.append(key)
            else:
                row = list(key)
                row.insert(ai, cnt)
                merged.append(tuple(row))
        merged = _sorted_rows(q, merged)
        n_total = len(merged)
        if q.limit is not None:
            n_total = min(n_total, q.limit)
            merged = merged[: q.limit]
        return merged, n_total

    merged = [tuple(r) for rows, _n in shard_replies for r in rows]
    if q.distinct:
        merged = _sorted_rows(q, list(dict.fromkeys(merged)))
        n_total = len(merged)
        if q.limit is not None:
            n_total = min(n_total, q.limit)
            merged = merged[: q.limit]
        return merged, n_total

    # plain: shard solution bags are disjoint, so totals sum exactly;
    # each shard already clipped its own total at LIMIT, and
    # min(sum of clipped, LIMIT) still equals min(true total, LIMIT)
    merged = _sorted_rows(q, merged)
    n_total = sum(n for _rows, n in shard_replies)
    if q.limit is not None:
        n_total = min(n_total, q.limit)
        merged = merged[: q.limit]
    return merged, n_total


# ---------------------------------------------------------------------------
# decomposed dispatch — per-pattern scatter + host-side combine
# ---------------------------------------------------------------------------


def decompose_queries(
    q: A.SelectQuery,
) -> "list[tuple[A.SelectQuery, str | None]]":
    """One single-pattern sub-query per ``q.all_patterns()`` entry, paired
    with its routing subject (the pattern's constant subject, or None to
    scatter).  A fully-constant pattern becomes a COUNT probe — the store
    dedupes triples, so it matches at most once and presence is all the
    combine needs."""
    out = []
    for pat in q.all_patterns():
        subject = pat.slots[0] if not pat.slots[0].startswith("?") else None
        if pat.variables:
            sub = A.SelectQuery(patterns=(pat,), select=tuple(pat.variables))
        else:
            sub = A.SelectQuery(
                patterns=(pat,),
                select=("?__present",),
                agg=A.Count(var=None, alias="?__present"),
            )
        out.append((sub, subject))
    return out


def pattern_rows_to_solutions(
    sub: A.SelectQuery, shard_rows: "list[list[tuple]]"
) -> "list[dict[str, str]]":
    """Gathered single-pattern rows -> the solution mappings
    :func:`combine_pattern_solutions` consumes.  Each matching triple
    lives on exactly one shard, so concatenation is the exact match set —
    no cross-shard duplicates to collapse."""
    if sub.agg is not None:  # the fully-constant COUNT probe
        present = any(int(r[0]) > 0 for rows in shard_rows for r in rows)
        return [{}] if present else []
    vars_ = sub.select or ()
    return [
        {v: c for v, c in zip(vars_, r) if c is not None}
        for rows in shard_rows
        for r in rows
    ]


def combine_decomposed(
    q: A.SelectQuery, pattern_sols: "list[list[dict[str, str]]]"
) -> "tuple[list[tuple], int]":
    """Host-side algebra tail over gathered per-pattern solutions; LIMIT
    re-applied here so ``n_total`` still reports the pre-LIMIT count the
    engine would (clipped at LIMIT, matching ``BatchResult.n``)."""
    full = combine_pattern_solutions(
        dataclasses.replace(q, limit=None), pattern_sols
    )
    n_total = len(full)
    if q.limit is not None:
        n_total = min(n_total, q.limit)
        full = full[: q.limit]
    return full, n_total
