"""Literal-value side tables — FILTER / ORDER BY semantics over term ids.

The executor never touches strings at query time; comparisons and
value-typed ordering run on dense *rank* tables built once per store
(cached on the store object; ``KGServer`` constructs them eagerly at
server store-load so no client pays the cost on its first query):

* ``num_rank[t]`` — rank of term ``t``'s numeric value among the store's
  distinct numeric literal values (``-1`` if the term is not a numeric
  literal).  Equal values share a rank, so rank comparisons are exactly
  value comparisons — no float precision leaves the host (device arrays
  are int32, immune to the f64->f32 demotion a value table would suffer).
* ``str_rank[t]`` — rank of the raw (unescaped) literal body among the
  store's distinct literal bodies (``-1`` for non-literals); codepoint
  order, the SPARQL ``STR()`` comparison our lite semantics uses.
* ``is_num`` / ``is_lit`` — participation masks (SPARQL type errors make a
  comparison false, they never crash).
* ``order_rank[t]`` — the ``ORDER BY`` total order: IRIs (by rendered
  term) < numeric literals (by value) < other literals (by raw body),
  ties broken by rendered term (= term id), so the order is a permutation
  and identical across stores of the same graph.  Built *on the store's
  device*: the int32 class/rank/tie keys are lexsorted with successive
  stable torch argsorts and scattered back — only the string/number
  extraction stays on host.

Constants are resolved to rank *bounds* on the host at plan/encode time
with a binary search over the kept sorted-unique tables, so a constant
absent from the store still compares correctly (it falls between ranks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.encoder import render_template
from repro_torch.kg.store import TripleStore


@dataclasses.dataclass(frozen=True)
class ValueTable:
    # tensors on the store's device, one entry per term id
    is_lit: torch.Tensor      # bool[T]
    is_num: torch.Tensor      # bool[T]
    str_rank: torch.Tensor    # int32[T], -1 for non-literals
    num_rank: torch.Tensor    # int32[T], -1 for non-numerics
    order_rank: torch.Tensor  # int32[T], a permutation (the ORDER BY key)
    # True when order_rank is the identity: value order == term-id order,
    # so an ORDER BY over already-term-id-sorted rows can be elided
    order_is_tid: bool
    # host tables for constant rank lookup
    str_uniq: np.ndarray     # object[Us]  sorted distinct literal bodies
    num_uniq: np.ndarray     # float64[Un] sorted distinct numeric values

    def num_bounds(self, value: float) -> tuple[int, int]:
        """``(lo, hi)`` ranks such that a term compares to ``value`` as its
        ``num_rank`` compares to the bounds: ``< value`` iff ``rank < lo``,
        ``== value`` iff ``lo <= rank < hi``, ``> value`` iff ``rank >= hi``."""
        lo = int(np.searchsorted(self.num_uniq, value, side="left"))
        hi = int(np.searchsorted(self.num_uniq, value, side="right"))
        return lo, hi

    def str_bounds(self, body: str) -> tuple[int, int]:
        lo = int(np.searchsorted(self.str_uniq, body, side="left"))
        hi = int(np.searchsorted(self.str_uniq, body, side="right"))
        return lo, hi


def literal_body(store: TripleStore, term_id: int) -> str | None:
    """Raw (unescaped) literal body of a term, ``None`` for IRIs."""
    pat = store.dictionary.decode_scalar(int(store.term_pat[term_id]))
    kind, pattern = pat.split(":", 1)
    if kind != "lit":
        return None
    if "{}" not in pattern:
        return pattern
    return render_template(
        pattern, store.dictionary.decode_scalar(int(store.term_val[term_id]))
    )


def parse_number(body: str) -> float | None:
    """The one number-parsing rule shared by engine and oracle."""
    try:
        v = float(body)
    except ValueError:
        return None
    return v if np.isfinite(v) else None


def value_table(store: TripleStore) -> ValueTable:
    """Build (or fetch the cached) side tables for a store."""
    cached = getattr(store, "_value_table", None)
    if cached is not None:
        return cached
    T = store.n_terms
    is_lit = np.zeros(T, bool)
    bodies = np.empty(T, object)
    numvals = np.full(T, np.nan)
    for t in range(T):
        body = literal_body(store, t)
        if body is None:
            continue
        is_lit[t] = True
        bodies[t] = body
        v = parse_number(body)
        if v is not None:
            numvals[t] = v
    str_rank = np.full(T, -1, np.int32)
    if is_lit.any():
        str_uniq, inv = np.unique(bodies[is_lit], return_inverse=True)
        str_rank[is_lit] = inv.astype(np.int32)
    else:
        str_uniq = np.empty(0, object)
    is_num = ~np.isnan(numvals)
    num_rank = np.full(T, -1, np.int32)
    if is_num.any():
        num_uniq, inv = np.unique(numvals[is_num], return_inverse=True)
        num_rank[is_num] = inv.astype(np.int32)
    else:
        num_uniq = np.empty(0, np.float64)
    # the ORDER BY total order, built on device from int32 keys: class
    # (iri < numeric < other literal), the within-class value rank, term id
    # as the tie-break.  order_rank[perm[i]] = i makes it a permutation.
    dev = store.device
    tid = np.arange(T, dtype=np.int32)
    cls = np.where(~is_lit, 0, np.where(is_num, 1, 2)).astype(np.int32)
    within = np.where(
        ~is_lit, tid, np.where(is_num, num_rank, str_rank)
    ).astype(np.int32)
    # jnp.lexsort((tid, within, cls)): successive stable argsorts, least
    # significant key first
    perm = torch.arange(T, device=dev)
    for key in (tid, within, cls):
        k = torch.from_numpy(key).to(dev)
        perm = perm[torch.argsort(k[perm], stable=True)]
    arange = torch.arange(T, dtype=torch.int32, device=dev)
    order_rank = torch.zeros(T, dtype=torch.int32, device=dev)
    order_rank[perm] = arange
    order_is_tid = bool((perm == arange).all())
    table = ValueTable(
        is_lit=torch.from_numpy(is_lit).to(dev),
        is_num=torch.from_numpy(is_num).to(dev),
        str_rank=torch.from_numpy(str_rank).to(dev),
        num_rank=torch.from_numpy(num_rank).to(dev),
        order_rank=order_rank,
        order_is_tid=order_is_tid,
        str_uniq=str_uniq,
        num_uniq=num_uniq,
    )
    store._value_table = table
    return table
