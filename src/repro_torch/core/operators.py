"""The three physical RML operators: SOM, ORM, OJM (+ naive counterparts).

The counterpart of ``repro.core.operators``.  Each operator consumes
dictionary-encoded columns (int32 value ids) and a
:class:`StaticTripleParams` describing the term templates of the rule, and
produces the candidate triple keys together with duplicate-elimination
results.  The *optimized* path threads a PTT through the call (incremental
dedup, the paper's contribution); the *naive* path returns raw keys so the
executor can perform the paper's generate-all + sort-dedup baseline.
Triple keys come from the ``hash_mix`` kernel on both paths
(``ptt.triple_keys``), and the naive join is the ``nested_join`` kernel on
the card (``naive.nested_loop_join``).

Operator selection (paper §III.iii):
  join condition present            -> OJM  (PJTT index join)
  reference to parent, same source  -> ORM  (self-join, Θ(1) subject access)
  otherwise                         -> SOM
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import naive, pjtt, ptt


@dataclasses.dataclass(frozen=True)
class StaticTripleParams:
    """Static identity of a predicate-object rule."""

    subj_tmpl: int  # template id of the child subject term
    pred_id: int    # term id of the (constant) predicate
    obj_tmpl: int   # template id of the object term


class OpResult(NamedTuple):
    ptt: ptt.PTT
    is_new: torch.Tensor      # bool[...]  triples to emit
    overflowed: torch.Tensor  # bool[]


# ---------------------------------------------------------------- optimized


def som(
    table: ptt.PTT,
    subj_vals: torch.Tensor,
    obj_vals: torch.Tensor,
    p: StaticTripleParams,
) -> OpResult:
    """Simple Object Map: object value read straight from the source column
    (or a constant broadcast by the caller).  Cost: |N_p| + 2|S_p|."""
    r = ptt.insert_triples(
        table, p.subj_tmpl, subj_vals, p.pred_id, p.obj_tmpl, obj_vals
    )
    return OpResult(r.ptt, r.is_new, r.overflowed)


def orm(
    table: ptt.PTT,
    subj_vals: torch.Tensor,
    parent_subj_vals: torch.Tensor,
    p: StaticTripleParams,
) -> OpResult:
    """Object Reference Map: the object is the *parent map's subject term*
    applied to the same row (same logical source -> Θ(1) access, no join).
    ``p.obj_tmpl`` must be the parent's subject template id."""
    r = ptt.insert_triples(
        table, p.subj_tmpl, subj_vals, p.pred_id, p.obj_tmpl, parent_subj_vals
    )
    return OpResult(r.ptt, r.is_new, r.overflowed)


class OjmResult(NamedTuple):
    ptt: ptt.PTT
    is_new: torch.Tensor        # bool[m, K]
    subjects: torch.Tensor      # int32[m, K]   matched parent subject values
    valid: torch.Tensor         # bool[m, K]
    truncated: torch.Tensor     # bool[]
    overflowed: torch.Tensor    # bool[]


def ojm(
    table: ptt.PTT,
    index,  # PJTTSorted | PJTTHash
    child_subj_vals: torch.Tensor,
    child_join_keys: torch.Tensor,
    p: StaticTripleParams,
    max_matches: int,
) -> OjmResult:
    """Object Join Map: index join through the PJTT, then PTT dedup.
    Cost: 2|N_parent| + |N_child| + |N_p| + 2|S_p| (paper §III.iv)."""
    if isinstance(index, pjtt.PJTTSorted):
        pr = pjtt.probe_sorted(index, child_join_keys, max_matches)
    else:
        pr = pjtt.probe_hash(index, child_join_keys, max_matches)
    m, K = pr.subjects.shape
    subj = child_subj_vals[:, None].expand(m, K).reshape(-1)
    obj = pr.subjects.reshape(-1)
    r = ptt.insert_triples(
        table,
        p.subj_tmpl,
        subj,
        p.pred_id,
        p.obj_tmpl,
        obj,
        valid=pr.valid.reshape(-1),
    )
    return OjmResult(
        ptt=r.ptt,
        is_new=r.is_new.view(m, K),
        subjects=pr.subjects,
        valid=pr.valid,
        truncated=pr.truncated,
        overflowed=r.overflowed,
    )


# -------------------------------------------------------------------- naive


class NaiveKeys(NamedTuple):
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    valid: torch.Tensor


def naive_som_keys(
    subj_vals: torch.Tensor, obj_vals: torch.Tensor, p: StaticTripleParams
) -> NaiveKeys:
    """Generate ALL candidate triple keys (duplicates included) — the naive
    engine defers duplicate elimination to a final sort pass."""
    hi, lo = ptt.triple_keys(p.subj_tmpl, subj_vals, p.pred_id, p.obj_tmpl, obj_vals)
    return NaiveKeys(hi, lo, torch.ones(subj_vals.shape, dtype=torch.bool,
                                        device=subj_vals.device))


def naive_ojm_keys(
    parent_keys: torch.Tensor,
    parent_subjects: torch.Tensor,
    child_subj_vals: torch.Tensor,
    child_join_keys: torch.Tensor,
    p: StaticTripleParams,
    max_matches: int,
) -> tuple[NaiveKeys, torch.Tensor, torch.Tensor]:
    """Nested-loop join (|N_parent|·|N_child| comparisons) producing all
    result triples with duplicates.  Returns (keys, subjects, truncated)."""
    jr = naive.nested_loop_join(
        parent_keys, parent_subjects, child_join_keys, max_matches
    )
    m, K = jr.subjects.shape
    subj = child_subj_vals[:, None].expand(m, K).reshape(-1)
    obj = jr.subjects.reshape(-1)
    hi, lo = ptt.triple_keys(p.subj_tmpl, subj, p.pred_id, p.obj_tmpl, obj)
    return (
        NaiveKeys(hi, lo, jr.valid.reshape(-1)),
        jr.subjects,
        jr.truncated,
    )


def naive_dedup(keys: NaiveKeys) -> naive.SortDedupResult:
    """The Θ(N log N) merge-sort duplicate elimination of the baseline."""
    return naive.sort_dedup_masked(keys.key_hi, keys.key_lo, keys.valid)
