"""Mapping planner: RML document -> ordered physical operator plan.

Responsibilities (paper's "RML Triples Map Syntax Interpreter"):

* classify every predicate-object map to SOM / ORM / OJM,
* emit a CLASS op (rdf:type SOM) per subject map with an rr:class,
* deduplicate PJTT builds — a parent map referenced by several join rules
  builds its index ONCE (one of the paper's headline savings),
* group ops by predicate so PTT capacities can be sized from the total
  candidate count per predicate.

Term patterns are namespaced strings (``iri:`` templates/constants,
``lit:`` literal references) so output materialization knows the term kind.
"""

from __future__ import annotations

import dataclasses

from repro_torch.rml.model import (
    MappingDocument,
    RefObjectMap,
    TermMap,
    TriplesMap,
    parse_source_key,  # noqa: F401  (re-exported: executor calls planner.parse_source_key)
    source_key,
)

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"


def term_pattern(term: TermMap) -> str:
    """Canonical namespaced pattern string for a term map."""
    if term.template is not None:
        return "iri:" + term.pattern
    if term.reference is not None:
        return "lit:{}"
    c = term.constant or ""
    return ("iri:" if c.startswith(("http://", "https://", "urn:")) else "lit:") + c


@dataclasses.dataclass(frozen=True)
class PlannedOp:
    kind: str                    # SOM | ORM | OJM | CLASS
    triples_map: str
    predicate: str
    source_key: str              # logical source identity (fmt:path)
    subj_pattern: str
    subj_columns: tuple[str, ...]
    obj_pattern: str
    obj_columns: tuple[str, ...]          # SOM: source cols; ORM: parent subj cols
    join_child_column: str | None = None  # OJM only
    pjtt_key: str | None = None           # OJM only: cache key of the index
    parent_source_key: str | None = None
    parent_subj_pattern: str | None = None
    parent_subj_columns: tuple[str, ...] = ()
    parent_join_column: str | None = None


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    ops: tuple[PlannedOp, ...]
    # predicate -> ops generating it (PTT sizing + shared-table bookkeeping)
    by_predicate: dict[str, tuple[int, ...]]
    # pjtt_key -> (parent_source_key, parent_join_column, parent_subj_*)
    pjtt_builds: dict[str, tuple[str, str, str, tuple[str, ...]]]


def _src_key(tm: TriplesMap) -> str:
    return source_key(tm.source)


def plan(doc: MappingDocument) -> ExecutionPlan:
    ops: list[PlannedOp] = []
    pjtt_builds: dict[str, tuple[str, str, str, tuple[str, ...]]] = {}

    for tm in doc.triples_maps.values():
        subj_pat = term_pattern(tm.subject)
        subj_cols = tm.subject.columns
        if tm.subject_class:
            ops.append(
                PlannedOp(
                    kind="CLASS",
                    triples_map=tm.name,
                    predicate=RDF_TYPE,
                    source_key=_src_key(tm),
                    subj_pattern=subj_pat,
                    subj_columns=subj_cols,
                    obj_pattern="iri:" + tm.subject_class,
                    obj_columns=(),
                )
            )
        for pom in tm.poms:
            kind = doc.classify(tm, pom)
            om = pom.object_map
            if kind == "SOM":
                assert isinstance(om, TermMap)
                ops.append(
                    PlannedOp(
                        kind="SOM",
                        triples_map=tm.name,
                        predicate=pom.predicate,
                        source_key=_src_key(tm),
                        subj_pattern=subj_pat,
                        subj_columns=subj_cols,
                        obj_pattern=term_pattern(om),
                        obj_columns=om.columns,
                    )
                )
            elif kind == "ORM":
                assert isinstance(om, RefObjectMap)
                parent = doc.triples_maps[om.parent_triples_map]
                ops.append(
                    PlannedOp(
                        kind="ORM",
                        triples_map=tm.name,
                        predicate=pom.predicate,
                        source_key=_src_key(tm),
                        subj_pattern=subj_pat,
                        subj_columns=subj_cols,
                        obj_pattern=term_pattern(parent.subject),
                        obj_columns=parent.subject.columns,
                    )
                )
            else:  # OJM
                assert isinstance(om, RefObjectMap) and om.join is not None
                parent = doc.triples_maps[om.parent_triples_map]
                pkey = f"{parent.name}\x1f{om.join.parent}"
                pjtt_builds.setdefault(
                    pkey,
                    (
                        _src_key(parent),
                        om.join.parent,
                        term_pattern(parent.subject),
                        parent.subject.columns,
                    ),
                )
                ops.append(
                    PlannedOp(
                        kind="OJM",
                        triples_map=tm.name,
                        predicate=pom.predicate,
                        source_key=_src_key(tm),
                        subj_pattern=subj_pat,
                        subj_columns=subj_cols,
                        obj_pattern=term_pattern(parent.subject),
                        obj_columns=parent.subject.columns,
                        join_child_column=om.join.child,
                        pjtt_key=pkey,
                        parent_source_key=_src_key(parent),
                        parent_subj_pattern=term_pattern(parent.subject),
                        parent_subj_columns=parent.subject.columns,
                        parent_join_column=om.join.parent,
                    )
                )

    by_pred: dict[str, list[int]] = {}
    for i, op in enumerate(ops):
        by_pred.setdefault(op.predicate, []).append(i)
    return ExecutionPlan(
        ops=tuple(ops),
        by_predicate={k: tuple(v) for k, v in by_pred.items()},
        pjtt_builds=pjtt_builds,
    )
