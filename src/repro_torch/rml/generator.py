"""Testbed generator — the paper's COSMIC-derived benchmark datasets.

The paper builds six datasets from the COSMIC coding point-mutation table:
{10K, 100K, 1M} rows × {25%, 75%} duplicate rate, *each duplicated value
repeated 20 times*, plus mapping files with 1..5 predicate-object maps of
each operator type (SOM / ORM / OJM).  COSMIC requires a license, so we
generate schema-faithful synthetic tables with exactly those statistical
controls; the engine never looks at the string content, only at the
dictionary-encoded structure, so the performance profile is preserved.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.rml.model import (
    JoinCondition,
    LogicalSource,
    MappingDocument,
    PredicateObjectMap,
    RefObjectMap,
    TermMap,
    TriplesMap,
)

BASE = "http://repro.org/"
COLUMNS = (
    "MUTATION_ID",
    "GENE_NAME",
    "ACCESSION_NUMBER",   # the ENST join column of the motivating example
    "GENOMIC_MUTATION_ID",
    "MUTATION_CDS",
    "MUTATION_AA",
    "OMIXCORE_SCORE",
)
PARENT_COLUMNS = ("ACCESSION_NUMBER", "EXON_ID", "EXON_START", "EXON_END")
DUP_GROUP = 20  # the paper: each duplicated value repeated 20 times


@dataclasses.dataclass
class Testbed:
    child: dict[str, np.ndarray]          # the main (child) table
    parent: dict[str, np.ndarray] | None  # second source for OJM testbeds
    doc: MappingDocument
    name: str

    def write(self, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        _write_csv(os.path.join(out_dir, "child.csv"), self.child)
        if self.parent is not None:
            _write_csv(os.path.join(out_dir, "parent.csv"), self.parent)
        return out_dir


def _write_csv(path: str, table: dict[str, np.ndarray]) -> None:
    cols = list(table)
    n = len(table[cols[0]])
    with open(path, "w", encoding="utf-8") as f:
        f.write(",".join(cols) + "\n")
        for i in range(n):
            f.write(",".join(str(table[c][i]) for c in cols) + "\n")


def _dup_rows(n_rows: int, dup_rate: float, rng: np.random.Generator) -> np.ndarray:
    """Row-identity vector of length n_rows where ``dup_rate`` of the rows are
    duplicates, occurring in groups of DUP_GROUP (paper's construction)."""
    n_dup = int(round(n_rows * dup_rate))
    n_groups = max(n_dup // DUP_GROUP, 1) if n_dup else 0
    n_uniq = n_rows - n_dup + n_groups  # each group contributes one original
    ids = np.arange(n_uniq, dtype=np.int64)
    extra = []
    if n_groups:
        group_ids = rng.choice(n_uniq, size=n_groups, replace=False)
        reps = np.full(n_groups, DUP_GROUP - 1, dtype=np.int64)
        # distribute the remainder so total length is exactly n_rows
        rem = n_dup - n_groups * (DUP_GROUP - 1)
        i = 0
        while rem > 0:
            reps[i % n_groups] += 1
            rem -= 1
            i += 1
        while rem < 0:
            reps[i % n_groups] -= 1
            rem += 1
            i += 1
        extra = np.repeat(group_ids, reps)
    out = np.concatenate([ids, extra]) if len(extra) else ids
    rng.shuffle(out)
    return out[:n_rows]


def make_child_table(
    n_rows: int, dup_rate: float, seed: int = 0, n_enst_pool: int | None = None
) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    row_id = _dup_rows(n_rows, dup_rate, rng)
    n_enst = n_enst_pool or max(n_rows // 16, 4)
    enst_of_row = rng.integers(0, n_enst, size=row_id.max() + 1)
    table = {}
    for col in COLUMNS:
        if col == "ACCESSION_NUMBER":
            table[col] = np.array(
                [f"ENST{enst_of_row[r]:011d}" for r in row_id], dtype=object
            )
        elif col == "OMIXCORE_SCORE":
            score = (row_id % 1000) / 1000.0
            table[col] = np.array([f"{s:.3f}" for s in score], dtype=object)
        else:
            table[col] = np.array([f"{col}_{r}" for r in row_id], dtype=object)
    return table


def make_parent_table(
    n_rows: int, dup_rate: float, seed: int = 1, n_enst_pool: int | None = None
) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    row_id = _dup_rows(n_rows, dup_rate, rng)
    n_enst = n_enst_pool or max(n_rows // 16, 4)
    enst_of_row = rng.integers(0, n_enst, size=row_id.max() + 1)
    table = {}
    for col in PARENT_COLUMNS:
        if col == "ACCESSION_NUMBER":
            table[col] = np.array(
                [f"ENST{enst_of_row[r]:011d}" for r in row_id], dtype=object
            )
        else:
            table[col] = np.array([f"{col}_{r}" for r in row_id], dtype=object)
    return table


def _subject(template_col: str = "MUTATION_ID") -> TermMap:
    return TermMap(template=f"{BASE}mutation/{{{template_col}}}")


def make_som_testbed(
    n_rows: int, dup_rate: float, n_poms: int = 1, seed: int = 0
) -> Testbed:
    """SOM mapping: n_poms predicate-object maps with column references."""
    obj_cols = [c for c in COLUMNS if c != "MUTATION_ID"][:n_poms]
    poms = tuple(
        PredicateObjectMap(
            predicate=f"{BASE}vocab/{c.lower()}", object_map=TermMap(reference=c)
        )
        for c in obj_cols
    )
    tm = TriplesMap(
        name="TriplesMap1",
        source=LogicalSource(path="child.csv"),
        subject=_subject(),
        subject_class=f"{BASE}vocab/Mutation",
        poms=poms,
    )
    return Testbed(
        child=make_child_table(n_rows, dup_rate, seed),
        parent=None,
        doc=MappingDocument({"TriplesMap1": tm}),
        name=f"som{n_poms}-{n_rows}-{int(dup_rate*100)}",
    )


def make_orm_testbed(
    n_rows: int, dup_rate: float, n_poms: int = 1, seed: int = 0
) -> Testbed:
    """ORM mapping: child references parent maps over the SAME source."""
    src = LogicalSource(path="child.csv")
    maps: dict[str, TriplesMap] = {}
    poms = []
    ref_cols = [c for c in COLUMNS if c != "MUTATION_ID"][:n_poms]
    for i, col in enumerate(ref_cols):
        pname = f"ParentMap{i+1}"
        maps[pname] = TriplesMap(
            name=pname,
            source=src,
            subject=TermMap(template=f"{BASE}{col.lower()}/{{{col}}}"),
            subject_class=f"{BASE}vocab/{col.title()}",
        )
        poms.append(
            PredicateObjectMap(
                predicate=f"{BASE}vocab/has_{col.lower()}",
                object_map=RefObjectMap(parent_triples_map=pname, join=None),
            )
        )
    maps["TriplesMap1"] = TriplesMap(
        name="TriplesMap1",
        source=src,
        subject=_subject(),
        subject_class=f"{BASE}vocab/Mutation",
        poms=tuple(poms),
    )
    return Testbed(
        child=make_child_table(n_rows, dup_rate, seed),
        parent=None,
        doc=MappingDocument(maps),
        name=f"orm{n_poms}-{n_rows}-{int(dup_rate*100)}",
    )


def make_ojm_testbed(
    n_rows: int,
    dup_rate: float,
    n_poms: int = 1,
    seed: int = 0,
    parent_rows: int | None = None,
) -> Testbed:
    """OJM mapping: joins to parent maps over a DIFFERENT source on the ENST
    accession column (the motivating example's join)."""
    parent_rows = parent_rows or n_rows
    # join-key pool sized for ~4 matches per child row (keeps |N_p| = Θ(4·n))
    n_pool = max(min(n_rows, parent_rows) // 4, 4)
    child_src = LogicalSource(path="child.csv")
    parent_src = LogicalSource(path="parent.csv")
    maps: dict[str, TriplesMap] = {}
    poms = []
    for i in range(n_poms):
        pname = f"ExonMap{i+1}"
        maps[pname] = TriplesMap(
            name=pname,
            source=parent_src,
            subject=TermMap(template=f"{BASE}exon{i+1}/{{EXON_ID}}"),
            subject_class=f"{BASE}vocab/Exon",
        )
        poms.append(
            PredicateObjectMap(
                predicate=f"{BASE}vocab/in_exon_{i+1}",
                object_map=RefObjectMap(
                    parent_triples_map=pname,
                    join=JoinCondition(
                        child="ACCESSION_NUMBER", parent="ACCESSION_NUMBER"
                    ),
                ),
            )
        )
    maps["TriplesMap1"] = TriplesMap(
        name="TriplesMap1",
        source=child_src,
        subject=_subject(),
        subject_class=f"{BASE}vocab/Mutation",
        poms=tuple(poms),
    )
    return Testbed(
        child=make_child_table(n_rows, dup_rate, seed, n_enst_pool=n_pool),
        parent=make_parent_table(parent_rows, dup_rate, seed + 1, n_enst_pool=n_pool),
        doc=MappingDocument(maps),
        name=f"ojm{n_poms}-{n_rows}-{int(dup_rate*100)}",
    )


def make_testbed(
    kind: str, n_rows: int, dup_rate: float, n_poms: int = 1, seed: int = 0
) -> Testbed:
    if kind == "SOM":
        return make_som_testbed(n_rows, dup_rate, n_poms, seed)
    if kind == "ORM":
        return make_orm_testbed(n_rows, dup_rate, n_poms, seed)
    if kind == "OJM":
        return make_ojm_testbed(n_rows, dup_rate, n_poms, seed)
    raise ValueError(f"unknown testbed kind {kind!r}")
