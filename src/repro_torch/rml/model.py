"""RML mapping model — the ⟨O, S, M⟩ data-integration system of the paper.

A :class:`MappingDocument` is the set M of mapping rules; each
:class:`TriplesMap` groups rules sharing a subject; each
:class:`PredicateObjectMap` is one rule and classifies (paper §III.iii) to
exactly one physical operator:

* plain object map                        -> SOM
* parentTriplesMap, same logical source   -> ORM
* parentTriplesMap + joinCondition        -> OJM
"""

from __future__ import annotations

import dataclasses
import re
from typing import Literal

_PLACEHOLDER = re.compile(r"\{([^{}]+)\}")


@dataclasses.dataclass(frozen=True)
class LogicalSource:
    path: str
    fmt: Literal["csv", "tsv", "json"] = "csv"
    iterator: str | None = None  # JSONPath-ish iterator for json sources


def source_key(src: LogicalSource) -> str:
    """Canonical logical-source identity string.  The JSON iterator is part
    of the identity: two maps over the same file with different iterators
    are different sources (they yield different record streams)."""
    key = f"{src.fmt}:{src.path}"
    if src.iterator:
        key += f"\x1f{src.iterator}"
    return key


def parse_source_key(key: str) -> tuple[str, str, str | None]:
    """Inverse of :func:`source_key`: -> (fmt, path, iterator)."""
    fmt, rest = key.split(":", 1)
    path, _, iterator = rest.partition("\x1f")
    return fmt, path, iterator or None


@dataclasses.dataclass(frozen=True)
class TermMap:
    """rr:template / rml:reference / rr:constant term map."""

    template: str | None = None
    reference: str | None = None
    constant: str | None = None

    def __post_init__(self):
        n = sum(x is not None for x in (self.template, self.reference, self.constant))
        if n != 1:
            raise ValueError("TermMap needs exactly one of template/reference/constant")

    @property
    def kind(self) -> str:
        if self.template is not None:
            return "template"
        if self.reference is not None:
            return "reference"
        return "constant"

    @property
    def columns(self) -> tuple[str, ...]:
        """Source columns this term reads (template placeholders or the
        reference column; constants read none)."""
        if self.template is not None:
            return tuple(_PLACEHOLDER.findall(self.template))
        if self.reference is not None:
            return (self.reference,)
        return ()

    @property
    def pattern(self) -> str:
        """Canonical string pattern identifying the term *template*; the
        per-row value slots in via dictionary-encoded ids (DESIGN.md §2)."""
        if self.template is not None:
            return _PLACEHOLDER.sub("{}", self.template)
        if self.reference is not None:
            return "{}"  # raw literal value
        return self.constant  # type: ignore[return-value]

    @property
    def key(self) -> tuple[str, tuple[str, ...]]:
        """``(pattern, columns)`` — the term map's evaluation identity.
        Two term maps with the same key over the same logical source
        produce identical per-row values, which is what lets the mapping
        planner (:mod:`repro_torch.rml.plan`) factor them into one FunMap-style
        common subexpression evaluated once per source scan."""
        return (self.pattern, self.columns)


@dataclasses.dataclass(frozen=True)
class JoinCondition:
    child: str   # column of the child logical source
    parent: str  # column of the parent logical source


@dataclasses.dataclass(frozen=True)
class RefObjectMap:
    parent_triples_map: str
    join: JoinCondition | None = None  # None -> ORM (same source), else OJM


@dataclasses.dataclass(frozen=True)
class PredicateObjectMap:
    predicate: str  # constant predicate IRI
    object_map: TermMap | RefObjectMap


@dataclasses.dataclass(frozen=True)
class TriplesMap:
    name: str
    source: LogicalSource
    subject: TermMap
    subject_class: str | None = None
    poms: tuple[PredicateObjectMap, ...] = ()


@dataclasses.dataclass(frozen=True)
class MappingDocument:
    triples_maps: dict[str, TriplesMap]

    def classify(self, tm: TriplesMap, pom: PredicateObjectMap) -> str:
        """-> 'SOM' | 'ORM' | 'OJM' per the paper's operator-selection rule."""
        om = pom.object_map
        if isinstance(om, TermMap):
            return "SOM"
        parent = self.triples_maps[om.parent_triples_map]
        if om.join is None:
            if parent.source != tm.source:
                raise ValueError(
                    f"ORM {tm.name}->{parent.name} requires a shared logical source"
                )
            return "ORM"
        return "OJM"

    def validate(self) -> None:
        for tm in self.triples_maps.values():
            for pom in tm.poms:
                self.classify(tm, pom)
