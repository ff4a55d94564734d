"""Serialize a MappingDocument back to RML turtle (round-trips the parser)."""

from __future__ import annotations

from repro_torch.rml.model import MappingDocument, RefObjectMap, TermMap, TriplesMap

_PREFIXES = """\
@prefix rr: <http://www.w3.org/ns/r2rml#> .
@prefix rml: <http://semweb.mmlab.be/ns/rml#> .
@prefix ql: <http://semweb.mmlab.be/ns/ql#> .

"""


def _term(om: TermMap, indent: str) -> str:
    if om.template is not None:
        return f'{indent}rr:template "{om.template}"'
    if om.reference is not None:
        return f'{indent}rml:reference "{om.reference}"'
    return f'{indent}rr:constant "{om.constant}"'


def _triples_map(tm: TriplesMap) -> str:
    ql = "ql:JSONPath" if tm.source.fmt == "json" else "ql:CSV"
    lines = [f"<#{tm.name}> a rr:TriplesMap ;"]
    src = f'    rml:logicalSource [ rml:source "{tm.source.path}" ; rml:referenceFormulation {ql}'
    if tm.source.iterator:
        src += f' ; rml:iterator "{tm.source.iterator}"'
    lines.append(src + " ] ;")
    subj = f"    rr:subjectMap [ {_term(tm.subject, '').strip()}"
    if tm.subject_class:
        subj += f" ; rr:class <{tm.subject_class}>"
    lines.append(subj + " ]" + (" ;" if tm.poms else " ."))
    for i, pom in enumerate(tm.poms):
        last = i == len(tm.poms) - 1
        om = pom.object_map
        if isinstance(om, RefObjectMap):
            inner = f"rr:parentTriplesMap <#{om.parent_triples_map}>"
            if om.join is not None:
                inner += (
                    f' ; rr:joinCondition [ rr:child "{om.join.child}" ;'
                    f' rr:parent "{om.join.parent}" ]'
                )
        else:
            inner = _term(om, "").strip()
        lines.append(
            f"    rr:predicateObjectMap [ rr:predicate <{pom.predicate}> ;"
            f" rr:objectMap [ {inner} ] ]" + (" ." if last else " ;")
        )
    return "\n".join(lines) + "\n"


def to_turtle(doc: MappingDocument) -> str:
    return _PREFIXES + "\n".join(_triples_map(tm) for tm in doc.triples_maps.values())


def write_turtle(doc: MappingDocument, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_turtle(doc))
