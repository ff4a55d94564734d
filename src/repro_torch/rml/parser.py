"""Parser for the RML turtle subset used by the paper's mappings.

Supports the constructs exercised in the paper's Figure 1 / testbeds:
``@prefix``, triples maps with ``rml:logicalSource``, ``rr:subjectMap``
(template + class), ``rr:predicateObjectMap`` with plain object maps
(``rr:template`` / ``rml:reference`` / ``rr:constant``), referencing object
maps (``rr:parentTriplesMap``), and ``rr:joinCondition`` (``rr:child`` /
``rr:parent``).  Blank-node property lists, ``;``/``,`` lists, IRIs,
prefixed names and string literals are handled by a small recursive-descent
parser — enough to round-trip every mapping in the bundled testbeds.
"""

from __future__ import annotations

import re

from repro_torch.rml.model import (
    JoinCondition,
    LogicalSource,
    MappingDocument,
    PredicateObjectMap,
    RefObjectMap,
    TermMap,
    TriplesMap,
)

_TOKEN = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<iri><[^>]*>)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<punct>[\[\];,.])
  | (?P<prefixed>[A-Za-z_][\w\-]*:[\w\-./#]*)
  | (?P<kw>@prefix|a)
  | (?P<ws>\s+)
""",
    re.VERBOSE,
)


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise SyntaxError(f"RML parse error at: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        toks.append(m.group())
    return toks


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0
        self.prefixes: dict[str, str] = {}

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise SyntaxError(f"expected {tok!r}, got {got!r}")

    # -- term expansion -----------------------------------------------------
    def expand(self, tok: str) -> str:
        if tok.startswith("<") and tok.endswith(">"):
            return tok[1:-1]
        if tok.startswith('"') and tok.endswith('"'):
            return tok[1:-1].encode().decode("unicode_escape")
        if ":" in tok:
            pfx, local = tok.split(":", 1)
            if pfx in self.prefixes:
                return self.prefixes[pfx] + local
        return tok

    # -- grammar ------------------------------------------------------------
    def parse(self) -> MappingDocument:
        maps: dict[str, TriplesMap] = {}
        while self.peek() is not None:
            if self.peek() == "@prefix":
                self.next()
                name = self.next().rstrip(":")
                iri = self.expand(self.next())
                self.expect(".")
                self.prefixes[name] = iri
            else:
                tm = self.parse_triples_map()
                maps[tm.name] = tm
        doc = MappingDocument(triples_maps=maps)
        doc.validate()
        return doc

    def parse_triples_map(self) -> TriplesMap:
        name_tok = self.next()
        name = name_tok[1:-1] if name_tok.startswith("<") else name_tok
        name = name.lstrip("#")
        props = self.parse_property_list()
        self.expect(".")
        return self.build_triples_map(name, props)

    def parse_property_list(self) -> list[tuple[str, object]]:
        """predicate object (',' object)* (';' predicate ...)*"""
        props: list[tuple[str, object]] = []
        while True:
            nxt = self.peek()
            if nxt in (None, ".", "]"):
                break
            pred_tok = self.next()
            pred = "rdf:type" if pred_tok == "a" else pred_tok
            while True:
                obj = self.parse_object()
                props.append((pred, obj))
                if self.peek() == ",":
                    self.next()
                    continue
                break
            if self.peek() == ";":
                self.next()
                continue
            break
        return props

    def parse_object(self):
        tok = self.peek()
        if tok == "[":
            self.next()
            inner = self.parse_property_list()
            self.expect("]")
            return inner
        return self.next()

    # -- model construction ---------------------------------------------------
    def _get(self, props, *keys):
        out = []
        for p, v in props:
            local = p.split(":", 1)[-1].lstrip("<").rstrip(">").split("#")[-1].split("/")[-1]
            if local in keys:
                out.append(v)
        return out

    def build_term_map(self, props) -> TermMap:
        tpl = self._get(props, "template")
        ref = self._get(props, "reference")
        const = self._get(props, "constant")
        if tpl:
            return TermMap(template=self.expand(tpl[0]))
        if ref:
            return TermMap(reference=self.expand(ref[0]))
        if const:
            return TermMap(constant=self.expand(const[0]))
        raise SyntaxError(f"term map without template/reference/constant: {props}")

    def build_triples_map(self, name: str, props) -> TriplesMap:
        ls_props = self._get(props, "logicalSource")[0]
        src_tok = self._get(ls_props, "source")[0]
        fmt = "csv"
        rf = self._get(ls_props, "referenceFormulation")
        if rf and "JSON" in str(rf[0]).upper():
            fmt = "json"
        elif rf and "TSV" in str(rf[0]).upper():
            fmt = "tsv"  # ql:TSV — tab-delimited, same reader, different split
        iterator = None
        it = self._get(ls_props, "iterator")
        if it:
            iterator = self.expand(it[0])
        source = LogicalSource(path=self.expand(src_tok), fmt=fmt, iterator=iterator)

        sm_props = self._get(props, "subjectMap")[0]
        subject = self.build_term_map(sm_props)
        cls = self._get(sm_props, "class")
        subject_class = self.expand(cls[0]) if cls else None

        poms = []
        for pom_props in self._get(props, "predicateObjectMap"):
            pred = self.expand(self._get(pom_props, "predicate")[0])
            om_entries = self._get(pom_props, "objectMap")
            if not om_entries:
                raise SyntaxError(f"predicateObjectMap without objectMap in {name}")
            om_props = om_entries[0]
            parent = self._get(om_props, "parentTriplesMap")
            if parent:
                pname = str(parent[0])
                pname = (pname[1:-1] if pname.startswith("<") else pname).lstrip("#")
                join = None
                jc = self._get(om_props, "joinCondition")
                if jc:
                    child = self.expand(self._get(jc[0], "child")[0])
                    par = self.expand(self._get(jc[0], "parent")[0])
                    join = JoinCondition(child=child, parent=par)
                obj: TermMap | RefObjectMap = RefObjectMap(
                    parent_triples_map=pname, join=join
                )
            else:
                obj = self.build_term_map(om_props)
            poms.append(PredicateObjectMap(predicate=pred, object_map=obj))

        return TriplesMap(
            name=name,
            source=source,
            subject=subject,
            subject_class=subject_class,
            poms=tuple(poms),
        )


def parse(text: str) -> MappingDocument:
    return _Parser(_tokenize(text)).parse()


def parse_file(path: str) -> MappingDocument:
    with open(path, encoding="utf-8") as f:
        return parse(f.read())
