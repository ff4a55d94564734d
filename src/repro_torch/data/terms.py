"""Shared RDF term rendering — N-Triples escaping and (pattern, value) decode.

A term leaves the engine as a *(pattern id, value id)* pair into the global
:class:`~repro_torch.data.encoder.Dictionary`; this module is the single place that
turns the pair back into a concrete N-Triples term string.  It is shared by
``core.executor`` (the N-Triples dump) and ``repro_torch.kg`` (query-time binding
decode), so both emit byte-identical — and *valid* — N-Triples: literals get
full string escaping (backslash, quote, and control characters), not just
``"``.  It lives beside the encoder in ``repro_torch.data`` so the dependency DAG
stays one-directional (``data`` ← ``core`` ← ``kg``).
"""

from __future__ import annotations

import re

from repro_torch.data.encoder import Dictionary, render_template

# N-Triples ECHAR escapes; everything else in the forbidden range goes \uXXXX.
_ESCAPES = {
    "\\": "\\\\",
    '"': '\\"',
    "\n": "\\n",
    "\r": "\\r",
    "\t": "\\t",
    "\b": "\\b",
    "\f": "\\f",
}
_NEEDS_ESCAPE = re.compile(r'[\x00-\x1f"\\\x7f]')
_UNESCAPE = re.compile(r"\\(u[0-9A-Fa-f]{4}|U[0-9A-Fa-f]{8}|.)")
_ECHAR_INV = {v[1]: k for k, v in _ESCAPES.items()}  # 'n' -> '\n', ...


def escape_literal(s: str) -> str:
    """Escape a raw string for an N-Triples STRING_LITERAL_QUOTE body."""
    if not _NEEDS_ESCAPE.search(s):
        return s

    def repl(m: re.Match) -> str:
        ch = m.group(0)
        e = _ESCAPES.get(ch)
        return e if e is not None else f"\\u{ord(ch):04X}"

    return _NEEDS_ESCAPE.sub(repl, s)


def unescape_literal(s: str) -> str:
    """Inverse of :func:`escape_literal` (accepts any valid ECHAR/UCHAR)."""

    def repl(m: re.Match) -> str:
        body = m.group(1)
        if body[0] in "uU":
            return chr(int(body[1:], 16))
        return _ECHAR_INV.get(body, body)

    return _UNESCAPE.sub(repl, s)


def render_term(d: Dictionary, pat_id: int, val_id: int) -> str:
    """(pattern id, value id) -> concrete N-Triples term (``<iri>`` or
    ``"literal"``).  Patterns are the planner's namespaced strings
    (``iri:...`` / ``lit:...``); ``{}`` slots take the dictionary value."""
    pat = d.decode_scalar(pat_id)
    kind, pattern = pat.split(":", 1)
    value = d.decode_scalar(val_id) if "{}" in pattern else ""
    body = render_template(pattern, value) if "{}" in pattern else pattern
    if kind == "iri":
        return f"<{body}>"
    return '"' + escape_literal(body) + '"'


def canonical_term(token: str) -> str:
    """Normalize a user-supplied constant term (``<iri>`` or a quoted
    literal, possibly with escapes) to the exact string :func:`render_term`
    produces, so it can key a rendered-term lookup."""
    token = token.strip()
    if token.startswith("<") and token.endswith(">"):
        return token
    if token.startswith('"') and token.endswith('"') and len(token) >= 2:
        return '"' + escape_literal(unescape_literal(token[1:-1])) + '"'
    raise ValueError(f"not an N-Triples term: {token!r}")
