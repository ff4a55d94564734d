"""``repro_torch.kg`` — queryable, persistable triple store over engine output.

The creation engine (``repro_torch.core.executor``) stops at a write-only
:class:`KGResult`; this subsystem turns that into a *servable* artifact:

* :mod:`repro_torch.kg.store`   — immutable dictionary-encoded int32 ``(s, p, o)``
  columns with SPO/POS/OSP sorted permutation indexes (torch stable sorts).
* :mod:`repro_torch.kg.query`   — batched lexicographic range scans for single
  triple patterns (batched, many queries per dispatch); conjunctive BGP
  evaluation delegates to the ``repro_torch.serve`` planner + batched
  executor (one query path, shared with the query server).
* :mod:`repro_torch.kg.persist` — versioned ``.kgz`` npz snapshots (build once,
  serve many times) and the ``open_store`` cache for long-lived processes.

Term rendering (full N-Triples escaping) lives in :mod:`repro_torch.data.terms`,
shared with the engine's N-Triples dump and re-exported here.

Entry points: ``KGResult.to_store()`` and ``python -m repro_torch.launch.query``.
"""

from repro_torch.kg.query import (
    Bindings,
    TriplePattern,
    binding_set,
    decode_bindings,
    match_counts,
    match_pattern,
    oracle_solve,
    parse_bgp,
    solve,
    solve_text,
)
from repro_torch.kg.persist import load, open_store, save
from repro_torch.kg.store import TripleStore
from repro_torch.data.terms import escape_literal, render_term, unescape_literal

__all__ = [
    "Bindings",
    "TriplePattern",
    "TripleStore",
    "binding_set",
    "decode_bindings",
    "escape_literal",
    "load",
    "match_counts",
    "open_store",
    "match_pattern",
    "oracle_solve",
    "parse_bgp",
    "render_term",
    "save",
    "solve",
    "solve_text",
    "unescape_literal",
]
