"""``repro_torch.serve`` — SPARQL-lite query algebra + batching query server.

The serving half of the KG lifecycle, layered over ``repro_torch.kg`` stores:

* :mod:`repro_torch.serve.algebra` — the query IR (``SelectQuery``: BGP +
  UNION + OPTIONAL + FILTER + projection / GROUP BY + COUNT / DISTINCT /
  ORDER BY / LIMIT) and its parser.
* :mod:`repro_torch.serve.plan`    — cost-based planner: index-measured scan
  cardinalities, greedy connected join ordering, filter pushdown.
* :mod:`repro_torch.serve.exec`    — the batched executor: a whole plan (and
  a whole batch of same-shape queries) runs as one device dispatch;
  bindings never materialize on host between joins.
* :mod:`repro_torch.serve.fastpath` — batches of at most 64 chain queries
  through one launch of kernel K4 (``csrc/scan_join.cu``) on the card.
* :mod:`repro_torch.serve.values`  — literal value side tables (numeric/string
  ranks) decoded once per store for FILTER evaluation on term ids.
* :mod:`repro_torch.serve.server`  — long-lived socket server micro-batching
  concurrent clients by plan signature; :mod:`repro_torch.serve.client`
  talks to it (newline-delimited JSON, the JAX package's protocol).
* :mod:`repro_torch.serve.oracle`  — the naive full-algebra oracle anchoring the
  tests.

Entry points: ``repro_torch.api.connect``,
``python -m repro_torch.launch.query --kg out.kgz`` and
``python -m repro_torch.launch.serve --kg out.kgz``.
"""

from repro_torch.serve.algebra import Count, SelectQuery, parse_select
from repro_torch.serve.exec import BatchResult, Executor, get_executor, solve_select
from repro_torch.serve.oracle import oracle_select
from repro_torch.serve.plan import Plan, plan_query

__all__ = [
    "BatchResult",
    "Count",
    "Executor",
    "Plan",
    "SelectQuery",
    "get_executor",
    "oracle_select",
    "parse_select",
    "plan_query",
    "solve_select",
]
