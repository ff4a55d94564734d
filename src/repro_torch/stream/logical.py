"""Logical plan nodes — what a Dataset *will* do, recorded lazily.

The plan is a linear chain ``Read -> (Project | MapBlocks | Encode)* ->
Batch?``.  Nothing here executes; :mod:`repro_torch.stream.physical` lowers the
chain by (a) rewriting a leading ``Read -> Project(pushdown=True)`` pair
into the datasource itself — the reader then never materializes a pruned
column (see :func:`repro_torch.stream.physical.pushdown_projection`) — and
(b) fusing all consecutive per-block transforms into one operator so a
block makes a single pass through Python per stage boundary.

``Project`` carries the planner-relevant policy in two fields:

* ``fill`` — ``""`` union-fills columns missing from a block (the right
  semantics for heterogeneous JSON records and glob shards); ``None`` is
  *strict* and raises ``KeyError`` on a missing column, which is what the
  mapping planner (:mod:`repro_torch.rml.plan`) demands for fixed-schema
  sources — a missing mapped column is a typo, not heterogeneity, and
  must fail loudly rather than fabricate empty-string terms.
* ``pushdown`` — opt-in marker set by planner-driven projections; only a
  marked Project is pushed into the reader, so ad-hoc Dataset users (and
  the planner-off reference path) keep the read-everything behavior.

``Encode`` is the one stateful node: its dictionary is shared and
append-only, so ids are stable across blocks and across overflow replays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.stream.block import Block
from repro_torch.stream.datasource import Datasource


@dataclasses.dataclass(frozen=True)
class LogicalOp:
    pass


@dataclasses.dataclass(frozen=True)
class Read(LogicalOp):
    source: Datasource


@dataclasses.dataclass(frozen=True)
class Project(LogicalOp):
    columns: tuple[str, ...]
    fill: str | None = ""  # None -> strict (KeyError on missing column)
    pushdown: bool = False  # planner-driven: push into the datasource


@dataclasses.dataclass(frozen=True)
class MapBlocks(LogicalOp):
    fn: Callable[[Block], Block]


@dataclasses.dataclass(frozen=True)
class Encode(LogicalOp):
    """Incremental dictionary encoding: every non-integer column of each
    block is replaced by its int32 id column.  The dictionary is shared and
    append-only, so ids are stable across blocks and across replays."""

    dictionary: object  # repro_torch.data.encoder.Dictionary (duck-typed: .encode)
    columns: tuple[str, ...] | None = None  # None -> all string columns

    def apply(self, block: Block) -> Block:
        out = {}
        for name, col in block.columns.items():
            wanted = self.columns is None or name in self.columns
            if wanted and not np.issubdtype(col.dtype, np.integer):
                out[name] = self.dictionary.encode(col)
            else:
                out[name] = col
        return Block(out)


@dataclasses.dataclass(frozen=True)
class Batch(LogicalOp):
    """Re-chunk the stream to exactly ``rows`` rows per block (final block
    may be short — the consumer pads it and carries a validity mask)."""

    rows: int
