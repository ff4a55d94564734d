"""The lazy Dataset API over partitioned Blocks.

A Dataset is an immutable logical plan; every transform returns a new
Dataset and nothing reads the source until :meth:`iter_blocks` runs the
lowered physical plan.  Iteration is repeatable — each call re-executes the
plan from the source — which is what lets the KG engine replay a predicate
(after a PTT overflow) without caching source data in memory.

    ds = (read_csv("child.csv", block_rows=8192)
          .project("MUTATION_ID", "GENE_NAME")
          .encode(dictionary)
          .batch(8192))
    for block in ds.iter_blocks():      # int32 blocks, bounded prefetch
        ...
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from repro_torch.stream import physical
from repro_torch.stream.block import Block
from repro_torch.stream.datasource import Datasource, TableDatasource, make_datasource
from repro_torch.stream.logical import Batch, Encode, LogicalOp, MapBlocks, Project, Read

DEFAULT_BLOCK_ROWS = 1 << 14


def _check_block_rows(rows: int) -> int:
    if rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {rows}")
    return rows


class Dataset:
    def __init__(self, plan: tuple[LogicalOp, ...]):
        self._plan = plan

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_source(cls, source: Datasource) -> "Dataset":
        return cls((Read(source),))

    @classmethod
    def from_table(
        cls, columns: dict[str, np.ndarray], block_rows: int = DEFAULT_BLOCK_ROWS
    ) -> "Dataset":
        return cls.from_source(
            TableDatasource(columns=columns, block_rows=_check_block_rows(block_rows))
        )

    # -- lazy transforms (each returns a new Dataset) ------------------------

    def _with(self, op: LogicalOp) -> "Dataset":
        return Dataset(self._plan + (op,))

    def project(
        self, *columns: str, fill: str | None = "", pushdown: bool = False
    ) -> "Dataset":
        """Project to ``columns``; ``fill`` is the value for columns absent
        from a block (``None`` -> strict KeyError).  ``pushdown=True``
        marks the projection for the physical rewrite that pushes it into
        the datasource (planner-driven reads; see
        :func:`repro_torch.stream.physical.pushdown_projection`)."""
        return self._with(
            Project(columns=tuple(columns), fill=fill, pushdown=pushdown)
        )

    def map_blocks(self, fn: Callable[[Block], Block]) -> "Dataset":
        return self._with(MapBlocks(fn=fn))

    def encode(self, dictionary, columns: tuple[str, ...] | None = None) -> "Dataset":
        return self._with(Encode(dictionary=dictionary, columns=columns))

    def batch(self, rows: int) -> "Dataset":
        return self._with(Batch(rows=_check_block_rows(rows)))

    # -- execution -----------------------------------------------------------

    def iter_blocks(self, prefetch: int = 2) -> Iterator[Block]:
        return physical.execute(self._plan, prefetch=prefetch)

    def count(self) -> int:
        if len(self._plan) == 1 and isinstance(self._plan[0], Read):
            counter = getattr(self._plan[0].source, "count_rows", None)
            if counter is not None:  # row count without building cell arrays
                return counter()
        return sum(b.n_rows for b in self.iter_blocks())

    def materialize(self) -> Block:
        """Concatenate every block — eager escape hatch for small data."""
        return Block.concat(list(self.iter_blocks()))

    def take(self, n: int) -> Block:
        out: list[Block] = []
        got = 0
        for block in self.iter_blocks():
            out.append(block)
            got += block.n_rows
            if got >= n:
                break
        whole = Block.concat(out)
        return whole.slice(0, min(n, whole.n_rows))

    def schema(self) -> tuple[str, ...]:
        for block in self.iter_blocks(prefetch=0):
            return block.schema
        return ()


def read_csv(
    path: str, block_rows: int = DEFAULT_BLOCK_ROWS, delimiter: str = ","
) -> Dataset:
    fmt = "tsv" if delimiter == "\t" else "csv"
    return Dataset.from_source(
        make_datasource(
            path, fmt, _check_block_rows(block_rows), delimiter=delimiter
        )
    )


def read_json(
    path: str, block_rows: int = DEFAULT_BLOCK_ROWS, iterator: str | None = None
) -> Dataset:
    return Dataset.from_source(
        make_datasource(path, "json", _check_block_rows(block_rows), iterator)
    )


def read_source(
    path: str,
    fmt: str = "csv",
    block_rows: int = DEFAULT_BLOCK_ROWS,
    iterator: str | None = None,
) -> Dataset:
    """Format-dispatching reader; glob patterns become sharded multi-file
    sources (one shard per file, heterogeneous schemas unioned on project)."""
    return Dataset.from_source(
        make_datasource(path, fmt, _check_block_rows(block_rows), iterator)
    )
