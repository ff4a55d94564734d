"""Chunked datasources: CSV/TSV, JSON(-lines), and glob-sharded multi-file.

A :class:`Datasource` exposes ``read_tasks()`` — one :class:`ReadTask` per
shard (file).  A ReadTask is a zero-arg callable yielding Blocks of at most
``block_rows`` rows; the physical executor runs the tasks in order behind a
bounded prefetch queue.  Re-invoking a task re-reads the shard, which is what
lets the engine replay a predicate after a hash-table overflow without ever
caching the source in memory.

Every source also supports **projection pushdown**: ``with_columns(keep,
strict)`` returns a copy that materializes only the ``keep`` columns — a
pruned CSV column is never even accumulated into a cell list, let alone a
numpy array.  ``strict=True`` (fixed-schema sources only) makes a missing
kept column a ``KeyError`` *at read time*, replacing the downstream strict
``Project``; sources whose schema is per-record or per-shard (JSON, globs)
refuse strict pushdown and prune tolerantly, leaving the union-fill
``Project`` in place.  The physical executor applies the rewrite when a
plan starts ``Read -> Project(pushdown=True)`` (see
:func:`repro_torch.stream.physical.pushdown_projection`).
"""

from __future__ import annotations

import csv
import dataclasses
import glob as _glob
import json
import os
from typing import Callable, Iterator, Protocol

import numpy as np

from repro_torch.data.sources import expand_iterator
from repro_torch.stream.block import Block


@dataclasses.dataclass(frozen=True)
class ReadTask:
    read: Callable[[], Iterator[Block]]
    name: str = ""


class Datasource(Protocol):
    def read_tasks(self) -> list[ReadTask]: ...


def _plan_metrics(kept: int, pruned: int) -> None:
    """Account a pushed-down projection at the point it actually takes
    effect (the reader has seen the real schema)."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    reg.inc("plan.columns_kept", kept)
    reg.inc("plan.columns_pruned", pruned)


@dataclasses.dataclass(frozen=True)
class CSVDatasource:
    """Streaming CSV/TSV reader: never holds more than one block of rows.

    Rows shorter than the header are right-padded with ""; extra cells
    beyond the header are dropped (the eager loader crashes on both).
    With ``keep`` set only those columns are accumulated — pruned cells
    are skipped before any list/array is built, which is where the
    planner's wide-source pushdown win comes from.
    """

    path: str
    block_rows: int
    delimiter: str = ","
    keep: tuple[str, ...] | None = None  # projection pushdown
    strict: bool = True  # keep column missing from header -> KeyError

    def with_columns(self, keep, strict: bool) -> "CSVDatasource":
        return dataclasses.replace(self, keep=tuple(keep), strict=strict)

    def read_tasks(self) -> list[ReadTask]:
        return [ReadTask(read=self._blocks, name=self.path)]

    def _blocks(self) -> Iterator[Block]:
        with open(self.path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            header = next(reader, None)
            if header is None:
                return
            if self.keep is None:
                names = list(header)
                idxs = list(range(len(header)))
            else:
                pos = {h: i for i, h in enumerate(header)}
                if self.strict:
                    missing = [c for c in self.keep if c not in pos]
                    if missing:
                        raise KeyError(
                            f"columns {missing} not in header of {self.path!r}"
                        )
                names = [c for c in self.keep if c in pos]
                idxs = [pos[c] for c in names]
                _plan_metrics(len(names), len(header) - len(names))
            cols: list[list[str]] = [[] for _ in names]
            n = 0
            for row in reader:
                w = len(row)
                for out, i in enumerate(idxs):
                    cols[out].append(row[i] if i < w else "")
                n += 1
                if n == self.block_rows:
                    yield Block(
                        {h: np.array(c, dtype=object) for h, c in zip(names, cols)}
                    )
                    cols = [[] for _ in names]
                    n = 0
            if n:
                yield Block(
                    {h: np.array(c, dtype=object) for h, c in zip(names, cols)}
                )

    def count_rows(self) -> int:
        """Row count without building cell arrays (cheap sizing pre-pass)."""
        with open(self.path, newline="", encoding="utf-8") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            if next(reader, None) is None:
                return 0
            return sum(1 for _ in reader)


@dataclasses.dataclass(frozen=True)
class JSONDatasource:
    """JSON-lines (streamed line-by-line) or a top-level array (parsed in one
    go — JSON arrays aren't incrementally parseable with the stdlib — but
    still emitted and processed block-at-a-time downstream)."""

    path: str
    block_rows: int
    iterator: str | None = None
    keep: tuple[str, ...] | None = None  # tolerant projection pushdown

    def with_columns(self, keep, strict: bool) -> "JSONDatasource | None":
        if strict:
            # per-record schemas: strictness is a whole-stream property the
            # executor's union validation pass owns, not a read-time check
            return None
        return dataclasses.replace(self, keep=tuple(keep))

    def read_tasks(self) -> list[ReadTask]:
        return [ReadTask(read=self._blocks, name=self.path)]

    def _blocks(self) -> Iterator[Block]:
        with open(self.path, encoding="utf-8") as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":
                records = json.load(f)
                yield from self._chunk(iter(records))
            else:
                yield from self._chunk(
                    json.loads(line) for line in f if line.strip()
                )

    def _chunk(self, parsed) -> Iterator[Block]:
        buf: list = []
        for rec in parsed:
            rows = expand_iterator(rec, self.iterator)
            if self.keep is not None:
                # pre-fill with "" so a record carrying none of the kept
                # keys still contributes a row (the union-fill Project
                # downstream would have produced exactly this block)
                rows = [
                    {k: r.get(k, "") for k in self.keep} for r in rows
                ]
            buf.extend(rows)
            while len(buf) >= self.block_rows:
                yield Block.from_records(buf[: self.block_rows])
                buf = buf[self.block_rows :]
        if buf:
            yield Block.from_records(buf)

    def count_rows(self) -> int:
        """Record count without building columns."""
        n = 0
        with open(self.path, encoding="utf-8") as f:
            head = f.read(1)
            f.seek(0)
            if head == "[":
                parsed = iter(json.load(f))
            else:
                parsed = (json.loads(line) for line in f if line.strip())
            for rec in parsed:
                n += len(expand_iterator(rec, self.iterator))
        return n


@dataclasses.dataclass(frozen=True)
class GlobDatasource:
    """Multi-file source: one shard (ReadTask) per matching file, in sorted
    path order.  Shards may have heterogeneous schemas; downstream
    ``project`` fills the union with empty strings."""

    pattern: str
    block_rows: int
    fmt: str = "csv"
    iterator: str | None = None
    delimiter: str | None = None
    keep: tuple[str, ...] | None = None  # tolerant pushdown into each shard

    def with_columns(self, keep, strict: bool) -> "GlobDatasource | None":
        if strict:
            return None  # shards may have heterogeneous schemas
        return dataclasses.replace(self, keep=tuple(keep))

    def read_tasks(self) -> list[ReadTask]:
        return [t for s in self._shards() for t in s.read_tasks()]

    def count_rows(self) -> int:
        return sum(s.count_rows() for s in self._shards())

    def _shards(self) -> list["Datasource"]:
        paths = sorted(_glob.glob(self.pattern))
        if not paths:
            # a typo'd path must fail loudly like the eager loader's open(),
            # not produce an empty KG
            raise FileNotFoundError(f"no files match source glob {self.pattern!r}")
        shards = [
            make_datasource(
                path, self.fmt, self.block_rows, self.iterator, self.delimiter
            )
            for path in paths
        ]
        if self.keep is not None:
            shards = [
                s.with_columns(self.keep, strict=False) or s for s in shards
            ]
        return shards


@dataclasses.dataclass(frozen=True)
class TableDatasource:
    """In-memory columnar table, chunked — the ``tables=`` bypass used by
    tests and by callers that already hold the data."""

    columns: dict[str, np.ndarray]
    block_rows: int
    keep: tuple[str, ...] | None = None
    strict: bool = True

    def with_columns(self, keep, strict: bool) -> "TableDatasource":
        return dataclasses.replace(self, keep=tuple(keep), strict=strict)

    def read_tasks(self) -> list[ReadTask]:
        return [ReadTask(read=self._blocks, name="<table>")]

    def _view(self) -> dict[str, np.ndarray]:
        if self.keep is None:
            return self.columns
        if self.strict:
            missing = [c for c in self.keep if c not in self.columns]
            if missing:
                raise KeyError(f"columns {missing} not in table source")
        view = {c: self.columns[c] for c in self.keep if c in self.columns}
        _plan_metrics(len(view), len(self.columns) - len(view))
        return view

    def _blocks(self) -> Iterator[Block]:
        view = self._view()
        for start in range(0, self.count_rows(), self.block_rows):
            yield Block(
                {k: v[start : start + self.block_rows] for k, v in view.items()}
            )

    def count_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))


_GLOB_CHARS = ("*", "?", "[")


def is_sharded_path(path: str) -> bool:
    """True when ``path`` is a glob pattern (and not a literal file that
    happens to contain glob metacharacters, e.g. ``data[v2]/child.csv``)."""
    return any(c in path for c in _GLOB_CHARS) and not os.path.exists(path)


def make_datasource(
    path: str,
    fmt: str,
    block_rows: int,
    iterator: str | None = None,
    delimiter: str | None = None,
) -> Datasource:
    """fmt + path -> datasource; glob patterns shard into per-file tasks."""
    if is_sharded_path(path):
        return GlobDatasource(
            pattern=path, block_rows=block_rows, fmt=fmt, iterator=iterator,
            delimiter=delimiter,
        )
    if fmt == "csv":
        return CSVDatasource(
            path=path, block_rows=block_rows, delimiter=delimiter or ","
        )
    if fmt == "tsv":
        return CSVDatasource(
            path=path, block_rows=block_rows, delimiter=delimiter or "\t"
        )
    if fmt == "json":
        return JSONDatasource(path=path, block_rows=block_rows, iterator=iterator)
    raise ValueError(f"unsupported source format {fmt!r}")
