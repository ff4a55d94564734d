"""The Block: a fixed-row columnar chunk, the unit of streaming execution.

Every dataset is a sequence of Blocks; operators transform one Block at a
time, so peak host memory is O(block_rows), not O(table_rows).  Columns are
1-D numpy arrays of equal length — ``object`` (string) columns straight off
a reader, ``int32`` columns once dictionary-encoded.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class Block:
    columns: dict[str, np.ndarray]

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def schema(self) -> tuple[str, ...]:
        return tuple(self.columns)

    def select(self, names: Iterable[str], fill: str | None = "") -> "Block":
        """Project to ``names``.  Absent columns are filled with ``fill`` so
        heterogeneous shards (multi-file JSON, ragged records) line up;
        ``fill=None`` makes the projection strict (KeyError on a missing
        column — the right mode for fixed-schema sources, where a missing
        name is a mapping typo, not heterogeneity)."""
        n = self.n_rows
        out = {}
        for name in names:
            col = self.columns.get(name)
            if col is None:
                if fill is None:
                    raise KeyError(
                        f"column {name!r} not in block "
                        f"(available: {list(self.columns)})"
                    )
                col = np.full(n, fill, dtype=object)
            out[name] = col
        return Block(out)

    def slice(self, start: int, end: int) -> "Block":
        return Block({k: v[start:end] for k, v in self.columns.items()})

    @staticmethod
    def concat(blocks: list["Block"]) -> "Block":
        """Column union across blocks (heterogeneous shards fill missing
        cells with "", matching :meth:`select`)."""
        if not blocks:
            return Block({})
        names: dict[str, None] = {}
        for b in blocks:
            for k in b.columns:
                names.setdefault(k, None)
        return Block(
            {
                k: np.concatenate(
                    [
                        b.columns.get(k, np.full(b.n_rows, "", dtype=object))
                        for b in blocks
                    ]
                )
                for k in names
            }
        )

    @staticmethod
    def from_records(records: list[Mapping]) -> "Block":
        """Rows -> columns with key union across records; missing cells are
        empty strings.  Delegates to the eager loader's helper so streamed
        and eager JSON ingestion share one definition of record semantics."""
        from repro_torch.data.sources import records_to_columns

        return Block(records_to_columns(records))
