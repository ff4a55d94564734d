"""Dictionary encoding — strings leave the host, int32 ids go to the device.

The global :class:`Dictionary` maps every distinct RDF term *value* to a dense
int32 id.  Equality of ids == equality of strings across columns and sources,
which is what makes join keys comparable on device (DESIGN.md §2).  Bulk
encoding is vectorized with ``np.unique``; only the per-dictionary novel
values pay a Python-dict insertion.
"""

from __future__ import annotations

import numpy as np

_SEP = "\x1f"  # joins multi-column template values; cannot occur in CSV cells


class Dictionary:
    """Bidirectional str <-> int32, append-only."""

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = []

    def __len__(self) -> int:
        return len(self._to_str)

    def encode_scalar(self, value: str) -> int:
        vid = self._to_id.get(value)
        if vid is None:
            vid = len(self._to_str)
            self._to_id[value] = vid
            self._to_str.append(value)
        return vid

    def encode(self, values: np.ndarray) -> np.ndarray:
        """Vectorized bulk encode of a 1-D string array -> int32 ids."""
        values = np.asarray(values)
        uniq, inverse = np.unique(values, return_inverse=True)
        uniq_ids = np.fromiter(
            (self.encode_scalar(str(u)) for u in uniq), dtype=np.int32, count=len(uniq)
        )
        return uniq_ids[inverse].astype(np.int32)

    def decode(self, ids: np.ndarray) -> np.ndarray:
        table = np.asarray(self._to_str, dtype=object)
        return table[np.asarray(ids)]

    def decode_scalar(self, vid: int) -> str:
        return self._to_str[int(vid)]

    def strings(self) -> list[str]:
        """The id -> string table (ids are positions) — for persistence."""
        return list(self._to_str)

    @classmethod
    def from_strings(cls, strings: list[str]) -> "Dictionary":
        """Rebuild from a persisted id -> string table."""
        d = cls()
        d._to_str = list(strings)
        d._to_id = {s: i for i, s in enumerate(strings)}
        return d


def join_columns(columns: list[np.ndarray]) -> np.ndarray:
    """Combine multi-placeholder template columns into one value string."""
    if len(columns) == 1:
        return np.asarray(columns[0])
    out = np.asarray(columns[0]).astype(object)
    for col in columns[1:]:
        out = out + _SEP
        out = out + np.asarray(col).astype(object)
    return out


def render_template(pattern: str, value: str) -> str:
    """Inverse of the encoding for output materialization: fill the ``{}``
    slots of a canonical pattern with the (possibly multi-part) value."""
    parts = value.split(_SEP)
    out, i = [], 0
    for chunk in pattern.split("{}"):
        out.append(chunk)
        if i < len(parts):
            out.append(parts[i])
            i += 1
    # pattern.split yields len(parts)+1 chunks for a well-formed pair
    return "".join(out)
