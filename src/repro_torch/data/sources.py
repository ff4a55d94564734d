"""Columnar source readers: CSV and JSON-lines, no pandas dependency.

Each reader returns ``dict[column] -> np.ndarray[object]`` — the columnar
form the encoder and pipeline operate on.  Sources are loaded exactly once
per executor run and cached by path (the paper: "avoid ... uploading the
parent triples map's data source of a join multiple times").
"""

from __future__ import annotations

import csv
import json

import numpy as np


def load_csv(path: str, delimiter: str = ",") -> dict[str, np.ndarray]:
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=delimiter)
        header = next(reader)
        cols: list[list[str]] = [[] for _ in header]
        for row in reader:
            for i, cell in enumerate(row):
                cols[i].append(cell)
    return {h: np.array(c, dtype=object) for h, c in zip(header, cols)}


def expand_iterator(record, iterator: str | None) -> list:
    """Apply the '$.items'-style dotted iterator path to one parsed record.

    Shared by the eager loader and the streamed JSON datasource so the two
    paths can never drift apart on iterator semantics."""
    if not iterator:
        return [record]
    sel = iterator.lstrip("$").strip(".")
    if not sel:
        return [record]
    node = record
    for part in sel.split("."):
        node = node[part]
    return node if isinstance(node, list) else [node]


def records_to_columns(records: list) -> dict[str, np.ndarray]:
    """Rows -> columns with key union across ALL records (heterogeneous rows
    would otherwise silently drop fields absent from records[0]); missing
    cells become "".  Shared by the eager loader and ``stream.Block``."""
    keys: dict[str, None] = {}
    for r in records:
        for k in r:
            keys.setdefault(k, None)
    return {
        k: np.array([str(r.get(k, "")) for r in records], dtype=object) for k in keys
    }


def load_json(path: str, iterator: str | None = None) -> dict[str, np.ndarray]:
    """JSON-lines or a top-level array; ``iterator`` selects a nested list
    field (a '$.items'-style path with dots)."""
    with open(path, encoding="utf-8") as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            records = json.load(f)
        else:
            records = [json.loads(line) for line in f if line.strip()]
    if iterator:
        out = []
        for r in records:
            out.extend(expand_iterator(r, iterator))
        records = out
    if not records:
        return {}
    return records_to_columns(records)


def load(path: str, fmt: str = "csv", iterator: str | None = None):
    if fmt == "csv":
        return load_csv(path)
    if fmt == "tsv":
        return load_csv(path, delimiter="\t")
    if fmt == "json":
        return load_json(path, iterator)
    raise ValueError(f"unsupported source format {fmt!r}")


class SourceCache:
    """Per-run cache so each logical source is read and encoded once."""

    def __init__(self, root: str = "."):
        self.root = root
        self._cache: dict[str, dict[str, np.ndarray]] = {}

    def get(self, source) -> dict[str, np.ndarray]:
        from repro_torch.rml.model import source_key

        key = source_key(source)
        if key not in self._cache:
            import os

            path = source.path
            if not os.path.isabs(path):
                path = os.path.join(self.root, path)
            self._cache[key] = load(path, source.fmt, source.iterator)
        return self._cache[key]
