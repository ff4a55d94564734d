"""``.kgz`` snapshots — build the store once, serve it many times.

A snapshot is a plain (uncompressed) NumPy ``.npz`` archive; every member is
a flat array, so the format is mmap-friendly and versioned.  v3 adds
**lineage**: every snapshot carries a content-derived snapshot id, a parent
id, a monotonically increasing *generation* counter, and a *kind* bit that
distinguishes a full store from a **delta** snapshot (the net overlay of a
live store — new terms plus inserted and tombstoned id-triples — resolved
against its parent by :func:`load_chain`).  The bytes are the JAX
package's: a store or a live overlay saved by either package loads in the
other.

Full snapshot (kind 0):

==============  =========  ==================================================
member          dtype      contents
==============  =========  ==================================================
``meta``        int64[4]   (format version, n_triples, generation, kind=0)
``lineage``     int64[2]   (snapshot id, parent snapshot id; 0 = none)
``dict_blob``   uint8      all dictionary strings, utf-8, concatenated
``dict_off``    int64      end offset of each string into ``dict_blob``
``term_pat``    int32[T]   term id -> pattern id
``term_val``    int32[T]   term id -> value id
``s  p  o``     int32[n]   triple columns, term ids
``perm_spo``    int32[n]   sorted permutations (likewise ``perm_pos``,
                           ``perm_osp``) — load gathers, never re-sorts
==============  =========  ==================================================

Delta snapshot (kind 1, written by :func:`save_delta`; one-hop chains —
a delta always references a *full* parent):

===============  =========  =================================================
``meta``         int64[4]   (format version, n inserted, generation, kind=1)
``lineage``      int64[2]   (snapshot id, REQUIRED parent snapshot id)
``parent``       uint8      parent path, utf-8 (relative paths resolve
                            against the delta file's directory)
``term_base``    int64[1]   parent n_terms the overlay ids start at
``terms_blob``   uint8      overlay terms (rendered), utf-8, concatenated
``terms_off``    int64      end offsets into ``terms_blob``
``ins_s/p/o``    int32      inserted id-triples (sorted)
``del_s/p/o``    int32      tombstoned base id-triples (sorted)
===============  =========  =================================================

Snapshots are written with a deterministic zip encoder (fixed timestamps,
stored entries, insertion order), so *equal stores produce byte-identical
files* — the property the live compaction guarantee (`compacted ==
from-scratch rebuild`) is asserted against.
"""

from __future__ import annotations

import os
import zipfile
import zlib
from collections import OrderedDict

import numpy as np

from repro_torch.core.executor import resolve_device
from repro_torch.data.encoder import Dictionary
from repro_torch.kg.store import ORDERS, TripleStore

# v2: term ids are canonical by *rendered* term — v1 snapshots may hold the
# same RDF term under multiple encoding-keyed ids (and duplicate rendered
# triples), which yields wrong query answers, so they are rejected.
# v3: meta grew (generation, kind) and a lineage member; v2 files still
# load (generation 0, no lineage).
FORMAT_VERSION = 3
_MIN_VERSION = 2

KIND_FULL = 0
KIND_DELTA = 1


def _write_npz(path: str, members: "dict[str, np.ndarray]") -> None:
    """``np.savez`` look-alike with *deterministic* bytes: fixed zip
    timestamps, no compression, member order = dict insertion order.
    ``np.load`` reads the result unchanged."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in members.items():
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(
                    f, np.asarray(arr), allow_pickle=False
                )


def _crc_chain(h: int, arrays) -> int:
    for a in arrays:
        h = zlib.crc32(np.ascontiguousarray(a).tobytes(), h)
    return h


def content_id(store: TripleStore, generation: int) -> int:
    """Content-derived snapshot id: a crc32 chain over the id columns and
    term tables, tagged with the generation in the low 20 bits.  Collisions
    only weaken the lineage *check* (load_chain cross-validates n_terms
    too); they cannot corrupt data."""
    h = _crc_chain(
        0, (store.s, store.p, store.o, store.term_pat, store.term_val)
    )
    return (h << 20) | (generation & 0xFFFFF)


def save(
    store: TripleStore, path: str, *, generation: int = 0, parent_id: int = 0
) -> int:
    """Write a full snapshot; returns (and attaches to the store) its
    snapshot id.  ``generation`` counts mutations/compactions along the
    store's lineage; ``parent_id`` links a compacted store to the snapshot
    it grew out of."""
    sid = content_id(store, generation)
    strings = store.dictionary.strings()
    encoded = [s.encode("utf-8") for s in strings]
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    off = np.cumsum([len(e) for e in encoded], dtype=np.int64)
    members = {
        "meta": np.asarray(
            [FORMAT_VERSION, store.n_triples, generation, KIND_FULL], np.int64
        ),
        "lineage": np.asarray([sid, parent_id], np.int64),
        "dict_blob": blob,
        "dict_off": off,
        "term_pat": store.term_pat,
        "term_val": store.term_val,
        "s": store.s,
        "p": store.p,
        "o": store.o,
    }
    for order in ORDERS:
        members[f"perm_{order}"] = store.indexes[order].perm
    _write_npz(path, members)
    store._kgz_generation = generation
    store._snapshot_id = sid
    return sid


def _pack_strings(strings) -> "tuple[np.ndarray, np.ndarray]":
    encoded = [s.encode("utf-8") for s in strings]
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    off = np.cumsum([len(e) for e in encoded], dtype=np.int64)
    return blob, off


def _unpack_strings(blob: np.ndarray, off: np.ndarray) -> "list[str]":
    raw = blob.tobytes()
    out, start = [], 0
    for end in off:
        out.append(raw[start:end].decode("utf-8"))
        start = int(end)
    return out


def save_delta(live, path: str, parent_path: str) -> int:
    """Write a ``LiveStore``'s *net* overlay as a delta snapshot chained to
    the parent full snapshot at ``parent_path`` (which must already have
    been saved/loaded so its snapshot id is known).  Chains are one hop:
    a delta always references a full snapshot, and the overlay it records
    is the live store's entire current overlay."""
    base = live.base
    parent_sid = getattr(base, "_snapshot_id", None)
    if parent_sid is None:
        raise ValueError(
            "save_delta: parent store has no snapshot id — "
            "save/load the parent .kgz first"
        )
    ins = sorted(live._inserted)
    dels = sorted(live._tomb)
    ins_cols = np.asarray(ins, np.int32).reshape(-1, 3)
    del_cols = np.asarray(dels, np.int32).reshape(-1, 3)
    terms_blob, terms_off = _pack_strings(live._new_terms)
    sid = (
        _crc_chain(0, (ins_cols, del_cols, terms_blob)) << 20
    ) | (live.generation & 0xFFFFF)
    members = {
        "meta": np.asarray(
            [FORMAT_VERSION, len(ins), live.generation, KIND_DELTA], np.int64
        ),
        "lineage": np.asarray([sid, parent_sid], np.int64),
        "parent": np.frombuffer(parent_path.encode("utf-8"), dtype=np.uint8),
        "term_base": np.asarray([base.n_terms], np.int64),
        "terms_blob": terms_blob,
        "terms_off": terms_off,
        "ins_s": ins_cols[:, 0].copy(),
        "ins_p": ins_cols[:, 1].copy(),
        "ins_o": ins_cols[:, 2].copy(),
        "del_s": del_cols[:, 0].copy(),
        "del_p": del_cols[:, 1].copy(),
        "del_o": del_cols[:, 2].copy(),
    }
    _write_npz(path, members)
    return sid


def peek_meta(path: str) -> "tuple[int, int, int, int]":
    """``(format version, n, generation, kind)`` without loading the store
    (v2 files report generation 0, kind full)."""
    with np.load(path) as z:
        meta = z["meta"]
    version = int(meta[0])
    n = int(meta[1])
    generation = int(meta[2]) if len(meta) > 2 else 0
    kind = int(meta[3]) if len(meta) > 3 else KIND_FULL
    return version, n, generation, kind


def load_chain(path: str, device="cuda"):
    """Open a snapshot as a :class:`repro_torch.live.delta.LiveStore` on
    ``device`` (``cuda`` unless the caller asks for the CPU): a full
    snapshot becomes a live store with an empty overlay; a delta snapshot
    resolves its parent (path stored in the file, relative to the delta
    file's directory), verifies the lineage (parent snapshot id and term
    count must match what the delta recorded), and replays the overlay."""
    from repro_torch.live.delta import LiveStore

    version, _, generation, kind = peek_meta(path)
    if not (_MIN_VERSION <= version <= FORMAT_VERSION):
        raise ValueError(
            f"{path}: kgz format v{version}, this build reads "
            f"v{_MIN_VERSION}..v{FORMAT_VERSION}"
        )
    if kind == KIND_FULL:
        return LiveStore(open_store(path, device=device))
    with np.load(path) as z:
        parent_rel = z["parent"].tobytes().decode("utf-8")
        parent_sid = int(z["lineage"][1])
        term_base = int(z["term_base"][0])
        new_terms = _unpack_strings(z["terms_blob"], z["terms_off"])
        ins = np.stack([z["ins_s"], z["ins_p"], z["ins_o"]], axis=1)
        dels = np.stack([z["del_s"], z["del_p"], z["del_o"]], axis=1)
    parent_path = parent_rel
    if not os.path.isabs(parent_path):
        parent_path = os.path.join(os.path.dirname(path) or ".", parent_path)
    base = open_store(parent_path, device=device)
    if getattr(base, "_snapshot_id", None) != parent_sid:
        raise ValueError(
            f"{path}: parent snapshot id mismatch — {parent_path} is not "
            "the snapshot this delta was chained to"
        )
    if base.n_terms != term_base:
        raise ValueError(
            f"{path}: parent has {base.n_terms} terms, delta expects "
            f"{term_base} — lineage mismatch"
        )
    live = LiveStore(base)
    live._apply_snapshot(new_terms, ins, dels, generation)
    return live


_OPEN_STORES: OrderedDict[tuple, TripleStore] = OrderedDict()
# Sized for a sharded serving group: a coordinator keeps every shard of a
# manifest open at once (plus a generation or two of compaction rewrites),
# so the cap must comfortably exceed the largest expected shard count — a
# cap smaller than N shards would evict-thrash on every scatter.  Long-
# lived coordinators opening many shard *generations* stay bounded: old
# generations fall off the LRU tail instead of leaking.
_OPEN_STORES_MAX = 16


def set_open_store_cache_size(max_stores: int) -> None:
    """Resize the :func:`open_store` LRU (evicting oldest entries now if
    shrinking).  A coordinator serving ``N`` shards should ensure the cap
    is at least ``N`` + headroom; :mod:`repro_torch.shard.coordinator` calls
    this when a manifest names more shards than the current cap."""
    global _OPEN_STORES_MAX
    if max_stores < 1:
        raise ValueError("open_store cache needs room for at least 1 store")
    _OPEN_STORES_MAX = max_stores
    while len(_OPEN_STORES) > _OPEN_STORES_MAX:
        _OPEN_STORES.popitem(last=False)


def open_store_cache_info() -> "tuple[int, int]":
    """``(resident stores, cap)`` — test/diagnostic surface."""
    return len(_OPEN_STORES), _OPEN_STORES_MAX


def open_store(path: str, device="cuda") -> TripleStore:
    """Cached :func:`load`: the validated store (with its device index
    copies, lazy term maps, value tables and compiled query pipelines) is
    keyed by ``(realpath, mtime_ns, size, generation, device)``, so repeated
    CLI/server phases — and every client of a long-lived process — reuse
    one open store instead of re-reading and re-validating the snapshot.
    A rewritten file changes the key and reloads; the generation component
    catches a same-second same-size rewrite (mtime_ns granularity is
    filesystem-dependent, and compaction rewrites in place), and the LRU
    cap (:func:`set_open_store_cache_size`) bounds resident stores — every
    rewrite generation makes a *new* key, so without eviction a long-lived
    coordinator would accumulate one dead store per compaction."""
    st = os.stat(path)
    try:
        _, _, generation, _ = peek_meta(path)
    except Exception:
        generation = -1  # unreadable meta: let load() raise the real error
    dev = str(resolve_device(device))
    key = (os.path.realpath(path), st.st_mtime_ns, st.st_size, generation, dev)
    store = _OPEN_STORES.get(key)
    if store is None:
        store = load(path, device=dev)
        _OPEN_STORES[key] = store
        while len(_OPEN_STORES) > _OPEN_STORES_MAX:
            _OPEN_STORES.popitem(last=False)
    else:
        _OPEN_STORES.move_to_end(key)
    return store


def load(path: str, device="cuda") -> TripleStore:
    with np.load(path) as z:
        meta = z["meta"]
        version, n = int(meta[0]), int(meta[1])
        if not (_MIN_VERSION <= version <= FORMAT_VERSION):
            raise ValueError(
                f"{path}: kgz format v{version}, this build reads "
                f"v{_MIN_VERSION}..v{FORMAT_VERSION}"
            )
        generation = int(meta[2]) if len(meta) > 2 else 0
        kind = int(meta[3]) if len(meta) > 3 else KIND_FULL
        if kind != KIND_FULL:
            raise ValueError(
                f"{path}: delta snapshot; open it with load_chain()"
            )
        raw = z["dict_blob"]
        off = z["dict_off"]
        # a corrupted offset table would silently misalign every decoded
        # string while all downstream id-range checks still pass
        if (int(off[-1]) if len(off) else 0) != len(raw) or (
            len(off) and (off[0] < 0 or np.any(np.diff(off) < 0))
        ):
            raise ValueError(
                f"{path}: dictionary offsets corrupted "
                "— truncated or corrupted snapshot"
            )
        strings = _unpack_strings(raw, off)
        s, p, o = z["s"], z["p"], z["o"]
        if not (len(s) == len(p) == len(o) == n):
            raise ValueError(
                f"{path}: triple columns disagree with meta n_triples={n} "
                "— truncated or corrupted snapshot"
            )
        term_pat, term_val = z["term_pat"], z["term_val"]
        if len(term_pat) != len(term_val):
            raise ValueError(
                f"{path}: term_pat/term_val lengths disagree "
                "— truncated or corrupted snapshot"
            )
        # out-of-range ids would decode garbage terms (Python negative
        # indexing wraps silently) rather than fail
        for name, col, hi in (
            ("s", s, len(term_pat)),
            ("p", p, len(term_pat)),
            ("o", o, len(term_pat)),
            ("term_pat", term_pat, len(strings)),
            ("term_val", term_val, len(strings)),
        ):
            if len(col) and (col.min() < 0 or col.max() >= hi):
                raise ValueError(
                    f"{path}: {name} ids out of range [0, {hi}) "
                    "— truncated or corrupted snapshot"
                )
        perms = {}
        for order in ORDERS:
            perm = z[f"perm_{order}"]
            # a bad permutation (wrong length, out-of-range, or repeated row)
            # would gather garbage and answer queries silently wrong; bound
            # the values before bincount so a huge bogus entry raises here
            # instead of allocating a giant count array
            if len(perm) != n or (
                n
                and (
                    perm.min() < 0
                    or perm.max() >= n
                    or not np.array_equal(
                        np.bincount(perm, minlength=n), np.ones(n, np.int64)
                    )
                )
            ):
                raise ValueError(
                    f"{path}: perm_{order} is not a permutation of {n} rows "
                    "— truncated or corrupted snapshot"
                )
            perms[order] = perm
        sid = int(z["lineage"][0]) if version >= 3 else None
        store = TripleStore.build(
            Dictionary.from_strings(strings),
            term_pat, term_val, s, p, o, perms=perms, device=device,
        )
    # load gathers instead of re-sorting, so verify each gathered index really
    # is lexicographically non-decreasing (cheap vectorized spot-check)
    for order, idx in store.indexes.items():
        c0, c1, c2 = idx.cols
        sorted_ok = np.all(
            (c0[:-1] < c0[1:])
            | (
                (c0[:-1] == c0[1:])
                & (
                    (c1[:-1] < c1[1:])
                    | ((c1[:-1] == c1[1:]) & (c2[:-1] <= c2[1:]))
                )
            )
        )
        if not bool(sorted_ok):
            raise ValueError(
                f"{path}: index {order} is not sorted — corrupted snapshot"
            )
    store._kgz_generation = generation
    store._snapshot_id = sid if sid is not None else content_id(
        store, generation
    )
    return store


# ---------------------------------------------------------------------------
# shard manifests — one JSON file naming N partitioned .kgz shard stores
# ---------------------------------------------------------------------------

# A sharded KG is N ordinary full .kgz snapshots plus one JSON manifest:
#
#     {"format": "repro.shard/1",
#      "n_shards": 2,
#      "partition": {"by": "subject", "hash": "crc32"},
#      "shards": [{"path": "kg.shard0.kgz", "n_triples": 61,
#                  "n_terms": 40, "snapshot_id": 123, "generation": 0}, ...],
#      "dictionary": {"n_terms_union": 71, "n_terms_shards": 78,
#                     "n_triples": 120}}
#
# ``partition`` pins the assignment rule: triple -> shard by
# crc32(rendered subject term) % n_shards (repro_torch.shard.partition).  Term
# ids are ranks of rendered terms and therefore build-dependent, so the
# *rendered subject* — the stable content the id ranks — is what hashes;
# a coordinator can route a bound-subject query without any shared id
# space.  Each shard keeps its own term dictionary (rows cross the merge
# as rendered terms, whose sort order IS global term-id order);
# ``dictionary`` records the union/per-shard term totals the ingestion
# barrier merged.  Shard paths are stored relative to the manifest.

MANIFEST_FORMAT = "repro.shard/1"


def save_manifest(path: str, manifest: dict) -> None:
    import json

    if manifest.get("format") != MANIFEST_FORMAT:
        raise ValueError(
            f"manifest format must be {MANIFEST_FORMAT!r}, "
            f"got {manifest.get('format')!r}"
        )
    with open(path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")


def load_manifest(path: str) -> dict:
    """Read and validate a shard manifest; shard entries gain an
    ``abs_path`` resolved against the manifest's directory."""
    import json

    with open(path, encoding="utf-8") as f:
        m = json.load(f)
    if not isinstance(m, dict) or m.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: not a {MANIFEST_FORMAT} shard manifest")
    shards = m.get("shards")
    if not isinstance(shards, list) or len(shards) != m.get("n_shards"):
        raise ValueError(
            f"{path}: manifest shards disagree with n_shards="
            f"{m.get('n_shards')}"
        )
    part = m.get("partition", {})
    if part.get("by") != "subject" or part.get("hash") != "crc32":
        raise ValueError(
            f"{path}: unsupported partition spec {part!r} — this build "
            "reads subject/crc32 manifests"
        )
    base = os.path.dirname(os.path.abspath(path))
    for entry in shards:
        p = entry["path"]
        entry["abs_path"] = p if os.path.isabs(p) else os.path.join(base, p)
    return m


def is_manifest(path: str) -> bool:
    """Cheap sniff: does ``path`` name a shard manifest (vs a .kgz zip)?
    Reads only the first bytes — a .kgz starts with the zip magic, a
    manifest is a JSON object carrying the format marker."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
    except OSError:
        return False
    if not head.lstrip()[:1] == b"{":
        return False
    return MANIFEST_FORMAT.encode() in head
