"""Immutable dictionary-encoded triple store — the servable KG artifact.

The engine's :class:`~repro_torch.core.executor.KGResult` is write-only: per
predicate, parallel ``(pattern id, value id)`` int32 columns.  A
:class:`TripleStore` re-keys those pairs into a dense *term id* space (one
int32 id per distinct RDF term — subject, predicate, or object alike) and
holds the graph as three int32 columns ``(s, p, o)`` plus three sorted
permutation indexes:

* **SPO** — triples lexsorted by (subject, predicate, object)
* **POS** — by (predicate, object, subject)
* **OSP** — by (object, subject, predicate)

Every one of the 8 triple-pattern bound-position masks is a contiguous row
range of exactly one of these orders, so a pattern match is a pair of
(vectorized, batched) lexicographic binary searches — see ``repro_torch.kg.query``.
The permutations are built with torch stable argsorts on the store's
device; construction from a ``KGResult`` is array-at-a-time over the
existing int32 columns.  The numpy columns stay on the host; the
``device_*`` caches are int32 tensors on ``TripleStore.device`` (``cuda``
unless the caller asks for the CPU; no fallback).  Term
*identity* is the rendered RDF term, not the engine encoding: distinct
(pattern, value) pairs that render to the same term (a constant object map
``lit:hello`` vs. a reference column holding ``hello``) are collapsed to one
term id during construction — each distinct term is rendered exactly once for
that, and never again during query (decode happens only at output time).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.encoder import Dictionary
from repro_torch.data.terms import render_term

# index order -> the (primary, secondary, tertiary) triple positions
ORDERS: dict[str, tuple[int, int, int]] = {
    "spo": (0, 1, 2),
    "pos": (1, 2, 0),
    "osp": (2, 0, 1),
}


def _lexsort3(k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows lexicographically by (k0, k1, k2): three
    stable argsorts, least-significant key first."""
    o = torch.argsort(k2, stable=True)
    o = o[torch.argsort(k1[o], stable=True)]
    return o[torch.argsort(k0[o], stable=True)]


def _resolve_device(device) -> torch.device:
    from repro_torch.core.executor import resolve_device

    return resolve_device(device)


class Index(NamedTuple):
    """One sort order: ``perm`` maps sorted rank -> row id; ``cols`` are the
    (primary, secondary, tertiary) term-id columns in sorted order."""

    order: str
    perm: np.ndarray                                    # int32[n]
    cols: tuple[np.ndarray, np.ndarray, np.ndarray]     # int32[n] each


def _pack(pat: np.ndarray, val: np.ndarray) -> np.ndarray:
    """(pattern id, value id) int32 pairs -> one int64 key (ids are >= 0)."""
    return (pat.astype(np.int64) << 32) | val.astype(np.int64)


def encode_rendered_term(dictionary: Dictionary, term: str) -> tuple[int, int]:
    """Rendered N-Triples term -> ``(pattern id, value id)`` under the same
    scheme :meth:`TripleStore.from_ntriples` uses — shared with the live
    overlay's dictionary append so overlay terms decode/compare exactly
    like base terms."""
    from repro_torch.data.terms import unescape_literal

    if term.startswith("<"):
        kind, body = "iri", term[1:-1]
    else:
        kind, body = "lit", unescape_literal(term[1:-1])
    if "{}" in body:
        # a literal '{}' would read as a template slot: route the
        # body through the value side of the (pattern, value) pair
        if "\x1f" in body:
            raise ValueError(
                f"term body mixes '{{}}' and the multi-column "
                f"separator; not representable: {term!r}"
            )
        return (
            dictionary.encode_scalar(f"{kind}:{{}}"),
            dictionary.encode_scalar(body),
        )
    # slotless pattern: render_term never reads the value id —
    # point it at the pattern string to stay in range
    pid = dictionary.encode_scalar(f"{kind}:{body}")
    return pid, pid


@dataclasses.dataclass
class TripleStore:
    dictionary: Dictionary
    term_pat: np.ndarray   # int32[T]  term id -> pattern id
    term_val: np.ndarray   # int32[T]  term id -> value id
    s: np.ndarray          # int32[n]  term ids
    p: np.ndarray
    o: np.ndarray
    indexes: dict[str, Index]
    # where the device_* caches live (and the index sorts ran)
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"), repr=False)

    # lazy caches (device copies of index columns; rendered-term lookup)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)
    _term_ids: dict[str, int] | None = dataclasses.field(default=None, repr=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_kg(
        cls, dictionary: Dictionary, triples: dict[str, dict[str, np.ndarray]],
        device="cuda",
    ) -> "TripleStore":
        """Build from engine output (``KGResult.dictionary`` /
        ``KGResult.triples``); each distinct term is rendered once to
        canonicalize term identity by rendered string."""
        spat, sval, ppairs, opat, oval = [], [], [], [], []
        for pred, t in triples.items():
            n = len(t["subj_val"])
            spat.append(np.asarray(t["subj_pat"], np.int32))
            sval.append(np.asarray(t["subj_val"], np.int32))
            opat.append(np.asarray(t["obj_pat"], np.int32))
            oval.append(np.asarray(t["obj_val"], np.int32))
            # a predicate is a constant-iri term: pattern "iri:<pred>", value 0
            pid = dictionary.encode_scalar(f"iri:{pred}")
            ppairs.append(np.full(n, np.int64(pid) << 32, np.int64))

        def cat(chunks, dtype=np.int32):
            return (
                np.concatenate(chunks).astype(dtype)
                if chunks else np.zeros(0, dtype)
            )

        skey = _pack(cat(spat), cat(sval))
        pkey = cat(ppairs, np.int64)
        okey = _pack(cat(opat), cat(oval))
        n = len(skey)
        uniq, inv = np.unique(
            np.concatenate([skey, pkey, okey]), return_inverse=True
        )
        term_pat = (uniq >> 32).astype(np.int32)
        term_val = (uniq & 0x7FFFFFFF).astype(np.int32)
        # Term identity is the *rendered* term: distinct encodings can render
        # to the same RDF term (constant 'lit:hello' vs. reference 'lit:{}'
        # over the value 'hello'), and leaving them as separate ids makes
        # constant-bound queries match only one encoding and breaks variable
        # unification across encodings in BGP joins.  Collapse colliding
        # encodings to one canonical id (ids come out sorted by rendered
        # string) and drop the duplicate triples the merge exposes.
        rendered = np.array(
            [
                render_term(dictionary, int(p), int(v))
                for p, v in zip(term_pat, term_val)
            ]
        )
        uniq_rendered, first, remap = np.unique(
            rendered, return_index=True, return_inverse=True
        )
        term_pat = term_pat[first]
        term_val = term_val[first]
        inv = remap[inv].astype(np.int32)
        trip = np.unique(
            np.stack([inv[:n], inv[n : 2 * n], inv[2 * n :]], axis=1), axis=0
        )
        store = cls.build(
            dictionary, term_pat, term_val,
            trip[:, 0], trip[:, 1], trip[:, 2], device=device,
        )
        # term id i IS the rank of its rendered string in uniq_rendered, so
        # the reverse map term_id() would otherwise re-render lazily is
        # already in hand — seed it
        store._term_ids = {str(r): i for i, r in enumerate(uniq_rendered)}
        return store

    @classmethod
    def from_ntriples(
        cls, triples: "list[tuple[str, str, str]]", device="cuda"
    ) -> "TripleStore":
        """Build a store from rendered N-Triples terms (``<iri>`` /
        ``'"literal"'`` strings) — the test/tooling path for small ad-hoc
        graphs.  Term ids come out as ranks of the canonical rendered term,
        exactly like :meth:`from_kg`, so two stores of the same graph use
        identical ids regardless of how they were built."""
        from repro_torch.data.terms import canonical_term

        canon = sorted(
            {
                tuple(canonical_term(t) for t in trip)
                for trip in triples
            }
        )
        terms = sorted({t for trip in canon for t in trip})
        dictionary = Dictionary()
        term_pat = np.zeros(len(terms), np.int32)
        term_val = np.zeros(len(terms), np.int32)
        for i, term in enumerate(terms):
            term_pat[i], term_val[i] = encode_rendered_term(dictionary, term)
        tid = {t: i for i, t in enumerate(terms)}
        cols = np.asarray(
            [[tid[s], tid[p], tid[o]] for s, p, o in canon], np.int32
        ).reshape(-1, 3)
        store = cls.build(
            dictionary, term_pat, term_val, cols[:, 0], cols[:, 1], cols[:, 2],
            device=device,
        )
        store._term_ids = dict(tid)
        return store

    @classmethod
    def build(
        cls, dictionary, term_pat, term_val, s, p, o,
        perms: dict[str, np.ndarray] | None = None, device="cuda",
    ) -> "TripleStore":
        """Assemble the store; sort the three permutations with torch on
        ``device`` unless ``perms`` provides them (the ``.kgz`` load path —
        gather only)."""
        dev = _resolve_device(device)
        s, p, o = (np.asarray(c, np.int32) for c in (s, p, o))
        cols = (s, p, o)
        dcols = None if perms is not None else tuple(
            torch.from_numpy(c).to(dev) for c in cols)
        indexes: dict[str, Index] = {}
        for order, (a, b, c) in ORDERS.items():
            if perms is not None:
                perm = perms[order]
            else:
                perm = _lexsort3(dcols[a], dcols[b], dcols[c]).to(
                    torch.int32).cpu().numpy()
            indexes[order] = Index(
                order=order,
                perm=perm,
                cols=(cols[a][perm], cols[b][perm], cols[c][perm]),
            )
        return cls(
            dictionary=dictionary,
            term_pat=np.asarray(term_pat, np.int32),
            term_val=np.asarray(term_val, np.int32),
            s=np.asarray(s, np.int32), p=np.asarray(p, np.int32),
            o=np.asarray(o, np.int32),
            indexes=indexes,
            device=dev,
        )

    # -- basics --------------------------------------------------------------

    @property
    def n_triples(self) -> int:
        return len(self.s)

    @property
    def n_terms(self) -> int:
        return len(self.term_pat)

    def device_cols(self, order: str) -> tuple:
        """Index columns as int32 tensors on the store's device (cached)."""
        if order not in self._dev:
            self._dev[order] = tuple(
                torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
                for c in self.indexes[order].cols
            )
        return self._dev[order]

    # term ids must fit KEY_BITS for the packed range-search keys; beyond
    # that the executor falls back to the 3-column lexicographic scan
    KEY_BITS = 21

    def device_keys(self, order: str):
        """The index's (primary, secondary, tertiary) columns packed into
        one *sorted* 63-bit key per row, split into two int32 device
        columns ``(hi, lo)`` — the JAX package's layout, kept so the search
        kernel compares two int32 words; the low word carries the unsigned->signed bias (XOR of the
        sign bit) to keep int32 comparisons order-preserving.  Fields are
        shifted +1 so the ``-1`` wildcard packs below every real id.  A
        lexicographic range scan becomes a 2-column binary search (one
        round per bit of the row count, 2 gathers per round, vs 32x3 for
        the general scan).  ``None`` when term ids overflow the fields."""
        if self.n_terms >= (1 << self.KEY_BITS) - 2:
            return None
        cache_key = f"keys_{order}"
        if cache_key not in self._dev:
            c0, c1, c2 = self.indexes[order].cols
            b = self.KEY_BITS
            packed = (
                ((c0.astype(np.int64) + 1) << (2 * b))
                | ((c1.astype(np.int64) + 1) << b)
                | (c2.astype(np.int64) + 1)
            )
            khi = (packed >> 32).astype(np.int32)
            klo = (
                (packed & 0xFFFFFFFF).astype(np.uint32)
                ^ np.uint32(0x80000000)
            ).view(np.int32)
            self._dev[cache_key] = (
                torch.from_numpy(khi).to(self.device),
                torch.from_numpy(np.ascontiguousarray(klo)).to(self.device),
            )
        return self._dev[cache_key]

    def device_primary_starts(self, order: str):
        """``starts[t] .. starts[t+1]`` is the row range whose *primary*
        column equals term ``t`` — seeds a range search so it bisects only
        that term's rows (e.g. one subject's few triples) instead of the
        whole index."""
        cache_key = f"prim_{order}"
        if cache_key not in self._dev:
            c0 = self.indexes[order].cols[0]
            starts = np.searchsorted(
                c0, np.arange(self.n_terms + 1)
            ).astype(np.int32)
            self._dev[cache_key] = torch.from_numpy(starts).to(self.device)
        return self._dev[cache_key]

    def primary_rounds(self, order: str) -> int:
        """Bisection rounds that cover the widest primary-term row range of
        this index (static per store: it sizes the search loop)."""
        cache_key = f"prim_rounds_{order}"
        cached = self._dev.get(cache_key)
        if cached is None:
            starts = self.device_primary_starts(order).cpu().numpy()
            widest = int(np.max(np.diff(starts))) if self.n_terms else 1
            cached = max(1, widest.bit_length())
            self._dev[cache_key] = cached
        return cached

    def spo_row(self, s: int, p: int, o: int) -> int | None:
        """Row id holding the id-triple ``(s, p, o)``, ``None`` when the
        store does not contain it — a host-side bisect over the sorted SPO
        index (the live overlay's duplicate/tombstone resolution path)."""
        idx = self.indexes["spo"]
        c0, c1, c2 = idx.cols
        # keys of the columns' dtype: a Python int makes numpy search an
        # int64 copy of the whole column (a 1M-row store: ~0.8 ms a call)
        s, p, o = (c0.dtype.type(x) for x in (s, p, o))
        lo = int(np.searchsorted(c0, s, side="left"))
        hi = int(np.searchsorted(c0, s, side="right"))
        lo2 = lo + int(np.searchsorted(c1[lo:hi], p, side="left"))
        hi2 = lo + int(np.searchsorted(c1[lo:hi], p, side="right"))
        j = lo2 + int(np.searchsorted(c2[lo2:hi2], o, side="left"))
        if j < hi2 and int(c2[j]) == o:
            return int(idx.perm[j])
        return None

    # -- term decode / encode ------------------------------------------------

    def decode_term(self, term_id: int) -> str:
        return render_term(
            self.dictionary, int(self.term_pat[term_id]), int(self.term_val[term_id])
        )

    def term_id(self, rendered: str) -> int | None:
        """Rendered N-Triples term string -> term id (None if absent).  The
        reverse map is rendered once, lazily, on first constant lookup."""
        if self._term_ids is None:
            self._term_ids = {
                self.decode_term(i): i for i in range(self.n_terms)
            }
        return self._term_ids.get(rendered)

    def iter_ntriples(self):
        """Render in SPO index order (deterministic, sorted by term id)."""
        perm = self.indexes["spo"].perm
        for row in perm:
            yield (
                f"{self.decode_term(self.s[row])} "
                f"{self.decode_term(self.p[row])} "
                f"{self.decode_term(self.o[row])} ."
            )
