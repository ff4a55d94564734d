"""Mutable delta overlay over the immutable sorted :class:`TripleStore`.

A :class:`LiveStore` makes a served KG writable without giving up the
fused single-dispatch query path:

* **Insert log** — inserted triples live in a small append set, encoded
  with the same dense term-id scheme as the base: term ids ``< base
  n_terms`` are base ids, new terms take the next ids in an append-only
  overlay (their strings interned into the *shared* base dictionary, which
  is append-only, so base decode is untouched).
* **Tombstones** — deletes of base triples record the base *row id*; the
  row stays in the sorted indexes but every query masks it out.
* **OverlayView** — an immutable snapshot the executor queries: the insert
  log re-sorted into a real (power-of-two padded) delta ``TripleStore``
  over the combined term table, plus per-order *alive prefix sums* over
  the base (``alive[r]`` = live base rows before sorted position ``r``).
  ``repro_torch.serve.exec`` runs a second range-scan arm against the
  delta index in the same batched dispatch and rank-selects the alive base
  rows, so answers over ``base ⊕ delta`` stay batch-fused and
  deterministic.  The delta index and the prefix sums live on the base
  store's device.
  Views are copy-on-write: mutations build a fresh view, in-flight query
  batches keep the one they captured.
* **Compaction** — :meth:`LiveStore.compact` rebuilds the base from the
  surviving rendered triples via :meth:`TripleStore.from_ntriples`.  That
  full canonical rebuild is what makes the snapshot guarantee hold: a
  compacted store is *byte-identical* (via :func:`repro_torch.kg.persist.save`)
  to a from-scratch build of the same triple set, no matter how the
  pre-compaction base was constructed (eager, streamed, ``.kgz`` chain).

Ordering caveat: overlay term ids are appended after the base ids, so
while live answers are deterministic (the executor's determinism sort
runs on the view's ids), they are only in canonical rendered order once
no overlay term is involved — compaction restores canonical ids.

Layering: ``live`` sits above ``kg`` and below ``serve`` consumers, but
the executor never imports it (the view is duck-typed); ``live`` imports
``serve`` only lazily inside :meth:`LiveStore.solve`.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.core.hashset import next_pow2
from repro_torch.data.terms import canonical_term
from repro_torch.kg.store import TripleStore, encode_rendered_term

_I32_MAX = int(np.iinfo(np.int32).max)


class OverlayView:
    """One immutable ``base ⊕ delta`` snapshot (see the module docstring).

    Duck-types the store surface the executor, constant encoder, value
    tables and oracle consume: ``n_triples`` / ``n_terms`` / ``term_pat``
    / ``term_val`` / ``dictionary`` / ``decode_term`` / ``term_id`` /
    ``device``.
    """

    def __init__(
        self,
        base: TripleStore,
        new_terms: tuple[str, ...],
        new_ids: dict[str, int],
        inserted: "set[tuple[int, int, int]]",
        tomb_rows: "list[int]",
    ):
        self.base = base
        self.dictionary = base.dictionary
        self.device = base.device  # where value tables over the view live
        self._new_terms = tuple(new_terms)
        self._new_ids = dict(new_ids)
        t0 = base.n_terms
        if self._new_terms:
            extra_pat = np.zeros(len(self._new_terms), np.int32)
            extra_val = np.zeros(len(self._new_terms), np.int32)
            for i, term in enumerate(self._new_terms):
                extra_pat[i], extra_val[i] = encode_rendered_term(
                    base.dictionary, term
                )
            self.term_pat = np.concatenate([base.term_pat, extra_pat])
            self.term_val = np.concatenate([base.term_val, extra_val])
        else:
            self.term_pat = base.term_pat
            self.term_val = base.term_val

        ins = sorted(inserted)
        self.n_delta = len(ins)
        self.dead = np.zeros(base.n_triples, bool)
        if tomb_rows:
            self.dead[np.asarray(tomb_rows, np.int64)] = True
        self.n_dead = int(self.dead.sum())
        self.active = bool(self.n_delta or self.n_dead)

        # the delta index: the insert log as a real TripleStore over the
        # combined term table, padded to a pow2 row capacity so delta
        # growth within a bucket reuses the cached pipelines.  Pad rows
        # carry the maximum representable id — they sort (and pack) above
        # every real row, and the executor clamps its delta ranges to the
        # live count ``n_delta``, which excludes exactly them.
        cap = next_pow2(max(self.n_delta, 1))
        n_comb = len(self.term_pat)
        if n_comb < (1 << TripleStore.KEY_BITS) - 2:
            pad_id = (1 << TripleStore.KEY_BITS) - 2
        else:
            pad_id = _I32_MAX
        cols = np.full((cap, 3), pad_id, np.int32)
        if ins:
            cols[: self.n_delta] = np.asarray(ins, np.int32)
        self.delta = TripleStore.build(
            base.dictionary, self.term_pat, self.term_val,
            cols[:, 0].copy(), cols[:, 1].copy(), cols[:, 2].copy(),
            device=base.device,
        )
        self._alive: dict[str, torch.Tensor] = {}

    # -- store-like surface ---------------------------------------------------

    @property
    def n_terms(self) -> int:
        return len(self.term_pat)

    @property
    def n_triples(self) -> int:
        """The *live* triple count (base minus tombstones plus delta)."""
        return self.base.n_triples - self.n_dead + self.n_delta

    def decode_term(self, term_id: int) -> str:
        t = int(term_id)
        if t < self.base.n_terms:
            return self.base.decode_term(t)
        return self._new_terms[t - self.base.n_terms]

    def term_id(self, rendered: str) -> int | None:
        t = self.base.term_id(rendered)
        if t is None:
            t = self._new_ids.get(rendered)
        return t

    # -- executor operands ----------------------------------------------------

    def alive(self, order: str) -> torch.Tensor:
        """int32[n_base+1] prefix sums of non-tombstoned rows in ``order``'s
        sorted sequence, on the base store's device (cached per order):
        ``alive[hi] - alive[lo]`` is a range's live count, and rank-select
        over it materializes the j-th live row."""
        a = self._alive.get(order)
        if a is None:
            perm = self.base.indexes[order].perm
            live = (~self.dead[perm]).astype(np.int64)
            a = torch.from_numpy(
                np.concatenate(
                    [np.zeros(1, np.int64), np.cumsum(live)]
                ).astype(np.int32)
            ).to(self.base.device)
            self._alive[order] = a
        return a


class LiveStore:
    """A mutable store: an immutable base plus the current overlay.

    Mutations (:meth:`insert` / :meth:`delete` / :meth:`compact`) bump
    ``generation`` and invalidate the cached view; :meth:`view` snapshots
    the overlay for query execution.  Thread-safety is the caller's
    contract — the server serializes mutations on its dispatcher thread.
    """

    def __init__(self, base: TripleStore):
        self.base = base
        self.generation = int(getattr(base, "_kgz_generation", 0))
        self._new_terms: list[str] = []
        self._new_ids: dict[str, int] = {}
        self._inserted: set[tuple[int, int, int]] = set()
        self._tomb: dict[tuple[int, int, int], int] = {}  # id-triple -> base row
        self._view: OverlayView | None = None

    # -- basics ---------------------------------------------------------------

    @property
    def n_triples(self) -> int:
        return self.base.n_triples - len(self._tomb) + len(self._inserted)

    @property
    def n_terms(self) -> int:
        return self.base.n_terms + len(self._new_terms)

    @property
    def n_delta(self) -> int:
        return len(self._inserted)

    @property
    def n_tombstones(self) -> int:
        return len(self._tomb)

    @property
    def delta_fraction(self) -> float:
        """Overlay pressure: (inserts + tombstones) / live triples — the
        signal a compaction policy (and the ``live.delta_fraction`` gauge)
        watches."""
        return (self.n_delta + self.n_tombstones) / max(self.n_triples, 1)

    def decode_term(self, term_id: int) -> str:
        t = int(term_id)
        if t < self.base.n_terms:
            return self.base.decode_term(t)
        return self._new_terms[t - self.base.n_terms]

    def term_id(self, rendered: str) -> int | None:
        return self._resolve(canonical_term(rendered))

    # -- term interning -------------------------------------------------------

    def _resolve(self, rendered: str) -> int | None:
        t = self.base.term_id(rendered)
        if t is None:
            t = self._new_ids.get(rendered)
        return t

    def _intern(self, rendered: str) -> int:
        t = self._resolve(rendered)
        if t is None:
            t = self.base.n_terms + len(self._new_terms)
            self._new_ids[rendered] = t
            self._new_terms.append(rendered)
        return t

    def _touch(self) -> None:
        self._view = None
        self.generation += 1

    # -- mutations ------------------------------------------------------------

    def insert(self, triples) -> int:
        """Insert rendered ``(s, p, o)`` term-string triples; returns how
        many were actually added (duplicates of live triples are skipped;
        inserting a tombstoned base triple resurrects it)."""
        added = 0
        tn = self.base.n_terms
        for s, p, o in triples:
            trip = (
                self._intern(canonical_term(s)),
                self._intern(canonical_term(p)),
                self._intern(canonical_term(o)),
            )
            if trip in self._tomb:
                del self._tomb[trip]
                added += 1
                continue
            if trip in self._inserted:
                continue
            if (
                trip[0] < tn and trip[1] < tn and trip[2] < tn
                and self.base.spo_row(*trip) is not None
            ):
                continue
            self._inserted.add(trip)
            added += 1
        if added:
            self._touch()
        return added

    def delete(self, triples) -> tuple[int, int]:
        """Delete rendered triples; returns ``(deleted, tombstoned)`` —
        deleting a delta-inserted triple just removes it from the insert
        log, deleting a base triple adds a tombstone, deleting an absent
        triple is a no-op."""
        deleted = tombstoned = 0
        tn = self.base.n_terms
        for s, p, o in triples:
            ids = tuple(
                self._resolve(canonical_term(t)) for t in (s, p, o)
            )
            if any(t is None for t in ids):
                continue
            if ids in self._inserted:
                self._inserted.discard(ids)
                deleted += 1
                continue
            if ids in self._tomb:
                continue
            if ids[0] < tn and ids[1] < tn and ids[2] < tn:
                row = self.base.spo_row(*ids)
                if row is not None:
                    self._tomb[ids] = row
                    deleted += 1
                    tombstoned += 1
        if deleted:
            self._touch()
        return deleted, tombstoned

    # -- snapshots ------------------------------------------------------------

    def view(self) -> OverlayView:
        """The current immutable query snapshot (cached until a mutation)."""
        if self._view is None:
            self._view = OverlayView(
                self.base,
                tuple(self._new_terms),
                self._new_ids,
                self._inserted,
                list(self._tomb.values()),
            )
        return self._view

    def _id_to_rendered(self) -> list[str]:
        base = self.base
        if base._term_ids is None:  # force the reverse map, then invert it
            base._term_ids = {
                base.decode_term(i): i for i in range(base.n_terms)
            }
        out: list[str | None] = [None] * self.n_terms
        for s, i in base._term_ids.items():
            out[i] = s
        for k, s in enumerate(self._new_terms):
            out[base.n_terms + k] = s
        return out

    def rendered_triples(self) -> list[tuple[str, str, str]]:
        """The live triple set as rendered term strings (surviving base
        rows plus the insert log) — the oracle's and compaction's input."""
        id2s = self._id_to_rendered()
        base = self.base
        keep = np.ones(base.n_triples, bool)
        if self._tomb:
            keep[np.fromiter(
                self._tomb.values(), np.int64, len(self._tomb)
            )] = False
        out = [
            (id2s[int(a)], id2s[int(b)], id2s[int(c)])
            for a, b, c in zip(base.s[keep], base.p[keep], base.o[keep])
        ]
        out += [
            (id2s[a], id2s[b], id2s[c]) for a, b, c in sorted(self._inserted)
        ]
        return out

    def compact(self) -> TripleStore:
        """Merge the overlay into a fresh canonical base and reset the
        overlay.  Always a full canonical rebuild — that is the byte-
        identity guarantee: ``save(compact())`` equals ``save`` of a
        from-scratch :meth:`TripleStore.from_ntriples` of the same triple
        set (term ids = ranks of rendered terms, deterministic snapshot
        writer), regardless of how the previous base was built."""
        new = TripleStore.from_ntriples(
            self.rendered_triples(), device=self.base.device
        )
        self.base = new
        self._new_terms = []
        self._new_ids = {}
        self._inserted = set()
        self._tomb = {}
        self._view = None
        self.generation += 1
        return new

    def _apply_snapshot(self, new_terms, ins, dels, generation: int) -> None:
        """Rehydrate the overlay from a delta snapshot (see
        :func:`repro_torch.kg.persist.load_chain`): intern the recorded overlay
        terms in order (their ids must come out exactly where the snapshot
        encoded them), replay inserted id-triples and re-resolve tombstoned
        id-triples against the parent's SPO index."""
        t0 = self.base.n_terms
        for k, term in enumerate(new_terms):
            t = self._intern(term)
            if t != t0 + k:
                raise ValueError(
                    f"delta snapshot: overlay term {term!r} resolves to id "
                    f"{t}, expected {t0 + k} — lineage mismatch"
                )
        n_all = self.n_terms
        for row in np.asarray(ins, np.int64).reshape(-1, 3):
            trip = (int(row[0]), int(row[1]), int(row[2]))
            if any(t < 0 or t >= n_all for t in trip):
                raise ValueError(
                    "delta snapshot: inserted term ids out of range "
                    "— truncated or corrupted snapshot"
                )
            self._inserted.add(trip)
        for row in np.asarray(dels, np.int64).reshape(-1, 3):
            trip = (int(row[0]), int(row[1]), int(row[2]))
            base_row = self.base.spo_row(*trip)
            if base_row is None:
                raise ValueError(
                    "delta snapshot: tombstoned triple not present in the "
                    "parent store — lineage mismatch"
                )
            self._tomb[trip] = base_row
        self.generation = int(generation)
        self._view = None

    # -- query convenience ----------------------------------------------------

    def solve(self, q):
        """Plan + execute one query (text or ``SelectQuery``) over the
        current ``base ⊕ delta`` snapshot through the fused executor."""
        from repro_torch.serve import algebra
        from repro_torch.serve.exec import get_executor

        if isinstance(q, str):
            q = algebra.parse_select(q)
        ex = get_executor(self.base)
        return ex.execute(ex.plan(q), [q], view=self.view())
