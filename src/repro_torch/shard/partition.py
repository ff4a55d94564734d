"""Subject-hash partitioning — one ``TripleStore`` into N shard stores.

The assignment rule (pinned by the manifest's ``partition`` spec) is

    shard(triple) = crc32(utf-8 rendered subject term) % n_shards

Term *ids* are ranks of rendered term strings and therefore differ
between builds (and between shards), so the hash runs over the rendered
subject — the stable content those ids rank.  Everything downstream
leans on one consequence: all triples sharing a subject land on one
shard, so any solution whose matched triples share a subject (single
patterns, star BGPs, bound-subject queries) is found on exactly one
shard and on no other — scatter/gather needs no cross-shard dedup.

Each shard store is a normal :class:`~repro_torch.kg.store.TripleStore` built
with :meth:`~repro_torch.kg.store.TripleStore.from_ntriples`, carrying its own
term dictionary; results cross the merge as rendered terms, whose sort
order equals every store's term-id order, so the coordinator's merge
reproduces the unsharded engine's deterministic ordering exactly.
"""

from __future__ import annotations

import zlib

import numpy as np

from repro_torch.kg.store import TripleStore

# bump when the assignment rule changes; load_manifest rejects specs this
# build cannot reproduce
HASH_NAME = "crc32"
PARTITION_SPEC = {"by": "subject", "hash": HASH_NAME}


def shard_of_term(rendered_subject: str, n_shards: int) -> int:
    """The shard a subject's triples live on.  crc32 is stable across
    Python versions, processes and platforms — a manifest written on one
    machine routes identically on every other."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(rendered_subject.encode("utf-8")) % n_shards


def partition_triples(
    triples, n_shards: int
) -> "list[list[tuple[str, str, str]]]":
    """Rendered ``(s, p, o)`` triples -> one bucket per shard."""
    buckets: list[list[tuple[str, str, str]]] = [[] for _ in range(n_shards)]
    for t in triples:
        buckets[shard_of_term(t[0], n_shards)].append(tuple(t))
    return buckets


def partition_store(
    store: TripleStore, n_shards: int
) -> "list[list[tuple[str, str, str]]]":
    """Partition an existing store's triples by subject hash.  Hashing is
    vectorized over *distinct* subject ids (each rendered once), then
    broadcast to the triple rows — O(distinct subjects) string work."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    subj_ids = np.unique(store.s)
    shard_by_id = np.zeros(
        int(subj_ids.max()) + 1 if len(subj_ids) else 1, np.int32
    )
    for tid in subj_ids:
        shard_by_id[int(tid)] = shard_of_term(
            store.decode_term(int(tid)), n_shards
        )
    row_shard = shard_by_id[store.s] if store.n_triples else np.zeros(0, np.int32)
    buckets: list[list[tuple[str, str, str]]] = [[] for _ in range(n_shards)]
    for i in range(store.n_triples):
        buckets[int(row_shard[i])].append(
            (
                store.decode_term(int(store.s[i])),
                store.decode_term(int(store.p[i])),
                store.decode_term(int(store.o[i])),
            )
        )
    return buckets


def build_shard_stores(
    store: TripleStore, n_shards: int
) -> "list[TripleStore]":
    """Partition and build the N shard stores in-process, on the source
    store's device (the test/local path; :mod:`repro_torch.shard.ingest`
    adds the persisted, multi-process variant)."""
    return [
        TripleStore.from_ntriples(bucket, device=store.device)
        for bucket in partition_store(store, n_shards)
    ]
