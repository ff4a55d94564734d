"""Sharded KG ingestion — rendered triples -> N ``.kgz`` stores + manifest.

Two parallel axes, both using *spawned* worker processes (a forked CUDA
context is unusable; every worker payload is a plain picklable tuple at
module top level, the device among it as a string, so each worker opens
its own CUDA context on the card — and finds the kernels built, or builds
them itself):

**Shard-store builds** (:func:`ingest_sharded`): the parent partitions
rendered triples by subject hash (:mod:`repro_torch.shard.partition`), then
builds and saves each shard store — serially in-process by default, or
across ``workers`` processes.  Each worker encodes with its **own
per-shard term dictionary** (term ids are ranks of rendered terms, so no
cross-shard id coordination is needed — rendered terms are the shared key
space).  The ``Pool`` join is the barrier: only after every shard store
is on disk does the parent merge the workers' term statistics into the
manifest's ``dictionary`` section and write the manifest, so a manifest
on disk always names complete, loadable shards.

**Group-parallel KG creation** (:func:`ingest_mapping_sharded`): the
mapping planner's rule groups (:mod:`repro_torch.rml.plan`) are independent by
construction — disjoint in predicates and sources — so each group's
sub-KG can be built in its own process from a sub-document of just that
group's triples maps (plus any rule-less OJM parents).  The union of the
groups' rendered triples is exactly the monolithic KG: predicates never
cross groups, and duplicate elimination is per-predicate.  Rendered
triples are the exchange format between the two stages for the same
reason they are the cross-shard key space: they are engine- and
dictionary-independent.  The stores' bytes do not depend on the device they
were built on, nor on the worker count: they equal the JAX package's.
"""

from __future__ import annotations

import multiprocessing
import os

from repro_torch.kg import persist
from repro_torch.shard.partition import PARTITION_SPEC, partition_triples


def shard_paths(manifest_path: str, n_shards: int) -> "list[str]":
    """The shard store filenames a manifest at ``manifest_path`` governs:
    ``kg.shards.json`` -> ``kg.shard0.kgz`` ... next to it."""
    base = os.path.basename(manifest_path)
    for suffix in (".shards.json", ".json"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    return [f"{base}.shard{i}.kgz" for i in range(n_shards)]


def _build_shard(job: "tuple[list, str, str]") -> dict:
    """Build one shard store from its triple bucket on the job's device
    and save it.  Runs in a worker process (or inline for the serial
    path)."""
    bucket, path, device = job
    from repro_torch.kg.store import TripleStore

    store = TripleStore.from_ntriples(bucket, device=device)
    sid = persist.save(store, path)
    return {
        "n_triples": store.n_triples,
        "n_terms": store.n_terms,
        "snapshot_id": sid,
        "generation": 0,
    }


def ingest_sharded(
    triples,
    manifest_path: str,
    n_shards: int,
    workers: int = 0,
    device="cuda",
) -> dict:
    """Partition rendered ``(s, p, o)`` triples into ``n_shards`` stores
    next to ``manifest_path``, build/save them on ``device`` (``workers``
    > 1 fans the builds across spawned processes), and write the manifest
    once every shard is durable.  Returns the manifest dict (as loaded,
    with relative shard paths)."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    triples = [tuple(t) for t in triples]
    buckets = partition_triples(triples, n_shards)
    out_dir = os.path.dirname(os.path.abspath(manifest_path))
    os.makedirs(out_dir, exist_ok=True)
    rel_paths = shard_paths(manifest_path, n_shards)
    jobs = [
        (bucket, os.path.join(out_dir, rel), str(device))
        for bucket, rel in zip(buckets, rel_paths)
    ]
    if workers > 1 and n_shards > 1:
        # spawn, not fork: a CUDA context does not survive a fork
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, n_shards)) as pool:
            stats = pool.map(_build_shard, jobs)  # the barrier
    else:
        stats = [_build_shard(job) for job in jobs]
    # barrier passed: every shard .kgz exists; merge the per-shard term
    # dictionaries' stats and only now publish the manifest
    union_terms = set()
    for s, p, o in triples:
        union_terms.add(s)
        union_terms.add(p)
        union_terms.add(o)
    manifest = {
        "format": persist.MANIFEST_FORMAT,
        "n_shards": n_shards,
        "partition": dict(PARTITION_SPEC),
        "shards": [
            {"path": rel, **st} for rel, st in zip(rel_paths, stats)
        ],
        "dictionary": {
            "n_terms_union": len(union_terms),
            "n_terms_shards": sum(st["n_terms"] for st in stats),
            "n_triples": sum(st["n_triples"] for st in stats),
        },
    }
    persist.save_manifest(manifest_path, manifest)
    return manifest


def _store_triples(store) -> "list[tuple[str, str, str]]":
    """Render a TripleStore back to ``(s, p, o)`` term-string tuples — the
    dictionary-independent form both sharding stages exchange."""
    return [
        (
            store.decode_term(int(store.s[i])),
            store.decode_term(int(store.p[i])),
            store.decode_term(int(store.o[i])),
        )
        for i in range(store.n_triples)
    ]


def shard_store(
    store, manifest_path: str, n_shards: int, workers: int = 0
) -> dict:
    """Partition an already-built :class:`~repro_torch.kg.store.TripleStore`
    into a sharded KG on disk (the ``rdfize --shards N`` tail end), the
    shard stores built on the store's device."""
    return ingest_sharded(
        _store_triples(store), manifest_path, n_shards, workers=workers,
        device=store.device,
    )


def _build_group_triples(job: "tuple[str, list, str, dict]"):
    """Build one rule group's sub-KG and render it.  Runs in a spawned
    worker process: parses the mapping text, restricts the document to the
    group's triples maps, runs the engine on ``engine_opts["device"]``,
    and returns the rendered triples plus the group's per-predicate
    statistics."""
    mapping_text, tm_names, data_root, engine_opts = job
    from repro_torch.core.executor import create_kg
    from repro_torch.rml import parser
    from repro_torch.rml.model import MappingDocument

    doc = parser.parse(mapping_text)
    sub = MappingDocument(
        triples_maps={n: doc.triples_maps[n] for n in tm_names}
    )
    result = create_kg(sub, data_root=data_root, **engine_opts)
    store = result.to_store(device=engine_opts["device"])
    return _store_triples(store), result.stats


def ingest_mapping_sharded(
    mapping_text: str,
    data_root: str,
    manifest_path: str,
    n_shards: int,
    workers: int,
    engine_opts: dict | None = None,
    device="cuda",
):
    """Group-parallel sharded KG creation: build each mapping-plan rule
    group's sub-KG in its own spawned process, union the rendered triples
    (groups are predicate-disjoint, so the union *is* the monolithic KG),
    then hash-partition into ``n_shards`` stores via
    :func:`ingest_sharded` with the same worker pool size.

    Returns ``(manifest, stats, n_triples)`` where ``stats`` merges the
    groups' per-predicate statistics back into mapping order — identical
    to a monolithic run's stats, since each group is self-contained.
    Every engine run and store build is on ``device``.
    """
    from repro_torch.rml import parser
    from repro_torch.rml.plan import build_plan

    engine_opts = dict(engine_opts or {}, device=str(device))
    doc = parser.parse(mapping_text)
    mplan = build_plan(doc)
    jobs = []
    for g in mplan.groups:
        names = list(g.triples_maps)
        for pk in g.pjtt_keys:  # rule-less OJM parents still define PJTTs
            parent = pk.split("\x1f")[0]
            if parent not in names:
                names.append(parent)
        jobs.append((mapping_text, names, data_root, engine_opts))
    if workers > 1 and len(jobs) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            built = pool.map(_build_group_triples, jobs)
    else:
        built = [_build_group_triples(job) for job in jobs]
    triples: list = []
    group_stats: dict = {}
    for trips, stats in built:
        triples.extend(trips)
        group_stats.update(stats)  # predicates never cross groups
    stats = {
        pred: group_stats[pred]
        for pred in mplan.exec_plan.by_predicate
        if pred in group_stats
    }
    manifest = ingest_sharded(
        triples, manifest_path, n_shards, workers=workers, device=device
    )
    return manifest, stats, len(set(triples))
