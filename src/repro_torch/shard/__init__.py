"""repro_torch.shard — hash-partitioned stores, scatter/gather serving, sharded
ingestion.

A sharded KG is N ordinary ``.kgz`` stores (one term dictionary each)
plus one JSON manifest pinning the partition rule
(crc32 of the rendered subject term, modulo N — see
:mod:`repro_torch.shard.partition` and the manifest format in
:mod:`repro_torch.kg.persist`).  Build one with ``rdfize --shards N`` or
:func:`repro_torch.shard.ingest.ingest_sharded`; query it through
``repro_torch.api.connect(<manifest>)`` (in-process) or a
:class:`repro_torch.shard.coordinator.Coordinator` (the NDJSON server face,
``launch.serve --kg <manifest>``).  The merge that makes shard answers
byte-identical to the unsharded engine lives in
:mod:`repro_torch.shard.merge`.
"""

from repro_torch.shard.coordinator import (  # noqa: F401
    Coordinator,
    ShardGroup,
    ShardLink,
    ShardSession,
    connect_shard_group,
    open_shard_group,
    spawn_shard_servers,
)
from repro_torch.shard.ingest import ingest_sharded, shard_store  # noqa: F401
from repro_torch.shard.merge import choose_dispatch  # noqa: F401
from repro_torch.shard.partition import (  # noqa: F401
    PARTITION_SPEC,
    build_shard_stores,
    partition_store,
    partition_triples,
    shard_of_term,
)
