"""``repro_torch.stream`` — block-based streaming ingestion for out-of-core KG creation.

The subsystem follows the lazy-Dataset / partitioned-Block shape of modern
streaming data engines: a :class:`Dataset` records a *logical plan*
(``read -> project -> map -> encode -> batch``) and only touches data when
iterated, at which point the plan is lowered to a pipelined *physical plan*
(fused per-block operators behind a bounded prefetch queue).  Sources are
read in fixed-row chunks, so no full source column is ever materialized on
the host — the architectural prerequisite for the engine scaling past RAM.
"""

from repro_torch.stream.block import Block
from repro_torch.stream.dataset import (
    DEFAULT_BLOCK_ROWS,
    Dataset,
    read_csv,
    read_json,
    read_source,
)
from repro_torch.stream.datasource import (
    CSVDatasource,
    Datasource,
    GlobDatasource,
    JSONDatasource,
    ReadTask,
)

__all__ = [
    "Block",
    "Dataset",
    "DEFAULT_BLOCK_ROWS",
    "read_csv",
    "read_json",
    "read_source",
    "Datasource",
    "CSVDatasource",
    "JSONDatasource",
    "GlobDatasource",
    "ReadTask",
]
