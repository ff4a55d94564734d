"""Architecture registry of the port: the (arch x shape) cells it runs.

The counterpart of ``repro.configs.registry``, holding only the recsys
entry for now (the LM and GNN families are not ported yet).  The shapes
are the JAX package's: ``serve_p99`` and ``serve_bulk`` are forward
batches, ``retrieval_cand`` the candidates one query is scored against,
``train_batch`` the batch of a training step (an entry's ``train_shape``;
the step is ``configs.cells.recsys_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs import wide_deep

RECSYS_SHAPES = {
    "train_batch": 65536,
    "serve_p99": 512,
    "serve_bulk": 262144,
    "retrieval_cand": 1_000_000,
}


@dataclasses.dataclass
class ArchEntry:
    name: str
    family: str                      # lm | gnn | recsys
    config: Callable
    smoke_config: Callable
    shapes: tuple[str, ...]
    skips: dict[str, str]
    train_shape: str | None = None   # the shape a training step runs at


ARCHS: dict[str, ArchEntry] = {
    "wide-deep": ArchEntry(
        "wide-deep", "recsys", wide_deep.config, wide_deep.smoke_config,
        tuple(RECSYS_SHAPES), {}, train_shape="train_batch",
    ),
}


def get_arch(name: str) -> ArchEntry:
    return ARCHS[name]
