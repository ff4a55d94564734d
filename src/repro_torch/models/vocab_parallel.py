"""Vocab-parallel embedding and logits, in their no-mesh forms.

The counterpart of ``repro.models.vocab_parallel``.  With no mesh active,
JAX's ``embed`` is ``jnp.take(table, ids, axis=0)`` and ``tied_logits`` is
``h @ table.T``; the port has no mesh, so these are the forms it runs.  The
shard_map arms (the table sharded over ``model`` and ``data``, a masked
local take and a psum) wait for more than one card.
"""

from __future__ import annotations

import torch


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, d) table, (B, S) int ids -> (B, S, d)."""
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])


def tied_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(V, d) table, (B, S, d) hidden -> (B, S, V) logits."""
    return h @ table.T
