"""Vocab-parallel embedding and logits (the Megatron pattern).

The counterpart of ``repro.models.vocab_parallel``.  With no mesh active,
``embed`` is ``jnp.take(table, ids, axis=0)`` and ``tied_logits`` is
``h @ table.T``.  With a ``("data", "model")`` ``ProcessMesh`` active
(``sharding.set_mesh``), each runs JAX's shard_map body on this rank:

  storage : table (V, d) sharded ``P("model", "data")`` — vocab over
            ``model``, the embedding dim over ``data`` (FSDP-style)
  embed   : all-gather the d-shards over ``data`` (a transient V/m x d
            slice), a masked local take, a psum over ``model``
  logits  : ``h @ slice.T`` on each model shard -> vocab-sharded logits

A rank passes its block of the table and its block of the flattened token
stream, shaped as it likes (``(..., )`` ids, ``(..., d)`` hidden), and gets
its block of the output: rows ``(..., d)``, the same on every ``model``
rank, and logits ``(..., V/m)``.  The token layout is JAX's
(``sharding.token_spec``): split over the data-parallel axes when their
product divides the token count, else replicated (tiny decode batches),
the body the same either way.  In a sharded trace the table and tokens
are DTensors, entered by JAX's in-specs, and the output leaves as one.
"""

from __future__ import annotations

import torch

from repro_torch.models import sharding
from repro_torch.models.sharding import P


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, d) table, (B, S) int ids -> (B, S, d)."""
    if not sharding.arms_active():
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])
    flat = ids.reshape(-1)
    ids_spec = sharding.token_spec(flat.shape[0], sharding.current_mesh())
    full = sharding.all_gather(sharding.enter(table, P("model", "data")), "data", axis=1)
    ids_l = sharding.enter(flat, ids_spec)
    v_loc = full.shape[0]  # (V/m, d)
    local = ids_l - sharding.axis_index("model") * v_loc
    ok = (local >= 0) & (local < v_loc)
    rows = full.index_select(0, local.clamp(0, v_loc - 1))
    rows = sharding.psum(torch.where(ok[:, None], rows, 0), "model")
    return sharding.leave(rows, P(ids_spec[0], None)).reshape(*ids.shape, -1)


def tied_logits(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(V, d) table, (B, S, d) hidden -> (B, S, V) logits; on a mesh this
    rank's (..., V/m) vocab slice (ready for a sharded-softmax loss)."""
    if not sharding.arms_active():
        return h @ table.T
    flat = h.reshape(-1, h.shape[-1])
    h_spec = sharding.token_spec(flat.shape[0], sharding.current_mesh())
    full = sharding.all_gather(sharding.enter(table, P("model", "data")), "data", axis=1)
    logits = sharding.enter(flat, P(h_spec[0], None)) @ full.T
    return sharding.leave(logits, P(h_spec[0], "model")).reshape(*h.shape[:-1], -1)
