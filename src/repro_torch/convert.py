"""Carry state between the JAX package and the port.

Each function takes numpy arrays (``np.asarray`` of a JAX ``HashSet``,
``RadixTable``, ``PJTTSorted`` or ``PJTTHash`` field) and returns the
port's structure with tensors on ``device``.  uint32 words become int32
tensors with the same bits; ``u32_numpy`` goes back.  This lets an insert
that one package began continue in the other; ``store_from_arrays`` holds
both packages on one triple store without going through a file.
``state_from_params`` turns a JAX model's params (a nested dict of numpy
arrays, e.g. Wide & Deep's or an LM's) into the state dict of the port's
module, and ``kv_cache_from_numpy`` a JAX decode cache into the port's, so
a decode that JAX began continues in the port.  ``shard_state_from_params``
gives one rank of a ``ProcessMesh`` its blocks of such params by their
partition specs.  bfloat16 arrays (numpy's ``ml_dtypes`` type, as
``np.asarray`` gives a JAX bf16 array) keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashset import HashSet
from repro_torch.core.pjtt import PJTTHash, PJTTSorted
from repro_torch.kernels.ops import RadixTable
from repro_torch.models import sharding
from repro_torch.models.layers import flatten


def u32_tensor(a, device="cuda") -> torch.Tensor:
    """uint32 (or int32) numpy array -> int32 bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"expected uint32 or int32 words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 numpy array (the JAX form)."""
    return t.detach().cpu().numpy().view(np.uint32)


def hashset_from_numpy(hi, lo, device="cuda") -> HashSet:
    return HashSet(hi=u32_tensor(hi, device), lo=u32_tensor(lo, device))


def radix_table_from_numpy(hi, lo, device="cuda") -> RadixTable:
    hi, lo = u32_tensor(hi, device), u32_tensor(lo, device)
    if hi.dim() != 2 or hi.shape != lo.shape:
        raise ValueError(f"a radix table is two [n_parts, cap] arrays, got "
                         f"{tuple(hi.shape)} and {tuple(lo.shape)}")
    return RadixTable(hi=hi, lo=lo)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(device)


def pjtt_sorted_from_numpy(skeys, ssubj, device="cuda") -> PJTTSorted:
    return PJTTSorted(skeys=_i32(skeys, device), ssubj=_i32(ssubj, device))


def pjtt_hash_from_numpy(tkey, tstart, tcount, ssubj, device="cuda") -> PJTTHash:
    return PJTTHash(
        tkey=_i32(tkey, device), tstart=_i32(tstart, device),
        tcount=_i32(tcount, device), ssubj=_i32(ssubj, device),
    )


def store_from_arrays(strings, term_pat, term_val, s, p, o, perms, cols=None,
                      device="cuda"):
    """A JAX ``TripleStore``'s numpy fields -> the port's ``TripleStore`` on
    ``device``: the dictionary's strings (``Dictionary.strings()``), the
    term tables, the ``s``/``p``/``o`` columns and each index's ``perm``
    (and, to check them, its ``cols``) by order name."""
    from repro_torch.data.encoder import Dictionary
    from repro_torch.kg.store import TripleStore

    store = TripleStore.build(
        Dictionary.from_strings(list(strings)), term_pat, term_val, s, p, o,
        perms={k: np.asarray(v, np.int32) for k, v in perms.items()},
        device=device,
    )
    for order, want in (cols or {}).items():
        got = store.indexes[order].cols
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise ValueError(f"index {order}: columns disagree with s, p, o "
                             "gathered by its permutation")
    return store


def _tensor(a, device) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype and bits on ``device``."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def state_from_params(params, device="cuda") -> dict:
    """A JAX params pytree (nested dicts of arrays, ``np.asarray``-able;
    lists, such as an LM's unrolled ``blocks``, by index) -> a flat state
    dict keyed ``"mlp.fc0.w"`` or ``"blocks.0.attn.q.w"``, as the port's
    modules name their parameters; load it with ``module.load_state_dict``."""
    return {k: _tensor(v, device) for k, v in flatten(params).items()}


def shard_state_from_params(params, specs, mesh, device="cuda") -> dict:
    """``state_from_params`` for one rank of ``mesh``: each leaf's block by
    its partition spec (``specs`` a tree parallel to ``params``, e.g.
    ``recsys.param_specs(cfg)``, ``transformer.param_specs(cfg)`` or
    ``{"table": P("model", "data")}``), taken before the copy to ``device``.
    Leaves may be numpy arrays or tensors."""
    specs = flatten(specs)
    out = {}
    for k, v in flatten(params).items():
        t = v if isinstance(v, torch.Tensor) else _tensor(v, "cpu")
        out[k] = sharding.local_block(t, specs[k], mesh).to(device)
    return out


def kv_cache_from_numpy(k, v, pos, device="cuda"):
    """A JAX ``KVCache``'s fields (``np.asarray`` of each; stacked with a
    leading L axis from ``transformer.make_cache``, or one layer's) -> the
    port's ``attention.KVCache`` on ``device``: ``k``/``v`` in their dtype,
    ``pos`` int32."""
    from repro_torch.models.attention import KVCache

    k, v = _tensor(k, device), _tensor(v, device)
    pos = _i32(pos, device)
    if k.shape != v.shape or tuple(pos.shape) != tuple(k.shape[:-2]):
        raise ValueError(f"a KV cache is k and v of one shape (..., T, n_kv, D) and pos "
                         f"(..., T); got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(pos.shape)}")
    return KVCache(k=k, v=v, pos=pos)
