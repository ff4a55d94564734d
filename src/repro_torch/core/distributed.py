"""Distributed PTT/PJTT — the paper's operators over hash-owned shards.

The counterpart of ``repro.core.distributed``.  The hash space is the
shard axis: a triple's *owner* shard is a hash of its 64-bit key, so every
shard holds a disjoint slice of the PTT and duplicate elimination is exact
with no cross-shard races.  The shuffle is one all-to-all of key traffic
followed by a purely local batched insert, plus a second all-to-all that
routes the ``is_new`` verdicts back to the producers.  The PJTT is
distributed the same way: parent (key, subject) pairs are shuffled by
join-key owner, each shard builds a local sorted index, and OJM probes are
shuffled to the owner and answered in place.

JAX runs one shard per device of a mesh under ``shard_map``.  Each
function here has two arms, picked by its first argument:

* a ``launch.mesh.ProcessMesh``: one shard a rank, SPMD in every rank's
  process.  A rank passes and gets back the blocks JAX's shard_map body
  sees: the table's ``(1, cap)`` shard, and its contiguous slice of the
  keys (``sharding.local_block(x, P(axes), mesh)``; the overflow flag is
  the same on every rank).  ``all_to_all(x, axes, 0, 0)`` is
  ``all_to_all_single`` over the whole mesh, ``pmax(flag) > 0`` an
  ``all_reduce(MAX)``;
* ``n_shards``, an int: the shards stacked on axis 0 of tensors on one
  device, global inputs of length ``n`` split into ``n_shards``
  contiguous slices, as JAX's ``P(axes)`` splits them in mesh order.  Each
  collective becomes the operation that gives the same bits: the
  all-to-all of the per-shard ``[S, cap]`` send buffers is
  ``transpose(0, 1)`` of the stacked ``[S_src, S_dst, cap]`` tensor, and
  the ``pmax`` is ``any`` over shards.  The per-shard insert, sort and
  span expansion run one shard after another.

Both arms run the same code on a ``[S, ...]`` stack of shards (``S`` = 1
on a rank) and give the same bits as JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hashing, hashset, pjtt
from repro_torch.core.hashing import EMPTY
from repro_torch.models import sharding

# Default slack factor for the fixed-capacity all-to-all bins.  With random
# hash owners the per-bucket load is Binomial(n_local, 1/S); 4x the mean keeps
# the overflow probability negligible for n_local >= 1k.
BIN_SLACK = 4

_PAD_KEY = 2**31 - 1  # sorts to the end; never a dictionary id


class ShardedPTT(NamedTuple):
    """PTT whose rows are split over ``n_shards`` shards (axis 0)."""

    hi: torch.Tensor  # int32[n_shards, cap_per_shard] (uint32 bit patterns)
    lo: torch.Tensor  # int32[n_shards, cap_per_shard]


class ShardedPJTT(NamedTuple):
    """Per-shard sorted join index over owner-shuffled parent pairs."""

    skeys: torch.Tensor  # int32[n_shards, cap]   sorted within shard, _PAD_KEY at END
    ssubj: torch.Tensor  # int32[n_shards, cap]


class _Stacked:
    """``n`` shards stacked on axis 0 of one device's tensors."""

    def __init__(self, n: int):
        self.n, self.rows = n, n

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[n] -> [n_shards, n / n_shards], the contiguous per-shard slices."""
        if x.shape[0] % self.n:
            raise ValueError(f"{x.shape[0]} lanes do not split into {self.n} equal shards")
        return x.reshape(self.n, -1)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Per-source [S, n_shards * cap, ...] buffers, chunk d for shard d ->
        per-destination [S, n_shards * cap, ...] buffers in source order."""
        x = send.reshape(self.n, self.n, -1, *send.shape[2:])
        return x.transpose(0, 1).reshape(send.shape)

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        return flags.any()


class _Rank:
    """This rank's one shard, on axis 0, of a ``ProcessMesh`` of shards."""

    def __init__(self, mesh):
        self.mesh, self.n, self.rows = mesh, mesh.size, 1

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return x[None]

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        return sharding.all_to_all(send[0], self.mesh.axis_names, self.mesh)[None]

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        flag = flags.any().to(torch.int32)
        return sharding.pmax(flag, self.mesh.axis_names, self.mesh) > 0


def _shards(mesh):
    return _Stacked(mesh) if isinstance(mesh, int) else _Rank(mesh)


def make_sharded_ptt(mesh, capacity_total: int, device="cuda") -> ShardedPTT:
    """An empty PTT of ``capacity_total`` slots over the shards of ``mesh``
    (``n_shards``, or a ``ProcessMesh``: this rank's ``(1, cap)`` shard)."""
    sh = _shards(mesh)
    cap = hashset.next_pow2(max(capacity_total // sh.n, 8))
    return ShardedPTT(
        hi=torch.full((sh.rows, cap), EMPTY, dtype=torch.int32, device=device),
        lo=torch.full((sh.rows, cap), EMPTY, dtype=torch.int32, device=device),
    )


def _owner(key_hi: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of a key.  Uses a re-mixed lane so the owner bits are
    independent of the slot bits (key_lo & mask) used inside the local
    table; the modulo is taken on the unsigned word, as in JAX."""
    return (hashing.fmix32(hashing.u32(key_hi) ^ 0xA5A5A5A5) % n_shards).to(torch.int32)


def _bin_cap(n_local: int, n_shards: int) -> int:
    return max(BIN_SLACK * ((n_local + n_shards - 1) // n_shards), 1)


def _bin_by_owner(owner: torch.Tensor, n_shards: int, cap: int, valid: torch.Tensor):
    """Group each shard's lane indices by owner into an (n_shards, cap)
    routing plan; every argument and result has the source shard on axis 0.

    Returns (dest_by_lane [S, n_local] int64 with -1 for overflow/invalid,
    send_index [S, n_shards*cap] int64 gather map with -1 for empty, the
    per-source overflow flags [S]).
    """
    S, n = owner.shape
    dev = owner.device
    owner_v = torch.where(valid, owner, n_shards).to(torch.int64)  # invalid -> virtual bucket
    order = torch.argsort(owner_v, dim=1, stable=True)
    sorted_owner = torch.gather(owner_v, 1, order)
    buckets = torch.arange(n_shards + 1, dtype=torch.int64, device=dev).expand(S, -1)
    starts = torch.searchsorted(sorted_owner, buckets.contiguous())
    rank = torch.arange(n, dtype=torch.int64, device=dev) - torch.gather(starts, 1, sorted_owner)
    real = sorted_owner < n_shards
    ok = real & (rank < cap)
    dest = torch.where(ok, sorted_owner * cap + rank, -1)
    # scatter the original lane index into the send buffer; lane n_shards*cap
    # of each row takes the lanes JAX drops, and is cut off
    send_index = torch.full((S, n_shards * cap + 1), -1, dtype=torch.int64, device=dev)
    send_index.scatter_(1, torch.where(ok, dest, n_shards * cap), order)
    overflow = (real & (rank >= cap)).any(dim=1)
    # dest per ORIGINAL lane (for the route-back un-permute)
    dest_by_lane = torch.empty_like(dest).scatter_(1, order, dest)
    return dest_by_lane, send_index[:, :-1], overflow


def _gather_or(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Row-wise ``x[s][idx[s]]`` where ``idx >= 0``, else ``fill``; gathers
    along axis 1 (and broadcasts over any trailing axes of ``x``)."""
    safe = idx.clamp(0, x.shape[1] - 1)
    if x.dim() == 3:
        got = torch.gather(x, 1, safe[..., None].expand(-1, -1, x.shape[2]))
        return torch.where(idx[..., None] >= 0, got, fill)
    return torch.where(idx >= 0, torch.gather(x, 1, safe), fill)


def distributed_insert(mesh, table: ShardedPTT, key_hi, key_lo, valid):
    """Shuffle-dedup: batched distributed PTT insert.

    ``key_hi/key_lo/valid`` are split over the shards of ``mesh`` (with
    ``n_shards``: the global keys, in contiguous slices; with a
    ``ProcessMesh``: this rank's slice).  Returns (table', is_new, overflow)
    with ``is_new`` aligned to the input layout.  Exactly-one-winner
    semantics hold globally because each key is judged only by its owner
    shard.
    """
    sh = _shards(mesh)
    khi, klo, val = (sh.split(x) for x in (key_hi, key_lo, valid))
    cap = _bin_cap(khi.shape[1], sh.n)
    owner = _owner(khi, sh.n)
    dest_by_lane, send_index, ovf_bin = _bin_by_owner(owner, sh.n, cap, val)

    recv_hi = sh.all_to_all(_gather_or(khi, send_index, EMPTY))
    recv_lo = sh.all_to_all(_gather_or(klo, send_index, EMPTY))
    recv_valid = ~((recv_hi == EMPTY) & (recv_lo == EMPTY))

    his, los, flags, ovf = [], [], [], ovf_bin
    for s in range(sh.rows):
        res = hashset.insert_masked(
            hashset.HashSet(table.hi[s], table.lo[s]), recv_hi[s], recv_lo[s], recv_valid[s]
        )
        his.append(res.table.hi)
        los.append(res.table.lo)
        flags.append(res.is_new)
        ovf = ovf | res.overflowed
    flags_back = sh.all_to_all(torch.stack(flags))
    # un-permute: lane i was sent to flat slot dest_by_lane[i]
    is_new = _gather_or(flags_back, dest_by_lane, False) & val
    table = ShardedPTT(hi=torch.stack(his), lo=torch.stack(los))
    return table, is_new.reshape(-1), sh.any(ovf)


def build_distributed_pjtt(mesh, parent_keys, parent_subjects):
    """Shuffle parent (key, subject) pairs to their key's owner shard and
    build a local sorted index there.  Bin overflow is reported (skewed keys
    beyond BIN_SLACK× the mean load need a larger slack)."""
    sh = _shards(mesh)
    pk, ps = sh.split(parent_keys), sh.split(parent_subjects)
    hi, _ = hashing.mix64([pk])
    cap = _bin_cap(pk.shape[1], sh.n)
    dest_by_lane, send_index, ovf_bin = _bin_by_owner(_owner(hi, sh.n), sh.n, cap, pk >= 0)
    recv_k = sh.all_to_all(_gather_or(pk, send_index, _PAD_KEY))
    recv_s = sh.all_to_all(_gather_or(ps, send_index, -1))
    idx = [pjtt.build_sorted(recv_k[s], recv_s[s]) for s in range(sh.rows)]
    skeys = torch.stack([i.skeys for i in idx])
    ssubj = torch.stack([i.ssubj for i in idx])
    return ShardedPJTT(skeys=skeys, ssubj=ssubj), sh.any(ovf_bin)


def distributed_ojm_probe(mesh, index: ShardedPJTT, child_keys, max_matches: int):
    """Index-join probe against the distributed PJTT.

    Child keys are shuffled to their owner shard, answered with a padded
    (cap, max_matches) block, and routed back.  Returns (subjects, valid,
    overflow) aligned with the child layout: int32[n, max_matches].
    """
    sh = _shards(mesh)
    ck = sh.split(child_keys)
    valid = ck >= 0
    hi, _ = hashing.mix64([ck])
    cap = _bin_cap(ck.shape[1], sh.n)
    dest_by_lane, send_index, ovf_bin = _bin_by_owner(_owner(hi, sh.n), sh.n, cap, valid)
    recv_k = sh.all_to_all(_gather_or(ck, send_index, _PAD_KEY))

    # manual span probe: pad probes (and the index's own pad rows, which
    # share _PAD_KEY and so form one huge span) must not count as matches
    # or trigger the truncation flag
    real = recv_k != _PAD_KEY
    s0 = torch.searchsorted(index.skeys, recv_k)
    e0 = torch.searchsorted(index.skeys, recv_k, right=True)
    cnt = torch.where(real, e0 - s0, 0)
    subj = []
    for s in range(sh.rows):
        pr = pjtt._expand_spans(index.ssubj[s], s0[s], cnt[s], max_matches)
        subj.append(torch.where(pr.valid, pr.subjects, -1))
    trunc = (cnt > max_matches).any(dim=1)
    subj_back = sh.all_to_all(torch.stack(subj))
    out_subj = _gather_or(subj_back, dest_by_lane, -1)
    out_valid = (out_subj >= 0) & valid[..., None]
    ovf = sh.any(ovf_bin | trunc)
    return out_subj.reshape(-1, max_matches), out_valid.reshape(-1, max_matches), ovf
