"""K4 ``scan_join``: the serving fast path's fused scan–join chain.

The general ``repro_torch.serve.exec`` pipeline runs a whole algebra tree
as a few dozen tensor operations a dispatch; at batch 1–64 that constant
dominates.  This module computes the dominant plan shapes — a ``Scan``
followed by up to two inner ``BindJoin`` s under the standard ``Project
→ Sort → Limit`` tail — as ONE unit with a tiny calling convention:

* per reader: the packed split keys, the three index columns, and the
  primary-term row starts (all persistent store tensors);
* per query: one ``(n_readers, 3)`` int32 constants row, a validity
  flag, and a limit — packed into a single ``[batch, qrow_width]``
  matrix so each dispatch pays exactly one host→device copy;
* out: the projected/sorted/limited binding columns, the row counts,
  and a single ``[n_stages]`` *max-needed* vector (the capacity
  feedback), reduced over the batch on the device.

Two formulations of the same function:

* :func:`chain_plain` — plain PyTorch over a leading batch axis (the
  JAX package's ``chain_query`` under ``vmap``); the CPU runs it, and
  the card compares the kernel with it;
* the hand-written CUDA kernel ``csrc/scan_join.cu`` (one block per
  query), which :func:`scan_join` launches for CUDA tensors.  It searches
  on groups of lanes (stage 0 a warp a search, 33-ary rounds with a pivot a
  lane and ``__ballot_sync``; a bind stage :func:`bind_search_lanes` lanes a
  left row), keeps the chain's columns in shared memory where they fit
  (:data:`CHAIN_SMEM_INTS`) and sorts a tail of at most 32 rows on one
  warp, each lane counting the rows before its own.  Its searches equal the bisection's only because every
  round count covers its window (:func:`check_search_rounds`).

It replaces the Pallas kernel ``repro.kernels.scan_join.pallas_scan_join``
(``grid=(batch,)``, one program per query).  All semantics match the
general executor operator for operator: the same packed-bound encoding
(``-1`` wildcard packs below every real id, ``-2`` unknown constants
produce empty ranges), the same seeded primary-term bisection with a fixed
round count, the same packed cumsum/searchsorted bind-join expansion, and
a sort over every output column — so the fast path is row-for-row
identical to the general pipeline.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

I32_MAX = 2**31 - 1
UNBOUND = -1
# what the kernel takes (csrc/scan_join.cu): readers, chain columns and
# output columns
MAX_READERS, MAX_COLS, MAX_OUT = 3, 12, 16
# the chain's columns fit the kernel's shared memory up to this many ints a
# query (csrc/scan_join.cu: kChainSmemInts); above it they go to scratch
CHAIN_SMEM_INTS = 12288
launches = 0  # kernel launches by ``scan_join`` since the last reset


# ---------------------------------------------------------------------------
# packed split-key binary search (the general executor reuses these)
# ---------------------------------------------------------------------------


def pack_bound(q0, q1, q2, bits: int):
    """Pack a (possibly wildcarded) query bound into the store's split
    63-bit key space (see ``TripleStore.device_keys``): fields are shifted
    +1 so ``-1`` packs below every real id and ``I32_MAX`` clamps to the
    all-ones field above every id.  Returns int32 ``(hi, lo)`` with the
    low word sign-bit-biased, matching the store's key columns.  The
    fields are computed on int64 lanes (CPU torch has no uint32 shifts)
    and stored back as int32 bit patterns."""

    def f(x):
        # clip BEFORE the +1: I32_MAX + 1 would wrap in int32
        return torch.as_tensor(x).to(torch.int64).clamp(-1, (1 << bits) - 2) + 1

    f0, f1, f2 = f(q0), f(q1), f(q2)
    hi = (f0 << (2 * bits - 32)) | (f1 >> (32 - bits))
    lo = ((f1 & ((1 << (32 - bits)) - 1)) << bits) | f2
    lo = lo ^ 0x80000000
    # int64 lanes holding 32-bit words -> int32 with the same bits
    return hi.to(torch.int32), (lo - ((lo & 0x80000000) << 1)).to(torch.int32)


def lex_search2(khi, klo, qhi, qlo, upper: bool, rounds: int,
                lo_init=None, hi_init=None):
    """Binary search on the split-key pair: count of rows lex-< (or <= for
    ``upper``) the query bound.  ``rounds`` covers the widest possible
    [lo_init, hi_init) window (the full store by default; a seeded search
    passes a primary-term row range and correspondingly few rounds)."""
    n = khi.shape[0]
    if lo_init is None:
        lo = torch.zeros(qhi.shape, dtype=torch.int32, device=qhi.device)
        hi = torch.full(qhi.shape, n, dtype=torch.int32, device=qhi.device)
    else:
        lo = lo_init.expand(qhi.shape).to(torch.int32)
        hi = hi_init.expand(qhi.shape).to(torch.int32)
    for _ in range(rounds):
        mid = lo + ((hi - lo) >> 1)
        g = mid.clamp(0, max(n - 1, 0))
        mhi, mlo = khi[g], klo[g]
        tail = (mlo <= qlo) if upper else (mlo < qlo)
        before = (mhi < qhi) | ((mhi == qhi) & tail)
        open_ = lo < hi
        lo, hi = (
            torch.where(open_ & before, mid + 1, lo),
            torch.where(open_ & ~before, mid, hi),
        )
    return lo


# ---------------------------------------------------------------------------
# the static chain description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReaderSpec:
    """One pattern reader, resolved to its index order: ``src[j]`` says
    where index-order position ``j`` s bound comes from — ``('c', pos)``
    a constant from the reader's consts row, ``('b', col)`` a chain
    binding column, ``('w', 0)`` wildcard — and ``out`` lists the
    wildcard positions that bind new chain columns."""

    src: tuple[tuple[str, int], tuple[str, int], tuple[str, int]]
    out: tuple[tuple[int, int], ...]       # (index-order pos j, chain col)
    prim_rounds: int                       # seeded-bisection rounds


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """The whole fused chain: readers in pipeline order (reader ``i``
    reads constants row ``i``), the chain column count, and the
    projection ``out_cols`` (chain column per output variable, ``-1``
    for a selected variable no pattern ever binds)."""

    readers: tuple[ReaderSpec, ...]
    n_cols: int
    out_cols: tuple[int, ...]
    key_bits: int
    rounds: int                            # full-store bisection rounds
    store_n: int                           # base rows (>= 1)


def check_search_rounds(spec: ChainSpec, operands) -> None:
    """Raise unless every search's round count covers its window:
    ``spec.rounds >= bit_length(store_n)`` for a full-index search and each
    reader's ``prim_rounds >= bit_length`` of its widest primary-term range
    (``operands[i][5]`` is reader ``i`` s ``prim_start``).  The bisection
    then ends at the window's partition point, which the kernel's k-ary
    searches find; with fewer rounds it would stop short, and no other
    search reproduces where."""
    if spec.rounds < int(spec.store_n).bit_length():
        raise ValueError(f"chain spec has {spec.rounds} search rounds for "
                         f"{spec.store_n} rows")
    for i, r in enumerate(spec.readers):
        prim = operands[i][5]
        widest = int((prim[1:] - prim[:-1]).max()) if prim.shape[0] > 1 else 0
        if r.prim_rounds < widest.bit_length():
            raise ValueError(f"reader {i} has {r.prim_rounds} seeded search rounds "
                             f"for a primary-term range of {widest} rows")


def bind_search_lanes(n_left: int) -> int:
    """Lanes each left row of a bind stage takes in the kernel
    (``csrc/scan_join.cu::bind_ranges``) when the stage has ``n_left`` left
    rows: as many as 256 threads allow, from 32 down to 2.  A primary-term
    window no wider than that is probed whole in one round; a wider one is
    searched by the group's two halves, one for each end."""
    for lanes, rows in ((32, 8), (16, 16), (8, 32), (4, 64)):
        if n_left <= rows:
            return lanes
    return 2


def qrow_width(n_readers: int) -> int:
    """Width of the packed per-query row: the flattened ``(n_readers, 3)``
    constants, the validity flag, and the limit."""
    return 3 * n_readers + 2


# ---------------------------------------------------------------------------
# the plain version: the whole chain over a leading batch axis
# ---------------------------------------------------------------------------


def _reader_range(spec: ChainSpec, r: ReaderSpec, khi, klo, prim_start,
                  lo_q, hi_q, primary_q):
    """(start, end) rows inside the reader's bound range; seeded to the
    primary term's row range when the primary is bound."""
    qhi_l, qlo_l = pack_bound(*lo_q, spec.key_bits)
    qhi_h, qlo_h = pack_bound(*hi_q, spec.key_bits)
    if primary_q is None:
        lo = lex_search2(khi, klo, qhi_l, qlo_l, False, spec.rounds)
        hi = lex_search2(khi, klo, qhi_h, qlo_h, True, spec.rounds)
        return lo, hi
    T = prim_start.shape[0] - 1
    g0 = primary_q.clamp(0, max(T - 1, 0))
    lo0 = prim_start[g0]
    hi0 = prim_start[g0 + 1]
    lo = lex_search2(khi, klo, qhi_l, qlo_l, False, r.prim_rounds, lo0, hi0)
    hi = lex_search2(khi, klo, qhi_h, qlo_h, True, r.prim_rounds, lo0, hi0)
    # a negative primary (unknown constant / padded row / unmatched left
    # binding) is an empty range
    ok = primary_q >= 0
    zero = torch.zeros_like(lo)
    return torch.where(ok, lo, zero), torch.where(ok, hi, zero)


def _bounds(r: ReaderSpec, consts_r, cols, shape):
    """The reader's (lo, hi) bound triples in index order, plus the
    primary operand (None = wildcard primary, full-store search).
    ``consts_r`` is ``[B, 3]``; ``shape`` is ``(B,)`` or ``(B, rows)``."""
    dev = consts_r.device

    def const(arg):
        v = consts_r[:, arg]
        return v.view(v.shape + (1,) * (len(shape) - 1)).expand(shape)

    lo_q, hi_q = [], []
    for kind, arg in r.src:
        if kind == "c":
            lo_q.append(const(arg))
            hi_q.append(const(arg))
        elif kind == "b":
            lo_q.append(cols[arg])
            hi_q.append(cols[arg])
        else:
            lo_q.append(torch.full(shape, -1, dtype=torch.int32, device=dev))
            hi_q.append(torch.full(shape, I32_MAX, dtype=torch.int32, device=dev))
    kind, arg = r.src[0]
    if kind == "c":
        primary_q = const(arg)
    elif kind == "b":
        primary_q = cols[arg]
    else:
        primary_q = None
    return lo_q, hi_q, primary_q


def _gather(col, idx):
    return col.gather(1, idx.long())


def lexsort_rows(keys):
    """Permutation ``[B, cap]`` sorting each row's entries lexicographically
    by ``keys`` (most significant first), stably: successive stable
    argsorts, least significant key first."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else _gather(k, perm)
        o = torch.argsort(kk, dim=1, stable=True)
        perm = o if perm is None else perm.gather(1, o)
    return perm


def chain_plain(spec: ChainSpec, caps: tuple[int, ...], operands, consts,
                qvalid, qlimit):
    """Run the fused chain for a batch.  ``operands[i]`` is reader ``i``'s
    ``(khi, klo, c0, c1, c2, prim_start)``; ``caps[i]`` its output
    capacity; ``consts`` ``[B, R, 3]``, ``qvalid`` bool ``[B]``, ``qlimit``
    ``[B]`` (``-1`` = no limit).  Returns ``(out_cols, n, needed)`` with
    ``needed`` ``[B, R]``, the exact per-stage row requirement."""
    B = consts.shape[0]
    dev = consts.device
    cols: list = [None] * spec.n_cols

    def ar(k):
        return torch.arange(k, dtype=torch.int32, device=dev)

    r0 = spec.readers[0]
    khi, klo, c0, c1, c2, prim = operands[0]
    lo_q, hi_q, primary_q = _bounds(r0, consts[:, 0], cols, (B,))
    lo, hi = _reader_range(spec, r0, khi, klo, prim, lo_q, hi_q, primary_q)
    count = torch.where(qvalid, hi - lo, torch.zeros_like(lo))
    needed = [count]
    cap = caps[0]
    r = (lo[:, None] + ar(cap)[None, :]).clamp(0, spec.store_n - 1)
    valid = ar(cap)[None, :] < count[:, None]
    by_j = (c0, c1, c2)
    for j, col in r0.out:
        cols[col] = torch.where(valid, by_j[j][r], UNBOUND)
    n = count.clamp(max=cap)

    for k in range(1, len(spec.readers)):
        rk = spec.readers[k]
        khi, klo, c0, c1, c2, prim = operands[k]
        cl = caps[k - 1]
        lo_q, hi_q, primary_q = _bounds(rk, consts[:, k], cols, (B, cl))
        lo, hi = _reader_range(spec, rk, khi, klo, prim, lo_q, hi_q, primary_q)
        cnt = torch.where(ar(cl)[None, :] < n[:, None], hi - lo, 0)
        # packed expansion (same as the general executor): out row j
        # belongs to the left row whose count prefix-sum passes j
        cum = torch.cumsum(cnt, dim=1, dtype=torch.int32)
        total = cum[:, cl - 1]
        cap = caps[k]
        j = ar(cap).expand(B, cap).contiguous()
        rowidx = torch.searchsorted(cum, j, right=True, out_int32=True)
        rowc = rowidx.clamp(0, cl - 1)
        prev = torch.where(rowc > 0, _gather(cum, (rowc - 1).clamp(min=0)), 0)
        kk = j - prev
        rr = (_gather(lo, rowc) + kk).clamp(0, spec.store_n - 1)
        valid_out = j < total.clamp(max=cap)[:, None]
        new_cols: list = [None] * spec.n_cols
        for col in range(spec.n_cols):
            if cols[col] is not None:
                new_cols[col] = torch.where(valid_out, _gather(cols[col], rowc), UNBOUND)
        by_j = (c0, c1, c2)
        for jj, col in rk.out:
            new_cols[col] = torch.where(valid_out, by_j[jj][rr], UNBOUND)
        cols = new_cols
        needed.append(total)
        n = total.clamp(max=cap)

    # tail: Project -> Sort -> Limit, exactly the general pipeline's.
    # Sorting by EVERY output column makes the table a pure function of
    # the row multiset, so the direct key sort reproduces the general
    # path's permutation sort row for row.
    cap = caps[-1]
    outs = []
    for col in spec.out_cols:
        if col >= 0 and cols[col] is not None:
            outs.append(cols[col])
        else:
            outs.append(torch.full((B, cap), UNBOUND, dtype=torch.int32, device=dev))
    valid = ar(cap)[None, :] < n[:, None]
    if outs:
        keys = [torch.where(valid, c, I32_MAX) for c in outs]
        perm = lexsort_rows(keys)
        outs = [torch.where(valid, _gather(c, perm), UNBOUND) for c in keys]
    n = torch.where(qlimit >= 0, torch.minimum(n, qlimit), n)
    return tuple(outs), n, torch.stack(needed, dim=1)


# ---------------------------------------------------------------------------
# launch strategies
# ---------------------------------------------------------------------------


def _split_args(spec: ChainSpec, args):
    n_ops = 6 * len(spec.readers)
    operands = tuple(tuple(args[6 * i: 6 * i + 6]) for i in range(len(spec.readers)))
    return operands, args[n_ops]


def _unpack_qrows(spec: ChainSpec, qbuf):
    """Split the packed per-query rows into (consts[B, R, 3], valid[B],
    limit[B])."""
    R = len(spec.readers)
    return qbuf[:, : 3 * R].reshape(-1, R, 3), qbuf[:, 3 * R] != 0, qbuf[:, 3 * R + 1]


def scan_join_plain(spec: ChainSpec, caps: tuple[int, ...], *args):
    """The plain version: ``(*reader operands, qbuf)`` ->
    ``(out_cols, n, needed_max)``."""
    operands, qbuf = _split_args(spec, args)
    consts, qvalid, qlimit = _unpack_qrows(spec, qbuf)
    outs, n, needed = chain_plain(spec, caps, operands, consts, qvalid, qlimit)
    return outs, n, needed.amax(dim=0)


def _check(spec: ChainSpec, caps: tuple[int, ...], operands, qbuf) -> None:
    R = len(spec.readers)
    if not 1 <= R <= MAX_READERS or len(caps) != R:
        raise ValueError(f"scan_join takes 1..{MAX_READERS} readers with one "
                         f"capacity each, got {R} readers and caps {caps}")
    if spec.n_cols > MAX_COLS or len(spec.out_cols) > MAX_OUT:
        raise ValueError(f"scan_join takes at most {MAX_COLS} chain columns and "
                         f"{MAX_OUT} output columns, got {spec.n_cols} and "
                         f"{len(spec.out_cols)}")
    if any(c < 2 or c & (c - 1) or c >= 2**31 for c in caps):
        raise ValueError(f"scan_join capacities are powers of two >= 2, got {caps}")
    tensors = [t for pack in operands for t in pack] + [qbuf]
    if any(t.device != qbuf.device for t in tensors):
        raise ValueError("scan_join operands must be on one device")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in tensors):
        raise ValueError("scan_join takes contiguous int32 tensors on the card")
    if qbuf.dim() != 2 or qbuf.shape[1] != qrow_width(R) or qbuf.shape[0] < 1:
        raise ValueError(f"qbuf must be [B, {qrow_width(R)}], got {tuple(qbuf.shape)}")
    for khi, klo, c0, c1, c2, prim in operands:
        if not (khi.shape == klo.shape == c0.shape == c1.shape == c2.shape
                == (spec.store_n,)) or prim.dim() != 1 or prim.shape[0] < 2:
            raise ValueError("each reader takes khi, klo, c0, c1, c2 [store_n] "
                             "and prim_start [T + 1]")


_scratch: dict[torch.device, torch.Tensor] = {}


def _scratch_for(device, n_ints: int) -> torch.Tensor:
    """Per-query scratch for a chain whose columns do not fit the kernel's
    shared memory (two ping-pong column tables, the count prefix sums and
    the left rows' range starts): one grow-only buffer per device, reused by
    every launch on the stream (launches are ordered on it)."""
    buf = _scratch.get(device)
    if buf is None or buf.numel() < n_ints:
        buf = torch.empty(max(n_ints, 1), dtype=torch.int32, device=device)
        _scratch[device] = buf
    return buf


_KIND = {"c": 0, "b": 1, "w": 2}


def _spec_ints(spec: ChainSpec, caps, operands) -> list[int]:
    """The static chain as the kernel's int table (csrc/scan_join.cu)."""
    ints = [len(spec.readers), spec.n_cols, len(spec.out_cols), spec.key_bits,
            spec.rounds, spec.store_n, *caps, *([0] * (MAX_READERS - len(caps)))]
    for i in range(MAX_READERS):
        if i < len(spec.readers):
            r = spec.readers[i]
            ints += [_KIND[k] for k, _ in r.src] + [a for _, a in r.src]
            out = list(r.out) + [(0, 0)] * (3 - len(r.out))
            ints += [len(r.out)] + [j for j, _ in out] + [c for _, c in out]
            ints += [r.prim_rounds, operands[i][5].shape[0] - 1]
        else:
            ints += [0] * 15
    ints += list(spec.out_cols) + [0] * (MAX_OUT - len(spec.out_cols))
    return ints


def prepare_launch(spec: ChainSpec, caps: tuple[int, ...], *args,
                   stage0_loads: torch.Tensor | None = None):
    """Check one launch's CUDA inputs (``*args`` as :func:`scan_join`
    takes them) and allocate its outputs; returns
    ``(launch, out_cols, n, needed)`` where ``launch()`` enqueues the kernel
    on the current stream (and raises if the launch is refused) without
    counting it.  :func:`scan_join` launches through it; a timing loop can
    call ``launch`` back to back.  Given ``stage0_loads`` (int32 ``[B, 2]``
    on the card), the kernel also writes there the dependent global loads
    each query's lower and upper stage-0 search made, as it counted them."""
    operands, qbuf = _split_args(spec, args)
    caps = tuple(int(c) for c in caps)
    _check(spec, caps, operands, qbuf)
    dev = qbuf.device
    B, cap = qbuf.shape[0], caps[-1]
    if stage0_loads is not None and (
            stage0_loads.shape != (B, 2) or stage0_loads.dtype != torch.int32
            or stage0_loads.device != dev or not stage0_loads.is_contiguous()):
        raise ValueError(f"stage0_loads must be a contiguous int32 [{B}, 2] tensor on {dev}")
    outs = tuple(torch.empty((B, cap), dtype=torch.int32, device=dev)
                 for _ in spec.out_cols)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    needed = torch.empty((B, len(spec.readers)), dtype=torch.int32, device=dev)
    capmax = max(caps)
    chain_ints = (2 * spec.n_cols + 2) * capmax
    scratch = 0 if chain_ints <= CHAIN_SMEM_INTS else _scratch_for(
        dev, B * chain_ints).data_ptr()
    ptrs = [t.data_ptr() for pack in operands for t in pack]
    ptrs += [0] * (6 * (MAX_READERS - len(operands)))
    ptrs += [qbuf.data_ptr(), n.data_ptr(), needed.data_ptr(), scratch,
             0 if stage0_loads is None else stage0_loads.data_ptr()]
    ptrs += [o.data_ptr() for o in outs] + [0] * (MAX_OUT - len(outs))
    ints = _spec_ints(spec, caps, operands)
    lib = _build.library("scan_join")
    args = ((ctypes.c_ulonglong * len(ptrs))(*ptrs), len(ptrs),
            (ctypes.c_int * len(ints))(*ints), len(ints), B, capmax,
            torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)

    def launch() -> None:
        _build.check(lib, lib.scan_join_launch(*args), "scan_join")

    return launch, outs, n, needed


def scan_join(spec: ChainSpec, caps: tuple[int, ...], *args):
    """``(*reader operands, qbuf[B, qrow_width])`` -> ``(out_cols, n,
    needed_max)``: for CUDA tensors the kernel ``csrc/scan_join.cu`` (one
    block per query), for CPU tensors the plain version."""
    qbuf = args[-1]
    if qbuf.device.type == "cpu":
        return scan_join_plain(spec, caps, *args)
    if qbuf.device.type != "cuda":
        raise ValueError(f"scan_join runs on cuda or cpu tensors, not {qbuf.device}")
    launch, outs, n, needed = prepare_launch(spec, caps, *args)
    launch()
    global launches
    launches += 1
    return outs, n, needed.amax(dim=0)


def make_batched(spec: ChainSpec, caps: tuple[int, ...], use_kernel: bool = False):
    """A batched entry point for one (chain, capacities) shape, taking the
    flat argument list ``(*reader operands, qbuf[B, qrow_width])`` and
    returning ``(out_cols, n, needed_max)``.  ``use_kernel`` picks the
    wrapper :func:`scan_join` (the kernel for CUDA tensors); otherwise the
    plain version."""
    if use_kernel:
        return lambda *args: scan_join(spec, caps, *args)
    return lambda *args: scan_join_plain(spec, caps, *args)
