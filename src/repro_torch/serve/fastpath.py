"""The small-batch dispatch fast path.

The general executor (``serve/exec.py``) compiles the whole algebra
tree and ships ~30 operand leaves per dispatch; that constant is noise
at batch 4096 and dominant at batch 1.  For the plan shapes that carry
interactive traffic — a ``Scan → BindJoin*`` chain of up to three
pattern readers (see :func:`repro_torch.serve.plan.fastpath_chain`) — this
module dispatches through :mod:`repro_torch.kernels.scan_join` (kernel K4)
instead, with every per-dispatch cost stripped:

* the chain is resolved at build time into a static
  :class:`~repro_torch.kernels.scan_join.ChainSpec` (index orders, constant /
  left-bound / wildcard sources, projection columns), so dispatch does
  no plan walking;
* per-query inputs are written into **grow-only staging buffers** kept
  per batch pad (pinned host memory for a store on the card) — no
  per-dispatch allocation, one host→device copy a dispatch;
* the per-capacity ``needed`` dict (one device→host sync per operator
  in the general path) collapses to a single ``[n_readers]`` max
  vector reduced on device;
* for a store on the card the whole batch runs as one launch of the
  hand-written kernel ``csrc/scan_join.cu`` (one block per query); a
  store on the CPU runs the plain PyTorch version of the same chain.

The capacity-feedback contract is shared with the general executor:
the same ``scan{id}`` / ``bindC{id}`` capacity names against the same
per-signature floors (``Executor._floors``), the same grow-and-retry
loop, counters, and trace spans — so a signature that warms up through
either path stays warm through both, and tests that count dispatches
see identical behavior.  Overlay (live-store) views and batches over
:data:`MAX_BATCH` never come here; ``execute_encoded`` routes them to
the general pipeline unchanged.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.hashset import next_pow2
from repro_torch.kernels import scan_join as K
from repro_torch.kg.store import ORDERS
from repro_torch.obs import get_registry, get_tracer
from repro_torch.serve import plan as P

# batches this small dispatch through the fused chain; larger ones are
# the general pipeline's amortized regime
MAX_BATCH = 64
# a chain stage that wants more rows than this belongs to the general
# path (same clamp as the planner's initial-capacity guess)
_CAP_LIMIT = 1 << 22
_MAX_GROW_ROUNDS = 12


def build(ex, plan: P.Plan) -> "SigFastPath | None":
    """Resolve ``plan`` into a :class:`SigFastPath`, or None when the
    plan (or the store — unpacked keys, empty base) needs the general
    executor.  Called once per plan signature and cached by the
    executor."""
    readers = P.fastpath_chain(plan)
    if readers is None:
        return None
    store = ex.store
    if store.n_triples == 0 or store.device_keys("spo") is None:
        return None
    col_of: dict[str, int] = {}
    rspecs: list[K.ReaderSpec] = []
    cap_names: list[str] = []
    base_caps: list[int] = []
    for r in readers:
        perm3 = ORDERS[r.order]
        if isinstance(r, P.Scan):
            var_by_pos = dict(r.var_slots)
            bound_by_pos: dict[int, int] = {}
        else:
            var_by_pos = dict(r.free_slots)
            bound_by_pos = {}
            for pos, v in r.bound_slots:
                col = col_of.get(v)
                if col is None:  # planner invariant violated: punt
                    return None
                bound_by_pos[pos] = col
        consts = set(r.const_slots)
        src: list[tuple[str, int]] = []
        out: list[tuple[int, int]] = []
        for j in range(3):
            pos = perm3[j]
            if pos in consts:
                src.append(("c", pos))
            elif pos in bound_by_pos:
                src.append(("b", bound_by_pos[pos]))
            elif pos in var_by_pos:
                col = col_of.setdefault(var_by_pos[pos], len(col_of))
                src.append(("w", 0))
                out.append((j, col))
            else:
                src.append(("w", 0))
        if src[0][0] == "w" and isinstance(r, P.BindJoin):
            # bind-join orders put a bound slot first by construction;
            # anything else is a shape the chain math doesn't seed
            return None
        rspecs.append(
            K.ReaderSpec(
                src=tuple(src),
                out=tuple(out),
                prim_rounds=store.primary_rounds(r.order),
            )
        )
        # identical capacity names and initial guesses to the general
        # path's _initial_caps: the per-signature floors are shared
        if isinstance(r, P.Scan):
            cap_names.append(f"scan{r.node_id}")
            base_caps.append(next_pow2(max(r.est, 1)))
        else:
            cap_names.append(f"bindC{r.node_id}")
            base_caps.append(next_pow2(min(max(r.est, 16), _CAP_LIMIT)))
    spec = K.ChainSpec(
        readers=tuple(rspecs),
        n_cols=len(col_of),
        out_cols=tuple(col_of.get(v, -1) for v in plan.root.out_vars),
        key_bits=store.KEY_BITS,
        rounds=max(1, int(store.n_triples).bit_length()),
        store_n=store.n_triples,
    )
    operands: list = []
    for r in readers:
        khi, klo = store.device_keys(r.order)
        c0, c1, c2 = store.device_cols(r.order)
        operands += [khi, klo, c0, c1, c2, store.device_primary_starts(r.order)]
    K.check_search_rounds(spec, [operands[6 * i: 6 * i + 6] for i in range(len(readers))])
    return SigFastPath(ex, plan, spec, tuple(operands), tuple(cap_names),
                       tuple(base_caps))


class SigFastPath:
    """One plan signature's resolved fast path: the static chain spec,
    the store operand tuple, grow-only staging buffers per batch pad,
    and the batched-function cache per (batch pad, capacities)."""

    def __init__(self, ex, plan, spec, operands, cap_names, base_caps):
        from repro_torch.serve.exec import plan_label

        self.ex = ex
        self.plan = plan
        self.spec = spec
        self.operands = operands
        self.cap_names = cap_names
        self.base_caps = base_caps
        self.label = plan_label(plan.sig)
        self._staging: dict[int, torch.Tensor] = {}  # batch pad -> rows
        self._compiled: dict[tuple, callable] = {}
        # the kernel for a store on the card; the plain chain on the CPU
        self._use_kernel = ex.store.device.type == "cuda"

    def _get_fn(self, bpad: int, caps: tuple[int, ...]):
        key = (bpad, caps)
        fn = self._compiled.get(key)
        reg = get_registry()
        if fn is not None:
            reg.inc("exec.pipeline_cache_hit")
            return fn
        reg.inc("exec.pipeline_cache_miss")
        reg.inc("exec.fastpath_compiles")
        fn = K.make_batched(self.spec, caps, use_kernel=self._use_kernel)
        self._compiled[key] = fn
        return fn

    def stage(self, consts: np.ndarray, limits, bsz: int) -> torch.Tensor:
        """Pack the batch into its grow-only staging rows (one packed
        ``[bpad, 3R+2]`` int32 matrix per batch pad, reused forever; pad
        rows: -2 consts so every scan misses, valid 0, limit -1), pinned
        for a store on the card; returns the staging tensor."""
        n_readers = len(self.spec.readers)
        bpad = next_pow2(max(bsz, 1))
        staged = self._staging.get(bpad)
        if staged is None:
            staged = torch.empty((bpad, K.qrow_width(n_readers)), dtype=torch.int32,
                                 pin_memory=self._use_kernel)
            self._staging[bpad] = staged
        qbuf = staged.numpy()
        qbuf[:bsz, : 3 * n_readers] = consts[:bsz].reshape(bsz, -1)
        qbuf[bsz:, : 3 * n_readers] = -2
        qbuf[:bsz, 3 * n_readers] = 1
        qbuf[bsz:, 3 * n_readers] = 0
        qbuf[:bsz, 3 * n_readers + 1] = -1 if limits is None else limits[:bsz]
        qbuf[bsz:, 3 * n_readers + 1] = -1
        return staged

    def caps(self) -> list[int]:
        """The capacities a dispatch starts from: the planner's guesses
        raised to the signature's floors (shared with the general path)."""
        floors = self.ex._floors.setdefault(self.plan.sig, {})
        return [max(base, floors.get(nm, 0))
                for nm, base in zip(self.cap_names, self.base_caps)]

    def dispatch(self, consts: np.ndarray, limits, bsz: int):
        """Run the batch; returns a ``(out_cols, counts)`` pair of numpy
        results, or None when capacity feedback outgrew the fast path
        (the caller re-runs on the general pipeline; the shared floors
        carry the growth over)."""
        ex = self.ex
        reg = get_registry()
        tracer = get_tracer()
        bpad = next_pow2(max(bsz, 1))
        staged = self.stage(consts, limits, bsz)
        floors = ex._floors.setdefault(self.plan.sig, {})
        caps = self.caps()
        label = self.label
        reg.inc("exec.batches")
        reg.inc("exec.queries", bsz)
        for round_i in range(_MAX_GROW_ROUNDS):
            t0 = time.perf_counter_ns()
            if round_i == 0:
                # the batch's one host->device copy; a re-run reuses it
                qdev = staged.to(ex.store.device, non_blocking=True)
            fn = self._get_fn(bpad, tuple(caps))
            outs, n, needed_max = fn(*self.operands, qdev)
            ex.dispatches += 1
            need = needed_max.cpu().numpy()
            grown = False
            overgrown = False
            for i, nm in enumerate(self.cap_names):
                want = int(need[i])
                if want > caps[i]:
                    caps[i] = next_pow2(want)
                    floors[nm] = max(floors.get(nm, 0), caps[i])
                    grown = True
                    reg.inc("exec.cap_growth")
                    if caps[i] > _CAP_LIMIT:
                        overgrown = True
            t1 = time.perf_counter_ns()
            reg.inc("exec.dispatches")
            reg.inc("exec.fastpath_dispatches")
            reg.observe("exec.dispatch_ms", (t1 - t0) / 1e6)
            if round_i > 0:
                reg.inc("exec.redispatches")
            if tracer.enabled:
                tracer.add_complete(
                    "redispatch" if round_i > 0 else "dispatch",
                    "exec", t0, t1,
                    plan=label, batch=bsz, round=round_i,
                    grown=grown, fast=True,
                )
            if overgrown:
                # result too large for the small-batch regime: the grown
                # floors transfer to the general path, which re-runs
                return None
            if not grown:
                break
        else:
            raise RuntimeError(
                "executor capacity feedback did not converge "
                f"(caps={dict(zip(self.cap_names, caps))}) — "
                "pathological query?"
            )
        # counts and columns come back in one copy
        flat = torch.cat([n[:bsz, None], *(c[:bsz] for c in outs)], dim=1)
        flat = flat.cpu().numpy()
        cap = outs[0].shape[1] if outs else 0
        cols = tuple(flat[:, 1 + t * cap: 1 + (t + 1) * cap] for t in range(len(outs)))
        return cols, flat[:, 0].astype(np.int64)
