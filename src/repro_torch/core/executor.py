"""Eager executor — the paper's engine loop, on the card.

The counterpart of the eager optimized engine of ``repro.core.executor``
(paper Fig. 2):

  RML doc --plan--> physical ops --batches--> device steps
       sources -> columnar load -> dictionary encode -> fixed-shape batches
  each step: triple keys (``hash_mix`` kernel) -> radix PTT insert
  (``bucket_dedup`` kernel); OJM rules probe the sorted PJTT first.
  The Knowledge Graph Creator appends the ``is_new`` triples incrementally.

Device code runs on ``EngineConfig.device`` ("cuda" by default); the CPU is
used only when asked for.  The written N-Triples are byte-identical to the
JAX engine's.  The streamed engine, the naive engine and the hash PJTT
arrive in slice 2 of the port and raise ``ValueError`` here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import pjtt, planner, ptt
from repro_torch.core.hashset import next_pow2
from repro_torch.data import pipeline
from repro_torch.data.encoder import Dictionary, join_columns
from repro_torch.data.sources import SourceCache
from repro_torch.data.terms import render_term
from repro_torch.rml.model import MappingDocument

_LATER = "arrives in slice 2 of the PyTorch port (see ROADMAP.md); use repro for it"


def resolve_device(device) -> torch.device:
    """The device a run asked for.  Asking for CUDA on a host without a
    card raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {str(device)!r}")
    return dev


# --------------------------------------------------------------------------
# device steps
# --------------------------------------------------------------------------


def _dedup_step(table, subj_tmpl, subj_vals, pred_id, obj_tmpl, obj_vals, valid):
    """SOM/ORM/CLASS step: triple keys -> masked PTT insert."""
    res = ptt.insert_triples(
        ptt.PTT(table), subj_tmpl, subj_vals, pred_id, obj_tmpl, obj_vals, valid
    )
    return res.ptt.table, res.is_new, res.overflowed


def _ojm_sorted_step(
    table, index, subj_tmpl, subj_vals, pred_id, obj_tmpl, max_matches,
    child_keys, valid,
):
    """OJM step, sorted PJTT: probe spans -> expand -> masked PTT insert."""
    pr = pjtt.probe_sorted(index, child_keys, max_matches)
    m, K = pr.subjects.shape
    subj = subj_vals[:, None].expand(m, K).reshape(-1)
    obj = pr.subjects.reshape(-1)
    v = (pr.valid & valid[:, None]).reshape(-1)
    res = ptt.insert_triples(ptt.PTT(table), subj_tmpl, subj, pred_id, obj_tmpl, obj, v)
    return (
        res.ptt.table, res.is_new.view(m, K), pr.subjects, v.view(m, K),
        res.overflowed, pr.truncated,
    )


def _span_stats(skeys: torch.Tensor, child_keys: torch.Tensor) -> tuple[int, int]:
    """(|N_p|, largest span) of child keys against sorted parent keys."""
    if child_keys.numel() == 0:
        return 0, 0
    s = torch.searchsorted(skeys, child_keys)
    e = torch.searchsorted(skeys, child_keys, right=True)
    cnt = e - s
    return int(cnt.sum()), int(cnt.max())


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PredicateStats:
    """Per-predicate cost accounting, mirroring the paper's φ expressions."""

    kind: str
    n_candidates: int = 0   # |N_p|
    n_unique: int = 0       # |S_p|
    n_parent: int = 0
    n_child: int = 0

    def phi_optimized(self) -> float:
        base = self.n_candidates + 2 * self.n_unique
        if self.kind == "OJM":
            return 2 * self.n_parent + self.n_child + base
        return base

    def phi_naive(self) -> float:
        n = max(self.n_candidates, 1)
        base = self.n_candidates + self.n_unique + n * np.log2(n)
        if self.kind == "OJM":
            return self.n_parent * self.n_child + base
        return base


@dataclasses.dataclass
class KGResult:
    """The created knowledge graph, term-id form + dictionaries for decode."""

    dictionary: Dictionary
    # predicate -> dict of parallel int32 arrays
    triples: dict[str, dict[str, np.ndarray]]
    stats: dict[str, PredicateStats]
    wall_time_s: float = 0.0
    engine: str = "optimized"
    load_encode_s: float = 0.0  # of wall_time_s: reading and encoding sources

    @property
    def n_triples(self) -> int:
        return sum(len(t["subj_val"]) for t in self.triples.values())

    def iter_ntriples(self):
        d = self.dictionary
        for pred, t in self.triples.items():
            for i in range(len(t["subj_val"])):
                s = _render(d, int(t["subj_pat"][i]), int(t["subj_val"][i]))
                o = _render(d, int(t["obj_pat"][i]), int(t["obj_val"][i]))
                yield f"{s} <{pred}> {o} ."

    def write_ntriples(self, path: str) -> int:
        n = 0
        with open(path, "w", encoding="utf-8") as f:
            for line in self.iter_ntriples():
                f.write(line + "\n")
                n += 1
        return n


def _plan_gauges(mplan) -> None:
    """Publish the mapping plan's shape into ``repro_torch.obs`` (plan.*
    rows in the metrics catalog)."""
    from repro_torch.obs import get_registry

    reg = get_registry()
    reg.gauge("plan.groups").set(len(mplan.groups))
    reg.gauge("plan.sources").set(len(mplan.sources))
    reg.gauge("plan.shared_terms").set(len(mplan.shared))
    reg.gauge("plan.rules").set(len(mplan.exec_plan.ops))


def _sources_by_key(doc: MappingDocument) -> dict:
    """planner source_key -> LogicalSource (keys match the planned ops)."""
    return {
        planner.source_key(tm.source): tm.source
        for tm in doc.triples_maps.values()
    }


# full N-Triples escaping, shared with the JAX package's decode path
_render = render_term


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


@dataclasses.dataclass
class EngineConfig:
    engine: str = "optimized"        # optimized (naive: slice 2)
    join_strategy: str = "sorted"    # sorted (hash: slice 2)
    batch_size: int = 1 << 16
    load_factor: float = 0.6
    max_matches: int | None = None   # None -> derived from true max span
    stream: bool = False             # streamed engine: slice 2
    # mapping-level planning (rml.plan): group-by-group rule execution.
    # Output is byte-identical either way.
    mapping_plan: bool = True
    device: str = "cuda"             # cuda | cpu; no fallback between them


class Engine:
    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    # -- helpers -------------------------------------------------------------

    def _term_values(
        self, dct: Dictionary, table: dict[str, np.ndarray], columns: tuple[str, ...]
    ) -> np.ndarray:
        if not columns:  # constant term: single id 0 slot (value unused)
            n = len(next(iter(table.values()))) if table else 0
            return np.zeros(n, dtype=np.int32)
        return dct.encode(join_columns([table[c] for c in columns]))

    def run(
        self,
        doc: MappingDocument,
        data_root: str = ".",
        tables: dict[str, dict[str, np.ndarray]] | None = None,
    ) -> KGResult:
        """Create the knowledge graph.  ``tables`` optionally bypasses disk:
        maps source key ('csv:child.csv') -> columnar dict."""
        t0 = time.perf_counter()
        cfg = self.config
        if cfg.stream:
            raise ValueError(f"stream=True: the streamed engine {_LATER}")
        if cfg.engine != "optimized":
            raise ValueError(f"engine={cfg.engine!r}: the naive engine {_LATER}")
        if cfg.join_strategy != "sorted":
            raise ValueError(
                f"join_strategy={cfg.join_strategy!r}: the hash PJTT {_LATER}"
            )
        dev = resolve_device(cfg.device)
        mplan = None
        if cfg.mapping_plan:
            from repro_torch.rml.plan import build_plan

            mplan = build_plan(doc)
            _plan_gauges(mplan)
        exec_plan = mplan.exec_plan if mplan is not None else planner.plan(doc)
        dct = Dictionary()
        cache = SourceCache(data_root)
        sources_by_key = _sources_by_key(doc)
        load_encode_s = 0.0

        def get_table(source_key: str):
            if tables is not None and source_key in tables:
                return tables[source_key]
            from repro_torch.rml.model import LogicalSource

            src = sources_by_key.get(source_key)
            if src is None:
                fmt, path, iterator = planner.parse_source_key(source_key)
                src = LogicalSource(path=path, fmt=fmt, iterator=iterator)
            return cache.get(src)

        # ---- encode the value columns each op needs (once per column set)
        value_cache: dict[tuple, np.ndarray] = {}

        def values_for(source_key: str, columns: tuple[str, ...]) -> np.ndarray:
            nonlocal load_encode_s
            key = (source_key, columns)
            if key not in value_cache:
                t = time.perf_counter()
                value_cache[key] = self._term_values(
                    dct, get_table(source_key), columns
                )
                load_encode_s += time.perf_counter() - t
            return value_cache[key]

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # ---- build PJTTs once per (parent map, join column)
        indexes: dict[str, pjtt.PJTTSorted] = {}
        for pkey, (psrc, pcol, _ppat, pcols) in exec_plan.pjtt_builds.items():
            pkeys = values_for(psrc, (pcol,))
            psubj = values_for(psrc, pcols)
            indexes[pkey] = pjtt.build_sorted(on_device(pkeys), on_device(psubj))

        # ---- per-predicate candidate estimate -> PTT capacity
        stats: dict[str, PredicateStats] = {}
        pred_candidates: dict[str, int] = {}
        op_spans: dict[int, tuple[int, int]] = {}  # op idx -> (|N_p|, max span)
        for pred, op_idxs in exec_plan.by_predicate.items():
            total = 0
            kind = exec_plan.ops[op_idxs[0]].kind
            for i in op_idxs:
                op = exec_plan.ops[i]
                n_child = len(values_for(op.source_key, op.subj_columns))
                if op.kind == "OJM":
                    # exact |N_p| and max span from the sorted parent keys;
                    # sizes the PTT and the padded-ragged probe width
                    skeys = torch.sort(on_device(
                        values_for(op.parent_source_key, (op.parent_join_column,))
                    )).values
                    ck = on_device(values_for(op.source_key, (op.join_child_column,)))
                    op_spans[i] = _span_stats(skeys, ck)
                    total += op_spans[i][0]
                else:
                    op_spans[i] = (n_child, 1)
                    total += n_child
            pred_candidates[pred] = total
            stats[pred] = PredicateStats(kind=kind)

        # ---- run the ops: group-by-group along the mapping plan's DAG
        # when planning is on (groups are disjoint in predicates and
        # sources, so this only reorders work), else one flat pass
        triples_out: dict[str, dict[str, list[np.ndarray]]] = {}
        if mplan is not None:
            schedule = [
                (g, [(p, exec_plan.by_predicate[p]) for p in g.predicates])
                for g in mplan.groups
            ]
        else:
            schedule = [(None, list(exec_plan.by_predicate.items()))]
        from repro_torch import obs

        for g, pred_items in schedule:
            span_args = {"group": g.index} if g is not None else {}
            with obs.span("plan_group", cat="plan", **span_args):
                self._run_optimized(
                    exec_plan, values_for, indexes, pred_candidates,
                    op_spans, stats, triples_out, dct, dev,
                    pred_items=pred_items,
                )

        # emit in the op plan's predicate order regardless of group
        # scheduling: the written KG is byte-identical planner-on/off
        final = {
            pred: {
                k: np.concatenate(v) if v else np.zeros(0, np.int32)
                for k, v in triples_out[pred].items()
            }
            for pred in exec_plan.by_predicate
        }
        return KGResult(
            dictionary=dct,
            triples=final,
            stats=stats,
            wall_time_s=time.perf_counter() - t0,
            engine=cfg.engine,
            load_encode_s=load_encode_s,
        )

    # -- per-batch step --------------------------------------------------------

    def _consume_batch(
        self, op, spat, pid, opat, table, batch, index, K, out, st, dev,
    ):
        """Push one fixed-shape padded batch through the device step for
        ``op``; appends emitted triples to ``out`` and accumulates ``st``.
        Returns ``(table, overflowed)``."""
        valid = torch.from_numpy(batch.valid).to(dev)
        sv = torch.from_numpy(batch.arrays["subj"]).to(dev)
        if op.kind == "OJM":
            ck = torch.from_numpy(batch.arrays["jkey"]).to(dev)
            table, is_new, psubj, v, ovf, trunc = _ojm_sorted_step(
                table, index, spat, sv, pid, opat, K, ck, valid,
            )
            if bool(trunc):
                raise RuntimeError(
                    f"PJTT span exceeded max_matches={K}; "
                    "re-run with a larger max_matches"
                )
            st.n_candidates += int(v.sum())
            emit = is_new & v
            # row-major order, as np.nonzero over the (m, K) block
            rows = torch.nonzero(emit)[:, 0].cpu().numpy()
            objs = psubj[emit].cpu().numpy()
            out["subj_val"].append(batch.arrays["subj"][rows].astype(np.int32))
            out["obj_val"].append(objs.astype(np.int32))
            n_emit = len(rows)
        else:
            ov = torch.from_numpy(batch.arrays["obj"]).to(dev)
            table, is_new, ovf = _dedup_step(table, spat, sv, pid, opat, ov, valid)
            is_new_np = is_new.cpu().numpy()
            st.n_candidates += int(batch.valid.sum())
            rows = np.nonzero(is_new_np & batch.valid)[0]
            out["subj_val"].append(batch.arrays["subj"][rows].astype(np.int32))
            out["obj_val"].append(batch.arrays["obj"][rows].astype(np.int32))
            n_emit = len(rows)
        out["subj_pat"].append(np.full(n_emit, spat, np.int32))
        out["obj_pat"].append(np.full(n_emit, opat, np.int32))
        st.n_unique += n_emit
        return table, bool(ovf)

    # -- optimized engine ------------------------------------------------------

    def _run_optimized(
        self, exec_plan, values_for, indexes, pred_candidates, op_spans,
        stats, triples_out, dct: Dictionary, dev, pred_items=None,
    ):
        cfg = self.config
        if pred_items is None:
            pred_items = exec_plan.by_predicate.items()
        for pred, op_idxs in pred_items:
            cap = next_pow2(int(pred_candidates[pred] / cfg.load_factor) + 16)
            while True:  # overflow -> double capacity and replay the predicate
                table = ptt.make_capacity(cap, device=dev).table
                out = {k: [] for k in ("subj_pat", "subj_val", "obj_pat", "obj_val")}
                st = stats[pred]
                st.n_candidates = st.n_unique = st.n_parent = st.n_child = 0
                overflow = False
                for i in op_idxs:
                    op = exec_plan.ops[i]
                    pid = np.int32(dct.encode_scalar(op.predicate))
                    spat = np.int32(dct.encode_scalar(op.subj_pattern))
                    opat = np.int32(dct.encode_scalar(op.obj_pattern))
                    subj_vals = values_for(op.source_key, op.subj_columns)
                    cols = {"subj": subj_vals}
                    if op.kind == "OJM":
                        cols["jkey"] = values_for(
                            op.source_key, (op.join_child_column,)
                        )
                    elif op.kind in ("SOM", "ORM"):
                        cols["obj"] = values_for(op.source_key, op.obj_columns)
                    else:  # CLASS: constant object
                        cols["obj"] = np.zeros_like(subj_vals)

                    n = len(subj_vals)
                    bs = min(cfg.batch_size, pipeline.pick_batch_size(n))
                    K = 1
                    if op.kind == "OJM":
                        _tot, mx = op_spans[i]
                        K = cfg.max_matches or max(int(mx), 1)
                        st.n_parent += (
                            len(values_for(op.parent_source_key, (op.parent_join_column,)))
                        )
                        st.n_child += n
                    idx = indexes[op.pjtt_key] if op.kind == "OJM" else None
                    for batch in pipeline.batches(cols, bs):
                        table, ovf = self._consume_batch(
                            op, spat, pid, opat, table, batch, idx, K, out, st, dev
                        )
                        if ovf:
                            overflow = True
                            break
                    if overflow:
                        break
                if not overflow:
                    triples_out[pred] = out
                    break
                cap *= 2  # replay this predicate with a bigger table


def create_kg(
    doc: MappingDocument,
    data_root: str = ".",
    tables=None,
    **config,
) -> KGResult:
    """One-call public API: parse-level document -> knowledge graph.
    ``device`` defaults to "cuda"."""
    return Engine(EngineConfig(**config)).run(doc, data_root=data_root, tables=tables)
