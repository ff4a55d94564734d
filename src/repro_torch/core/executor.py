"""Executor — the paper's engine loop, on the card.

The counterpart of ``repro.core.executor`` (paper Fig. 2):

  RML doc --plan--> physical ops --batches--> device steps
       sources -> columnar load -> dictionary encode -> fixed-shape batches
  each step: triple keys (``hash_mix`` kernel) -> radix PTT insert
  (``bucket_dedup`` kernel); OJM rules probe the PJTT (sorted or hash)
  first.  The Knowledge Graph Creator appends the ``is_new`` triples
  incrementally.

Engines:
  * ``optimized`` — the SDM-RDFizer operators (PTT incremental dedup, PJTT
    index join), eager or streamed block by block (``stream=True``).
  * ``naive``     — SDM-RDFizer⁻: generate everything, nested-loop joins
    (``nested_join`` kernel), one sort dedup per predicate at the end.

Device code runs on ``EngineConfig.device`` ("cuda" by default); the CPU is
used only when asked for.  The written N-Triples are byte-identical to the
JAX engine's, for every engine and join strategy.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import operators, pjtt, planner, ptt
from repro_torch.core.hashset import next_pow2
from repro_torch.data import pipeline
from repro_torch.data.encoder import Dictionary, join_columns
from repro_torch.data.sources import SourceCache
from repro_torch.data.terms import render_term
from repro_torch.rml.model import MappingDocument


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


def _ojm_step(
    table, index, subj_tmpl, subj_vals, pred_id, obj_tmpl, max_matches,
    child_keys, valid,
):
    """OJM step: probe the PJTT (sorted or hash) -> expand -> masked PTT
    insert."""
    if isinstance(index, pjtt.PJTTSorted):
        pr = pjtt.probe_sorted(index, child_keys, max_matches)
    else:
        pr = pjtt.probe_hash(index, child_keys, max_matches)
    m, K = pr.subjects.shape
    subj = subj_vals[:, None].expand(m, K).reshape(-1)
    obj = pr.subjects.reshape(-1)
    v = (pr.valid & valid[:, None]).reshape(-1)
    res = ptt.insert_triples(ptt.PTT(table), subj_tmpl, subj, pred_id, obj_tmpl, obj, v)
    return (
        res.ptt.table, res.is_new.view(m, K), pr.subjects, v.view(m, K),
        res.overflowed, pr.truncated,
    )


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _build_pjtt(join_strategy: str, keys: torch.Tensor, subjects: torch.Tensor):
    if join_strategy == "hash":
        return pjtt.build_hash(keys, subjects)
    return pjtt.build_sorted(keys, subjects)


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

    def to_store(self, device="cuda"):
        """Servable form: a queryable, persistable
        ``repro_torch.kg.TripleStore`` built array-at-a-time over these
        int32 columns, its index sorts on ``device``."""
        from repro_torch.kg.store import TripleStore

        return TripleStore.from_kg(self.dictionary, self.triples, device=device)


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
    engine: str = "optimized"        # optimized | naive
    join_strategy: str = "sorted"    # sorted | hash
    batch_size: int = 1 << 16
    load_factor: float = 0.6
    max_matches: int | None = None   # None -> derived from true max span
    # streaming ingestion (repro_torch.stream): block-at-a-time, out-of-core
    stream: bool = False
    block_rows: int = 1 << 14
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
        dev = resolve_device(cfg.device)
        mplan = None
        if cfg.mapping_plan:
            from repro_torch.rml.plan import build_plan

            mplan = build_plan(doc)
            _plan_gauges(mplan)
        if cfg.stream:
            if cfg.engine != "optimized":
                raise ValueError(
                    "stream=True supports only the optimized engine "
                    "(the naive engine materializes everything by design)"
                )
            if cfg.block_rows < 1:
                raise ValueError(f"block_rows must be >= 1, got {cfg.block_rows}")
            return self._run_stream(doc, data_root, tables, t0, dev, mplan=mplan)
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

        # ---- build PJTTs once per (parent map, join column)
        indexes: dict[str, tuple | pjtt.PJTTSorted | pjtt.PJTTHash] = {}
        for pkey, (psrc, pcol, _ppat, pcols) in exec_plan.pjtt_builds.items():
            kd = _to_device(values_for(psrc, (pcol,)), dev)
            sd = _to_device(values_for(psrc, pcols), dev)
            if cfg.engine == "naive":
                indexes[pkey] = (kd, sd)  # raw arrays for the nested loop
            else:
                indexes[pkey] = _build_pjtt(cfg.join_strategy, kd, sd)

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
                    skeys = torch.sort(_to_device(
                        values_for(op.parent_source_key, (op.parent_join_column,)), dev
                    )).values
                    ck = _to_device(values_for(op.source_key, (op.join_child_column,)), dev)
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
                if cfg.engine == "optimized":
                    self._run_optimized(
                        exec_plan, values_for, indexes, pred_candidates,
                        op_spans, stats, triples_out, dct, dev,
                        pred_items=pred_items,
                    )
                else:
                    self._run_naive(
                        exec_plan, values_for, indexes, op_spans, stats,
                        triples_out, dct, dev, pred_items=pred_items,
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

    # -- shared per-batch step (eager and streamed paths) ----------------------

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
            table, is_new, psubj, v, ovf, trunc = _ojm_step(
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

    # -- streamed optimized engine (repro_torch.stream) ------------------------

    def _run_stream(self, doc, data_root, tables, t0, dev, mplan=None) -> KGResult:
        """Out-of-core KG creation.  Every source flows block-at-a-time
        through a lazy ``read -> project -> derive -> encode -> batch``
        Dataset; only dictionary-encoded int32 ids (and the PJTT indexes
        built from them) outlive a block, so host memory is bounded by
        O(block_rows) per raw column regardless of source size.  Sized like
        the eager engine (exact span stats, streamed), with the same
        overflow-replay fallback — a replay re-reads the source rather than
        re-using a cached table.

        With a :class:`~repro_torch.rml.plan.MappingPlan`
        (``mapping_plan=True``) three planner-driven optimizations engage,
        none of which changes the produced KG: projections are pushed into
        the readers (pruned columns never materialize), shared term columns
        are evaluated once per source scan and served from an int32 cache,
        and the rule groups run as a DAG — each group's factored cache and
        PJTT indexes live only for that group.

        ``KGResult.load_encode_s`` is the time this thread spends pulling
        blocks from the streams (waiting on the prefetched read, projecting
        and encoding); only this thread makes device tensors."""
        import os

        from repro_torch import obs
        from repro_torch.stream import Dataset, read_source
        from repro_torch.stream.block import Block
        from repro_torch.stream.datasource import is_sharded_path

        cfg = self.config
        exec_plan = mplan.exec_plan if mplan is not None else planner.plan(doc)
        reg = obs.get_registry()
        dct = Dictionary()
        block_rows = cfg.block_rows
        # block_rows bounds I/O granularity; batch_size still bounds the
        # device batch (a block is split into padded batches if the user
        # asked for a smaller device shape)
        device_rows = min(cfg.batch_size, block_rows)
        prefetch = 2  # blocks read ahead of the engine, per stream
        sources_by_key = _sources_by_key(doc)
        load_encode_s = 0.0

        def timed(blocks):
            """The blocks of an iterator, with the time spent making each
            one added to ``load_encode_s``."""
            nonlocal load_encode_s
            it = iter(blocks)
            while True:
                t = time.perf_counter()
                block = next(it, None)
                load_encode_s += time.perf_counter() - t
                if block is None:
                    return
                yield block

        def count_rows(source_key: str) -> int:
            nonlocal load_encode_s
            t = time.perf_counter()
            n = dataset_for(source_key).count()
            load_encode_s += time.perf_counter() - t
            return n

        def resolve(source_key: str) -> tuple[str, str, str | None]:
            """source_key -> (fmt, absolute path, iterator)."""
            src = sources_by_key.get(source_key)
            if src is not None:
                fmt, path, iterator = src.fmt, src.path, src.iterator
            else:
                fmt, path, iterator = planner.parse_source_key(source_key)
            if not os.path.isabs(path):
                path = os.path.join(data_root, path)
            return fmt, path, iterator

        def dataset_for(source_key: str) -> Dataset:
            if tables is not None and source_key in tables:
                return Dataset.from_table(tables[source_key], block_rows=block_rows)
            fmt, path, iterator = resolve(source_key)
            return read_source(
                path, fmt=fmt, block_rows=block_rows, iterator=iterator
            )

        def fill_of(source_key: str) -> str | None:
            """Projection fill policy: "" (union-fill) for genuinely
            heterogeneous sources — JSON records and glob-sharded files —
            matching the eager loader's key-union; None (strict KeyError,
            matching the eager engine's table[c]) for fixed-schema
            single-file CSV/TSV and the tables bypass, where a missing
            column is a mapping typo."""
            if tables is not None and source_key in tables:
                return None
            fmt, path, _ = resolve(source_key)
            if fmt == "json":
                return ""
            return "" if is_sharded_path(path) else None

        def derived(block: Block, columns: tuple) -> np.ndarray:
            """String value column for a (possibly multi-column) term; a
            constant term is int32 zeros, which Encode passes through."""
            if not columns:
                return np.zeros(block.n_rows, dtype=np.int32)
            return join_columns([block.columns[c] for c in columns])

        def op_dataset(op) -> Dataset:
            if op.kind == "OJM":
                extra: tuple = (op.join_child_column,)
            elif op.kind in ("SOM", "ORM"):
                extra = tuple(op.obj_columns)
            else:
                extra = ()
            needed = tuple(dict.fromkeys(tuple(op.subj_columns) + extra))

            def to_term_columns(block: Block) -> Block:
                cols = {"subj": derived(block, op.subj_columns)}
                if op.kind == "OJM":
                    cols["jkey"] = block.columns[op.join_child_column]
                elif op.kind in ("SOM", "ORM"):
                    cols["obj"] = derived(block, op.obj_columns)
                else:  # CLASS: constant object
                    cols["obj"] = np.zeros(block.n_rows, dtype=np.int32)
                return Block(cols)

            # all-constant ops read no columns; skip the projection entirely
            # (a zero-column block would lose its row count) and let
            # to_term_columns derive zeros from the raw block's n_rows
            ds = dataset_for(op.source_key)
            if needed:
                ds = ds.project(*needed, fill=fill_of(op.source_key))
            return ds.map_blocks(to_term_columns).encode(dct).batch(block_rows)

        # ---- referenced-column validation for union-fill sources: a column
        # absent from EVERY record is a mapping typo (the eager engine's
        # table[c] raises on it); fill-mode projection would otherwise
        # silently emit ""-term triples.  The scan also yields row counts,
        # sparing these sources the sizing count pass below.
        refcols: dict[str, set] = {}
        for op in exec_plan.ops:
            cols = refcols.setdefault(op.source_key, set())
            cols.update(op.subj_columns)
            if op.kind == "OJM":
                cols.add(op.join_child_column)
            else:
                cols.update(op.obj_columns)
        for psrc_, pcol_, _ppat_, pcols_ in exec_plan.pjtt_builds.values():
            cols = refcols.setdefault(psrc_, set())
            cols.add(pcol_)
            cols.update(pcols_)
        row_counts: dict[str, int] = {}
        for skey, cols in refcols.items():
            if not cols or fill_of(skey) is None:
                continue
            seen: set = set()
            n = 0
            for block in timed(dataset_for(skey).iter_blocks(prefetch)):
                seen |= set(block.schema)
                n += block.n_rows
            row_counts[skey] = n
            missing = cols - seen
            if missing:
                raise KeyError(
                    f"columns {sorted(missing)} not present in any record of "
                    f"source {skey!r}"
                )

        # ---- planner-on state: the factored shared-term cache.  Keyed
        # (source_key, columns) like the eager path's value cache, holding
        # the dictionary-encoded int32 value column of a term evaluated by
        # >= 2 sites.  Filled per group, freed when the group completes.
        value_cache: dict[tuple, np.ndarray] = {}

        def build_factored(group) -> None:
            """One streaming pass per source with shared terms: evaluate
            and encode every factored term column of the group (FunMap's
            pre-materialization, scoped to the group's lifetime)."""
            nonlocal load_encode_s
            per_src: dict[str, list[tuple]] = {}
            for (skey, colset), _sh in mplan.shared.items():
                if skey in group.sources:
                    per_src.setdefault(skey, []).append(colset)
            for skey, colsets in sorted(per_src.items()):
                union_raw = tuple(
                    dict.fromkeys(c for cols in colsets for c in cols)
                )
                ds = dataset_for(skey).project(
                    *union_raw, fill=fill_of(skey), pushdown=True
                )
                chunks: dict[tuple, list] = {cols: [] for cols in colsets}
                n = 0
                for block in timed(ds.iter_blocks(prefetch)):
                    t = time.perf_counter()
                    for cols in colsets:
                        chunks[cols].append(dct.encode(derived(block, cols)))
                    load_encode_s += time.perf_counter() - t
                    n += block.n_rows
                for cols in colsets:
                    value_cache[(skey, cols)] = (
                        np.concatenate(chunks[cols])
                        if chunks[cols]
                        else np.zeros(0, np.int32)
                    )
                row_counts[skey] = n

        def op_blocks(op):
            """Planner-on block stream for one op: slots whose term column
            is in the factored cache are sliced from it; remaining slots
            stream the source with the projection pushed into the read."""
            slots: list[tuple[str, tuple]] = [("subj", tuple(op.subj_columns))]
            if op.kind == "OJM":
                slots.append(("jkey", (op.join_child_column,)))
            elif op.kind in ("SOM", "ORM"):
                slots.append(("obj", tuple(op.obj_columns)))
            else:  # CLASS: constant object
                slots.append(("obj", ()))
            cached: dict[str, np.ndarray] = {}
            uncached: list[tuple[str, tuple]] = []
            for name, cols in slots:
                if not cols:
                    continue  # constant slot: zeros derived per block
                arr = value_cache.get((op.source_key, cols))
                if arr is not None:
                    cached[name] = arr
                else:
                    uncached.append((name, cols))
            if not uncached:
                # fully factored (or all-constant): no re-read at all
                if cached:
                    length = len(next(iter(cached.values())))
                else:
                    length = row_counts.get(op.source_key)
                    if length is None:  # timed by the caller, as a block read
                        length = dataset_for(op.source_key).count()
                        row_counts[op.source_key] = length
                for start in range(0, length, block_rows):
                    end = min(start + block_rows, length)
                    cols_out = {}
                    for name, _cols in slots:
                        if name in cached:
                            cols_out[name] = cached[name][start:end]
                        else:
                            cols_out[name] = np.zeros(end - start, np.int32)
                    reg.inc("plan.factored_rows", (end - start) * len(cached))
                    yield Block(cols_out)
                return
            needed = tuple(
                dict.fromkeys(c for _n, cols in uncached for c in cols)
            )
            ds = dataset_for(op.source_key).project(
                *needed, fill=fill_of(op.source_key), pushdown=True
            )
            offset = 0
            for block in ds.iter_blocks(prefetch):
                m = block.n_rows
                cols_out = {}
                for name, cols in slots:
                    if name in cached:
                        cols_out[name] = cached[name][offset:offset + m]
                    elif not cols:
                        cols_out[name] = np.zeros(m, np.int32)
                    else:
                        cols_out[name] = dct.encode(derived(block, cols))
                if cached:
                    reg.inc("plan.factored_rows", m * len(cached))
                offset += m
                yield Block(cols_out)

        # ---- PJTT builds: stream the parent once; retain only int32 ids
        indexes: dict[str, pjtt.PJTTSorted | pjtt.PJTTHash] = {}
        parent_counts: dict[str, int] = {}
        sorted_parent_keys: dict[str, np.ndarray] = {}

        def build_pjtts(pjtt_items) -> None:
            for pkey, (psrc, pcol, _ppat, pcols) in pjtt_items:
                kc = value_cache.get((psrc, (pcol,)))
                sc = value_cache.get((psrc, tuple(pcols)))
                if kc is not None and (sc is not None or not pcols):
                    # both columns already factored: build from the cache
                    pkeys = kc
                    psubj = (
                        sc if sc is not None else np.zeros(len(kc), np.int32)
                    )
                    reg.inc("plan.factored_rows", 2 * len(pkeys))
                else:
                    needed = tuple(dict.fromkeys((pcol,) + tuple(pcols)))

                    def to_index_columns(
                        block: Block, pcol=pcol, pcols=pcols
                    ) -> Block:
                        return Block(
                            {
                                "key": block.columns[pcol],
                                "subj": derived(block, pcols),
                            }
                        )

                    ds = dataset_for(psrc).project(
                        *needed, fill=fill_of(psrc),
                        pushdown=mplan is not None,
                    )
                    ds = ds.map_blocks(to_index_columns).encode(dct)
                    kchunks, schunks = [], []
                    for block in timed(ds.iter_blocks(prefetch)):
                        kchunks.append(block.columns["key"])
                        schunks.append(block.columns["subj"])
                    pkeys = (
                        np.concatenate(kchunks) if kchunks
                        else np.zeros(0, np.int32)
                    )
                    psubj = (
                        np.concatenate(schunks) if schunks
                        else np.zeros(0, np.int32)
                    )
                indexes[pkey] = _build_pjtt(
                    cfg.join_strategy, _to_device(pkeys, dev), _to_device(psubj, dev)
                )
                parent_counts[pkey] = len(pkeys)
                sorted_parent_keys[pkey] = np.sort(np.asarray(pkeys))
                row_counts[psrc] = len(pkeys)

        # ---- sizing pre-pass: exact |N_p| and max span, streamed
        stats: dict[str, PredicateStats] = {}
        pred_candidates: dict[str, int] = {}
        op_spans: dict[int, tuple[int, int]] = {}

        def size_predicates(pred_list) -> None:
            for pred in pred_list:
                op_idxs = exec_plan.by_predicate[pred]
                total = 0
                stats[pred] = PredicateStats(
                    kind=exec_plan.ops[op_idxs[0]].kind
                )
                for i in op_idxs:
                    op = exec_plan.ops[i]
                    if op.kind == "OJM":
                        spk = sorted_parent_keys[op.pjtt_key]
                        ck_all = value_cache.get(
                            (op.source_key, (op.join_child_column,))
                        )
                        if ck_all is not None:
                            # factored child key: span stats with no re-read
                            cnt = np.searchsorted(spk, ck_all, side="right") \
                                - np.searchsorted(spk, ck_all, side="left")
                            tot = int(cnt.sum()) if len(cnt) else 0
                            mx = int(cnt.max()) if len(cnt) else 0
                            row_counts[op.source_key] = len(ck_all)
                        else:
                            tot = mx = n = 0
                            ds = (
                                dataset_for(op.source_key)
                                .project(
                                    op.join_child_column,
                                    fill=fill_of(op.source_key),
                                    pushdown=mplan is not None,
                                )
                                .encode(dct)
                            )
                            for block in timed(ds.iter_blocks(prefetch)):
                                ck = block.columns[op.join_child_column]
                                cnt = np.searchsorted(spk, ck, side="right") \
                                    - np.searchsorted(spk, ck, side="left")
                                if len(cnt):
                                    tot += int(cnt.sum())
                                    mx = max(mx, int(cnt.max()))
                                n += block.n_rows
                            row_counts[op.source_key] = n
                        op_spans[i] = (tot, mx)
                        total += tot
                    else:
                        n = row_counts.get(op.source_key)
                        if n is None:
                            n = count_rows(op.source_key)
                            row_counts[op.source_key] = n
                        op_spans[i] = (n, 1)
                        total += n
                pred_candidates[pred] = total

        # ---- run the ops, block-at-a-time
        triples_out: dict[str, dict[str, list[np.ndarray]]] = {}

        def run_predicates(pred_list) -> None:
            for pred in pred_list:
                op_idxs = exec_plan.by_predicate[pred]
                cap = next_pow2(int(pred_candidates[pred] / cfg.load_factor) + 16)
                while True:  # overflow -> double capacity, re-stream
                    table = ptt.make_capacity(cap, device=dev).table
                    out = {
                        k: []
                        for k in ("subj_pat", "subj_val", "obj_pat", "obj_val")
                    }
                    st = stats[pred]
                    st.n_candidates = st.n_unique = st.n_parent = st.n_child = 0
                    overflow = False
                    for i in op_idxs:
                        op = exec_plan.ops[i]
                        pid = np.int32(dct.encode_scalar(op.predicate))
                        spat = np.int32(dct.encode_scalar(op.subj_pattern))
                        opat = np.int32(dct.encode_scalar(op.obj_pattern))
                        idx = None
                        K = 1
                        if op.kind == "OJM":
                            idx = indexes[op.pjtt_key]
                            _tot, mx = op_spans[i]
                            K = cfg.max_matches or max(int(mx), 1)
                            st.n_parent += parent_counts[op.pjtt_key]
                            st.n_child += row_counts[op.source_key]
                        blocks = timed(
                            op_blocks(op)
                            if mplan is not None
                            else op_dataset(op).iter_blocks(prefetch)
                        )
                        for block in blocks:
                            for batch in pipeline.batches(
                                block.columns, device_rows
                            ):
                                table, ovf = self._consume_batch(
                                    op, spat, pid, opat, table, batch,
                                    idx, K, out, st, dev,
                                )
                                if ovf:
                                    overflow = True
                                    break
                            if overflow:
                                break
                        if overflow:
                            break
                    if not overflow:
                        triples_out[pred] = out
                        break
                    cap *= 2

        if mplan is None:
            build_pjtts(exec_plan.pjtt_builds.items())
            size_predicates(list(exec_plan.by_predicate))
            run_predicates(list(exec_plan.by_predicate))
        else:
            # group-by-group along the DAG: factored cache and PJTT
            # indexes are built at group entry and freed at group exit
            for g in mplan.groups:
                with obs.span("plan_group", cat="plan", group=g.index,
                              rules=len(g.op_indices)):
                    build_factored(g)
                    build_pjtts(
                        (pk, exec_plan.pjtt_builds[pk]) for pk in g.pjtt_keys
                    )
                    size_predicates(list(g.predicates))
                    run_predicates(list(g.predicates))
                for skey in g.sources:
                    for key in [k for k in value_cache if k[0] == skey]:
                        del value_cache[key]
                for pk in g.pjtt_keys:
                    indexes.pop(pk, None)
                    sorted_parent_keys.pop(pk, None)

        # emit in the op plan's predicate order regardless of group
        # scheduling: the written KG is byte-identical planner-on/off
        final = {
            pred: {
                k: np.concatenate(v) if v else np.zeros(0, np.int32)
                for k, v in triples_out[pred].items()
            }
            for pred in exec_plan.by_predicate
        }
        stats = {pred: stats[pred] for pred in exec_plan.by_predicate}
        return KGResult(
            dictionary=dct,
            triples=final,
            stats=stats,
            wall_time_s=time.perf_counter() - t0,
            engine="stream",
            load_encode_s=load_encode_s,
        )

    # -- naive engine ----------------------------------------------------------

    def _run_naive(
        self, exec_plan, values_for, indexes, op_spans, stats, triples_out,
        dct, dev, pred_items=None,
    ):
        """SDM-RDFizer⁻: every candidate triple of a predicate is generated
        (OJM through the nested-loop join), keyed, and deduplicated by one
        sort.  The (m, K) join lanes stay on the device; only the surviving
        triples come back, in lane order."""
        cfg = self.config
        if pred_items is None:
            pred_items = exec_plan.by_predicate.items()
        for pred, op_idxs in pred_items:
            parts = []  # (spat, opat, subjects [n], K, objects [n*K])
            keys = []
            st = stats[pred]
            for i in op_idxs:
                op = exec_plan.ops[i]
                pid = dct.encode_scalar(op.predicate)  # ids in the JAX order
                spat = dct.encode_scalar(op.subj_pattern)
                opat = dct.encode_scalar(op.obj_pattern)
                p = operators.StaticTripleParams(subj_tmpl=spat, pred_id=pid, obj_tmpl=opat)
                subj_vals = values_for(op.source_key, op.subj_columns)
                n = len(subj_vals)
                sv = _to_device(subj_vals, dev)
                if op.kind == "OJM":
                    pkeys, psubj = indexes[op.pjtt_key]
                    _tot, mx = op_spans[i]
                    K = cfg.max_matches or max(int(mx), 1)
                    ck = _to_device(values_for(op.source_key, (op.join_child_column,)), dev)
                    nk, subjects, trunc = operators.naive_ojm_keys(
                        pkeys, psubj, sv, ck, p, K
                    )
                    if bool(trunc):
                        raise RuntimeError("naive join exceeded max_matches")
                    obj = subjects.reshape(-1)
                    st.n_parent += pkeys.shape[0]
                    st.n_child += n
                else:
                    K = 1
                    if op.kind == "CLASS":
                        obj = torch.zeros_like(sv)
                    else:
                        obj = _to_device(values_for(op.source_key, op.obj_columns), dev)
                    nk = operators.naive_som_keys(sv, obj, p)
                parts.append((spat, opat, sv, K, obj))
                keys.append(nk)
            v = torch.cat([k.valid for k in keys])
            st.n_candidates = int(v.sum())
            dd = operators.naive_dedup(operators.NaiveKeys(
                torch.cat([k.key_hi for k in keys]),
                torch.cat([k.key_lo for k in keys]), v,
            ))
            del keys, v
            st.n_unique = int(dd.n_unique)
            out = {k: [] for k in ("subj_pat", "subj_val", "obj_pat", "obj_val")}
            off = 0
            for spat, opat, sv, K, obj in parts:
                lanes = torch.nonzero(dd.uniq_mask[off:off + obj.shape[0]])[:, 0]
                off += obj.shape[0]
                out["subj_val"].append(sv[lanes // K].cpu().numpy())
                out["obj_val"].append(obj[lanes].cpu().numpy())
                out["subj_pat"].append(np.full(len(lanes), spat, np.int32))
                out["obj_pat"].append(np.full(len(lanes), opat, np.int32))
            triples_out[pred] = out


def create_kg(
    doc: MappingDocument,
    data_root: str = ".",
    tables=None,
    **config,
) -> KGResult:
    """One-call public API: parse-level document -> knowledge graph.
    ``device`` defaults to "cuda"."""
    return Engine(EngineConfig(**config)).run(doc, data_root=data_root, tables=tables)
