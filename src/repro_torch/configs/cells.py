"""Cell builders: (architecture x input shape x mesh) -> a traceable spec,
and the single-device train steps the train cells run.

The counterpart of ``repro.configs.cells``.  A *cell* is one dry-run unit:
``fn``, what the cell computes on one device over the port's modules, and
``args``, its arguments at the cell's global shapes and dtypes.  By default
the args are fake tensors (``FakeTensorMode``: shapes and dtypes, no
memory), so ``launch.dryrun`` traces a cell of any size; ``fake=False``
draws them for real from ``seed`` on ``device`` (ids in range, an empty
table), so the same cell also runs.  Torch tensors carry no sharding, so
``specs`` holds each arg's partition spec (``models.sharding.P``) in a tree
parallel to ``args``; ``sharding.local_shape`` reads per-device shapes off
it.  ``donate`` names the args the cell updates in place (JAX's donated
buffers) and ``note`` says what a cell's shape means.

The train steps (``recsys_train_step``, ``lm_train_step``,
``gnn_train_step``) are the ones JAX's train cells build: an ``AdamW`` and
``make_train_step`` around the family's loss.  Each returns ``(step, opt,
params)``, where ``params`` are the module's own parameters by name (a flat
dict keyed by JAX's dotted paths), which the step updates in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import distributed, hashing
from repro_torch.models import layers, recsys, transformer
from repro_torch.models.gnn import common as gnn_common
from repro_torch.models.gnn import equiformer, gat, meshgraphnet, nequip
from repro_torch.models.recsys import WideDeep, WideDeepConfig, bce_loss
from repro_torch.models.sharding import P
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step
from repro_torch.train.tree import tree_map

GNN_FAMILIES = {
    "gat-cora": (gat, gat.GATConfig),
    "meshgraphnet": (meshgraphnet, meshgraphnet.MGNConfig),
    "nequip": (nequip, nequip.NequIPConfig),
    "equiformer-v2": (equiformer, equiformer.EquiformerConfig),
}

WIDTHS = ("n_sparse", "embed_dim", "vocab_per_field", "n_dense", "mlp", "dtype")


def recsys_train_step(cfg: WideDeepConfig, model: WideDeep, opt: AdamW | None = None,
                      **step_kw):
    """-> (step, opt, params): the cell's train step for ``model`` run under
    ``cfg`` (whose ``dedup_cap`` and ``bag_size`` decide the lookup; every
    width must be the model's), its optimizer (``opt``, by default the
    cell's ``AdamW(lr=1e-3)``) and ``params``, the model's own parameters
    by name, which the step updates in place.  ``step_kw`` goes to
    ``make_train_step`` (``grad_accum``, ``compress``).

        step, opt, params = recsys_train_step(cfg, model)
        state = opt.init(params)
        params, state, metrics = step(params, state, sparse_ids, dense, labels)
    """
    _check_widths(cfg, model.cfg, WIDTHS)
    model.cfg = cfg
    opt = opt if opt is not None else AdamW(lr=1e-3)

    def loss(params, sparse_ids, dense_feats, labels):
        logits = torch.func.functional_call(model, params, (sparse_ids, dense_feats))
        return bce_loss(logits, labels)

    return make_train_step(loss, opt, **step_kw), opt, dict(model.named_parameters())


def _check_widths(cfg, model_cfg, fields) -> None:
    for name in fields:
        if getattr(cfg, name) != getattr(model_cfg, name):
            raise ValueError(f"cfg.{name} = {getattr(cfg, name)!r}, the model's is "
                             f"{getattr(model_cfg, name)!r}")


LM_WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff", "vocab",
             "qkv_bias", "tie_embeddings", "moe", "n_experts", "norm", "dtype")


def lm_train_step(cfg: transformer.LMConfig, model: transformer.Transformer,
                  opt: AdamW | None = None, **step_kw):
    """-> (step, opt, params): ``lm_train_cell``'s step for ``model`` run
    under ``cfg`` (whose ``remat``, ``attn_chunk`` and ``microbatches`` it
    follows; every width must be the model's): ``AdamW(lr=1e-4,
    weight_decay=0.1)`` unless ``opt`` is given, ``grad_accum =
    cfg.microbatches`` unless ``step_kw`` says otherwise, and
    ``transformer.loss_fn``.  With ``grad_accum > 1`` the batch has JAX's
    layout ``(accum, B / accum, S)``.

        step, opt, params = lm_train_step(cfg, model)
        state = opt.init(params)
        params, state, metrics = step(params, state, tokens, labels)
    """
    _check_widths(cfg, model.cfg, LM_WIDTHS)
    opt = opt if opt is not None else AdamW(lr=1e-4, weight_decay=0.1)
    step_kw.setdefault("grad_accum", cfg.microbatches)

    def loss(params, tokens, labels):
        return transformer.loss_fn(cfg, layers.nest(params), tokens, labels)

    return make_train_step(loss, opt, **step_kw), opt, dict(model.named_parameters())


def gnn_train_step(arch: str, cfg, model: layers.ParamTree, opt: AdamW | None = None,
                   n_graphs: int = 1, **step_kw):
    """-> (step, opt, params): ``gnn_train_cell``'s step for the GNN
    ``arch``'s ``model`` run under ``cfg`` (``registry.gnn_cell_config``
    gives a cell's): ``AdamW(lr=1e-3)`` unless ``opt`` is given, around
    ``module.loss_fn`` over ``n_graphs`` graphs (the shape's).  The step
    takes one ``GraphBatch`` of tensors.

        step, opt, params = gnn_train_step(arch, cfg, model)
        params, state, metrics = step(params, opt.init(params), batch)
    """
    module, cls = GNN_FAMILIES[arch]
    if not isinstance(cfg, cls):
        raise ValueError(f"{arch} trains under a {cls.__name__}, not {type(cfg).__name__}")
    opt = opt if opt is not None else AdamW(lr=1e-3)

    def loss(params, batch):
        return module.loss_fn(layers.nest(params), cfg, batch, n_graphs)

    return make_train_step(loss, opt, **step_kw), opt, dict(model.named_parameters())


# -------------------------------------------------------------------- cells


@dataclasses.dataclass
class CellSpec:
    name: str              # "<arch>/<shape>"
    kind: str              # train | prefill | decode | serve | retrieval | rdfizer
    fn: Callable           # what the cell computes on one device
    args: tuple            # trees of tensors at the cell's global shapes
    donate: tuple = ()     # args updated in place
    note: str = ""
    specs: tuple = ()      # each arg's partition spec, a tree parallel to args


class _Draw:
    """Where a cell's tensors come from, entered around everything the
    builder makes: fake tensors (a ``FakeTensorMode``, which takes the
    models' real constant tables in), or real ones drawn from ``seed`` on
    ``device``."""

    def __init__(self, device, fake: bool, seed: int):
        self.device = torch.device(device)
        self.seed = seed
        self.mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else (
            contextlib.nullcontext())
        self.gen = None

    def __enter__(self):
        self.mode.__enter__()
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def ints(self, shape, high: int, dtype=torch.int32):
        return torch.randint(0, high, shape, generator=self.gen, device=self.device,
                             dtype=dtype)

    def floats(self, shape, dtype=torch.float32):
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=dtype)

    def trues(self, shape):
        return torch.ones(shape, dtype=torch.bool, device=self.device)


def _dp(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _whole(tree):
    return tree_map(lambda _: P(), tree)


# ----------------------------------------------------------------------- LM


def lm_train_cell(cfg: transformer.LMConfig, mesh, batch: int, seq: int, *,
                  device="cpu", fake: bool = True, seed: int = 0) -> CellSpec:
    dp = _dp(mesh)
    accum = cfg.microbatches
    # microbatch accumulation: (accum, B/accum, S), looped by the step
    shape = (accum, batch // accum, seq) if accum > 1 else (batch, seq)
    with _Draw(device, fake, seed) as d:
        model = transformer.Transformer(cfg, device=d.device, seed=seed)
        step, opt, params = lm_train_step(cfg, model)
        state = opt.init(params)
        tokens, labels = d.ints(shape, cfg.vocab), d.ints(shape, cfg.vocab)
    pspecs = layers.flatten(transformer.param_specs(cfg))
    bspec = P(None, dp, None) if accum > 1 else P(dp, None)
    return CellSpec(
        name=f"{cfg.name}/train", kind="train", fn=step,
        args=(params, state, tokens, labels), donate=(0, 1),
        specs=(pspecs, opt.state_specs(pspecs), bspec, bspec),
    )


def lm_prefill_cell(cfg: transformer.LMConfig, mesh, batch: int, seq: int, *,
                    device="cpu", fake: bool = True, seed: int = 0) -> CellSpec:
    dp = _dp(mesh)

    def fn(params, tokens):
        with torch.no_grad():
            return transformer.prefill(cfg, layers.nest(params), tokens)

    with _Draw(device, fake, seed) as d:
        params = dict(transformer.Transformer(cfg, device=d.device, seed=seed).named_parameters())
        tokens = d.ints((batch, seq), cfg.vocab)
    return CellSpec(
        name=f"{cfg.name}/prefill", kind="prefill", fn=fn, args=(params, tokens),
        specs=(layers.flatten(transformer.param_specs(cfg)), P(dp, None)),
    )


def lm_decode_cell(cfg: transformer.LMConfig, mesh, batch: int, ctx_len: int,
                   serve_layout: bool = False, *, device="cpu", fake: bool = True,
                   seed: int = 0) -> CellSpec:
    dp = _dp(mesh)
    # batch 1 (long_500k) cannot shard over the data axes; the serve layout
    # replicates the token batch (weights resident), the cache stays
    # (batch->data, length->model)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    cache_dp = dp if batch % dp_size == 0 else None
    bdp = None if serve_layout else cache_dp

    def fn(params, cache, tokens, pos):
        with torch.no_grad():
            return transformer.decode_step(cfg, layers.nest(params), cache, tokens, pos)

    with _Draw(device, fake, seed) as d:
        params = dict(transformer.Transformer(cfg, device=d.device, seed=seed).named_parameters())
        cache = transformer.make_cache(cfg, batch, ctx_len, device=d.device)
        tokens = d.ints((batch, 1), cfg.vocab)
        pos = d.ints((), ctx_len)
    note = ""
    if cfg.window is not None and ctx_len > cfg.window:
        note = f"SWA ring buffer: cache is O(window={cfg.window}), logical ctx {ctx_len}"
    return CellSpec(
        name=f"{cfg.name}/decode", kind="decode", fn=fn,
        args=(params, cache, tokens, pos), donate=(1,), note=note,
        specs=(layers.flatten(transformer.param_specs(cfg, serve=serve_layout)),
               transformer.cache_specs(cfg, cache_dp), P(bdp, None), P()),
    )


# ---------------------------------------------------------------------- GNN


def _graph_batch(d: _Draw, n, e, d_feat, task, n_classes, n_graphs) -> gnn_common.GraphBatch:
    if task == "node_cls":
        labels, label_mask = d.ints((n,), max(n_classes, 1)), d.trues((n,))
    else:
        labels, label_mask = d.floats((n_graphs,)), d.trues((n_graphs,))
    graph_id = torch.div(torch.arange(n, dtype=torch.int32, device=d.device) * n_graphs, n,
                         rounding_mode="floor")
    return gnn_common.GraphBatch(
        node_feat=d.floats((n, d_feat)), positions=d.floats((n, 3)),
        edge_src=d.ints((e,), n), edge_dst=d.ints((e,), n),
        node_mask=d.trues((n,)), edge_mask=d.trues((e,)),
        labels=labels, graph_id=graph_id.to(torch.int32), label_mask=label_mask,
    )


def gnn_train_cell(arch: str, cfg, mesh, *, n, e, d_feat, task, n_classes=0, n_graphs=1,
                   shard_edges=False, shape_name="", device="cpu", fake: bool = True,
                   seed: int = 0) -> CellSpec:
    module, _ = GNN_FAMILIES[arch]
    if shard_edges:
        # the edge axis padded to the dp-axes product (padded edges masked)
        e = -(-e // 512) * 512
    edge_spec = P(_dp(mesh)) if shard_edges else P()
    with _Draw(device, fake, seed) as d:
        model = gnn_common.Model(module, cfg, device=d.device, seed=seed)
        step, opt, params = gnn_train_step(arch, cfg, model, n_graphs=n_graphs)
        state = opt.init(params)
        batch = _graph_batch(d, n, e, d_feat, task, n_classes, n_graphs)
    # GNN params are whole on every device (small next to the graph)
    graph_specs = gnn_common.GraphBatch(
        node_feat=P(), positions=P(), edge_src=edge_spec, edge_dst=edge_spec,
        node_mask=P(), edge_mask=edge_spec, labels=P(), graph_id=P(), label_mask=P())
    return CellSpec(
        name=f"{arch}/{shape_name}", kind="train", fn=step,
        args=(params, state, batch), donate=(0, 1),
        specs=(_whole(params), _whole(state), graph_specs),
    )


# -------------------------------------------------------------------- recsys


def _recsys_inputs(d: _Draw, cfg: WideDeepConfig, batch: int):
    return (d.ints((batch, cfg.n_sparse, cfg.bag_size), cfg.vocab_per_field),
            d.floats((batch, cfg.n_dense)))


def recsys_train_cell(cfg: WideDeepConfig, mesh, batch: int, *, device="cpu",
                      fake: bool = True, seed: int = 0) -> CellSpec:
    dp = _dp(mesh)
    with _Draw(device, fake, seed) as d:
        step, opt, params = recsys_train_step(cfg, WideDeep(cfg, device=d.device, seed=seed))
        state = opt.init(params)
        sp, de = _recsys_inputs(d, cfg, batch)
        y = d.ints((batch,), 2)
    pspecs = layers.flatten(recsys.param_specs(cfg))
    return CellSpec(
        name=f"{cfg.name}/train", kind="train", fn=step,
        args=(params, state, sp, de, y), donate=(0, 1),
        specs=(pspecs, AdamW().state_specs(pspecs), P(dp, None, None), P(dp, None), P(dp)),
    )


def recsys_serve_cell(cfg: WideDeepConfig, mesh, batch: int, shape_name: str, *,
                      device="cpu", fake: bool = True, seed: int = 0) -> CellSpec:
    dp = _dp(mesh)
    with _Draw(device, fake, seed) as d:
        model = WideDeep(cfg, device=d.device, seed=seed)
        params = dict(model.named_parameters())
        sp, de = _recsys_inputs(d, cfg, batch)

    def fn(params, sp, de):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (sp, de))

    return CellSpec(
        name=f"{cfg.name}/{shape_name}", kind="serve", fn=fn, args=(params, sp, de),
        specs=(layers.flatten(recsys.param_specs(cfg)), P(dp, None, None), P(dp, None)),
    )


class _Scores(nn.Module):
    """``WideDeep.retrieval_scores`` as a module's forward, so that
    ``functional_call`` binds the cell's params to it."""

    def __init__(self, model: WideDeep):
        super().__init__()
        self.model = model

    def forward(self, sp, de, cand):
        return self.model.retrieval_scores(sp, de, cand)


def recsys_retrieval_cell(cfg: WideDeepConfig, mesh, n_candidates: int, *, device="cpu",
                          fake: bool = True, seed: int = 0) -> CellSpec:
    n_candidates = -(-n_candidates // mesh.size) * mesh.size  # pad to the mesh size
    with _Draw(device, fake, seed) as d:
        scores = _Scores(WideDeep(cfg, device=d.device, seed=seed))
        params = dict(scores.model.named_parameters())
        sp, de = _recsys_inputs(d, cfg, 1)
        cand = d.floats((n_candidates, cfg.mlp[-1]))

    def fn(params, sp, de, cand):
        with torch.no_grad():
            bound = {f"model.{k}": v for k, v in params.items()}
            return torch.func.functional_call(scores, bound, (sp, de, cand))

    return CellSpec(
        name=f"{cfg.name}/retrieval_cand", kind="retrieval", fn=fn,
        args=(params, sp, de, cand),
        specs=(layers.flatten(recsys.param_specs(cfg)), P(), P(),
               P(tuple(mesh.axis_names), None)),
    )


# ------------------------------------------------------------------ rdfizer


def rdfizer_shuffle_cell(mesh, n_keys: int, *, device="cpu", fake: bool = True,
                         seed: int = 0) -> CellSpec:
    """The paper's own workload as a cell: one distributed shuffle-dedup step
    (PTT insert) across the whole mesh, 2^22 table slots a shard, its
    shards stacked on one device (``core.distributed``).  Its probe loop
    reads flags on the host, so it runs for real rather than traced.  Real
    keys are 64-bit ``mix64`` keys of ``n_keys / 4`` distinct words (75%
    duplicates), the table empty; words are int32 bit patterns, where JAX's
    are uint32."""
    axes = tuple(mesh.axis_names)
    n_shards = mesh.size
    cap = 1 << 22  # table slots a shard
    with _Draw(device, fake, seed) as d:
        thi = torch.full((n_shards, cap), hashing.EMPTY, dtype=torch.int32, device=d.device)
        tlo = torch.full((n_shards, cap), hashing.EMPTY, dtype=torch.int32, device=d.device)
        khi, klo = hashing.mix64([d.ints((n_keys,), max(n_keys // 4, 1))])
        valid = d.trues((n_keys,))

    def fn(thi, tlo, hi, lo, v):
        t, is_new, ovf = distributed.distributed_insert(
            n_shards, distributed.ShardedPTT(thi, tlo), hi, lo, v)
        return t.hi, t.lo, is_new.sum(), ovf

    return CellSpec(
        name="rdfizer/shuffle_dedup", kind="rdfizer", fn=fn,
        args=(thi, tlo, khi, klo, valid), donate=(0, 1),
        note="the paper's PTT insert at mesh scale",
        specs=(P(axes), P(axes), P(axes), P(axes), P(axes)),
    )
