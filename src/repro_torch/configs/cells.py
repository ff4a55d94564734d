"""The single-device part of ``repro.configs.cells``' training cells.

JAX's ``recsys_train_cell``, ``lm_train_cell`` and ``gnn_train_cell`` each
build an ``AdamW`` and ``make_train_step`` around the family's loss and
lower it on a mesh.  Here the same steps train the port's modules on one
device: ``recsys_train_step`` (Wide & Deep), ``lm_train_step`` (the LMs)
and ``gnn_train_step`` (the GNNs).  Each returns ``(step, opt, params)``,
where ``params`` are the module's own parameters by name, which the step
updates in place.  The mesh, the parameter and optimizer specs and
``eval_shape`` wait for the port's mesh work.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, transformer
from repro_torch.models.gnn import equiformer, gat, meshgraphnet, nequip
from repro_torch.models.recsys import WideDeep, WideDeepConfig, bce_loss
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step

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
