"""The single-device part of ``repro.configs.cells``' recsys training cell.

``recsys_train_cell`` builds ``AdamW(lr=1e-3)`` and ``make_train_step``
around ``recsys.loss_fn`` and runs it on batches of
``RECSYS_SHAPES["train_batch"]`` rows.  Here the same step trains a
``WideDeep`` module on one device; the mesh, the parameter and optimizer
specs and ``eval_shape`` wait for the port's mesh work.
"""

from __future__ import annotations

import torch

from repro_torch.models.recsys import WideDeep, WideDeepConfig, bce_loss
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step

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
    for name in WIDTHS:
        if getattr(cfg, name) != getattr(model.cfg, name):
            raise ValueError(f"cfg.{name} = {getattr(cfg, name)!r}, the model's is "
                             f"{getattr(model.cfg, name)!r}")
    model.cfg = cfg
    opt = opt if opt is not None else AdamW(lr=1e-3)

    def loss(params, sparse_ids, dense_feats, labels):
        logits = torch.func.functional_call(model, params, (sparse_ids, dense_feats))
        return bce_loss(logits, labels)

    return make_train_step(loss, opt, **step_kw), opt, dict(model.named_parameters())
