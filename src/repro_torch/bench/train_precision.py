"""How far an fp32 Wide & Deep training step lands from an fp64 one.

The measurement behind the tolerances ``chip_smoke.py`` phase 16 states
when it holds training on the card against the CPU.  One model
(``configs.wide_deep`` at ``--vocab`` ids a field, weights from seed 1)
and ``--steps`` batches of ``--batch`` rows (Zipf(1.3) ids, the
example's labels) are trained three ways: through
``configs.cells.recsys_train_step`` in fp32 on ``--device`` and in fp32 on
the CPU, and in fp64 on the CPU (forward, loss and backward in fp64;
AdamW keeps its fp32 moments, as JAX's does).  Against the fp64 run, each
fp32 run reports:
- the first step's gradient error, a leaf (2-norm of the difference over
  the 2-norm of the fp64 gradient);
- the ReLUs that flip: the first batch's pre-activations on the other side
  of 0, a layer;
- loss and grad_norm a step (relative);
- the params after the steps, a leaf: the 2-norm of the difference over the
  2-norm of the fp64 run's update, and the largest |difference|.

    PYTHONPATH=src python -m repro_torch.bench.train_precision [--device cuda|cpu]
        [--vocab 65536] [--batch 4096] [--steps 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import cells, wide_deep
from repro_torch.core.executor import resolve_device
from repro_torch.models.recsys import WideDeep, bce_loss
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step


def _batches(cfg, n: int, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=cfg.n_dense).astype(np.float32)
    out = []
    for _ in range(n):
        sp = (np.minimum(rng.zipf(1.3, size=(batch, cfg.n_sparse, 1)), cfg.vocab_per_field)
              - 1).astype(np.int32)
        de = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        y = (de @ w_true + 0.3 * rng.normal(size=batch) > 0).astype(np.int32)
        out.append(tuple(torch.from_numpy(a) for a in (sp, de, y)))
    return out


def _bce64(logits, labels):
    y = labels.to(logits.dtype)
    return torch.mean(logits.clamp(min=0) - logits * y + torch.log1p(torch.exp(-logits.abs())))


def _train(cfg, device, dtype, batches, lr):
    """-> (first-step grads, first-batch pre-activations a layer, [(loss,
    grad_norm)] a step, params after the steps), all on the CPU in fp64."""
    model = WideDeep(cfg, device="cpu", seed=1).to(device=device, dtype=dtype)
    if dtype == torch.float32:
        step, opt, params = cells.recsys_train_step(cfg, model, AdamW(lr=lr))

        def logits_loss(p, sp, de, y):
            return bce_loss(torch.func.functional_call(model, p, (sp, de)), y)
    else:
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        params = dict(model.named_parameters())

        def logits_loss(p, sp, de, y):
            return _bce64(torch.func.functional_call(model, p, (sp, de)), y)

        opt = AdamW(lr=lr)
        step = make_train_step(logits_loss, opt)
    sp, de, y = (x.to(device) for x in batches[0])
    with torch.no_grad():
        grads = torch.func.grad(logits_loss)(params, sp, de, y)
        x = torch.cat([model.embedding_bag(sp), de.to(dtype)], dim=-1)
        pre = []
        for i in range(len(cfg.mlp)):
            x = model.mlp.get_submodule(f"fc{i}")(x)
            pre.append(x.cpu().double())
            x = torch.relu(x)
    state = opt.init(params)
    metrics = []
    for b in batches:
        params, state, m = step(params, state, *(t.to(device) for t in b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return ({k: g.cpu().double() for k, g in grads.items()}, pre, metrics,
            {k: p.detach().cpu().double() for k, p in params.items()})


def run(device="cuda", vocab=1 << 16, batch=4096, steps=2, lr=1e-3, seed=3,
        log=True) -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(wide_deep.config(), vocab_per_field=vocab)
    batches = _batches(cfg, steps, batch, seed)
    p0 = {k: p.detach().double() for k, p in WideDeep(cfg, device="cpu", seed=1)
          .named_parameters()}
    g64, pre64, m64, p64 = _train(cfg, torch.device("cpu"), torch.float64, batches, lr)
    report = {"vocab": vocab, "batch": batch, "steps": steps, "lr": lr,
              "fp64": {"loss_grad_norm": m64}, "runs": {}}
    devices = [dev] if dev.type == "cpu" else [dev, torch.device("cpu")]
    for d in devices:
        g, pre, m, p = _train(cfg, d, torch.float32, batches, lr)
        r = {
            "grad_rel_err": {k: float((g[k] - g64[k]).norm() / g64[k].norm()) for k in g64},
            "relu_flips": [int(((a > 0) != (b > 0)).sum()) for a, b in zip(pre, pre64)],
            "pre_activations": [a.numel() for a in pre],
            "loss_rel_err": [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(m, m64)],
            "grad_norm_rel_err": [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(m, m64)],
            "update_rel_err": {k: float((p[k] - p64[k]).norm() / (p64[k] - p0[k]).norm())
                               for k in p0},
            "max_abs_diff": {k: float((p[k] - p64[k]).abs().max()) for k in p0},
        }
        name = f"fp32 {d.type}"
        if d.type == "cuda":
            name += f" ({torch.cuda.get_device_name(d)})"
        report["runs"][name] = r
        if log:
            print(f"{name} against fp64 on the CPU (vocab {vocab}, batch {batch}, {steps} "
                  f"steps, lr {lr}):", flush=True)
            print(f"  step-1 gradient error a leaf: "
                  f"{ {k: f'{v:.3g}' for k, v in r['grad_rel_err'].items()} }")
            print(f"  ReLU flips a layer: {r['relu_flips']} of {r['pre_activations']}")
            print(f"  loss error a step {[f'{x:.3g}' for x in r['loss_rel_err']]}, grad_norm "
                  f"{[f'{x:.3g}' for x in r['grad_norm_rel_err']]}")
            print(f"  params: difference over the update's norm a leaf "
                  f"{ {k: f'{v:.3g}' for k, v in r['update_rel_err'].items()} }; largest "
                  f"|diff| {max(r['max_abs_diff'].values()):.3g}", flush=True)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.train_precision")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fp32 run beside the CPU's trains (no fallback)")
    ap.add_argument("--vocab", type=int, default=1 << 16)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    args = ap.parse_args(argv)
    report = run(args.device, args.vocab, args.batch, args.steps)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
