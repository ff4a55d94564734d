"""Train a qwen-family model on a fixed random corpus until its loss falls:
the training driver at example scale.

The port of ``examples/train_lm.py``: ``--size tiny`` is qwen2.5-3b's smoke
config, ``--size 100m`` the JAX example's ~100M variant (8 layers, d_model
512, vocab 32,000, fp32), trained with ``AdamW(lr=3e-3)`` on the JAX
example's numpy corpus and batches; the weights are the port's, drawn from
seed 0.  The loss must fall, as the JAX example asserts.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cuda|cpu] \
        [--size tiny|100m] [--steps 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--size", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (no fallback)")
    args = ap.parse_args(argv)

    from repro_torch.configs import qwen2_5_3b
    from repro_torch.core.executor import resolve_device
    from repro_torch.models import layers, transformer
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step

    dev = resolve_device(args.device)
    if args.size == "100m":
        cfg = dataclasses.replace(
            qwen2_5_3b.config(), n_layers=8, d_model=512, n_heads=8, n_kv=2,
            head_dim=64, d_ff=2048, vocab=32000, dtype=torch.float32,
            sequence_parallel=False, attn_chunk=None, microbatches=1,
        )
    else:
        cfg = qwen2_5_3b.smoke_config()
    print(f"training {cfg.name} variant: {cfg.param_count()/1e6:.1f}M params on {dev}")

    model = transformer.Transformer(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    step = make_train_step(
        lambda p, t, l: transformer.loss_fn(cfg, layers.nest(p), t, l), opt)

    # fixed random corpus -> loss must fall (memorization signal)
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(32, args.seq + 1)).astype(np.int32)).to(dev)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(corpus), size=args.batch)).to(dev)
        params, opt_state, m = step(params, opt_state, corpus[idx, :-1], corpus[idx, 1:])
        losses.append(float(m["loss"]))
        if i % 50 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not improve")
    print("loss improved — training works end to end")
    return {"losses": losses, "params": cfg.param_count()}


if __name__ == "__main__":
    main()
