"""End-to-end LM training driver with fault tolerance.

The port of ``repro.launch.train``: trains a registered LM at its smoke
configuration on one device through the port's ``train/*``, wrapped in the
fault-tolerance substrate: periodic (background) checkpoints, crash retry
with restore, straggler detection.  The same flags, plus ``--device``
(default ``cuda``; a host without a card fails rather than falling back).
Only the LM family trains here, as in JAX.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --steps 200 --batch 8 --seq 128 --ckpt-every 50 --out /tmp/run1 [--device cpu]

The synthetic corpus and the batches are numpy draws in JAX's order; the
weights are the port's, drawn from seed 0.  Checkpoints are JAX's format,
so either driver resumes the other's (``--resume``).  A restore after a
failure first waits for the background saves already started, so it finds
the latest checkpoint whatever the writer thread's progress.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument(
        "--simulate-failure-at", type=int, default=-1,
        help="raise at this step once, to exercise the retry/restore path",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (no fallback)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.core.executor import resolve_device
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint, fault
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import make_train_step

    entry = registry.get_arch(args.arch)
    if entry.family != "lm":
        raise SystemExit(
            f"{args.arch} is {entry.family}; this driver trains the LM family"
            " (see examples/ for gnn/recsys end-to-end runs)"
        )
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(entry.smoke_config(), sequence_parallel=False)
    print(f"[train] {cfg.name} smoke config: {cfg.param_count()/1e6:.2f}M params")

    model = transformer.Transformer(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    opt = AdamW(lr=args.lr)
    step_fn = make_train_step(
        lambda p, t, l: transformer.loss_fn(cfg, transformer.nest(p), t, l),
        opt,
        compress=args.compress_grads,
    )
    state = {"opt": opt.init(params), "err": None}

    def load(path):
        """Restore ``path`` into the model's parameters (in place) and the
        optimizer state; -> its step."""
        (rp, ro), s = checkpoint.restore(path, (params, state["opt"]), device=dev)
        with torch.no_grad():
            for k, v in rp.items():
                params[k].copy_(v)
        state["opt"] = ro
        return s

    start_step = 0
    if args.resume:
        latest = checkpoint.latest_step_dir(args.out)
        if latest:
            start_step = load(latest)
            print(f"[train] resumed from {latest} at step {start_step}")

    # synthetic LM data: next-token prediction over a fixed random corpus so
    # the loss has real signal (memorization) and must go DOWN
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab, size=(64, args.seq + 1)).astype(np.int32)
    corpus_t = torch.from_numpy(corpus).to(dev)

    detector = fault.StragglerDetector()
    policy = fault.RetryPolicy(max_retries=3, backoff_s=0.1)
    failures, saving = [], []

    def settle():
        for t in saving:
            t.join()
        saving.clear()

    def restore_hook(attempt, exc):
        failures.append(str(exc))
        settle()
        latest = checkpoint.latest_step_dir(args.out)
        if latest:
            s = load(latest)
            print(f"[train] restored step {s} after failure: {exc}")

    losses = []
    for step in range(start_step, args.steps):
        idx = torch.from_numpy(rng.integers(0, len(corpus), size=args.batch)).to(dev)
        toks, labels = corpus_t[idx, :-1], corpus_t[idx, 1:]

        def do_step():
            if args.simulate_failure_at == step and not failures:
                raise RuntimeError("simulated node failure")
            if args.compress_grads:
                _, o, m, e = step_fn(params, state["opt"], toks, labels,
                                     error_fb=state["err"])
                state["err"] = e
            else:
                _, o, m = step_fn(params, state["opt"], toks, labels)
            state["opt"] = o
            return m

        t0 = time.perf_counter()
        metrics = policy.run(do_step, on_failure=restore_hook)
        losses.append(float(metrics["loss"]))
        detector.observe(time.perf_counter() - t0)

        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            saving.append(checkpoint.save(
                os.path.join(args.out, f"step_{step}"),
                (params, state["opt"]),
                step=step,
                background=True,
            ))

    settle()
    checkpoint.save(
        os.path.join(args.out, f"step_{args.steps}"),
        (params, state["opt"]), step=args.steps,
    )
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return {"start_step": start_step, "losses": losses, "failures": failures,
            "step": int(state["opt"].step)}


if __name__ == "__main__":
    main()
