"""Serve an LM with batched requests: prefill + batched decode with a KV
cache, composed only of ``transformer.prefill``, ``make_cache`` and
``decode_step``.

What ``examples/serve_lm.py`` of the JAX package describes; that file
hands its flags to ``repro.launch.serve``, which is now the KG query
server, and stops at "unrecognized arguments".  Here: the requests' prompts
are prefilled (the last position's logits); the cache is filled by
``decode_step`` over the prompt positions, and its last logits are held
against the prefill's (two paths of one model, within ``TOL`` of the
logits' largest magnitude); then ``--gen`` tokens are decoded greedily for
the whole batch.  Prints tokens/s for prefill and for decode.

Only dense archs are held to ``TOL``.  In an MoE arch an expert takes at
most ``capacity`` tokens of a dispatch and drops the rest, as in JAX; a
prefill dispatches B * S tokens, a decode step B, so the two paths drop
different tokens and are different functions (with room for every token
they agree to the last bit).  Their difference is printed, not checked.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cuda|cpu] \
        [--arch mixtral-8x7b] [--size smoke|full] [--layers N] [--batch 4] \
        [--prompt-len 24] [--gen 48]

The weights are random, drawn from seed 0; the prompts are numpy draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

# ||prefill - cache path||_inf / ||prefill||_inf.  fp32: the two paths
# differ only in summation order.  bf16: every layer's output is rounded
# at 2^-8 on each path, and the roundings differ with the matmul shapes; a
# fault (a wrong slot, position or mask) moves the logits by their own size.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}


def normwise_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).abs().max() / want.abs().max())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, prompts: torch.Tensor, gen: int) -> dict:
    """Prefill ``prompts`` (B, S), fill a cache over them by ``decode_step``,
    then decode ``gen`` tokens greedily from the prefill's last logits.
    -> the generated tokens (B, gen), the two paths' normwise error and the
    times (host clock, ending in a synchronize; the prefill is timed after
    one untimed warm-up prefill, the cache fill warms the decode step)."""
    from repro_torch.models import transformer

    dev = prompts.device
    B, S = prompts.shape
    with torch.inference_mode():
        transformer.prefill(cfg, params, prompts)
        _sync(dev)
        t0 = time.perf_counter()
        first = transformer.prefill(cfg, params, prompts)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        cache = transformer.make_cache(cfg, B, S + gen, dev)
        position = torch.zeros((), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for i in range(S):
            logits, cache = transformer.decode_step(cfg, params, cache, prompts[:, i:i + 1],
                                                    position)
            position = position + 1
        _sync(dev)
        t_fill = time.perf_counter() - t0
        err = normwise_err(logits, first)

        tok = torch.argmax(first[:, -1], dim=-1)[:, None]
        out = []
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = transformer.decode_step(cfg, params, cache, tok, position)
            position = position + 1
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        tokens = torch.cat(out, dim=1)
        finite = bool(torch.isfinite(first).all()) and bool(torch.isfinite(logits).all())
    return {
        "tokens": tokens, "logits_err": err, "finite": finite,
        "prefill_s": t_prefill, "prefill_tok_s": B * S / t_prefill,
        "fill_s": t_fill,
        "decode_s": t_decode, "decode_ms_step": t_decode / gen * 1e3,
        "decode_tok_s": B * gen / t_decode,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke",
                    help="the registry's smoke config or its published widths")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model serves (no fallback)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.core.executor import resolve_device
    from repro_torch.models import transformer

    entry = registry.get_arch(args.arch)
    if entry.family != "lm":
        raise SystemExit(f"{args.arch} is {entry.family}; this example serves the LM family")
    dev = resolve_device(args.device)
    cfg = entry.config() if args.size == "full" else entry.smoke_config()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = transformer.Transformer(cfg, device=dev, seed=0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    print(f"serving {cfg.name} ({args.size}, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e6:.1f}M params, {cfg.dtype}) on {dev}: batch "
          f"{args.batch}, prompt {args.prompt_len}, gen {args.gen}")
    res = serve(cfg, model.params(), prompts, args.gen)
    tol = TOL[cfg.dtype]
    checked = not cfg.moe
    print(f"prefill: {res['prefill_s'] * 1e3:.2f} ms, {res['prefill_tok_s']:.1f} tokens/s; "
          f"decode: {res['decode_ms_step']:.3f} ms a step, {res['decode_tok_s']:.1f} tokens/s; "
          f"prefill against the cache path: {res['logits_err']:.3g} normwise "
          + (f"(tolerance {tol})" if checked else "(MoE capacity drops: not checked)"))
    print(f"first request's tokens: {res['tokens'][0].tolist()}")
    if not res["finite"] or (checked and res["logits_err"] > tol):
        raise RuntimeError(f"serve_lm: prefill and the cache path disagree by "
                           f"{res['logits_err']:.3g} (> {tol}) or a logit is not finite")
    return {**res, "cfg": cfg, "checked": checked}


if __name__ == "__main__":
    main()
