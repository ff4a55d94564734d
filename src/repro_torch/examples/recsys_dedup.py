"""The paper's technique beyond RDF: PTT-style dedup-gather on the Wide &
Deep embedding path, trained.

The port of ``examples/recsys_dedup.py``: trains the smoke Wide & Deep
model on a synthetic CTR stream whose ids are heavy-tailed (Zipf, as recsys
ids are), with and without ``dedup_gather``, and shows (a) the losses of
both runs, (b) the |N| -> |S| reduction in rows fetched that the PTT idea
buys.  The numpy stream is drawn in the JAX example's order (the dedup run
continues the generator after the plain run), so the id-stream numbers
equal the JAX example's; the weights are the port's, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.examples.recsys_dedup [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import cells, wide_deep
from repro_torch.core.dedup_gather import dedup_gather
from repro_torch.core.executor import resolve_device
from repro_torch.models.recsys import WideDeep
from repro_torch.train.optimizer import AdamW

B, POOL, STEPS = 256, 512, 60


def id_stream(cfg, rng: np.random.Generator):
    """The example's pool: Zipf(1.3) ids (POOL, F, 1), dense features,
    labels ``dense @ w_true + 0.3 * noise > 0``, and the first batch's flat
    global ids, drawn in the JAX example's order."""
    zipf = np.minimum(rng.zipf(1.3, size=(POOL, cfg.n_sparse, 1)), cfg.vocab_per_field) - 1
    dense = rng.normal(size=(POOL, cfg.n_dense)).astype(np.float32)
    w_true = rng.normal(size=cfg.n_dense).astype(np.float32)
    labels = (dense @ w_true + 0.3 * rng.normal(size=POOL) > 0).astype(np.int32)
    flat_ids = (zipf[:B] + (np.arange(cfg.n_sparse)[None, :, None] * cfg.vocab_per_field)
                ).reshape(-1)
    return zipf, dense, labels, flat_ids


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.recsys_dedup")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (no fallback)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = wide_deep.smoke_config()
    rng = np.random.default_rng(0)
    zipf, dense, labels, flat_ids = id_stream(cfg, rng)
    n_unique = len(np.unique(flat_ids))
    print(f"id stream: {len(flat_ids)} lookups, {n_unique} distinct "
          f"(|N|/|S| = {len(flat_ids)/n_unique:.1f}x duplicate factor)")

    cap = int(n_unique * 1.5)
    cfg_dedup = dataclasses.replace(cfg, dedup_cap=cap)
    pool = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (zipf.astype(np.int32), dense, labels)]
    out = {"lookups": len(flat_ids), "n_unique": n_unique, "cap": cap, "losses": {}}
    for name, c in (("plain", cfg), ("dedup-gather", cfg_dedup)):
        model = WideDeep(c, device=dev, seed=0)
        step, opt, params = cells.recsys_train_step(c, model, AdamW(lr=1e-2))
        state = opt.init(params)
        losses = []
        for _ in range(STEPS):
            idx = torch.from_numpy(rng.integers(0, POOL, size=B)).to(dev)
            params, state, m = step(params, state, *(a[idx] for a in pool))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        out["losses"][name] = losses
        print(f"  {name:14s}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # traffic accounting (what a row-sharded table would move across chips)
    table = torch.zeros((cfg.n_sparse * cfg.vocab_per_field, cfg.embed_dim), device=dev)
    res = dedup_gather(table, torch.from_numpy(flat_ids.astype(np.int32)).to(dev), cap)
    out.update(rows_fetched_plain=len(flat_ids), rows_fetched_dedup=cap,
               true_unique=int(res.n_unique))
    print(f"\nrows fetched: plain={len(flat_ids)}  dedup={cap} "
          f"(true unique {int(res.n_unique)}) -> "
          f"{len(flat_ids)/cap:.1f}x less gather/collective traffic")
    return out


if __name__ == "__main__":
    main()
