"""Checkpoint and restore in the JAX package's on-disk format.

One directory per step, as ``repro.train.checkpoint`` writes it:
  * ``manifest.json`` — ``step``, ``n_leaves``, the structure (``treedef``,
    for a reader; restore matches by the caller's ``like_tree``) and
    ``extra``;
  * ``arrays.npz``    — every leaf as ``leaf_{i}``, in ``jax.tree.flatten``
    order (:mod:`repro_torch.train.tree`), so either package restores the
    other's checkpoint.

Writes are atomic (a ``.tmp`` directory, then a rename), so a crash mid-write
never corrupts the latest checkpoint.  ``background=True`` copies every leaf
to the host before it returns, then writes on a thread (training goes on).
``restore`` places the leaves on one device, where JAX takes shardings.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.tree import describe, leaves, unflatten


def save(path: str, tree, step: int, extra: dict | None = None, background: bool = False):
    host_leaves = [t.detach().cpu().numpy() for t in leaves(tree)]  # device -> host NOW
    treedef = describe(tree)

    def _write():
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(
            os.path.join(tmp, "arrays.npz"),
            **{f"leaf_{i}": a for i, a in enumerate(host_leaves)},
        )
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": treedef,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def restore(path: str, like_tree, device="cuda"):
    """Load a checkpoint into the structure of ``like_tree``, each leaf with
    its ``like_tree`` leaf's dtype, on ``device``.  Returns (tree, step).
    Asking for CUDA on a host without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("restore on device 'cuda' needs an NVIDIA card; pass device='cpu'")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs = leaves(like_tree)
    if len(refs) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(refs)}")
    loaded = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} in the checkpoint, "
                                 f"expected {tuple(ref.shape)}")
            loaded.append(torch.from_numpy(arr).to(device=device, dtype=ref.dtype))
    return unflatten(like_tree, loaded), manifest["step"]


def latest_step_dir(root: str) -> str | None:
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_") and not d.endswith(".tmp")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))
