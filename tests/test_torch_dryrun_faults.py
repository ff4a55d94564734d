"""The sharded trace's layouts, held where torch versions and GSPMD differ.

* A layout probe: during the edge-split NequIP and Equiformer traces every
  DTensor an op takes or makes holds the local block its placements give
  (``compute_local_shape_and_global_offset``).  Torch versions differ in
  some of DTensor's rules (one shifts a split dim past a new last dim of
  ``stack``), so the trace handles those ops itself (``stack`` and
  ``cat`` are held here too); the probe holds the invariant whose breach
  made such a trace fail, on any torch version.
* A chunked-attention arm: one attention layer, forward and backward, its
  input split over the sequence as the LM blocks' residual stream is, a
  few heads, the KV chunk smaller than the sequence.  Its collectives are
  held to JAX's ``collective_bytes`` of the same function on a (4, 2)
  ``("data", "model")`` mesh of 8 host devices (compiled in a subprocess):
  the backward keeps the forward's head split in the chunks' cotangents,
  as GSPMD does, where resharding them by all-to-all moved each chunk's
  scores.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.cells import CellSpec, _Draw
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention, sharding
from repro_torch.models.sharding import P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = Mesh(("data", "model"), (4, 2))
ATTN = dict(d_model=64, n_heads=4, n_kv=2, head_dim=16, chunk=8)
B, S = 8, 32  # the sequence in 4 chunks
LAYERS = 2  # the edge-split GNNs: the last layer's l > 0 outputs are dead code, which XLA drops
ROW, COL = P("model", "data"), P("data", "model")
ATTN_SPECS = (COL, COL, COL, ROW, P("data", "model", None), P("data", "model", None))


class _Probe(dryrun.Collectives):
    """``Collectives`` that also holds every DTensor an op takes or makes to
    the local block its placements give; the first few breaches are kept
    in ``found`` (op, global shape, placements, wanted, held)."""

    found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        if not any(issubclass(t, DTensor) for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, DTensor):
                with unset_fake_temporarily():
                    want = tuple(compute_local_shape_and_global_offset(
                        t.shape, t.device_mesh, t.placements)[0])
                if want != tuple(t._local_tensor.shape) and len(_Probe.found) < 8:
                    _Probe.found.append((str(func), tuple(t.shape), t.placements, want,
                                         tuple(t._local_tensor.shape)))
        return out


def _edge_split_cell(arch: str):
    import dataclasses

    from repro_torch.configs import cells, registry

    cfg = dataclasses.replace(registry.gnn_cell_config(arch, "ogb_products"), n_layers=LAYERS)
    return lambda: cells.gnn_train_cell(arch, cfg, MESH, n=2048, e=8192, d_feat=100,
                                        task="node_cls", n_classes=47, shard_edges=True,
                                        shape_name="ogb_products")


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_edge_split_layouts_hold_their_placements(arch, monkeypatch):
    """Every DTensor of the edge-split trace, forward and backward, holds
    the block its placements give (the probe sees each op DTensor
    dispatches; the ops the trace handles itself return such blocks)."""
    monkeypatch.setattr(dryrun, "Collectives", _Probe)
    monkeypatch.setattr(_Probe, "found", [])
    rec = dryrun.sharded_collectives(_edge_split_cell(arch), MESH)
    assert _Probe.found == []
    assert rec["counts"], rec


@pytest.mark.parametrize("join,dim", [(torch.stack, 0), (torch.stack, 1), (torch.stack, -1),
                                      (torch.cat, 0), (torch.cat, -1)])
def test_joins_keep_the_split_dim(join, dim):
    """``stack`` and ``cat`` of edge-split (64, 3) tensors and a plain one:
    the split stays on the edges' dim (shifted past a new dim before it)
    and the local block is the rank's rows joined; a ``cat`` along the
    split dim keeps the split too, as GSPMD partitions a concatenate (a
    (48, 3) block a rank), each tensor and the result moved by one
    all-to-all over the split's ranks; nothing else moves."""
    from repro_torch.launch.mesh import fake_process_mesh
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_mesh(MESH) as pm, sharding.sharded_trace(pm):
        with _Draw("cpu", True, 0):
            xs = [torch.zeros(64, 3) for _ in range(2)]
        ds = [sharding.distribute(x, P("data"), pm) for x in xs]
        with dryrun.Collectives() as counter:
            out = join([*ds, xs[0]], dim=dim)
        whole = join([*xs, xs[0]], dim=dim)
        assert tuple(out.shape) == tuple(whole.shape)
        rows = 0 if join is torch.cat or dim % 3 > 0 else 1
        assert list(out.placements) == [Shard(rows), Replicate()]
        local = list(whole.shape)
        local[rows] //= 4
        assert tuple(out.to_local().shape) == tuple(local)
        along = join is torch.cat and dim == 0
        assert counter.record()["counts"] == ({"all-to-all": 4} if along else {})


def _dead_branch_counts(dead: bool, remat, backward: bool = True) -> dict:
    """The collectives of a loss ``relu(x @ w).sum()`` on a (4, 2) mesh, x
    split over both axes and the weights whole (the forward gathers x's
    columns), and of its gradients; with ``dead``, also ``(x * 2) @ w2``,
    which nothing reads.  ``remat`` "lazy": rematerialized, its forward
    reading x's shape first as a first call's lazy set-up does, which the
    recomputation does not."""
    from repro_torch.launch.mesh import fake_process_mesh
    from repro_torch.models import layers

    calls = []

    def f(x, w, w2):
        if remat == "lazy" and not calls:
            for _ in range(16):
                x.shape
        calls.append(x)
        if dead:
            (x * 2) @ w2
        return torch.relu(x @ w).sum()

    with fake_process_mesh(MESH) as pm, sharding.sharded_trace(pm):
        with _Draw("cpu", True, 0):
            x, w, w2 = torch.zeros(16, 8), torch.zeros(8, 4), torch.zeros(8, 4)
        with x.fake_mode, dryrun.Collectives() as counter:
            args = [sharding.distribute(t, s, pm).requires_grad_() for t, s in
                    ((x, P("data", "model")), (w, P(None, None)), (w2, P(None, None)))]
            loss = layers.remat(f, bool(remat))(*args)
            if backward:
                torch.autograd.grad(loss, args, allow_unused=True, materialize_grads=True)
        return counter.record()


@pytest.mark.parametrize("remat", [False, True, "lazy"], ids=["plain", "remat", "lazy"])
def test_dead_code_issues_no_collectives(remat):
    """XLA's dead-code elimination in the count: a product that nothing
    reads issues no collective, in the forward or (rematerialized) in its
    recomputation, so the step counts as it does without it, also where
    the recomputation makes fewer calls than its forward (torch versions
    differ in such reads); a forward that runs no backward pass counts it
    (its gather of x's columns)."""
    assert _dead_branch_counts(True, remat) == _dead_branch_counts(False, remat)
    fwd = [_dead_branch_counts(dead, remat, backward=False) for dead in (True, False)]
    assert fwd[0]["counts"] == {"all-gather": 2} and fwd[1]["counts"] == {"all-gather": 1}, fwd


# ------------------------------------------------- the chunked attention arm

_JAX = f"""
ATTN, B, S = {ATTN!r}, {B!r}, {S!r}
""" + r"""
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.launch.dryrun import collective_bytes
from repro.launch.mesh import make_local_mesh
from repro.models import attention
from repro.models.sharding import constrain

mesh = make_local_mesh(8, model=2)
cfg = attention.AttnConfig(**ATTN)
d, hq, hkv = ATTN["d_model"], ATTN["n_heads"] * ATTN["head_dim"], ATTN["n_kv"] * ATTN["head_dim"]
col, row, seq = P("data", "model"), P("model", "data"), P("data", "model", None)


def fn(wq, wk, wv, wo, x, y):
    def loss(ws, x):
        p = {n: {"w": w} for n, w in zip("qkvo", ws)}
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        out, _ = attention.forward(p, cfg, constrain(x, P("data", None, None)), pos)
        return jnp.sum(constrain(out, seq) * y)

    return jax.grad(loss, argnums=(0, 1))((wq, wk, wv, wo), x)


def sds(shape, spec):
    return jax.ShapeDtypeStruct(shape, jnp.float32, sharding=NamedSharding(mesh, spec))


args = [sds((d, hq), col), sds((d, hkv), col), sds((d, hkv), col), sds((hq, d), row),
        sds((B, S, d), seq), sds((B, S, d), seq)]
with set_mesh(mesh):
    txt = jax.jit(fn).lower(*args).compile().as_text()
json.dump(collective_bytes(txt), open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_attention(tmp_path_factory):
    path = tmp_path_factory.mktemp("attn") / "jax.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX, str(path)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _attention_arm():
    cfg = attention.AttnConfig(**ATTN)
    d, hq, hkv = ATTN["d_model"], ATTN["n_heads"] * ATTN["head_dim"], (
        ATTN["n_kv"] * ATTN["head_dim"])

    def fn(wq, wk, wv, wo, x, y):
        xs = [t.detach().requires_grad_() for t in (wq, wk, wv, wo, x)]
        with torch.enable_grad():
            p = {n: {"w": w} for n, w in zip("qkvo", xs)}
            pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
            out, _ = attention.forward(p, cfg, sharding.constrain(xs[4], P("data", None, None)),
                                       pos)
            loss = torch.sum(sharding.constrain(out, P("data", "model", None)) * y)
            return torch.autograd.grad(loss, xs)

    def build():
        with _Draw("cpu", True, 0):
            args = tuple(torch.zeros(s) for s in [(d, hq), (d, hkv), (d, hkv), (hq, d),
                                                  (B, S, d), (B, S, d)])
        return CellSpec(name="attention", kind="arm", fn=fn, args=args, specs=ATTN_SPECS)

    return build


def test_chunked_attention_backward_collectives_near_jax(jax_attention):
    """The port's count of the arm against JAX's: all-to-all at most 1.25x
    of JAX's bytes, the total within 0.8-1.25.  JAX counts its chunk loop's
    body once (a ``lax.scan``) where the port's loop is unrolled, so
    whatever the backward moves inside the loop would count once a chunk
    here: the cotangents keep the forward's head split through the loop
    (the scan's carry, ``sharding.carry``) and are resharded once, where
    the backward loop starts."""
    rec = dryrun.sharded_collectives(_attention_arm(), MESH)
    assert rec.pop("replicated_for") == {}
    want = jax_attention
    print("\nchunked attention, forward+backward, (4, 2), a device")
    for kind in sorted(set(rec["bytes_by_kind"]) | set(want["bytes_by_kind"])):
        print(f"  {kind:18s} JAX {want['bytes_by_kind'].get(kind, 0):>10,d} "
              f"({want['counts'].get(kind, 0)})  port {rec['bytes_by_kind'].get(kind, 0):>10,d} "
              f"({rec['counts'].get(kind, 0)})")
    total = rec["total_bytes"] / want["total_bytes"]
    print(f"  port / JAX: total {total:.3f}")
    assert rec["bytes_by_kind"].get("all-to-all", 0) <= 1.25 * want["bytes_by_kind"].get(
        "all-to-all", 0)
    assert 0.8 <= total <= 1.25, total
