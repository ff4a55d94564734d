"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode.

The counterpart of ``repro.models.gnn.meshgraphnet``.  Assigned config: 15
processor layers, d_hidden=128, 2-layer MLPs (LayerNorm-terminated), sum
aggregation, residual edge/node updates.  Edge inputs are (relative
position, distance) per the paper.  With ``cfg.remat`` each block is
rematerialized (``layers.remat``); its inputs, the node latent ``v`` and
the edge latent ``e``, are what a block keeps for the backward pass.
``channel_shard`` places JAX's channel constraints, which act only in a
sharded trace (``models.sharding``): on one device it changes nothing
(JAX's constrained variant computes the same MLP).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_in: int = 16
    remat: bool = True
    channel_shard: bool = False  # shard hidden channels over 'model'
    out_dim: int = 1          # per-graph regression target
    task: str = "graph_reg"   # graph_reg | node_cls
    n_classes: int = 0
    dtype: Any = torch.float32


def _mlp_ln_init(gen, d_in, d_hidden, d_out, n_layers, dtype, device):
    dims = (d_in,) + (d_hidden,) * (n_layers - 1) + (d_out,)
    return {"mlp": layers.mlp_init(gen, dims, dtype, device=device),
            "ln": layers.layernorm_init(d_out, dtype, device)}


def _mlp_ln(p, x, shard: bool = False):
    if not shard:
        return layers.layernorm(p["ln"], layers.mlp(p["mlp"], x))
    # the channel-sharded variant, as JAX writes it: a constraint after every
    # dense (each acts only in a sharded trace; the arithmetic is the MLP's)
    n = len(p["mlp"])
    for i in range(n):
        x = layers.dense(p["mlp"][f"fc{i}"], x)
        if i < n - 1:
            x = torch.relu(x)
        x = common.shard_channels(x)
    return common.shard_channels(layers.layernorm(p["ln"], x))


def init(gen: torch.Generator, cfg: MGNConfig, device="cuda") -> dict:
    d = cfg.d_hidden
    ps = {
        "node_enc": _mlp_ln_init(gen, cfg.d_in, d, d, cfg.mlp_layers, cfg.dtype, device),
        "edge_enc": _mlp_ln_init(gen, 4, d, d, cfg.mlp_layers, cfg.dtype, device),
    }
    for i in range(cfg.n_layers):
        ps[f"block{i}"] = {
            "edge": _mlp_ln_init(gen, 3 * d, d, d, cfg.mlp_layers, cfg.dtype, device),
            "node": _mlp_ln_init(gen, 2 * d, d, d, cfg.mlp_layers, cfg.dtype, device),
        }
    out_d = cfg.n_classes if cfg.task == "node_cls" else cfg.out_dim
    ps["decoder"] = {"mlp": layers.mlp_init(gen, (d, d, out_d), cfg.dtype, device=device)}
    return ps


def forward(params, cfg: MGNConfig, batch: common.GraphBatch, n_graphs: int = 1):
    vec, dist, _ = common.edge_vectors(batch)
    ef = torch.cat([vec, dist[:, None]], dim=-1).to(cfg.dtype)
    cs = cfg.channel_shard
    v = _mlp_ln(params["node_enc"], batch.node_feat.to(cfg.dtype), shard=cs)
    e = _mlp_ln(params["edge_enc"], ef, shard=cs)

    def block(p, v, e):
        e_in = torch.cat(
            [e, common.gather_src(v, batch), common.gather_dst(v, batch)], dim=-1)
        if cs:
            e_in = common.shard_channels(e_in)
        e = e + _mlp_ln(p["edge"], e_in, shard=cs)
        agg = common.scatter_sum(e, batch)
        v = v + _mlp_ln(p["node"], torch.cat([v, agg], dim=-1), shard=cs)
        if cs:
            v, e = common.shard_channels(v), common.shard_channels(e)
        return v, e

    block = layers.remat(block, cfg.remat)
    for i in range(cfg.n_layers):
        v, e = block(params[f"block{i}"], v, e)
    out = layers.mlp(params["decoder"]["mlp"], v)
    if cfg.task == "node_cls":
        return out  # (N, n_classes)
    return common.graph_readout(out[:, 0], batch, n_graphs)  # (G,)


def loss_fn(params, cfg: MGNConfig, batch: common.GraphBatch, n_graphs: int = 1):
    out = forward(params, cfg, batch, n_graphs)
    if cfg.task == "node_cls":
        return common.node_ce_loss(out, batch)
    return common.graph_mse_loss(out, batch)
