"""GAT (Velickovic et al., arXiv:1710.10903): attention aggregator GNN.

The counterpart of ``repro.models.gnn.gat``.  Assigned config (gat-cora):
2 layers, 8 hidden units, 8 heads, ELU, attention-softmax aggregation over
incoming edges (SDDMM -> segment-softmax -> SpMM, as gather + segment
ops).  ``forward`` takes no ``n_graphs`` and ``loss_fn`` does, as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    task: str = "node_cls"  # node_cls | graph_reg
    channel_shard: bool = False
    dtype: Any = torch.float32

    @property
    def out_dim(self) -> int:
        return self.n_classes if self.task == "node_cls" else 1


def init(gen: torch.Generator, cfg: GATConfig, device="cuda") -> dict:
    """JAX's params tree.  JAX draws ``attn_src`` and ``attn_dst`` from one
    key, so they start equal; so do the port's."""
    ps = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.out_dim if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        attn = torch.empty((heads, d_out), dtype=cfg.dtype, device=device).normal_(
            generator=gen).mul_(0.1)
        ps[f"layer{i}"] = {
            "proj": layers.dense_init(gen, d_in, heads * d_out, cfg.dtype, device=device),
            "attn_src": attn,
            "attn_dst": attn.clone(),
        }
        d_in = d_out * heads if not last else d_out
    return ps


def forward(params, cfg: GATConfig, batch: common.GraphBatch):
    x = batch.node_feat.to(cfg.dtype)
    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        last = i == cfg.n_layers - 1
        d_out = cfg.out_dim if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        h = layers.dense(p["proj"], x).reshape(-1, heads, d_out)
        a_src = torch.sum(h * p["attn_src"], dim=-1)  # (N, H)
        a_dst = torch.sum(h * p["attn_dst"], dim=-1)
        e = F.leaky_relu(
            common.gather_src(a_src, batch) + common.gather_dst(a_dst, batch), 0.2)
        alpha = common.edge_softmax(e, batch)         # (E, H)
        msgs = common.gather_src(h, batch) * alpha[..., None]
        agg = common.scatter_sum(msgs, batch)         # (N, H, d_out)
        x = agg.reshape(-1, heads * d_out)
        if not last:
            x = F.elu(x)
            if cfg.channel_shard and (heads * d_out) % 16 == 0:
                x = common.shard_channels(x)
    return x  # (N, n_classes) for last layer with 1 head


def loss_fn(params, cfg: GATConfig, batch: common.GraphBatch, n_graphs: int = 1):
    out = forward(params, cfg, batch)
    if cfg.task == "node_cls":
        return common.node_ce_loss(out, batch)
    pred = common.graph_readout(out[:, 0], batch, n_graphs)
    return common.graph_mse_loss(pred, batch)
