"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential via Clebsch-Gordan tensor products.

The counterpart of ``repro.models.gnn.nequip``.  Assigned config: 5
interaction layers, 32 channels, l_max=2, 8 Bessel RBFs, cutoff 5 Å.  Node
features are a dict of irreps ``l -> (N, C, 2l+1)``.  Each interaction:
message = sum over CG paths (l_in (x) l_sh -> l_out) of ``w_path(r_ij) *
W[l_in, l_sh, l_out] f_src Y(r_hat)``, aggregated with a segment sum,
followed by per-l self-interaction linear layers and a gated nonlinearity
(scalars gate the l>0 irreps).

JAX contracts a path with one three-operand ``einsum("eca,eb,abd->ecd")``,
whose pairing XLA picks; here the order is explicit, ``Y`` into the CG
table first and then a batched product with the source features, equal to
JAX's to fp32 rounding.  With ``cfg.remat`` each layer is rematerialized;
its dict of irreps crosses the checkpoint as a tuple ordered by ``l``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.gnn import common, so3


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16           # raw node feature width (species embedding etc.)
    task: str = "graph_reg"  # graph_reg | node_cls
    n_classes: int = 0
    remat: bool = True
    channel_shard: bool = False
    dtype: Any = torch.float32

    @property
    def paths(self):
        out = []
        for l1 in range(self.l_max + 1):
            for l2 in range(self.l_max + 1):
                for l3 in range(self.l_max + 1):
                    if abs(l1 - l2) <= l3 <= l1 + l2:
                        out.append((l1, l2, l3))
        return out


def init(gen: torch.Generator, cfg: NequIPConfig, device="cuda") -> dict:
    C = cfg.channels
    ps: dict = {"embed": layers.dense_init(gen, cfg.d_in, C, cfg.dtype, device=device)}
    for i in range(cfg.n_layers):
        blk: dict = {}
        for (l1, l2, l3) in cfg.paths:
            # radial MLP: rbf -> C path weights (per channel)
            blk[f"radial_{l1}_{l2}_{l3}"] = layers.mlp_init(
                gen, (cfg.n_rbf, 16, C), cfg.dtype, device=device)
        for l in range(cfg.l_max + 1):
            blk[f"self_{l}"] = layers.dense_init(gen, C, C, cfg.dtype, device=device)
            blk[f"out_{l}"] = layers.dense_init(gen, C, C, cfg.dtype, device=device)
        blk["gate"] = layers.dense_init(gen, C, C * cfg.l_max, cfg.dtype, device=device)
        ps[f"layer{i}"] = blk
    out_dim = cfg.n_classes if cfg.task == "node_cls" else 1
    ps["readout"] = layers.mlp_init(gen, (C, 16, out_dim), cfg.dtype, device=device)
    return ps


def _apply_lin(p, feat):
    """Per-l linear over the channel axis: (N, C, M) -> (N, C', M)."""
    return torch.einsum("ncm,cd->ndm", feat, p["w"])


def forward(params, cfg: NequIPConfig, batch: common.GraphBatch, n_graphs: int = 1):
    C = cfg.channels
    n = batch.n_nodes
    dev = batch.node_feat.device
    # initial irreps: scalars from node features; higher l start at zero
    feats = [layers.dense(params["embed"], batch.node_feat.to(cfg.dtype))[..., None]]
    for l in range(1, cfg.l_max + 1):
        feats.append(torch.zeros((n, C, 2 * l + 1), dtype=cfg.dtype, device=dev))

    _, dist, unit = common.edge_vectors(batch)
    sh = so3.sph_harm(cfg.l_max, unit).to(cfg.dtype)  # (E, (L+1)^2)
    rbf = common.bessel_rbf(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    cgs = {path: torch.as_tensor(so3.real_cg(*path), dtype=cfg.dtype, device=dev)
           for path in cfg.paths}

    def layer(p, *feats):
        msgs: list = [None] * (cfg.l_max + 1)
        src = [common.gather_src(f, batch) for f in feats]
        for (l1, l2, l3) in cfg.paths:
            w = layers.mlp(p[f"radial_{l1}_{l2}_{l3}"], rbf)       # (E, C)
            y = sh[:, l2 * l2:(l2 + 1) * (l2 + 1)]                  # (E, m2)
            yc = torch.einsum("eb,abd->ead", y, cgs[(l1, l2, l3)])  # (E, m1, m3)
            m = torch.bmm(src[l1], yc)                              # (E, C, m3)
            if cfg.channel_shard:
                m = common.shard_channels(m)
            m = m * w[..., None]
            msgs[l3] = m if msgs[l3] is None else msgs[l3] + m
        agg = [common.scatter_sum(m, batch) for m in msgs]
        new = [_apply_lin(p[f"self_{l}"], feats[l]) + _apply_lin(p[f"out_{l}"], agg[l])
               for l in range(cfg.l_max + 1)]
        if cfg.channel_shard:
            new = [common.shard_channels(f) for f in new]
        # gated nonlinearity: scalars -> silu; l>0 scaled by sigmoid gates
        scal = new[0][..., 0]
        gates = torch.sigmoid(layers.dense(p["gate"], scal))       # (N, C*l_max)
        out = [F.silu(scal)[..., None]]
        for l in range(1, cfg.l_max + 1):
            g = gates[:, (l - 1) * C: l * C]
            out.append(new[l] * g[..., None])
        if cfg.channel_shard:
            out = [common.shard_channels(f) for f in out]
        return tuple(out)

    layer = layers.remat(layer, cfg.remat)
    for i in range(cfg.n_layers):
        feats = layer(params[f"layer{i}"], *feats)
    out = layers.mlp(params["readout"], feats[0][..., 0])
    if cfg.task == "node_cls":
        return out  # (N, n_classes) invariant node logits
    return common.graph_readout(out[:, 0], batch, n_graphs)


def loss_fn(params, cfg: NequIPConfig, batch, n_graphs: int = 1):
    out = forward(params, cfg, batch, n_graphs)
    if cfg.task == "node_cls":
        return common.node_ce_loss(out, batch)
    return common.graph_mse_loss(out, batch)
