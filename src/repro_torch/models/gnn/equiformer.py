"""EquiformerV2 (Liao et al., arXiv:2306.12059): equivariant graph attention
with eSCN-style SO(2) convolutions.

The counterpart of ``repro.models.gnn.equiformer``.  The eSCN insight (the
paper's O(L^6) -> O(L^3) reduction): rotate each edge's source features
into a frame where the edge direction is z-hat; in that frame the SH of
the edge direction is nonzero only at m=0, so the full SO(3) tensor
product collapses to independent per-m SO(2) convolutions, truncated at
``m_max`` (assigned: l_max=6, m_max=2).  Attention weights come from the
invariant (m=0) channel; messages are rotated back and aggregated.

JAX stores features as (N, C, (l_max+1)^2); here they are (N, (l_max+1)^2,
C), so that each irrep index is a contiguous row of C channels: the
per-l rotations are batched products over whole rows, the per-l linears
plain matrix products, and JAX's scatters into zeros (``.at[:, :,
idx].set``) one concatenation of rows in irrep order, zero rows for m >
m_max, which autograd sees.  The SO(2) convolutions flatten each m-block
as JAX does, (C, l)-ordered, so the weights are JAX's.  The arithmetic is
JAX's operation by operation; only the memory layout differs.  The Wigner
rotations use ``so3.wigner_d_from_rot``.  With ``cfg.remat`` each layer is
rematerialized.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.gnn import common, so3


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16
    task: str = "graph_reg"  # graph_reg | node_cls
    n_classes: int = 0
    channel_shard: bool = False  # constrain channels over the model axis
    remat: bool = True
    dtype: Any = torch.float32

    @property
    def n_sph(self) -> int:
        return (self.l_max + 1) ** 2


def _m_blocks(cfg: EquiformerConfig):
    """eSCN m-blocks: for each m in 0..m_max the list of flattened irrep
    indices (+m and -m components per l >= m)."""
    blocks = []
    for m in range(cfg.m_max + 1):
        plus = [l * l + l + m for l in range(max(m, 0), cfg.l_max + 1) if l >= m]
        minus = [l * l + l - m for l in range(max(m, 1), cfg.l_max + 1) if l >= m]
        blocks.append((np.array(plus), np.array(minus)))
    return blocks


@layers.constant_cache
def _blocks(l_max: int, m_max: int, device: torch.device):
    """``_m_blocks`` as index tensors on ``device``, and for each irrep
    index where the SO(2) conv's output row comes from: (m, sign, j), the
    j-th row of block m's +m (sign 0) or -m (sign 1) piece, or None (m >
    m_max: zero)."""
    cfg = EquiformerConfig(l_max=l_max, m_max=m_max)
    blocks, source = [], [None] * cfg.n_sph
    for m, (plus, minus) in enumerate(_m_blocks(cfg)):
        blocks.append((torch.as_tensor(plus, device=device),
                       torch.as_tensor(minus, device=device)))
        for j, i in enumerate(plus):
            source[i] = (m, 0, j)
        if m > 0:
            for j, i in enumerate(minus):
                source[i] = (m, 1, j)
    return blocks, source


def init(gen: torch.Generator, cfg: EquiformerConfig, device="cuda") -> dict:
    C, H = cfg.channels, cfg.n_heads
    blocks = _m_blocks(cfg)
    dt = cfg.dtype
    ps: dict = {"embed": layers.dense_init(gen, cfg.d_in, C, dt, device=device)}
    for i in range(cfg.n_layers):
        blk: dict = {}
        for m, (plus, minus) in enumerate(blocks):
            nl = len(plus)  # number of l's participating at this m
            # SO(2) conv: mixes channels x l at fixed m; two weight mats for
            # the (+m, -m) rotation-pair structure
            blk[f"so2_{m}_r"] = layers.dense_init(gen, C * nl, C * nl, dt, device=device)
            if m > 0:
                blk[f"so2_{m}_i"] = layers.dense_init(gen, C * nl, C * nl, dt, device=device)
        blk["radial"] = layers.mlp_init(gen, (cfg.n_rbf, C, C), dt, device=device)
        blk["attn"] = layers.mlp_init(gen, (2 * C, C, H), dt, device=device)
        blk["val_head"] = layers.dense_init(gen, C, C, dt, device=device)
        blk["out"] = layers.dense_init(gen, C, C, dt, device=device)
        blk["ffn"] = {
            "lin1": layers.dense_init(gen, C, 2 * C, dt, device=device),
            "lin2": layers.dense_init(gen, 2 * C, C, dt, device=device),
        }
        ps[f"layer{i}"] = blk
    out_dim = cfg.n_classes if cfg.task == "node_cls" else 1
    ps["readout"] = layers.mlp_init(gen, (C, C, out_dim), dt, device=device)
    return ps


def _so2_conv(p, cfg, x_rot):
    """x_rot: (E, n_sph, C) in the edge-aligned frame.  Per-m SO(2) conv:
    (y_+m + i y_-m) = W (x_+m + i x_-m) with W complex -> two real mats,
    over JAX's (C, l)-ordered flattening of each m-block."""
    E = x_rot.shape[0]
    C = cfg.channels
    blocks, source = _blocks(cfg.l_max, cfg.m_max, x_rot.device)

    def flat(idx):  # rows idx of (E, n_sph, C) -> (E, C * nl), c-major as JAX's
        return x_rot.index_select(1, idx).transpose(1, 2).reshape(E, C * len(idx))

    def rows(y, nl):  # (E, C * nl) -> (E, nl, C)
        return y.reshape(E, C, nl).transpose(1, 2)

    pieces = []
    for m, (plus, minus) in enumerate(blocks):
        nl = len(plus)
        xp = flat(plus)
        if m == 0:
            pieces.append((rows(layers.dense(p["so2_0_r"], xp), nl),))
        else:
            xm = flat(minus)
            wr, wi = p[f"so2_{m}_r"], p[f"so2_{m}_i"]
            yp = layers.dense(wr, xp) - layers.dense(wi, xm)
            ym = layers.dense(wi, xp) + layers.dense(wr, xm)
            pieces.append((rows(yp, nl), rows(ym, nl)))
    # each irrep row from its piece; m > m_max rows are zero (eSCN truncation)
    zero = x_rot.new_zeros((E, 1, C))
    return torch.cat([zero if src is None else pieces[src[0]][src[1]][:, src[2]:src[2] + 1]
                      for src in source], dim=1)


def _rotate(feats, Ds, inverse: bool):
    """Apply block-diagonal Wigner rotation to (E, n_sph, C): JAX's
    ``eab,ecb->eca`` (inverse) is ``D @ rows``, ``eba,ecb->eca`` ``D^T @
    rows``, over each l's rows."""
    outs = []
    for l, D in enumerate(Ds):
        sl = feats[:, l * l:(l + 1) * (l + 1)]
        outs.append(torch.bmm(D if inverse else D.transpose(1, 2), sl))
    return torch.cat(outs, dim=1)


def forward(params, cfg: EquiformerConfig, batch: common.GraphBatch, n_graphs: int = 1):
    C, H = cfg.channels, cfg.n_heads
    n = batch.n_nodes
    emb = layers.dense(params["embed"], batch.node_feat.to(cfg.dtype))
    x = torch.cat([emb[:, None, :], emb.new_zeros((n, cfg.n_sph - 1, C))], dim=1)

    _, dist, unit = common.edge_vectors(batch)
    rbf = common.bessel_rbf(dist, cfg.n_rbf, cfg.cutoff).to(cfg.dtype)
    R = so3.rot_to_align_z(unit.to(torch.float32))
    Ds = [d.to(cfg.dtype) for d in so3.wigner_d_from_rot(cfg.l_max, R)]

    def layer(p, x):
        src = common.gather_src(x, batch)             # (E, n_sph, C)
        rot = _rotate(src, Ds, inverse=False)         # edge frame
        conv = _so2_conv(p, cfg, rot)
        radial = layers.mlp(p["radial"], rbf)         # (E, C)
        conv = conv * radial[:, None, :]

        # attention from invariants (m=0 of conv + dst scalars)
        inv = conv[:, 0, :]                           # (E, C)
        dst_scal = common.gather_dst(x[:, 0, :], batch)
        logits = layers.mlp(p["attn"], torch.cat([inv, dst_scal], -1))
        alpha = common.edge_softmax(logits, batch)    # (E, H)
        # head-structured value weighting
        vals = layers.dense(p["val_head"], conv)      # (E, n_sph, C)
        vals = vals.reshape(vals.shape[0], cfg.n_sph, H, C // H)
        vals = vals * alpha[:, None, :, None].to(vals.dtype)
        msg = vals.reshape(vals.shape[0], cfg.n_sph, C)
        msg = _rotate(msg, Ds, inverse=True)          # back to global frame
        agg = common.scatter_sum(msg, batch)
        x = x + agg @ p["out"]["w"]

        # equivariant FFN: per-l linear with scalar-gated nonlinearity
        h = x @ p["ffn"]["lin1"]["w"]
        gate = F.silu(h[:, 0, :])[:, None, :]
        h = h * gate
        return x + h @ p["ffn"]["lin2"]["w"]

    layer = layers.remat(layer, cfg.remat)
    for i in range(cfg.n_layers):
        x = layer(params[f"layer{i}"], x)

    out = layers.mlp(params["readout"], x[:, 0, :])
    if cfg.task == "node_cls":
        return out
    return common.graph_readout(out[:, 0], batch, n_graphs)


def loss_fn(params, cfg: EquiformerConfig, batch, n_graphs: int = 1):
    out = forward(params, cfg, batch, n_graphs)
    if cfg.task == "node_cls":
        return common.node_ce_loss(out, batch)
    return common.graph_mse_loss(out, batch)
