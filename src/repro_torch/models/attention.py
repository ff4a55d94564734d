"""Attention: GQA / MQA, RoPE, sliding windows, KV-cache decode.

The counterpart of ``repro.models.attention``, with JAX's arithmetic op by
op: scores as an ``einsum`` in the input dtype, then fp32 times the scale,
masked with ``-1e30``, softmax in fp32, cast back to the dtype of ``v``;
the KV-chunked path keeps the online-softmax recurrence over every chunk
(masked, none skipped).  ``F.scaled_dot_product_attention`` is not used:
its rounding and its fully masked rows differ from JAX's.

``long_500k`` decode relies on the sliding window: the KV cache is a ring
buffer of ``window`` slots, so cache memory is O(window), independent of the
logical position.

The decode cache is written in place (JAX's jitted step writes it in place
too); its edges are JAX's: a slot past the cache is clamped to the last
slot for ``k``/``v`` (``dynamic_update_slice``) and dropped for ``pos``
(``.at[].set``), and a negative slot counts from the end, as in both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.sharding import carry, scan

NEG = -1e30  # the masked score


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    window: int | None = None  # sliding-window size; None -> full causal
    # KV-chunked online-softmax attention (flash-style): never materializes
    # the (S, T) score matrix.  None -> dense scores (fine for short seqs).
    chunk: int | None = None


def init(gen: torch.Generator, cfg: AttnConfig, dtype, device="cuda", lead: tuple = ()) -> dict:
    kw = dict(device=device, lead=lead)
    return {
        "q": layers.dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim, dtype, cfg.qkv_bias,
                               **kw),
        "k": layers.dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim, dtype, cfg.qkv_bias,
                               **kw),
        "v": layers.dense_init(gen, cfg.d_model, cfg.n_kv * cfg.head_dim, dtype, cfg.qkv_bias,
                               **kw),
        "o": layers.dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model, dtype, False, **kw),
    }


def rope_freq(d: int, theta: float) -> np.ndarray:
    """JAX's frequency table: computed in float64 (``np.arange`` is), then
    cast to float32 as JAX casts a float64 array when it multiplies."""
    half = d // 2
    return (1.0 / (theta ** (np.arange(0, half) * 2.0 / d))).astype(np.float32)


@layers.constant_cache
def _freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    # one copy to the device per table, not one per call
    return torch.from_numpy(rope_freq(d, theta)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].to(torch.float32) * _freq(x.shape[-1], theta, x.device)
    ang = ang[..., None, :]  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, d)


def _sdpa(q, k, v, mask, scale):
    """q (B,S,Hq,D), k/v (B,T,Hkv,D) with GQA head grouping."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", q, k).to(torch.float32) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


def _chunked_sdpa(q, k, v, pos_q, pos_k, window, scale, chunk):
    """Flash-style attention: a loop over KV chunks with the online-softmax
    (running max / denominator / accumulator) recurrence.  Peak memory is
    O(S * chunk) per head group instead of O(S * T)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q5 = q.reshape(b, s, hkv, g, d)

    pad = (-k.shape[1]) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=-1)

    m = torch.full((b, hkv, g, s), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), dtype=torch.float32, device=q.device)
    for c0 in scan(range(0, k.shape[1], chunk)):  # JAX's lax.scan over the chunks
        kc, vc, pc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], pos_k[:, c0:c0 + chunk]
        logits = torch.einsum("bshgd,bchd->bhgsc", q5, kc).to(torch.float32) * scale
        valid = (pc[:, None, :] >= 0) & (pc[:, None, :] <= pos_q[:, :, None])
        if window is not None:
            valid &= pc[:, None, :] > pos_q[:, :, None] - window
        valid = valid[:, None, None, :, :]  # (b,1,1,s,chunk)
        lmax = torch.amax(torch.where(valid, logits, NEG), dim=-1)
        new_m = torch.maximum(m, lmax)
        p = torch.where(valid, torch.exp(logits - new_m[..., None]), 0.0)
        alpha = torch.exp(m - new_m)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgsc,bchd->bhgsd", p.to(vc.dtype), vc).to(torch.float32)
        m, l, acc = carry(new_m, l, acc)  # JAX's scan carry
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def forward(p, cfg: AttnConfig, x, positions):
    """Full (training / prefill) pass.  Returns (out, (k, v)) so callers can
    seed a decode cache from the prefill."""
    b, s, _ = x.shape
    q = _split_heads(layers.dense(p["q"], x), cfg.n_heads, cfg.head_dim)
    k = _split_heads(layers.dense(p["k"], x), cfg.n_kv, cfg.head_dim)
    v = _split_heads(layers.dense(p["v"], x), cfg.n_kv, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    scale = 1.0 / np.sqrt(cfg.head_dim)
    if cfg.chunk is not None and s > cfg.chunk:
        out = _chunked_sdpa(q, k, v, positions, positions, cfg.window, scale, cfg.chunk)
    else:
        ti = positions[:, :, None]  # queries
        tj = positions[:, None, :]  # keys
        mask = tj <= ti
        if cfg.window is not None:
            mask &= tj > ti - cfg.window
        out = _sdpa(q, k, v, mask, scale)
    out = layers.dense(p["o"], out.reshape(b, s, -1))
    return out, (k, v)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, n_kv, D); T = max_len (full) or window (SWA)
    v: torch.Tensor
    # positions currently stored in each slot, -1 = empty: (B, T)
    pos: torch.Tensor


def write_cache(cache: KVCache, k, v, slot, posb) -> None:
    """Write each row's new ``k``/``v`` (B, 1, n_kv, D) and position into its
    slot, in place, with JAX's edges: a negative slot counts from the end;
    ``k``/``v`` then clamp the slot into [0, T-1], ``pos`` skips a slot
    outside it (the write lands where a row's slot mask holds, and no old
    position is read back).  No host sync."""
    t = cache.k.shape[1]
    slot = torch.where(slot < 0, slot + t, slot)
    rows = torch.arange(slot.shape[0], device=slot.device)
    kv_slot = torch.clamp(slot, 0, t - 1).to(torch.int64)
    cache.k[rows, kv_slot] = k[:, 0]
    cache.v[rows, kv_slot] = v[:, 0]
    hit = torch.arange(t, device=slot.device)[None, :] == slot[:, None]  # none outside [0, T)
    cache.pos.copy_(torch.where(hit, posb.to(cache.pos.dtype)[:, None], cache.pos))


def decode_step(p, cfg: AttnConfig, cache: KVCache, x, position):
    """One-token decode.  x: (B, 1, d_model); position: a 0-d or (B,) int
    tensor (the logical index of the new token).  The cache slot is
    ``position`` for full attention and ``position % window`` for
    sliding-window (ring buffer).  Returns (out, cache): the cache is the
    one passed in, written in place."""
    b = x.shape[0]
    q = _split_heads(layers.dense(p["q"], x), cfg.n_heads, cfg.head_dim)
    k = _split_heads(layers.dense(p["k"], x), cfg.n_kv, cfg.head_dim)
    v = _split_heads(layers.dense(p["v"], x), cfg.n_kv, cfg.head_dim)
    posb = position.expand(b) if position.dim() == 0 else position
    q = rope(q, posb[:, None], cfg.rope_theta)
    k = rope(k, posb[:, None], cfg.rope_theta)

    slot = posb % cache.k.shape[1] if cfg.window is not None else posb
    write_cache(cache, k, v, slot, posb)

    # attend over every filled slot that is causally visible
    cpos = cache.pos
    visible = (cpos >= 0) & (cpos <= posb[:, None])
    if cfg.window is not None:
        visible &= cpos > (posb[:, None] - cfg.window)
    mask = visible[:, None, :]  # (B, 1, T)
    out = _sdpa(q, cache.k, cache.v, mask, 1.0 / np.sqrt(cfg.head_dim))
    out = layers.dense(p["o"], out.reshape(b, 1, -1))
    return out, cache
