"""Transformer LM family: dense + MoE, GQA/MQA, SWA, GeGLU/SwiGLU, RoPE.

The counterpart of ``repro.models.transformer``: one parametric
implementation covers the five LM architectures of the registry.  Layers
are stacked as in JAX: every block leaf has a leading ``L`` axis
(``blocks.attn.q.w`` is ``(L, d, Hq*D)``, ``blocks.moe.up`` ``(L, E, d,
f)``), and the layers run in a Python loop over views of it, where JAX
scans.  ``params`` is JAX's nested dict of tensors; ``Transformer`` holds
it as an ``nn.Module`` whose parameter names are JAX's paths, so
``convert.state_from_params`` loads JAX's params unchanged and checkpoints
keep JAX's leaf order.

Arithmetic follows JAX op by op.  GeGLU is ``jax.nn.gelu``'s default, the
tanh form.  Tied embeddings scale by ``sqrt(d_model)`` rounded to
``cfg.dtype`` first (45.25 in bf16 for d = 2048), as
``jnp.asarray(np.sqrt(d), dtype)`` does.

``cfg.scan_layers=False`` (the dry-run's unrolled variant) keeps
``blocks`` as a list of per-layer dicts, as JAX's ``init`` builds it;
every model function runs the same operations over either layout, so the
two are bit-equal with the same weights.  ``param_specs``, ``cache_specs``
and ``batch_axes`` give JAX's partition specs (``models.sharding.P``) for
the dry-run's accounting; sequence parallelism and the int8 expert gathers
(``moe_quant_gather``) act only across cards, so their config fields are
kept and change nothing here (``constrain`` is the identity with no mesh).
``cfg.remat`` rematerializes each block where grad is enabled
(``layers.remat``, JAX's ``jax.checkpoint`` with ``nothing_saveable``):
only a block's input is kept for the backward pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import attention, layers, moe, vocab_parallel
from repro_torch.models.sharding import P


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # variants
    qkv_bias: bool = False
    gated_act: str = "silu"          # silu -> SwiGLU, gelu -> GeGLU
    window: int | None = None        # sliding-window attention (mixtral)
    tie_embeddings: bool = False     # gemma
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    # execution
    dtype: Any = torch.bfloat16
    remat: bool = True
    sequence_parallel: bool = True
    scan_layers: bool = True
    attn_chunk: int | None = 1024   # flash-style KV chunking (None = dense)
    microbatches: int = 1           # grad-accum splits / prefill waves
    moe_quant_gather: bool = False  # int8 FSDP gathers: JAX's sharded MoE only

    @property
    def attn(self) -> attention.AttnConfig:
        return attention.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv=self.n_kv,
            head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias,
            window=self.window,
            chunk=self.attn_chunk,
        )

    @property
    def moe_cfg(self) -> moe.MoEConfig:
        return moe.MoEConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            n_experts=self.n_experts,
            top_k=self.top_k,
        )

    def param_count(self) -> int:
        d, f, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = d * (self.n_heads + 2 * self.n_kv) * self.head_dim + (
            self.n_heads * self.head_dim
        ) * d
        if self.moe:
            ffn = 3 * d * f * self.n_experts + d * self.n_experts
        else:
            ffn = 3 * d * f
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + 2 * d) + emb + d

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k experts)."""
        if not self.moe:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * 3 * d * f * self.n_experts
        return dense + L * 3 * d * f * self.top_k


# ------------------------------------------------------------------ params


def _norm_init(cfg: LMConfig, device, lead=()):
    if cfg.norm == "rmsnorm":
        return layers.rmsnorm_init(cfg.d_model, cfg.dtype, device, lead)
    return layers.layernorm_init(cfg.d_model, cfg.dtype, device, lead)


def _norm(cfg: LMConfig, p, x):
    return layers.rmsnorm(p, x) if cfg.norm == "rmsnorm" else layers.layernorm(p, x)


def init_layers(gen: torch.Generator, cfg: LMConfig, device="cuda", lead=None) -> dict:
    """Every block's params, stacked on a leading ``L`` axis (one layer's
    with ``lead=()``)."""
    lead = (cfg.n_layers,) if lead is None else lead
    p = {
        "ln1": _norm_init(cfg, device, lead),
        "attn": attention.init(gen, cfg.attn, cfg.dtype, device, lead),
        "ln2": _norm_init(cfg, device, lead),
    }
    if cfg.moe:
        p["moe"] = moe.init(gen, cfg.moe_cfg, cfg.dtype, device, lead)
    else:
        p["ffn"] = layers.glu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, device, lead)
    return p


def init(gen: torch.Generator, cfg: LMConfig, device="cuda") -> dict:
    """JAX's params tree, drawn from ``gen`` on ``device``: ``blocks`` stacked,
    or with ``scan_layers=False`` a list of per-layer dicts."""
    if cfg.scan_layers:
        blocks = init_layers(gen, cfg, device)
    else:
        blocks = [init_layers(gen, cfg, device, lead=()) for _ in range(cfg.n_layers)]
    p = {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model, cfg.dtype, device),
        "blocks": blocks,
        "ln_f": _norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab, cfg.dtype, device=device)
    return p


def unstack(blocks, n: int) -> list:
    """Every layer's params: the list itself where the layers are unrolled,
    else views of the stacked leaves by one ``unbind`` a leaf: its backward
    stacks the layers' gradients once, where ``n`` separate views would
    each add a zero-padded (L, ...) gradient into the leaf's."""
    if isinstance(blocks, list):
        return blocks
    if isinstance(blocks, dict):
        per_key = {k: unstack(v, n) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(blocks.unbind(0))


class Transformer(layers.ParamTree):
    """An LM's params as parameters named by JAX's paths (``embed.table``,
    ``blocks.attn.q.w``, ...), drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed``.  The model functions of this module
    take ``model.params()``."""

    def __init__(self, cfg: LMConfig, device="cuda", seed: int = 0):
        gen = torch.Generator(device=device).manual_seed(seed)
        super().__init__(init(gen, cfg, device))
        self.cfg = cfg


# --------------------------------------------------------------- sharding


def param_specs(cfg: LMConfig, serve: bool = False):
    """JAX's partition-spec tree matching ``init``: layer leaves have a
    leading (whole) L axis when stacked, and ``blocks`` is a list of
    per-layer trees when unrolled.

    Training (default): Megatron TP on ``model`` plus FSDP over ``data`` on
    the other dim.  ``serve=True`` (dense archs): column/row-parallel over
    the flattened (``data``, ``model``) axis, weights resident, no
    optimizer state."""
    lead = (None,) if cfg.scan_layers else ()

    def lp(*spec):  # a layer param: the (whole) stacked axis first
        return P(*(lead + spec))

    norm_spec = {"scale": lp(None)} if cfg.norm == "rmsnorm" else {
        "scale": lp(None), "bias": lp(None)}
    final_norm = {"scale": P(None)} if cfg.norm == "rmsnorm" else {
        "scale": P(None), "bias": P(None)}
    if serve and not cfg.moe:
        flat = ("data", "model")
        col, row, bias, head = lp(None, flat), lp(flat, None), lp(flat), P(None, flat)
    else:
        col, row, bias = lp("data", "model"), lp("model", "data"), lp("model")
        head = P("data", "model")
    attn = {"q": {"w": col}, "k": {"w": col}, "v": {"w": col}, "o": {"w": row}}
    if cfg.qkv_bias:
        for n in ("q", "k", "v"):
            attn[n]["b"] = bias
    block = {"ln1": norm_spec, "attn": attn, "ln2": norm_spec}
    if cfg.moe:
        # TP inside each expert: up/gate column-parallel on d_ff, down
        # row-parallel, the d_model dim FSDP-sharded over data
        block["moe"] = {"router": {"w": lp(None, None)}, "up": lp(None, "data", "model"),
                        "gate": lp(None, "data", "model"), "down": lp(None, "model", "data")}
    else:
        block["ffn"] = {"up": {"w": col}, "gate": {"w": col}, "down": {"w": row}}
    specs = {
        "embed": {"table": P("model", "data")},  # vocab_parallel's storage layout
        "blocks": block if cfg.scan_layers else [block] * cfg.n_layers,
        "ln_f": final_norm,
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": head}
    return specs


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dim: ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def cache_specs(cfg: LMConfig, dp=("data",)) -> attention.KVCache:
    """JAX's layout of the decode cache: batch over ``dp``, the length over
    ``model`` (the split-KV decode layout; KV-head counts do not divide a
    16-way axis)."""
    return attention.KVCache(
        k=P(None, dp, "model", None, None),
        v=P(None, dp, "model", None, None),
        pos=P(None, dp, "model"),
    )


# ----------------------------------------------------------------- forward


def _ffn(cfg: LMConfig, p, h):
    """The block's FFN -> (out, aux): MoE, or the gated GLU (aux None)."""
    if cfg.moe:
        return moe.forward(p["moe"], cfg.moe_cfg, h)
    act = F.silu if cfg.gated_act == "silu" else _gelu_tanh
    return layers.glu(p["ffn"], h, act=act), None


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _block_forward(cfg: LMConfig, p, x, positions):
    h = _norm(cfg, p["ln1"], x)
    h, _ = attention.forward(p["attn"], cfg.attn, h, positions)
    x = x + h
    h, aux = _ffn(cfg, p, _norm(cfg, p["ln2"], x))
    return x + h, aux


def _embed(cfg: LMConfig, params, tokens):
    x = vocab_parallel.embed(params["embed"]["table"], tokens)
    if cfg.tie_embeddings:
        # the scale rounded to cfg.dtype, as jnp.asarray(np.sqrt(d), dtype)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype, device=x.device)
    return x


def forward(cfg: LMConfig, params, tokens):
    """tokens (B, S) -> final hidden states (B, S, d)."""
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    # the block's aux (an MoE's balance loss) is not part of the loss
    block = layers.remat(lambda p, x: _block_forward(cfg, p, x, positions)[0], cfg.remat)
    for lp in unstack(params["blocks"], cfg.n_layers):
        x = block(lp, x)
    return _norm(cfg, params["ln_f"], x)


def logits_fn(cfg: LMConfig, params, h):
    if cfg.tie_embeddings:
        return vocab_parallel.tied_logits(params["embed"]["table"], h)
    return layers.dense(params["lm_head"], h)


def loss_fn(cfg: LMConfig, params, tokens, labels):
    h = forward(cfg, params, tokens)
    return layers.cross_entropy_loss(logits_fn(cfg, params, h), labels)


# ------------------------------------------------------------------ decode


def make_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda") -> attention.KVCache:
    """Stacked per-layer KV cache, leading L axis.  SWA archs cap the length
    at the window (ring buffer): this makes long_500k decode O(window)."""
    length = min(max_len, cfg.window) if cfg.window is not None else max_len
    kv_shape = (cfg.n_layers, batch, length, cfg.n_kv, cfg.head_dim)
    return attention.KVCache(
        k=torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
        pos=torch.full((cfg.n_layers, batch, length), -1, dtype=torch.int32, device=device),
    )


def decode_step(cfg: LMConfig, params, cache: attention.KVCache, tokens, position):
    """One decode step.  tokens (B, 1); position a 0-d or (B,) int tensor.
    Returns (logits (B, 1, V), cache): the cache passed in, each layer's
    slice written in place."""
    x = _embed(cfg, params, tokens)
    for i, lp in enumerate(unstack(params["blocks"], cfg.n_layers)):
        lcache = attention.KVCache(cache.k[i], cache.v[i], cache.pos[i])
        h, _ = attention.decode_step(lp["attn"], cfg.attn, lcache, _norm(cfg, lp["ln1"], x),
                                     position)
        x = x + h
        h, _ = _ffn(cfg, lp, _norm(cfg, lp["ln2"], x))
        x = x + h
    h = _norm(cfg, params["ln_f"], x)
    return logits_fn(cfg, params, h), cache


def prefill(cfg: LMConfig, params, tokens):
    """Prefill pass: full forward, returns last-position logits (B, 1, V).

    ``microbatches > 1`` processes the request batch in waves (batch-chunked
    prefill): batch elements are independent, so results are exact and peak
    activation/MoE-dispatch memory drops by the factor."""
    b = tokens.shape[0]
    mb = cfg.microbatches
    if mb > 1 and b % mb == 0:
        waves = tokens.reshape(mb, b // mb, tokens.shape[1])
        outs = [logits_fn(cfg, params, forward(cfg, params, t)[:, -1:, :]) for t in waves]
        return torch.stack(outs).reshape(b, 1, -1)
    h = forward(cfg, params, tokens)
    return logits_fn(cfg, params, h[:, -1:, :])
