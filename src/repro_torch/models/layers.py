"""Shared neural-net layers: plain functions over dicts of tensors, and the
``nn.Module``s that hold those dicts as parameters.

The counterpart of ``repro.models.layers``.  A layer's parameters are a
dict (``{"w": ..., "b": ...}``) with the JAX package's names and shapes, so
weights carry across by name (:mod:`repro_torch.convert`).  ``*_init``
functions draw from an explicit ``torch.Generator`` on the target device;
JAX's ``jax.random`` streams cannot be reproduced, so parity is checked on
converted weights.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.models import sharding


def constant_cache(fn):
    """``functools.lru_cache`` for a function that builds constant tensors
    (a table copied to the device once): it builds them outside every
    dispatch mode, so inside the dry-run's trace (a ``FakeTensorMode``,
    which takes real constants in, under counting modes) the cache never
    holds a fake tensor and filling it counts no work, whichever trace
    fills it first."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def run(*args):
        with _disable_current_modes():
            return cached(*args)

    run.cache_clear = cached.cache_clear
    return run


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               bias: bool = False, device="cuda", lead: tuple = ()) -> dict:
    """``lead`` prepends axes to every leaf (``(L,)`` for a stack of layers)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((*lead, d_in, d_out), dtype=dtype, device=device).uniform_(
        -scale, scale, generator=gen)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(dim: int, dtype=torch.float32, device="cuda", lead: tuple = ()) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


def layernorm_init(dim: int, dtype=torch.float32, device="cuda", lead: tuple = ()) -> dict:
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def embedding_init(gen: torch.Generator, vocab: int, dim: int, dtype=torch.float32,
                   device="cuda") -> dict:
    t = torch.empty((vocab, dim), dtype=dtype, device=device).normal_(generator=gen)
    return {"table": t.mul_(0.02)}


def embed(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"].index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)


def mlp_init(gen: torch.Generator, dims: tuple[int, ...], dtype=torch.float32,
             bias: bool = True, device="cuda") -> dict:
    """Plain ReLU MLP: dims = (in, h1, ..., out)."""
    return {f"fc{i}": dense_init(gen, dims[i], dims[i + 1], dtype, bias=bias, device=device)
            for i in range(len(dims) - 1)}


def mlp(p, x: torch.Tensor, act=torch.relu, final_act: bool = False) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"fc{i}"], x)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def glu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
             device="cuda", lead: tuple = ()) -> dict:
    """Gated linear unit block (SwiGLU/GeGLU share the structure)."""
    return {
        "up": dense_init(gen, d_model, d_ff, dtype, device=device, lead=lead),
        "gate": dense_init(gen, d_model, d_ff, dtype, device=device, lead=lead),
        "down": dense_init(gen, d_ff, d_model, dtype, device=device, lead=lead),
    }


def glu(p, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    return dense(p["down"], act(dense(p["gate"], x)) * dense(p["up"], x))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Token-level mean CE; logits (..., V) fp32-accumulated."""
    logits = logits.to(torch.float32)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def remat(fn, enabled: bool = True):
    """``fn`` rematerialized, as ``jax.checkpoint`` with ``nothing_saveable``:
    where grad is enabled it runs under ``torch.utils.checkpoint`` and keeps
    only its inputs for the backward pass, which runs it again; under
    ``torch.no_grad()`` (serving) it is ``fn``.  The recomputation runs the
    same operations, so the gradients are bit-equal to an unrematerialized
    run's.  The blocks and layers this wraps draw no random numbers, so the
    RNG state is neither saved nor restored (``preserve_rng_state=False``).
    ``fn`` must return a tensor or a tuple of tensors.  The recomputation
    runs under the torch-function modes the forward ran under, as JAX
    replays the same program (the backward pass itself runs outside them)."""
    if not enabled:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False,
                                                 context_fn=_forward_modes)

    return run


def _forward_modes():
    """``checkpoint``'s contexts: none for the forward, and the forward's
    torch-function modes for the recomputation (in a sharded trace, which
    matches its calls to the forward's: ``sharding.recomputation``)."""
    modes = torch.overrides._get_current_function_mode_stack()
    if not modes:
        return contextlib.nullcontext(), contextlib.nullcontext()
    stack = contextlib.ExitStack()
    again = sharding.recomputation()

    @contextlib.contextmanager
    def replay():
        with stack:
            for mode in modes:
                stack.enter_context(mode)
            stack.enter_context(again)
            yield

    return contextlib.nullcontext(), replay()


def nest(flat: dict) -> dict:
    """A flat dict keyed by dotted paths (``named_parameters``) -> the
    nested params tree; a level whose keys are all indices (``blocks.0``,
    ``blocks.1``, ...) becomes a list, as JAX's unrolled layers are."""
    out: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return _lists(out)


def flatten(tree, prefix: str = "") -> dict:
    """``nest``'s inverse: a nested tree (dicts, lists by index) -> a flat
    dict keyed by dotted paths (``"blocks.0.attn.q.w"``)."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


class ParamTree(nn.Module):
    """A nested dict of tensors (a JAX params tree; lists allowed) as
    parameters named by its paths (``embed.table``, ``blocks.0.attn.q.w``,
    ``layer0.radial_1_1_2.fc0.w``), so
    ``convert.state_from_params`` loads JAX's params unchanged; ``params()``
    gives the nested dict back."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
        if tree is not None:
            self._register(self, tree)

    @staticmethod
    def _register(module: nn.Module, tree) -> None:
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            k = str(k)  # a list's items are named by index (``blocks.0``)
            if isinstance(v, (dict, list)):
                child = nn.Module()
                module.add_module(k, child)
                ParamTree._register(child, v)
            else:
                module.register_parameter(k, nn.Parameter(v))

    def params(self) -> dict:
        return nest(dict(self.named_parameters()))


class Dense(nn.Module):
    """``dense`` with its ``w`` (and ``b``) as parameters."""

    def __init__(self, gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
                 bias: bool = False, device="cuda"):
        super().__init__()
        for k, v in dense_init(gen, d_in, d_out, dtype, bias, device).items():
            self.register_parameter(k, nn.Parameter(v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(dict(self.named_parameters()), x)


class MLP(nn.Module):
    """``mlp`` over ``fc0 .. fc{n-1}`` Dense layers (the JAX dict's keys)."""

    def __init__(self, gen: torch.Generator, dims: tuple[int, ...], dtype=torch.float32,
                 bias: bool = True, device="cuda"):
        super().__init__()
        for i in range(len(dims) - 1):
            self.add_module(f"fc{i}", Dense(gen, dims[i], dims[i + 1], dtype, bias, device))

    def forward(self, x: torch.Tensor, act=torch.relu, final_act: bool = False) -> torch.Tensor:
        params = {name: dict(m.named_parameters()) for name, m in self.named_children()}
        return mlp(params, x, act, final_act)
