"""Train-step factory: gradients, optional microbatch accumulation, optional
gradient compression, the AdamW update.

The counterpart of ``repro.train.trainer``.  ``make_train_step(loss_fn,
opt)`` returns

    step(params, opt_state, *batch, error_fb=None)
        -> (params', opt_state', metrics[, error_fb'])

where ``loss_fn(params, *batch)`` returns a 0-d loss and ``params`` is a
pytree of tensors (for a module, ``dict(module.named_parameters())`` bound
with ``torch.func.functional_call``).  Gradients come from
``torch.func.grad_and_value``, dense as JAX's autodiff gives them; the
update writes the parameters and moments in place (JAX's donated
``params``/``opt_state``).  ``metrics`` holds ``loss`` and ``grad_norm`` as
0-d tensors on the device: nothing syncs with the host.

Microbatching: ``grad_accum > 1`` loops over a leading microbatch axis
the caller adds to the batch tensors, summing losses and gradients in
microbatch order.  JAX's ``lax.scan`` and unrolled forms compute the same
sums, so ``unroll_accum`` changes nothing here; it is kept for JAX's
signature.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train import compression
from repro_torch.train.optimizer import AdamW
from repro_torch.train.tree import leaves, unflatten


def make_train_step(
    loss_fn: Callable,
    opt: AdamW,
    grad_accum: int = 1,
    compress: bool = False,
    unroll_accum: bool = False,
):
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def value_and_grad(params, *batch):
        # no graph outside: the gradients of parameters that require grad
        # would otherwise hold their backward pass alive
        with torch.no_grad():
            return grad_and_value(params, *batch)

    def grads_of(params, *batch):
        if grad_accum == 1:
            grads, loss = value_and_grad(params, *batch)
            return loss, grads
        # JAX adds each microbatch to zeros; 0 + x is x, so the sums start
        # from the first microbatch's
        grads, loss = value_and_grad(params, *(b[0] for b in batch))
        loss, acc = loss.to(torch.float32), [g.to(torch.float32) for g in leaves(grads)]
        for i in range(1, grad_accum):
            g, l = value_and_grad(params, *(b[i] for b in batch))
            loss = loss + l
            for a, x in zip(acc, leaves(g), strict=True):
                a.add_(x)
        for a in acc:
            a.div_(grad_accum)
        return loss / grad_accum, unflatten(grads, acc)

    def step(params, opt_state, *batch, error_fb=None):
        loss, grads = grads_of(params, *batch)
        if compress:
            grads, error_fb = compression.compress_decompress(grads, error_fb)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm}
        if compress:
            return params, opt_state, metrics, error_fb
        return params, opt_state, metrics

    return step
