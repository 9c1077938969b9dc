"""Train-step factory: grad accumulation, clipping, optimizer, metrics.

The port's counterpart of ``repro/training/trainer.py``.
``make_train_step`` returns a function

    (params, opt_state, batch, step) → (params, opt_state, metrics)

where ``batch`` holds (B, S) integer tensors on the params' device.  The
global batch is split into ``microbatches`` chunks, accumulated in a
Python loop (the reference's ``lax.scan``); remat happens inside the
model.  The loss and the accumulated gradients are float32, and the
gradient of a bfloat16 param is bfloat16, as ``jax.value_and_grad`` gives
them.  ``rules`` (``distributed.sharding.ShardingRules``) go to every model
call; the reference's constraint that keeps the stacked microbatches'
batch dim on the batch axes is a guarded spec check, which moves nothing
on the port's single-controller mesh.

Params and optimizer state are updated in place (``training/optimizer``)
and returned.  The params the caller passes need not require grad: each
gradient is taken through detached aliases of them, so serving on the
same params keeps building no graph.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..checkpoint.store import tree_flatten
from ..distributed.sharding import guard_spec
from ..kernels.adamw import ops as adamw_ops
from ..runtime import trace
from .optimizer import Optimizer, apply_updates, norm_and_clip_factor

__all__ = ["make_train_step", "make_eval_step", "make_accum_steps"]


def _grad_fn(model, *, rules=None, attn_impl: str, remat: bool) -> Callable:
    """(params, batch) → (loss, grads): the port's ``jax.value_and_grad``."""
    def value_and_grad(params, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = model.loss_fn(rebuild(live), batch, rules=rules,
                                 impl=attn_impl, remat=remat)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), rebuild(list(grads))
    return value_and_grad


def _split(batch, microbatches: int, rules=None):
    """The batch cut into ``microbatches`` equal parts along its rows; with
    ``rules``, each stacked part keeps its batch dim on the batch axes (a
    guarded spec; nothing moves on the single-controller mesh)."""
    parts = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{microbatches} microbatches")
        x = x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))
        if rules is not None:
            ba = rules.batch_axes if rules.batch_axes else None
            guard_spec((None, ba) + (None,) * (x.dim() - 2), x.shape,
                       rules.mesh.shape)
        parts[k] = x
    return [{k: x[i] for k, x in parts.items()} for i in range(microbatches)]


def _accumulate(acc, grads, accum_dtype):
    """acc + g in ``accum_dtype``, leaf by leaf, in place."""
    acc_leaves = tree_flatten(acc)[0]
    for a, g in zip(acc_leaves, tree_flatten(grads)[0]):
        a.add_(g.to(accum_dtype))
    return acc


def _zeros(params, dtype):
    leaves, rebuild = tree_flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=dtype, device=p.device)
                    for p in leaves])


def _divide(grads, n: int):
    """g / n, a true division on every device (a 0-dim tensor divisor)."""
    leaves, rebuild = tree_flatten(grads)
    return rebuild([g / torch.as_tensor(float(n), dtype=g.dtype, device=g.device)
                    for g in leaves])


def _clip_and_apply(optimizer, params, opt_state, grads, step, clip_norm):
    """Clip (the factor rides into the optimizer), update, apply.  On
    gradients that lie on the card an optimizer with a ``step`` (AdamW)
    updates and applies in one pass a leaf; elsewhere ``update`` then
    ``apply_updates`` run.  One ``train.optimizer`` span: ``impl`` ("cuda"
    where the update kernel ran), ``elems`` (elements updated) and
    ``fused_elems`` (those the kernel updated)."""
    leaves = tree_flatten(grads)[0]
    with trace.span("train.optimizer") as sp:
        gnorm = torch.zeros((), dtype=torch.float32)
        scale = None
        if clip_norm is not None:
            gnorm, scale = norm_and_clip_factor(grads, clip_norm)
        fused = 0
        if optimizer.step is not None and adamw_ops.impl_of(leaves) == "cuda":
            params, opt_state, fused = optimizer.step(grads, opt_state, params,
                                                      step, scale=scale)
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  step, scale=scale)
            params = apply_updates(params, updates)
        if sp is not None:
            sp.attrs.update(impl="cuda" if fused else "torch",
                            elems=sum(g.numel() for g in leaves),
                            fused_elems=fused)
    return params, opt_state, gnorm


def make_train_step(
    model,
    optimizer: Optimizer,
    *,
    rules=None,
    microbatches: int = 1,
    attn_impl: str = "auto",
    remat: bool = True,
    clip_norm: Optional[float] = 1.0,
    accum_dtype=torch.float32,
) -> Callable:
    grad_fn = _grad_fn(model, rules=rules, attn_impl=attn_impl, remat=remat)

    def train_step(params, opt_state, batch, step):
        if microbatches == 1:
            loss, grads = grad_fn(params, batch)
        else:
            grads = _zeros(params, accum_dtype)
            loss = None
            for mb in _split(batch, microbatches, rules):
                mb_loss, g = grad_fn(params, mb)
                grads = _accumulate(grads, g, accum_dtype)
                del g
                loss = mb_loss if loss is None else loss + mb_loss
            loss = loss / microbatches
            grads = _divide(grads, microbatches)
        params, opt_state, gnorm = _clip_and_apply(
            optimizer, params, opt_state, grads, step, clip_norm)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": step + 1}
        return params, opt_state, metrics

    return train_step


def make_eval_step(model, *, rules=None, attn_impl: str = "auto"):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss_fn(params, batch, rules=rules, impl=attn_impl,
                             remat=False)
    return eval_step


def make_accum_steps(
    model,
    optimizer: Optimizer,
    *,
    rules=None,
    attn_impl: str = "auto",
    remat: bool = True,
    clip_norm: Optional[float] = 1.0,
    accum_dtype=torch.bfloat16,
    microbatches: int = 1,
):
    """External gradient accumulation: two steps instead of one.

        micro_step(params, grad_acc, micro_batch) → (grad_acc, loss)
        apply_step(params, opt_state, grads, step) → (params, opt_state, metrics)

    ``grad_acc`` (zeros of ``accum_dtype`` shaped like the params, made by
    the caller) is accumulated in place, so the step peaks at ONE gradient
    tree beside it.
    """
    grad_fn = _grad_fn(model, rules=rules, attn_impl=attn_impl, remat=remat)

    def micro_step(params, grad_acc, micro_batch):
        loss, g = grad_fn(params, micro_batch)
        return _accumulate(grad_acc, g, accum_dtype), loss

    def apply_step(params, opt_state, grads, step):
        grads = _divide(grads, microbatches)
        params, opt_state, gnorm = _clip_and_apply(
            optimizer, params, opt_state, grads, step, clip_norm)
        return params, opt_state, {"grad_norm": gnorm, "step": step + 1}

    return micro_step, apply_step
