"""Optimizers from scratch: AdamW and Adafactor over dicts of tensors.

The port's counterpart of ``repro/training/optimizer.py``, under the same
(init, update) contract:

    state  = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

AdamW keeps float32 (m, v), 8 bytes a param.  Adafactor factors the second
moment into row and column statistics and keeps no momentum.  Each
update runs the reference's operations in its order, in float32, and
returns the updates in each param's dtype.

AdamW also has ``step(grads, state, params, step, scale=None)``: update
and apply at once, in place, returning ``(params, state, fused)``.  On a
CUDA leaf it launches ``adamw_update_kernel`` (``kernels/adamw``), which
reads each operand once and builds no updates tree; on any other leaf it
runs ``update`` then ``apply_updates``' arithmetic.  ``fused`` counts the
elements the kernel updated.  :func:`global_norm` and
:func:`norm_and_clip_factor` take ``grad_sumsq_kernel`` for CUDA leaves
the same way.  Adafactor has no ``step`` (None).

Memory.  The reference chains its leaves through
``jax.lax.optimization_barrier`` so that one leaf's float32 temporaries
are alive at a time.  Here a leaf is a whole layer stack, so the plain
versions work in pieces along the leading (layer) axis
(``kernels/adamw/ref.py::CHUNK``), and state and params are updated in
place: ``update`` writes m and v where they are and returns the same
state, and ``apply_updates`` writes the params where they are and returns
them.  Adafactor's whole-leaf means keep one leaf's float32 temporaries
alive at a time, as the reference does.

``update`` also takes ``scale``, the clip factor of
:func:`clip_by_global_norm`: ``g * scale`` is then formed piece by piece,
in float32 as the reference's clipped gradient is, instead of as a whole
float32 copy of the gradient tree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint.store import tree_flatten
from ..kernels.adamw import ops as adamw_ops
from ..kernels.adamw.ref import (adamw_update_reference, apply_reference,
                                 clip_factor_reference, grad_f32, scalar)

__all__ = ["adamw", "adafactor", "apply_updates", "global_norm",
           "clip_by_global_norm", "norm_and_clip_factor", "Optimizer"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step, scale=None) -> (updates, state)
    #: (grads, state, params, step, scale=None) -> (params, state, fused), or None
    step: Optional[Callable] = None


def _map(fn, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``, same structure."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


@torch.no_grad()
def apply_updates(params, updates):
    """p ← (p in f32 + u in f32) in p's dtype, in place; returns ``params``."""
    return _map(apply_reference, params, updates)


@torch.no_grad()
def norm_and_clip_factor(tree, max_norm: float):
    """(global norm, min(1, max_norm / max(norm, 1e-9))), 0-dim float32;
    on CUDA leaves both come from the card's two norm passes."""
    return adamw_ops.grad_norm(tree_flatten(tree)[0], max_norm)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    return adamw_ops.grad_norm(tree_flatten(tree)[0])[0]


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) as a float32 0-dim tensor."""
    return clip_factor_reference(norm, max_norm)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads · factor, norm); as in the reference, a bfloat16 gradient
    times the float32 factor is float32."""
    norm, scale = norm_and_clip_factor(grads, max_norm)
    return _map(lambda g: grad_f32(g, scale), grads), norm


def _decay_mask(p) -> float:
    """No weight decay for vectors/scalars (norm scales, biases, gates)."""
    return 1.0 if p.dim() >= 2 else 0.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: Callable, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _map(zeros, params), "v": _map(zeros, params)}

    def scalars(step):
        """The bias corrections and -lr of ``step``, as float32 values."""
        step_f = np.float32(step) + np.float32(1.0)
        bc1 = np.float32(1.0) - np.float32(b1) ** step_f
        bc2 = np.float32(1.0) - np.float32(b2) ** step_f
        return bc1, bc2, -np.float32(lr(step))

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        bc1, bc2, neg_lr = scalars(step)

        def one(g, m, v, p):
            return adamw_update_reference(
                g, m, v, p, scale, bc1, bc2, neg_lr, b1=b1, b2=b2, eps=eps,
                wd=weight_decay * _decay_mask(p))

        return _map(one, grads, state["m"], state["v"], params), state

    @torch.no_grad()
    def step_(grads, state, params, step, scale=None):
        bc1, bc2, neg_lr = scalars(step)
        fused = 0
        for g, m, v, p in zip(*(tree_flatten(t)[0] for t in (
                grads, state["m"], state["v"], params))):
            if adamw_ops.adamw_leaf(g, m, v, p, scale, bc1, bc2, neg_lr,
                                    b1=b1, b2=b2, eps=eps,
                                    wd=weight_decay * _decay_mask(p)):
                fused += p.numel()
        return params, state, fused

    return Optimizer(init, update, step_)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


def adafactor(lr: Callable, *, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, decay_rate: float = 0.8,
              weight_decay: float = 0.0) -> Optimizer:
    """Shazeer & Stern 2018, factored over the two largest dims.

    State per ≥2-D param: row stats (shape minus last dim) + col stats
    (shape minus second-to-last dim); 1-D params fall back to full v.
    """

    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"stats": _map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        step_f = np.float32(step) + np.float32(1.0)
        rho_v = np.float32(1.0) - step_f ** np.float32(-decay_rate)
        lr_v = np.float32(lr(step))

        def one(g, st, p):
            rho, lr_t = scalar(rho_v, p), scalar(lr_v, p)
            g = grad_f32(g, scale)
            g2 = g * g + eps1
            if _factored(p):
                vr = rho * st["vr"] + (1 - rho) * torch.mean(g2, dim=-1)
                vc = rho * st["vc"] + (1 - rho) * torch.mean(g2, dim=-2)
                # rank-1 reconstruction of v
                denom = torch.mean(vr, dim=-1, keepdim=True)
                vhat = (vr[..., None] / torch.clamp(denom[..., None], min=eps1)) \
                    * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(vhat, min=eps1))
                st["vr"].copy_(vr)
                st["vc"].copy_(vc)
            else:
                v = rho * st["v"] + (1 - rho) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps1))
                st["v"].copy_(v)
            del g2
            # update clipping (RMS of update ≤ clip_threshold)
            rms_u = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            p_scale = torch.clamp(torch.sqrt(torch.mean(pf * pf)), min=eps2)
            upd = -lr_t * p_scale * u
            if weight_decay:
                upd = upd - lr_t * weight_decay * _decay_mask(p) * pf
            return upd.to(p.dtype)

        def walk(g, st, p):  # st mirrors the params, down to the stats dicts
            if isinstance(g, dict):
                return {k: walk(g[k], st[k], p[k]) for k in g}
            return one(g, st, p)

        return walk(grads, state["stats"], params), state

    return Optimizer(init, update)

