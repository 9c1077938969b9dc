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

Memory.  The reference chains its leaves through
``jax.lax.optimization_barrier`` so that one leaf's float32 temporaries
are alive at a time.  Here a leaf is a whole layer stack -- falcon-mamba's
``in_proj`` at 32 layers holds 2.15 G elements, 8.6 GB a float32 copy --
so AdamW, ``global_norm`` and ``apply_updates`` work in pieces of at most
``CHUNK`` elements along the leading (layer) axis, and state and params
are updated in place: ``update`` writes m and v where they are and
returns the same state, and ``apply_updates`` writes the params where
they are and returns them.  Adafactor's whole-leaf means keep one leaf's
float32 temporaries alive at a time, as the reference does.

``update`` also takes ``scale``, the clip factor of
:func:`clip_by_global_norm`: ``g * scale`` is then formed piece by piece,
in float32 as the reference's clipped gradient is, instead of as a whole
float32 copy of the gradient tree.

Scalars (the rate, bias corrections, the clip factor) are 0-dim float32
tensors on the params' device: a division by one is a true division on
the card too, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.store import tree_flatten

__all__ = ["adamw", "adafactor", "apply_updates", "global_norm",
           "clip_by_global_norm", "Optimizer", "CHUNK"]

#: most elements of one leaf a float32 temporary holds at a time
CHUNK = 1 << 26


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step, scale=None) -> (updates, state)


def _map(fn, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``, same structure."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(*xs) for xs in zip(leaves, *others)])


def _pieces(*tensors) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped tensors cut along the leading axis into
    pieces of at most ``CHUNK`` elements (one row at least)."""
    first = tensors[0]
    if first.dim() == 0:
        yield tensors
        return
    rows = max(1, CHUNK // max(1, first[0].numel()))
    for i in range(0, first.shape[0], rows):
        yield tuple(t[i:i + rows] for t in tensors)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def _grad_f32(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The gradient as the reference's update sees it: float32, clipped."""
    g = g.float()
    return g if scale is None else g * scale


@torch.no_grad()
def apply_updates(params, updates):
    """p ← (p in f32 + u in f32) in p's dtype, in place; returns ``params``."""
    def one(p, u):
        for pp, uu in _pieces(p, u):
            pp.copy_((pp.float() + uu.float()).to(p.dtype))
        return p
    return _map(one, params, updates)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    total = None
    for x in tree_flatten(tree)[0]:
        for (piece,) in _pieces(x):
            f = piece.float()
            part = torch.sum(f * f)
            total = part if total is None else total + part
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) as a float32 0-dim tensor."""
    return torch.clamp(_scalar(max_norm, norm) / torch.clamp(norm, min=1e-9),
                       max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads · factor, norm); as in the reference, a bfloat16 gradient
    times the float32 factor is float32."""
    norm = global_norm(grads)
    scale = clip_factor(norm, max_norm)
    return _map(lambda g: _grad_f32(g, scale), grads), norm


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

    @torch.no_grad()
    def update(grads, state, params, step, scale=None):
        step_f = np.float32(step) + np.float32(1.0)
        bc1 = np.float32(1.0) - np.float32(b1) ** step_f
        bc2 = np.float32(1.0) - np.float32(b2) ** step_f
        neg_lr = -np.float32(lr(step))

        def one(g, m, v, p):
            c1, c2, nlr = (_scalar(x, p) for x in (bc1, bc2, neg_lr))
            wd = weight_decay * _decay_mask(p)
            out = torch.empty_like(p)
            for gg, mm, vv, pp, oo in _pieces(g, m, v, p, out):
                gg = _grad_f32(gg, scale)
                mm.mul_(b1).add_((1 - b1) * gg)
                vv.mul_(b2).add_((1 - b2) * gg * gg)
                u = (mm / c1) / (torch.sqrt(vv / c2) + eps)
                u.add_(wd * pp.float())
                oo.copy_(u.mul_(nlr))
            return out

        return _map(one, grads, state["m"], state["v"], params), state

    return Optimizer(init, update)


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
            rho, lr_t = _scalar(rho_v, p), _scalar(lr_v, p)
            g = _grad_f32(g, scale)
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

