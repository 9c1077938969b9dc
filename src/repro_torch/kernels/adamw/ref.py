"""Plain torch version of AdamW's clip, update and apply, leaf by leaf.

Each operation is a torch pass of its own, in float32, rounding where the
reference rounds; ``training/optimizer.py`` runs these on CPU and ``meta``
leaves.  The CUDA kernels run the same operations in the same order, so on
the card the update is bit-equal to :func:`adamw_update_reference` then
:func:`apply_reference`; the norm sums in another order than
:func:`grad_sumsq_reference`.

Memory.  A leaf is a whole layer stack -- falcon-mamba's ``in_proj`` at 32
layers holds 2.15 G elements, 8.6 GB a float32 copy -- so every function
here works in pieces of at most ``CHUNK`` elements along the leading
(layer) axis and writes state and params in place.

Scalars (the rate, bias corrections, the clip factor) are 0-dim float32
tensors on the params' device: a division by one is a true division on
the card too, as in the reference.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import torch

__all__ = ["CHUNK", "pieces", "scalar", "grad_f32", "grad_sumsq_reference",
           "clip_factor_reference", "adamw_update_reference",
           "apply_reference"]

#: most elements of one leaf a float32 temporary holds at a time
CHUNK = 1 << 26


def pieces(*tensors) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped tensors cut along the leading axis into
    pieces of at most ``CHUNK`` elements (one row at least)."""
    first = tensors[0]
    if first.dim() == 0:
        yield tensors
        return
    rows = max(1, CHUNK // max(1, first[0].numel()))
    for i in range(0, first.shape[0], rows):
        yield tuple(t[i:i + rows] for t in tensors)


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def grad_f32(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The gradient as the reference's update sees it: float32, clipped."""
    g = g.float()
    return g if scale is None else g * scale


@torch.no_grad()
def grad_sumsq_reference(leaves: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The float32 sum of squares of every leaf (None without leaves)."""
    total = None
    for x in leaves:
        for (piece,) in pieces(x):
            f = piece.float()
            part = torch.sum(f * f)
            total = part if total is None else total + part
    return total


def clip_factor_reference(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)) as a float32 0-dim tensor."""
    return torch.clamp(scalar(max_norm, norm) / torch.clamp(norm, min=1e-9),
                       max=1.0)


@torch.no_grad()
def adamw_update_reference(g, m, v, p, scale, bc1, bc2, neg_lr, *,
                           b1: float, b2: float, eps: float,
                           wd: float) -> torch.Tensor:
    """One AdamW step of one leaf: m and v in place; returns the update in
    p's dtype.  ``bc1``, ``bc2`` the bias corrections and ``neg_lr`` -lr
    (float32 values); ``scale`` the clip factor (0-dim) or None; ``wd`` the
    leaf's weight decay."""
    c1, c2, nlr = (scalar(x, p) for x in (bc1, bc2, neg_lr))
    out = torch.empty_like(p)
    for gg, mm, vv, pp, oo in pieces(g, m, v, p, out):
        gg = grad_f32(gg, scale)
        mm.mul_(b1).add_((1 - b1) * gg)
        vv.mul_(b2).add_((1 - b2) * gg * gg)
        u = (mm / c1) / (torch.sqrt(vv / c2) + eps)
        u.add_(wd * pp.float())
        oo.copy_(u.mul_(nlr))
    return out


@torch.no_grad()
def apply_reference(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """p ← (p in f32 + u in f32) in p's dtype, in place; returns ``p``."""
    for pp, uu in pieces(p, u):
        pp.copy_((pp.float() + uu.float()).to(p.dtype))
    return p
