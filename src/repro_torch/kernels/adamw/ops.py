"""Dispatch of AdamW's clip and update by the leaves' device.

  * CUDA leaves: the hand-written kernels (kernel.py), ``impl="cuda"``;
  * CPU and ``meta`` leaves (the dry run's, ``launch/dryrun.py``): the
    plain torch version (ref.py), ``impl="torch"``.

There is no knob: the device decides, and a CUDA leaf the kernels do not
take (another dtype; a param or moment not contiguous) raises; nothing
falls back.  A gradient that autograd laid out in other strides (a stacked
leaf's, in whisper) is read through a contiguous copy.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .kernel import adamw_update_cuda, grad_norm_cuda
from .ref import (adamw_update_reference, apply_reference,
                  clip_factor_reference, grad_sumsq_reference)

__all__ = ["grad_norm", "adamw_leaf", "impl_of"]


def impl_of(leaves: Sequence[torch.Tensor]) -> str:
    """"cuda" where every leaf lies on a CUDA card, else "torch"."""
    on_card = bool(leaves) and all(t.device.type == "cuda" for t in leaves)
    return "cuda" if on_card else "torch"


def grad_norm(leaves: Sequence[torch.Tensor], max_norm: Optional[float] = None,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(global norm, clip factor or None without ``max_norm``) of the
    gradient leaves, 0-dim float32; without leaves a norm of 0 on the CPU."""
    leaves = list(leaves)
    if impl_of(leaves) == "cuda":
        return grad_norm_cuda([g.contiguous() for g in leaves], max_norm)
    total = grad_sumsq_reference(leaves)
    norm = (torch.zeros((), dtype=torch.float32) if total is None
            else torch.sqrt(total))
    return norm, None if max_norm is None else clip_factor_reference(norm, max_norm)


def adamw_leaf(g, m, v, p, scale, bc1, bc2, neg_lr, *, b1: float, b2: float,
               eps: float, wd: float) -> bool:
    """One AdamW step of one leaf in place (m, v and p); True where the
    kernel ran it."""
    if p.device.type == "cuda":
        adamw_update_cuda(g.contiguous(), m, v, p, scale, bc1, bc2, neg_lr,
                          b1=b1, b2=b2, eps=eps, wd=wd)
        return True
    apply_reference(p, adamw_update_reference(g, m, v, p, scale, bc1, bc2,
                                              neg_lr, b1=b1, b2=b2, eps=eps,
                                              wd=wd))
    return False
