"""AdamW's clip, update and apply as two hand-written CUDA passes.

Replaces no TPU kernel: the reference's optimizer
(``repro/training/optimizer.py``) is plain jnp.  Source:
``kernels/csrc/adamw.cu`` (its header says what bounds it on an H100 and
what the design does about it: bytes; one read of each operand).

* :func:`grad_norm_cuda`: ``grad_sumsq_kernel`` once a leaf, then
  ``grad_sumsq_finish_kernel``: the global norm of the gradients and, given
  ``max_norm``, the clip factor, each a 0-dim float32 tensor on the card.
  The host reads nothing back, and the norm is the same bits on every run.
* :func:`adamw_update_cuda`: ``adamw_update_kernel``, one pass over a leaf
  that writes m, v and p in place, bit-equal to the plain update and apply.

Leaves: gradients and params each in float32 or bfloat16, moments in
float32, contiguous and on one device.  Both launch on
``torch.cuda.current_stream()`` without synchronising.  For leaves that lie
on the CPU each runs its plain version (ref.py) instead; on a CUDA leaf it
launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import (adamw_update_reference, apply_reference,
                  clip_factor_reference, grad_sumsq_reference)

__all__ = ["grad_norm_cuda", "adamw_update_cuda", "LAUNCHES", "SHAPES"]

#: kernel launches (each wrapper adds one where it launches, nowhere else)
LAUNCHES = {"grad_sumsq": 0, "adamw_update": 0}
#: (kernel, elements, gradient dtype[, param dtype]) -> launches at that shape
SHAPES: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "grad_sumsq_tile": [],
    "grad_sumsq_launch": [_P, _I, _L, _I, _P, _P],
    "grad_sumsq_finish_launch": [_P, _L, _F, _P, _P, _P],
    "adamw_update_launch": [_P, _I, _P, _I, _P, _P, _L, _P] + [_F] * 9
                           + [_I, _P],
}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("adamw", _SIGNATURES)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_leaf(t: torch.Tensor, name: str, shape, device) -> None:
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    check_tensor(t, name, t.dtype, shape, device)


def _aligned(*tensors) -> int:
    """1 where every pointer takes the kernels' 16-byte vector loads."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _count(key) -> None:
    LAUNCHES[key[0]] += 1
    SHAPES[key] = SHAPES.get(key, 0) + 1


def grad_norm_cuda(leaves: Sequence[torch.Tensor],
                   max_norm: Optional[float] = None,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(norm, clip factor) of the gradient leaves: sqrt of the float32 sum
    of their squares and, given ``max_norm``, min(1, max_norm / max(norm,
    1e-9)) (else None); each 0-dim float32 on the leaves' device."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("grad_norm_cuda needs at least one leaf")
    device = leaves[0].device
    for i, g in enumerate(leaves):
        _check_leaf(g, f"leaf {i}", tuple(g.shape), device)
    if device.type == "cpu":
        norm = torch.sqrt(grad_sumsq_reference(leaves))
        factor = None if max_norm is None else clip_factor_reference(norm, max_norm)
        return norm, factor

    lib = _lib()
    tile = lib.grad_sumsq_tile()
    tiles = [-(-g.numel() // tile) for g in leaves]
    partials = torch.empty((max(1, sum(tiles)),), dtype=torch.float32,
                           device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    factor = None if max_norm is None else torch.empty_like(norm)
    stream = torch.cuda.current_stream(device).cuda_stream
    offset = 0
    for g, k in zip(leaves, tiles):
        if k:
            err = lib.grad_sumsq_launch(
                g.data_ptr(), _DTYPES[g.dtype], g.numel(), _aligned(g),
                partials.data_ptr() + 4 * offset, stream)
            check_launch(err, "grad_sumsq")
            _count(("grad_sumsq", g.numel(), _name(g.dtype)))
        offset += k
    err = lib.grad_sumsq_finish_launch(
        partials.data_ptr(), offset, 0.0 if max_norm is None else float(max_norm),
        norm.data_ptr(), None if factor is None else factor.data_ptr(), stream)
    check_launch(err, "grad_sumsq_finish")
    return norm, factor


def adamw_update_cuda(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      p: torch.Tensor, scale: Optional[torch.Tensor],
                      bc1, bc2, neg_lr, *, b1: float, b2: float, eps: float,
                      wd: float) -> torch.Tensor:
    """One AdamW step of one leaf, clip factor ``scale`` (0-dim float32, or
    None) applied to g: m, v and p updated in place; returns ``p``.  The
    arguments are :func:`ref.adamw_update_reference`'s."""
    device = p.device
    shape = tuple(p.shape)
    _check_leaf(p, "p", shape, device)
    _check_leaf(g, "g", shape, device)
    check_tensor(m, "m", torch.float32, shape, device)
    check_tensor(v, "v", torch.float32, shape, device)
    if scale is not None:
        check_tensor(scale, "scale", torch.float32, (), device)
    if device.type == "cpu":
        return apply_reference(p, adamw_update_reference(
            g, m, v, p, scale, bc1, bc2, neg_lr, b1=b1, b2=b2, eps=eps, wd=wd))

    n = p.numel()
    if n == 0:
        return p
    err = _lib().adamw_update_launch(
        g.data_ptr(), _DTYPES[g.dtype], p.data_ptr(), _DTYPES[p.dtype],
        m.data_ptr(), v.data_ptr(), n,
        None if scale is None else scale.data_ptr(),
        float(b1), float(1 - b1), float(b2), float(1 - b2), float(bc1),
        float(bc2), float(eps), float(wd), float(neg_lr), _aligned(g, p, m, v),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "adamw_update")
    _count(("adamw_update", n, _name(g.dtype), _name(p.dtype)))
    return p
