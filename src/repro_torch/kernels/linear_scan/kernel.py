"""Diagonal linear recurrence as a hand-written CUDA kernel (K5).

Replaces ``repro/kernels/linear_scan/kernel.py::linear_scan_pallas`` (body
``_scan_kernel``).  Source: ``kernels/csrc/linear_scan.cu`` (its header says
what bounds it on an H100 and what the design does about it): one thread
per (b, d) channel walks t with the float32 carry in a register, d fastest
so each timestep's loads and stores are coalesced.  It takes any T,
float32 or bfloat16 inputs, and writes h and h_T in a's dtype.

``linear_scan_bwd_cuda`` is its backward (``linear_scan_bwd_kernel`` in the
same source), which the reference has no kernel for: the same thread per
channel walks t downward with the cotangent's carry in a register.

Both launch on ``torch.cuda.current_stream()``.  For tensors that lie on
the CPU each runs its plain torch version (ref.py) instead; on a CUDA
tensor it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import linear_scan_bwd_reference, linear_scan_reference

__all__ = ["linear_scan_cuda", "linear_scan_bwd_cuda", "LAUNCHES", "SHAPES"]

#: kernel launches (each wrapper adds one where it launches, nowhere else)
LAUNCHES = {"linear_scan": 0, "linear_scan_bwd": 0}
#: (B, T, D, dtype, has_h0) -> launches at that shape
SHAPES: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "linear_scan_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "linear_scan_bwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                               _P, _P],
}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("linear_scan", _SIGNATURES)


def _check_scan(a: torch.Tensor, others) -> Tuple[int, int, int]:
    """Validate a (B, T, D) in float32 or bfloat16 and ``others`` like it."""
    if a.dim() != 3:
        raise ValueError(f"a: expected (B, T, D), got shape {tuple(a.shape)}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"a: expected float32 or bfloat16, got {a.dtype}")
    check_tensor(a, "a", a.dtype, tuple(a.shape), a.device)
    for name, t in others:
        check_tensor(t, name, a.dtype, tuple(a.shape), a.device)
    return tuple(a.shape)


def _f32_channels(t: Optional[torch.Tensor], name: str, shape, device):
    """A (B, D) operand the kernels take as float32, or None."""
    if t is None:
        return None
    t = t.to(torch.float32).contiguous()
    check_tensor(t, name, torch.float32, shape, device)
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (B, T, D), h_T (B, D)) in a's dtype for a, b (B, T, D), h0 (B, D)."""
    device = a.device
    if device.type == "cpu":
        return linear_scan_reference(a, b, h0)

    n_batch, n_t, n_d = _check_scan(a, [("b", b)])
    h0f = _f32_channels(h0, "h0", (n_batch, n_d), device)

    out = torch.empty_like(a)
    h_t = torch.empty((n_batch, n_d), dtype=a.dtype, device=device)
    if n_batch * n_d == 0:
        return out, h_t
    err = _lib().linear_scan_launch(
        a.data_ptr(), b.data_ptr(), _ptr(h0f),
        n_batch, n_t, n_d, _DTYPES[a.dtype], out.data_ptr(), h_t.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "linear_scan")
    LAUNCHES["linear_scan"] += 1
    key = (n_batch, n_t, n_d, str(a.dtype).replace("torch.", ""), h0 is not None)
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return out, h_t


def linear_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                         h0: Optional[torch.Tensor], gh: torch.Tensor,
                         ghT: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """(da, db, dh0) of :func:`linear_scan_cuda` from its saved a, h and h0
    and the cotangents gh (B, T, D) and ghT (B, D); da and db in a's dtype,
    dh0 float32 (None without h0)."""
    device = a.device
    if device.type == "cpu":
        return linear_scan_bwd_reference(a, h, h0, gh, ghT)

    n_batch, n_t, n_d = _check_scan(a, [("h", h), ("gh", gh)])
    h0f = _f32_channels(h0, "h0", (n_batch, n_d), device)
    ghTf = _f32_channels(ghT, "ghT", (n_batch, n_d), device)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty(
        (n_batch, n_d), dtype=torch.float32, device=device)
    if n_batch * n_d == 0:
        return da, db, dh0
    err = _lib().linear_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), _ptr(h0f), gh.data_ptr(), _ptr(ghTf),
        n_batch, n_t, n_d, _DTYPES[a.dtype], da.data_ptr(), db.data_ptr(),
        _ptr(dh0), torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "linear_scan_bwd")
    LAUNCHES["linear_scan_bwd"] += 1
    return da, db, dh0
