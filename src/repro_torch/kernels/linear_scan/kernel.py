"""Diagonal linear recurrence as a hand-written CUDA kernel (K5).

Replaces ``repro/kernels/linear_scan/kernel.py::linear_scan_pallas`` (body
``_scan_kernel``).  Source: ``kernels/csrc/linear_scan.cu`` (its header says
what bounds it on an H100 and what the design does about it): one thread
per (b, d) channel walks t with the float32 carry in a register, d fastest
so each timestep's loads and stores are coalesced.  It takes any T,
float32 or bfloat16 inputs, and writes h and h_T in a's dtype.

``linear_scan_cuda`` launches on ``torch.cuda.current_stream()``.  For
tensors that lie on the CPU it runs the plain torch version (ref.py)
instead; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import linear_scan_reference

__all__ = ["linear_scan_cuda", "LAUNCHES", "SHAPES"]

#: kernel launches (the wrapper adds one where it launches, nowhere else)
LAUNCHES = {"linear_scan": 0}
#: (B, T, D, dtype, has_h0) -> launches at that shape
SHAPES: dict = {}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "linear_scan_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("linear_scan", _SIGNATURES)


def linear_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (B, T, D), h_T (B, D)) in a's dtype for a, b (B, T, D), h0 (B, D)."""
    device = a.device
    if device.type == "cpu":
        return linear_scan_reference(a, b, h0)

    if a.dim() != 3:
        raise ValueError(f"a: expected (B, T, D), got shape {tuple(a.shape)}")
    n_batch, n_t, n_d = a.shape
    if a.dtype not in _DTYPES:
        raise TypeError(f"a: expected float32 or bfloat16, got {a.dtype}")
    check_tensor(a, "a", a.dtype, (n_batch, n_t, n_d), device)
    check_tensor(b, "b", a.dtype, (n_batch, n_t, n_d), device)
    h0f = None
    if h0 is not None:
        h0f = h0.to(torch.float32).contiguous()
        check_tensor(h0f, "h0", torch.float32, (n_batch, n_d), device)

    out = torch.empty_like(a)
    h_t = torch.empty((n_batch, n_d), dtype=a.dtype, device=device)
    if n_batch * n_d == 0:
        return out, h_t
    err = _lib().linear_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0f is None else h0f.data_ptr(),
        n_batch, n_t, n_d, _DTYPES[a.dtype], out.data_ptr(), h_t.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "linear_scan")
    LAUNCHES["linear_scan"] += 1
    key = (n_batch, n_t, n_d, str(a.dtype).replace("torch.", ""), h0 is not None)
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return out, h_t
