"""Plain torch version of the diagonal linear recurrence h_t = a_t·h_{t-1} + b_t.

Counterpart of ``repro/kernels/linear_scan/ref.py::linear_scan_reference``,
in the Pallas kernel's arithmetic (``repro/kernels/linear_scan/kernel.py``):
the carry is float32 whatever the inputs' dtype, and every h_t is written
out in a's dtype.  It is a sequential loop over t, one multiply and one
add a step, each rounded on its own -- the order the CUDA kernel
(csrc/linear_scan.cu) runs -- so on the card the two are bit-equal.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["linear_scan_reference", "linear_scan_bwd_reference"]


def linear_scan_reference(
    a: torch.Tensor,  # (B, T, D) decay
    b: torch.Tensor,  # (B, T, D) input
    h0: Optional[torch.Tensor] = None,  # (B, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(h (B, T, D), h_T (B, D))``, both in a's dtype."""
    n_batch, n_t, n_d = a.shape
    if h0 is None:
        h = torch.zeros((n_batch, n_d), dtype=torch.float32, device=a.device)
    else:
        h = h0.to(torch.float32)
    out = torch.empty_like(a)
    for t in range(n_t):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out, h.to(a.dtype)


def linear_scan_bwd_reference(
    a: torch.Tensor,  # (B, T, D) decay, as the forward was given it
    h: torch.Tensor,  # (B, T, D) the forward's output
    h0: Optional[torch.Tensor],  # (B, D) or None
    gh: torch.Tensor,  # (B, T, D) cotangent of h
    ghT: Optional[torch.Tensor] = None,  # (B, D) cotangent of h_T, or None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(da, db, dh0)``: da and db in a's dtype, dh0 (f32) or None.

    The reverse loop of the CUDA backward (``linear_scan_bwd_kernel``):
    with a float32 carry c = ghT (or 0), for t from T-1 down to 0
    g_t = gh_t + c, db_t = g_t, da_t = g_t·h_{t-1} (h_{-1} = h0 or 0) and
    c = a_t·g_t; dh0 = c.  Each multiply and add rounds on its own.
    """
    n_batch, n_t, n_d = a.shape
    if ghT is None:
        c = torch.zeros((n_batch, n_d), dtype=torch.float32, device=a.device)
    else:
        c = ghT.to(torch.float32)
    if h0 is None:
        h_first = torch.zeros((n_batch, n_d), dtype=torch.float32, device=a.device)
    else:
        h_first = h0.to(torch.float32)
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    for t in range(n_t - 1, -1, -1):
        g = gh[:, t].float() + c
        db[:, t] = g
        h_prev = h[:, t - 1].float() if t > 0 else h_first
        da[:, t] = g * h_prev
        c = a[:, t].float() * g
    return da, db, (c if h0 is not None else None)
