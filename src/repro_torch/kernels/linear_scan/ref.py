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

__all__ = ["linear_scan_reference"]


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
