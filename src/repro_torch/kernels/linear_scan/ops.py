"""Dispatch wrapper for the diagonal linear recurrence.

The port's counterpart of ``repro/kernels/linear_scan/ops.py``.
``linear_scan`` picks the implementation:

  * ``impl="cuda"``   — the hand-written kernel (kernel.py); for tensors on
                        the CPU the wrapper runs the plain version
  * ``impl="torch"``  — the plain torch loop (ref.py), on any device
  * ``impl=None``     — ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise

The reference's names land on their twins: ``"pallas"`` → ``"cuda"``, and
``"assoc"`` / ``"scan"`` → ``"torch"``.  A kernel that fails to build or
launch raises; nothing falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional

from .kernel import linear_scan_cuda
from .ref import linear_scan_reference

__all__ = ["linear_scan", "resolve_impl"]

_ALIASES = {"pallas": "cuda", "assoc": "torch", "scan": "torch"}


def resolve_impl(impl: Optional[str], device_type: str) -> str:
    """The port's backend for a reference or port impl name."""
    if impl is None:
        return "cuda" if device_type == "cuda" else "torch"
    impl = _ALIASES.get(impl, impl)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl}")
    return impl


def linear_scan(a, b, h0=None, *, impl: Optional[str] = None):
    """(h (B, T, D), h_T (B, D)) for h_t = a_t·h_{t-1} + b_t."""
    if resolve_impl(impl, a.device.type) == "cuda":
        return linear_scan_cuda(a, b, h0)
    return linear_scan_reference(a, b, h0)
