"""Dispatch wrapper for the diagonal linear recurrence, with its gradient.

The port's counterpart of ``repro/kernels/linear_scan/ops.py``.
``linear_scan`` picks the implementation:

  * ``impl="cuda"``   — the hand-written kernels (kernel.py); for tensors
                        on the CPU the wrappers run their plain versions
  * ``impl="torch"``  — the plain torch loops (ref.py), on any device
  * ``impl=None``     — ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise

The reference's names land on their twins: ``"pallas"`` → ``"cuda"``, and
``"assoc"`` / ``"scan"`` → ``"torch"``.  A kernel that fails to build or
launch raises; nothing falls back to the plain version.

Both backends run through one ``torch.autograd.Function``: its forward is
the scan (K5 on the card), its backward the reverse scan of the
cotangents (``linear_scan_bwd_kernel`` on the card).  It saves a, the
forward's h and h0.  Without inputs that require grad it builds no graph.

On ``meta`` tensors (the dry run's, ``launch/dryrun.py``) both directions
return shape-only outputs: no kernel launches and the plain loop over T
does not run.  The scan has no matmul, so a FLOP count loses nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import linear_scan_bwd_cuda, linear_scan_cuda
from .ref import linear_scan_bwd_reference, linear_scan_reference

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


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0, impl):
        if a.device.type == "meta":
            h, h_t = torch.empty_like(a), a.new_empty((a.shape[0], a.shape[2]))
        else:
            fwd = linear_scan_cuda if impl == "cuda" else linear_scan_reference
            h, h_t = fwd(a, b, h0)
        ctx.impl = impl
        ctx.save_for_backward(a, h, h0)
        ctx.set_materialize_grads(False)
        return h, h_t

    @staticmethod
    def backward(ctx, gh, ghT):
        a, h, h0 = ctx.saved_tensors
        if a.device.type == "meta":
            return (torch.empty_like(a), torch.empty_like(a),
                    None if h0 is None else torch.empty_like(h0), None)
        if gh is None:
            gh = torch.zeros_like(h)
        bwd = linear_scan_bwd_cuda if ctx.impl == "cuda" else linear_scan_bwd_reference
        da, db, dh0 = bwd(a, h, h0, gh.contiguous(), ghT)
        if dh0 is not None:
            dh0 = dh0.to(h0.dtype)
        return da, db, dh0, None


def linear_scan(a, b, h0=None, *, impl: Optional[str] = None):
    """(h (B, T, D), h_T (B, D)) for h_t = a_t·h_{t-1} + b_t."""
    return _LinearScan.apply(a, b, h0, resolve_impl(impl, a.device.type))
