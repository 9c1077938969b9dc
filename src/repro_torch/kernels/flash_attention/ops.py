"""Dispatch wrapper for flash attention.

The port's counterpart of ``repro/kernels/flash_attention/ops.py``.
``flash_attention`` picks the implementation:

  * ``impl="cuda"``   — the hand-written kernel (kernel.py); for tensors on
                        the CPU the wrapper runs the plain version
  * ``impl="torch"``  — the materialised-softmax version (ref.py), on any
                        device
  * ``impl=None``     — ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise

The reference's names land on their twins: ``"pallas"`` → ``"cuda"`` and
``"xla"`` → ``"torch"``.  ``block_q`` / ``block_k`` are accepted for the
reference's signature and ignored: the kernel's tiles are fixed and it
takes any Sq and Sk.  A kernel that fails to build or launch raises;
nothing falls back to the plain version.
"""
from __future__ import annotations

from typing import Optional

from .kernel import check_rows_see_keys, mha_cuda
from .ref import mha_reference

__all__ = ["flash_attention", "resolve_impl"]

_ALIASES = {"pallas": "cuda", "xla": "torch"}


def resolve_impl(impl: Optional[str], device_type: str) -> str:
    """The port's backend for a reference or port impl name."""
    if impl is None:
        return "cuda" if device_type == "cuda" else "torch"
    impl = _ALIASES.get(impl, impl)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown impl {impl}")
    return impl


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None,
                    q_offset: int = 0, impl: Optional[str] = None,
                    block_q: int = 128, block_k: int = 128):
    """Attention over (B, H, S, D) layouts; ``q_offset`` is q[0]'s position."""
    del block_q, block_k  # the reference's tile sizes; see the module doc
    if resolve_impl(impl, q.device.type) == "cuda":
        return mha_cuda(q, k, v, causal=causal, window=window, scale=scale,
                        q_offset=q_offset)
    check_rows_see_keys(q.shape[2], k.shape[2], causal=causal, window=window,
                        q_offset=q_offset)
    return mha_reference(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)
