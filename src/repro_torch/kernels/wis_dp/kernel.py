"""Batched WIS DP + backtrack as a hand-written CUDA kernel (K2).

Replaces ``repro/kernels/wis_dp/kernel.py::wis_batch_pallas`` (body
``_batch_kernel``) plus the fused gather ``repro/kernels/wis_dp/ops.py::
_fused_weights``.  Source: ``kernels/csrc/wis_batch.cu`` (its header says
what bounds it on an H100 and what the design does about it): one block
per window stages the row (gather × transform × mask folded into the
load) in shared memory, or in a global scratch buffer once a row outgrows
the block's shared memory, and one thread runs the sequential float32 DP
and the backtrack.

``wis_batch_cuda`` launches on ``torch.cuda.current_stream()`` -- the
stream the scoring kernel ran on -- so the fused first pass reads the
in-flight score tensor with no host copy.  For tensors that lie on the CPU
it runs the plain torch version (ref.py) instead; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import fused_weights, wis_batch_reference

__all__ = ["wis_batch_cuda", "LAUNCHES", "SHAPES"]

#: kernel launches (the wrapper adds one where it launches, nowhere else)
LAUNCHES = {"wis_batch": 0}
#: (W, L, fused, transformed) -> launches at that shape
SHAPES: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wis_batch_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "wis_batch_row_bytes": [_I],
    "wis_batch_smem_limit": [_I, ctypes.POINTER(ctypes.c_int)],
}
_SMEM_LIMIT: dict = {}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("wis_batch", _SIGNATURES)


def smem_limit(device: torch.device) -> int:
    """Largest dynamic shared memory (bytes) a block may opt into."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMEM_LIMIT:
        out = ctypes.c_int(0)
        check_launch(_lib().wis_batch_smem_limit(index, ctypes.byref(out)),
                     "wis_batch_smem_limit")
        _SMEM_LIMIT[index] = int(out.value)
    return _SMEM_LIMIT[index]


def row_bytes(lanes: int) -> int:
    """Staging bytes one window row needs (w, pred, dp, take)."""
    return int(_lib().wis_batch_row_bytes(lanes))


def uses_shared_memory(lanes: int, device: torch.device) -> bool:
    """True when a row of ``lanes`` lanes is staged in shared memory."""
    return row_bytes(lanes) <= smem_limit(device)


def wis_batch_cuda(pred: torch.Tensor, *, weights: Optional[torch.Tensor] = None,
                   scores: Optional[torch.Tensor] = None,
                   idx: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   transform: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sel (W, L) bool, totals (W,) f32) for (W, L) sorted lanes.

    Pass ``weights`` (W, L) f32, or the fused operands ``scores`` (M_pad,)
    f32 + ``idx`` (W, L) i32 + ``mask`` (W, L) bool (+ ``transform``
    (M_pad,) f32).  ``pred`` is (W, L) int32.
    """
    fused = weights is None
    if fused and (scores is None or idx is None or mask is None):
        raise ValueError("fused settle needs scores, idx and mask")
    device = pred.device
    if device.type == "cpu":
        w = fused_weights(scores, idx, mask, transform) if fused else weights
        return wis_batch_reference(w, pred)

    n_rows, lanes = pred.shape
    check_tensor(pred, "pred", torch.int32, (n_rows, lanes), device)
    m_pad = 0
    if fused:
        m_pad = int(scores.shape[0])
        if m_pad == 0:
            raise ValueError("fused settle needs a non-empty score vector")
        check_tensor(scores, "scores", torch.float32, (m_pad,), device)
        check_tensor(idx, "idx", torch.int32, (n_rows, lanes), device)
        check_tensor(mask, "mask", torch.bool, (n_rows, lanes), device)
        if transform is not None:
            check_tensor(transform, "transform", torch.float32, (m_pad,), device)
    else:
        check_tensor(weights, "weights", torch.float32, (n_rows, lanes), device)

    sel = torch.empty((n_rows, lanes), dtype=torch.bool, device=device)
    totals = torch.empty((n_rows,), dtype=torch.float32, device=device)
    if n_rows == 0 or lanes == 0:
        return sel, totals.zero_()
    scratch = None
    if not uses_shared_memory(lanes, device):
        scratch = torch.empty((n_rows * row_bytes(lanes),), dtype=torch.uint8,
                              device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().wis_batch_launch(
        ptr(weights), ptr(scores), ptr(transform), ptr(idx), ptr(mask),
        pred.data_ptr(), n_rows, lanes, m_pad, sel.data_ptr(),
        totals.data_ptr(), ptr(scratch), torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "wis_batch")
    LAUNCHES["wis_batch"] += 1
    key = (n_rows, lanes, fused, transform is not None)
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return sel, totals
