"""WIS DP kernels in hand-written CUDA: batched settle (K2), single window (K3).

Replaces ``repro/kernels/wis_dp/kernel.py::wis_batch_pallas`` (body
``_batch_kernel``) plus the fused gather ``repro/kernels/wis_dp/ops.py::
_fused_weights``.  Source: ``kernels/csrc/wis_batch.cu`` (its header says
what bounds it on an H100 and what the design does about it): one block
per window stages the row (gather × transform × mask folded into the
load) in shared memory, or in a global scratch buffer once a row outgrows
the block's shared memory; one thread runs the sequential float32 DP with
its loads issued a few steps ahead, and the whole block backtracks by
pointer doubling (rows with a taken zero-length interval keep the
lane-by-lane walk).  ``ref.py`` models both steps for the tests.

``wis_dp_cuda`` (K3) replaces ``wis_dp_pallas`` (body ``_dp_kernel``): the
forward DP of one window, (dp, take) for M end-sorted lanes, from the same
source file.  It is bound by its chain of M dependent steps, not by bytes
or operations, and runs K2's pipelined forward on one thread.  Only dp
stays resident in shared memory; the lanes stream through a small ring,
bulk-copied by a producer thread and converted by a warp.  Past one
block's ~55k lanes a cluster of up to 8 blocks splits dp across their
shared memory and hands the chain on at each boundary; past that, dp goes
to a global scratch.  ``wis_dp_plan`` names the branch, chosen from M and
the device's limits before the launch and never after a failure; the C
entry ``wis_dp_launch_on`` takes a branch to force.
``ref.py::wis_dp_stream_reference`` models the kernel for the tests.

Both launch on ``torch.cuda.current_stream()`` -- for ``wis_batch_cuda``
the stream the scoring kernel ran on, so the fused first pass reads the
in-flight score tensor with no host copy.  For tensors that lie on the CPU
they run the plain torch versions (ref.py) instead; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import fused_weights, wis_batch_reference, wis_dp_reference

__all__ = ["wis_batch_cuda", "wis_dp_cuda", "wis_dp_plan", "DP_PATHS",
           "LAUNCHES", "SHAPES"]

#: kernel launches (the wrapper adds one where it launches, nowhere else)
LAUNCHES = {"wis_batch": 0, "wis_dp": 0}
#: (W, L, fused, transformed) -> launches of K2; ("wis_dp", M) -> of K3
SHAPES: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wis_batch_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "wis_batch_launch_paths": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                               _P, _P],
    "wis_batch_row_bytes": [_I],
    "wis_batch_smem_limit": [_I, ctypes.POINTER(ctypes.c_int)],
    "wis_dp_launch_on": [_I, _P, _P, _I, _P, _P, _P, _P],
    "wis_dp_plan": [_I, _I, ctypes.POINTER(ctypes.c_int)],
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


#: K3's branches by the number ``wis_dp_plan`` gives them
DP_PATHS = ("shared", "cluster", "global scratch")


def wis_dp_plan(lanes: int, path: int = -1) -> Tuple[int, int, int, int]:
    """K3's launch plan for a window of ``lanes`` lanes on the current
    device: (branch, blocks in the cluster, lanes a block owns, shared bytes
    a block).  The branch is 0 for one block with dp in its shared memory,
    1 for a cluster of blocks splitting dp across theirs, 2 for dp in a
    global scratch buffer.  ``path`` -1 chooses as the launch does; 0, 1, 2
    force that branch and raise if it cannot take ``lanes``."""
    plan = (ctypes.c_int * 4)()
    check_launch(_lib().wis_dp_plan(lanes, path, plan), "wis_dp_plan")
    return tuple(int(v) for v in plan)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel bulk-copies its operands in 16-byte pieces
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wis_dp_cuda(weights: torch.Tensor, pred: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dp (M,) f32, take (M,) bool) for (M,) end-sorted f32 weights and
    int32 predecessor counts, on the branch :func:`wis_dp_plan` chooses."""
    device = weights.device
    if device.type == "cpu":
        return wis_dp_reference(weights, pred)

    lanes = int(weights.shape[0]) if weights.dim() == 1 else -1
    if lanes < 0:
        raise ValueError(f"weights: expected (M,), got {tuple(weights.shape)}")
    check_tensor(weights, "weights", torch.float32, (lanes,), device)
    check_tensor(pred, "pred", torch.int32, (lanes,), device)
    dp = torch.empty((lanes,), dtype=torch.float32, device=device)
    take = torch.empty((lanes,), dtype=torch.int32, device=device)
    if lanes == 0:
        return dp, take.bool()
    scratch = None
    if wis_dp_plan(lanes)[0] == 2:  # the launch plans the same again
        scratch = torch.empty((lanes + 1,), dtype=torch.float32, device=device)
    weights, pred = _aligned(weights), _aligned(pred)  # held past the launch
    err = _lib().wis_dp_launch_on(
        -1, weights.data_ptr(), pred.data_ptr(), lanes,
        dp.data_ptr(), take.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "wis_dp")
    LAUNCHES["wis_dp"] += 1
    key = ("wis_dp", lanes)
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return dp, take.bool()
