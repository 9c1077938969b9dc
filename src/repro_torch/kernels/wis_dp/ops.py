"""Batched WIS settle dispatch: one launch clears every window of a round.

The port's counterpart of the batched half of ``repro/kernels/wis_dp/
ops.py``.  ``wis_settle_batch`` / ``wis_settle_fused`` are the forms behind
the batched round settle (core/wis.py ``RoundSelector``).  Weights and
predecessor tables are runtime operands and shapes are pow2-bucketed by
the caller.  The fused form gathers its weights from the IN-FLIGHT score
tensor of the round's scoring launch, on the same stream, so scores flow
into selection without a host round-trip.

Backends: ``"cuda"`` is the hand-written kernel (kernel.py), ``"torch"``
its plain torch version (ref.py).  The single-window ``wis_dp`` /
``wis_clear`` forms (the TPU package's third kernel) and mesh sharding are
not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..common import build_counts as _build_counts
from ..common import check_dispatch_fault, resolve_device
from .kernel import LAUNCHES as _CUDA_LAUNCHES
from .kernel import wis_batch_cuda
from .ref import fused_weights, wis_batch_reference

__all__ = ["wis_settle_batch", "wis_settle_fused", "build_counts",
           "launch_counts"]


def build_counts() -> dict:
    """nvcc builds of the settle kernel in this process (at most one)."""
    return {"cuda": _build_counts().get("wis_batch", 0)}


def launch_counts() -> dict:
    """Launches of the settle kernel so far (the wrapper's counter)."""
    return {"cuda": _CUDA_LAUNCHES["wis_batch"]}


def _impl_for(impl: Optional[str], dev: torch.device) -> str:
    if impl is None:
        impl = "cuda" if dev.type == "cuda" else "torch"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"settle impl must be 'cuda' or 'torch', got {impl!r}")
    return impl


def _on(x, dtype, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev, dtype=dtype)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded settle is not ported yet (single device only)")


def wis_settle_batch(weights, pred, *, impl: Optional[str] = None,
                     device=None, mesh=None):
    """Batched multi-window WIS: (W, L) sorted weights/pred → (sel, totals).

    Rows are windows, lanes candidates sorted ascending by end time (the
    host pack in core/wis.py produces the layout); padded / banned lanes
    carry weight 0 and are never selected under the strict ``>`` rule.
    Returns torch tensors on ``device`` (the card unless asked), in flight.
    """
    _no_mesh(mesh)
    dev = resolve_device(device)
    impl = _impl_for(impl, dev)
    shape = tuple(int(s) for s in np.shape(weights))
    check_dispatch_fault(impl, "wis_settle_batch", shape)
    w = _on(weights, torch.float32, dev)
    p = _on(pred, torch.int32, dev)
    if impl == "torch":
        return wis_batch_reference(w, p)
    return wis_batch_cuda(p, weights=w)


def wis_settle_fused(scores, idx, mask, pred, *, impl: Optional[str] = None,
                     mesh=None, transform=None):
    """Fused score→clear launch: gather weights from IN-FLIGHT scores.

    ``scores`` is the (M_pad,) float32 tensor of a scoring launch (still in
    flight); it fixes the device.  ``idx``/``mask``/``pred`` are the
    host-built (W, L) sorted-lane layout (pool index per lane, validity,
    predecessor counts).  The launch follows the scoring kernel on the same
    stream, so selection never waits on a device→host→device round-trip.
    ``transform`` (optional (M_pad,) float32) multiplies each gathered
    score -- the clearing policy's selection transform.  Returns the
    in-flight (sel, totals) pair.
    """
    _no_mesh(mesh)
    if not isinstance(scores, torch.Tensor):
        raise TypeError("wis_settle_fused gathers from the scoring launch's "
                        "torch tensor")
    dev = scores.device
    impl = _impl_for(impl, dev)
    shape = tuple(int(s) for s in np.shape(idx))
    check_dispatch_fault(impl, "wis_settle_fused", shape)
    scores = scores.to(torch.float32).contiguous()
    i = _on(idx, torch.int32, dev)
    msk = _on(mask, torch.bool, dev)
    p = _on(pred, torch.int32, dev)
    tr = None if transform is None else _on(transform, torch.float32, dev)
    if impl == "torch":
        return wis_batch_reference(fused_weights(scores, i, msk, tr), p)
    return wis_batch_cuda(p, scores=scores, idx=i, mask=msk, transform=tr)
