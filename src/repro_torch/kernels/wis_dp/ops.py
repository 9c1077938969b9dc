"""WIS dispatch: the batched round settle and the single-window clear.

The port's counterpart of ``repro/kernels/wis_dp/ops.py``.
``wis_settle_batch`` / ``wis_settle_fused`` are the forms behind the
batched round settle (core/wis.py ``RoundSelector``).  Weights and
predecessor tables are runtime operands and shapes are pow2-bucketed by
the caller.  The fused form gathers its weights from the IN-FLIGHT score
tensor of the round's scoring launch, on the same stream, so scores flow
into selection without a host round-trip.

``wis_dp`` / ``wis_clear`` are the single-window forms: the forward DP of
one window on the device (K3), with the float64 stable sort, the
``searchsorted`` predecessors and the backtrack on the host, as in the
reference.

Backends: ``"cuda"`` is the hand-written kernel (kernel.py), ``"torch"``
its plain torch version (ref.py); for the single-window forms the
reference's ``"pallas"`` lands on ``"cuda"`` and ``"ref"`` on ``"torch"``.

``mesh`` (a 1-axis auction mesh, ``launch/mesh.py``) splits the window
rows of the batched settle into equal shards, one a mesh device: each
shard clears its rows independently (the per-row DP never crosses rows),
so the sharded launch is byte-identical to the single-device one.  The
fused form keeps the score vector (and transform) whole on every shard's
device -- a lane of any window may index any pool row -- and splits only
``idx``, ``mask`` and ``pred``.  Results are concatenated on the first
mesh device.  A mesh of one device, or one that does not divide the
rows, takes the unsharded launch.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...distributed.sharding import sharded_launch
from ..common import build_counts as _build_counts
from ..common import check_dispatch_fault, resolve_device
from .kernel import LAUNCHES as _CUDA_LAUNCHES
from .kernel import wis_batch_cuda, wis_dp_cuda
from .ref import fused_weights, wis_batch_reference, wis_dp_reference

__all__ = ["wis_settle_batch", "wis_settle_fused", "wis_dp", "wis_clear",
           "build_counts", "launch_counts"]


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


def _launch_settle(impl: str, p, *, w=None, scores=None, idx=None,
                   mask=None, transform=None):
    """One launch over the rows of ``p``: (sel, totals)."""
    if impl == "torch":
        if w is None:
            w = fused_weights(scores, idx, mask, transform)
        return wis_batch_reference(w, p)
    return wis_batch_cuda(p, weights=w, scores=scores, idx=idx, mask=mask,
                          transform=transform)


def wis_settle_batch(weights, pred, *, impl: Optional[str] = None,
                     device=None, mesh=None):
    """Batched multi-window WIS: (W, L) sorted weights/pred → (sel, totals).

    Rows are windows, lanes candidates sorted ascending by end time (the
    host pack in core/wis.py produces the layout); padded / banned lanes
    carry weight 0 and are never selected under the strict ``>`` rule.
    Returns torch tensors on ``device`` (the card unless asked; the first
    mesh device with a ``mesh``), in flight.
    """
    dev = resolve_device(device, mesh)
    impl = _impl_for(impl, dev)
    shape = tuple(int(s) for s in np.shape(weights))
    check_dispatch_fault(impl, "wis_settle_batch", shape)
    w = _on(weights, torch.float32, dev)
    p = _on(pred, torch.int32, dev)
    return sharded_launch(mesh, dev, int(p.shape[0]), {"p": p, "w": w}, {},
                          functools.partial(_launch_settle, impl))


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
    return sharded_launch(mesh, dev, int(p.shape[0]),
                          {"p": p, "idx": i, "mask": msk},
                          {"scores": scores, "transform": tr},
                          functools.partial(_launch_settle, impl))


_DP_ALIASES = {"pallas": "cuda", "ref": "torch"}


def wis_dp(weights, pred, *, impl: Optional[str] = None, device=None):
    """(M,) end-sorted weights + predecessor counts → (dp (M,), take (M,) bool).

    Tensors stay where they lie; arrays go to ``device`` (the card unless
    asked).  ``impl`` None is ``"cuda"`` on the card, ``"torch"`` on the CPU.
    """
    dev = weights.device if isinstance(weights, torch.Tensor) \
        else resolve_device(device)
    impl = _impl_for(_DP_ALIASES.get(impl, impl), dev)
    w = _on(weights, torch.float32, dev)
    p = _on(pred, torch.int32, dev)
    if impl == "torch":
        return wis_dp_reference(w, p)
    return wis_dp_cuda(w, p)


def wis_clear(starts, ends, weights, *, impl: Optional[str] = None,
              device=None) -> Tuple[np.ndarray, float]:
    """Optimal WIS over one window: (selected indices, total) as the host
    ``core.wis.wis_select`` returns them, with the DP on ``device``."""
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    weights = np.asarray(weights, np.float64)
    m = starts.shape[0]
    if m == 0:
        return np.zeros((0,), np.int64), 0.0

    order = np.argsort(ends, kind="stable")
    s, e, w = starts[order], ends[order], weights[order]
    pred = np.searchsorted(e, s, side="right").astype(np.int32)

    dp, take = wis_dp(w.astype(np.float32), pred, impl=impl, device=device)
    dp = dp.cpu().numpy()
    take = take.cpu().numpy()

    sel = []
    j = m
    while j > 0:
        if take[j - 1]:
            sel.append(j - 1)
            j = pred[j - 1]
        else:
            j -= 1
    sel = np.array(sel[::-1], dtype=np.int64)
    return order[sel], float(dp[-1])
