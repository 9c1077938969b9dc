"""Plain torch versions of the WIS clearing DP (paper §4.4).

Counterparts of ``repro/kernels/wis_dp/ref.py``.  They operate on
intervals ALREADY sorted by end time with precomputed predecessors p(j):

    dp[0] = 0;  dp[j+1] = w[j] + dp[p[j]] if that is strictly > dp[j], else dp[j]
    take[j] = (w[j] + dp[p[j]] > dp[j])

``wis_batch_reference`` is the multi-window form behind the batched
settle: DP *and* backtrack for a whole ``(W, L)`` padded round.  It loops
over lanes, vectorised over windows, in float32 -- the same sequence of
rounded adds the CUDA kernel (csrc/wis_batch.cu) runs per window, so
totals are bit-equal.  The backtrack is the bounded cursor walk (at most L
steps) of the reference.  Padded / banned lanes carry weight 0: with the
strict ``>`` rule a zero-weight lane is never taken.

``fused_weights`` is the gather of ``repro/kernels/wis_dp/ops.py::
_fused_weights``: selection weights from the (bucket-padded) score vector,
times an optional float32 transform, under the lane mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["wis_dp_reference", "wis_batch_reference", "fused_weights"]


def _forward(weights: torch.Tensor, pred: torch.Tensor):
    """(W, L) float32 weights + int predecessors → (dp (W, L+1), take (W, L))."""
    w_rows, lanes = weights.shape
    dp = torch.zeros((w_rows, lanes + 1), dtype=torch.float32,
                     device=weights.device)
    take = torch.zeros((w_rows, lanes), dtype=torch.bool, device=weights.device)
    p = pred.to(torch.int64).clamp(0, lanes)
    for j in range(lanes):
        with_j = weights[:, j] + dp.gather(1, p[:, j:j + 1])[:, 0]
        t = with_j > dp[:, j]
        take[:, j] = t
        dp[:, j + 1] = torch.where(t, with_j, dp[:, j])
    return dp, take


def wis_dp_reference(weights: torch.Tensor, pred: torch.Tensor):
    """(M,) weights, (M,) predecessor counts → (dp (M,), take (M,) bool)."""
    dp, take = _forward(weights.to(torch.float32)[None, :], pred[None, :])
    return dp[0, 1:], take[0]


def wis_batch_reference(weights: torch.Tensor,
                        pred: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-window DP + backtrack.

    Args:
      weights: (W, L) float32, sorted by end time per row, 0 on padded /
        banned lanes.
      pred: (W, L) int32 predecessor counts per row (indexes dp[0..L]).

    Returns:
      (sel (W, L) bool selection mask in SORTED lane order,
       total (W,) float32 optimal totals).
    """
    w_rows, lanes = weights.shape
    dp, take = _forward(weights.to(torch.float32), pred)
    p = pred.to(torch.int64).clamp(0, lanes)
    sel = torch.zeros((w_rows, lanes), dtype=torch.bool, device=weights.device)
    rows = torch.arange(w_rows, device=weights.device)
    j = torch.full((w_rows,), lanes, dtype=torch.int64, device=weights.device)
    for _ in range(lanes):
        active = j > 0
        jm1 = (j - 1).clamp(min=0)
        t = active & take[rows, jm1]
        sel[rows, jm1] |= t
        j = torch.where(active, torch.where(t, p[rows, jm1], j - 1), j)
    return sel, dp[:, lanes]


def fused_weights(scores: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                  transform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather (W, L) selection weights from the in-flight score vector."""
    safe = idx.to(torch.int64).clamp(0, scores.shape[0] - 1)
    w = scores[safe].to(torch.float32)
    if transform is not None:
        w = w * transform[safe].to(torch.float32)
    return torch.where(mask, w, torch.zeros((), dtype=torch.float32,
                                            device=w.device))
