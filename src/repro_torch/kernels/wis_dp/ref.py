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

``wis_forward_pipelined_reference`` and ``wis_backtrack_doubling_reference``
model how the CUDA kernel computes the same results (csrc/wis_batch.cu,
steps 2-4 of its header): the forward DP with its loads issued ``depth``
steps ahead and a register ring of the last ``depth`` dp values, and the
backtrack by pointer doubling with the bounded walk kept for rows whose
predecessors climb.  ``wis_dp_stream_reference`` models the single-window
kernel K3 (the section of csrc/wis_batch.cu after K2): its lanes streamed
through a ring of stages, dp split across the blocks of a cluster, the
chain handed on at each block boundary.  Only tests call them (the card
tests in ``tests/test_torch_card_kernels.py`` among them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["wis_dp_reference", "wis_batch_reference", "fused_weights",
           "wis_forward_reference", "climbing_rows",
           "wis_forward_pipelined_reference", "wis_backtrack_doubling_reference",
           "wis_dp_stream_reference"]


def wis_forward_reference(weights: torch.Tensor, pred: torch.Tensor):
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
    dp, take = wis_forward_reference(weights.to(torch.float32)[None, :],
                                     pred[None, :])
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
    dp, take = wis_forward_reference(weights.to(torch.float32), pred)
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


def wis_forward_pipelined_reference(weights: torch.Tensor, pred: torch.Tensor,
                                    depth: int, *,
                                    dp0: Optional[torch.Tensor] = None,
                                    lanes=None):
    """The kernel's forward DP: (dp (W, L+1), take (W, L)), as
    :func:`wis_forward_reference`.

    Step j's dp[pred] is loaded ``depth`` steps early, at step j - depth
    right after that step stored dp[j - depth + 1], so it serves
    d = j - pred >= depth - 1, and a pred past j reads the still-zero
    entry.  d in [1, depth - 2] is picked one step ahead from the last dp
    values (registers in the kernel).  A lane with d = 0 carries w+ =
    fmax(w, 0) and its step is dp[j] + w+; any other step is fmax(w +
    dp[pred], dp[j]) -- the reference's bits either way, since dp is never
    NaN or -0.  take is read back from dp as dp[j+1] > dp[j].  Rows shorter
    than 2 depth, and the last steps of longer ones, read dp from the table
    directly, as the kernel's unpipelined tail.

    ``dp0`` (W,) is dp[0] (0 by default: K3's later blocks start from the
    dp handed to them).  ``lanes``, if given, is told where the kernel
    reads its lanes: ``lanes.window(j, 2 depth)`` where it reads lanes j ..
    j + 2 depth - 1 (every lane before j read), ``lanes.at(j)`` where it
    reads lane j alone (see :func:`wis_dp_stream_reference`).
    """
    w_rows, n = weights.shape
    p = pred.to(torch.int64).clamp(0, n)
    zero = torch.zeros((w_rows,), dtype=torch.float32)
    pos = torch.arange(n)
    w = weights.to(torch.float32)
    w = torch.where(p == pos, torch.fmax(w, zero[:, None]), w)  # staged w+
    dp = torch.zeros((w_rows, n + 1), dtype=torch.float32)
    if dp0 is not None:
        dp[:, 0] = dp0

    def load(step):  # dp[pred] of ``step`` as the table holds it now
        return dp.gather(1, p[:, step][:, None])[:, 0]

    span = 2 * depth
    body = (n - span) // span * span if n >= span else 0
    if body and lanes is not None:
        lanes.window(0, span)
    loaded = [load(u) for u in range(depth)] if body else []
    back = [zero] * depth  # back[k] = dp[j - 1 - k]
    cur = dp[:, 0].clone()  # dp[j]
    b = w[:, 0] + loaded[0] if body else zero  # step j's w + dp[pred]
    for j in range(n):
        if lanes is not None:
            if j >= body:
                lanes.at(j)
            elif j % span == 0:
                lanes.window(j + span, span)
        if j < body:
            nxt = torch.where(p[:, j] == j, cur + w[:, j], torch.fmax(b, cur))
            dp[:, j + 1] = nxt
            loaded[j % depth] = load(j + depth)  # after the store
            # step j + 1's w + dp[pred] (the kernel forms it before this
            # step's chain; its slot is another one unless depth = 1)
            d1 = j + 1 - p[:, j + 1]
            p1 = loaded[(j + 1) % depth]
            for k in range(depth - 2, 1, -1):
                p1 = torch.where(d1 == k, back[k - 2], p1)
            if depth >= 3:
                p1 = torch.where(d1 == 1, cur, p1)
            back = [cur] + back[:-1]
            cur, b = nxt, w[:, j + 1] + p1
        else:
            v = torch.where(p[:, j] > j, zero, load(j))
            cur = torch.where(p[:, j] == j, cur + w[:, j],
                              torch.fmax(w[:, j] + v, cur))
            dp[:, j + 1] = cur
    return dp, dp[:, 1:] > dp[:, :-1]


class _Ring:
    """K3's ring of ``stages`` slots of ``stage_lanes`` lanes for one block's
    ``n`` lanes, as the kernel runs it: stage t lands in slot t % stages
    once the chain has freed stage t - stages (the producer issues the
    first ``stages`` at once); the chain frees the stage before one it
    enters.  Raises AssertionError where the kernel would read a lane that
    has not landed or was freed, read a window across two stages, or wait
    on a stage the producer cannot issue (a deadlock)."""

    def __init__(self, n: int, stage_lanes: int, stages: int):
        self.size, self.stages = stage_lanes, stages
        self.n_stages = -(-n // stage_lanes)
        self.slot = [-1] * stages  # the stage each slot holds
        self.issued = 0
        self.freed = 0  # stages [0, freed) handed back to the producer
        self.entered = -1  # the stage the chain reads from
        self._issue()

    def _issue(self):
        while self.issued < min(self.n_stages, self.freed + self.stages):
            self.slot[self.issued % self.stages] = self.issued
            self.issued += 1

    def _enter(self, t: int, free: bool):
        if free and t > 0:
            assert self.freed == t - 1, "the chain frees stages in order"
            self.freed = t
            self._issue()
        assert t < self.issued, f"ring deadlock: the chain waits on stage {t}"
        self.entered = t

    def _read(self, j: int):
        t = j // self.size
        assert t == self.entered and t >= self.freed, \
            f"lane {j} read outside the stage the chain holds"
        assert self.slot[t % self.stages] == t, f"lane {j}: slot overwritten"

    def window(self, j: int, count: int):
        t = j // self.size
        assert (j + count - 1) // self.size == t, "a window spans two stages"
        if t != self.entered:
            self._enter(t, free=True)
        for x in range(j, j + count):
            self._read(x)

    def at(self, j: int):
        t = j // self.size
        if t != self.entered:
            self._enter(t, free=False)
        self._read(j)


def wis_dp_stream_reference(weights: torch.Tensor, pred: torch.Tensor,
                            depth: int, *, lanes_per_rank: Optional[int] = None,
                            stage_lanes: int = 384, stages: int = 4,
                            stats: Optional[dict] = None):
    """K3's single-window forward DP as the kernel computes it: (dp (M,),
    take (M,) bool), as :func:`wis_dp_reference`.

    The window is split into blocks of ``lanes_per_rank`` lanes (all M in
    one block by default), block r owning lanes [r S, r S + S) and dp[r S ..
    r S + S] in its own table.  Block by block, as the chain is handed on:
    the converter clamps pred to [0, M] and a pred past j to j + 1 (a dp
    entry still zero), and for a pred in an earlier block folds that
    block's final dp[pred] into w (the plain version's float32 add) and
    points the lane at dp[j + 1]; the chain runs
    :func:`wis_forward_pipelined_reference` on the block's own table from
    the dp handed to it, its lanes read through :class:`_Ring`.  take is
    dp[j+1] > dp[j], as the kernel writes it.  ``stats``, if given,
    receives the blocks, the preds folded and the stages streamed.
    """
    m = int(weights.shape[0])
    span = lanes_per_rank or max(m, 1)
    assert stage_lanes % (2 * depth) == 0 and stage_lanes >= 4 * depth
    w_all = weights.to(torch.float32)
    p_all = pred.to(torch.int64).clamp(0, m)
    parts = []  # parts[q]: block q's dp[q S .. q S + n_q]
    folded = streamed = 0
    for base in range(0, m, span):
        n = min(span, m - base)
        j = torch.arange(base, base + n)
        p = torch.minimum(p_all[base:base + n], j + 1)
        w = w_all[base:base + n].clone()
        remote = p < base
        if remote.any():
            q = p[remote] // span  # the block that owns dp[p], and its slot
            w[remote] = w[remote] + torch.stack(parts)[q, p[remote] - q * span]
            p = torch.where(remote, j + 1, p)
            folded += int(remote.sum())
        ring = _Ring(n, stage_lanes, stages)
        handed = parts[-1][-1:] if parts else None  # the hand-off
        dp, _ = wis_forward_pipelined_reference(
            w[None], (p - base)[None], depth, dp0=handed, lanes=ring)
        parts.append(dp[0])
        streamed += ring.n_stages
    if stats is not None:
        stats.update(blocks=len(parts), folded=folded, stages=streamed)
    if not parts:
        return (torch.zeros((0,), dtype=torch.float32),
                torch.zeros((0,), dtype=torch.bool))
    dp = torch.cat([parts[0]] + [part[1:] for part in parts[1:]])
    return dp[1:], dp[1:] > dp[:-1]


def climbing_rows(take: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(W,) bool: rows where some taken lane's predecessor lies past it.

    Only a zero-length interval has pred[j] > j and can be taken (padded
    lanes also have pred = L but weigh 0).  The kernel backtracks these
    rows with the bounded lane-by-lane walk, every other row by pointer
    doubling.
    """
    lanes = take.shape[1]
    pos = torch.arange(lanes, device=take.device)
    return (take & (pred.to(torch.int64).clamp(0, lanes) > pos)).any(dim=1)


def wis_backtrack_doubling_reference(take: torch.Tensor,
                                     pred: torch.Tensor) -> torch.Tensor:
    """The kernel's backtrack: the selection mask (W, L) from take and pred.

    Rows outside :func:`climbing_rows`: with
    next(x) = take[x-1] ? pred[x-1] : x-1 and next(0) = 0, ceil(log2 L)
    rounds of "mark J[m] for every marked m; J <- J o J" from mark = {L},
    then sel[x-1] = mark[x] & take[x-1].  Other rows: the bounded L-step
    cursor walk, marking each cursor position it visits.
    """
    w_rows, lanes = take.shape
    p = pred.to(torch.int64).clamp(0, lanes)
    pos = torch.arange(lanes)
    climbing = climbing_rows(take, pred)
    jump = torch.zeros((w_rows, lanes + 1), dtype=torch.int64)
    jump[:, 1:] = torch.where(take, p, pos)
    mark = torch.zeros((w_rows, lanes + 1), dtype=torch.int64)
    mark[:, lanes] = 1
    span = 1
    while span < lanes:
        hit = mark * (jump > 0)
        mark = mark.scatter_reduce(1, jump, hit, reduce="amax")
        jump = jump.gather(1, jump)
        span *= 2
    rows = torch.nonzero(climbing)[:, 0]
    if len(rows):
        walk = torch.zeros((len(rows), lanes + 1), dtype=torch.int64)
        j = torch.full((len(rows),), lanes, dtype=torch.int64)
        r = torch.arange(len(rows))
        for _ in range(lanes):
            active = j > 0
            walk[r, j] |= active.to(torch.int64)
            jm1 = (j - 1).clamp(min=0)
            nxt = torch.where(take[rows, jm1], p[rows, jm1], j - 1)
            j = torch.where(active, nxt, j)
        mark[rows] = walk
    return mark[:, 1:].bool() & take
