"""Weighted Interval Scheduling (paper §4.4, `SelectBestCompatibleVariants`).

The per-window clearing step: given M candidate variants, each an interval
[t_start, t_end] with weight Score(v) ≥ 0, select the maximum-total-score
subset of pairwise non-overlapping intervals.

Classical DP after sorting by end time — O(M log M):

    p(j) = largest i < j with end_i <= start_j        (binary search)
    dp[j] = max(dp[j-1], w_j + dp[p(j)])

Two per-window implementations:

* :func:`wis_select`       — numpy host path (the scheduler's default).
* :func:`wis_brute_force`  — O(2^M) oracle for property tests.

Plus the BATCHED multi-window machinery behind the device-resident round
settle (the clearing-side twin of the batched scoring engine):

* :class:`RoundSelector` packs every window's candidate set into a padded
  ``(W, L)`` sorted-lane layout once per round (:meth:`RoundSelector.pack`)
  and clears any subset of windows in ONE dispatch
  (:meth:`RoundSelector.select`), with three backends mirroring
  ``jasda_score``'s contract — host ``numpy`` (float64, byte-identical to
  the per-window loop by construction), the plain ``torch`` version and
  the ``cuda`` kernel (``kernels/wis_dp``).  Shapes are pow2-bucketed on
  both dims, as the reference does.
* :meth:`RoundSelector.predispatch` fuses selection behind the round's
  in-flight scoring dispatch (scores never round-trip through the host);
  the returned :class:`SettlePrefetch` materializes at settle time.
* :func:`make_round_selector` maps the ``SchedulerConfig.wis_impl`` knob to
  a selector (None → the historical per-window :func:`wis_select` loop).

Banned lanes are excluded by ZEROING their weights rather than re-packing:
under the strict ``>`` tie rule a zero-weight lane is never taken and its
presence shifts dp indices without changing any dp value, so zero-weight
banning is exactly equivalent to removing the lane (the conflict
resolution loop re-clears dirty windows from the retained buffers).

Intervals are treated as half-open [start, end): touching intervals
(end_i == start_j) are compatible, matching the paper's worked example where
(40,47) and (47,50) are both selected.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .types import OVERLAP_EPS

__all__ = [
    "wis_select",
    "wis_brute_force",
    "total_weight",
    "RoundSelector",
    "SettlePrefetch",
    "PackedSettle",
    "make_round_selector",
    "predispatch_settle",
    "wis_select_batch",
]


def _validate(starts, ends, weights):
    starts = np.asarray(starts, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    if not (starts.shape == ends.shape == weights.shape):
        raise ValueError("starts/ends/weights must have identical shapes")
    if np.any(ends < starts):
        raise ValueError("interval with end < start")
    if np.any(weights < -1e-12):
        raise ValueError("WIS optimality requires non-negative weights")
    return starts, ends, weights


def wis_select(
    starts: Sequence[float],
    ends: Sequence[float],
    weights: Sequence[float],
) -> Tuple[np.ndarray, float]:
    """Optimal WIS. Returns (selected original indices asc by end, total).

    O(M log M): numpy argsort + searchsorted + a single DP pass.
    """
    starts, ends, weights = _validate(starts, ends, weights)
    m = starts.shape[0]
    if m == 0:
        return np.zeros((0,), dtype=np.int64), 0.0

    order = np.argsort(ends, kind="stable")
    s, e, w = starts[order], ends[order], weights[order]

    # p[j]: number of intervals (in sorted order) ending <= s[j]; dp is
    # 1-indexed with dp[0] = 0 so p[j] indexes dp directly.
    p = np.searchsorted(e, s, side="right")

    dp = np.zeros(m + 1, dtype=np.float64)
    take = np.zeros(m, dtype=bool)
    for j in range(m):
        with_j = w[j] + dp[p[j]]
        if with_j > dp[j]:  # strict: prefer fewer intervals on ties
            dp[j + 1] = with_j
            take[j] = True
        else:
            dp[j + 1] = dp[j]

    # Backtrack.
    sel: List[int] = []
    j = m
    while j > 0:
        if take[j - 1]:
            sel.append(j - 1)
            j = p[j - 1]
        else:
            j -= 1
    sel_sorted = np.array(sel[::-1], dtype=np.int64)
    return order[sel_sorted], float(dp[m])


def wis_brute_force(
    starts: Sequence[float],
    ends: Sequence[float],
    weights: Sequence[float],
) -> Tuple[np.ndarray, float]:
    """Exhaustive oracle (use only for small M in tests)."""
    starts, ends, weights = _validate(starts, ends, weights)
    m = starts.shape[0]
    if m > 22:
        raise ValueError("brute force limited to M <= 22")
    best_mask, best_val = 0, 0.0
    for mask in range(1 << m):
        idx = [i for i in range(m) if mask >> i & 1]
        ok = True
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if (starts[i] < ends[j] - OVERLAP_EPS
                        and starts[j] < ends[i] - OVERLAP_EPS):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            val = float(sum(weights[i] for i in idx))
            if val > best_val + 1e-15:
                best_val, best_mask = val, mask
    sel = np.array([i for i in range(m) if best_mask >> i & 1], dtype=np.int64)
    return sel, best_val


def total_weight(weights: Sequence[float], selected: Sequence[int]) -> float:
    w = np.asarray(weights, dtype=np.float64)
    return float(w[np.asarray(selected, dtype=np.int64)].sum()) if len(selected) else 0.0


# ---------------------------------------------------------------------------
# Batched multi-window settle (device-resident clearing, paper §4.4 batched)
# ---------------------------------------------------------------------------

#: smallest shape buckets for the batched dispatch: the window dim and the
#: lane dim both pad to powers of two
MIN_ROW_BUCKET = 8
MIN_LANE_BUCKET = 32


def _bucket(n: int, lo: int) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


class PackedSettle:
    """Retained padded buffers for one round's batched WIS dispatches.

    ``idx_sorted[k, j]`` is the pool index of window k's j-th candidate in
    ascending-end order (−1 on padded lanes); ``pred`` the predecessor
    table over that order; ``wmat`` the float64 selection weights in the
    same layout (0 on pads).  Sort order and predecessors are computed ONCE
    (float64, stable — identical to the per-window host path); banning only
    zeroes weights, so conflict-resolution re-clears re-dispatch straight
    from these buffers.
    """

    __slots__ = ("members", "idx_sorted", "pred", "wmat", "n_windows",
                 "lanes", "row_len", "_pred_rows")

    def __init__(self, members, idx_sorted, pred, wmat):
        self.members = members
        self.idx_sorted = idx_sorted
        self.pred = pred
        self.wmat = wmat
        self.n_windows = idx_sorted.shape[0]
        self.lanes = idx_sorted.shape[1]
        self.row_len = np.fromiter((len(m) for m in members), np.intp,
                                   count=len(members))
        # lazily materialized python predecessor lists (per-row scalar DP)
        self._pred_rows: list = [None] * self.n_windows

    def pred_row(self, k: int) -> list:
        row = self._pred_rows[k]
        if row is None:
            row = self._pred_rows[k] = self.pred[k, : self.row_len[k]].tolist()
        return row

    def fill_weights(self, sel_scores: np.ndarray) -> None:
        """Gather the (sorted-lane) weight matrix from per-pool scores."""
        sel_scores = np.asarray(sel_scores, np.float64)
        if sel_scores.size == 0:
            self.wmat = np.zeros(self.idx_sorted.shape, np.float64)
            return
        safe = np.clip(self.idx_sorted, 0, None)
        self.wmat = np.where(self.idx_sorted >= 0, sel_scores[safe], 0.0)


class SettlePrefetch:
    """An in-flight fused score→clear first pass (see RoundSelector).

    Holds the retained :class:`PackedSettle` plus the device selection mask
    the fused dispatch is computing; :meth:`materialize` blocks at the host
    boundary and returns (first_pass selections, packed buffers) for the
    fixed-point settle to continue from.

    ``transformed`` records whether the dispatch multiplied the gathered
    scores by the policy's selection transform
    (``ClearingPolicy.prefetch_transform``): a transformed prefetch is only
    valid for a settle that SELECTS on the matching transformed scores, and
    vice versa — ``fixed_point_settle`` checks the flag before adopting the
    first pass.
    """

    def __init__(self, packed: PackedSettle, raw_sel, selector: "RoundSelector",
                 transformed: bool = False):
        self.packed = packed
        self._raw = raw_sel
        self.selector = selector
        self.transformed = transformed

    def materialize(self, scores: np.ndarray):
        packed = self.packed
        # the copy to the host waits for the fused launch; a device fault
        # surfaces here as it is (no silent step down the ladder)
        sel = self._raw.to("cpu").numpy()[: packed.n_windows]
        first_pass = [
            [int(i) for i in packed.idx_sorted[k][np.flatnonzero(sel[k])]]
            for k in range(packed.n_windows)
        ]
        if packed.wmat is None:
            packed.fill_weights(scores)
        return first_pass, packed


def _batch_dp_backtrack_numpy(w: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Float64 batched DP + backtrack, vectorized across windows.

    Per-row arithmetic is EXACTLY :func:`wis_select`'s DP (same float64
    add and strict ``>``; ``max(dp[j], with_j)`` equals the reference's
    conditional copy bit-for-bit, ties included), so selections are
    byte-identical to the per-window host loop.  The python loop runs once
    per LANE for all windows instead of once per candidate per window, in
    lane-major (transposed) layout with preallocated outputs and flat-index
    gathers so each step is a handful of contiguous (W,)-sized kernels.
    """
    r, m = w.shape
    w_t = np.ascontiguousarray(w.T)  # (m, r): lane-major rows
    dp = np.zeros((m + 1, r), np.float64)
    dp1d = dp.reshape(-1)
    # flat offsets of dp[pred[j, row], row] in lane-major dp
    pf_t = np.ascontiguousarray(pred.T.astype(np.intp) * r
                                + np.arange(r, dtype=np.intp)[None, :])
    take_t = np.empty((m, r), bool)
    with_j = np.empty(r, np.float64)
    for j in range(m):
        np.add(w_t[j], dp1d[pf_t[j]], out=with_j)
        np.greater(with_j, dp[j], out=take_t[j])
        np.maximum(with_j, dp[j], out=dp[j + 1])
    # Backtrack with a skip table: prev_take[row, j] = largest position
    # j' ≤ j whose lane j'−1 was taken (0 if none).  The reference walk
    # decrements the cursor through non-taken stretches before selecting —
    # prev_take collapses each stretch into one gather, so every vectorized
    # iteration lands EXACTLY one selection per active row and the loop
    # runs max-selections-per-row times instead of max-lanes times.
    jj = np.arange(1, m + 1, dtype=np.intp)
    prev_take = np.zeros((r, m + 1), np.intp)
    np.maximum.accumulate(np.where(take_t.T, jj[None, :], 0), axis=1,
                          out=prev_take[:, 1:])
    sel = np.zeros((r, m), bool)
    rows = np.arange(r)
    cur = np.full(r, m, np.intp)
    while True:
        j = prev_take[rows, cur]
        act = j > 0
        if not act.any():
            break
        jm1 = np.maximum(j - 1, 0)
        sel[rows[act], jm1[act]] = True
        cur = np.where(act, pred[rows, jm1], 0)
    return sel


class RoundSelector:
    """Batched multi-window WIS selector (the device-resident settle).

    One instance per scheduler (``SchedulerConfig.wis_impl``); stateless
    apart from the backend choice, so it is shared freely across rounds and
    replays.  Also callable with the classic per-window ``(starts, ends,
    weights)`` signature (delegating to :func:`wis_select`) so code written
    against the scalar selector protocol keeps working.
    """

    batched = True

    def __init__(self, impl: str = "numpy", mesh=None, health=None,
                 device=None):
        if impl not in ("numpy", "torch", "cuda"):
            raise ValueError(
                f"wis_impl must be one of 'numpy' | 'torch' | 'cuda', got {impl!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded settle is not ported yet (single device only)")
        self.impl = impl
        # the torch device the device backends run on (the CUDA card unless
        # the caller asks for the CPU); the host backend needs none
        self.torch_device = None
        if impl != "numpy":
            from ..kernels.common import resolve_device

            self.torch_device = resolve_device(device)
        # sticky per-backend health (kernels.common.BackendHealth), shared
        # with the scheduler's scoring dispatches: an injected dispatch
        # fault degrades every future settle down the cuda → torch → numpy
        # ladder
        self.health = health

    def _effective_impl(self) -> str:
        return self.health.resolve(self.impl) if self.health is not None \
            else self.impl

    @property
    def device(self) -> bool:
        return self._effective_impl() in ("torch", "cuda")

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"RoundSelector({self.impl!r}, device={self.torch_device})"

    def __call__(self, starts, ends, weights):
        return wis_select(starts, ends, weights)

    # -- packing ---------------------------------------------------------------
    def pack(self, members, view, sel_scores: Optional[np.ndarray] = None) -> PackedSettle:
        """Pad every window's candidates into the (W, L) sorted-lane layout.

        ``members[k]`` lists window k's pool indices in pool order (the
        same order the per-window host path sees).  Device backends bucket
        lanes to a power of two so drifting per-window pool sizes reuse
        a few shapes; the host backend packs exactly (shorter DP loop).
        """
        w = len(members)
        lens = np.fromiter((len(m) for m in members), np.intp, count=w)
        max_len = int(lens.max()) if w else 1
        lanes = (max(1, max_len) if self.impl == "numpy"
                 else _bucket(max_len, MIN_LANE_BUCKET))
        idx = np.full((w, lanes), -1, np.intp)
        total = int(lens.sum())
        if total:
            import itertools

            flat = np.fromiter(
                itertools.chain.from_iterable(members), np.intp, count=total)
            rows = np.repeat(np.arange(w, dtype=np.intp), lens)
            cum0 = np.concatenate([[0], np.cumsum(lens)[:-1]])
            lane = np.arange(total, dtype=np.intp) - np.repeat(cum0, lens)
            idx[rows, lane] = flat
        valid = idx >= 0
        if total and len(view):
            safe = np.clip(idx, 0, None)
            s = np.where(valid, view.t_start[safe], np.inf)
            e = np.where(valid, view.t_end[safe], np.inf)
        else:  # empty pool: all lanes padded (gathering would index-error)
            s = np.full((w, lanes), np.inf)
            e = np.full((w, lanes), np.inf)
        order = np.argsort(e, axis=1, kind="stable")
        e_s = np.take_along_axis(e, order, axis=1)
        s_s = np.take_along_axis(s, order, axis=1)
        pred = np.empty((w, lanes), np.int32)
        for k in range(w):
            pred[k] = np.searchsorted(e_s[k], s_s[k], side="right")
        idx_sorted = np.take_along_axis(idx, order, axis=1)
        packed = PackedSettle(members, idx_sorted, pred, None)
        if sel_scores is not None:
            packed.fill_weights(sel_scores)
        return packed

    # -- batched selection -----------------------------------------------------
    def select(self, packed: PackedSettle, rows, banned=None) -> List[List[int]]:
        """Clear the given windows in one dispatch → pool indices per row
        (ascending end time, matching :func:`wis_select`'s return order)."""
        return self.select_rows(packed, [(k, banned) for k in rows])

    #: the vectorized host DP pays off once the batch carries at least this
    #: many windows-worth of real lanes per lane step (below it, per-row
    #: scalar DP straight from the packed buffers is cheaper — no pow2 pad
    #: work, no per-step numpy kernel overhead)
    _VECTOR_MIN_ROWS = 6.0

    def select_rows(self, packed: PackedSettle, requests) -> List[List[int]]:
        """Like :meth:`select` but with a per-row banned mask — the form the
        GlobalAssignment lockstep replays use (rows from different candidate
        configurations share the packed buffers but not their bans)."""
        if not requests:
            return []
        if self.impl == "numpy":
            total = int(packed.row_len[[k for k, _ in requests]].sum())
            if total < self._VECTOR_MIN_ROWS * packed.lanes:
                # small batch (conflict re-clears, narrow rounds): scalar DP
                # per row from the retained sort/pred — identical selections
                return [self._select_row_scalar(packed, k, banned)
                        for k, banned in requests]
        rows = [k for k, _ in requests]
        idx_rows = packed.idx_sorted[rows]
        w = packed.wmat[rows]  # fancy indexing copies — safe to mutate
        first_banned = requests[0][1]
        if all(b is first_banned for _, b in requests):
            # common case (one shared ban state): one vectorized masking
            if first_banned is not None and first_banned.any():
                w[(idx_rows >= 0) & first_banned[np.clip(idx_rows, 0, None)]] = 0.0
        else:
            for r, (k, banned) in enumerate(requests):
                if banned is not None and banned.any():
                    bi = idx_rows[r]
                    w[r, (bi >= 0) & banned[np.clip(bi, 0, None)]] = 0.0
        sel = self._dispatch(w, packed.pred[rows])
        # single nonzero + row-split instead of W flatnonzero calls
        sel_rows, sel_lanes = np.nonzero(sel)
        pool_idx = idx_rows[sel_rows, sel_lanes]
        splits = np.searchsorted(sel_rows, np.arange(1, len(requests)))
        return [part.tolist() for part in np.split(pool_idx, splits)]

    @staticmethod
    def _select_row_scalar(packed: PackedSettle, k: int, banned) -> List[int]:
        """One window's WIS from the retained buffers, scalar python DP.

        Skips the re-sort the per-window host path pays on every re-clear
        (order and predecessors were fixed at pack time); python floats ARE
        IEEE float64, so the arithmetic is bit-identical to ``wis_select``.
        """
        n = int(packed.row_len[k])
        if n == 0:
            return []
        idx_row = packed.idx_sorted[k]
        w = packed.wmat[k, :n].tolist()
        if banned is not None and banned.any():
            bi = idx_row[:n]
            bm = (bi >= 0) & banned[np.clip(bi, 0, None)]
            for j in np.flatnonzero(bm):
                w[j] = 0.0
        p = packed.pred_row(k)
        dp = [0.0] * (n + 1)
        take = [False] * n
        for j in range(n):
            with_j = w[j] + dp[p[j]]
            if with_j > dp[j]:
                dp[j + 1] = with_j
                take[j] = True
            else:
                dp[j + 1] = dp[j]
        sel: List[int] = []
        j = n
        while j > 0:
            if take[j - 1]:
                sel.append(j - 1)
                j = p[j - 1]
            else:
                j -= 1
        sel.reverse()
        return [int(idx_row[s]) for s in sel]

    def _dispatch(self, w: np.ndarray, pred: np.ndarray) -> np.ndarray:
        impl = self._effective_impl()
        if impl == "numpy":
            return _batch_dp_backtrack_numpy(w, pred)
        # device path: pad the row dim to its pow2 bucket (zero rows clear
        # empty), as the reference does
        from ..kernels.common import KernelDispatchError
        from ..kernels.wis_dp import ops as wis_ops

        r = w.shape[0]
        rb = _bucket(r, MIN_ROW_BUCKET)
        wp, pp = w, pred
        if rb != r:
            wp = np.concatenate([w, np.zeros((rb - r, w.shape[1]), w.dtype)])
            pp = np.concatenate(
                [pred, np.zeros((rb - r, pred.shape[1]), pred.dtype)])
        # degradation ladder: a backend with an injected dispatch fault is
        # marked sick (sticky) and the dispatch retries one rung down,
        # ending at the host float64 DP, which cannot fail
        while impl != "numpy":
            try:
                sel, _ = wis_ops.wis_settle_batch(
                    wp.astype(np.float32), pp, impl=impl,
                    device=self.torch_device)
                return sel.to("cpu").numpy()[:r]
            except KernelDispatchError as exc:
                if self.health is None:
                    raise
                self.health.mark_failed(impl, str(exc))
                impl = self.health.resolve(impl)
        return _batch_dp_backtrack_numpy(w, pred)

    # -- fused score→clear dispatch (device backends only) ---------------------
    def predispatch(self, n_windows: int, win_idx, view, handle,
                    transform=None) -> Optional["SettlePrefetch"]:
        """Dispatch the ban-free first-pass WIS against IN-FLIGHT scores.

        Called right after ``score_round_async`` while the scoring dispatch
        is still on the device stream: the selection weights are gathered
        from the device scores array, so the round's scores flow into
        clearing without a host round-trip, and the whole score→clear chain
        overlaps the next round's host preparation.  Host-only backends
        return None (nothing to fuse).

        ``transform`` (optional (M,) float32, aligned with the pool) is the
        clearing policy's selection-weight multiplier — gathered scores are
        multiplied in-dispatch, which is what lets score-transforming
        backends (FairShare's age boost) consume the fused path.
        """
        if not self.device:
            return None
        from .policy.base import _pool_members  # lazy: avoids import cycle

        members = _pool_members(n_windows, win_idx)
        packed = self.pack(members, view, None)
        rb = _bucket(n_windows, MIN_ROW_BUCKET)
        idx = packed.idx_sorted
        pred = packed.pred
        if rb != n_windows:
            pad = np.full((rb - n_windows, packed.lanes), -1, idx.dtype)
            idx = np.concatenate([idx, pad])
            pred = np.concatenate(
                [pred, np.zeros((rb - n_windows, packed.lanes), pred.dtype)])
        from ..kernels.wis_dp import ops as wis_ops

        tr = None
        if transform is not None:
            # pad to the bucket-padded device scores (padded rows are
            # masked lanes; 1.0 keeps the gather shape-stable)
            tr = np.ones(int(handle.device_scores.shape[0]), np.float32)
            tr[: len(transform)] = np.asarray(transform, np.float32)
        from ..kernels.common import KernelDispatchError

        try:
            sel, _ = wis_ops.wis_settle_fused(
                handle.device_scores, idx.astype(np.int32), idx >= 0, pred,
                impl=self._effective_impl(), transform=tr)
        except KernelDispatchError as exc:
            # speculation is optional: mark the backend sick and settle
            # without fusion (the settle half re-clears from host scores)
            if self.health is None:
                raise
            self.health.mark_failed(exc.backend, str(exc))
            return None
        return SettlePrefetch(packed, sel, self,
                              transformed=transform is not None)


def predispatch_settle(selector, backend, n_windows: int, win_idx, view,
                       handle, ages=None) -> Optional[SettlePrefetch]:
    """Dispatch the fused first-pass WIS iff every fusion condition holds.

    The ONE eligibility rule shared by every entry point (clear_round, the
    pipelined round stream, the scheduler's prepare half): the selector is
    a device-backed RoundSelector, the scoring dispatch is still in flight,
    and the clearing backend declares ``supports_prefetch``.  Backends that
    SELECT on transformed scores publish the transform through
    ``prefetch_transform(view, ages)`` (None = identity) and it is applied
    in-dispatch, so the fused first pass matches their selection weights.
    Returns None when any condition fails — callers settle without fusion,
    identically.
    """
    if (isinstance(selector, RoundSelector) and selector.device
            and handle is not None and handle.in_flight
            and getattr(backend, "supports_prefetch", False)):
        get_tr = getattr(backend, "prefetch_transform", None)
        transform = get_tr(view, ages) if get_tr is not None else None
        return selector.predispatch(n_windows, win_idx, view, handle,
                                    transform=transform)
    return None


def make_round_selector(impl: Optional[str], mesh=None, health=None,
                        device=None):
    """Map the ``wis_impl`` knob to a selector.

    None → the historical per-window :func:`wis_select` host loop (the
    default: byte-identical, no device involvement); "numpy" → the batched
    float64 host backend (byte-identical by construction, one python DP
    loop per LANE instead of per candidate per window); "torch" / "cuda" →
    the device backends in ``kernels/wis_dp`` (float32 DP, fused score→
    clear launch) on ``device`` (the CUDA card unless the caller asks for
    the CPU).  ``mesh`` sharding is not ported yet and must be None.
    """
    if impl is None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded settle is not ported yet (single device only)")
        return wis_select
    return RoundSelector(impl, mesh=mesh, health=health, device=device)


def wis_select_batch(starts, ends, weights, valid=None, *, impl: str = "numpy",
                     device=None):
    """Batched multi-window WIS over padded (W, L) arrays (test/bench API).

    Returns ``(sel_mask (W, L) bool in ORIGINAL lane order, totals (W,))``.
    Semantically ``wis_select`` applied per row over the valid lanes;
    ``impl`` picks the host float64 path or a device backend ("torch" /
    "cuda", on ``device``: the CUDA card unless asked).  Totals are
    recomputed on the host in float64 for all impls so they are directly
    comparable against the per-window reference.
    """
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    weights = np.asarray(weights, np.float64)
    w, lanes = starts.shape
    if valid is None:
        valid = np.ones((w, lanes), bool)
    valid = np.asarray(valid, bool)

    sel = np.zeros((w, lanes), bool)
    if lanes == 0 or w == 0:
        return sel, np.zeros(w, np.float64)
    s = np.where(valid, starts, np.inf)
    e = np.where(valid, ends, np.inf)
    wt = np.where(valid, weights, 0.0)
    order = np.argsort(e, axis=1, kind="stable")
    e_s = np.take_along_axis(e, order, axis=1)
    s_s = np.take_along_axis(s, order, axis=1)
    w_s = np.take_along_axis(wt, order, axis=1)
    pred = np.empty((w, lanes), np.int32)
    for k in range(w):
        pred[k] = np.searchsorted(e_s[k], s_s[k], side="right")
    if impl == "numpy":
        sel_sorted = _batch_dp_backtrack_numpy(w_s, pred)
    else:
        from ..kernels.wis_dp import ops as wis_ops

        dev_sel, _ = wis_ops.wis_settle_batch(
            w_s.astype(np.float32), pred, impl=impl, device=device)
        sel_sorted = dev_sel.to("cpu").numpy()
    rows = np.repeat(np.arange(w), lanes).reshape(w, lanes)
    sel[rows, order] = sel_sorted
    sel &= valid
    totals = np.where(sel, weights, 0.0).sum(axis=1)
    return sel, totals
