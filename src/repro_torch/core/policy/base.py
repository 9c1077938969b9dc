"""The ``ClearingPolicy`` protocol: the round-clearing objective as an API.

The paper's scheduler performs *policy-driven clearing that balances
utilization, fairness, and temporal responsiveness*; fragmentation-aware
MIG schedulers (arXiv:2512.16099, arXiv:2511.18906) show that the CHOICE of
clearing objective is exactly where those trade-offs are won.  This module
makes the objective a first-class, swappable backend instead of a strategy
baked into free functions:

* a :class:`ClearingPolicy` owns the post-scores half of an auction round —
  per-window selection, cross-window conflict resolution, and tie-breaking
  (Algorithm 1 line 12 + step 12b);
* :func:`fixed_point_settle` is the shared machinery every shipped backend
  builds on: optimal WIS per window plus an iterated conflict-resolution
  loop, parameterized by (a) the scores used for SELECTION (which may be a
  fairness-transformed copy of the reported auction scores) and (b) a
  per-job keep-preference used when revoking conflicting wins (which is how
  a global assignment overrides the greedy keep-best rule).

Shipped backends (one module each):

* :class:`~repro.core.policy.greedy.GreedyWIS` — the default; byte-identical
  to the historical greedy semantics (keep best-scored win, re-clear to
  fixed point).
* :class:`~repro.core.policy.assignment.GlobalAssignment` — searches
  assignments of conflicting jobs to windows (Hungarian seed + exhaustive /
  coordinate-descent refinement) and never clears less total score than
  greedy.
* :class:`~repro.core.policy.fairshare.FairShare` — age/Jain-weighted
  selection: starved jobs are boosted and multi-win jobs discounted so wins
  spread across jobs.

State mutation (commit, ages, calibration) stays the scheduler's job; a
backend is pure given its inputs, which is what lets the round pipeline
replay speculative rounds under ANY policy.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..types import PoolView, RoundResult, Variant, Window
from ..wis import RoundSelector, SettlePrefetch, wis_select

__all__ = ["ClearingPolicy", "fixed_point_settle"]


class ClearingPolicy(abc.ABC):
    """Owns one auction round's clearing objective (selection + conflicts).

    Implementations must be frozen dataclasses (hashable, comparable) so a
    :class:`~repro.core.policy.presets.Policy` embedding one stays a value
    object.  ``settle`` must be pure given its inputs — the round pipeline
    relies on replayability.
    """

    #: short stable identifier used in logs / benchmark rows
    name: str = "abstract"

    #: True when ``settle`` accepts the ``prefetch`` kwarg (an in-flight
    #: fused first-pass WIS from ``core.wis.RoundSelector.predispatch``).
    #: Backends that SELECT on the raw auction scores use the prefetch as
    #: dispatched; backends that transform selection scores publish the
    #: transform through :meth:`prefetch_transform` so it is applied
    #: in-dispatch and the fused first pass matches their selection weights.
    supports_prefetch: bool = False

    def prefetch_transform(self, view, ages):
        """Per-bid float32 selection-weight multiplier for the fused first
        pass, or None (identity — select on the raw scores).

        Called at PREDISPATCH time (before scores materialize), so it may
        only depend on host-known state (``view``, ``ages``).  A backend
        overriding this must select its first pass on
        ``float32(score) * float32(transform)`` — quantized exactly like
        the device gather — for the fused and unfused paths to agree.
        """
        return None

    @abc.abstractmethod
    def settle(
        self,
        windows: Sequence[Window],
        fit: Sequence[Variant],
        win_idx: Sequence[int],
        scores: np.ndarray,
        *,
        selector: Callable = wis_select,
        work_budget: Optional[Mapping[str, float]] = None,
        view: Optional[PoolView] = None,
        ages: Optional[Mapping[str, float]] = None,
    ) -> RoundResult:
        """Clear the scored pool: WIS per window + cross-window resolution.

        ``scores`` are the auction scores reported in the result (commit
        scores, totals); a backend may SELECT on a transformed copy but must
        report the raw values so totals stay comparable across backends.
        ``ages`` maps job_id → A_i(t) ∈ [0,1] for fairness-aware backends.
        """

    def clear_round(
        self,
        windows: Sequence[Window],
        variants: Sequence[Variant],
        scoring,
        **kw,
    ) -> RoundResult:
        """Full-round convenience: score the pool, then settle through self.

        Accepts the same keyword arguments as :func:`repro.core.clearing.
        clear_round` (ages, calibrate, score_impl, recheck_theta,
        per_agent_theta, work_budget, ...).
        """
        from ..clearing import clear_round as _clear_round

        return _clear_round(windows, variants, scoring, clearing=self, **kw)


def _empty_round(windows: Sequence[Window]) -> RoundResult:
    from ..clearing import _empty_round as _impl

    return _impl(windows)


def _pool_members(n_windows: int, win_idx: Sequence[int]) -> List[List[int]]:
    """window → pool indices (pool order), the layout every settle shares.

    Vectorized grouping: a stable argsort of ``win_idx`` yields the pool
    indices grouped by window with pool order preserved within each group —
    identical content to the per-element append loop, at numpy speed.
    """
    win_k = np.asarray(win_idx)
    if win_k.size == 0:
        return [[] for _ in range(n_windows)]
    order = np.argsort(win_k, kind="stable")
    counts = np.bincount(win_k, minlength=n_windows)
    splits = np.cumsum(counts)[:-1]
    return [part.tolist() for part in np.split(order, splits)]


class _FixedPointState:
    """One resumable fixed-point settle (WIS sweeps + conflict resolution).

    Extracted from the former monolithic loop so that (a) dirty windows of
    one pass re-clear in ONE batched dispatch when the selector is a
    :class:`~repro.core.wis.RoundSelector`, and (b) ``GlobalAssignment``
    can drive MANY candidate-configuration replays in lockstep, batching
    every live replay's dirty windows into a single dispatch per
    generation.  Semantics are byte-identical to the original loop (pinned
    by the frozen-reference tests): the state only re-sequences WHO calls
    the selector, never what it selects.
    """

    def __init__(self, windows, fit, win_idx, sel_scores, view, members,
                 selector, packed, work_budget, prefer):
        self.windows = windows
        self.fit = fit
        self.win_idx = win_idx
        self.sel_scores = sel_scores
        self.view = view
        self.members = members
        self.selector = selector
        self.rs = selector if isinstance(selector, RoundSelector) else None
        self.packed = packed
        self.work_budget = work_budget
        self.prefer = prefer
        self.banned = np.zeros(len(fit), dtype=bool)
        self.selected: List[List[int]] = [[] for _ in windows]
        self.dirty: List[int] = list(range(len(windows)))
        self.n_conflicts = 0
        self.active = True  # False once the fixed point is reached

    def seed(self, first_pass: Sequence[Sequence[int]]) -> None:
        """Adopt precomputed ban-free first-pass selections (skip sweep 1)."""
        self.selected = [list(s) for s in first_pass]
        self.dirty = []

    def take_dirty(self) -> List[int]:
        ks, self.dirty = self.dirty, []
        return ks

    def reclear(self, ks: Sequence[int]) -> None:
        """Re-run WIS on the given windows over their unbanned candidates."""
        if not ks:
            return
        if self.rs is not None:
            for k, sel in zip(ks, self.rs.select(self.packed, ks, self.banned)):
                self.selected[k] = sel
            return
        view, sel_scores = self.view, self.sel_scores
        for k in ks:
            idx = [i for i in self.members[k] if not self.banned[i]]
            if not idx:
                self.selected[k] = []
                continue
            ia = np.asarray(idx, np.intp)
            sel, _ = self.selector(view.t_start[ia], view.t_end[ia], sel_scores[ia])
            self.selected[k] = [idx[int(j)] for j in np.asarray(sel)]

    def resolve(self) -> bool:
        """One conflict-resolution pass; True while new bans were issued.

        Per-job win lists across all windows, best score first (preferred
        win first when the backend pinned one); drops cross-window
        overlapping wins and work-budget overruns, marking their windows
        dirty for the next re-clear sweep.  Interval/score reads go through
        the PoolView columns (same float64 values as the variant attrs, at
        array-index cost — replays hit this pass hundreds of times).
        """
        from ..types import OVERLAP_EPS

        fit, win_idx, sel_scores = self.fit, self.win_idx, self.sel_scores
        ts, te = self.view.t_start, self.view.t_end
        job_ids = self.view.job_ids
        eps = OVERLAP_EPS
        prefer, work_budget = self.prefer, self.work_budget
        wins_by_job: Dict[str, List[int]] = {}
        for k, sel in enumerate(self.selected):
            for i in sel:
                wins_by_job.setdefault(job_ids[i], []).append(i)
        newly_banned = False
        for job_id, wins in wins_by_job.items():
            if len(wins) < 2 and work_budget is None:
                continue
            pin = prefer.get(job_id) if prefer is not None else None
            pins = (() if pin is None
                    else (int(pin),) if isinstance(pin, (int, np.integer))
                    else tuple(int(p) for p in pin))
            wins.sort(key=lambda i: (0 if i in pins else 1,
                                     -sel_scores[i], ts[i], win_idx[i]))
            kept: List[int] = []
            used_work = 0.0
            budget = None
            if work_budget is not None:
                budget = work_budget.get(job_id)
            for i in wins:
                drop = any(ts[i] < te[j] - eps and ts[j] < te[i] - eps
                           and win_idx[i] != win_idx[j]
                           for j in kept)
                if not drop and budget is not None:
                    work = float(fit[i].payload["work"]) if fit[i].payload else 0.0
                    if used_work + work > budget + 1e-9:
                        drop = True
                    else:
                        used_work += work
                if drop:
                    self.banned[i] = True
                    newly_banned = True
                    self.n_conflicts += 1
                    if win_idx[i] not in self.dirty:
                        self.dirty.append(win_idx[i])
                else:
                    kept.append(i)
        self.active = newly_banned
        return newly_banned

    def run_to_fixed_point(self) -> "_FixedPointState":
        """Drive reclear/resolve until no new bans are issued; returns self."""
        while True:
            self.reclear(self.take_dirty())
            if not self.resolve():
                return self

    def total(self, scores: np.ndarray) -> float:
        """The cleared total this state would report, WITHOUT packaging.

        Float-sum order replicates :meth:`package` exactly (per-window
        ascending t_start, windows in order, one flat sum) so comparisons
        between replays keep the packaged tie-break semantics bit-for-bit.
        """
        t_start = self.view.t_start
        vals = [float(scores[i])
                for k in range(len(self.windows))
                for i in sorted(self.selected[k], key=t_start.__getitem__)]
        return float(sum(vals))

    def package(self, scores: np.ndarray) -> RoundResult:
        """Per-window results + the flattened commit set (+ pool indices)."""
        from ..types import ClearingResult

        fit, members = self.fit, self.members
        results: List[ClearingResult] = []
        all_selected: List[Variant] = []
        all_scores: List[float] = []
        selected_idx: List[tuple] = []
        for k, w in enumerate(self.windows):
            sel = sorted(self.selected[k], key=lambda i: fit[i].t_start)
            sel_set = set(sel)
            rejected = tuple(fit[i] for i in members[k] if i not in sel_set)
            results.append(
                ClearingResult(
                    window=w,
                    selected=tuple(fit[i] for i in sel),
                    scores=tuple(float(scores[i]) for i in sel),
                    total_score=float(sum(scores[i] for i in sel)),
                    n_bids=len(members[k]),
                    rejected=rejected,
                )
            )
            selected_idx.append(tuple(sel))
            all_selected.extend(fit[i] for i in sel)
            all_scores.extend(float(scores[i]) for i in sel)
        return RoundResult(
            windows=tuple(self.windows),
            results=tuple(results),
            selected=tuple(all_selected),
            scores=tuple(all_scores),
            total_score=float(sum(all_scores)),
            n_bids=len(fit),
            n_conflicts=self.n_conflicts,
            selected_idx=tuple(selected_idx),
        )


def fixed_point_settle(
    windows: Sequence[Window],
    fit: Sequence[Variant],
    win_idx: Sequence[int],
    scores: np.ndarray,
    *,
    selector: Callable = wis_select,
    work_budget: Optional[Mapping[str, float]] = None,
    view: Optional[PoolView] = None,
    select_scores: Optional[np.ndarray] = None,
    prefer: Optional[Mapping[str, int]] = None,
    first_pass_sink: Optional[List[List[int]]] = None,
    first_pass: Optional[Sequence[Sequence[int]]] = None,
    packed=None,
    prefetch: Optional[SettlePrefetch] = None,
) -> RoundResult:
    """WIS per window + iterated cross-window conflict resolution.

    The shared clearing core (Algorithm 1 line 12 and step 12b): each window
    is cleared optimally over its unbanned candidates, then per-job win
    lists across windows are scanned for conflicts — a job holding
    overlapping intervals on two slices, or (with ``work_budget``) more
    total work than it has — and conflicting wins are revoked.  Windows that
    lose a winner are re-cleared within the round; bans grow monotonically,
    so the loop reaches a fixed point in ≤ |pool| passes.

    ``selector`` is either the classic per-window callable (default
    :func:`wis_select`) or a batched :class:`~repro.core.wis.RoundSelector`
    — then every sweep (the ban-free first pass AND each conflict
    re-clear) dispatches ALL its dirty windows at once from retained packed
    buffers instead of looping windows on the host.

    Hooks the backends compose:

    * ``select_scores`` — scores used for SELECTION (WIS weights and the
      keep-priority order in conflict resolution).  Defaults to ``scores``;
      :class:`FairShare` passes an age-boosted transform here while the
      reported ``scores`` stay the raw auction values.
    * ``prefer`` — maps job_id → pool index (or tuple of indices, one per
      disjoint conflict cluster) to keep FIRST when that job's wins
      conflict, overriding the greedy best-score-first rule.  This is the
      primitive :class:`GlobalAssignment` drives its search with; with
      ``prefer=None`` the keep order is exactly the historical greedy semantics
      (byte-identical, pinned by tests).
    * ``first_pass_sink`` — when given a list, it receives the ban-free
      first-pass selections (one list of pool indices per window) before
      conflict resolution starts, so callers that need the pre-resolution
      win structure (conflict-cluster discovery) don't re-run the
      per-window WIS sweep.
    * ``first_pass`` — the inverse: adopt precomputed ban-free first-pass
      selections and skip the initial sweep entirely (the first pass is
      ban-free and prefer-independent, so it is identical across
      ``GlobalAssignment``'s candidate-configuration replays).
    * ``packed`` — retained :class:`~repro.core.wis.PackedSettle` buffers
      to dispatch from (RoundSelector only); lets replays share one pack.
    * ``prefetch`` — an in-flight fused first pass dispatched against the
      round's device scores (``RoundSelector.predispatch``); honored when
      its transform state matches the settle's selection scores — an
      untransformed prefetch needs ``select_scores is None``, a transformed
      one (``prefetch.transformed``) needs the matching transformed
      ``select_scores``.
    """
    windows = list(windows)
    if not fit:
        return _empty_round(windows)
    if view is None:
        view = PoolView.build(fit)
    sel_scores = scores if select_scores is None else np.asarray(select_scores)

    members = (packed.members if packed is not None
               else _pool_members(len(windows), win_idx))
    if (prefetch is not None and first_pass is None
            and getattr(prefetch, "transformed", False)
            == (select_scores is not None)):
        # injected dispatch faults fire at predispatch (which then returns
        # no prefetch); a device fault surfacing here is real and propagates
        first_pass, packed = prefetch.materialize(sel_scores)
        members = packed.members
    rs = selector if isinstance(selector, RoundSelector) else None
    if rs is not None and packed is None:
        packed = rs.pack(members, view, sel_scores)

    st = _FixedPointState(windows, fit, win_idx, sel_scores, view, members,
                          selector, packed, work_budget, prefer)
    if first_pass is not None:
        st.seed(first_pass)

    # fixed point: each pass bans ≥ 1 variant or terminates, so the loop is
    # bounded by the pool size
    first_sweep = True
    while True:
        st.reclear(st.take_dirty())
        if first_sweep:
            first_sweep = False
            if first_pass_sink is not None:
                first_pass_sink.extend(list(s) for s in st.selected)
        if not st.resolve():
            break
    return st.package(scores)
