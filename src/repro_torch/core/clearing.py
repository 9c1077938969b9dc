"""Auction-round clearing (paper §4.4, Algorithm 1, batched across windows).

The round model generalizes the paper's per-window iteration: one round
announces ALL open windows, pools every job's bids, scores the pooled set in
ONE batched dispatch (scoring.score_round → kernels/jasda_score), then runs
the optimal WIS selection per window plus cross-window conflict resolution:

    1:    announce W = {w_1..w_K} to all jobs          (windows.py)
    4:    each job generates eligible variants over W  (jobs.py)
    6-8:  Score(v) = λ ĥ(v) + (1−λ) f̃_sys(v)           (one batched call)
    11:   V = ∪_J ∪_w V_{J,w}
    12:   per window: Ŝ_w = SelectBestCompatibleVariants(V_w, Score)
    12b:  cross-window resolution — a job winning overlapping intervals on
          two slices (or more total work than it has) keeps only its
          best-scored wins; freed capacity is re-cleared within the round
          until a fixed point (bans grow monotonically, so ≤ |V| passes).
    13:   commit ∪_w Ŝ_w, update layout and statistics (scheduler.py)

Steps 12/12b — the clearing OBJECTIVE — are owned by a pluggable
:class:`repro.core.policy.ClearingPolicy` backend: :func:`clear_round` and
:func:`settle_round` dispatch through the ``clearing`` argument (default
``GreedyWIS``, byte-identical to the historical hardwired path) rather than
baking one strategy in.  See ``repro.core.policy`` for the shipped backends
(``GreedyWIS`` / ``GlobalAssignment`` / ``FairShare``) and the unified
``Policy`` presets.

:func:`clear_window` is the single-window special case (the paper's original
Algorithm 1) and remains the numpy reference path; the scheduler's ``step()``
compatibility wrapper and the equivalence tests pin round == legacy on one
window.  All functions are pure given their inputs; state mutation (commit,
age updates, calibration) is the scheduler's job.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .scoring import ScoringPolicy, score_pool, score_round_async
from .types import (OVERLAP_EPS, TIME_EPS, ClearingResult, PoolView,
                    RoundResult, Variant, Window)
from .wis import make_round_selector, predispatch_settle, wis_select

__all__ = ["clear_window", "clear_round", "assign_bids", "settle_round"]


def clear_window(
    window: Window,
    variants: Sequence[Variant],
    policy: ScoringPolicy,
    *,
    ages: Optional[Mapping[str, float]] = None,
    calibrate: Optional[Callable[[Variant, float], float]] = None,
    extra_sys: Optional[Callable[[Variant], Mapping[str, float]]] = None,
    selector: Callable = wis_select,
) -> ClearingResult:
    """Score the pooled bids and clear w* optimally (Algorithm 1 lines 6–12).

    ``selector`` is pluggable so benchmarks can swap the numpy DP for the
    JAX/Pallas paths; all return identical selections (tested).
    """
    variants = [v for v in variants if _fits(v, window)]
    if not variants:
        return ClearingResult(
            window=window, selected=(), scores=(), total_score=0.0, n_bids=0
        )

    scores = score_pool(
        variants, window, policy, ages=ages, calibrate=calibrate, extra_sys=extra_sys
    )
    starts = np.array([v.t_start for v in variants])
    ends = np.array([v.t_end for v in variants])
    sel_idx, total = selector(starts, ends, scores)
    sel_set = set(int(i) for i in np.asarray(sel_idx))
    selected = [variants[i] for i in sorted(sel_set, key=lambda i: variants[i].t_start)]
    rejected = [v for i, v in enumerate(variants) if i not in sel_set]
    return ClearingResult(
        window=window,
        selected=tuple(selected),
        scores=tuple(float(scores[i]) for i in sorted(sel_set, key=lambda i: variants[i].t_start)),
        total_score=float(total),
        n_bids=len(variants),
        rejected=tuple(rejected),
    )


def _fits(v: Variant, w: Window, eps: float = TIME_EPS) -> bool:
    """Clearing-side sanity: variant must lie inside the announced window."""
    return (
        v.slice_id == w.slice_id
        and v.t_start >= w.t_min - eps
        and v.t_end <= w.t_end + eps
        and v.duration > 0
    )


def _overlap(a: Variant, b: Variant, eps: float = OVERLAP_EPS) -> bool:
    return a.t_start < b.t_end - eps and b.t_start < a.t_end - eps


def assign_bids(
    windows: Sequence[Window],
    variants: Sequence[Variant],
    view: Optional[PoolView] = None,
) -> Tuple[List[Variant], np.ndarray, PoolView]:
    """Assign each pooled bid to the (unique) window containing it.

    Windows on one slice are disjoint idle gaps, so a variant fits at most
    one; first-fit in window order keeps the assignment deterministic.
    Vectorized over the pool: builds (or reuses) a :class:`PoolView` and
    tests containment per window with numpy masks instead of a
    per-variant python loop.  Returns ``(fit, win_idx, fit_view)`` — the
    fitting subset in pool order, the window index each bid targets, and
    the aligned struct-of-arrays view the downstream pack/WIS stages reuse.
    """
    if view is None:
        view = PoolView.build(variants)
    m = len(view)
    if m == 0:
        return [], np.zeros(0, np.intp), view
    slice_code = {w.slice_id: None for w in windows}
    for i, sid in enumerate(slice_code):
        slice_code[sid] = i
    codes = np.asarray(
        [slice_code.get(s, -1) for s in view.slice_ids], np.intp
    )
    eps = TIME_EPS
    assigned = np.full(m, -1, np.intp)
    for k, w in enumerate(windows):
        mask = (
            (assigned < 0)
            & (codes == slice_code[w.slice_id])
            & (view.t_start >= w.t_min - eps)
            & (view.t_end <= w.t_end + eps)
            & (view.duration > 0)
        )
        assigned[mask] = k
    fit_idx = np.nonzero(assigned >= 0)[0]
    fit_view = view.take(fit_idx)
    return fit_view.variants, assigned[fit_idx], fit_view


def _empty_round(windows: Sequence[Window]) -> RoundResult:
    empty = [
        ClearingResult(window=w, selected=(), scores=(), total_score=0.0, n_bids=0)
        for w in windows
    ]
    return RoundResult(tuple(windows), tuple(empty), (), (), 0.0, 0)


def _default_clearing():
    """Module-level GreedyWIS singleton (lazy: avoids an import cycle)."""
    global _GREEDY
    if _GREEDY is None:
        from .policy import GreedyWIS

        _GREEDY = GreedyWIS()
    return _GREEDY


_GREEDY = None


def clear_round(
    windows: Sequence[Window],
    variants: Sequence[Variant],
    policy: ScoringPolicy,
    *,
    ages: Optional[Mapping[str, float]] = None,
    calibrate: Optional[Callable[[Variant, float], float]] = None,
    selector: Callable = wis_select,
    work_budget: Optional[Mapping[str, float]] = None,
    score_impl: Optional[str] = None,
    recheck_theta: Optional[float] = None,
    per_agent_theta: bool = False,
    grid: int = 32,
    grid_cache=None,
    clearing=None,
    wis_impl: Optional[str] = None,
    mesh=None,
    device=None,
) -> RoundResult:
    """Clear one batched auction round over ALL announced windows.

    Scores the pooled bids in a single batched dispatch, then settles the
    round through the ``clearing`` backend (a ``repro.core.policy.
    ClearingPolicy``; default ``GreedyWIS`` — per-window WIS plus greedy
    cross-window conflict resolution, byte-identical to the historical
    behavior).  ``work_budget`` maps job_id → biddable work so a job never
    wins more total work than it has.

    ``recheck_theta`` re-verifies safety condition (a) in-dispatch against
    each bid's own window capacity (scoring.score_round);
    ``per_agent_theta`` uses each bid's OWN agent θ (``Variant.theta``)
    instead of one scheduler-wide bound.  ``grid_cache`` reuses FMP grid
    discretizations across rounds.  The dispatch/settle halves are exposed
    separately (:func:`assign_bids`, scoring's ``score_round_async``,
    :func:`settle_round`) so the round pipeline can overlap them across
    consecutive rounds.

    ``wis_impl`` selects the settle-side WIS backend (overrides
    ``selector``): None = the per-window host loop, "numpy" = batched host
    float64, "torch"/"cuda" = the device-resident batched settle
    (``kernels/wis_dp``: the plain torch version or the CUDA kernel).
    With a device backend the ban-free first WIS pass is FUSED behind the
    scoring launch — selection weights are gathered from the still-in-
    flight device scores, no host round-trip.  ``device`` is where the
    device backends run: the CUDA card unless the caller asks for the CPU
    (``"cpu"``).

    ``mesh`` (a ``launch.mesh.Mesh``, e.g. ``launch.mesh.
    make_auction_mesh()``) splits the pooled-bid rows of the scoring launch
    and the window rows of the device settle into equal shards, one a mesh
    device, launched from this one process — byte-identical to
    single-device clearing (cross-window conflict resolution stays
    host-side and global).  The device backends then run on the mesh's
    devices.  Only meaningful with a device ``wis_impl``/``score_impl``;
    ignored by host paths.

    Returns a :class:`RoundResult`; ``results`` aligns with ``windows``.
    """
    windows = list(windows)
    if not windows:
        return RoundResult((), (), (), (), 0.0, 0)
    if wis_impl is not None:
        selector = make_round_selector(wis_impl, mesh=mesh, device=device)

    fit, win_idx, fit_view = assign_bids(windows, variants)
    if not fit:
        return _empty_round(windows)

    # -- one batched scoring call over the pooled bids (lines 6–8) ------------
    handle = score_round_async(
        fit, windows, win_idx, policy,
        ages=ages, calibrate=calibrate, impl=score_impl,
        recheck_theta=recheck_theta, per_agent_theta=per_agent_theta,
        grid=grid, grid_cache=grid_cache,
        view=fit_view, mesh=mesh, device=device,
    )
    backend = clearing if clearing is not None else _default_clearing()
    prefetch = predispatch_settle(
        selector, backend, len(windows), win_idx, fit_view, handle,
        ages=ages)
    return settle_round(
        windows, fit, win_idx, handle.result(),
        selector=selector, work_budget=work_budget, view=fit_view,
        clearing=backend, ages=ages, prefetch=prefetch,
    )


def settle_round(
    windows: Sequence[Window],
    fit: Sequence[Variant],
    win_idx: Sequence[int],
    scores: np.ndarray,
    *,
    selector: Callable = wis_select,
    work_budget: Optional[Mapping[str, float]] = None,
    view: Optional[PoolView] = None,
    clearing=None,
    ages: Optional[Mapping[str, float]] = None,
    prefetch=None,
) -> RoundResult:
    """The post-scores half of :func:`clear_round`, dispatched through the
    ``clearing`` backend (default ``GreedyWIS``): WIS per window plus
    cross-window conflict resolution (Algorithm 1 line 12 and step 12b).
    Pure given its inputs; the pipeline calls it once the in-flight scores
    of a dispatched round materialize.  ``view`` (the struct-of-arrays form
    of ``fit`` from :func:`assign_bids`) lets the per-window WIS passes
    gather interval arrays instead of re-walking the variant objects;
    ``ages`` feeds fairness-aware backends (ignored by ``GreedyWIS``).
    ``prefetch`` (an in-flight fused first-pass WIS from
    ``RoundSelector.predispatch``) is forwarded only to backends that
    declare ``supports_prefetch`` — custom backends with the original
    settle signature keep working unchanged.
    """
    backend = clearing if clearing is not None else _default_clearing()
    kw = {}
    if prefetch is not None and getattr(backend, "supports_prefetch", False):
        kw["prefetch"] = prefetch
    return backend.settle(
        windows, fit, win_idx, scores,
        selector=selector, work_budget=work_budget, view=view, ages=ages,
        **kw,
    )
