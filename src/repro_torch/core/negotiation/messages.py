"""Typed messages of the scheduler↔agent negotiation protocol.

The paper's interaction cycle is a *bidirectional* negotiation: the
scheduler announces execution windows, jobs answer with scored subjob
variants, the clearing awards a subset — and feedback about the clearing
flows BACK to the bidders so they can adapt.  Before this module the cycle
was encoded as loose positional arguments (``windows, now, n_chips``) and
the feedback half did not exist at all.  Each leg is now a frozen value
object:

    WindowAnnouncement ──▶ BidBundle ──▶ (score + clear) ──▶ RoundFeedback
         (step 1)          (steps 2–3)       (step 4)        (step 5 + §4.2.1)

* :class:`WindowAnnouncement` — one round's full window set plus per-slice
  chip counts; what ``JobAgent.respond`` consumes.
* :class:`BidBundle` — one agent's answer, grouped per announced window
  (the grouping is what lets the round pipeline drop an invalidated
  window's bids without regenerating the rest).
* :class:`Award` / :class:`LossReport` — per-bid outcomes inside the
  feedback; losses carry a coarse *reason* so strategies can react
  differently to being outscored vs. colliding with their own wins.
* :class:`RoundFeedback` — the broadcast published by
  ``JasdaScheduler._settle_round`` after every clear: per-window
  winning-score cutoffs, per-job awards/losses, and the §4.2.1 calibration
  state (reliability ρ, mean error ε̄, signed declaration bias) each agent
  needs for online bid shading.

Messages are immutable and value-comparable; :func:`build_feedback` is the
single constructor the scheduler (and baselines/tests) use, so the
feedback contents stay consistent across entry points.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..types import OVERLAP_EPS, PoolView, RoundResult, Variant, Window, overlaps

__all__ = [
    "WindowAnnouncement",
    "BidBundle",
    "Award",
    "LossReport",
    "RoundFeedback",
    "build_feedback",
    "LOSS_OUTSCORED",
    "LOSS_WINDOW_EMPTY",
    "LOSS_SELF_CONFLICT",
    "LOSS_SLICE_FAILED",
    "LOSS_SHED",
    "LOSS_PREEMPTED",
    "MIGRATED",
    "build_shed_feedback",
    "build_migration_feedback",
]


@dataclass(frozen=True)
class WindowAnnouncement:
    """Step 1: the full window set of one auction round.

    ``chips`` maps slice_id → chip count (throughput model input); windows
    keep the announcement order (the WindowPolicy ordering).
    """

    now: float
    windows: Tuple[Window, ...]
    chips: Mapping[str, int] = field(default_factory=dict)

    def chips_for(self, slice_id: str) -> int:
        return int(self.chips.get(slice_id, 1)) if self.chips else 1


@dataclass(frozen=True)
class BidBundle:
    """Steps 2–3: one agent's bids, grouped per announced window.

    ``by_window[k]`` holds the bids targeting ``announcement.windows[k]``
    (possibly empty — condition (a)/(b) failures keep the job silent on
    that window).  An agent may bid the same remaining work on several
    windows; cross-window exclusivity is enforced at clearing time.
    """

    job_id: str
    by_window: Tuple[Tuple[Variant, ...], ...]

    @property
    def variants(self) -> Tuple[Variant, ...]:
        """The flattened pool contribution, in window order."""
        return tuple(v for group in self.by_window for v in group)

    def __len__(self) -> int:
        return sum(len(g) for g in self.by_window)


@dataclass(frozen=True)
class Award:
    """One winning bid: the cleared variant, its window and commit score."""

    variant_id: str
    window: Window
    score: float


#: LossReport.reason values
LOSS_OUTSCORED = "outscored"  # window cleared, rivals' bids won instead
LOSS_WINDOW_EMPTY = "window_empty"  # the whole window cleared empty (→ dead)
# overlaps one of the job's OWN wins: a chain-position alternative yielding
# to the sibling the WIS picked, or a cross-slice duplicate revoked by
# conflict resolution.  NOT a market defeat — adaptive strategies must not
# react to it the way they react to being outscored.
LOSS_SELF_CONFLICT = "self_conflict"
# the slice backing an ALREADY-WON commitment died before execution: the
# win is revoked, the work re-enters the job's biddable pool, and the
# scheduler broadcasts this reason out-of-round (scheduler.revoke_slice).
# Like self_conflict it is NOT a market defeat — the bid price was fine;
# adaptive strategies should re-bid, not shade.
LOSS_SLICE_FAILED = "slice_failed"
# admission control shed the job before it could bid (open-loop service
# back-pressure: the pending pool would have exceeded the largest pow2
# scoring bucket, or a token-bucket rate limit fired).  Broadcast
# out-of-round (scheduler.shed_job / the service engine); the report's
# window is a zero-duration placeholder and its variant_id is the job id —
# no variant was ever generated.  NOT a market defeat: the job never
# priced anything.
LOSS_SHED = "shed"
# the revocation ladder interrupted a RUNNING commitment but credited the
# completed preempt_granularity granules (scheduler.preempt): only the
# residual work re-enters the biddable pool.  Broadcast out-of-round by the
# MigrationPlanner.  Like slice_failed it is NOT a market defeat — the bid
# price was fine; adaptive strategies should re-bid the residual, not shade.
LOSS_PREEMPTED = "preempted"
# the revocation ladder RE-PLACED a commitment's residual work on a
# compatible surviving slice (scheduler.migrate_commitment): the loss row
# retires the old variant id and a paired Award row carries the new
# placement, so bidders' cutoff/calibration state stays honest without the
# work ever leaving the schedule.  NOT a market defeat.
MIGRATED = "migrated"


@dataclass(frozen=True)
class LossReport:
    """One losing bid with a coarse reason and the window's score cutoff.

    ``cutoff`` is the lowest winning score in the bid's window (0.0 when
    the window cleared empty) — the auction-style price signal an adaptive
    bidder shades against.
    """

    variant_id: str
    window: Window
    reason: str
    cutoff: float = 0.0


@dataclass(frozen=True)
class RoundFeedback:
    """Step 5 + §4.2.1: what the clearing tells the bidders afterwards.

    One broadcast per settled round; agents read their own rows (keyed by
    job_id).  ``cutoffs`` maps ``Window.key`` → minimum winning score
    (0.0 for windows that cleared empty).  The calibration maps carry the
    scheduler's CURRENT trust state for every agent in the round —
    reliability ρ_J (Eq. 8), the windowed mean error ε̄, and the signed
    declaration bias (declared − observed EWMA) that bid-shading
    strategies steer to zero.
    """

    t: float
    windows: Tuple[Window, ...]
    cutoffs: Mapping[Tuple[str, float], float]
    awards: Mapping[str, Tuple[Award, ...]]
    losses: Mapping[str, Tuple[LossReport, ...]]
    reliability: Mapping[str, float]
    calibration_error: Mapping[str, float]
    calibration_bias: Mapping[str, float]
    n_selected: int = 0
    n_conflicts: int = 0

    def cutoff_for(self, window: Window) -> float:
        return float(self.cutoffs.get(window.key, 0.0))


def build_feedback(
    now: float,
    windows: Sequence[Window],
    agents: Sequence,
    bids: Sequence[Sequence[Sequence[Variant]]],
    rr: RoundResult,
    calibrator=None,
    *,
    view: Optional[PoolView] = None,
    win_idx=None,
) -> RoundFeedback:
    """Assemble the :class:`RoundFeedback` for one settled round.

    ``bids[a][k]`` are agent a's bids on window k (the RoundPrep layout).
    Variant ids are unique within a round (jobs._make_variant), so the
    winner sets key on them.  ``calibrator`` is the scheduler's
    :class:`~repro.core.calibration.Calibrator` (None in stateless tests:
    the calibration maps come back empty-trust ρ=1).

    When the caller supplies the round's ``view`` (the fitting pool's
    :class:`~repro.core.types.PoolView`) and ``win_idx``, AND the clearing
    reported per-window pool indices (``rr.selected_idx``), the award/loss
    classification runs on numpy columns instead of walking the variant
    objects: agents' bids occupy contiguous pool segments (the RoundPrep
    pooling order), winners are a boolean column, self-conflict detection
    is one pairwise interval matrix per agent.  Classification is
    equivalence-tested against the object walk; any shape mismatch (bids
    dropped by assign_bids, a custom backend without ``selected_idx``)
    falls back to the walk.
    """
    windows = list(windows)
    if (view is not None and win_idx is not None
            and len(rr.selected_idx) == len(windows)
            and len(view) == sum(len(g) for per in bids for g in per)):
        return _build_feedback_vectorized(
            now, windows, agents, bids, rr, calibrator, view, win_idx)
    # per-window winner ids + commit scores, and the cutoff price signal
    won_score: Dict[str, float] = {}
    winners_per_window: List[set] = []
    cutoffs: Dict[Tuple[str, float], float] = {}
    for k, result in enumerate(rr.results):
        ids = set()
        for v, s in zip(result.selected, result.scores):
            ids.add(v.variant_id)
            won_score[v.variant_id] = float(s)
        winners_per_window.append(ids)
        cutoffs[windows[k].key] = float(min(result.scores)) if result.scores else 0.0

    awards: Dict[str, Tuple[Award, ...]] = {}
    losses: Dict[str, Tuple[LossReport, ...]] = {}
    reliability: Dict[str, float] = {}
    calibration_error: Dict[str, float] = {}
    calibration_bias: Dict[str, float] = {}
    for agent, per_window in zip(agents, bids):
        job_id = agent.spec.job_id
        my_awards: List[Award] = []
        my_wins: List[Variant] = []
        lost: List[Tuple[Variant, Window, int]] = []
        for k, group in enumerate(per_window):
            if k >= len(windows):
                break
            for v in group:
                if v.variant_id in winners_per_window[k]:
                    my_awards.append(
                        Award(v.variant_id, windows[k], won_score[v.variant_id])
                    )
                    my_wins.append(v)
                else:
                    lost.append((v, windows[k], k))
        my_losses: List[LossReport] = []
        for v, w, k in lost:
            if not winners_per_window[k]:
                reason = LOSS_WINDOW_EMPTY
            elif any(overlaps(v, win) for win in my_wins):
                # same epsilon-tolerant predicate the clearing itself used,
                # so the classification matches the conflict resolution
                reason = LOSS_SELF_CONFLICT
            else:
                reason = LOSS_OUTSCORED
            my_losses.append(
                LossReport(v.variant_id, w, reason, cutoffs.get(w.key, 0.0))
            )
        if my_awards:
            awards[job_id] = tuple(my_awards)
        if my_losses:
            losses[job_id] = tuple(my_losses)
        if calibrator is not None:
            st = calibrator.state(job_id)
            reliability[job_id] = float(st.rho)
            # the same windowed E_v[ε] that drives ρ (Eq. 7/8), not the
            # full-history mean — the two diverge for long-lived jobs
            calibration_error[job_id] = float(
                st.mean_error(calibrator.config.error_window)
            )
            calibration_bias[job_id] = float(st.bias)
        else:
            reliability[job_id] = 1.0
            calibration_error[job_id] = 0.0
            calibration_bias[job_id] = 0.0
    return RoundFeedback(
        t=now,
        windows=tuple(windows),
        cutoffs=cutoffs,
        awards=awards,
        losses=losses,
        reliability=reliability,
        calibration_error=calibration_error,
        calibration_bias=calibration_bias,
        n_selected=len(rr.selected),
        n_conflicts=rr.n_conflicts,
    )


def build_shed_feedback(now: float, job_ids: Sequence[str],
                        calibrator=None) -> RoundFeedback:
    """Out-of-round feedback for admission-control sheds (``LOSS_SHED``).

    Mirrors the out-of-round broadcast ``scheduler.revoke_slice`` builds
    for ``slice_failed``: one :class:`LossReport` per shed job, empty
    window set (no round ran), a zero-duration placeholder window and the
    job id standing in for the never-generated variant id.  Shared by
    ``JasdaScheduler.shed_job`` (queued jobs evicted under back-pressure)
    and the service engine (arrivals rejected before admission).
    """
    losses: Dict[str, Tuple[LossReport, ...]] = {}
    reliability: Dict[str, float] = {}
    cal_err: Dict[str, float] = {}
    cal_bias: Dict[str, float] = {}
    for job_id in job_ids:
        losses[job_id] = (
            LossReport(job_id, Window("", 0.0, now, 0.0), LOSS_SHED),)
        if calibrator is not None:
            st = calibrator.state(job_id)
            reliability[job_id] = float(st.rho)
            cal_err[job_id] = float(
                st.mean_error(calibrator.config.error_window))
            cal_bias[job_id] = float(st.bias)
        else:
            reliability[job_id] = 1.0
            cal_err[job_id] = 0.0
            cal_bias[job_id] = 0.0
    return RoundFeedback(
        t=now, windows=(), cutoffs={}, awards={}, losses=losses,
        reliability=reliability, calibration_error=cal_err,
        calibration_bias=cal_bias,
    )


def build_migration_feedback(now: float, migrations: Sequence = (),
                             preemptions: Sequence = (),
                             calibrator=None) -> RoundFeedback:
    """Out-of-round feedback for the revocation ladder's first two rungs.

    ``migrations`` rows are ``(job_id, old_variant_id, new_variant_id,
    old_window, new_window, score)``: each emits a ``MIGRATED`` loss
    retiring the old placement plus an :class:`Award` for the new one (the
    commit score carries over — migration is not a re-auction).
    ``preemptions`` rows are ``(job_id, variant_id, window)``: one
    ``LOSS_PREEMPTED`` report each, the residual work having re-entered
    the job's biddable pool.  Mirrors :func:`build_shed_feedback`: empty
    window set (no round ran), calibration state snapshotted per job.
    """
    awards: Dict[str, List[Award]] = {}
    losses: Dict[str, List[LossReport]] = {}
    for job_id, old_vid, new_vid, old_w, new_w, score in migrations:
        losses.setdefault(job_id, []).append(
            LossReport(old_vid, old_w, MIGRATED))
        awards.setdefault(job_id, []).append(
            Award(new_vid, new_w, float(score)))
    for job_id, vid, w in preemptions:
        losses.setdefault(job_id, []).append(
            LossReport(vid, w, LOSS_PREEMPTED))
    reliability: Dict[str, float] = {}
    cal_err: Dict[str, float] = {}
    cal_bias: Dict[str, float] = {}
    for job_id in sorted(set(awards) | set(losses)):
        if calibrator is not None:
            st = calibrator.state(job_id)
            reliability[job_id] = float(st.rho)
            cal_err[job_id] = float(
                st.mean_error(calibrator.config.error_window))
            cal_bias[job_id] = float(st.bias)
        else:
            reliability[job_id] = 1.0
            cal_err[job_id] = 0.0
            cal_bias[job_id] = 0.0
    return RoundFeedback(
        t=now, windows=(), cutoffs={},
        awards={j: tuple(a) for j, a in awards.items()},
        losses={j: tuple(l) for j, l in losses.items()},
        reliability=reliability, calibration_error=cal_err,
        calibration_bias=cal_bias,
    )


def _build_feedback_vectorized(
    now: float,
    windows: List[Window],
    agents: Sequence,
    bids: Sequence[Sequence[Sequence[Variant]]],
    rr: RoundResult,
    calibrator,
    view: PoolView,
    win_idx,
) -> RoundFeedback:
    """PoolView-column award/loss classification (the fast path).

    Pool layout invariant (RoundPrep): bids are pooled agent-major,
    window-major within an agent, and the caller verified nothing was
    dropped by window assignment — so each agent owns one contiguous
    segment of the pool and ``win_idx`` equals each bid's group index.
    Output (tuples, ordering, reasons, cutoffs) is identical to the object
    walk above, which remains the reference (equivalence-tested).
    """
    m = len(view)
    win_k = np.asarray(win_idx, np.intp)
    sel_mask = np.zeros(m, bool)
    score_of = np.zeros(m, np.float64)
    winner_count = np.zeros(len(windows), np.intp)
    cutoffs: Dict[Tuple[str, float], float] = {}
    for k, (sel_idx, result) in enumerate(zip(rr.selected_idx, rr.results)):
        if sel_idx:
            ia = np.asarray(sel_idx, np.intp)
            sel_mask[ia] = True
            score_of[ia] = np.asarray(result.scores, np.float64)
        winner_count[k] = len(sel_idx)
        cutoffs[windows[k].key] = float(min(result.scores)) if result.scores else 0.0

    ts, te = view.t_start, view.t_end
    vids = view.variant_ids
    awards: Dict[str, Tuple[Award, ...]] = {}
    losses: Dict[str, Tuple[LossReport, ...]] = {}
    reliability: Dict[str, float] = {}
    calibration_error: Dict[str, float] = {}
    calibration_bias: Dict[str, float] = {}
    lo = 0
    for agent, per_window in zip(agents, bids):
        job_id = agent.spec.job_id
        n = sum(len(g) for g in per_window)
        seg = np.arange(lo, lo + n)
        lo += n
        if n:
            seg_sel = sel_mask[seg]
            my_sel = seg[seg_sel]
            if len(my_sel):
                awards[job_id] = tuple(
                    Award(vids[i], windows[win_k[i]], float(score_of[i]))
                    for i in my_sel
                )
            loss_idx = seg[~seg_sel]
            if len(loss_idx):
                empty = winner_count[win_k[loss_idx]] == 0
                if len(my_sel):
                    ws, we = ts[my_sel], te[my_sel]
                    ls, le = ts[loss_idx], te[loss_idx]
                    olap = np.any(
                        (ls[:, None] < we[None, :] - OVERLAP_EPS)
                        & (ws[None, :] < le[:, None] - OVERLAP_EPS),
                        axis=1,
                    )
                else:
                    olap = np.zeros(len(loss_idx), bool)
                my_losses = []
                for i, is_empty, is_olap in zip(loss_idx, empty, olap):
                    reason = (LOSS_WINDOW_EMPTY if is_empty
                              else LOSS_SELF_CONFLICT if is_olap
                              else LOSS_OUTSCORED)
                    w = windows[win_k[i]]
                    my_losses.append(
                        LossReport(vids[i], w, reason, cutoffs.get(w.key, 0.0)))
                losses[job_id] = tuple(my_losses)
        if calibrator is not None:
            st = calibrator.state(job_id)
            reliability[job_id] = float(st.rho)
            calibration_error[job_id] = float(
                st.mean_error(calibrator.config.error_window)
            )
            calibration_bias[job_id] = float(st.bias)
        else:
            reliability[job_id] = 1.0
            calibration_error[job_id] = 0.0
            calibration_bias[job_id] = 0.0
    return RoundFeedback(
        t=now,
        windows=tuple(windows),
        cutoffs=cutoffs,
        awards=awards,
        losses=losses,
        reliability=reliability,
        calibration_error=calibration_error,
        calibration_bias=calibration_bias,
        n_selected=len(rr.selected),
        n_conflicts=rr.n_conflicts,
    )
