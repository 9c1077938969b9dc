"""Streaming SLO metrics for the service: O(1)-memory quantiles + counters.

A long-lived service cannot buffer every latency sample, so the p50/p95/
p99 decision-latency quantiles use the P² algorithm (Jain & Chlamtac,
CACM 1985): five markers per quantile, parabolic interpolation on every
observation, no buffers.  The estimator is deterministic given the
observation order — which the service's seeded event loop guarantees —
so two soaks with the same seed produce byte-identical
:class:`ServiceStats` snapshots (the determinism contract tested in
``tests/test_service.py``).

Per-job lifecycle timestamps (admit → first announce → first award →
complete) are kept only while the job is in flight; on completion the
latencies fold into the streaming estimators and the timeline is
dropped, so the metrics footprint stays bounded by the live queue.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["P2Quantile", "JobTimeline", "ServiceMetrics", "ServiceStats"]


class P2Quantile:
    """P² streaming estimator of a single quantile (no sample buffer).

    Jain & Chlamtac's five-marker scheme: marker heights approximate the
    (0, q/2, q, (1+q)/2, 1) quantiles; desired positions advance with
    every observation and heights adjust by a piecewise-parabolic (PP)
    step, falling back to linear when the parabola would cross a
    neighbor.  Until five observations exist the exact order statistic is
    returned.  Picklable; deterministic in observation order.
    """

    __slots__ = ("q", "n", "_heights", "_pos", "_desired", "_incr")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.n = 0
        self._heights: List[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._incr = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if len(self._heights) < 5:
            self._heights.append(x)
            self._heights.sort()
            return
        h = self._heights
        # locate the cell; clamp the extremes to the new observation
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._incr[i]
        # adjust the three interior markers
        for i in (1, 2, 3):
            d = self._desired[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or (
                    d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, s)
                h[i] = hp
                self._pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1])
        )

    def _linear(self, i: int, s: float) -> float:
        h, p = self._heights, self._pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (p[j] - p[i])

    def value(self) -> float:
        """Current estimate (NaN before the first observation)."""
        if not self._heights:
            return float("nan")
        if len(self._heights) < 5 or self.n < 5:
            # exact small-sample order statistic (nearest-rank)
            h = sorted(self._heights)
            idx = min(len(h) - 1, max(0, round(self.q * (len(h) - 1))))
            return h[int(idx)]
        return self._heights[2]


@dataclass
class JobTimeline:
    """Lifecycle timestamps of one in-flight job (service bookkeeping)."""

    admit: float
    announce: Optional[float] = None  # first round the job could bid in
    award: Optional[float] = None  # first award
    complete: Optional[float] = None


@dataclass(frozen=True)
class ServiceStats:
    """Value-comparable snapshot of a service's counters and SLO metrics.

    Latency semantics: ``latency_*`` is admit → first award (the decision
    latency an external submitter observes); ``announce_award_*`` is
    first announce → first award (the pure auction-path latency the
    paper's responsiveness claim is about — it excludes time spent queued
    before the first round).  Goodput counts only COMPLETED jobs' work
    per unit elapsed time, so half-done jobs at the horizon do not
    inflate it.
    """

    t: float
    n_arrived: int
    n_admitted: int
    n_shed: int
    n_cancelled: int
    n_expired: int
    n_completed: int
    n_rounds: int
    n_awards: int
    n_revoked_slices: int
    n_degraded_slices: int
    queue_depth: int
    backlog_work: float
    completed_work: float
    goodput: float
    round_rate: float
    latency_p50: float
    latency_p95: float
    latency_p99: float
    announce_award_p50: float
    announce_award_p95: float
    announce_award_p99: float
    # disruption accounting (the revocation ladder's audit surface),
    # defaulted at the end so pre-migration snapshots stay comparable:
    # commitments preempted with credit / migrated across slices / lost
    # outright, granule-aligned work credited, and the per-reason loss
    # histogram as sorted (reason, count) pairs (value-comparable)
    n_preempted: int = 0
    n_migrated: int = 0
    n_lost_commitments: int = 0
    work_credited: float = 0.0
    loss_reasons: tuple = ()

    def summary(self) -> str:
        return (
            f"t={self.t:.0f} rounds={self.n_rounds} "
            f"arrived={self.n_arrived} admitted={self.n_admitted} "
            f"shed={self.n_shed} completed={self.n_completed} "
            f"queue={self.queue_depth} goodput={self.goodput:.3f} "
            f"p50={self.latency_p50:.1f} p99={self.latency_p99:.1f}"
        )


class ServiceMetrics:
    """Mutable metrics state the engine drives; snapshots to ServiceStats."""

    def __init__(self):
        self.n_arrived = 0
        self.n_admitted = 0
        self.n_shed = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self.n_completed = 0
        self.n_rounds = 0
        self.n_awards = 0
        self.n_revoked_slices = 0
        self.n_degraded_slices = 0
        self.completed_work = 0.0
        self.timelines: Dict[str, JobTimeline] = {}
        self._latency = {q: P2Quantile(q) for q in (0.5, 0.95, 0.99)}
        self._announce_award = {q: P2Quantile(q) for q in (0.5, 0.95, 0.99)}

    # -- lifecycle hooks ---------------------------------------------------
    def admitted(self, job_id: str, now: float) -> None:
        self.n_admitted += 1
        self.timelines[job_id] = JobTimeline(admit=now)

    def announced(self, job_id: str, now: float) -> None:
        tl = self.timelines.get(job_id)
        if tl is not None and tl.announce is None:
            tl.announce = now

    def awarded(self, job_id: str, now: float) -> bool:
        """Record an award; returns True on the job's FIRST award (the
        decision-latency sample)."""
        self.n_awards += 1
        tl = self.timelines.get(job_id)
        if tl is None or tl.award is not None:
            return False
        tl.award = now
        for est in self._latency.values():
            est.observe(now - tl.admit)
        base = tl.announce if tl.announce is not None else tl.admit
        for est in self._announce_award.values():
            est.observe(now - base)
        return True

    def completed(self, job_id: str, now: float, work: float) -> None:
        self.n_completed += 1
        self.completed_work += float(work)
        tl = self.timelines.pop(job_id, None)
        if tl is not None:
            tl.complete = now

    def dropped(self, job_id: str) -> None:
        """Forget a job that left without completing (shed/cancel/expire)."""
        self.timelines.pop(job_id, None)

    # -- snapshot ----------------------------------------------------------
    def snapshot(self, now: float, *, queue_depth: int,
                 backlog_work: float, n_preempted: int = 0,
                 n_migrated: int = 0, n_lost_commitments: int = 0,
                 work_credited: float = 0.0,
                 loss_reasons: tuple = ()) -> ServiceStats:
        elapsed = max(now, 1e-9)
        return ServiceStats(
            t=float(now),
            n_arrived=self.n_arrived,
            n_admitted=self.n_admitted,
            n_shed=self.n_shed,
            n_cancelled=self.n_cancelled,
            n_expired=self.n_expired,
            n_completed=self.n_completed,
            n_rounds=self.n_rounds,
            n_awards=self.n_awards,
            n_revoked_slices=self.n_revoked_slices,
            n_degraded_slices=self.n_degraded_slices,
            queue_depth=int(queue_depth),
            backlog_work=float(backlog_work),
            completed_work=float(self.completed_work),
            goodput=float(self.completed_work / elapsed),
            round_rate=float(self.n_rounds / elapsed),
            latency_p50=self._latency[0.5].value(),
            latency_p95=self._latency[0.95].value(),
            latency_p99=self._latency[0.99].value(),
            announce_award_p50=self._announce_award[0.5].value(),
            announce_award_p95=self._announce_award[0.95].value(),
            announce_award_p99=self._announce_award[0.99].value(),
            n_preempted=int(n_preempted),
            n_migrated=int(n_migrated),
            n_lost_commitments=int(n_lost_commitments),
            work_credited=float(work_credited),
            loss_reasons=tuple(loss_reasons),
        )
