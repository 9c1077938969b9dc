"""Baseline schedulers for the comparison study (paper §6(a) future work).

The port's copy of ``repro/core/baselines.py`` (numpy only, unchanged).

The paper positions JASDA against schedulers that treat jobs as
"indivisible, monolithic entities".  We implement four such baselines behind
the same scheduler interface the simulator drives, so all systems run on
identical workloads, slices, and execution noise:

* ``FifoScheduler``        — strict arrival order; head-of-line blocking.
* ``BackfillScheduler``    — EASY backfill: FIFO head gets a reservation,
                             later jobs may jump ahead iff they do not delay it.
* ``BestFitScheduler``     — greedy: each free slice takes the waiting job
                             with minimal leftover capacity (bin-packing flavour).
* ``AuctionScheduler``     — Themis-flavoured monolithic auction: jobs bid
                             whole-job utilities each round, highest bid wins
                             the slice for its FULL runtime (no atomization).

All baselines schedule whole jobs as single non-preemptive blocks — the
delta to JASDA is therefore exactly (i) atomization + (ii) variant bidding +
(iii) optimal per-window clearing, which is what the study isolates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .jobs import JobAgent
from .trp import is_safe, predict_duration
from .types import ClearingResult, Commitment, RoundResult, SliceSpec, Variant, Window
from .windows import SliceTimeline

__all__ = [
    "MonolithicScheduler",
    "FifoScheduler",
    "BackfillScheduler",
    "BestFitScheduler",
    "AuctionScheduler",
]


class MonolithicScheduler:
    """Common machinery: whole-job commitments on slice timelines.

    ``policy`` optionally accepts the same unified ``repro.core.policy.
    Policy`` object JASDA takes, so comparison sweeps can hand every system
    one configuration: monolithic baselines have no variants to clear, so
    only the safety bound applies (a scheduler-wide ``recheck_theta``
    overrides ``theta``, mirroring JASDA's precedence); everything else is
    ignored by construction.
    """

    name = "monolithic"

    def __init__(self, slices: Sequence[SliceSpec], *, theta: float = 0.05,
                 policy=None):
        if policy is not None and getattr(policy, "recheck_theta", None) is not None:
            theta = policy.recheck_theta
        self.policy = policy
        self.slices: Dict[str, SliceTimeline] = {
            s.slice_id: SliceTimeline(s) for s in slices
        }
        self.agents: Dict[str, JobAgent] = {}
        self.commitments: List[Commitment] = []  # outstanding only
        # running totals (simulator metrics): commitments prune on settle
        self.n_committed_total: int = 0
        self.committed_score_total: float = 0.0
        self.retired_intervals: Dict[str, List] = {}
        self._queue: List[str] = []  # arrival order
        self.theta = theta

    # -- membership (simulator interface) -----------------------------------
    def add_job(self, agent: JobAgent, now: float) -> None:
        self.agents[agent.spec.job_id] = agent
        self._queue.append(agent.spec.job_id)

    def remove_job(self, job_id: str) -> None:
        self.agents.pop(job_id, None)
        if job_id in self._queue:
            self._queue.remove(job_id)

    def add_slice(self, spec: SliceSpec) -> None:
        self.slices[spec.slice_id] = SliceTimeline(spec)

    def drop_slice(self, slice_id: str, now: Optional[float] = None) -> List[Commitment]:
        tl = self.slices.pop(slice_id, None)
        if tl is not None:
            ivs = tl.busy()
            if now is not None:
                ivs = [(s0, min(e0, now)) for s0, e0 in ivs if s0 < now]
            self.retired_intervals.setdefault(slice_id, []).extend(ivs)
        lost = [c for c in self.commitments if c.variant.slice_id == slice_id]
        self.commitments = [c for c in self.commitments if c.variant.slice_id != slice_id]
        return lost

    def complete(self, variant: Variant, observed, *, observed_utility=None,
                 work_done=None, actual_end=None) -> float:
        # settle the commitment so a partially-done job (runtime overran its
        # committed block → tail work lost) can re-enter the waiting queue
        self.commitments = [c for c in self.commitments if c.variant is not variant]
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.record_progress(
                work_done if work_done is not None else variant.payload["work"]
            )
        if actual_end is not None and actual_end < variant.t_end - 1e-9:
            tl = self.slices.get(variant.slice_id)
            if tl is not None:
                tl.release(variant.t_start, variant.t_end)
                tl.commit(variant.t_start, actual_end)
        return 0.0

    def fail(self, variant: Variant, now: float) -> None:
        self.commitments = [c for c in self.commitments if c.variant is not variant]
        tl = self.slices.get(variant.slice_id)
        if tl is not None:
            tl.release(variant.t_start, variant.t_end)
            occupied_until = min(now, variant.t_end)
            if occupied_until > variant.t_start:
                tl.commit(variant.t_start, occupied_until)
        # monolithic: the WHOLE job restarts (nothing was checkpointed)
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.work_done = 0.0
            if variant.job_id not in self._queue:
                self._queue.append(variant.job_id)

    # -- round API (simulator interface) --------------------------------------
    def run_round(self, now: float) -> Optional[RoundResult]:
        """Drive the baseline's step() to quiescence for one scheduler tick.

        Monolithic baselines have no batched auction; a "round" is the
        legacy greedy loop (bounded like the pre-round simulator driver was)
        packaged behind the same interface JASDA's round exposes, so the
        simulator drives every scheduler uniformly.
        """
        results: List[ClearingResult] = []
        selected: List[Variant] = []
        budget = 3 * max(len(self.slices), 1)
        while budget > 0:
            budget -= 1
            res = self.step(now)
            if res is None:
                break
            results.append(res)
            selected.extend(res.selected)
        if not results:
            return None
        return RoundResult(
            windows=tuple(r.window for r in results),
            results=tuple(results),
            selected=tuple(selected),
            scores=tuple(s for r in results for s in r.scores),
            total_score=float(sum(r.total_score for r in results)),
            n_bids=sum(r.n_bids for r in results),
        )

    def utilization(self, t_from: float, t_to: float) -> Dict[str, float]:
        out = {}
        span = max(t_to - t_from, 1e-9)
        intervals: Dict[str, list] = {
            sid: list(tl.busy()) for sid, tl in self.slices.items()
        }
        for sid, ivs in self.retired_intervals.items():
            intervals.setdefault(sid, []).extend(ivs)
        for sid, ivs in intervals.items():
            busy = sum(max(0.0, min(e, t_to) - max(s, t_from)) for s, e in ivs)
            out[sid] = busy / span
        return out

    # -- helpers --------------------------------------------------------------
    def _waiting(self) -> List[JobAgent]:
        out = []
        committed = {c.variant.job_id for c in self.commitments}
        for jid in self._queue:
            a = self.agents.get(jid)
            if a is not None and not a.finished and jid not in committed:
                out.append(a)
        return out

    def _whole_job_variant(self, agent: JobAgent, sid: str, t_start: float) -> Optional[Variant]:
        tl = self.slices[sid]
        spec = tl.spec
        if not is_safe(agent.spec.fmp, spec.capacity_bytes, self.theta):
            return None
        thr = agent.throughput_on(spec.capacity_bytes, spec.n_chips)
        if thr <= 0:
            return None
        activation = 0.25  # checkpoint-restore/startup, same cost as JASDA chunks
        dur = predict_duration(agent.work_remaining, thr, quantile=0.9) + activation
        return Variant(
            job_id=agent.spec.job_id,
            slice_id=sid,
            t_start=t_start,
            duration=dur,
            fmp=agent.spec.fmp,
            local_utility=0.5,
            declared_features={},
            payload={"work": agent.work_remaining, "activation": activation},
            variant_id=f"{agent.spec.job_id}/mono",
        )

    def _commit(self, v: Variant, now: float, score: float = 0.0) -> None:
        self.slices[v.slice_id].commit(v.t_start, v.t_end)
        self.commitments.append(Commitment(variant=v, commit_time=now, score=score))
        self.n_committed_total += 1
        self.committed_score_total += float(score)
        # mirror JASDA's per-agent win accounting so cross-system win-rate
        # and cleared-score comparisons read off the same agent fields
        agent = self.agents.get(v.job_id)
        if agent is not None:
            agent.n_wins += 1
            agent.score_won += float(score)

    def _free_at(self, sid: str, now: float) -> bool:
        tl = self.slices[sid]
        gaps = tl.gaps(now, 1e-6)
        return bool(gaps)

    def _result(self, window_sid: str, now: float, selected: List[Variant]) -> ClearingResult:
        spec = self.slices[window_sid].spec
        w = Window(window_sid, spec.capacity_bytes, now, max((v.duration for v in selected), default=0.0))
        return ClearingResult(
            window=w, selected=tuple(selected),
            scores=tuple(0.0 for _ in selected),
            total_score=0.0, n_bids=len(selected),
        )


class FifoScheduler(MonolithicScheduler):
    name = "fifo"

    def step(self, now: float) -> Optional[ClearingResult]:
        waiting = self._waiting()
        if not waiting:
            return None
        head = waiting[0]
        selected: List[Variant] = []
        for sid in sorted(self.slices):
            if not self._free_at(sid, now):
                continue
            v = self._whole_job_variant(head, sid, now)
            if v is not None:
                self._commit(v, now)
                selected.append(v)
                break
        # strict FIFO: if the head cannot start, nobody else may.
        return self._result(selected[0].slice_id, now, selected) if selected else None


class BackfillScheduler(MonolithicScheduler):
    name = "easy-backfill"

    def step(self, now: float) -> Optional[ClearingResult]:
        waiting = self._waiting()
        if not waiting:
            return None
        selected: List[Variant] = []
        head = waiting[0]

        # 1) try to start the head job immediately on any free slice
        placed_head = False
        for sid in sorted(self.slices):
            if self._free_at(sid, now):
                v = self._whole_job_variant(head, sid, now)
                if v is not None:
                    self._commit(v, now)
                    selected.append(v)
                    placed_head = True
                    break

        # 2) head blocked → give it a reservation at the earliest future
        #    moment any compatible slice frees up; backfill others before it
        if not placed_head:
            shadow: Dict[str, float] = {}
            best_sid, best_t = None, float("inf")
            for sid, tl in self.slices.items():
                t_free = tl.busy_until(now)
                vprobe = self._whole_job_variant(head, sid, t_free)
                if vprobe is not None and t_free < best_t:
                    best_sid, best_t = sid, t_free
            if best_sid is not None:
                shadow[best_sid] = best_t  # head's reservation start
                for agent in waiting[1:]:
                    for sid in sorted(self.slices):
                        if not self._free_at(sid, now):
                            continue
                        v = self._whole_job_variant(agent, sid, now)
                        if v is None:
                            continue
                        # EASY rule: must not push past the reservation
                        if sid in shadow and v.t_end > shadow[sid] + 1e-9:
                            continue
                        self._commit(v, now)
                        selected.append(v)
                        break
        return self._result(selected[0].slice_id, now, selected) if selected else None


class BestFitScheduler(MonolithicScheduler):
    name = "best-fit"

    def step(self, now: float) -> Optional[ClearingResult]:
        waiting = self._waiting()
        if not waiting:
            return None
        selected: List[Variant] = []
        for sid in sorted(self.slices):
            if not self._free_at(sid, now):
                continue
            spec = self.slices[sid].spec
            # minimal leftover capacity = tightest-fitting job
            best, best_leftover = None, float("inf")
            for agent in waiting:
                if any(v.job_id == agent.spec.job_id for v in selected):
                    continue
                peak = agent.spec.fmp.peak_mean()
                if peak > spec.capacity_bytes:
                    continue
                leftover = spec.capacity_bytes - peak
                if leftover < best_leftover:
                    v = self._whole_job_variant(agent, sid, now)
                    if v is not None:
                        best, best_leftover = v, leftover
            if best is not None:
                self._commit(best, now)
                selected.append(best)
        return self._result(selected[0].slice_id, now, selected) if selected else None


class AuctionScheduler(MonolithicScheduler):
    """Whole-job sealed-bid auction per free slice (Themis-flavoured).

    Jobs bid value density = priority / predicted JCT; each free slice is
    awarded to the highest bid.  Identical to JASDA's market framing but
    WITHOUT atomization, variants, or per-window WIS packing.
    """

    name = "auction"

    def step(self, now: float) -> Optional[ClearingResult]:
        waiting = self._waiting()
        if not waiting:
            return None
        selected: List[Variant] = []
        taken: set = set()
        for sid in sorted(self.slices):
            if not self._free_at(sid, now):
                continue
            bids = []
            for agent in waiting:
                if agent.spec.job_id in taken:
                    continue
                v = self._whole_job_variant(agent, sid, now)
                if v is None:
                    continue
                # finish-time-fairness flavoured bid: short jobs with
                # deadlines bid higher
                urgency = 1.0
                if agent.spec.qos_deadline is not None:
                    slack = agent.spec.qos_deadline - (now + v.duration)
                    urgency = 2.0 if slack < 0 else 1.0 + 1.0 / (1.0 + slack)
                bids.append((agent.spec.priority * urgency / max(v.duration, 1e-9), v))
            if bids:
                bids.sort(key=lambda b: -b[0])
                v = bids[0][1]
                self._commit(v, now, score=bids[0][0])
                taken.add(v.job_id)
                selected.append(v)
        return self._result(selected[0].slice_id, now, selected) if selected else None
