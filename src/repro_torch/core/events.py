"""Shared discrete-event machinery: the heap discipline + execution plumbing.

Factored out of ``core/simulator.py`` so the closed-loop simulator and the
open-loop streaming service (``repro.service``) drive the SAME event loop:

* :class:`EventHeap` — a seeded, picklable min-heap of ``(t, kind, seq,
  payload)`` tuples with a monotone sequence number breaking timestamp
  ties deterministically.  Checkpointing the heap object inside the same
  pickle graph as the scheduler preserves payload identities (the
  ``Variant`` objects shared with the commit index), which is what makes
  crash-restore replays byte-identical.
* :class:`ExecutionPlumbing` — the synthetic executor: launches committed
  variants with stochastic ground-truth runtimes (log-normal noise around
  activation + work/(throughput × speed)), samples true memory
  trajectories for capacity-violation accounting, and assembles the
  ex-post observation fed back through ``scheduler.complete``.

Event-kind ordering at equal timestamps is part of the replay contract:
completions fire before the scheduler tick sharing their timestamp,
planned fault events fire after it, and the service-side cancel/deadline
events fire after the round that could still have used them.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .types import Variant

__all__ = [
    "EventHeap",
    "ExecutionPlumbing",
    "COMPLETE",
    "FAIL",
    "REPAIR",
    "ARRIVE",
    "TICK",
    "FAULT",
    "CANCEL",
    "DEADLINE",
    "REPARTITION",
]

# Ordering at equal timestamps: completions before scheduler ticks (the
# round at t observes everything that finished by t); arrivals before the
# tick (a job arriving at t bids in the round at t); planned faults and the
# open-loop cancel/deadline events strictly after the tick sharing their
# timestamp.  REPARTITION is last: a repartition opportunity at t runs
# strictly BETWEEN the round at t and the round at t+dt (the drain-first
# protocol in core/repartition.py assumes settled state).
COMPLETE, FAIL, REPAIR, ARRIVE, TICK, FAULT, CANCEL, DEADLINE, \
    REPARTITION = range(9)


class EventHeap:
    """Min-heap of ``(t, kind, seq, payload)`` with deterministic tie-break.

    ``seq`` is a monotone push counter: two events with equal ``(t, kind)``
    pop in push order, so replays are byte-identical per seed.  Picklable;
    the heap invariant is re-established on restore (defensive — the list
    is serialized in heap order anyway).
    """

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap: List[Tuple[float, int, int, object]] = []
        self._seq = 0

    def push(self, t: float, kind: int, payload: object = None) -> None:
        heapq.heappush(self._heap, (t, kind, self._seq, payload))
        self._seq += 1

    def pop(self) -> Tuple[float, int, int, object]:
        return heapq.heappop(self._heap)

    def peek(self) -> Tuple[float, int, int, object]:
        return self._heap[0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __getstate__(self):
        return {"heap": list(self._heap), "seq": self._seq}

    def __setstate__(self, state):
        self._heap = list(state["heap"])
        heapq.heapify(self._heap)
        self._seq = state["seq"]


class ExecutionPlumbing:
    """Launch/complete plumbing shared by simulator and service.

    Owns the executor-side mutable state — ``running`` (slice → (variant,
    actual end)), ``pending`` (committed variants waiting for their start
    time) and the capacity-violation counter — and pushes COMPLETE events
    onto the shared :class:`EventHeap`.  The object is checkpointed as one
    node of the same pickle graph as the scheduler, so the Variant
    identities its ``running``/``pending`` sets share with the scheduler's
    commit index survive a crash-restore.
    """

    def __init__(
        self,
        scheduler,
        heap: EventHeap,
        rng: np.random.Generator,
        *,
        runtime_cv: float = 0.1,
        check_capacity: bool = True,
    ):
        self.scheduler = scheduler
        self.heap = heap
        self.rng = rng
        self.runtime_cv = runtime_cv
        self.check_capacity = check_capacity
        self.running: Dict[str, Tuple[Variant, float]] = {}
        self.pending: List[Variant] = []
        self.violations = 0

    # -- launch ------------------------------------------------------------
    def launch(self, v: Variant, t_now: float) -> None:
        """Start executing a committed variant whose t_start has arrived.

        Ground-truth runtime = activation + work / (throughput × speed) with
        log-normal noise — NOT the declared Δt̃ (which is a conservative
        quantile).  Early finishes release the committed tail back to the
        timeline (scheduler.complete), so honest-but-safe declarations cost
        little; overruns lose the tail work beyond the committed end.
        """
        scheduler = self.scheduler
        spec = scheduler.slices[v.slice_id].spec
        agent = scheduler.agents.get(v.job_id)
        thr = agent.throughput_on(spec.capacity_bytes, spec.n_chips) if agent else 1.0
        thr = max(thr * spec.speed, 1e-9)
        activation = float(v.payload.get("activation", 0.0))
        median = activation + v.payload["work"] / thr
        sigma = np.sqrt(np.log1p(self.runtime_cv**2))
        actual = float(median * np.exp(self.rng.normal(-0.5 * sigma**2, sigma)))
        # truncate to the committed interval: non-preemptive, but the slice is
        # reclaimed at the committed end regardless (overrun → lost tail work)
        actual_end = v.t_start + actual
        if self.check_capacity:
            traj = v.fmp.sample_trajectory(self.rng)
            if np.any(traj > scheduler.slices[v.slice_id].spec.capacity_bytes):
                self.violations += 1
        self.running[v.slice_id] = (v, actual_end)
        self.heap.push(max(actual_end, t_now), COMPLETE, v.slice_id)

    def launch_due(self, now: float, lookahead: float, dead_slices) -> None:
        """Launch pending variants whose start falls within ``lookahead``.

        Variants bound to a dead slice are silently dropped (lost with the
        slice); a variant whose slice is still busy stays pending.
        """
        still: List[Variant] = []
        for v in self.pending:
            if v.slice_id in dead_slices:
                continue  # lost with the slice
            if v.t_start <= now + lookahead and v.slice_id not in self.running:
                self.launch(v, now)
            else:
                still.append(v)
        self.pending = still

    # -- completion --------------------------------------------------------
    def complete(self, slice_id: str, now: float) -> Optional[Tuple[Variant, float]]:
        """Finish the variant running on ``slice_id``; returns (variant,
        actual duration) or None when the slice was already vacated (failed
        or revoked before its completion event popped).

        Observed feature values for ex-post verification come from the
        job's TRUE profile adjusted by realized runtime — independent of
        what was declared, so misreporting is measurable (Eq. 6).
        """
        if slice_id not in self.running:
            return None
        v, actual_end = self.running.pop(slice_id)
        dur_actual = actual_end - v.t_start
        truth = dict(v.payload.get("true_features", v.declared_features))
        observed = dict(truth)
        ratio = float(np.clip(v.duration / max(dur_actual, 1e-9), 0.0, 1.0))
        for k in ("jct", "progress"):
            if k in observed:
                observed[k] = float(np.clip(observed[k] * ratio, 0.0, 1.0))
        overrun = actual_end > v.t_end + 1e-9
        work = v.payload["work"] * (
            min(1.0, (v.t_end - v.t_start) / max(dur_actual, 1e-9)) if overrun else 1.0
        )
        self.scheduler.complete(
            v,
            observed,
            work_done=work,
            actual_end=min(actual_end, v.t_end),
        )
        return v, dur_actual

    # -- failure / cancellation -------------------------------------------
    def fail_running(self, slice_id: str, now: float) -> Optional[Variant]:
        """The slice died mid-execution: release its running variant."""
        if slice_id not in self.running:
            return None
        v, _ = self.running.pop(slice_id)
        self.scheduler.fail(v, now)
        return v

    def drop_pending(self, slice_id: str) -> List[Variant]:
        """Forget pending variants bound to a (now dead) slice."""
        dropped = [p for p in self.pending if p.slice_id == slice_id]
        self.pending = [p for p in self.pending if p.slice_id != slice_id]
        return dropped

    def drop_pending_job(self, job_id: str) -> List[Variant]:
        """Forget pending (not yet launched) variants of a job.

        The caller owns the scheduler-side cancellation (``scheduler.fail``
        releases the reservations); running variants are NOT touched —
        execution is non-preemptive.
        """
        dropped = [p for p in self.pending if p.job_id == job_id]
        self.pending = [p for p in self.pending if p.job_id != job_id]
        return dropped
