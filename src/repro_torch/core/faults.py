"""Deterministic, seeded fault injection + recovery for auction rounds.

The paper embeds "feedback, calibration, and probabilistic safety directly
into the scheduling loop"; real MIG fleets additionally reconfigure and
revoke partitions online (arXiv:2511.18906), and the SJA predecessor
(arXiv:2509.19086) assumes jobs re-atomize when the cluster changes under
them.  This module is that missing failure surface, built so every run is
REPLAYABLE: a :class:`FaultPlan` is a frozen, seeded schedule of
:class:`FaultEvent` rows the simulator injects between and during rounds,
and every recovery path (commitment revocation, bid-collection retries,
the kernel degradation ladder, checkpointed crash restore) is driven only
by the plan + the simulation clock — never by wall time or consumable
global state — so a crash-at-round-k + restore replays byte-identically.

Fault taxonomy (``FaultEvent.kind``):

==========================  ==============================================
``slice_revoked``           the slice dies; running chunk fails, all its
                            commitments are revoked and re-enter bidding
                            (``JasdaScheduler.revoke_slice``), affected
                            agents get a ``slice_failed`` loss broadcast
``slice_degraded``          the slice keeps running at ``magnitude`` ×
                            its former speed (straggler injection)
``agent_silent``            the agent answers NOTHING for ``duration``
                            time units (silent bidder; dropped per round,
                            never retried — silence has no error signal)
``agent_error``             the agent's ``respond()`` RPC errors for
                            ``duration`` time units; the scheduler retries
                            with capped exponential backoff and drops the
                            agent for the round when retries exhaust
``device_dispatch_fail``    the next kernel dispatch on backend ``target``
                            raises ``KernelDispatchError``; sticky
                            ``BackendHealth`` walks the degradation ladder
                            (pallas → ref → numpy) and speculation is
                            invalidated at the fault epoch
``scheduler_crash``         the scheduler process dies mid-run; the
                            simulator restores the latest checkpoint and
                            replays (requires a ``CheckpointStore``)
==========================  ==============================================

Agent faults are TIME-WINDOWED, not count-consumed: whether job J is
silent at time t depends only on (plan, t), so a speculative preparation
built for round t — possibly discarded and rebuilt by the pipeline —
observes the identical fault state every time.  ``attempts`` on
``agent_error`` events bounds how many CONSECUTIVE retry attempts fail
within one collection (deterministic per attempt index), letting tests
exercise the succeeds-after-backoff path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "SLICE_REVOKED",
    "SLICE_DEGRADED",
    "AGENT_SILENT",
    "AGENT_ERROR",
    "DEVICE_DISPATCH_FAIL",
    "SCHEDULER_CRASH",
    "AgentFault",
    "AgentSilentError",
    "AgentRespondError",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
]

SLICE_REVOKED = "slice_revoked"
SLICE_DEGRADED = "slice_degraded"
AGENT_SILENT = "agent_silent"
AGENT_ERROR = "agent_error"
DEVICE_DISPATCH_FAIL = "device_dispatch_fail"
SCHEDULER_CRASH = "scheduler_crash"

FAULT_KINDS = (
    SLICE_REVOKED,
    SLICE_DEGRADED,
    AGENT_SILENT,
    AGENT_ERROR,
    DEVICE_DISPATCH_FAIL,
    SCHEDULER_CRASH,
)


class AgentFault(Exception):
    """Base for bid-collection faults; ``retryable`` drives the backoff."""

    retryable = False


class AgentSilentError(AgentFault):
    """The agent missed the bid-collection deadline (no error signal).

    Not retryable: a silent bidder is dropped for the round immediately —
    retrying silence would stall the round for nothing.
    """

    retryable = False


class AgentRespondError(AgentFault):
    """The agent's ``respond()`` RPC errored; retryable with backoff."""

    retryable = True


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled fault.  ``target`` is a slice_id, job_id, or backend
    name depending on ``kind``; ``duration`` scopes time-windowed faults
    (agent silent/error windows, slice repair delay); ``magnitude`` is the
    kind-specific intensity (speed factor for ``slice_degraded``);
    ``attempts`` is how many consecutive retry attempts an ``agent_error``
    fails within one bid collection (0 = every attempt in the window)."""

    t: float
    kind: str
    target: str = ""
    duration: float = 0.0
    magnitude: float = 1.0
    attempts: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}")


@dataclass(frozen=True)
class FaultPlan:
    """A frozen, seeded schedule of fault events (sorted by time).

    Frozen so a plan can be embedded in configs, hashed into benchmark
    labels, and shipped to a restored run unchanged — the plan IS the
    replay key together with ``SimConfig.seed``.
    """

    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events", tuple(sorted(self.events, key=lambda e: e.t)))

    def for_kind(self, kind: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind == kind)

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        t_end: float,
        slice_ids: Iterable[str] = (),
        job_ids: Iterable[str] = (),
        revoke_rate: float = 0.0,
        degrade_rate: float = 0.0,
        silent_rate: float = 0.0,
        error_rate: float = 0.0,
        dispatch_fail_times: Iterable[float] = (),
        crash_times: Iterable[float] = (),
        repair_time: float = 50.0,
        fault_duration: float = 20.0,
        backend: str = "ref",
    ) -> "FaultPlan":
        """Seeded random plan: Poisson faults per target plus explicit
        dispatch-failure / crash times.  Deterministic per (seed, args)."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []

        def poisson(rate: float, gap: float):
            if rate <= 0.0:
                return
            t = float(rng.exponential(1.0 / rate))
            while t < t_end:
                yield t
                t += gap + float(rng.exponential(1.0 / rate))

        for sid in slice_ids:
            for t in poisson(revoke_rate, repair_time):
                events.append(FaultEvent(t, SLICE_REVOKED, sid,
                                         duration=repair_time))
            for t in poisson(degrade_rate, fault_duration):
                events.append(FaultEvent(
                    t, SLICE_DEGRADED, sid, duration=fault_duration,
                    magnitude=float(rng.uniform(0.3, 0.8))))
        for jid in job_ids:
            for t in poisson(silent_rate, fault_duration):
                events.append(FaultEvent(t, AGENT_SILENT, jid,
                                         duration=fault_duration))
            for t in poisson(error_rate, fault_duration):
                events.append(FaultEvent(
                    t, AGENT_ERROR, jid, duration=fault_duration,
                    attempts=int(rng.integers(1, 4))))
        for t in dispatch_fail_times:
            events.append(FaultEvent(float(t), DEVICE_DISPATCH_FAIL, backend))
        for t in crash_times:
            events.append(FaultEvent(float(t), SCHEDULER_CRASH))
        return cls(seed=seed, events=tuple(events))


class FaultInjector:
    """Runtime view of a :class:`FaultPlan`: the agent-fault gate.

    Holds NO consumable state for agent faults — the gate answers "is job
    J silent / erroring at time t, attempt k" purely from the plan's time
    windows, which is what keeps speculative (pipelined) bid collections
    byte-identical to serial ones.  Slice / device / crash events are
    delivered by the simulator's event heap instead (they mutate scheduler
    state and must happen exactly once per timeline position).

    Picklable (plain tuples/dicts only), so it rides the crash-recovery
    checkpoint unchanged.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._silent: Dict[str, List[Tuple[float, float]]] = {}
        self._error: Dict[str, List[Tuple[float, float, int]]] = {}
        for e in plan.events:
            if e.kind == AGENT_SILENT:
                self._silent.setdefault(e.target, []).append(
                    (e.t, e.t + e.duration))
            elif e.kind == AGENT_ERROR:
                self._error.setdefault(e.target, []).append(
                    (e.t, e.t + e.duration, int(e.attempts)))

    # -- the bid-collection gate (scheduler.fault_gate) -------------------
    def __call__(self, agent, now: float, attempt: int) -> None:
        """Raise the fault active for ``agent`` at ``now``, if any.

        Called by the scheduler BEFORE each ``respond()`` attempt; the
        attempt index makes "fails first k attempts" deterministic."""
        job_id = agent.spec.job_id
        for t0, t1 in self._silent.get(job_id, ()):
            if t0 <= now < t1:
                raise AgentSilentError(
                    f"{job_id} silent at t={now:g} (window [{t0:g},{t1:g}))")
        for t0, t1, attempts in self._error.get(job_id, ()):
            if t0 <= now < t1 and (attempts == 0 or attempt < attempts):
                raise AgentRespondError(
                    f"{job_id} respond() error at t={now:g} "
                    f"attempt {attempt} (window [{t0:g},{t1:g}))")

    # -- the event stream the simulator schedules -------------------------
    def scheduled_events(self) -> Tuple[FaultEvent, ...]:
        """Events the simulator must deliver through its heap (slice /
        device / crash); agent windows are handled by the gate alone."""
        return tuple(e for e in self.plan.events
                     if e.kind in (SLICE_REVOKED, SLICE_DEGRADED,
                                   DEVICE_DISPATCH_FAIL, SCHEDULER_CRASH))
