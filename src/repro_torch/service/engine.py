"""The long-lived `JasdaService`: open-loop auction rounds with SLOs.

The closed-loop simulator drains a pre-drawn workload; the service is
the production shape of the paper's "heavy traffic" deployment:
an event-driven :class:`~repro_torch.service.arrivals.ArrivalProcess` feeds a
PERSISTENT :class:`~repro_torch.core.scheduler.JasdaScheduler`, rounds fire on
a fixed cadence through the pipelined prepare/settle path, and every
job's admit → announce → award → complete path is timestamped into
streaming SLO quantiles (:mod:`repro_torch.service.metrics`).

The loop reuses the simulator's heap-event discipline verbatim
(``core/events.py``: same kinds, same equal-time ordering, same
:class:`ExecutionPlumbing` launch/complete model), so open-loop replays
inherit the byte-identity guarantees the closed-loop tests pin:

* a fixed-seed soak is deterministic — identical award log and
  :class:`ServiceStats` across two runs;
* a crash-restart from a periodic :class:`CheckpointStore` snapshot
  resumes mid-stream and replays byte-identically to the uncrashed run
  (the service object IS the checkpoint payload: scheduler + calibrator
  + arrival rng + event heap + executor + metrics in one pickle graph).

Back-pressure: each arrival passes through the configured
:class:`~repro_torch.service.admission.AdmissionPolicy`; shed jobs get the
out-of-round ``LOSS_SHED`` feedback.  Health: the
:class:`~repro_torch.runtime.monitor.HealthMonitor` is wired in — every round
heartbeats the live slices (completions post observed speed), silent
slices are revoked through ``scheduler.revoke_slice`` after
``max_missed`` intervals, and straggling slices get their declared speed
marked down once via ``scheduler.degrade_slice``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.events import (ARRIVE, CANCEL, COMPLETE, DEADLINE, REPARTITION,
                           TICK, EventHeap, ExecutionPlumbing)
from ..core.jobs import AgentConfig, JobAgent
from ..core.negotiation.messages import build_shed_feedback
from ..core.types import SliceSpec
from ..runtime import trace
from ..runtime.monitor import HealthConfig, HealthMonitor
from .admission import AcceptAll, AdmissionPolicy, BoundedQueue, \
    queue_bound_for_bucket
from .arrivals import ArrivalProcess, DeadlineExpired, JobArrival, JobCancel
from .metrics import ServiceMetrics, ServiceStats

__all__ = ["ServiceConfig", "JasdaService", "AwardRecord"]

#: the ``kind`` of each event on its ``service.event`` span
EVENT_NAMES = {TICK: "tick", COMPLETE: "complete", ARRIVE: "arrive",
               CANCEL: "cancel", DEADLINE: "deadline",
               REPARTITION: "repartition"}


@dataclass(frozen=True)
class ServiceConfig:
    """Knobs of one service deployment (frozen; rides the checkpoint)."""

    round_dt: float = 1.0  # auction cadence (a round every round_dt)
    t_end: float = 500.0  # default soak horizon for run()
    seed: int = 0  # executor noise stream (arrivals carry their own seed)
    runtime_cv: float = 0.1  # execution log-normal noise (as SimConfig)
    check_capacity: bool = True
    pipeline: bool = True  # double-buffer rounds (core/pipeline.py)
    # largest pow2 scoring bucket the deployment budgets one executable
    # for: BoundedQueue(None) resolves its depth cap from this
    # (admission.queue_bound_for_bucket)
    max_bucket_m: int = 512
    # bidding strategy for admitted jobs (None = GreedyChunking default)
    strategy: object = None
    keep_award_log: bool = True  # the soak ledger (determinism tests)
    # health policing (wired to runtime.monitor.HealthMonitor)
    heartbeat_interval: Optional[float] = None  # None → round_dt
    max_missed: int = 3
    straggler_ratio: float = 0.6
    # dynamic repartitioning (core/repartition.py): a RepartitionPolicy
    # ticked on the event heap every ``repartition_dt`` (None → round_dt),
    # strictly AFTER the round sharing its timestamp (between rounds).
    # None disables the subsystem; StaticInventory runs it but proposes
    # nothing — both byte-identical to the pre-repartition service.
    repartition: object = None
    repartition_dt: Optional[float] = None
    # preemption-aware recovery (core/repartition.py MigrationPlanner):
    # a MigrationConfig (or True for defaults) arms the revocation ladder
    # — dead slices are evacuated (migrate → preempt-with-credit →
    # revoke-lossy) instead of revoked outright.  None keeps the lossy
    # revocation path byte-identically.
    migration: object = None


@dataclass(frozen=True)
class AwardRecord:
    """One award-log row: enough to compare two soaks byte-for-byte."""

    round: int
    t: float
    variant_id: str
    job_id: str
    slice_id: str


class JasdaService:
    """A persistent auction serving an open-loop arrival stream.

    Drive with :meth:`run` (a soak to a horizon, optionally checkpointed)
    or :meth:`step_round` batches via repeated ``run`` calls on the same
    instance.  The instance is the checkpoint payload: restore with
    :meth:`restore` and call :meth:`run` again to resume mid-stream.
    """

    # pre-migration checkpoints lack the attribute; unpickled instances
    # fall back to the lossy revocation path
    migration = None

    def __init__(
        self,
        scheduler,
        arrivals: ArrivalProcess,
        *,
        config: Optional[ServiceConfig] = None,
        admission: Optional[AdmissionPolicy] = None,
        monitor: Optional[HealthMonitor] = None,
    ):
        self.cfg = config or ServiceConfig()
        self.scheduler = scheduler
        self.arrivals = arrivals
        self.admission = admission or AcceptAll()
        if (isinstance(self.admission, BoundedQueue)
                and self.admission.max_queue is None):
            self.admission.max_queue = queue_bound_for_bucket(
                self.cfg.max_bucket_m)
        hb = (self.cfg.heartbeat_interval
              if self.cfg.heartbeat_interval is not None
              else self.cfg.round_dt)
        self.monitor = monitor or HealthMonitor(HealthConfig(
            heartbeat_interval=hb, max_missed=self.cfg.max_missed,
            straggler_ratio=self.cfg.straggler_ratio))
        self.heap = EventHeap()
        self.exec = ExecutionPlumbing(
            scheduler, self.heap, np.random.default_rng(self.cfg.seed),
            runtime_cv=self.cfg.runtime_cv,
            check_capacity=self.cfg.check_capacity)
        self.metrics = ServiceMetrics()
        self.award_log: List[AwardRecord] = []
        self.now = 0.0
        self.round_count = 0
        self.dead_slices: Dict[str, SliceSpec] = {}
        self._degraded: set = set()
        self._muted: set = set()  # fault hook: slices whose host went silent
        for sid in scheduler.slices:
            self.monitor.register(sid, 0.0)
        self.heap.push(0.0, TICK)
        self.migration = None
        if self.cfg.migration is not None:
            from ..core.repartition import MigrationConfig, MigrationPlanner

            mig_cfg = (self.cfg.migration
                       if isinstance(self.cfg.migration, MigrationConfig)
                       else None)
            self.migration = MigrationPlanner(scheduler, mig_cfg)
        self.repartition = None
        if self.cfg.repartition is not None:
            from ..core.repartition import RepartitionCoordinator

            self.repartition = RepartitionCoordinator(
                scheduler, self.cfg.repartition, migration=self.migration)
            # first opportunity at t=0 orders AFTER the first round
            # (REPARTITION > TICK at equal timestamps)
            self.heap.push(0.0, REPARTITION)

    # -- fault hooks (tests / chaos drivers) -------------------------------
    def mute_slice(self, slice_id: str) -> None:
        """Stop a slice's heartbeats (simulates a silent host); the
        monitor will declare it dead after ``max_missed`` intervals and
        the service revokes it."""
        self._muted.add(slice_id)

    def unmute_slice(self, slice_id: str) -> None:
        self._muted.discard(slice_id)

    # -- the loop ----------------------------------------------------------
    def run(self, t_end: Optional[float] = None, *, checkpoint=None,
            checkpoint_every: int = 50) -> ServiceStats:
        """Run the service loop until ``t_end`` (default config horizon).

        With ``checkpoint`` (a :class:`~repro_torch.checkpoint.CheckpointStore`)
        the FULL service state is snapshotted before every
        ``checkpoint_every``-th round — speculation flushed first, so a
        snapshot never captures an in-flight round (the simulator's
        protocol).  Returns the final :class:`ServiceStats`.
        """
        cfg = self.cfg
        horizon = cfg.t_end if t_end is None else float(t_end)
        pipe = None
        if cfg.pipeline and hasattr(self.scheduler, "_prepare_round"):
            from ..core.pipeline import RoundPipeline

            pipe = RoundPipeline(self.scheduler)

        while self.heap:
            if self.heap.peek()[0] > horizon:
                break  # the event stays queued for the next run() call
            if checkpoint is not None and self.heap.peek()[1] == TICK:
                if self.round_count % max(1, checkpoint_every) == 0:
                    if pipe is not None:
                        pipe.flush()
                    checkpoint.save_state(self.round_count, self)
            t, kind, _seq, payload = self.heap.pop()
            self.now = t
            with trace.span("service.event", kind=EVENT_NAMES[kind], now=t):
                if kind == TICK:
                    self._on_tick(t, horizon, pipe)
                elif kind == COMPLETE:
                    self._on_complete(payload, t)
                elif kind == ARRIVE:
                    self._on_arrival(payload, t)
                elif kind == CANCEL:
                    self._on_cancel(payload.job_id, t, expired=False)
                elif kind == DEADLINE:
                    self._on_cancel(payload.job_id, t, expired=True)
                elif kind == REPARTITION:
                    self._on_repartition(t, horizon)

        if pipe is not None:
            pipe.flush()
        return self.stats()

    @classmethod
    def restore(cls, store, step: Optional[int] = None) -> "JasdaService":
        """Resume a checkpointed service (crash recovery).

        The restored object picks up mid-stream: the event heap still
        holds the round tick the snapshot was taken before, the arrival
        generator resumes its draw sequence, and a subsequent
        :meth:`run` replays byte-identically to the uncrashed service.
        """
        svc, _step = store.restore_state(step)
        if not isinstance(svc, cls):
            raise TypeError(
                f"checkpoint holds {type(svc).__name__}, not a {cls.__name__}")
        return svc

    # -- event handlers ----------------------------------------------------
    def _on_tick(self, now: float, horizon: float, pipe) -> None:
        cfg = self.cfg
        # stage the next round-interval of arrivals so they interleave
        # with this heap (an arrival at t ∈ (now, now+dt] pops before the
        # tick at now+dt: ARRIVE orders before TICK at equal timestamps);
        # those past the horizon wait in the heap for the next run() call
        for ev in self.arrivals.take_until(now + cfg.round_dt):
            if isinstance(ev, JobArrival):
                self.heap.push(ev.t, ARRIVE, ev)
            elif isinstance(ev, JobCancel):
                self.heap.push(ev.t, CANCEL, ev)
            elif isinstance(ev, DeadlineExpired):
                self.heap.push(ev.t, DEADLINE, ev)
        # health: heartbeat live slices (muted ones go silent), then police
        for sid in self.scheduler.slices:
            if sid not in self._muted:
                self.monitor.heartbeat(sid, now)
        self._police_slices(now)
        # the auction round (pipelined prepare/settle when available)
        self.metrics.n_rounds += 1
        self.round_count += 1
        nxt = now + cfg.round_dt
        with trace.span("service.round", now=now):
            if pipe is not None:
                rr = pipe.tick(now, next_time=nxt if nxt <= horizon else None)
            else:
                rr = self.scheduler.run_round(now)
        if rr is not None:
            # every live job saw this announcement; first-seen is the
            # announce timestamp of its decision path
            for job_id in self.scheduler.agents:
                self.metrics.announced(job_id, now)
            for v in rr.selected:
                self.metrics.awarded(v.job_id, now)
                if cfg.keep_award_log:
                    self.award_log.append(AwardRecord(
                        self.round_count, now, v.variant_id, v.job_id,
                        v.slice_id))
            self.exec.pending.extend(rr.selected)
        self.exec.launch_due(now, cfg.round_dt, self.dead_slices)
        self.heap.push(nxt, TICK)

    def _on_repartition(self, now: float, horizon: float) -> None:
        """Between-rounds repartition opportunity (periodic heap event).

        Coordinator mutations bump the scheduler epoch, so a pipelined
        speculative prep built against the old inventory is discarded by
        the normal validation protocol — no special flush here.
        """
        if self.repartition is not None:
            self.repartition.tick(now, self.exec)
            nxt = now + (self.cfg.repartition_dt
                         if self.cfg.repartition_dt is not None
                         else self.cfg.round_dt)
            self.heap.push(nxt, REPARTITION)

    def _on_arrival(self, ev: JobArrival, now: float) -> None:
        self.metrics.n_arrived += 1
        agent = JobAgent(ev.spec, AgentConfig(strategy=self.cfg.strategy))
        # the back-pressure boundary is the whole live bid pool: every
        # unfinished agent contributes pooled bid rows each round, so the
        # pow2-bucket budget bounds THIS set, not just never-awarded jobs
        queue = [a for a in self.scheduler.agents.values() if not a.finished]
        admit, to_shed = self.admission.on_arrival(agent, now, queue)
        for victim in to_shed:
            jid = victim.spec.job_id
            # a victim may already hold awards: cancel its queued chunks
            # (releasing their reservations); a chunk already running
            # finishes on its own and settles against a departed agent
            for v in self.exec.drop_pending_job(jid):
                self.scheduler.fail(v, now)
            if self.scheduler.shed_job(jid, now):
                self.metrics.n_shed += 1
                self.metrics.dropped(jid)
        if admit:
            self.scheduler.add_job(agent, now)
            self.metrics.admitted(ev.spec.job_id, now)
        else:
            # never entered the scheduler: notify the agent directly with
            # the same LOSS_SHED broadcast shed_job would have built
            agent.observe_feedback(
                build_shed_feedback(now, [ev.spec.job_id]))
            self.metrics.n_shed += 1

    def _on_complete(self, slice_id: str, now: float) -> None:
        done = self.exec.complete(slice_id, now)
        if done is None:
            return
        v, dur_actual = done
        # observed/declared speed feeds the straggler EWMA; >1 (early
        # finish) is fine, the EWMA is what's thresholded
        observed = float(np.clip(v.duration / max(dur_actual, 1e-9),
                                 0.0, 2.0))
        self.monitor.heartbeat(slice_id, now, observed_speed=observed)
        agent = self.scheduler.agents.get(v.job_id)
        if agent is not None and agent.finished:
            self.metrics.completed(v.job_id, now, agent.spec.total_work)
            # pool hygiene for the long-lived service: finished agents
            # leave the biddable pool; stray over-committed chunks are
            # cancelled (their reservations released)
            for leftover in self.exec.drop_pending_job(v.job_id):
                self.scheduler.fail(leftover, now)
            self.scheduler.remove_job(v.job_id)

    def _on_cancel(self, job_id: str, now: float, *, expired: bool) -> None:
        agent = self.scheduler.agents.get(job_id)
        if agent is None or agent.finished:
            return  # already done / already gone (shed or cancelled)
        # non-preemptive: a chunk already running finishes on its own (its
        # completion is harmless — the agent is gone by then); queued
        # not-yet-launched chunks are cancelled and their reservations
        # released
        for v in self.exec.drop_pending_job(job_id):
            self.scheduler.fail(v, now)
        self.scheduler.remove_job(job_id)
        if expired:
            self.metrics.n_expired += 1
        else:
            self.metrics.n_cancelled += 1
        self.metrics.dropped(job_id)

    # -- health policing ---------------------------------------------------
    def _police_slices(self, now: float) -> None:
        """The monitor's two halves (dead slices, stragglers) on the loop."""
        for sid in self.monitor.dead_slices(now):
            if sid in self.scheduler.slices:
                spec = self.scheduler.slices[sid].spec
                if self.migration is not None:
                    # revocation ladder: migrate what fits elsewhere,
                    # credit checkpointed progress, lose only the rest
                    self.migration.evacuate(sid, now, self.exec)
                else:
                    self.exec.fail_running(sid, now)
                    self.scheduler.revoke_slice(sid, now)
                    self.exec.drop_pending(sid)
                self.dead_slices[sid] = spec
                self.metrics.n_revoked_slices += 1
            self.monitor.remove(sid)
        for sid in self.monitor.stragglers():
            if sid in self.scheduler.slices and sid not in self._degraded:
                # mark the declared speed down to the observed EWMA once:
                # planning and calibration now see the slice as it is
                factor = float(np.clip(self.monitor.speed(sid), 0.1, 1.0))
                self.scheduler.degrade_slice(sid, factor)
                self._degraded.add(sid)
                self.metrics.n_degraded_slices += 1

    # -- reporting ---------------------------------------------------------
    def stats(self) -> ServiceStats:
        live = [a for a in self.scheduler.agents.values() if not a.finished]
        queue_depth = sum(1 for a in live if a.n_wins == 0)
        backlog = float(sum(a.biddable_work for a in live))
        sched = self.scheduler
        return self.metrics.snapshot(
            self.now, queue_depth=queue_depth, backlog_work=backlog,
            n_preempted=getattr(sched, "n_preempted_total", 0),
            n_migrated=getattr(sched, "n_migrated_total", 0),
            n_lost_commitments=getattr(sched, "n_lost_total", 0),
            work_credited=getattr(sched, "work_credited_total", 0.0),
            loss_reasons=tuple(sorted(
                getattr(sched, "loss_reasons", {}).items())))
