"""Discrete-event cluster simulator for JASDA and baseline schedulers.

The paper defers its quantitative study; this simulator IS that study's
engine.  It drives the scheduler's interaction cycle against a synthetic
cluster in which committed subjobs execute with *stochastic* runtimes and
memory trajectories drawn from the jobs' TRUE profiles (which may differ
from the declared ones — that is how misreporting and the §4.2.1
verification loop are exercised).

Fault model (beyond-paper, per assignment):
  * slice failures  — a slice dies at a random time, killing its running
    subjob; the job loses only that chunk (atomization = cheap recovery);
    the slice optionally resurrects after ``repair_time`` (elasticity).
  * stragglers      — a slice runs at speed < 1; observed durations inflate,
    ex-post ε grows, and calibration de-prioritizes jobs mapped there —
    mitigation falls out of the paper's own trust machinery.

Scenario axes (beyond-paper): fault model, stragglers, misreporting — and
mixed-strategy POPULATIONS (``make_workload(strategies=[...])``): jobs can
run different ``negotiation.BiddingStrategy`` backends side by side, and
``SimResult.strategy_stats`` reports per-strategy bids/wins/cleared score
so strategy matchups (AdaptiveBidder vs GreedyChunking) read off one run.

Metrics: utilization, mean/95p JCT, makespan, Jain fairness on slowdown,
bid/win counts, capacity-violation rate (validates θ).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .events import EventHeap, ExecutionPlumbing
from .events import ARRIVE as _ARRIVE
from .events import COMPLETE as _COMPLETE
from .events import FAIL as _FAIL
from .events import FAULT as _FAULT
from .events import REPAIR as _REPAIR
from .events import TICK as _TICK
from .fairness import jain_index
from .faults import (DEVICE_DISPATCH_FAIL, SCHEDULER_CRASH, SLICE_DEGRADED,
                     SLICE_REVOKED, FaultInjector, FaultPlan)
from .jobs import JobAgent
from .scheduler import JasdaScheduler, SchedulerConfig
from .types import JobSpec, SliceSpec, Variant

__all__ = ["SimConfig", "SimResult", "simulate", "make_workload"]

#: the reference package's backend names → the port's
_REFERENCE_BACKENDS = {"ref": "torch", "pallas": "cuda"}


@dataclass(frozen=True)
class SimConfig:
    t_end: float = 2000.0
    iteration_dt: float = 1.0  # scheduler wakes up every dt (A3)
    seed: int = 0
    # execution noise: actual duration = predicted_median * LogNormal(cv)
    runtime_cv: float = 0.1
    # failure injection
    failure_rate: float = 0.0  # per-slice failures per unit time
    repair_time: float = 50.0
    # capacity enforcement: sample the true memory trajectory and count
    # violations (validates the θ safety bound end-to-end)
    check_capacity: bool = True
    # double-buffer consecutive auction rounds (core/pipeline.py): the host
    # prepares tick t+dt's bids while tick t's scores are in flight on
    # device.  Selections are identical to serial rounds (tested); disable
    # to force the serial reference path.
    pipeline: bool = True
    # dynamic repartitioning (core/repartition.py): a RepartitionPolicy the
    # coordinator consults every ``repartition_every`` ticks, BEFORE the
    # round at that tick (between-rounds semantics).  None disables the
    # subsystem entirely; StaticInventory runs it but proposes nothing —
    # both are byte-identical to the pre-repartition simulator (tested).
    # Requires a pow2-consistent inventory (see ProfileLattice.infer).
    repartition: Optional[object] = None
    repartition_every: int = 1
    # preemption-aware recovery (core/repartition.py MigrationConfig): when
    # set, slice revocations and forced repartition drains walk the
    # migrate → preempt-with-credit → revoke-lossy ladder through a
    # MigrationPlanner instead of torching in-flight commitments.  None
    # disables the subsystem; a config with migration_budget=0 combined
    # with preempt_granularity=0 jobs degenerates to the lossy path
    # byte-identically (tested).
    migration: Optional[object] = None


@dataclass
class SimResult:
    utilization: float
    per_slice_utilization: Dict[str, float]
    mean_jct: float
    p95_jct: float
    makespan: float
    jain_slowdown: float
    n_finished: int
    n_jobs: int
    capacity_violations: int
    n_committed: int
    total_score: float
    jct_per_job: Dict[str, float] = field(default_factory=dict)
    reliability: Dict[str, float] = field(default_factory=dict)
    # full Calibrator.snapshot() — round-trippable via Calibrator.restore(),
    # so a follow-up run can resume the trust state this run ended with
    calibration: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # per-BiddingStrategy aggregates (mixed-strategy populations): strategy
    # name -> {n_jobs, n_finished, n_bids, n_wins, score_won}
    strategy_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    iterations: int = 0
    # names of the policy / clearing backend that produced this run (JASDA
    # schedulers report Policy.name + ClearingPolicy.name; baselines their
    # scheduler name) so preset sweeps stay self-describing
    policy: str = ""
    clearing: str = ""
    # the scheduler that FINISHED the run: after a scheduler_crash +
    # checkpoint restore this is the restored instance, not the one the
    # caller passed in (whose state is pre-crash and stale)
    scheduler: object = field(default=None, repr=False, compare=False)
    # the RepartitionCoordinator that finished the run (None when
    # cfg.repartition is None): carries frag_trace, move counters and the
    # energy proxy for benchmarks/tests
    repartition: object = field(default=None, repr=False, compare=False)
    # disruption accounting (the revocation ladder's audit surface):
    # commitments preempted with credit / migrated across slices / lost
    # outright, total granule-aligned work credited, and the per-reason
    # loss histogram (scheduler.loss_reasons) — all zero/empty on the
    # default lossy path
    n_preempted: int = 0
    n_migrated: int = 0
    n_lost_commitments: int = 0
    work_credited: float = 0.0
    loss_reasons: Dict[str, int] = field(default_factory=dict)

    def summary(self) -> str:
        tag = ""
        if self.policy:
            tag = f" policy={self.policy}" + (
                f"/{self.clearing}" if self.clearing else "")
        return (
            f"util={self.utilization:.3f} meanJCT={self.mean_jct:.1f} "
            f"p95JCT={self.p95_jct:.1f} makespan={self.makespan:.1f} "
            f"jain={self.jain_slowdown:.3f} finished={self.n_finished}/{self.n_jobs} "
            f"violations={self.capacity_violations}" + tag
        )


# Event kinds live in core/events.py (shared with repro.service): ordered so
# completions fire before scheduler ticks at equal time and planned fault
# events fire AFTER the tick sharing their timestamp (the round at t
# observes faults injected strictly before t).


def simulate(
    scheduler: JasdaScheduler,
    agents: Sequence[JobAgent],
    cfg: SimConfig = SimConfig(),
    *,
    faults: Optional[FaultPlan] = None,
    checkpoint=None,
    checkpoint_every: int = 1,
) -> SimResult:
    """Drive the scheduler against the synthetic cluster (module docstring).

    ``faults`` (a :class:`~repro.core.faults.FaultPlan`) injects the
    deterministic fault schedule: slice revocations/degradations and
    device-dispatch failures are delivered through the event heap; agent
    silent/error windows are enforced by the scheduler's bid-collection
    gate; ``scheduler_crash`` events kill the in-memory state and restore
    the latest checkpoint (requires ``checkpoint``, a
    :class:`~repro_torch.checkpoint.CheckpointStore`; crashes are ignored
    without one).  With ``checkpoint`` set, the FULL simulation state
    (scheduler + calibrator + agents + event heap + rng) is snapshotted
    before every ``checkpoint_every``-th tick — speculation is flushed
    first (semantics-preserving), so a snapshot never captures an
    in-flight round.  Crash-at-round-k + restore replays byte-identically
    to the uninterrupted run under the same plan (tested).
    """
    rng = np.random.default_rng(cfg.seed)
    heap = EventHeap()

    for a in agents:
        heap.push(a.spec.arrival_time, _ARRIVE, a)
    heap.push(0.0, _TICK)

    # failure schedule (Poisson per slice)
    if cfg.failure_rate > 0:
        for sid in list(scheduler.slices):
            t = rng.exponential(1.0 / cfg.failure_rate)
            while t < cfg.t_end:
                heap.push(t, _FAIL, sid)
                t += cfg.repair_time + rng.exponential(1.0 / cfg.failure_rate)

    # deterministic fault plan: slice/device/crash events ride the heap;
    # agent silent/error windows live in the gate (time-windowed, so
    # speculative bid collections replay identically — see core/faults.py)
    if faults is not None:
        injector = faults if isinstance(faults, FaultInjector) \
            else FaultInjector(faults)
        scheduler.fault_gate = injector
        for e in injector.scheduled_events():
            heap.push(e.t, _FAULT, e)

    # multi-tick round pipelining: JASDA schedulers expose the prepare/settle
    # split; baselines fall back to their serial run_round
    pipe = None
    if cfg.pipeline and hasattr(scheduler, "_prepare_round"):
        from .pipeline import RoundPipeline

        pipe = RoundPipeline(scheduler)

    # executor-side state (launch/complete plumbing shared with the service):
    # running/pending/violations live on the plumbing object so one pickle
    # graph checkpoints them together with the scheduler they share Variant
    # identities with
    ex = ExecutionPlumbing(scheduler, heap, rng,
                           runtime_cv=cfg.runtime_cv,
                           check_capacity=cfg.check_capacity)

    # dynamic repartitioning: the coordinator owns the buddy layout and
    # executes policy moves between rounds; its mutations bump the
    # scheduler epoch, so the pipeline's speculation protocol handles them
    # like any other state change (no special flush needed)
    # preemption-aware recovery: ONE planner walks the revocation ladder on
    # every forced slice death (fault path + repartition drains); None keeps
    # the historical lossy path
    planner = None
    if cfg.migration is not None:
        from .repartition import MigrationConfig, MigrationPlanner

        mig_cfg = (cfg.migration if isinstance(cfg.migration, MigrationConfig)
                   else None)
        planner = MigrationPlanner(scheduler, mig_cfg)

    coord = None
    if cfg.repartition is not None:
        from .repartition import RepartitionCoordinator

        coord = RepartitionCoordinator(scheduler, cfg.repartition,
                                       migration=planner)

    dead_slices: Dict[str, SliceSpec] = {}
    jct: Dict[str, float] = {}
    arrival: Dict[str, float] = {}
    iterations = 0
    now = 0.0

    store = checkpoint
    tick_count = 0
    # crash events already delivered this PROCESS lifetime.  Deliberately a
    # plain local that is NOT part of the checkpointed state: the restored
    # heap still contains the crash event that triggered the restore, and
    # skipping it on the re-pop is exactly what makes recovery terminate.
    consumed_crashes: Set[Tuple[float, int]] = set()

    while heap:
        # snapshot BEFORE the tick executes: restore resumes at round k with
        # the heap (including the pending tick itself) exactly as it was
        if store is not None and heap.peek()[1] == _TICK:
            if tick_count % checkpoint_every == 0:
                if pipe is not None:
                    pipe.flush()  # speculation holds device handles; flushing
                    # is semantics-preserving (pipeline equivalence contract)
                from ..kernels.common import dispatch_faults_snapshot

                store.save_state(tick_count, {
                    "scheduler": scheduler,
                    "agents": list(agents),
                    "events": heap,
                    "exec": ex,
                    "dead_slices": dead_slices,
                    "jct": jct,
                    "arrival": arrival,
                    "iterations": iterations,
                    "now": now,
                    "rng": rng,
                    "tick_count": tick_count,
                    "armed_faults": dispatch_faults_snapshot(),
                    # repartition layout + drain queue ride the same pickle
                    # graph (coordinator references the scheduler above)
                    "repartition": coord,
                    # migration ladder state (counters + config) rides the
                    # same graph, so resume across a migration boundary is
                    # byte-identical
                    "migration": planner,
                })
            tick_count += 1

        t, kind, eseq, payload = heap.pop()
        if t > cfg.t_end:
            break
        now = t

        if kind == _ARRIVE:
            agent: JobAgent = payload
            scheduler.add_job(agent, now)
            arrival[agent.spec.job_id] = now

        elif kind == _TICK:
            # "This cycle repeats continuously" (paper §3): one batched
            # auction round clears ALL open windows across all slices —
            # replacing the former 3 × n_slices sequential step() loop.
            iterations += 1
            if coord is not None and (
                    (iterations - 1) % max(1, cfg.repartition_every) == 0):
                coord.tick(now, ex)
            if pipe is not None:
                nxt = now + cfg.iteration_dt
                rr = pipe.tick(now, next_time=nxt if nxt <= cfg.t_end else None)
            else:
                rr = scheduler.run_round(now)
            if rr is not None and rr.selected:
                ex.pending.extend(rr.selected)
            # launch any committed variants whose start has arrived
            ex.launch_due(now, cfg.iteration_dt, dead_slices)
            if now + cfg.iteration_dt <= cfg.t_end:
                heap.push(now + cfg.iteration_dt, _TICK)

        elif kind == _COMPLETE:
            done = ex.complete(payload, now)
            if done is None:
                continue
            v, _dur = done
            agent = scheduler.agents.get(v.job_id)
            if agent is not None and agent.finished and v.job_id not in jct:
                jct[v.job_id] = now - arrival[v.job_id]

        elif kind == _FAIL:
            sid = payload
            if sid not in scheduler.slices:
                continue
            spec = scheduler.slices[sid].spec
            ex.fail_running(sid, now)
            lost = scheduler.drop_slice(sid, now=now)
            ex.drop_pending(sid)
            dead_slices[sid] = spec
            heap.push(now + cfg.repair_time, _REPAIR, sid)

        elif kind == _REPAIR:
            sid = payload
            spec = dead_slices.pop(sid, None)
            if spec is not None:
                scheduler.add_slice(spec)

        elif kind == _FAULT:
            e = payload
            if e.kind == SLICE_REVOKED:
                sid = e.target
                if sid not in scheduler.slices:
                    continue
                spec = scheduler.slices[sid].spec
                if planner is not None:
                    # revocation ladder: migrate → preempt-with-credit →
                    # revoke-lossy per commitment (core/repartition.py)
                    planner.evacuate(sid, now, ex)
                else:
                    ex.fail_running(sid, now)
                    # revoke (vs drop): requeues lost commitments through
                    # the atomizer, retires the slice's windows in the
                    # dead-window registry, notifies via LOSS_SLICE_FAILED
                    scheduler.revoke_slice(sid, now)
                    ex.drop_pending(sid)
                dead_slices[sid] = spec
                if e.duration > 0:
                    heap.push(now + e.duration, _REPAIR, sid)
            elif e.kind == SLICE_DEGRADED:
                if e.target in scheduler.slices:
                    scheduler.degrade_slice(e.target, e.magnitude)
            elif e.kind == DEVICE_DISPATCH_FAIL:
                from ..kernels.common import inject_dispatch_fault

                # plans written for the reference name its backends: its
                # jnp reference is the port's torch version, its Pallas
                # kernel the port's CUDA kernel
                target = e.target or "torch"
                inject_dispatch_fault(_REFERENCE_BACKENDS.get(target, target))
                # bump the scheduler epoch so any speculative prep rebuilds
                # and the armed fault lands at a deterministic dispatch
                scheduler.invalidate_speculation()
            elif e.kind == SCHEDULER_CRASH:
                key = (t, eseq)
                if (store is None or key in consumed_crashes
                        or store.latest_step() is None):
                    continue  # nothing to restore from: crash is a no-op
                consumed_crashes.add(key)
                from ..kernels.common import restore_dispatch_faults

                state, _ = store.restore_state()
                # rebind EVERY loop local from the snapshot; the plumbing
                # object restores with its scheduler/heap/rng references
                # intact (one pickle graph → identities preserved)
                scheduler = state["scheduler"]
                agents = state["agents"]
                heap = state["events"]
                ex = state["exec"]
                dead_slices = state["dead_slices"]
                jct = state["jct"]
                arrival = state["arrival"]
                iterations = state["iterations"]
                now = state["now"]
                rng = state["rng"]
                tick_count = state["tick_count"]
                coord = state.get("repartition")
                planner = state.get("migration")
                restore_dispatch_faults(state["armed_faults"])
                if pipe is not None:
                    pipe = RoundPipeline(scheduler)

    if pipe is not None:
        pipe.flush()  # roll back any outstanding speculative bid statistics

    # ---- metrics ------------------------------------------------------------
    # utilization over the ACTIVE span [first arrival, last completion]: long
    # idle tails after the workload drains would otherwise dilute the metric
    t_first = min(arrival.values()) if arrival else 0.0
    t_last = max(jct[j] + arrival[j] for j in jct) if jct else min(now, cfg.t_end)
    horizon = max(t_last - t_first, 1e-9)
    per_slice = scheduler.utilization(t_first, t_last)
    slowdowns = []
    for jid, a in scheduler.agents.items():
        if jid in jct:
            ideal = a.spec.total_work  # thr=1 ⇒ seconds
            slowdowns.append(jct[jid] / max(ideal, 1e-9))
    jcts = np.array(list(jct.values())) if jct else np.array([np.nan])
    calibrator = getattr(scheduler, "calibrator", None)
    cal = calibrator.snapshot() if calibrator is not None else {}
    # attribution: baselines carry a scheduler-identifying ``name`` class
    # attribute and never dispatch through a clearing backend, so they
    # report that name alone — even when handed a Policy for its θ — while
    # JASDA schedulers report the Policy + backend that actually cleared
    sched_name = getattr(scheduler, "name", "")
    policy = None if sched_name else getattr(scheduler, "policy", None)
    # per-strategy aggregates: the mixed-strategy scenario axis.  Keyed on
    # BiddingStrategy.name; one row per strategy present in the population.
    strategy_stats: Dict[str, Dict[str, float]] = {}
    for a in agents:
        name = getattr(getattr(a, "strategy", None), "name", "")
        if not name:
            continue
        row = strategy_stats.setdefault(
            name,
            {"n_jobs": 0, "n_finished": 0, "n_bids": 0, "n_wins": 0,
             "score_won": 0.0},
        )
        row["n_jobs"] += 1
        row["n_finished"] += int(a.spec.job_id in jct)
        row["n_bids"] += a.n_bids
        row["n_wins"] += a.n_wins
        row["score_won"] += float(getattr(a, "score_won", 0.0))
    return SimResult(
        policy=sched_name or getattr(policy, "name", ""),
        clearing=getattr(getattr(policy, "clearing", None), "name", ""),
        utilization=float(np.mean(list(per_slice.values()))) if per_slice else 0.0,
        per_slice_utilization=per_slice,
        mean_jct=float(np.nanmean(jcts)),
        p95_jct=float(np.nanpercentile(jcts, 95)),
        # makespan = last completion − first arrival (NOT the largest per-job
        # JCT, which under-reports whenever the longest-running job arrived
        # after the first one)
        makespan=float(t_last - t_first) if jct else float("nan"),
        jain_slowdown=jain_index(slowdowns) if slowdowns else 1.0,
        n_finished=len(jct),
        n_jobs=len(agents),
        capacity_violations=ex.violations,
        # running totals survive commitment pruning (completed/failed
        # commitments leave the outstanding list; see scheduler.commit_log)
        n_committed=getattr(scheduler, "n_committed_total",
                            len(scheduler.commitments)),
        total_score=float(getattr(scheduler, "committed_score_total",
                                  sum(c.score for c in scheduler.commitments))),
        jct_per_job=jct,
        reliability={j: s["rho"] for j, s in cal.items()},
        calibration=cal,
        strategy_stats=strategy_stats,
        iterations=iterations,
        scheduler=scheduler,
        repartition=coord,
        n_preempted=int(getattr(scheduler, "n_preempted_total", 0)),
        n_migrated=int(getattr(scheduler, "n_migrated_total", 0)),
        n_lost_commitments=int(getattr(scheduler, "n_lost_total", 0)),
        work_credited=float(getattr(scheduler, "work_credited_total", 0.0)),
        loss_reasons=dict(getattr(scheduler, "loss_reasons", {})),
    )


# ---------------------------------------------------------------------------
# Synthetic workloads
# ---------------------------------------------------------------------------


def make_workload(
    n_jobs: int,
    *,
    seed: int = 0,
    arrival_rate: float = 0.2,
    work_range: Tuple[float, float] = (20.0, 200.0),
    mem_range_gb: Tuple[float, float] = (2.0, 14.0),
    qos_fraction: float = 0.3,
    misreport_fraction: float = 0.0,
    misreport_factor: float = 1.5,
    strategies: Optional[Sequence] = None,
    min_capacity_fraction: float = 0.0,
    min_capacity_range_gb: Tuple[float, float] = (8.0, 20.0),
    preempt_granularity: float = 0.0,
) -> List[JobAgent]:
    """Poisson arrivals, log-uniform work, warmup/steady/burst FMPs.

    ``strategies`` opens the mixed-strategy scenario axis: a sequence of
    ``repro.core.negotiation.BiddingStrategy`` instances assigned round-
    robin across the jobs (job i gets ``strategies[i % len(strategies)]``),
    so populations like half-greedy/half-adaptive stay deterministic per
    seed.  None keeps every job on the default GreedyChunking.

    ``min_capacity_fraction`` opens the heterogeneous-capacity axis
    (profile-sensitive repartition scenarios): that fraction of jobs
    draws a hard ``JobSpec.min_capacity`` floor from
    ``min_capacity_range_gb`` — such jobs bid zero on any smaller slice
    (``jobs.throughput_on``), so they strand on fragmented inventories.
    The default 0.0 draws nothing from the rng, keeping workloads
    byte-identical to earlier revisions.

    ``preempt_granularity`` sets every job's checkpointable progress
    granule (``JobSpec.preempt_granularity``, in work units) for the
    revocation ladder's preempt-with-credit rung.  Assigned uniformly
    without touching the rng, so the default 0.0 — all-or-nothing — is
    byte-identical to earlier revisions.
    """
    from .jobs import AgentConfig
    from .trp import fmp_standard

    rng = np.random.default_rng(seed)
    t = 0.0
    agents = []
    gb = 1 << 30
    for i in range(n_jobs):
        t += rng.exponential(1.0 / arrival_rate)
        work = float(np.exp(rng.uniform(np.log(work_range[0]), np.log(work_range[1]))))
        steady = rng.uniform(*mem_range_gb) * gb
        fmp = fmp_standard(0.3 * steady, steady, 0.1 * steady, rel_sigma=0.03)
        deadline = None
        if rng.uniform() < qos_fraction:
            deadline = t + work * rng.uniform(2.0, 6.0)
        min_cap = 0.0
        if min_capacity_fraction > 0.0 and rng.uniform() < min_capacity_fraction:
            min_cap = rng.uniform(*min_capacity_range_gb) * gb
        spec = JobSpec(
            job_id=f"J{i:03d}",
            arrival_time=t,
            total_work=work,
            fmp=fmp,
            qos_deadline=deadline,
            min_capacity=min_cap,
            preempt_granularity=preempt_granularity,
        )
        mis = misreport_factor if rng.uniform() < misreport_fraction else 1.0
        strategy = strategies[i % len(strategies)] if strategies else None
        agents.append(JobAgent(spec, AgentConfig(misreport=mis, strategy=strategy)))
    return agents
