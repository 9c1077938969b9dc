"""The JASDA scheduler (paper §3), refactored to batched auction rounds.

``JasdaScheduler`` owns the control plane.  It is configured by ONE unified
``repro.core.policy.Policy`` value — scoring weights, window ordering, age
curve, calibration, θ-recheck mode AND the pluggable clearing backend
(``GreedyWIS`` / ``GlobalAssignment`` / ``FairShare``) — constructed
directly (``JasdaScheduler(slices, Policy.utilization())``) or via the
named presets.  The legacy ``SchedulerConfig`` still works: its scattered
policy fragments are converted with :meth:`SchedulerConfig.to_policy` (a
DeprecationWarning points at the Policy API), and runtime knobs
(dead-window cooldown, score backend override, log caps, cache sizes) stay
on ``SchedulerConfig`` either way.

One :meth:`JasdaScheduler.run_round`
drives the paper's five-step cycle over ALL open capacity at once:

  * announce every eligible window across every slice   (windows.py, step 1)
  * pooled bid collection from registered JobAgents
    via the typed negotiation protocol
    (WindowAnnouncement → BidBundle)                    (jobs.py, steps 2–3)
  * ONE batched scoring dispatch + per-window WIS with
    cross-window conflict resolution                    (clearing.py, step 4)
  * commitment + bookkeeping + fairness/trust, then a
    RoundFeedback broadcast back to every bidder
    (negotiation/messages.py: cutoffs, awards, loss
    reasons, calibration state) — the clearing→agent
    feedback channel adaptive strategies learn from     (step 5)

The round is split into a **prepare** half (announce + bid collection +
packing + async scoring dispatch — :meth:`_prepare_round`) and a **settle**
half (block on scores, WIS + conflicts, commit — :meth:`_settle_round`).
``run_round`` composes them serially; :meth:`run_rounds_pipelined`
double-buffers them across consecutive rounds (core/pipeline.py): while
round k's scores are in flight on device, the host speculatively prepares
round k+1, and an epoch counter (``_epoch``, bumped by every state
mutation) guarantees a speculative preparation is only used when it is
provably byte-identical to what a serial preparation would produce.

The paper prototype's one-window-per-iteration loop (A3) survives as the
thin :meth:`JasdaScheduler.step` compatibility wrapper — a round restricted
to the single policy-preferred window — so external drivers (executor.py)
and the equivalence tests keep working unchanged.

Commitment bookkeeping is bounded: ``commitments`` holds only OUTSTANDING
commitments (settled ones are pruned on :meth:`complete`/:meth:`fail`);
the append-only ``commit_log`` keeps lightweight audit rows (no FMP/variant
references) with running totals, optionally capped via
``SchedulerConfig.max_log_rows`` together with the iteration ``log``.

The scheduler is execution-agnostic: the simulator (simulator.py) and a
real executor both feed back observations through
``complete()``/``fail()``.  That separation mirrors the paper's
architecture, where the scheduler reasons only over declared profiles and
ex-post measurements.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..runtime.monitor import retry_with_backoff
from .calibration import CalibrationConfig, Calibrator
from .clearing import assign_bids
from .fairness import AgePolicy, AgeTracker
from .faults import AgentFault
from .jobs import JobAgent
from .negotiation import RoundFeedback, WindowAnnouncement, build_feedback
from .negotiation.messages import (LOSS_SLICE_FAILED, LossReport,
                                   build_shed_feedback)
from .policy import ClearingPolicy, GreedyWIS, Policy
from .scoring import ScoringPolicy, score_round_async
from .types import (DEAD_WINDOW_EPS, ClearingResult, Commitment, JobSpec,
                    RoundResult, SliceSpec, Variant, Window)
from .windows import (DeadWindowRegistry, SliceTimeline, WindowPolicy,
                      announce_window, announce_windows)

__all__ = ["JasdaScheduler", "SchedulerConfig", "CommitRecord", "RoundPrep"]


@dataclass(frozen=True)
class SchedulerConfig:
    """Runtime knobs + (deprecated) scattered policy fragments.

    The policy surface — scoring / window / age / calibration / clearing
    backend / θ-recheck — now lives on the unified ``repro.core.policy.
    Policy`` object; pass one straight to ``JasdaScheduler``.  The fragment
    fields below keep working (converted via :meth:`to_policy`, with a
    DeprecationWarning from the scheduler when overridden), so legacy
    ``SchedulerConfig(scoring=..., window=...)`` construction is unchanged.
    Runtime knobs (cooldowns, backend override, cache/log caps) are NOT part
    of ``Policy`` and remain first-class here.
    """

    scoring: ScoringPolicy = ScoringPolicy()
    window: WindowPolicy = WindowPolicy()
    calibration: CalibrationConfig = CalibrationConfig()
    age: AgePolicy = AgePolicy()
    # windows announced but receiving no winning bids are excluded for this
    # much TIME (prevents re-announcing a dead gap forever)
    dead_window_cooldown: float = 8.0
    # epsilon for matching a re-derived gap against a suppressed window
    # (float drift from releases/early finishes must not resurrect it)
    dead_window_eps: float = DEAD_WINDOW_EPS
    # batched-scoring backend override: None = auto (host numpy below
    # scoring.SMALL_POOL_M bids, else the CUDA kernel on a CUDA device / its
    # plain torch version on the CPU); "numpy" | "torch" | "cuda" to force
    score_impl: Optional[str] = None
    # settle-side WIS backend (the device-resident batched settle): None =
    # the historical per-window host loop (byte-identical default);
    # "numpy" = batched host float64 (byte-identical, one DP loop per lane
    # for all windows); "torch" | "cuda" = kernels/wis_dp device launch
    # with the first WIS pass fused behind the scoring launch.  A runtime
    # knob like score_impl — it changes WHERE clearing runs, never what is
    # selected.
    wis_impl: Optional[str] = None
    # multi-device sharding of a round's device work: not ported yet, must
    # stay None (a non-None mesh is refused by JasdaScheduler)
    mesh: Optional[object] = None
    # torch device of the "torch" / "cuda" backends: the CUDA card unless
    # the caller asks for the CPU ("cpu").  "cuda" on a machine without a
    # card raises at scheduler construction; it never runs on the host.
    device: str = "cuda"
    # re-verify safety condition (a) in-dispatch with this θ against each
    # bid's OWN window capacity (per-variant capacities; heterogeneous
    # slices).  None = off: generation already enforces condition (a).
    # Scheduler-wide OVERRIDE: takes precedence over recheck_per_agent.
    recheck_theta: Optional[float] = None
    # re-verify with each bid's OWN agent θ (Variant.theta → PackedRound.
    # thetas) instead of one scheduler-wide bound
    recheck_per_agent: bool = False
    # round-clearing backend (repro.core.policy.ClearingPolicy); None =
    # GreedyWIS (the historical greedy semantics, byte-identical)
    clearing: Optional[ClearingPolicy] = None
    # bid-collection fault handling (active only when a fault gate is
    # installed — ``scheduler.fault_gate``): an erroring agent's respond()
    # is retried up to ``bid_retries`` times with capped exponential
    # backoff; silent agents and retry-exhausted agents are DROPPED for
    # the round (empty bid groups) so a faulty bidder never stalls it
    bid_retries: int = 2
    bid_backoff_base: float = 0.01
    bid_backoff_factor: float = 2.0
    bid_backoff_max: float = 0.25
    # bounded FMP-grid discretization cache (entries), scoped to this
    # scheduler instance — see kernels.jasda_score.ops.FMPGridCache
    grid_cache_size: int = 1024
    # cap on audit-trail rows (iteration log AND commit log); None = keep all
    max_log_rows: Optional[int] = None
    # the unified Policy this config was built from (the BLESSED way to
    # combine a Policy with runtime knobs — set directly or via
    # :meth:`from_policy`).  When present it takes precedence over the
    # legacy fragment fields above and suppresses the deprecation warning;
    # a real dataclass field so ``dataclasses.replace`` preserves it.
    policy: Optional[Policy] = None

    def to_policy(self) -> Policy:
        """The unified Policy: the ``policy`` field if set, else the lifted
        legacy fragments."""
        if self.policy is not None:
            return self.policy
        return Policy(
            name="legacy",
            scoring=self.scoring,
            window=self.window,
            age=self.age,
            calibration=self.calibration,
            clearing=self.clearing if self.clearing is not None else GreedyWIS(),
            recheck_theta=self.recheck_theta,
            per_agent_theta=self.recheck_per_agent,
        )

    def _policy_fragments_overridden(self) -> bool:
        """True when legacy policy kwargs were used (→ deprecation path)."""
        if self.policy is not None:
            return False  # unified path: fragments only mirror the Policy
        return (
            self.scoring != ScoringPolicy()
            or self.window != WindowPolicy()
            or self.calibration != CalibrationConfig()
            or self.age != AgePolicy()
            or self.recheck_theta is not None
            or self.recheck_per_agent
            or self.clearing is not None
        )

    @classmethod
    def from_policy(cls, policy: Policy, **runtime_kw) -> "SchedulerConfig":
        """Mirror a Policy into a SchedulerConfig (runtime knobs as kwargs).

        The fragment fields are populated for introspection, and the
        ``policy`` field keeps the original object authoritative (preset
        name included) — surviving ``dataclasses.replace`` and never
        triggering the scattered-kwargs DeprecationWarning.
        """
        return cls(
            scoring=policy.scoring,
            window=policy.window,
            calibration=policy.calibration,
            age=policy.age,
            recheck_theta=policy.recheck_theta,
            recheck_per_agent=policy.per_agent_theta,
            clearing=policy.clearing,
            policy=policy,
            **runtime_kw,
        )


@dataclass
class IterationLog:
    """One row of the scheduler's audit trail (transparency, paper §5(f)).

    In round mode a row covers the whole round: ``n_windows`` announced
    windows cleared together (``window`` keeps the first announced window
    for backward compatibility; None when the round was empty).
    """

    t: float
    window: Optional[Window]
    n_bidders: int
    n_bids: int
    n_selected: int
    total_score: float
    n_windows: int = 0
    n_conflicts: int = 0
    # agents dropped from THIS round's bid collection (silent / erroring
    # past the retry budget) — the audit trail of graceful degradation
    n_dropped: int = 0


@dataclass
class CommitRecord:
    """Lightweight audit row for one commitment (no variant/FMP retained).

    ``status`` tracks the commitment lifecycle: ``active`` →
    ``completed`` | ``failed`` | ``lost`` (slice died, progress torched) |
    ``preempted`` (interrupted with partial-progress credit) |
    ``migrated`` (residual re-placed on another slice; the successor row
    is a fresh ``active`` commit).  On early finishes ``t_end`` is
    truncated to the actually-executed end; ``work_credited`` records the
    granule-aligned progress kept by the preempt/migrate rungs of the
    revocation ladder (0.0 for every other status).
    """

    variant_id: str
    job_id: str
    slice_id: str
    t_start: float
    t_end: float
    commit_time: float
    score: float
    status: str = "active"
    work_credited: float = 0.0

    @property
    def interval(self) -> Tuple[float, float]:
        return (self.t_start, self.t_end)


@dataclass
class RoundPrep:
    """The prepared (host) half of one auction round, ready to settle.

    Produced by :meth:`JasdaScheduler._prepare_round`; the scoring dispatch
    (``handle``) may still be in flight on device.  ``epoch`` snapshots the
    scheduler state version the preparation was computed against — the
    pipeline only reuses a speculative prep whose epoch still matches.
    ``bids[a][k]`` holds agent a's bids on window k (agent-major pool
    order), so invalidated windows can be dropped without regenerating the
    surviving windows' bids.
    """

    now: float
    epoch: int
    windows: List[Window]
    agents: List[JobAgent] = field(default_factory=list)
    # per-agent bid groups (read-only; group containers may be tuples)
    bids: List[Sequence[Sequence[Variant]]] = field(default_factory=list)
    pool: List[Variant] = field(default_factory=list)
    fit: List[Variant] = field(default_factory=list)
    win_idx: object = None  # (F,) window index per fitting bid
    view: object = None  # types.PoolView aligned with ``fit``
    bidders: int = 0
    budget: Dict[str, float] = field(default_factory=dict)
    ages: Optional[Dict[str, float]] = None  # A_i(now), reused by settle
    handle: Optional[object] = None  # scoring.ScoreHandle
    # (F,) host array of ψ_energy per fitting bid when an EnergyModel is
    # attached (core/repartition.py); None = no energy term (historical)
    energy: Optional[object] = None
    # in-flight fused first-pass WIS chained on the scoring dispatch
    # (core.wis.SettlePrefetch; device wis_impl + prefetch-capable backend)
    wis_prefetch: Optional[object] = None
    stats_snap: Optional[Dict[str, Tuple[int, int]]] = None  # speculative only
    n_dropped: int = 0  # agents dropped by the bid-collection fault gate


class JasdaScheduler:
    def __init__(
        self,
        slices: Sequence[SliceSpec],
        config: Union[SchedulerConfig, Policy, None] = None,
    ):
        """``config`` is a unified ``Policy`` (preferred) or a legacy
        ``SchedulerConfig`` (deprecated when its policy fragments are
        overridden; runtime knobs alone do not warn)."""
        if config is None:
            config = SchedulerConfig()
        if isinstance(config, Policy):
            self.policy = config
            self.config = SchedulerConfig.from_policy(config)
        elif isinstance(config, SchedulerConfig):
            if config._policy_fragments_overridden():
                warnings.warn(
                    "configuring JasdaScheduler policy through scattered "
                    "SchedulerConfig kwargs (scoring/window/age/calibration/"
                    "recheck_theta/clearing) is deprecated; pass a unified "
                    "repro.core.policy.Policy (e.g. Policy.utilization()) "
                    "instead",
                    DeprecationWarning,
                    stacklevel=2,
                )
            # to_policy returns the authoritative ``policy`` field when set
            # (preset name included); hand-built legacy configs are lifted
            self.policy = config.to_policy()
            self.config = config
        else:
            raise TypeError(
                f"config must be a Policy or SchedulerConfig, got {type(config).__name__}"
            )
        if self.config.mesh is not None:
            raise NotImplementedError(
                "mesh-sharded rounds are not ported yet: SchedulerConfig.mesh "
                "must be None")
        from ..kernels.common import resolve_device

        # where the device backends run; raises now, not mid-run, when the
        # requested CUDA card is missing
        self.device = resolve_device(self.config.device)
        self.slices: Dict[str, SliceTimeline] = {
            s.slice_id: SliceTimeline(s) for s in slices
        }
        self.agents: Dict[str, JobAgent] = {}
        self.calibrator = Calibrator(self.policy.calibration)
        self.ages = AgeTracker(self.policy.age)
        # outstanding commitments only; settled ones are pruned (complete/
        # fail/drop_slice) and survive as commit_log rows + running totals
        self.commitments: List[Commitment] = []
        self.commit_log: List[CommitRecord] = []
        self.n_committed_total: int = 0
        self.committed_score_total: float = 0.0
        # keyed by id(variant): variant ids are only unique within a round
        # (jobs._make_variant), while outstanding commitments span rounds —
        # identity keying cannot collide because the Commitment in the entry
        # keeps its variant alive for exactly the entry's lifetime
        self._commit_index: Dict[int, Tuple[Commitment, CommitRecord]] = {}
        self.log: List[IterationLog] = []
        # the most recent RoundFeedback broadcast (negotiation channel)
        self.last_feedback: Optional[RoundFeedback] = None
        self.retired_intervals: Dict[str, List[Tuple[float, float]]] = {}
        # disruption accounting (the revocation ladder's audit surface):
        # commitments preempted with credit, migrated to another slice, or
        # lost outright, plus the total granule-aligned work credited and a
        # per-reason loss histogram (slice_failed / preempted / migrated)
        self.n_preempted_total: int = 0
        self.n_migrated_total: int = 0
        self.n_lost_total: int = 0
        self.work_credited_total: float = 0.0
        self.loss_reasons: Dict[str, int] = {}
        self._dead_windows = DeadWindowRegistry(eps=self.config.dead_window_eps)
        # state version: bumped by EVERY mutation that could change what a
        # future round announces, who bids, or how bids are scored.  The
        # round pipeline validates speculative preparations against it.
        self._epoch = 0
        # per-scheduler bounded FMP grid cache (replaces the old
        # process-global lru_cache, which leaked grids across instances)
        from ..kernels.jasda_score.ops import FMPGridCache

        self._grid_cache = FMPGridCache(maxsize=self.config.grid_cache_size)
        # sticky per-backend health shared by the scoring and settle
        # dispatches: one injected dispatch fault anywhere degrades BOTH
        # down the cuda → torch → numpy ladder (kernels.common.BackendHealth)
        from ..kernels.common import BackendHealth

        self.backend_health = BackendHealth()
        # bid-collection fault gate (faults.FaultInjector or any callable
        # ``gate(agent, now, attempt)`` raising faults.AgentFault); None =
        # fault-free collection, byte-identical to the historical path
        self.fault_gate = None
        # repartition-layer inputs (core/repartition.py), both None by
        # default so the historical behavior is byte-identical:
        # window_demand feeds the ``frag_aware`` announcement ordering;
        # energy_model gives ψ_energy a per-slice power figure
        self.window_demand: Optional[Tuple[float, ...]] = None
        self.energy_model = None
        # settle-side WIS backend (SchedulerConfig.wis_impl): the default is
        # the historical per-window host loop; the batched backends clear
        # every window of a round in one dispatch (core/wis.py)
        from .wis import make_round_selector

        self._wis_selector = make_round_selector(self.config.wis_impl,
                                                 health=self.backend_health,
                                                 device=self.device)

    # -- membership -----------------------------------------------------------
    def add_job(self, agent: JobAgent, now: float) -> None:
        self.agents[agent.spec.job_id] = agent
        self.ages.register_arrival(agent.spec.job_id, now)
        self._epoch += 1

    def remove_job(self, job_id: str) -> None:
        self.agents.pop(job_id, None)
        self.ages.remove(job_id)
        self._epoch += 1

    def add_slice(self, spec: SliceSpec) -> None:
        """Elastic scale-up: a new slice joins the pool mid-run."""
        self.slices[spec.slice_id] = SliceTimeline(spec)
        self._epoch += 1

    def drop_slice(self, slice_id: str, now: Optional[float] = None) -> List[Commitment]:
        """Slice failure/scale-down: returns the commitments that were lost."""
        tl = self.slices.pop(slice_id, None)
        if tl is not None:  # keep history for utilization accounting, but
            # only the part actually EXECUTED (future commitments are lost,
            # re-bid elsewhere — counting them would double-book busy time)
            ivs = tl.busy()
            if now is not None:
                ivs = [(s0, min(e0, now)) for s0, e0 in ivs if s0 < now]
            self.retired_intervals.setdefault(slice_id, []).extend(ivs)
        lost = [c for c in self.commitments if c.variant.slice_id == slice_id]
        self.commitments = [c for c in self.commitments if c.variant.slice_id != slice_id]
        for c in lost:
            entry = self._commit_index.pop(id(c.variant), None)
            if entry is not None:
                entry[1].status = "lost"
            agent = self.agents.get(c.variant.job_id)
            if agent is not None:
                agent.mark_settled(c.variant)  # work becomes biddable again
        if lost:
            self.n_lost_total += len(lost)
            self.loss_reasons["slice_failed"] = (
                self.loss_reasons.get("slice_failed", 0) + len(lost))
        self._epoch += 1
        return lost

    # -- fault handling (core/faults.py drives these) --------------------------
    def revoke_slice(self, slice_id: str, now: float) -> List[Commitment]:
        """Slice death with the FULL recovery protocol (beyond drop_slice).

        On top of :meth:`drop_slice` (commitments marked ``lost`` in the
        commit_log, their work re-entering the owning agents' biddable
        pools through ``mark_settled``), this (a) retires the slice's
        announced windows through the :class:`DeadWindowRegistry` so an
        ε-close twin re-derived after repair cannot resurrect immediately,
        and (b) broadcasts an out-of-round :class:`RoundFeedback` carrying
        one ``slice_failed`` :class:`LossReport` per revoked commitment, so
        adaptive strategies and calibration observe the revocation the same
        way they observe any other round outcome.  Returns the lost
        commitments (all of whose variants the atomizer will re-chunk on
        the next announcement).

        Idempotent: revoking an already-dead slice (not in the pool, no
        outstanding commitments) is a strict no-op — no duplicate ``lost``
        commit rows, no second ``slice_failed`` broadcast, no epoch bump,
        no dead-window churn.  Fault and repartition paths may race to the
        same revocation; only the first one observes anything.
        """
        if slice_id not in self.slices and not any(
                c.variant.slice_id == slice_id for c in self.commitments):
            return []
        tl = self.slices.get(slice_id)
        capacity = tl.spec.capacity_bytes if tl is not None else 0.0
        cooldown = now + self.config.dead_window_cooldown
        if self.last_feedback is not None:
            for w in self.last_feedback.windows:
                if w.slice_id == slice_id:
                    self._dead_windows.add(slice_id, w.t_min, cooldown)
        lost = self.drop_slice(slice_id, now=now)
        if not lost:
            return lost
        losses: Dict[str, List[LossReport]] = {}
        for c in lost:
            v = c.variant
            w = Window(slice_id, capacity, v.t_start, v.t_end - v.t_start)
            self._dead_windows.add(slice_id, v.t_start, cooldown)
            losses.setdefault(v.job_id, []).append(
                LossReport(v.variant_id, w, LOSS_SLICE_FAILED))
        reliability: Dict[str, float] = {}
        cal_err: Dict[str, float] = {}
        cal_bias: Dict[str, float] = {}
        for job_id in losses:
            st = self.calibrator.state(job_id)
            reliability[job_id] = float(st.rho)
            cal_err[job_id] = float(
                st.mean_error(self.calibrator.config.error_window))
            cal_bias[job_id] = float(st.bias)
        feedback = RoundFeedback(
            t=now, windows=(), cutoffs={}, awards={},
            losses={j: tuple(ls) for j, ls in losses.items()},
            reliability=reliability, calibration_error=cal_err,
            calibration_bias=cal_bias,
        )
        for job_id in losses:
            agent = self.agents.get(job_id)
            if agent is not None:
                agent.observe_feedback(feedback)
        self.last_feedback = feedback
        return lost

    def shed_job(self, job_id: str, now: float) -> bool:
        """Admission-control eviction (open-loop service back-pressure).

        Removes the job from the biddable pool and notifies its agent via
        an out-of-round :class:`RoundFeedback` carrying one ``shed``
        :class:`LossReport` (``negotiation.messages.LOSS_SHED``) — the
        admission-side mirror of :meth:`revoke_slice`'s ``slice_failed``
        broadcast.  The caller owns any outstanding commitments: queued
        chunks should be cancelled via ``fail`` (releasing reservations)
        before shedding; a chunk already running settles harmlessly
        against the departed agent (``complete``/``fail`` tolerate it).
        Unlike a settled round, the broadcast does NOT replace
        ``last_feedback`` (sheds are out-of-band; the last real round's
        window set must stay visible to revoke_slice's dead-window
        bookkeeping).  Returns False when the job is unknown.
        """
        agent = self.agents.get(job_id)
        if agent is None:
            return False
        self.remove_job(job_id)
        agent.observe_feedback(
            build_shed_feedback(now, [job_id], self.calibrator))
        return True

    def degrade_slice(self, slice_id: str, speed_factor: float) -> None:
        """Straggler injection: the slice keeps running at reduced speed.

        Declared capacity is unchanged (commitments stay valid); observed
        durations inflate, ex-post ε grows, and calibration shifts bids
        away — the paper's own trust machinery is the mitigation.
        """
        tl = self.slices.get(slice_id)
        if tl is None:
            return
        import dataclasses

        tl.spec = dataclasses.replace(
            tl.spec, speed=tl.spec.speed * float(speed_factor))
        self._epoch += 1

    def set_window_demand(self, demand) -> None:
        """Attach the pending pool's capacity-demand histogram (repartition
        layer) to window announcement.  Only the ``frag_aware`` ordering
        reads it; a change invalidates speculative preparations exactly
        like any other announcement input."""
        demand = tuple(demand) if demand is not None else None
        if demand != self.window_demand:
            self.window_demand = demand
            self._epoch += 1

    def retire_slice(self, slice_id: str, now: float) -> List[Commitment]:
        """Permanently remove a slice (repartition merge-away/power-gate).

        Runs the full :meth:`revoke_slice` recovery protocol when
        commitments are outstanding (commit-log ``lost`` rows,
        ``LOSS_SLICE_FAILED`` feedback), then retires the id's
        dead-window entries — a slice reborn later under the same
        canonical id (split/merge cycles reuse interval-derived names)
        must start with a clean suppression slate.
        """
        if any(c.variant.slice_id == slice_id for c in self.commitments):
            lost = self.revoke_slice(slice_id, now)
        else:
            lost = self.drop_slice(slice_id, now=now)
        self._dead_windows.drop_slice(slice_id)
        return lost

    def invalidate_speculation(self) -> None:
        """Bump the state epoch so in-flight speculative preparations are
        discarded (fault epochs: e.g. a dispatch fault armed between
        rounds must be observed by a FRESH dispatch, not a stale one)."""
        self._epoch += 1

    # -- the interaction cycle: batched auction rounds --------------------------
    def run_round(self, now: float) -> Optional[RoundResult]:
        """Run ONE auction round over every announceable window.

        Returns None when no window is announceable (idle control plane).
        """
        return self._settle_round(self._prepare_round(now))

    def run_rounds_pipelined(self, times: Sequence[float]) -> List[Optional[RoundResult]]:
        """Run consecutive rounds with host/device double-buffering.

        Semantically identical to ``[self.run_round(t) for t in times]`` —
        selections, commitments, logs and agent statistics are byte-for-byte
        equal (equivalence-tested) — but while round k's batched scores are
        in flight on device, the host already announces windows and
        collects/packs bids for round k+1.  See core/pipeline.py for the
        speculation-validation protocol.
        """
        from .pipeline import RoundPipeline

        times = list(times)
        pipe = RoundPipeline(self)
        out: List[Optional[RoundResult]] = []
        for i, t in enumerate(times):
            nxt = times[i + 1] if i + 1 < len(times) else None
            out.append(pipe.tick(t, next_time=nxt))
        pipe.flush()
        return out

    def step(self, now: float) -> Optional[ClearingResult]:
        """Legacy single-window iteration (paper A3): a one-window round.

        Thin compatibility wrapper over the round machinery; selections are
        identical to the pre-round per-window path (equivalence-tested).
        """
        self._dead_windows.prune(now)
        window = announce_window(
            self.slices, now, self.policy.window, exclude=self._dead_windows,
            demand=self.window_demand,
        )
        if window is None:
            self._append_log(IterationLog(now, None, 0, 0, 0, 0.0))
            return None
        rr = self._settle_round(self._build_prep(now, [window]))
        return rr.results[0]

    # -- prepare half: announce + bids + pack + async dispatch ----------------
    def _prepare_round(self, now: float, *, speculative: bool = False) -> RoundPrep:
        """Host-side half of a round: announce, collect bids, dispatch scores.

        With ``speculative=True`` the per-agent bid statistics are
        snapshotted (generation mutates them) so the pipeline can roll them
        back if the preparation is discarded; variant ids are deterministic
        (jobs.py), so generation itself is replayable.
        """
        self._dead_windows.prune(now)
        windows = announce_windows(
            self.slices, now, self.policy.window, exclude=self._dead_windows,
            demand=self.window_demand,
        )
        if not windows:
            return RoundPrep(now=now, epoch=self._epoch, windows=[])
        return self._build_prep(now, windows, speculative=speculative)

    def _build_prep(
        self, now: float, windows: List[Window], *, speculative: bool = False
    ) -> RoundPrep:
        # Steps 2–3: every job answers the full window set (or stays silent)
        # through the typed negotiation protocol (one WindowAnnouncement in,
        # one BidBundle per agent out).
        chips = {sid: tl.spec.n_chips for sid, tl in self.slices.items()}
        agents = list(self.agents.values())
        snap = (
            {a.spec.job_id: a.stats_snapshot() for a in agents}
            if speculative else None
        )
        announcement = WindowAnnouncement(
            now=now, windows=tuple(windows), chips=chips
        )
        # bundle groups are consumed read-only (pooling, pipeline refilter
        # rebuilds outer lists) — keep the frozen tuples, no unwrap copy
        bids, n_dropped = self._collect_bids(agents, announcement)
        prep = RoundPrep(
            now=now, epoch=self._epoch, windows=list(windows),
            agents=agents, bids=bids, stats_snap=snap, n_dropped=n_dropped,
        )
        self._finalize_prep(prep)
        return prep

    def _collect_bids(
        self, agents: List[JobAgent], announcement: WindowAnnouncement
    ) -> Tuple[List[Sequence[Sequence[Variant]]], int]:
        """Bid collection with a deadline: faulty bidders never stall a round.

        Without a fault gate this is exactly the historical comprehension
        (one ``respond()`` per agent).  With one, each attempt first passes
        through ``self.fault_gate(agent, now, attempt)``: a retryable
        fault (``AgentRespondError``) retries with capped exponential
        backoff up to ``config.bid_retries`` times; a non-retryable one
        (``AgentSilentError`` — the deadline expiring with no response)
        or an exhausted retry budget drops the agent for THIS round (empty
        bid groups, counted in ``IterationLog.n_dropped``).  The gate is
        evaluated at the ROUND time with deterministic attempt indices, so
        a speculative (pipelined) collection replays identically to a
        serial one.  Backoff sleeps are simulated-time no-ops: the round
        deadline is a modeling construct, not a wall-clock wait.
        """
        gate = self.fault_gate
        if gate is None:
            return [list(a.respond(announcement).by_window)
                    for a in agents], 0
        cfg = self.config
        empty: List[Sequence[Variant]] = [() for _ in announcement.windows]
        bids: List[Sequence[Sequence[Variant]]] = []
        dropped = 0
        now = announcement.now
        for a in agents:
            def _attempt(k: int, agent=a):
                gate(agent, now, k)
                return list(agent.respond(announcement).by_window)

            try:
                bids.append(retry_with_backoff(
                    _attempt,
                    retries=cfg.bid_retries,
                    base=cfg.bid_backoff_base,
                    factor=cfg.bid_backoff_factor,
                    max_delay=cfg.bid_backoff_max,
                    sleep=lambda _delay: None,
                    retryable=lambda e: isinstance(e, AgentFault)
                    and e.retryable,
                ))
            except AgentFault:
                bids.append(list(empty))
                dropped += 1
        return bids, dropped

    def _finalize_prep(self, prep: RoundPrep) -> None:
        """Pool assembly + packing + scoring dispatch for prepared bids.

        Factored out so the pipeline can re-run it after dropping the bids
        of invalidated (suppressed-since-speculation) windows.
        """
        pool: List[Variant] = []
        bidders = 0
        budget: Dict[str, float] = {}
        for agent, per_window in zip(prep.agents, prep.bids):
            n = sum(len(vs) for vs in per_window)
            if n:
                bidders += 1
                for vs in per_window:
                    pool.extend(vs)
                budget[agent.spec.job_id] = agent.biddable_work
        prep.pool = pool
        prep.bidders = bidders
        prep.budget = budget
        prep.fit, prep.win_idx, prep.view = assign_bids(prep.windows, pool)
        prep.handle = None
        prep.wis_prefetch = None
        prep.energy = None
        prep.ages = self.ages.ages(prep.now)
        if prep.fit:
            # Step 4a: ONE batched scoring launch, left in flight on the
            # CUDA stream — the settle half blocks on it; the pipeline
            # overlaps it with the next round's host work.
            prep.handle = score_round_async(
                prep.fit, prep.windows, prep.win_idx,
                self.policy.scoring,
                ages=prep.ages,
                calibrate=self.calibrator.calibrate,
                impl=self.config.score_impl,
                recheck_theta=self.policy.recheck_theta,
                per_agent_theta=self.policy.per_agent_theta,
                grid_cache=self._grid_cache,
                view=prep.view,
                health=self.backend_health,
                device=self.device,
            )
            # ψ_energy (repartition layer): per-bid slice-power feature,
            # folded into the settled scores on the host.  The Eq. 3 clip
            # is slack (Σβ ≤ 1, ψ ∈ [0,1]), so the host-side addition is
            # exactly the batched objective with one more fs column.
            beta_e = self.policy.scoring.betas.get("energy", 0.0)
            if self.energy_model is not None and beta_e > 0.0:
                lam = self.policy.scoring.lam
                psi = np.array(
                    [self.energy_model.psi(v.slice_id) for v in prep.fit],
                    np.float64)
                prep.energy = (1.0 - lam) * beta_e * psi
            # Step 4a': fused score→clear — with a device wis_impl the
            # ban-free first WIS pass is dispatched right behind the
            # scoring call, consuming the still-in-flight device scores.
            # Settle (and, pipelined, the next round's host prep) then
            # overlaps the whole score+clear chain instead of just scoring.
            # The energy adjustment lands AFTER the device dispatch, so the
            # prefetch (which would clear on pre-adjustment scores) is
            # skipped whenever the term is active.
            if prep.energy is None:
                from .wis import predispatch_settle

                prep.wis_prefetch = predispatch_settle(
                    self._wis_selector, self.policy.clearing,
                    len(prep.windows), prep.win_idx, prep.view, prep.handle,
                    ages=prep.ages)

    # -- settle half: block on scores, clear, commit ---------------------------
    def _settle_round(self, prep: RoundPrep) -> Optional[RoundResult]:
        if not prep.windows:
            self._append_log(IterationLog(prep.now, None, 0, 0, 0, 0.0))
            return None
        scores = prep.handle.result() if prep.handle is not None else np.zeros(0)
        if prep.energy is not None:
            scores = scores + prep.energy
        # Step 4b: selection + conflict resolution, dispatched through the
        # configured clearing backend (Policy.clearing; GreedyWIS default)
        # with the configured WIS selector; the fused first-pass prefetch is
        # forwarded only to backends that declare support for it (custom
        # backends with the original settle signature stay compatible).
        kw = {}
        if (prep.wis_prefetch is not None
                and getattr(self.policy.clearing, "supports_prefetch", False)):
            kw["prefetch"] = prep.wis_prefetch
        rr = self.policy.clearing.settle(
            prep.windows, prep.fit, prep.win_idx, scores,
            selector=self._wis_selector,
            work_budget=prep.budget, view=prep.view, ages=prep.ages,
            **kw,
        )

        # Step 5: commit winners; suppress windows that cleared empty.
        now = prep.now
        for result in rr.results:
            if result.selected:
                tl = self.slices[result.window.slice_id]
                for v, s in zip(result.selected, result.scores):
                    tl.commit(v.t_start, v.t_end)
                    self._record_commit(v, now, s)
                    self.ages.mark_selected(v.job_id, now)
                    agent = self.agents[v.job_id]
                    agent.n_wins += 1
                    agent.score_won += float(s)
                    agent.mark_committed(v)
            else:
                self._dead_windows.add(
                    result.window.slice_id,
                    result.window.t_min,
                    now + self.config.dead_window_cooldown,
                )
        # The clearing→agent feedback channel (the negotiation loop's
        # closing leg): publish one RoundFeedback broadcast — per-window
        # winning-score cutoffs, per-job awards/losses with reasons, and the
        # §4.2.1 calibration state — to every agent of the round.  A
        # strategy that adapts (observe_feedback → True) could bid
        # differently next round, so it invalidates speculative
        # preparations exactly like a state mutation: epoch-validated, the
        # same protocol that guards dead windows (core/pipeline.py).
        feedback = build_feedback(
            now, prep.windows, prep.agents, prep.bids, rr, self.calibrator,
            view=prep.view, win_idx=prep.win_idx,
        )
        adapted = False
        for agent in prep.agents:
            if agent.observe_feedback(feedback):
                adapted = True
        self.last_feedback = feedback

        if rr.selected or adapted:
            # timelines, agent budgets, ages or strategy state changed:
            # invalidate any speculative preparation built against the
            # pre-settle state
            self._epoch += 1

        rr.n_bidders = prep.bidders
        self._append_log(
            IterationLog(
                now, prep.windows[0], prep.bidders, rr.n_bids, len(rr.selected),
                rr.total_score, n_windows=len(prep.windows),
                n_conflicts=rr.n_conflicts, n_dropped=prep.n_dropped,
            )
        )
        return rr

    # -- bounded bookkeeping ---------------------------------------------------
    def _record_commit(self, v: Variant, now: float, score: float) -> None:
        c = Commitment(variant=v, commit_time=now, score=score)
        rec = CommitRecord(
            variant_id=v.variant_id, job_id=v.job_id, slice_id=v.slice_id,
            t_start=v.t_start, t_end=v.t_end, commit_time=now,
            score=float(score),
        )
        self.commitments.append(c)
        self._commit_index[id(v)] = (c, rec)
        self.commit_log.append(rec)
        self.n_committed_total += 1
        self.committed_score_total += float(score)
        cap = self.config.max_log_rows
        if cap is not None and len(self.commit_log) > cap:
            del self.commit_log[: len(self.commit_log) - cap]

    def _append_log(self, row: IterationLog) -> None:
        self.log.append(row)
        cap = self.config.max_log_rows
        if cap is not None and len(self.log) > cap:
            del self.log[: len(self.log) - cap]

    def _prune_commitment(self, variant: Variant, status: str) -> Optional[CommitRecord]:
        # identity lookup: complete()/fail() receive the committed Variant
        # object back from the executor/simulator (an equal-but-distinct
        # object would simply not prune — never corrupt)
        entry = self._commit_index.pop(id(variant), None)
        if entry is None:
            return None
        c, rec = entry
        rec.status = status
        try:
            self.commitments.remove(c)
        except ValueError:
            pass  # already removed (e.g. slice dropped concurrently)
        return rec

    # -- ex-post feedback (paper §4.2.1) -----------------------------------------
    def complete(
        self,
        variant: Variant,
        observed_features: Dict[str, float],
        *,
        observed_utility: Optional[float] = None,
        work_done: Optional[float] = None,
        actual_end: Optional[float] = None,
    ) -> float:
        """Ingest execution ground truth for a committed variant.

        Updates calibration state (ρ_J, HistAvg) and job progress; prunes the
        commitment from the outstanding set (its audit row survives in
        ``commit_log`` as ``completed``); if the subjob finished EARLY, the
        reclaimed tail of its committed interval is released back to the
        timeline (new window for future rounds) and the audit row's end is
        truncated to the executed end.
        """
        eps = self.calibrator.verify(variant, observed_features, observed_utility)
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.mark_settled(variant)
            agent.record_progress(
                work_done if work_done is not None else variant.payload["work"]
            )
        rec = self._prune_commitment(variant, "completed")
        if actual_end is not None and actual_end < variant.t_end - 1e-9:
            tl = self.slices.get(variant.slice_id)
            if tl is not None:
                tl.release(variant.t_start, variant.t_end)
                tl.commit(variant.t_start, actual_end)
            if rec is not None:
                rec.t_end = actual_end
        self._epoch += 1
        return eps

    def fail(self, variant: Variant, now: float) -> None:
        """A committed subjob died (node failure): release its reservation.

        The job's progress for the chunk is NOT recorded (it restarts from
        the last checkpoint boundary = chunk start), and the slice becomes
        free from ``now`` — exactly the recovery path atomization buys.
        """
        tl = self.slices.get(variant.slice_id)
        if tl is not None:
            tl.release(variant.t_start, variant.t_end)
            occupied_until = min(now, variant.t_end)
            if occupied_until > variant.t_start:
                tl.commit(variant.t_start, occupied_until)  # occupancy until death
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.mark_settled(variant)
        self._prune_commitment(variant, "failed")
        self._epoch += 1

    def preempt(
        self,
        variant: Variant,
        now: float,
        *,
        work_done: float = 0.0,
        observed_features: Optional[Dict[str, float]] = None,
    ) -> Optional[CommitRecord]:
        """Interrupt a committed subjob, keeping granule-aligned progress.

        The preempt-with-credit rung of the revocation ladder: like
        :meth:`fail` the reservation is released (occupancy kept up to
        ``now``), but ``work_done`` — the completed ``preempt_granularity``
        granules, computed by the caller from the observed execution — is
        credited through ``JobAgent.record_progress``, so only the residual
        re-enters the biddable pool.  When the caller supplies the partial
        observation, calibration ingests the OBSERVED partial speed instead
        of discarding the sample.  The audit row becomes ``preempted`` with
        ``work_credited`` set and ``t_end`` truncated to the executed end.
        Returns the audit row, or None for an unknown commitment.
        """
        if id(variant) not in self._commit_index:
            return None
        if observed_features:
            self.calibrator.verify(variant, observed_features)
        tl = self.slices.get(variant.slice_id)
        if tl is not None:
            tl.release(variant.t_start, variant.t_end)
            occupied_until = min(now, variant.t_end)
            if occupied_until > variant.t_start:
                tl.commit(variant.t_start, occupied_until)
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.mark_settled(variant)
            if work_done > 0.0:
                agent.record_progress(work_done)
        rec = self._prune_commitment(variant, "preempted")
        if rec is not None:
            rec.work_credited = float(work_done)
            rec.t_end = max(variant.t_start, min(now, variant.t_end))
        self.n_preempted_total += 1
        self.work_credited_total += float(work_done)
        self.loss_reasons["preempted"] = (
            self.loss_reasons.get("preempted", 0) + 1)
        self._epoch += 1
        return rec

    def migrate_commitment(
        self,
        variant: Variant,
        now: float,
        *,
        slice_id: str,
        t_start: float,
        duration: float,
        residual_work: float,
        credited_work: float = 0.0,
        observed_features: Optional[Dict[str, float]] = None,
    ) -> Optional[Variant]:
        """Re-place a commitment's residual work on a surviving slice.

        The migrate rung of the revocation ladder: the old placement is
        vacated exactly like :meth:`preempt` (occupancy kept to ``now``,
        ``credited_work`` granules recorded as progress, partial
        observation fed to calibration), its audit row becomes
        ``migrated``, and a successor variant carrying ``residual_work``
        is committed at ``(slice_id, t_start, duration)`` — the commit
        score carries over, migration is not a re-auction.  The caller
        owns placement feasibility (capacity, windows, dead-window
        suppression: :class:`~repro.core.repartition.MigrationPlanner`);
        this method enforces only the timeline's own no-overlap invariant.
        Returns the successor variant, or None for an unknown commitment
        or a target slice not in the pool.
        """
        import dataclasses

        entry = self._commit_index.get(id(variant))
        tl_new = self.slices.get(slice_id)
        if entry is None or tl_new is None:
            return None
        c, _rec = entry
        if observed_features:
            self.calibrator.verify(variant, observed_features)
        tl = self.slices.get(variant.slice_id)
        if tl is not None:
            tl.release(variant.t_start, variant.t_end)
            occupied_until = min(now, variant.t_end)
            if occupied_until > variant.t_start:
                tl.commit(variant.t_start, occupied_until)
        agent = self.agents.get(variant.job_id)
        if agent is not None:
            agent.mark_settled(variant)
            if credited_work > 0.0:
                agent.record_progress(credited_work)
        old_rec = self._prune_commitment(variant, "migrated")
        if old_rec is not None:
            old_rec.work_credited = float(credited_work)
            old_rec.t_end = max(variant.t_start, min(now, variant.t_end))
        payload = (dict(variant.payload)
                   if isinstance(variant.payload, dict) else {})
        payload["work"] = float(residual_work)
        new_v = dataclasses.replace(
            variant,
            slice_id=slice_id,
            t_start=t_start,
            duration=duration,
            payload=payload,
            variant_id=variant.variant_id + "~mig",
        )
        tl_new.commit(t_start, t_start + duration)
        self._record_commit(new_v, now, c.score)
        if agent is not None:
            agent.mark_committed(new_v)
        self.n_migrated_total += 1
        self.work_credited_total += float(credited_work)
        self.loss_reasons["migrated"] = (
            self.loss_reasons.get("migrated", 0) + 1)
        self._epoch += 1
        return new_v

    # -- checkpointing (crash recovery; checkpoint/store.py) -------------------
    def __getstate__(self):
        """Picklable state for checkpointed crash recovery.

        ``_commit_index`` is keyed by ``id(variant)`` — identities do not
        survive a pickle round-trip, so the index is serialized as its
        entry list and re-keyed on the restored variant objects in
        :meth:`__setstate__`.  Pickling the scheduler TOGETHER with any
        simulator state that shares its Variant objects (one combined
        dump) preserves those identities across the boundary, which is
        what makes ``complete()``/``fail()`` identity lookups keep working
        after a restore.
        """
        state = self.__dict__.copy()
        state["_commit_index"] = list(self._commit_index.values())
        return state

    def __setstate__(self, state):
        entries = state.pop("_commit_index")
        self.__dict__.update(state)
        self._commit_index = {
            id(c.variant): (c, rec) for c, rec in entries}
        # checkpoints taken before the repartition layer existed
        self.__dict__.setdefault("window_demand", None)
        self.__dict__.setdefault("energy_model", None)
        # checkpoints taken before the preemption/migration subsystem
        self.__dict__.setdefault("n_preempted_total", 0)
        self.__dict__.setdefault("n_migrated_total", 0)
        self.__dict__.setdefault("n_lost_total", 0)
        self.__dict__.setdefault("work_credited_total", 0.0)
        self.__dict__.setdefault("loss_reasons", {})

    # -- reporting ------------------------------------------------------------
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
