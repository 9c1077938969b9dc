"""Dynamic repartitioning: the slice inventory as an online decision variable.

Every scenario before this module ran a FIXED slice inventory.  The MIG
literature treats partition layout as online state instead: fragmentation-
aware scheduling on shared GPUs (Ting et al., arXiv 2512.16099) and
energy-efficient dynamic repartitioning (Lipe et al., arXiv 2606.25082).
This module makes the JASDA pod behave the same way, while the auction
core barely changes — repartition events are just window births/deaths
through the machinery that already exists:

* a **profile lattice** (:class:`SliceProfile` / :class:`ProfileLattice`)
  constrains the shapes a slice may take: pow2 ``n_chips`` partitions of
  the pod, MIG-style, each with a ``power_watts`` figure that finally
  gives ψ_energy in ``core/scoring.py`` a real slice-side model;
* a **buddy layout** (:class:`RepartitionState`) maps every slice to an
  aligned pow2 chip interval of the pod, so split/merge legality is the
  classic buddy-allocator rule — merge only *siblings* (the two aligned
  halves of one parent interval), split only within the lattice — and
  split/merge products get canonical interval-derived ids
  (``p<offset>c<n>``) that stay bounded under repeated cycles;
* a **policy protocol** (:class:`RepartitionPolicy`) with three backends:
  :class:`StaticInventory` (default; proposes nothing, byte-identical to
  a run without the subsystem), :class:`FragmentationAware` (split/merge
  driven by :func:`fragmentation_index` over announced window capacities
  vs. the pending pool's ``min_capacity`` demand histogram, which also
  feeds the ``frag_aware`` ``WindowPolicy`` ordering), and
  :class:`EnergyAware` (consolidate-and-power-gate idle slices, λ_energy
  per profile);
* a **coordinator** (:class:`RepartitionCoordinator`) that executes moves
  safely BETWEEN rounds: busy slices drain first (the move waits up to
  ``drain_grace`` ticks for outstanding commitments to settle), then the
  slice leaves through ``revoke_slice`` — commit-log ``lost`` rows,
  ``LOSS_SLICE_FAILED`` feedback — exactly like a slice failure; merged-
  away ids retire their ``DeadWindowRegistry`` entries
  (:meth:`DeadWindowRegistry.drop_slice`) so a slice reborn later under
  the same canonical id starts clean; every mutation goes through
  scheduler methods that bump the state epoch, so pipelined speculation
  stays byte-identical; new slices announce through the normal
  ``add_slice`` path; and the whole coordinator is picklable plain data,
  so repartition state rides crash checkpoints with the rest of the run.

Integration knobs: ``SimConfig.repartition`` / ``simulate(...)`` in
``core/simulator.py`` and ``ServiceConfig.repartition`` (periodic
``_REPARTITION`` events on the service's :class:`EventHeap`) in
``service/engine.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .types import SliceSpec

__all__ = [
    "SliceProfile",
    "ProfileLattice",
    "RepartitionState",
    "Move",
    "RepartitionContext",
    "RepartitionPolicy",
    "StaticInventory",
    "FragmentationAware",
    "EnergyAware",
    "EnergyModel",
    "RepartitionCoordinator",
    "MigrationConfig",
    "MigrationPlanner",
    "fragmentation_index",
]

GB = 1024.0**3


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# ---------------------------------------------------------------------------
# profile lattice
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SliceProfile:
    """One legal slice shape: a pow2 ``n_chips`` partition of the pod.

    ``power_watts`` is the busy-power draw of a slice instantiated from
    this profile; ``idle_watts`` the draw while the slice is live but has
    nothing running.  A power-gated slice draws nothing.
    """

    n_chips: int
    capacity_bytes: float
    power_watts: float
    idle_watts: float = 0.0

    def __post_init__(self):
        if not _is_pow2(self.n_chips):
            raise ValueError(f"profile n_chips must be pow2, got {self.n_chips}")
        if self.capacity_bytes <= 0:
            raise ValueError("profile capacity must be positive")
        if self.idle_watts > self.power_watts:
            raise ValueError("idle_watts cannot exceed power_watts")

    @property
    def name(self) -> str:
        return f"{self.n_chips}c"


@dataclass(frozen=True)
class ProfileLattice:
    """The set of legal slice shapes, indexed by ``n_chips``.

    Split legality: a profile splits only when the half-size profile is
    in the lattice.  Merge legality: two slices merge only when they are
    buddy *siblings* (checked by :class:`RepartitionState`) AND the
    double-size profile is in the lattice.
    """

    profiles: Tuple[SliceProfile, ...]

    def __post_init__(self):
        sizes = [p.n_chips for p in self.profiles]
        if not sizes:
            raise ValueError("lattice needs at least one profile")
        if len(set(sizes)) != len(sizes):
            raise ValueError("duplicate profile sizes in lattice")
        object.__setattr__(
            self, "profiles",
            tuple(sorted(self.profiles, key=lambda p: p.n_chips)))

    # -- lookup -------------------------------------------------------------
    def profile_for(self, n_chips: int) -> SliceProfile:
        for p in self.profiles:
            if p.n_chips == n_chips:
                return p
        raise KeyError(f"no {n_chips}-chip profile in lattice "
                       f"(have {[p.n_chips for p in self.profiles]})")

    def has(self, n_chips: int) -> bool:
        return any(p.n_chips == n_chips for p in self.profiles)

    @property
    def max_power(self) -> float:
        return max(p.power_watts for p in self.profiles)

    # -- move legality ------------------------------------------------------
    def can_split(self, n_chips: int) -> bool:
        return n_chips > 1 and self.has(n_chips) and self.has(n_chips // 2)

    def can_merge(self, n_chips: int) -> bool:
        return self.has(n_chips) and self.has(n_chips * 2)

    def spec_for(self, slice_id: str, n_chips: int, *,
                 template: Optional[SliceSpec] = None) -> SliceSpec:
        """Instantiate a :class:`SliceSpec` of a lattice profile.

        ``template`` donates the per-chip hardware figures (flops, HBM
        bandwidth, speed) so split/merge products inherit the pod's
        hardware model rather than the SliceSpec defaults.
        """
        p = self.profile_for(n_chips)
        if template is not None:
            return replace(template, slice_id=slice_id,
                           capacity_bytes=p.capacity_bytes, n_chips=n_chips)
        return SliceSpec(slice_id=slice_id, capacity_bytes=p.capacity_bytes,
                         n_chips=n_chips)

    # -- constructors -------------------------------------------------------
    @classmethod
    def default(cls, *, chip_capacity_gb: float = 5.0, max_chips: int = 8,
                watts_per_chip: float = 350.0,
                idle_fraction: float = 0.15) -> "ProfileLattice":
        """A full pow2 ladder 1..max_chips with linear capacity/power."""
        if not _is_pow2(max_chips):
            raise ValueError("max_chips must be pow2")
        profs = []
        n = 1
        while n <= max_chips:
            w = watts_per_chip * n
            profs.append(SliceProfile(
                n_chips=n, capacity_bytes=chip_capacity_gb * n * GB,
                power_watts=w, idle_watts=idle_fraction * w))
            n <<= 1
        return cls(tuple(profs))

    @classmethod
    def infer(cls, specs: Sequence[SliceSpec], *,
              watts_per_chip: float = 350.0,
              idle_fraction: float = 0.15) -> "ProfileLattice":
        """Derive a lattice from an existing inventory.

        Per-chip capacity is taken from the inventory (it must be
        consistent across slices — the buddy layout needs one chip unit);
        the ladder spans 1 chip up to the pod's pow2 envelope.
        """
        if not specs:
            raise ValueError("cannot infer a lattice from an empty inventory")
        per_chip = {round(s.capacity_bytes / max(1, s.n_chips), 3) for s in specs}
        if len(per_chip) != 1:
            raise ValueError(
                f"inconsistent per-chip capacity across inventory: {sorted(per_chip)}")
        chip_cap = per_chip.pop()
        pod = _next_pow2(sum(max(1, s.n_chips) for s in specs))
        return cls.default(chip_capacity_gb=chip_cap / GB, max_chips=pod,
                           watts_per_chip=watts_per_chip,
                           idle_fraction=idle_fraction)


# ---------------------------------------------------------------------------
# buddy layout
# ---------------------------------------------------------------------------

def canonical_id(offset: int, n_chips: int) -> str:
    """Interval-derived slice id: bounded and deterministic under repeated
    split/merge cycles (the same interval always rebuilds the same id)."""
    return f"p{offset}c{n_chips}"


@dataclass
class RepartitionState:
    """Buddy-allocator view of the pod: slice id -> aligned chip interval.

    Invariants: every interval is ``(offset, n_chips)`` with pow2
    ``n_chips`` and ``offset % n_chips == 0``; live + gated intervals are
    pairwise disjoint.  Gated slices keep their interval (their chips are
    powered off, not reassigned) and their spec, so an ungate restores
    them exactly.
    """

    pod_chips: int
    intervals: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    gated: Dict[str, SliceSpec] = field(default_factory=dict)
    idle_streak: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def adopt(cls, specs: Sequence[SliceSpec],
              lattice: ProfileLattice) -> "RepartitionState":
        """Deterministically place an existing inventory on the pod.

        Largest slices first (ties by id), first-fit at the lowest aligned
        offset — the placement is a pure function of the inventory, so two
        runs adopting the same slices agree on every buddy relationship.
        """
        pod = _next_pow2(sum(max(1, s.n_chips) for s in specs))
        state = cls(pod_chips=pod)
        taken: List[Tuple[int, int]] = []
        for s in sorted(specs, key=lambda s: (-s.n_chips, s.slice_id)):
            n = max(1, s.n_chips)
            if not _is_pow2(n):
                raise ValueError(
                    f"slice {s.slice_id} has non-pow2 n_chips={s.n_chips}; "
                    "the buddy layout needs pow2 slices")
            off = 0
            while off + n <= pod:
                if all(off + n <= o or off >= o + m for o, m in taken):
                    break
                off += n
            else:
                raise ValueError(f"inventory does not fit a {pod}-chip pod")
            taken.append((off, n))
            state.intervals[s.slice_id] = (off, n)
        return state

    # -- buddy relations ----------------------------------------------------
    def interval(self, slice_id: str) -> Tuple[int, int]:
        return self.intervals[slice_id]

    def buddy_of(self, slice_id: str) -> Optional[str]:
        """The sibling slice id, if the buddy interval is live as ONE slice."""
        off, n = self.intervals[slice_id]
        boff = off ^ n
        for sid, (o, m) in self.intervals.items():
            if o == boff and m == n and sid != slice_id:
                return sid
        return None

    def mergeable_pairs(self, lattice: ProfileLattice,
                        live=None) -> List[Tuple[str, str]]:
        """All sibling pairs whose merge is lattice-legal, largest first,
        deterministic order.  ``live`` restricts candidates to slices
        currently in the scheduler pool (a fault-revoked slice keeps its
        interval but cannot merge until repaired)."""
        out = []
        seen = set()
        for sid in sorted(self.intervals):
            if sid in seen or sid in self.gated:
                continue
            if live is not None and sid not in live:
                continue
            b = self.buddy_of(sid)
            if b is None or b in self.gated:
                continue
            if live is not None and b not in live:
                continue
            _, n = self.intervals[sid]
            if lattice.can_merge(n):
                seen.add(sid)
                seen.add(b)
                out.append(tuple(sorted((sid, b))))
        out.sort(key=lambda p: (-self.intervals[p[0]][1], p))
        return out

    # -- move application (layout only; the coordinator drives the pool) ----
    def split_ids(self, slice_id: str) -> Tuple[str, str]:
        off, n = self.intervals[slice_id]
        if n < 2:
            raise ValueError(f"{slice_id} is a 1-chip slice; cannot split")
        h = n // 2
        return canonical_id(off, h), canonical_id(off + h, h)

    def apply_split(self, slice_id: str) -> Tuple[Tuple[str, int], Tuple[str, int]]:
        off, n = self.intervals.pop(slice_id)
        h = n // 2
        a, b = canonical_id(off, h), canonical_id(off + h, h)
        self.intervals[a] = (off, h)
        self.intervals[b] = (off + h, h)
        self.idle_streak.pop(slice_id, None)
        return (a, h), (b, h)

    def apply_merge(self, a: str, b: str) -> Tuple[str, int]:
        (oa, na), (ob, nb) = self.intervals[a], self.intervals[b]
        if na != nb or (oa ^ na) != ob:
            raise ValueError(
                f"{a} and {b} are not buddy siblings "
                f"({(oa, na)} vs {(ob, nb)}); merge only siblings")
        off = min(oa, ob)
        parent = canonical_id(off, 2 * na)
        del self.intervals[a]
        del self.intervals[b]
        self.intervals[parent] = (off, 2 * na)
        self.idle_streak.pop(a, None)
        self.idle_streak.pop(b, None)
        return parent, 2 * na


# ---------------------------------------------------------------------------
# fragmentation metric
# ---------------------------------------------------------------------------

def fragmentation_index(capacities: Sequence[float],
                        demands: Sequence[Tuple[float, float]]) -> float:
    """Demand-weighted stranded-work fraction, in [0, 1].

    ``capacities`` are the live announceable window capacities (windows
    inherit their slice's capacity, so the live slice capacities ARE the
    announcement-side histogram); ``demands`` is the pending pool's
    capacity-demand histogram as ``(remaining_work, min_capacity)`` rows.
    The index is the fraction of pending work whose ``min_capacity`` no
    single live slice can satisfy — work stranded purely by partition
    LAYOUT, the quantity a merge can recover (Ting et al.'s notion of
    fragmented-but-free capacity, adapted to the auction's window model).
    """
    total = sum(w for w, _ in demands)
    if total <= 0.0:
        return 0.0
    cmax = max(capacities, default=0.0)
    stranded = sum(w for w, mc in demands if mc > cmax)
    return stranded / total


# ---------------------------------------------------------------------------
# policy protocol + backends
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Move:
    """One repartition action; ``targets`` are the consumed slice ids."""

    kind: str  # "split" | "merge" | "gate" | "ungate"
    targets: Tuple[str, ...]


@dataclass(frozen=True)
class RepartitionContext:
    """Read-only snapshot a policy decides from (built by the coordinator)."""

    now: float
    specs: Mapping[str, SliceSpec]  # live inventory
    busy: frozenset  # slice ids with outstanding/running work
    gated: Mapping[str, SliceSpec]
    # pending pool: (remaining biddable work, min_capacity) per live job
    demand: Tuple[Tuple[float, float], ...]
    fragmentation: float
    backlog_work: float
    idle_streak: Mapping[str, int]
    lattice: ProfileLattice
    state: RepartitionState


class RepartitionPolicy:
    """Protocol: propose moves for one repartition tick.

    Implementations must be picklable (they ride crash checkpoints) and
    deterministic in the context — the coordinator calls ``propose`` at
    most once per tick and executes moves in list order.
    """

    name = "abstract"
    #: when True the coordinator attaches an :class:`EnergyModel` to the
    #: scheduler so ψ_energy scores placements by profile power draw
    energy_score = False

    def propose(self, ctx: RepartitionContext) -> List[Move]:
        raise NotImplementedError

    def window_demand(self, ctx: RepartitionContext) -> Optional[Tuple[float, ...]]:
        """Capacity-demand histogram for ``frag_aware`` announcement
        ordering (None = leave the scheduler's ordering input unchanged)."""
        return None


@dataclass(frozen=True)
class StaticInventory(RepartitionPolicy):
    """The default: never repartition.  A run with this policy is
    byte-identical to one without the repartition subsystem at all (the
    coordinator proposes nothing, touches nothing, bumps no epochs)."""

    name = "static"

    def propose(self, ctx: RepartitionContext) -> List[Move]:
        return []


@dataclass(frozen=True)
class FragmentationAware(RepartitionPolicy):
    """Split/merge driven by the stranded-work fragmentation index.

    Merge pressure: when more than ``merge_threshold`` of pending work is
    stranded (its ``min_capacity`` exceeds every live slice), merge the
    largest lattice-legal sibling pair — repeatedly, one move per tick,
    climbing the lattice until a slice big enough exists.  Split
    pressure: when nothing is stranded but the queue is crowded (more
    than ``split_queue_factor`` pending jobs per live slice), split the
    largest slice whose halves still satisfy every pending
    ``min_capacity`` — more windows per round, no new stranding.
    """

    name = "frag"
    merge_threshold: float = 0.05
    split_queue_factor: float = 4.0

    def propose(self, ctx: RepartitionContext) -> List[Move]:
        if ctx.fragmentation > self.merge_threshold:
            pairs = ctx.state.mergeable_pairs(ctx.lattice, live=ctx.specs)
            if pairs:
                return [Move("merge", pairs[0])]
            return []
        if not ctx.demand or ctx.fragmentation > 0.0:
            return []
        n_live = len(ctx.specs)
        if len(ctx.demand) <= self.split_queue_factor * max(1, n_live):
            return []
        max_mc = max(mc for _, mc in ctx.demand)
        best = None
        for sid in sorted(ctx.specs, key=lambda s: (-ctx.specs[s].n_chips, s)):
            n = ctx.specs[sid].n_chips
            if not ctx.lattice.can_split(n):
                continue
            half = ctx.lattice.profile_for(n // 2)
            if half.capacity_bytes >= max_mc:
                best = sid
                break
        return [Move("split", (best,))] if best else []

    def window_demand(self, ctx: RepartitionContext) -> Optional[Tuple[float, ...]]:
        return tuple(sorted({mc for _, mc in ctx.demand if mc > 0.0}))


@dataclass(frozen=True)
class EnergyAware(RepartitionPolicy):
    """Consolidate-and-power-gate idle slices (Lipe et al.'s direction).

    A slice idle for ``gate_after`` consecutive repartition ticks is a
    gating candidate; candidates are gated one per tick in order of
    λ_energy-weighted idle draw (biggest saving first), always keeping
    ``min_active`` slices live.  Idle sibling pairs consolidate (merge)
    before gating, so the pod gates big units rather than stranding
    half-parents.  When backlog per live slice exceeds
    ``ungate_backlog``, gated slices return (largest first) through the
    normal announcement path.  ``lam_energy`` scales each profile's draw
    in the gating order (per-profile λ_energy; default 1.0).
    """

    name = "energy"
    energy_score = True
    gate_after: int = 2
    min_active: int = 1
    ungate_backlog: float = 50.0
    lam_energy: Optional[Tuple[Tuple[str, float], ...]] = None

    def _lam(self, profile: SliceProfile) -> float:
        if self.lam_energy:
            for name, lam in self.lam_energy:
                if name == profile.name:
                    return lam
        return 1.0

    def propose(self, ctx: RepartitionContext) -> List[Move]:
        n_live = len(ctx.specs)
        # ungate first: backlog outranks savings
        if ctx.gated and ctx.backlog_work > self.ungate_backlog * max(1, n_live):
            sid = max(sorted(ctx.gated), key=lambda s: ctx.gated[s].capacity_bytes)
            return [Move("ungate", (sid,))]
        idle = [s for s in sorted(ctx.specs)
                if s not in ctx.busy
                and ctx.idle_streak.get(s, 0) >= self.gate_after]
        # consolidate: merge an idle sibling pair before gating it
        for a, b in ctx.state.mergeable_pairs(ctx.lattice, live=ctx.specs):
            if a in idle and b in idle:
                return [Move("merge", (a, b))]
        if n_live <= self.min_active:
            return []
        if not idle:
            return []

        def saving(sid: str) -> float:
            p = ctx.lattice.profile_for(ctx.specs[sid].n_chips)
            return self._lam(p) * p.idle_watts

        idle.sort(key=lambda s: (-saving(s), s))
        return [Move("gate", (idle[0],))]


# ---------------------------------------------------------------------------
# ψ_energy slice-side model
# ---------------------------------------------------------------------------

@dataclass
class EnergyModel:
    """Per-slice power map feeding ψ_energy in the scoring objective.

    ψ_energy(v) = 1 − watts(slice(v)) / peak — the §3.2 energy feature
    shape (``SystemFeatures.energy`` with E = watts·duration and
    E_max = peak·duration; the duration cancels), so placements on
    low-power profiles score higher.  Attached to the scheduler by the
    coordinator whenever the active policy sets ``energy_score``; the
    scheduler folds the term into settled scores on the host (the clip in
    Eq. 3 is slack there: Σβ ≤ 1 keeps f_sys in range), which keeps the
    batched device dispatch untouched.
    """

    watts: Dict[str, float]
    peak: float

    def psi(self, slice_id: str) -> float:
        w = self.watts.get(slice_id, self.peak)
        if self.peak <= 0.0:
            return 0.0
        return min(1.0, max(0.0, 1.0 - w / self.peak))


# ---------------------------------------------------------------------------
# the graceful revocation ladder: migrate → preempt-with-credit → revoke
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MigrationConfig:
    """Knobs of the :class:`MigrationPlanner` revocation ladder.

    ``migration_budget`` bounds how many commitments one evacuation may
    re-place (migration re-commits timelines and re-scores nothing, but
    each move is still an epoch bump + feedback row — unbounded migration
    of a hot slice could thrash).  ``horizon`` is the placement lookahead
    scanned on each candidate slice, ``duration_margin`` the safety factor
    on the residual's predicted runtime (the original declarations are
    conservative quantiles; the successor keeps that headroom so it does
    not trade revocation loss for overrun loss).
    """

    migration_budget: int = 4
    horizon: float = 200.0
    duration_margin: float = 1.25


class MigrationPlanner:
    """Walks the migrate → preempt-with-credit → revoke-lossy ladder.

    One :meth:`evacuate` call handles everything committed to a dying
    slice, per commitment and in deterministic order:

    1. **migrate** — while the migration budget lasts, try to re-place the
       commitment's residual work on a compatible surviving slice
       (capacity ≥ the job's ``min_capacity``, θ-safety via the agent's
       own memoized check, an idle gap big enough within the horizon, not
       dead-window suppressed, not overlapping the job's own wins) through
       ``scheduler.migrate_commitment``;
    2. **preempt with credit** — a RUNNING commitment whose job declares a
       ``preempt_granularity`` keeps its completed granules through
       ``scheduler.preempt`` (calibration ingests the observed partial
       speed); only the residual re-enters the biddable pool;
    3. **revoke lossy** — whatever remains takes the historical
       slice-failure path (``fail_running`` + ``revoke_slice`` +
       ``drop_pending``), progress torched.

    Rungs 1–2 broadcast ONE out-of-round ``build_migration_feedback`` to
    the affected agents (``MIGRATED`` award/loss pairs + ``preempted``
    losses); like sheds it does NOT replace ``scheduler.last_feedback``.
    With ``migration_budget=0`` and every ``preempt_granularity`` at 0 the
    ladder degenerates to exactly the historical three-call sequence —
    byte-identical, which is what lets the planner ride every entry point
    (fault path, repartition drain, service policing) unconditionally.

    Picklable plain data; checkpointed in the same pickle graph as the
    scheduler whose Variant identities it manipulates.
    """

    def __init__(self, scheduler, config: Optional[MigrationConfig] = None):
        self.scheduler = scheduler
        self.config = config if config is not None else MigrationConfig()
        self.n_migrated = 0
        self.n_preempted = 0
        self.n_lost = 0
        self.work_credited = 0.0

    # -- placement search ----------------------------------------------------
    def _find_placement(self, agent, residual: float, exclude: str,
                        now: float, activation: float):
        """Earliest feasible (t_start, slice_id, duration) for the residual,
        deterministic (slices scanned in sorted order, earliest gap first,
        ties by slice id) — or None when nothing fits in the horizon."""
        sched = self.scheduler
        cfg = self.config
        best = None
        for sid in sorted(sched.slices):
            if sid == exclude:
                continue
            tl = sched.slices[sid]
            spec = tl.spec
            if spec.capacity_bytes < agent.spec.min_capacity:
                continue
            if not agent.is_safe_on(spec.capacity_bytes):
                continue
            thr = agent.throughput_on(spec.capacity_bytes, spec.n_chips) * spec.speed
            if thr <= 0.0:
                continue
            need = (activation + residual / thr) * cfg.duration_margin
            for s, e in tl.gaps(now, cfg.horizon):
                start = max(s, now)
                if e - start < need - 1e-12:
                    continue
                if sched._dead_windows.suppressed(sid, s):
                    continue
                if agent._overlaps_own(start, need):
                    continue
                if best is None or (start, sid) < (best[0], best[1]):
                    best = (start, sid, need)
                break  # earliest feasible gap per slice is enough
        return best

    # -- the ladder ----------------------------------------------------------
    def evacuate(self, slice_id: str, now: float, ex=None) -> Dict[str, int]:
        """Walk the ladder over everything committed to ``slice_id``, then
        revoke the slice.  Returns per-rung counts for the caller's
        metrics (``migrated`` / ``preempted`` / ``lost``)."""
        import numpy as np

        from .negotiation.messages import build_migration_feedback
        from .types import Window

        sched = self.scheduler
        budget = self.config.migration_budget
        run = ex.running.get(slice_id) if ex is not None else None
        doomed = sorted(
            (c for c in sched.commitments if c.variant.slice_id == slice_id),
            key=lambda c: (c.variant.t_start, c.variant.variant_id))
        old_tl = sched.slices.get(slice_id)
        old_cap = old_tl.spec.capacity_bytes if old_tl is not None else 0.0
        migrations: List[tuple] = []
        preemptions: List[tuple] = []
        n_migrated = n_preempted = 0
        for c in doomed:
            v = c.variant
            agent = sched.agents.get(v.job_id)
            payload = v.payload if isinstance(v.payload, dict) else {}
            work = float(payload.get("work", 0.0))
            activation = float(payload.get("activation", 0.0))
            is_running = run is not None and run[0] is v
            credited = 0.0
            observed = None
            if is_running and agent is not None:
                g = float(agent.spec.preempt_granularity)
                actual_end = run[1]
                if g > 0.0 and now > v.t_start:
                    frac = float(np.clip(
                        (now - v.t_start) / max(actual_end - v.t_start, 1e-9),
                        0.0, 1.0))
                    credited = min(work, float(int((work * frac) / g)) * g)
                if credited > 0.0:
                    # the observed PARTIAL speed (the same truth-scaling
                    # complete() uses): speed from the full actual runtime,
                    # progress from the credited fraction
                    truth = dict(payload.get("true_features",
                                             v.declared_features))
                    observed = dict(truth)
                    ratio = float(np.clip(
                        v.duration / max(actual_end - v.t_start, 1e-9),
                        0.0, 1.0))
                    if "jct" in observed:
                        observed["jct"] = float(np.clip(
                            observed["jct"] * ratio, 0.0, 1.0))
                    if "progress" in observed:
                        observed["progress"] = float(np.clip(
                            observed["progress"] * (credited / max(work, 1e-9)),
                            0.0, 1.0))
            residual = work - credited
            old_w = Window(slice_id, old_cap, v.t_start, v.duration)
            # rung 1: migrate the residual to a surviving slice
            if budget > 0 and agent is not None and residual > 1e-9:
                placed = self._find_placement(
                    agent, residual, slice_id, now, activation)
                if placed is not None:
                    t0, sid2, need = placed
                    new_v = sched.migrate_commitment(
                        v, now, slice_id=sid2, t_start=t0, duration=need,
                        residual_work=residual, credited_work=credited,
                        observed_features=observed)
                    if new_v is not None:
                        budget -= 1
                        n_migrated += 1
                        self.work_credited += credited
                        if ex is not None:
                            if is_running:
                                ex.running.pop(slice_id, None)
                                run = None
                            ex.pending = [p for p in ex.pending if p is not v]
                            ex.pending.append(new_v)
                        cap2 = sched.slices[sid2].spec.capacity_bytes
                        migrations.append((
                            v.job_id, v.variant_id, new_v.variant_id,
                            old_w, Window(sid2, cap2, t0, need), c.score))
                        continue
            # rung 2: preempt with granule credit (running chunks only)
            if is_running and credited > 0.0:
                sched.preempt(v, now, work_done=credited,
                              observed_features=observed)
                n_preempted += 1
                self.work_credited += credited
                if ex is not None:
                    ex.running.pop(slice_id, None)
                run = None
                preemptions.append((v.job_id, v.variant_id, old_w))
                continue
            # rung 3: left for the lossy revocation below
        if migrations or preemptions:
            fb = build_migration_feedback(
                now, migrations, preemptions, sched.calibrator)
            for job_id in sorted(set(fb.losses) | set(fb.awards)):
                agent = sched.agents.get(job_id)
                if agent is not None:
                    agent.observe_feedback(fb)
        # the historical slice-failure path mops up whatever is left
        if ex is not None:
            ex.fail_running(slice_id, now)
        lost = sched.revoke_slice(slice_id, now)
        if ex is not None:
            ex.drop_pending(slice_id)
        self.n_migrated += n_migrated
        self.n_preempted += n_preempted
        self.n_lost += len(lost)
        return {"migrated": n_migrated, "preempted": n_preempted,
                "lost": len(lost)}


# ---------------------------------------------------------------------------
# coordinator: safe execution between rounds
# ---------------------------------------------------------------------------

class RepartitionCoordinator:
    """Owns the layout state and executes policy moves between rounds.

    Drain-first protocol: a move whose target slices still have
    outstanding commitments (or a variant running/queued in the
    execution plumbing) waits, re-checked every tick, up to
    ``drain_grace`` ticks; past that the targets are revoked —
    ``fail_running`` + ``revoke_slice`` + ``drop_pending``, the exact
    slice-failure path, with commit-log ``lost`` rows and
    ``LOSS_SLICE_FAILED`` feedback.  Merged-away and gated ids retire
    their dead-window entries so canonical-id rebirth starts clean.

    Everything here is picklable plain data; the coordinator is included
    in simulator/service crash checkpoints next to the scheduler it
    references (one combined pickle graph, preserving identity).
    """

    MAX_TRACE = 4096
    # class-level fallback so coordinators restored from pre-migration
    # checkpoints (plain __dict__ pickling) still resolve the attribute
    migration = None

    def __init__(self, scheduler, policy: RepartitionPolicy, *,
                 lattice: Optional[ProfileLattice] = None,
                 drain_grace: int = 2,
                 migration: Optional[MigrationPlanner] = None):
        self.scheduler = scheduler
        self.policy = policy
        # revocation ladder for forced drains (None = the historical
        # fail_running + revoke_slice + drop_pending lossy path)
        self.migration = migration
        specs = [tl.spec for tl in scheduler.slices.values()]
        self.lattice = lattice if lattice is not None else ProfileLattice.infer(specs)
        self.state = RepartitionState.adopt(specs, self.lattice)
        self.drain_grace = int(drain_grace)
        # moves waiting for their targets to drain: [(move, ticks_waited)]
        self.draining: List[Tuple[Move, int]] = []
        self.n_splits = 0
        self.n_merges = 0
        self.n_gates = 0
        self.n_ungates = 0
        self.n_forced = 0  # drains that ended in revocation
        self.energy_joules = 0.0
        self.frag_trace: List[Tuple[float, float]] = []
        self._last_tick: Optional[float] = None
        if self.policy.energy_score:
            self._attach_energy_model()

    # -- energy -------------------------------------------------------------
    def _attach_energy_model(self) -> None:
        watts = {}
        for sid in self.state.intervals:
            if sid in self.state.gated:
                continue
            _, n = self.state.intervals[sid]
            watts[sid] = self.lattice.profile_for(n).power_watts
        self.scheduler.energy_model = EnergyModel(
            watts=watts, peak=self.lattice.max_power)

    def _account_energy(self, now: float, busy: frozenset) -> None:
        """Tick-sampled energy proxy: busy slices draw profile power, idle
        live slices draw idle power, gated slices draw nothing."""
        if self._last_tick is not None:
            dt = now - self._last_tick
            if dt > 0:
                for sid, (_, n) in self.state.intervals.items():
                    if sid in self.state.gated:
                        continue
                    p = self.lattice.profile_for(n)
                    self.energy_joules += dt * (
                        p.power_watts if sid in busy else p.idle_watts)
        self._last_tick = now

    # -- context ------------------------------------------------------------
    def _busy_set(self, ex=None) -> frozenset:
        sched = self.scheduler
        busy = {c.variant.slice_id for c in sched.commitments}
        if ex is not None:
            busy.update(ex.running.keys())
            busy.update(v.slice_id for v in ex.pending)
        return frozenset(busy)

    def _context(self, now: float, busy: frozenset) -> RepartitionContext:
        sched = self.scheduler
        specs = {sid: tl.spec for sid, tl in sched.slices.items()}
        demand = tuple(
            (a.biddable_work, a.spec.min_capacity)
            for _, a in sorted(sched.agents.items())
            if a.biddable_work > 0.0)
        frag = fragmentation_index(
            [s.capacity_bytes for s in specs.values()], demand)
        for sid in specs:
            if sid in busy:
                self.state.idle_streak[sid] = 0
            else:
                self.state.idle_streak[sid] = self.state.idle_streak.get(sid, 0) + 1
        return RepartitionContext(
            now=now, specs=specs, busy=busy, gated=dict(self.state.gated),
            demand=demand, fragmentation=frag,
            backlog_work=sum(w for w, _ in demand),
            idle_streak=dict(self.state.idle_streak),
            lattice=self.lattice, state=self.state)

    # -- the tick -----------------------------------------------------------
    def tick(self, now: float, ex=None) -> List[Move]:
        """One repartition opportunity between rounds; returns executed moves."""
        busy = self._busy_set(ex)
        self._account_energy(now, busy)
        ctx = self._context(now, busy)
        if len(self.frag_trace) < self.MAX_TRACE:
            self.frag_trace.append((now, ctx.fragmentation))
        demand = self.policy.window_demand(ctx)
        if demand is not None and self.scheduler.policy.window.kind == "frag_aware":
            self.scheduler.set_window_demand(demand)
        queued, self.draining = self.draining, []
        in_flight = {t for m, _ in queued for t in m.targets}
        proposed = [m for m in self.policy.propose(ctx)
                    if not (set(m.targets) & in_flight)]
        executed: List[Move] = []
        for move, waited in queued + [(m, 0) for m in proposed]:
            if self._execute(move, now, ex, busy, waited):
                executed.append(move)
        if executed and self.policy.energy_score:
            self._attach_energy_model()
        return executed

    def _execute(self, move: Move, now: float, ex, busy: frozenset,
                 waited: int) -> bool:
        self._validate(move)
        # capture specs up front: a forced revoke below removes the slice
        specs = {t: self.scheduler.slices[t].spec for t in move.targets
                 if t in self.scheduler.slices}
        stuck = [t for t in move.targets
                 if move.kind != "ungate" and t in busy]
        if stuck:
            if waited < self.drain_grace:
                self.draining.append((move, waited + 1))
                return False
            for sid in stuck:  # drain grace exhausted: revocation ladder
                if self.migration is not None:
                    self.migration.evacuate(sid, now, ex)
                else:  # historical lossy slice-failure path
                    if ex is not None:
                        ex.fail_running(sid, now)
                    self.scheduler.revoke_slice(sid, now)
                    if ex is not None:
                        ex.drop_pending(sid)
                self.n_forced += 1
        if move.kind == "split":
            self._do_split(move.targets[0], now, specs[move.targets[0]])
        elif move.kind == "merge":
            self._do_merge(move.targets[0], move.targets[1], now,
                           specs[move.targets[0]])
        elif move.kind == "gate":
            self._do_gate(move.targets[0], now, specs[move.targets[0]])
        elif move.kind == "ungate":
            self._do_ungate(move.targets[0])
        return True

    def _validate(self, move: Move) -> None:
        if move.kind not in ("split", "merge", "gate", "ungate"):
            raise ValueError(f"unknown repartition move kind {move.kind!r}")
        pool = self.state.gated if move.kind == "ungate" else self.scheduler.slices
        for t in move.targets:
            if t not in pool:
                raise ValueError(f"{move.kind} target {t!r} is not available")
            if t not in self.state.intervals:
                raise ValueError(f"{move.kind} target {t!r} has no buddy interval")
        if move.kind == "split":
            _, n = self.state.intervals[move.targets[0]]
            if not self.lattice.can_split(n):
                raise ValueError(
                    f"split of {move.targets[0]} ({n} chips) leaves the lattice")
        elif move.kind == "merge":
            a, b = move.targets
            _, n = self.state.intervals[a]
            if not self.lattice.can_merge(n):
                raise ValueError(f"merge of {a}+{b} leaves the lattice")
            if self.state.buddy_of(a) != b:
                raise ValueError(f"{a} and {b} are not buddy siblings")

    # -- move bodies (every scheduler call below bumps the state epoch, so
    # pipelined speculation against the old inventory is discarded) ---------
    def _retire(self, slice_id: str, now: float) -> None:
        """Remove a slice that is permanently leaving (merge/split/gate):
        drop + dead-window retirement; drained slices have no commitments
        left so nothing is lost, and force-revoked ones already broadcast
        their losses above."""
        self.scheduler.retire_slice(slice_id, now)

    def _do_split(self, slice_id: str, now: float, spec: SliceSpec) -> None:
        tmpl = replace(spec, speed=1.0)
        self._retire(slice_id, now)
        for cid, n in self.state.apply_split(slice_id):
            self.scheduler.add_slice(
                self.lattice.spec_for(cid, n, template=tmpl))
        self.n_splits += 1

    def _do_merge(self, a: str, b: str, now: float, spec: SliceSpec) -> None:
        tmpl = replace(spec, speed=1.0)
        self._retire(a, now)
        self._retire(b, now)
        pid, n = self.state.apply_merge(a, b)
        self.scheduler.add_slice(self.lattice.spec_for(pid, n, template=tmpl))
        self.n_merges += 1

    def _do_gate(self, slice_id: str, now: float, spec: SliceSpec) -> None:
        self._retire(slice_id, now)
        self.state.gated[slice_id] = spec
        self.state.idle_streak.pop(slice_id, None)
        self.n_gates += 1

    def _do_ungate(self, slice_id: str) -> None:
        spec = self.state.gated.pop(slice_id)
        self.scheduler.add_slice(spec)
        self.n_ungates += 1

    # -- reporting ----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        out = {
            "n_splits": self.n_splits,
            "n_merges": self.n_merges,
            "n_gates": self.n_gates,
            "n_ungates": self.n_ungates,
            "n_forced": self.n_forced,
            "energy_joules": self.energy_joules,
            "n_live": len(self.scheduler.slices),
            "n_gated": len(self.state.gated),
        }
        if self.migration is not None:
            out["n_migrated"] = self.migration.n_migrated
            out["n_preempted"] = self.migration.n_preempted
        return out
