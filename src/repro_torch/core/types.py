"""Core JASDA datatypes (paper §3.1–§3.3).

These are plain frozen dataclasses: the scheduler control plane is host-side
Python (as in the paper), while the numeric hot paths (scoring, safety, WIS)
have vectorized JAX / Pallas implementations operating on struct-of-array
views produced by :func:`variants_to_arrays`.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Shared float tolerances
# ---------------------------------------------------------------------------

# ONE base tolerance for time/interval comparisons; the three tolerances the
# clearing layer needs are all derived from it by fixed factors, replacing
# what used to be unrelated hardcoded literals (1e-9 / 1e-12 / 1e-6) spread
# across clearing.py and windows.py.  The derived values deliberately
# preserve the historical semantics at each site (selections are pinned
# byte-identical by tests), while making the relationships explicit:
#
#   OVERLAP_EPS (1e-3x) < TIME_EPS < DEAD_WINDOW_EPS (1e3x)
#
# i.e. the overlap predicate is STRICTER than window containment (a bid may
# sit at a window boundary, but two bids must be cleanly disjoint), and
# dead-window matching is LOOSER than both (it absorbs float drift
# accumulated across whole release/early-finish/merge chains).
TIME_EPS = 1e-9

# Window-containment slack: clearing._fits / assign_bids / Window.contains
# accept a bid protruding past an announced boundary by at most this much.
# (This is the base constant itself; named uses below derive from it.)

# Temporal-overlap strictness: clearing._overlap, types.overlaps, the WIS
# brute-force oracle and the agents' own-interval checks treat two intervals
# overlapping by less than this as disjoint.
OVERLAP_EPS = 1e-3 * TIME_EPS

# Dead-window matching tolerance: windows.DeadWindowRegistry defaults to
# this (and SchedulerConfig.dead_window_eps mirrors it).
DEAD_WINDOW_EPS = 1e3 * TIME_EPS

# ---------------------------------------------------------------------------
# Slices (the MIG analogue: a TPU mesh partition)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SliceSpec:
    """A schedulable resource slice ``s_k`` with fixed capacity ``c_k`` (A1).

    On the paper's hardware this is a MIG slice of one GPU; in our TPU
    adaptation it is a partition of a pod mesh (``n_chips`` chips, aggregate
    HBM ``capacity_bytes``).
    """

    slice_id: str
    capacity_bytes: float  # c_k
    n_chips: int = 1
    flops_per_s: float = 197e12  # bf16 peak per chip (v5e-class)
    hbm_bw: float = 819e9  # bytes/s per chip
    # relative execution speed multiplier (stragglers are < 1.0)
    speed: float = 1.0

    @property
    def total_flops(self) -> float:
        return self.n_chips * self.flops_per_s * self.speed


# ---------------------------------------------------------------------------
# Windows (paper §3.1): w* = (s_k, c_k, t_min, Δt)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Window:
    """An announced time–capacity window on a slice."""

    slice_id: str
    capacity: float  # c_k  (bytes)
    t_min: float  # earliest start
    duration: float  # Δt

    @property
    def t_end(self) -> float:
        return self.t_min + self.duration

    @property
    def key(self) -> Tuple[str, float]:
        """Stable within-round identity: (slice, start).

        Windows announced in one round are disjoint gaps per slice, so the
        pair identifies a window uniquely; round-feedback cutoff maps
        (negotiation.messages.RoundFeedback) key on it.
        """
        return (self.slice_id, self.t_min)

    def contains(self, t_start: float, dur: float, *, eps: float = TIME_EPS) -> bool:
        return (t_start >= self.t_min - eps) and (t_start + dur <= self.t_end + eps)


# ---------------------------------------------------------------------------
# Variants (paper §3.2): v_{i,k,w*} = (s_k, t_start, Δt̃_i, TRP_i)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Variant:
    """A candidate subjob proposed by a job for a specific window.

    ``declared_features`` holds the job's self-declared normalized feature
    values φ_i(v) ∈ [0,1] (paper Eq. 2 / §4.2.1) — these are what ex-post
    verification compares against observations.  ``local_utility`` is the
    aggregate h̃(v) = Σ αᵢ φᵢ(v).
    """

    job_id: str
    slice_id: str
    t_start: float
    duration: float  # Δt̃_i (predicted)
    fmp: "FMPLike"  # compact TRP descriptor (memory profile)
    local_utility: float  # h̃(v) ∈ [0,1], declared by the job
    declared_features: Mapping[str, float] = field(default_factory=dict)
    payload: Any = None  # opaque subjob spec (e.g. a step-range chunk)
    variant_id: str = ""
    # the bidding agent's declared capacity-violation risk bound θ (paper
    # §4.1 condition (a)).  Carried per variant so the in-dispatch safety
    # recheck can verify each bid against ITS OWN agent's θ
    # (PackedRound.thetas); 1.0 = unconstrained (p_exceed ≤ 1 always holds),
    # the right default for variants built outside a JobAgent.
    theta: float = 1.0

    @property
    def t_end(self) -> float:
        return self.t_start + self.duration

    @property
    def interval(self) -> Tuple[float, float]:
        """I(v) = [t_start, t_start + Δt̃]."""
        return (self.t_start, self.t_end)


# Anything exposing the FMP protocol (mean/std over a time grid).
class FMPLike:  # pragma: no cover - typing helper
    def mean_std(self, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]: ...


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------


class JobState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class JobSpec:
    """Static description of a job entering the system."""

    job_id: str
    arrival_time: float
    total_work: float  # abstract work units (e.g. total step·chip-seconds)
    fmp: Any  # the job's (true or declared) memory profile model
    qos_deadline: Optional[float] = None  # QoS target completion time
    min_capacity: float = 0.0  # smallest slice capacity the job can use
    priority: float = 1.0
    # energy model: joules per unit work (used by the ψ_energy feature)
    energy_per_work: float = 1.0
    # preemption checkpoint granularity in work units: an interrupted chunk
    # keeps floor(done / granularity) × granularity of its progress (the
    # revocation ladder's preempt-with-credit rung).  0.0 — the default —
    # keeps the historical all-or-nothing semantics byte-identically: an
    # interruption torches the whole chunk.
    preempt_granularity: float = 0.0
    metadata: Mapping[str, Any] = field(default_factory=dict)


@dataclass
class JobStats:
    """Mutable per-job accounting used by fairness + calibration."""

    work_done: float = 0.0
    last_scheduled_time: Optional[float] = None
    first_scheduled_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_bids: int = 0
    n_wins: int = 0
    # calibration state (paper §4.2.1)
    hist_avg: float = 0.5  # HistAvg(J): EWMA of verified scores
    reliability: float = 1.0  # ρ_J ∈ (0, 1]
    verified_errors: list = field(default_factory=list)  # ε(v) history


# ---------------------------------------------------------------------------
# Commitments / schedule bookkeeping
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Commitment:
    """A variant committed to the schedule (paper step 5)."""

    variant: Variant
    commit_time: float
    score: float


@dataclass
class ClearingResult:
    """Output of one clearing iteration (Algorithm 1)."""

    window: Window
    selected: Sequence[Variant]
    scores: Sequence[float]
    total_score: float
    n_bids: int
    rejected: Sequence[Variant] = ()


@dataclass
class RoundResult:
    """Output of one batched auction ROUND over all announced windows.

    ``results[i]`` is the per-window clearing outcome for ``windows[i]``
    after cross-window conflict resolution; ``selected``/``scores`` are the
    flattened winners across every window (the commit set).  ``n_conflicts``
    counts wins revoked because a job won overlapping intervals on several
    slices (or more work than it had) and kept only its best-scored wins.
    """

    windows: Sequence[Window]
    results: Sequence["ClearingResult"]
    selected: Sequence[Variant]
    scores: Sequence[float]
    total_score: float
    n_bids: int
    n_bidders: int = 0
    n_conflicts: int = 0
    # per-window tuples of SELECTED pool indices (into the round's fitting
    # pool, aligned with ``results``) — lets downstream consumers (the
    # vectorized RoundFeedback assembly) classify winners from PoolView
    # columns without re-identifying variant objects.  Backends that do not
    # track pool indices may leave it empty (callers must fall back).
    selected_idx: Sequence = ()


# ---------------------------------------------------------------------------
# Struct-of-arrays view for vectorized scoring / WIS (JAX + Pallas paths)
# ---------------------------------------------------------------------------


@dataclass
class PoolView:
    """Single-walk struct-of-arrays view of a variant pool.

    The round hot path (window assignment → feature packing → per-window
    WIS) used to re-walk the python variant objects once per stage; a
    PoolView walks the pool ONCE and every stage operates on numpy columns
    (plus parallel python lists for the non-numeric fields).  ``take``
    produces an aligned sub-view without touching the variant objects.
    """

    variants: list
    t_start: np.ndarray  # (M,) float64
    duration: np.ndarray  # (M,) float64
    t_end: np.ndarray  # (M,) float64
    local_utility: np.ndarray  # (M,) float64
    thetas: np.ndarray  # (M,) float64 per-variant safety bound θ
    slice_ids: list  # per-variant slice id strings
    job_ids: list  # per-variant job id strings
    fmps: list  # per-variant FMP references
    variant_ids: list  # per-variant id strings (round-unique)

    @classmethod
    def build(cls, variants: Sequence[Variant]) -> "PoolView":
        if not variants:
            z = np.zeros(0, np.float64)
            return cls([], z, z.copy(), z.copy(), z.copy(), z.copy(),
                       [], [], [], [])
        rows = [
            (v.t_start, v.duration, v.slice_id, v.job_id, v.fmp,
             v.local_utility, v.theta, v.variant_id)
            for v in variants
        ]
        ts, dur, sids, jids, fmps, h, th, vids = zip(*rows)
        t_start = np.asarray(ts, np.float64)
        duration = np.asarray(dur, np.float64)
        return cls(
            list(variants), t_start, duration, t_start + duration,
            np.asarray(h, np.float64), np.asarray(th, np.float64),
            list(sids), list(jids), list(fmps), list(vids),
        )

    def __len__(self) -> int:
        return len(self.variants)

    def take(self, idx) -> "PoolView":
        idx = np.asarray(idx, np.intp)
        return PoolView(
            [self.variants[i] for i in idx],
            self.t_start[idx], self.duration[idx], self.t_end[idx],
            self.local_utility[idx], self.thetas[idx],
            [self.slice_ids[i] for i in idx],
            [self.job_ids[i] for i in idx],
            [self.fmps[i] for i in idx],
            [self.variant_ids[i] for i in idx],
        )


def variants_to_arrays(variants: Sequence[Variant]) -> dict:
    """Convert a variant pool to a struct-of-arrays dict for device kernels."""
    n = len(variants)
    return {
        "t_start": np.asarray([v.t_start for v in variants], dtype=np.float64),
        "t_end": np.asarray([v.t_end for v in variants], dtype=np.float64),
        "duration": np.asarray([v.duration for v in variants], dtype=np.float64),
        "local_utility": np.asarray(
            [v.local_utility for v in variants], dtype=np.float64
        ),
        "index": np.arange(n),
    }


def overlaps(a: Variant, b: Variant, *, eps: float = OVERLAP_EPS) -> bool:
    """Temporal overlap predicate on the same slice (clearing constraint i)."""
    return a.t_start < b.t_end - eps and b.t_start < a.t_end - eps
