"""Job agents (paper §3.2–§3.3): the stateful half of the bid side.

Each JobAgent owns a JobSpec + mutable progress state (work done,
outstanding commitments, safety cache, bid/win statistics) and implements
the job side of the interaction cycle by DELEGATING every decision —
variant generation, chunk sizing, window targeting, self-scoring, feedback
consumption — to a pluggable :class:`~repro.core.negotiation.base.
BiddingStrategy` selected via ``AgentConfig.strategy`` (default:
:class:`~repro.core.negotiation.greedy.GreedyChunking`, byte-identical to
the historical hardcoded generation).

The typed round protocol (``repro.core.negotiation.messages``):

* :meth:`JobAgent.respond` consumes a ``WindowAnnouncement`` and returns a
  ``BidBundle`` (bids grouped per announced window);
* :meth:`JobAgent.observe_feedback` ingests the scheduler's
  ``RoundFeedback`` after every clear and reports whether the strategy
  adapted (the scheduler bumps its state epoch when it did, so the round
  pipeline's speculative preparations stay provably serial-equivalent).

``generate_variants_round`` / ``generate_variants_by_window`` /
``generate_variants`` survive as thin delegates over the same single code
path (the strategy), so every pre-negotiation caller keeps working.

Eligibility (paper §4.1):
  (a) probabilistic safety  Pr(max RAM > c_k | FMP) ≤ θ   (safe-by-construction)
  (b) slice-specific constraints (affinity / min-capacity / compatibility)

Local utility h̃(v) = Σ α φ(v) uses the job's OWN weighting of the paper's
features (φ_JCT, φ_QoS, φ_progress).  A ``misreport`` factor lets experiments
model strategic jobs (declaring inflated φs) — the §4.2.1 calibration layer
is what keeps them in check, and tests verify exactly that.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .atomizer import AtomizerConfig
from .negotiation import (BiddingStrategy, BidBundle, GreedyChunking,
                          RoundFeedback, WindowAnnouncement)
from .scoring import JobFeatures
from .trp import is_safe
from .types import OVERLAP_EPS, TIME_EPS, JobSpec, JobState, Variant, Window

__all__ = ["JobAgent", "AgentConfig"]


@dataclass(frozen=True)
class AgentConfig:
    theta: float = 0.05  # θ: capacity-violation risk bound
    safety_method: str = "grid"  # grid | union (trp.py evaluators)
    # how the job weights its own features inside h̃ (Σ ≤ 1)
    alphas: Mapping[str, float] = field(
        default_factory=lambda: {"jct": 0.5, "qos": 0.3, "progress": 0.2}
    )
    # strategic misreporting factor: declared φ = clip(truth * misreport)
    misreport: float = 1.0
    # start-time alternatives within the window (beyond t_min itself)
    n_start_offsets: int = 1
    # the bid-side decision backend (repro.core.negotiation.BiddingStrategy);
    # None = GreedyChunking (the historical generation, byte-identical)
    strategy: Optional[BiddingStrategy] = None


class JobAgent:
    """The decision-capable agent wrapping one job (state-holder half)."""

    def __init__(
        self,
        spec: JobSpec,
        cfg: AgentConfig = AgentConfig(),
        atomizer: AtomizerConfig = AtomizerConfig(),
    ):
        self.spec = spec
        self.cfg = cfg
        self.atomizer = atomizer
        self.strategy: BiddingStrategy = (
            cfg.strategy if cfg.strategy is not None else GreedyChunking()
        )
        self.strategy_state = self.strategy.init_state(self)
        self.state = JobState.WAITING
        self.work_done: float = 0.0
        self.n_bids = 0
        self.n_wins = 0
        self.score_won: float = 0.0  # total cleared (committed) score
        # outstanding commitments: work already won but not yet executed, and
        # the time intervals it occupies (a job is a sequential subjob stream
        # — it must never hold two overlapping intervals, even across slices)
        self.outstanding_work: float = 0.0
        self.committed_intervals: list = []
        # safety verdicts are a function of (capacity, θ) only for a fixed
        # FMP — memoized so a round over many same-capacity windows checks
        # once (θ in the key: strategies may tighten the agent's own bound)
        self._safety_cache: Dict[Tuple[float, float], bool] = {}

    # -- progress ------------------------------------------------------------
    @property
    def work_remaining(self) -> float:
        return max(0.0, self.spec.total_work - self.work_done)

    @property
    def biddable_work(self) -> float:
        """Remaining work not yet covered by an outstanding commitment."""
        return max(0.0, self.work_remaining - self.outstanding_work)

    def mark_committed(self, variant: Variant) -> None:
        self.outstanding_work += variant.payload["work"]
        self.committed_intervals.append(variant.interval)

    def mark_settled(self, variant: Variant) -> None:
        """Commitment resolved (executed or failed): free the reservation."""
        self.outstanding_work = max(0.0, self.outstanding_work - variant.payload["work"])
        if variant.interval in self.committed_intervals:
            self.committed_intervals.remove(variant.interval)

    def _overlaps_own(self, t_start: float, duration: float) -> bool:
        t_end = t_start + duration
        for s, e in self.committed_intervals:
            if t_start < e - OVERLAP_EPS and s < t_end - OVERLAP_EPS:
                return True
        return False

    @property
    def finished(self) -> bool:
        return self.work_remaining <= 1e-9

    def record_progress(self, work: float) -> None:
        self.work_done += work
        if self.finished:
            self.state = JobState.FINISHED

    # -- throughput model ----------------------------------------------------
    def throughput_on(self, capacity: float, n_chips: int = 1) -> float:
        """Work units per second the job expects on a slice of this size.

        Simple linear-scaling model with a memory floor: a slice below
        ``min_capacity`` yields zero (condition (b): job stays silent).
        """
        if capacity < self.spec.min_capacity:
            return 0.0
        return float(n_chips)

    #: safety-verdict memo bound: strategies with a drifting θ (e.g.
    #: ConservativeSafety, whose ρ changes with every verification) insert
    #: one entry per distinct bound — evict oldest-first past this size so
    #: a long-lived agent's cache cannot grow without limit
    _SAFETY_CACHE_MAX = 256

    def is_safe_on(self, capacity: float, theta: Optional[float] = None) -> bool:
        """Condition (a) memoized by (capacity, θ) — the FMP is fixed.

        ``theta=None`` checks the agent's own ``cfg.theta``; strategies
        (e.g. ConservativeSafety) may pass a tightened bound.  Within one
        round θ is fixed per strategy, so the memo still collapses a
        many-window announcement to one FMP evaluation per capacity.
        """
        if theta is None:
            theta = self.cfg.theta
        key = (capacity, theta)
        hit = self._safety_cache.get(key)
        if hit is None:
            hit = is_safe(
                self.spec.fmp, capacity, theta, method=self.cfg.safety_method
            )
            while len(self._safety_cache) >= self._SAFETY_CACHE_MAX:
                self._safety_cache.pop(next(iter(self._safety_cache)))
            self._safety_cache[key] = hit
        return hit

    # -- speculative-bid support (core/pipeline.py) ----------------------------
    def stats_snapshot(self) -> int:
        """The one counter speculative bid generation mutates: ``n_bids``.

        Variant ids are deterministic per (window, chain position) — see
        :meth:`make_variant` — so generation itself is replayable (the
        strategy ``bid`` contract forbids mutating strategy state).
        Nothing else may be snapshotted here: the snapshot is taken BEFORE
        the in-flight round settles, and settle legitimately bumps
        ``n_wins`` / the strategy state — a wider rollback would erase it.
        """
        return self.n_bids

    def stats_restore(self, snap: int) -> None:
        self.n_bids = snap

    # -- the job side of one auction round (typed protocol) --------------------
    def respond(self, announcement: WindowAnnouncement) -> BidBundle:
        """Steps 2–3: answer one announcement through the strategy.

        Returns the agent's :class:`BidBundle` (bids grouped per announced
        window, aligned with ``announcement.windows``).  A finished or
        fully-committed job answers with an empty bundle without invoking
        the strategy.
        """
        if self.finished or self.biddable_work <= TIME_EPS:
            groups: Sequence[Sequence[Variant]] = [
                () for _ in announcement.windows
            ]
        else:
            groups = self.strategy.bid(self, self.strategy_state, announcement)
        return BidBundle(
            job_id=self.spec.job_id,
            by_window=tuple(tuple(g) for g in groups),
        )

    def observe_feedback(self, feedback: RoundFeedback) -> bool:
        """Step 5 closing leg: ingest the clearing's feedback broadcast.

        Returns True when the strategy adapted in a way that could change
        future bids (the scheduler invalidates speculative rounds then).
        """
        return bool(
            self.strategy.observe(self, self.strategy_state, feedback)
        )

    # -- legacy generation API: thin delegates over respond() ------------------
    def generate_variants_round(
        self,
        windows: Sequence[Window],
        now: float,
        n_chips: Optional[Mapping[str, int]] = None,
    ) -> List[Variant]:
        """Bid against the FULL window set of a round in one call.

        Variants for different windows may claim the same remaining work (and
        overlapping time spans on different slices); the round clearing keeps
        at most one win per conflict.  ``n_chips`` maps slice_id → chip count.
        """
        out: List[Variant] = []
        for per_window in self.generate_variants_by_window(windows, now, n_chips):
            out.extend(per_window)
        return out

    def generate_variants_by_window(
        self,
        windows: Sequence[Window],
        now: float,
        n_chips: Optional[Mapping[str, int]] = None,
    ) -> List[List[Variant]]:
        """Round bidding with per-window grouping (aligned with ``windows``).

        The grouped form is what the round pipeline needs: when a
        speculatively-announced window is invalidated (it died in the round
        being settled), its bids are dropped wholesale without touching the
        other windows' bids.  Generation per window is independent — a bid
        built for window w fits only w (windows on one slice are disjoint
        gaps), so dropping a group reproduces exactly the pool a fresh
        announcement over the surviving windows would have produced.
        """
        bundle = self.respond(
            WindowAnnouncement(
                now=now, windows=tuple(windows), chips=dict(n_chips or {})
            )
        )
        return [list(g) for g in bundle.by_window]

    def generate_variants(self, window: Window, now: float, n_chips: int = 1) -> List[Variant]:
        """Single-window bidding (the legacy A3 API): a one-window round."""
        return self.generate_variants_by_window(
            [window], now, {window.slice_id: n_chips}
        )[0]

    # -- variant assembly (strategies drive this; truth stays here) ------------
    def make_variant(
        self,
        window: Window,
        t_start: float,
        plan,
        now: float,
        seq: int,
        *,
        shade: float = 1.0,
        theta: Optional[float] = None,
    ) -> Variant:
        """Build one bid: truthful φs, then the declaration the strategy asks
        for (misreport × shade, clipped) and the θ it bids under."""
        feats = self._features(plan.work, plan.duration, t_start, now)
        declared = {
            k: float(np.clip(v * self.cfg.misreport * shade, 0.0, 1.0))
            for k, v in feats.items()
        }
        h = sum(self.cfg.alphas.get(k, 0.0) * v for k, v in declared.items())
        # Deterministic id: (window, chain position) — NOT a global counter.
        # Regenerating the same bid set (e.g. after a discarded speculative
        # round in the pipeline) must yield identical ids; uniqueness holds
        # within a round because a job bids each window at most once.
        vid = (f"{self.spec.job_id}/{window.slice_id}"
               f"@{window.t_min:.9g}#{seq}")
        return Variant(
            job_id=self.spec.job_id,
            slice_id=window.slice_id,
            t_start=t_start,
            duration=plan.duration,
            fmp=self.spec.fmp,
            local_utility=float(np.clip(h, 0.0, 1.0)),
            declared_features=declared,
            payload={
                "work": plan.work,
                "activation": self.atomizer.activation_cost,
                "true_features": feats,  # ground truth (≠ declared if misreporting)
            },
            variant_id=vid,
            # the risk bound this bid was generated under rides along so the
            # in-dispatch safety recheck can verify per-agent θ
            # (PackedRound.thetas); strategies may tighten the agent's own θ
            theta=self.cfg.theta if theta is None else theta,
        )

    # kept as an alias: pre-negotiation code and the frozen reference tests
    # call the historical underscore name
    _make_variant = make_variant

    # -- truthful feature values (what an honest job declares) ----------------
    def _features(self, work: float, duration: float, t_start: float, now: float) -> Dict[str, float]:
        """Honest φ values, spread over [0,1] so they discriminate.

        φ_JCT uses the chunk's *efficiency*: ideal compute time over committed
        span including queueing delay (chunks starting soon and running dense
        score high).  φ_QoS is the deadline-feasibility indicator.  φ_progress
        is the fraction of remaining work the chunk covers.
        """
        finish = t_start + duration
        wait = max(0.0, t_start - now)
        phi_jct = float(np.clip(duration / max(duration + wait, 1e-9), 0.0, 1.0))
        if self.spec.qos_deadline is None:
            phi_qos = 1.0
        else:
            rem_after = self.work_remaining - work
            est_completion = finish + rem_after  # thr≈1 chip ⇒ seconds ≈ work
            phi_qos = JobFeatures.qos(est_completion <= self.spec.qos_deadline)
        phi_prog = JobFeatures.progress(work, self.work_remaining)
        return {"jct": phi_jct, "qos": phi_qos, "progress": phi_prog}
