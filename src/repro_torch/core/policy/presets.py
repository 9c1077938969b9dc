"""The unified ``Policy`` object: one validated, frozen configuration.

Before this API the policy surface was five loose fragments —
``ScoringPolicy`` (λ/α/β), ``WindowPolicy`` (announcement ordering),
``AgePolicy`` (starvation curve), ``CalibrationConfig`` (§4.2.1 trust) and
``SchedulerConfig.recheck_theta`` — with the clearing objective hardwired.
``Policy`` composes all of them plus the swappable
:class:`~repro.core.policy.base.ClearingPolicy` backend and the per-agent-θ
recheck mode into one coherent value object, with named presets for the
paper's three headline trade-offs:

====================  =====  ============  ==================  ==============
preset                λ      window order  clearing backend    distinguishing
====================  =====  ============  ==================  ==============
``Policy.utilization``  0.3  best_fit      GlobalAssignment    packs tight
                                                               gaps, recovers
                                                               conflict score
``Policy.fairness``     0.5  earliest      FairShare           β_age=0.5,
                                                               fast age curve,
                                                               win spreading
``Policy.responsive``   0.7  earliest      GreedyWIS           job/QoS-first
                                                               scores, lowest
                                                               clearing
                                                               latency
====================  =====  ============  ==================  ==============

``Policy()`` (the "balanced" default) is byte-identical to the pre-API
scheduler: GreedyWIS clearing, Table-2 balanced weights, recheck off.
Construct variations with :meth:`Policy.replace` or preset ``**overrides``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from ..calibration import CalibrationConfig
from ..fairness import AgePolicy
from ..scoring import ScoringPolicy
from ..windows import WindowPolicy
from .assignment import GlobalAssignment
from .base import ClearingPolicy
from .fairshare import FairShare
from .greedy import GreedyWIS

__all__ = ["Policy"]


@dataclass(frozen=True)
class Policy:
    """One coherent, validated scheduler policy (see module docstring).

    ``recheck_theta`` is the scheduler-wide in-dispatch safety-recheck
    override (None = no override); ``per_agent_theta`` re-verifies each bid
    against its OWN agent's declared ``AgentConfig.theta`` instead
    (``Variant.theta`` → ``PackedRound.thetas``).  When both are set the
    scheduler-wide override wins, matching the legacy
    ``SchedulerConfig.recheck_theta`` semantics.
    """

    name: str = "balanced"
    scoring: ScoringPolicy = ScoringPolicy()
    window: WindowPolicy = WindowPolicy()
    age: AgePolicy = AgePolicy()
    calibration: CalibrationConfig = CalibrationConfig()
    clearing: ClearingPolicy = GreedyWIS()
    recheck_theta: Optional[float] = None
    per_agent_theta: bool = False

    def __post_init__(self):
        if not isinstance(self.scoring, ScoringPolicy):
            raise TypeError(f"scoring must be a ScoringPolicy, got {type(self.scoring).__name__}")
        if not isinstance(self.window, WindowPolicy):
            raise TypeError(f"window must be a WindowPolicy, got {type(self.window).__name__}")
        if not isinstance(self.age, AgePolicy):
            raise TypeError(f"age must be an AgePolicy, got {type(self.age).__name__}")
        if not isinstance(self.calibration, CalibrationConfig):
            raise TypeError(
                f"calibration must be a CalibrationConfig, got {type(self.calibration).__name__}")
        if not isinstance(self.clearing, ClearingPolicy):
            raise TypeError(
                f"clearing must be a ClearingPolicy backend, got {type(self.clearing).__name__}")
        if self.recheck_theta is not None and not (0.0 < self.recheck_theta <= 1.0):
            raise ValueError(f"recheck_theta must be in (0, 1], got {self.recheck_theta}")

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        """One-line summary (benchmark rows, simulator reports)."""
        return (f"{self.name}: lam={self.scoring.lam} "
                f"window={self.window.kind} clearing={self.clearing.name} "
                f"beta_age={self.scoring.beta_age} "
                f"recheck={'theta=%g' % self.recheck_theta if self.recheck_theta is not None else ('per-agent' if self.per_agent_theta else 'off')}")

    # -- named presets ---------------------------------------------------------
    @classmethod
    def utilization(cls, **overrides) -> "Policy":
        """Utilization-first: pack tight gaps, recover conflict utility.

        System-side weights dominate (λ=0.3, Table 2 "utilization-first"),
        windows are announced best-fit-first so small gaps fill before they
        expire, and the :class:`GlobalAssignment` backend reassigns
        conflicting cross-window wins instead of greedily revoking them.
        """
        kw = dict(
            name="utilization",
            scoring=ScoringPolicy(
                lam=0.3,
                betas={"utilization": 0.55, "slack": 0.25,
                       "mem_headroom": 0.1, "energy": 0.05, "age": 0.05},
            ),
            window=WindowPolicy(kind="best_fit"),
            clearing=GlobalAssignment(),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def fairness(cls, **overrides) -> "Policy":
        """Fairness-first: heavy age pressure + win-spreading clearing.

        β_age=0.5 with a fast-saturating age curve promotes starved jobs in
        SCORING; the :class:`FairShare` backend additionally boosts them in
        SELECTION and spreads per-round wins across jobs (Jain-friendly).
        """
        kw = dict(
            name="fairness",
            scoring=ScoringPolicy(
                lam=0.5,
                betas={"utilization": 0.25, "slack": 0.1,
                       "mem_headroom": 0.1, "energy": 0.05, "age": 0.5},
            ),
            age=AgePolicy(tau=30.0),
            clearing=FairShare(),
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def responsive(cls, **overrides) -> "Policy":
        """Responsiveness-first: job/QoS-weighted scores, minimal latency.

        λ=0.7 (Table 2 "QoS-first") lets declared job utility dominate,
        windows are announced earliest-first to minimize announcement →
        execution latency, and the zero-knob :class:`GreedyWIS` backend
        keeps per-round clearing cost at its floor.
        """
        kw = dict(
            name="responsive",
            scoring=ScoringPolicy(lam=0.7),
            window=WindowPolicy(kind="earliest"),
            clearing=GreedyWIS(),
        )
        kw.update(overrides)
        return cls(**kw)
