"""``ConservativeSafety``: reliability-scaled probabilistic safety.

Paper §4.1 condition (a) bounds the capacity-violation risk of every bid:
Pr(max RAM > c_k | FMP) ≤ θ.  The bound is only as good as the FMP it is
evaluated against — and §4.2.1's verification loop *measures* how good
that is: a job whose declarations keep diverging from observations ends up
with low reliability ρ_J.  This strategy turns that measurement into an
agent-side safety policy: the effective bound tightens with falling
reliability,

    θ_eff = max(theta_floor, θ · ρ_J^power)

so a job whose profile has proven untrustworthy stops bidding marginal
windows (where p_exceed sits between θ_eff and θ) until its reliability
recovers, and every emitted variant carries θ_eff in ``Variant.theta`` —
the in-dispatch per-agent recheck (``Policy.per_agent_theta``) then
enforces the tightened bound end-to-end.  Chunking is the same greedy
chain as :class:`~repro.core.negotiation.greedy.GreedyChunking`; at
ρ = 1 the two are byte-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..types import Variant
from .base import BiddingStrategy, chunk_chain_bids
from .messages import RoundFeedback, WindowAnnouncement

__all__ = ["ConservativeSafety"]


@dataclass(frozen=True)
class ConservativeSafety(BiddingStrategy):
    """Greedy chunking with a reliability-widened safety margin."""

    name = "conservative_safety"

    #: exponent on ρ: >1 tightens faster as reliability falls
    power: float = 1.0
    #: lower bound on the effective θ (never demand impossible certainty)
    theta_floor: float = 1e-5

    def init_state(self, agent) -> Dict:
        return {"rho": 1.0}

    def effective_theta(self, agent, state) -> float:
        rho = float(state.get("rho", 1.0))
        return max(self.theta_floor, agent.cfg.theta * rho ** self.power)

    def bid(self, agent, state, announcement: WindowAnnouncement) -> List[List[Variant]]:
        theta = self.effective_theta(agent, state)
        # an unchanged bound stays literally the agent's own θ so the
        # byte-identity with GreedyChunking holds at ρ = 1
        if theta == agent.cfg.theta:
            theta = None
        return [
            chunk_chain_bids(
                agent, w, announcement.now,
                announcement.chips_for(w.slice_id), theta=theta,
            )
            for w in announcement.windows
        ]

    def observe(self, agent, state, feedback: RoundFeedback) -> bool:
        rho = feedback.reliability.get(agent.spec.job_id)
        if rho is None or rho == state["rho"]:
            return False
        state["rho"] = float(rho)
        return True
