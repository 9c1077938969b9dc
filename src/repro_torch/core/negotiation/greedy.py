"""``GreedyChunking``: the historical bid generator as a strategy backend.

Byte-identical to the pre-negotiation ``JobAgent.generate_variants_round``
/ ``generate_variants_by_window`` path: for every announced window, build
the greedy chunk chain (largest-fit chunk per position plus the geometric
ladder of smaller alternatives) with the agent's own θ and honest-times-
misreport declarations.  The identity is pinned by a property test against
a frozen reference copy in tests/test_negotiation.py — do not "improve"
this backend; new behavior belongs in a new strategy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..types import Variant
from .base import BiddingStrategy, chunk_chain_bids
from .messages import WindowAnnouncement

__all__ = ["GreedyChunking"]


@dataclass(frozen=True)
class GreedyChunking(BiddingStrategy):
    """Stateless largest-fit chunk chains on every announced window."""

    name = "greedy_chunking"

    def bid(self, agent, state, announcement: WindowAnnouncement) -> List[List[Variant]]:
        return [
            chunk_chain_bids(
                agent, w, announcement.now, announcement.chips_for(w.slice_id)
            )
            for w in announcement.windows
        ]
