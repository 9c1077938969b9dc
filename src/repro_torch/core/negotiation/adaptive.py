"""``AdaptiveBidder``: feedback-driven chunk sizing, targeting and shading.

The strategy closes the negotiation loop on the agent side.  Every settled
round delivers a :class:`~repro.core.negotiation.messages.RoundFeedback`;
from it the bidder runs three independent online adaptations (all state in
the per-agent dict from :meth:`init_state`, never on the frozen strategy):

* **Chunk-scale adaptation.**  Being OUTSCORED in a contended window means
  the agent's large largest-fit chunks are losing whole-interval auctions
  to denser rivals.  The bidder shrinks its chunk scale (``shrink`` per
  losing round, floored at ``min_scale``) and switches its per-window
  variant budget from head *alternatives* to chain *depth* — more,
  smaller chunks tiled through the window, each an independently scored
  WIS candidate.  Rounds where every bid wins grow the scale back toward
  1 (fewer activations per unit work).  At scale 1.0 the bids are exactly
  :class:`~repro.core.negotiation.greedy.GreedyChunking`'s, so an
  uncontended AdaptiveBidder never pays an adaptation tax.
* **Window targeting.**  Per-slice EWMA of the announced cutoffs
  (minimum winning score) vs. an EWMA of the agent's own winning scores:
  a slice whose cutoff has stayed above ``skip_margin ×`` the agent's own
  level for ``skip_after`` consecutive outscored rounds is skipped until
  its cutoff relaxes — bids go where they can clear (win-rate, not
  wasted generation work).
* **Bid shading (§4.2.1).**  The feedback carries the calibrator's signed
  declaration bias (declared − observed EWMA).  A positive bias means the
  agent is over-declaring (e.g. a strategic ``misreport`` factor), ε is
  accumulating and ρ_J is sinking — so the bidder shades its declared φs
  down (``shade ← shade·(1 − η·bias)``), steering the bias to zero,
  keeping ρ_J ≈ 1 and its *calibrated* score ĥ competitive.  Auction-style
  shading: report what the verifier will confirm, not what clips highest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..types import Variant
from .base import BiddingStrategy, chunk_chain_bids
from .messages import LOSS_OUTSCORED, RoundFeedback, WindowAnnouncement

__all__ = ["AdaptiveBidder"]


@dataclass(frozen=True)
class AdaptiveBidder(BiddingStrategy):
    """Online bid optimization from clearing feedback (see module doc)."""

    name = "adaptive"

    #: chunk-scale multiplier applied on a round with outscored losses
    shrink: float = 0.6
    #: chunk-scale recovery multiplier on a fully-winning round
    grow: float = 1.2
    #: floor for the chunk scale (fraction of remaining work per chunk)
    min_scale: float = 0.12
    #: learning rate of the declaration-shading update
    shade_eta: float = 0.8
    #: floor for the shading factor
    min_shade: float = 0.25
    #: |bias| below which shading holds still (honest agents never shade)
    bias_deadband: float = 0.05
    #: EWMA retention for learned cutoffs / own-score levels
    level_decay: float = 0.5
    #: consecutive outscored rounds on a slice before targeting skips it
    skip_after: int = 3
    #: skip a slice while its cutoff EWMA exceeds margin × own level
    skip_margin: float = 1.3

    def init_state(self, agent) -> Dict:
        return {
            "scale": 1.0,
            "shade": 1.0,
            "cutoff": {},  # slice_id -> cutoff EWMA
            "own": 0.0,  # EWMA of own winning scores
            "streak": {},  # slice_id -> consecutive outscored rounds
        }

    # -- bidding ---------------------------------------------------------------
    def bid(self, agent, state, announcement: WindowAnnouncement) -> List[List[Variant]]:
        scale = state["scale"]
        out: List[List[Variant]] = []
        for w in announcement.windows:
            if self._skip(state, w.slice_id):
                out.append([])
                continue
            out.append(
                chunk_chain_bids(
                    agent, w, announcement.now,
                    announcement.chips_for(w.slice_id),
                    shade=state["shade"],
                    chunk_scale=scale,
                    # at scale 1.0 the bids are byte-identical to
                    # GreedyChunking; once shrunk, the variant budget buys
                    # chain depth instead of head alternatives
                    alternatives=scale >= 1.0,
                )
            )
        return out

    def _skip(self, state, slice_id: str) -> bool:
        if state["streak"].get(slice_id, 0) < self.skip_after:
            return False
        cutoff = state["cutoff"].get(slice_id)
        own = state["own"]
        return cutoff is not None and own > 0.0 and cutoff > self.skip_margin * own

    # -- adaptation ------------------------------------------------------------
    def observe(self, agent, state, feedback: RoundFeedback) -> bool:
        jid = agent.spec.job_id
        awards = feedback.awards.get(jid, ())
        losses = feedback.losses.get(jid, ())
        before = (state["scale"], state["shade"], dict(state["cutoff"]),
                  state["own"], dict(state["streak"]))

        d = self.level_decay
        for w in feedback.windows:
            cut = feedback.cutoff_for(w)
            if cut > 0.0:
                prev = state["cutoff"].get(w.slice_id)
                state["cutoff"][w.slice_id] = (
                    cut if prev is None else d * prev + (1 - d) * cut
                )
        for a in awards:
            state["own"] = (
                a.score if state["own"] == 0.0
                else d * state["own"] + (1 - d) * a.score
            )

        # per-slice streaks: a win resets, an outscored loss extends
        won_slices = {a.window.slice_id for a in awards}
        out_slices = {l.window.slice_id for l in losses
                      if l.reason == LOSS_OUTSCORED}
        for sid in won_slices:
            state["streak"][sid] = 0
        for sid in out_slices - won_slices:
            state["streak"][sid] = state["streak"].get(sid, 0) + 1

        # chunk-scale: shrink under contention (genuine market defeats),
        # recover when winning without being outscored anywhere
        if out_slices:
            state["scale"] = max(self.min_scale, state["scale"] * self.shrink)
        elif awards:
            state["scale"] = min(1.0, state["scale"] * self.grow)

        # declaration shading against the signed calibration bias
        bias = feedback.calibration_bias.get(jid, 0.0)
        if abs(bias) > self.bias_deadband:
            state["shade"] = float(
                np.clip(state["shade"] * (1.0 - self.shade_eta * bias),
                        self.min_shade, 1.0)
            )

        after = (state["scale"], state["shade"], state["cutoff"],
                 state["own"], state["streak"])
        return (before[0] != after[0] or before[1] != after[1]
                or before[2] != after[2] or before[3] != after[3]
                or before[4] != after[4])
