"""Bid-side negotiation: typed round protocol + pluggable bidding backends.

The mirror image of ``repro.core.policy`` (which made the *clearing*
objective a first-class backend): this package makes the *bid* side of the
scheduler↔agent interaction a first-class, swappable API and closes the
feedback loop the paper's "embedded directly into the scheduling loop"
claim requires.

Public surface:

* :class:`WindowAnnouncement` / :class:`BidBundle` / :class:`Award` /
  :class:`LossReport` / :class:`RoundFeedback` — the typed messages of one
  negotiation round (announce → bid → clear → feedback).
* :class:`BiddingStrategy` — the backend protocol (owns variant
  generation, chunk sizing, window targeting, self-scoring and feedback
  consumption); :func:`chunk_chain_bids` is the shared generation core.
* :class:`GreedyChunking` — the default; byte-identical to the historical
  ``JobAgent`` generation (pinned by a frozen-reference property test).
* :class:`AdaptiveBidder` — online chunk-scale / window-targeting /
  bid-shading adaptation from :class:`RoundFeedback`.
* :class:`ConservativeSafety` — reliability-scaled θ safety margin.
* :func:`build_feedback` — the scheduler-side feedback constructor.

Quickstart::

    from repro_torch.core import AgentConfig, JobAgent
    from repro_torch.core.negotiation import AdaptiveBidder

    agent = JobAgent(spec, AgentConfig(strategy=AdaptiveBidder()))
    # the scheduler announces, collects BidBundles, clears, and publishes
    # RoundFeedback back to every agent after each round automatically
"""
from .messages import (  # noqa: F401
    Award,
    BidBundle,
    LossReport,
    RoundFeedback,
    WindowAnnouncement,
    build_feedback,
)
from .base import BiddingStrategy, chunk_chain_bids  # noqa: F401
from .greedy import GreedyChunking  # noqa: F401
from .adaptive import AdaptiveBidder  # noqa: F401
from .conservative import ConservativeSafety  # noqa: F401

__all__ = [
    "WindowAnnouncement",
    "BidBundle",
    "Award",
    "LossReport",
    "RoundFeedback",
    "build_feedback",
    "BiddingStrategy",
    "chunk_chain_bids",
    "GreedyChunking",
    "AdaptiveBidder",
    "ConservativeSafety",
]
