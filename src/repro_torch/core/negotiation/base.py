"""The ``BiddingStrategy`` protocol: the bid side of a round as an API.

The paper's jobs "actively generate and score feasible subjobs in response
to scheduler-announced execution windows" — variant generation, chunk
sizing, window targeting and self-scoring are *decisions*, and before this
module they were hardcoded inside ``JobAgent``.  ``BiddingStrategy`` is
the bid-side mirror of :class:`~repro.core.policy.base.ClearingPolicy`: a
frozen, swappable backend that owns those decisions, while ``JobAgent``
slims to a state-holder (progress, commitments, safety cache, truthful
feature computation) that delegates through ``AgentConfig.strategy``.

Shipped backends (one module each):

* :class:`~repro.core.negotiation.greedy.GreedyChunking` — the default;
  byte-identical to the historical ``generate_variants_round`` chunk
  chain (pinned against a frozen reference in tests/test_negotiation.py).
* :class:`~repro.core.negotiation.adaptive.AdaptiveBidder` — consumes
  :class:`~repro.core.negotiation.messages.RoundFeedback` (per-window
  winning-score cutoffs, loss reasons, realized calibration bias) to
  adapt chunk size, window targeting and declaration shading online.
* :class:`~repro.core.negotiation.conservative.ConservativeSafety` —
  widens the θ safety margin as a function of calibration reliability ρ,
  making probabilistic safety an agent-side policy.

Replayability contract (the round pipeline relies on it): ``bid`` must be
a pure function of ``(agent state, strategy state, announcement)`` except
for the ``agent.n_bids`` counter, which the pipeline snapshots and rolls
back.  ALL adaptation happens in ``observe``, which runs at settle time —
strictly after any speculative ``bid`` for the next round was taken — and
returns True when the mutation could change future bids, so the scheduler
bumps its state epoch and provably invalidates stale speculation.
"""
from __future__ import annotations

import abc
from typing import Any, List, Optional, Sequence

from ..atomizer import chunk_candidates
from ..types import TIME_EPS, Variant, Window
from .messages import RoundFeedback, WindowAnnouncement

__all__ = ["BiddingStrategy", "chunk_chain_bids"]


class BiddingStrategy(abc.ABC):
    """Owns one agent's bid-side decisions (see module docstring).

    Implementations must be frozen dataclasses (hashable, comparable) so
    an ``AgentConfig`` embedding one stays a value object; per-agent
    mutable adaptation state lives in the object returned by
    :meth:`init_state` (held by the agent), never on the strategy itself —
    one strategy instance may serve a whole population.
    """

    #: short stable identifier used in logs / benchmark rows
    name: str = "abstract"

    def init_state(self, agent) -> Any:
        """Fresh per-agent adaptation state (None for stateless backends)."""
        return None

    @abc.abstractmethod
    def bid(
        self, agent, state, announcement: WindowAnnouncement
    ) -> List[List[Variant]]:
        """Answer one announcement: bids grouped per announced window.

        Must align with ``announcement.windows`` (empty group = silent on
        that window) and must not mutate ``state`` (see the replayability
        contract in the module docstring).
        """

    def observe(self, agent, state, feedback: RoundFeedback) -> bool:
        """Ingest one round's feedback; return True if ``state`` changed
        in a way that could alter future bids.  Default: stateless no-op."""
        return False


def chunk_chain_bids(
    agent,
    window: Window,
    now: float,
    n_chips: int = 1,
    *,
    theta: Optional[float] = None,
    shade: float = 1.0,
    chunk_scale: float = 1.0,
    alternatives: bool = True,
    n_start_offsets: Optional[int] = None,
) -> List[Variant]:
    """The shared chunk-chain generator every shipped strategy builds on.

    Builds a CHAIN of sequential chunks through the window (the paper's
    worked example: J_A fills w* with two tiling variants) plus smaller
    overlapping alternatives at each chain position.  Alternatives at one
    position mutually overlap, so the WIS clearing picks at most one per
    position; chain positions carve work from disjoint portions, so any
    selected combination commits ≤ biddable work.

    With the default knobs this is the historical ``JobAgent.
    generate_variants`` body verbatim (byte-identical, pinned by the
    frozen-reference property test).  The knobs are the strategy surface:

    * ``theta`` — safety bound for condition (a) and the per-variant
      ``Variant.theta`` stamp (None = the agent's own ``cfg.theta``);
      :class:`ConservativeSafety` passes its ρ-widened bound here.
    * ``shade`` — multiplicative declaration shading on the declared φs
      (:class:`AdaptiveBidder`'s calibration-bias steering).
    * ``chunk_scale`` ∈ (0, 1] — cap each chain chunk at this fraction of
      the remaining work, trading per-chunk progress for chain depth
      (more, smaller chunks packed through the window).
    * ``alternatives`` — offer the geometric ladder of smaller chunks at
      each chain position (True = historical behavior); adaptive bidders
      turn it off so the per-window variant budget buys chain depth
      instead of head alternatives.
    * ``n_start_offsets`` — start-time alternatives per chain position
      (None = the agent's own ``AgentConfig.n_start_offsets``; default 1 =
      historical behavior, byte-identical).  With n > 1, the position's
      carrier chunk is re-offered at n−1 later starts, evenly spaced
      within the SHORTEST alternative offered at the position — every
      offset copy therefore overlaps every sibling (WIS keeps at most one
      per position, preserving the chain's ≤-biddable-work invariant)
      while giving the packing freedom to dodge a rival's interval edge.
    """
    if agent.finished or agent.biddable_work <= TIME_EPS:
        return []
    thr = agent.throughput_on(window.capacity, n_chips)
    if thr <= 0:
        return []  # condition (b) fails → silent
    # condition (a): probabilistic safety against this slice's capacity
    if not agent.is_safe_on(window.capacity, theta):
        return []
    if n_start_offsets is None:
        n_start_offsets = getattr(agent.cfg, "n_start_offsets", 1)
    n_start_offsets = max(1, int(n_start_offsets))

    variants: List[Variant] = []
    remaining = agent.biddable_work
    t_cursor = window.t_min
    max_v = agent.atomizer.max_variants_per_window
    # smallest chunk worth asking for: τ_min of work at this throughput
    min_ask = agent.atomizer.tau_min * thr
    while remaining > TIME_EPS and t_cursor < window.t_end - TIME_EPS and len(variants) < max_v:
        span = window.t_end - t_cursor
        ask = remaining
        if chunk_scale < 1.0:
            ask = min(remaining, max(remaining * chunk_scale, min_ask))
        plans = chunk_candidates(ask, thr, span, agent.atomizer)
        if not plans:
            break
        offered = plans if alternatives else plans[:1]
        # emission order per position: carrier chunk, then its start-time
        # alternatives (the knob the agent explicitly asked for — they get
        # budget priority), then the smaller-chunk ladder.  With the
        # default n_start_offsets=1 this is exactly the historical
        # sequence, byte-identical.
        position = [(t_cursor, plans[0])]
        if n_start_offsets > 1:
            # the carrier shifted by o·(d_min/n) for o = 1..n−1.  Offsets
            # stay strictly inside the SHORTEST sibling's duration, so
            # every copy overlaps every alternative at this position
            # (mutual exclusivity under WIS: at most one committed per
            # position); the chain cursor still advances from the
            # unshifted carrier, so positions keep carving disjoint work.
            delta = min(p.duration for p in offered) / n_start_offsets
            position += [(t_cursor + o * delta, plans[0])
                         for o in range(1, n_start_offsets)]
        position += [(t_cursor, p) for p in offered[1:]]
        for t0, plan in position:
            if len(variants) >= max_v:
                break
            if t0 + plan.duration > window.t_end + TIME_EPS:
                continue
            if agent._overlaps_own(t0, plan.duration):
                continue  # job already committed elsewhere in this span
            variants.append(
                agent.make_variant(
                    window, t0, plan, now, len(variants),
                    shade=shade, theta=theta,
                )
            )
        largest = plans[0]
        remaining -= largest.work
        t_cursor += largest.duration
    if variants:
        agent.n_bids += 1
    return variants
