"""Round pipelining: overlap host bid preparation with device scoring.

CUDA launches are asynchronous: a batched scoring call returns immediately
with an in-flight tensor on the current stream, and the host only blocks
when it copies the values back.
Serial ``run_round`` wastes that window — it dispatches, then immediately
blocks to clear.  The :class:`RoundPipeline` double-buffers consecutive
rounds instead:

    dispatch k ─▶ [device: score round k      ]─▶ settle k ─▶ dispatch k+1 …
                  [host:   prepare round k+1  ]

While round k's scores are in flight, the host **speculatively** announces
windows and collects/packs bids for round k+1 (and even dispatches them).
Speculation is validated — never trusted — before use:

* every scheduler state mutation (commit, complete, fail, job/slice
  membership) bumps ``JasdaScheduler._epoch``; a speculative preparation
  whose epoch no longer matches is discarded (per-agent bid statistics are
  rolled back; variant ids are deterministic, so a fresh serial
  preparation is byte-identical to a never-speculated one);
* windows the settling round killed (cleared empty → dead-window
  suppression) do not bump the epoch — they only *remove* announcements —
  so the surviving preparation is FILTERED: the dead windows' bid groups
  are dropped and the pool re-packed/re-dispatched.  Bid generation is
  per-window independent (jobs.generate_variants_by_window), so the
  filtered pool equals what a fresh announcement would produce;
* the settle's RoundFeedback broadcast (the clearing→agent negotiation
  channel) is published AFTER speculation was taken, so a bidding
  strategy that adapts from it (observe_feedback → True) bumps the epoch
  exactly like a commitment: the pre-feedback speculative bids are
  discarded and regenerated serially against the adapted state.
  Stateless strategies (GreedyChunking) report no adaptation and keep
  speculation hitting — feedback consistency costs nothing unless a
  strategy actually uses the channel.

The result is provably identical to serial rounds (equivalence-tested
byte-for-byte), with the host work of round k+1 hidden behind round k's
device time whenever the state allows it — and a wasted-but-harmless
speculation (it overlapped a device wait) when it does not.

:func:`pipelined_clear_rounds` applies the same structure to a stateless
stream of (windows, pool) rounds — the form benchmarks and external
batch-auction drivers use — where every round is independent and the
overlap needs no speculation at all.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .clearing import assign_bids, settle_round
from .scoring import ScoringPolicy, score_round_async
from .types import RoundResult, Variant, Window
from .wis import make_round_selector, predispatch_settle

# NOTE: scheduler-level pipelining (RoundPipeline) needs no policy plumbing
# of its own — JasdaScheduler._settle_round dispatches through the
# scheduler's Policy.clearing backend, so speculation replays identically
# under ANY backend (settle is pure given its inputs).

__all__ = ["RoundPipeline", "pipelined_clear_rounds"]


class RoundPipeline:
    """Double-buffers a JasdaScheduler's auction rounds (see module doc).

    Drive it with :meth:`tick` once per round, passing the next round's
    time so the speculative preparation can start; call :meth:`flush` when
    done to roll back any outstanding speculation.  State lives on the
    scheduler — the pipeline only sequences prepare/settle halves.
    """

    # after this many consecutive discards, stop speculating until a round
    # settles without commitments (the state-stable regime where speculation
    # provably validates) — keeps the busy-auction overhead bounded
    MAX_CONSEC_DISCARDS = 3

    def __init__(self, scheduler):
        self.sched = scheduler
        self._spec = None  # speculative RoundPrep for the next tick
        self._consec_discards = 0
        # observability: how often speculation paid off / was filtered / lost
        self.stats = {"spec_hit": 0, "spec_filtered": 0, "spec_discarded": 0,
                      "serial_prep": 0}

    # -- public ----------------------------------------------------------------
    def tick(self, now: float, next_time: Optional[float] = None) -> Optional[RoundResult]:
        """Run the round at ``now``; speculatively prepare ``next_time``."""
        prep = self._take_validated(now)
        if prep is None:
            self.stats["serial_prep"] += 1
            prep = self.sched._prepare_round(now)
        # Overlap window: the current round's scores are (possibly) in
        # flight; prepare the next round's host half now.  Only worthwhile
        # when something is actually in flight — eager paths (empty round,
        # small-pool numpy) would pay the speculation cost with nothing to
        # hide it behind — and only while speculation has been validating
        # (adaptive back-off keeps busy-auction overhead bounded).
        self._spec = None
        speculate = (
            next_time is not None
            and self._in_flight(prep)
            and self._consec_discards < self.MAX_CONSEC_DISCARDS
        )
        if speculate:
            self._spec = self.sched._prepare_round(next_time, speculative=True)
        rr = self.sched._settle_round(prep)
        if rr is None or not rr.selected:
            # nothing committed: the state held still — re-arm speculation
            self._consec_discards = 0
        return rr

    def flush(self) -> None:
        """Discard outstanding speculation (restores agent bid statistics)."""
        if self._spec is not None:
            self._discard(self._spec)
            self._spec = None

    # -- speculation validation -------------------------------------------------
    @staticmethod
    def _in_flight(prep) -> bool:
        handle = getattr(prep, "handle", None)
        return handle is not None and handle.in_flight

    def _take_validated(self, now: float):
        """Return a usable preparation for ``now`` from speculation, or None.

        Valid   = epoch unchanged and no speculated window suppressed since.
        Filter  = epoch unchanged, some windows died: drop their bid groups,
                  re-pack and re-dispatch (bid stats re-derived).
        Discard = epoch changed (or wrong tick time): roll back stats.
        """
        spec, self._spec = self._spec, None
        if spec is None:
            return None
        if spec.now != now or spec.epoch != self.sched._epoch:
            self.stats["spec_discarded"] += 1
            self._consec_discards += 1
            self._discard(spec)
            return None
        reg = self.sched._dead_windows
        reg.prune(now)  # idempotent: speculation already pruned at `now`
        kept = [k for k, w in enumerate(spec.windows)
                if not reg.suppressed(w.slice_id, w.t_min)]
        if len(kept) == len(spec.windows):
            self.stats["spec_hit"] += 1
            self._consec_discards = 0
            return spec  # bit-identical to a serial preparation
        self.stats["spec_filtered"] += 1
        self._consec_discards = 0
        # Some speculated windows were killed by the round that settled in
        # between.  Timeline/agents/ages are untouched (epoch matched), so
        # the surviving windows' bids are exactly what a fresh announcement
        # would generate — drop the dead groups and redo pool/pack/dispatch.
        if spec.stats_snap is not None:
            for agent in spec.agents:
                agent.stats_restore(spec.stats_snap[agent.spec.job_id])
        spec.windows = [spec.windows[k] for k in kept]
        spec.bids = [[per_window[k] for k in kept] for per_window in spec.bids]
        for agent, per_window in zip(spec.agents, spec.bids):
            # re-apply the n_bids a serial generation over the surviving
            # windows would have counted (one per window with bids)
            agent.n_bids += sum(1 for vs in per_window if vs)
        if not spec.windows:
            return spec  # settles as an idle round (log row, None result)
        self.sched._finalize_prep(spec)
        return spec

    def _discard(self, spec) -> None:
        if spec.stats_snap is not None:
            for agent in spec.agents:
                agent.stats_restore(spec.stats_snap[agent.spec.job_id])


# ---------------------------------------------------------------------------
# Stateless round streams (benchmarks / batch-auction drivers)
# ---------------------------------------------------------------------------


def pipelined_clear_rounds(
    rounds: Sequence[Tuple[Sequence[Window], Sequence[Variant]]],
    policy: ScoringPolicy,
    *,
    ages=None,
    calibrate=None,
    score_impl: Optional[str] = None,
    recheck_theta: Optional[float] = None,
    per_agent_theta: bool = False,
    grid: int = 32,
    grid_cache=None,
    work_budget=None,
    clearing=None,
    wis_impl: Optional[str] = None,
    mesh=None,
    device=None,
) -> List[RoundResult]:
    """Clear a stream of independent rounds with dispatch/settle overlap.

    Equivalent to ``[clear_round(w, pool, policy, ...) for w, pool in
    rounds]`` (identical selections — asserted by the pipeline_overlap
    benchmark), but round k+1's host packing and round k's WIS clearing
    both run while round k(/k+1)'s device scoring is in flight.  Up to two
    rounds are queued on device at any time (double buffering).
    ``clearing`` selects the settle backend (``repro.core.policy.
    ClearingPolicy``; None = GreedyWIS) — the overlap structure is
    backend-agnostic because settle is pure given its inputs.

    ``wis_impl`` selects the settle-side WIS backend (see ``core.wis.
    make_round_selector``); with a device backend ("torch"/"cuda") each
    round's ban-free first WIS pass is launched right behind its scoring
    call — score→clear chain on the CUDA stream — so the settle half
    overlaps the next round's host packing too.  ``device`` is where the
    device backends run (the CUDA card unless the caller asks for the
    CPU); ``mesh`` sharding is not ported yet and must be None.
    """
    results: List[RoundResult] = []
    pending = None  # (windows, fit, win_idx, view, handle, prefetch)
    selector = make_round_selector(wis_impl, mesh=mesh, device=device)
    from .clearing import _default_clearing

    backend = clearing if clearing is not None else _default_clearing()

    def dispatch(windows, pool):
        windows = list(windows)
        fit, win_idx, fit_view = assign_bids(windows, pool)
        handle = None
        prefetch = None
        if fit:
            handle = score_round_async(
                fit, windows, win_idx, policy,
                ages=ages, calibrate=calibrate, impl=score_impl,
                recheck_theta=recheck_theta, per_agent_theta=per_agent_theta,
                grid=grid, grid_cache=grid_cache,
                view=fit_view, mesh=mesh, device=device,
            )
            prefetch = predispatch_settle(
                selector, backend, len(windows), win_idx, fit_view, handle,
                ages=ages)
        return windows, fit, win_idx, fit_view, handle, prefetch

    def settle(entry):
        windows, fit, win_idx, fit_view, handle, prefetch = entry
        scores = handle.result() if handle is not None else np.zeros(0)
        return settle_round(windows, fit, win_idx, scores,
                            work_budget=work_budget, view=fit_view,
                            clearing=backend, ages=ages,
                            selector=selector, prefetch=prefetch)

    for windows, pool in rounds:
        entry = dispatch(windows, pool)  # host pack + async device dispatch
        if pending is not None:
            # settles round k-1 while round k computes on device
            results.append(settle(pending))
        pending = entry
    if pending is not None:
        results.append(settle(pending))
    return results
