"""Job atomization (SJA substrate): splitting jobs into schedulable subjobs.

A subjob is a non-preemptive chunk of the parent job's remaining work that
fits an announced window.  The atomizer enforces the global minimum duration
τ_min (paper §4.1: anti-thrashing) and accounts for the fixed activation cost
of a chunk — on our TPU adaptation this is checkpoint-restore + compilation
warmup time, the analogue of the paper's "scheduling and activation costs".

Chunk candidates for a window of span T (from the job's perspective):
  * the largest chunk that fits T (greedy fill),
  * the remaining-work chunk if it completes within T (finishing early is
    preferable to holding the slice),
  * geometrically smaller chunks down to τ_min (gives the clearing DP
    packing alternatives — this is precisely the "multiple variants per
    window" freedom the paper adds over SJA).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .trp import predict_duration

__all__ = ["AtomizerConfig", "chunk_candidates", "ChunkPlan"]


@dataclass(frozen=True)
class AtomizerConfig:
    tau_min: float = 2.0  # τ_min: global minimum subjob duration
    activation_cost: float = 0.25  # checkpoint-restore + warmup per chunk
    max_variants_per_window: int = 4  # V_max (paper §4.6)
    geometric_ratio: float = 0.5  # shrink factor between variant sizes
    duration_quantile: float = 0.9  # declared Δt̃ quantile (temporal safety)
    duration_cv: float = 0.1  # runtime coefficient of variation


@dataclass(frozen=True)
class ChunkPlan:
    """One candidate chunk: ``work`` units predicted to take ``duration``."""

    work: float
    duration: float  # Δt̃ including activation cost


def chunk_candidates(
    work_remaining: float,
    throughput: float,
    window_span: float,
    cfg: AtomizerConfig,
) -> List[ChunkPlan]:
    """Enumerate feasible chunk sizes for a window of ``window_span``.

    Durations are declared at the configured quantile of the log-normal
    runtime model (trp.predict_duration) plus the activation cost, so a
    committed chunk overruns its interval only with probability ~(1-q).
    Returns [] if even a τ_min chunk cannot fit (the job stays silent).
    """
    if work_remaining <= 0 or throughput <= 0:
        return []
    span = window_span
    usable = span - cfg.activation_cost
    if usable < cfg.tau_min:
        return []

    def dur_of(work: float) -> float:
        return (
            predict_duration(
                work,
                throughput,
                cv=cfg.duration_cv,
                quantile=cfg.duration_quantile,
            )
            + cfg.activation_cost
        )

    # Invert: the largest work whose declared duration fits the span.
    # predict_duration is linear in work, so invert directly.
    unit = dur_of(1.0) - cfg.activation_cost  # declared seconds per work unit
    max_work_fit = max(0.0, (span - cfg.activation_cost) / unit)
    candidates: List[float] = []

    finish_work = min(work_remaining, max_work_fit)
    if finish_work <= 0:
        return []
    candidates.append(finish_work)

    # Geometric ladder of smaller alternatives (packing freedom for the DP).
    w = finish_work * cfg.geometric_ratio
    while len(candidates) < cfg.max_variants_per_window:
        d = dur_of(w)
        if d - cfg.activation_cost < cfg.tau_min:
            break
        candidates.append(w)
        w *= cfg.geometric_ratio

    plans = []
    for w in candidates:
        d = dur_of(w)
        if d - cfg.activation_cost + 1e-12 < cfg.tau_min:
            if w >= work_remaining - 1e-12:
                # FINISHING chunk: a residual smaller than τ_min must still be
                # schedulable or job tails starve.  Pad the declared duration
                # to τ_min — the slice is held for the minimum span, which
                # preserves the anti-thrashing invariant.
                d = cfg.activation_cost + cfg.tau_min
            else:
                continue
        if d <= span + 1e-9:
            plans.append(ChunkPlan(work=w, duration=d))
    return plans
