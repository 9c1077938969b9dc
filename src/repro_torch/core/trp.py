"""Temporal Resource Profiles (TRP) and Functional Memory Profiles (FMP).

Paper §3.2: a TRP is "a probabilistic model of time-varying resource demand
over execution ... warm-up phases, steady-state intervals, and transient
bursts"; an FMP is a TRP specialized to device memory.  The paper (and SJA)
leave the concrete family open; we use piecewise-phase Gaussian profiles:

    RAM(t) ~ N(mu(t), sigma(t)^2)   per grid point,

with phases (warmup ramp, steady, burst) and two safety evaluators:

* ``prob_exceed_grid``  — exact under per-grid-point independence:
  ``Pr(max_t RAM > c) = 1 - prod_t Phi((c - mu_t)/sigma_t)`` (log-space).
* ``prob_exceed_union`` — distribution-free union (Bonferroni) upper bound:
  ``sum_t (1 - Phi(z_t))``; conservative, monotone, cheap.

Both are validated against Monte-Carlo ground truth in tests.  The TRP also
drives duration prediction (``predict_duration``): subjob wall time is
modelled log-normally around work/throughput.

The vectorized safety math is mirrored by ``kernels/jasda_score`` (Pallas) and
its ``ref.py`` oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Sequence, Tuple

import numpy as np
from scipy.special import log_ndtr, ndtr  # Phi and log Phi, vectorized

__all__ = [
    "Phase",
    "PhaseFMP",
    "prob_exceed_grid",
    "prob_exceed_union",
    "predict_duration",
    "fmp_static",
    "fmp_from_model",
    "DEFAULT_GRID",
]

DEFAULT_GRID = 64  # time-grid resolution for safety evaluation


@dataclass(frozen=True)
class Phase:
    """One phase of a piecewise profile.

    ``frac`` is the fraction of total subjob duration this phase occupies.
    ``mu0 -> mu1`` ramps linearly across the phase (bytes). ``sigma`` is the
    per-point std (bytes).
    """

    frac: float
    mu0: float
    mu1: float
    sigma: float


@dataclass(frozen=True)
class PhaseFMP:
    """Piecewise-phase Gaussian memory profile (compact FMP descriptor)."""

    phases: Tuple[Phase, ...]

    def __post_init__(self):
        total = sum(p.frac for p in self.phases)
        if not math.isclose(total, 1.0, rel_tol=1e-6):
            raise ValueError(f"phase fractions must sum to 1, got {total}")

    # -- profile evaluation -------------------------------------------------
    def mean_std(self, t_rel: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma) at relative times ``t_rel`` in [0, 1]."""
        t = np.clip(np.asarray(t_rel, dtype=np.float64), 0.0, 1.0)
        mu = np.zeros_like(t)
        sigma = np.zeros_like(t)
        lo = 0.0
        for p in self.phases:
            hi = lo + p.frac
            # include right edge for the final phase
            in_phase = (t >= lo) & (t < hi) if hi < 1.0 - 1e-12 else (t >= lo)
            if p.frac > 0:
                alpha = (t - lo) / p.frac
            else:  # zero-length phase: degenerate
                alpha = np.zeros_like(t)
            mu = np.where(in_phase, p.mu0 + alpha * (p.mu1 - p.mu0), mu)
            sigma = np.where(in_phase, p.sigma, sigma)
            lo = hi
        return mu, sigma

    def grid(self, n: int = DEFAULT_GRID) -> Tuple[np.ndarray, np.ndarray]:
        """Discretize the profile onto an ``n``-point grid (cell midpoints)."""
        t = (np.arange(n) + 0.5) / n
        return self.mean_std(t)

    def peak_mean(self) -> float:
        return max(max(p.mu0, p.mu1) for p in self.phases)

    def scale(self, factor: float) -> "PhaseFMP":
        """Scale memory (e.g. for a different microbatch size)."""
        return PhaseFMP(
            tuple(
                Phase(p.frac, p.mu0 * factor, p.mu1 * factor, p.sigma * factor)
                for p in self.phases
            )
        )

    # -- sampling (simulator ground truth & MC validation) ------------------
    def sample_trajectory(
        self, rng: np.random.Generator, n: int = DEFAULT_GRID
    ) -> np.ndarray:
        mu, sigma = self.grid(n)
        return rng.normal(mu, sigma)


# ---------------------------------------------------------------------------
# Safety evaluators (paper §4.1(a): safe-by-construction)
# ---------------------------------------------------------------------------


def prob_exceed_grid(
    mu: np.ndarray, sigma: np.ndarray, capacity: float
) -> float:
    """``Pr(max_t RAM(t) > c)`` under per-grid-point independence.

    Computed in log space: ``1 - exp(sum_t log Phi((c - mu_t)/sigma_t))``.
    Deterministic points (sigma == 0) contribute 0/-inf exactly.
    """
    mu = np.asarray(mu, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    z = np.where(sigma > 0, (capacity - mu) / np.maximum(sigma, 1e-300), np.inf)
    # deterministic overflow: any mu > c with sigma == 0 -> certain violation
    det_violation = np.any((sigma == 0) & (mu > capacity))
    if det_violation:
        return 1.0
    log_survive = np.sum(log_ndtr(z[np.isfinite(z)]))
    return float(-np.expm1(log_survive))


def prob_exceed_union(
    mu: np.ndarray, sigma: np.ndarray, capacity: float
) -> float:
    """Union (Bonferroni) upper bound ``sum_t Pr(RAM_t > c)``, clipped to 1."""
    mu = np.asarray(mu, dtype=np.float64)
    sigma = np.asarray(sigma, dtype=np.float64)
    z = np.where(sigma > 0, (capacity - mu) / np.maximum(sigma, 1e-300), np.inf)
    tail = np.where(
        sigma > 0, 1.0 - ndtr(z), (mu > capacity).astype(np.float64)
    )
    return float(min(1.0, np.sum(tail)))


def is_safe(fmp: PhaseFMP, capacity: float, theta: float, *, n: int = DEFAULT_GRID,
            method: str = "grid") -> bool:
    """Eligibility condition (a): ``Pr(max RAM > c_k | FMP) <= theta``."""
    mu, sigma = fmp.grid(n)
    p = prob_exceed_grid(mu, sigma, capacity) if method == "grid" else \
        prob_exceed_union(mu, sigma, capacity)
    return p <= theta


# ---------------------------------------------------------------------------
# Duration prediction
# ---------------------------------------------------------------------------


def predict_duration(
    work: float,
    throughput: float,
    *,
    cv: float = 0.1,
    quantile: float = 0.9,
) -> float:
    """Predicted subjob duration Δt̃ from a log-normal runtime model.

    ``work / throughput`` is the median; the declared duration is the
    ``quantile`` of LogNormal(log median, sigma) with coefficient of
    variation ``cv`` — jobs declare a high quantile so the subjob completes
    within its committed interval w.h.p. (the temporal analogue of
    safe-by-construction).
    """
    if throughput <= 0:
        raise ValueError("throughput must be positive")
    median = work / throughput
    sigma = math.sqrt(math.log1p(cv * cv))
    # LogNormal quantile: median * exp(sigma * Phi^{-1}(q))
    from scipy.special import ndtri

    return float(median * math.exp(sigma * ndtri(quantile)))


# ---------------------------------------------------------------------------
# FMP constructors
# ---------------------------------------------------------------------------


def fmp_static(mean_bytes: float, sigma_bytes: float = 0.0) -> PhaseFMP:
    """Flat profile (constant residency), e.g. pure parameter residency."""
    return PhaseFMP((Phase(1.0, mean_bytes, mean_bytes, sigma_bytes),))


def fmp_standard(
    base: float,
    steady: float,
    burst: float = 0.0,
    *,
    warmup_frac: float = 0.1,
    burst_frac: float = 0.05,
    rel_sigma: float = 0.02,
) -> PhaseFMP:
    """Warmup-ramp / steady / burst profile (the paper's three regimes)."""
    steady_frac = 1.0 - warmup_frac - burst_frac
    if steady_frac < 0:
        raise ValueError("warmup_frac + burst_frac must be <= 1")
    phases = [
        Phase(warmup_frac, base, steady, rel_sigma * steady),
        Phase(steady_frac, steady, steady, rel_sigma * steady),
    ]
    if burst_frac > 0:
        peak = steady + burst
        phases.append(Phase(burst_frac, peak, peak, rel_sigma * peak))
    else:
        phases[-1] = Phase(
            phases[-1].frac + burst_frac, steady, steady, rel_sigma * steady
        )
    return PhaseFMP(tuple(phases))


def fmp_from_model(
    *,
    param_bytes: float,
    optimizer_bytes: float,
    activation_bytes: float,
    kv_cache_bytes: float = 0.0,
    transient_frac: float = 0.05,
    rel_sigma: float = 0.02,
) -> PhaseFMP:
    """Derive a training/serving FMP from model memory accounting.

    This is where architecture specifics (MoE optimizer state, SSM state
    caches, VLM cross-KV) enter the paper's technique: configs/ computes the
    four components per (arch, shape) and this builds the compact descriptor.
    """
    base = param_bytes + optimizer_bytes + kv_cache_bytes
    steady = base + activation_bytes
    burst = transient_frac * steady  # allocator/transient headroom spikes
    return fmp_standard(base, steady, burst, rel_sigma=rel_sigma)
