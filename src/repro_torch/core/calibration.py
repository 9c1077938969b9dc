"""Incentives, calibration and ex-post verification (paper §4.2.1).

Ex-ante calibration (Eq. 5):      ĥ(v) ← γ h̃(v) + (1−γ) HistAvg(J)
Per-feature error (Eq. 6):        ε_i(v) = |φ_i(v) − φ_i^observed(v)|
Per-variant error:                ε(v) = Σ w_i ε_i(v),  w ≥ 0, Σw = 1
Expected error (Eq. 7):           E_v[ε] = mean over verified variants
Reliability (Eq. 8):              ρ_J = exp(−κ · E_v[ε])  ∈ (0, 1]
Feedback form:                    ĥ(v) ← ρ_J h̃(v) + (1−ρ_J) HistAvg(J)

The paper leaves the HistAvg family open ("simple or weighted"); we use an
EWMA with configurable half-life and ablate the choice in benchmarks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from .types import Variant

__all__ = ["CalibrationConfig", "Calibrator", "per_variant_error", "reliability"]


@dataclass(frozen=True)
class CalibrationConfig:
    gamma: float = 0.7  # γ in Eq. 5 (ignored when mode="reliability")
    kappa: float = 3.0  # κ in Eq. 8
    # EWMA half-life (in number of verified variants) for HistAvg.
    hist_half_life: float = 8.0
    # feature weights w_i for ε(v); uniform over observed features if None.
    error_weights: Optional[Mapping[str, float]] = None
    # "fixed"      : ĥ = γ h̃ + (1−γ) HistAvg          (Eq. 5)
    # "reliability": ĥ = ρ_J h̃ + (1−ρ_J) HistAvg      (feedback form)
    # "multiplicative": ĥ = ρ_J · (γ h̃ + (1−γ) HistAvg)
    mode: str = "reliability"
    # verified-error history window for E_v[ε] (None = full history, Eq. 7)
    error_window: Optional[int] = 64

    def __post_init__(self):
        if not (0.0 <= self.gamma <= 1.0):
            raise ValueError("gamma must be in [0,1]")
        if self.kappa <= 0:
            raise ValueError("kappa must be positive")
        if self.mode not in ("fixed", "reliability", "multiplicative"):
            raise ValueError(f"unknown mode {self.mode}")


def per_variant_error(
    declared: Mapping[str, float],
    observed: Mapping[str, float],
    weights: Optional[Mapping[str, float]] = None,
) -> float:
    """ε(v) = Σ_i w_i |φ_i − φ_i^obs| over features present in both maps.

    Convex by construction (weights normalized to sum 1), hence ε(v) ∈ [0,1]
    when features are in [0,1].
    """
    common = [k for k in declared.keys() if k in observed]
    if not common:
        return 0.0
    if weights is None:
        w = {k: 1.0 / len(common) for k in common}
    else:
        tot = sum(max(0.0, weights.get(k, 0.0)) for k in common)
        if tot <= 0:
            w = {k: 1.0 / len(common) for k in common}
        else:
            w = {k: max(0.0, weights.get(k, 0.0)) / tot for k in common}
    eps = 0.0
    for k in common:
        eps += w[k] * abs(float(declared[k]) - float(observed[k]))
    return float(min(1.0, max(0.0, eps)))


def reliability(expected_error: float, kappa: float) -> float:
    """Eq. 8: ρ_J = exp(−κ E[ε]) ∈ (0, 1]."""
    return float(math.exp(-kappa * max(0.0, expected_error)))


@dataclass
class _JobCal:
    hist_avg: float = 0.5
    n_verified: int = 0
    errors: list = field(default_factory=list)
    rho: float = 1.0
    # signed declaration bias: EWMA of mean(declared − observed) over the
    # common features.  Positive = systematic over-declaration.  This is
    # the gradient signal auction-style bid shading steers to zero
    # (negotiation.AdaptiveBidder); |bias| ≤ ε̄ always (triangle inequality).
    bias: float = 0.0

    def mean_error(self, window: Optional[int] = None) -> float:
        errs = self.errors if window is None else self.errors[-window:]
        return float(np.mean(errs)) if errs else 0.0


class Calibrator:
    """Per-job trust state + the two calibration passes of §4.2.1."""

    def __init__(self, config: CalibrationConfig = CalibrationConfig()):
        self.config = config
        self._jobs: Dict[str, _JobCal] = {}

    # -- access ------------------------------------------------------------
    def state(self, job_id: str) -> _JobCal:
        return self._jobs.setdefault(job_id, _JobCal())

    def rho(self, job_id: str) -> float:
        return self.state(job_id).rho

    def hist_avg(self, job_id: str) -> float:
        return self.state(job_id).hist_avg

    # -- ex-ante calibration (Eq. 5 / feedback form) -------------------------
    def calibrate(self, variant: Variant, h_declared: float) -> float:
        st = self.state(variant.job_id)
        cfg = self.config
        h = float(np.clip(h_declared, 0.0, 1.0))
        if cfg.mode == "fixed":
            return cfg.gamma * h + (1 - cfg.gamma) * st.hist_avg
        if cfg.mode == "reliability":
            return st.rho * h + (1 - st.rho) * st.hist_avg
        # multiplicative
        return st.rho * (cfg.gamma * h + (1 - cfg.gamma) * st.hist_avg)

    # -- ex-post verification (Eqs. 6–8) -------------------------------------
    def verify(
        self,
        variant: Variant,
        observed_features: Mapping[str, float],
        observed_utility: Optional[float] = None,
    ) -> float:
        """Ingest ground-truth measurements for an executed variant.

        Returns the per-variant error ε(v).  Updates HistAvg (EWMA over
        *verified* scores, per the paper: "moving average of previously
        verified scores") and ρ_J.
        """
        st = self.state(variant.job_id)
        cfg = self.config
        eps = per_variant_error(
            variant.declared_features, observed_features, cfg.error_weights
        )
        st.errors.append(eps)
        st.n_verified += 1

        # Signed declaration bias (EWMA, same half-life as HistAvg): the
        # direction of the error, so strategies can shade declarations
        # toward observations instead of merely knowing they are off.
        common = [k for k in variant.declared_features if k in observed_features]
        if common:
            signed = float(
                np.mean([
                    float(variant.declared_features[k]) - float(observed_features[k])
                    for k in common
                ])
            )
            decay_b = 0.5 ** (1.0 / max(cfg.hist_half_life, 1e-9))
            st.bias = decay_b * st.bias + (1 - decay_b) * signed

        # HistAvg update: EWMA of the *verified* (observed) utility.
        if observed_utility is None:
            # reconstruct from observed features with the declared weighting
            observed_utility = float(
                np.clip(np.mean(list(observed_features.values()) or [0.5]), 0, 1)
            )
        decay = 0.5 ** (1.0 / max(cfg.hist_half_life, 1e-9))
        st.hist_avg = decay * st.hist_avg + (1 - decay) * float(
            np.clip(observed_utility, 0.0, 1.0)
        )

        # E_v[ε] over the (windowed) verified history → ρ_J.
        errs = st.errors if cfg.error_window is None else st.errors[-cfg.error_window:]
        expected = float(np.mean(errs)) if errs else 0.0
        st.rho = reliability(expected, cfg.kappa)
        return eps

    # -- reporting / checkpointing -------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Full per-job calibration state, JSON-serializable.

        Round-trippable through :meth:`restore`: the ``errors`` history is
        included verbatim (it feeds the windowed E_v[ε] → ρ update), so a
        restored calibrator continues exactly where the snapshot was taken
        — simulator checkpoints preserve trust state across runs.
        """
        return {
            j: {
                "rho": float(st.rho),
                "hist_avg": float(st.hist_avg),
                "n_verified": int(st.n_verified),
                "mean_error": st.mean_error(),
                "bias": float(st.bias),
                # plain floats, IN VERIFICATION ORDER: the windowed
                # E_v[ε] → ρ update reads the tail, so order is state
                "errors": [float(e) for e in st.errors],
            }
            for j, st in self._jobs.items()
        }

    def restore(self, snapshot: Mapping[str, Mapping[str, float]]) -> "Calibrator":
        """Rebuild per-job state from a :meth:`snapshot` (returns self).

        Tolerates snapshots taken before the ``bias``/``errors`` fields
        existed (missing keys restore to their neutral defaults; ρ then
        evolves from the restored value as new verifications arrive).
        The error history restores in its original verification order even
        for jobs that never re-bid after the restore — a re-snapshot must
        be exactly the snapshot that was restored (pinned by tests).
        """
        self._jobs = {
            j: _JobCal(
                hist_avg=float(row["hist_avg"]),
                n_verified=int(row.get("n_verified", 0)),
                errors=[float(e) for e in row.get("errors", ())],
                rho=float(row["rho"]),
                bias=float(row.get("bias", 0.0)),
            )
            for j, row in snapshot.items()
        }
        return self
