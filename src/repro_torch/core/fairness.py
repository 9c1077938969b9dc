"""Temporal fairness / age-aware prioritization (paper §4.3).

A_i(t) ∈ [0,1] is a normalized, non-decreasing function of the waiting time
since job J_i last had any variant selected.  It enters the system-side score
as β_age · A_i(t) (see scoring.system_utility), gradually promoting deferred
jobs without a hard completion-time bound — exactly the paper's semantics.

We provide the age curve as a saturating exponential (smooth, bounded,
monotone; its time constant controls how fast starvation pressure builds)
plus linear and step alternatives for ablation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = ["AgePolicy", "AgeTracker", "jain_index"]


@dataclass(frozen=True)
class AgePolicy:
    """Age curve A(wait) with saturation scale ``tau`` (time units)."""

    tau: float = 60.0
    kind: str = "exp"  # exp | linear | step

    def age(self, waiting: float) -> float:
        w = max(0.0, waiting)
        if self.kind == "exp":
            return 1.0 - math.exp(-w / max(self.tau, 1e-9))
        if self.kind == "linear":
            return min(1.0, w / max(self.tau, 1e-9))
        if self.kind == "step":
            return 1.0 if w >= self.tau else 0.0
        raise ValueError(f"unknown age kind {self.kind}")


class AgeTracker:
    """Tracks per-job last-selection times and produces A_i(t)."""

    def __init__(self, policy: AgePolicy = AgePolicy()):
        self.policy = policy
        self._last_selected: Dict[str, float] = {}

    def register_arrival(self, job_id: str, t: float) -> None:
        # a job that has never been selected ages from its arrival
        self._last_selected.setdefault(job_id, t)

    def mark_selected(self, job_id: str, t: float) -> None:
        self._last_selected[job_id] = t

    def remove(self, job_id: str) -> None:
        self._last_selected.pop(job_id, None)

    def age(self, job_id: str, t: float) -> float:
        last = self._last_selected.get(job_id)
        if last is None:
            return 0.0
        return self.policy.age(t - last)

    def ages(self, t: float) -> Dict[str, float]:
        return {j: self.policy.age(t - last) for j, last in self._last_selected.items()}


def jain_index(values) -> float:
    """Jain's fairness index over per-job outcomes (1 = perfectly fair)."""
    x = np.asarray(list(values), dtype=np.float64)
    x = x[np.isfinite(x)]
    if x.size == 0:
        return 1.0
    denom = x.size * np.sum(x * x)
    if denom <= 0:
        return 1.0
    return float(np.sum(x) ** 2 / denom)
