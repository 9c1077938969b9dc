"""``FairShare``: age/Jain-weighted clearing (temporal-fairness backend).

The paper's §4.3 age term already *scores* starved jobs higher; FairShare
additionally makes the CLEARING step fairness-aware, which matters when the
score gap is larger than β_age can close or when one job's bids dominate a
round:

* **age boost** — selection runs on ``s·(1 + age_weight·A_i(t))``: a starved
  job's bids out-rank slightly better-scored bids from recently-served jobs,
  in WIS selection and in conflict keep-priority alike.
* **win spreading** — after a first clearing pass, each job's k-th-best win
  (0-indexed) is discounted by ``1 + spread·k``, and bids beyond a job's
  win set carry the job's full-count discount; the round is then re-cleared
  once.  A job's BEST seat keeps its score, but marginal seats shrink and
  yield to jobs holding none, pushing the per-round win distribution toward
  a higher Jain index (diminishing-returns/proportional-fairness flavour).

Reported scores and totals stay the RAW auction values — the transform only
steers selection — so cleared totals remain comparable across backends.
Deterministic: two passes, no iteration to convergence.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..types import PoolView, RoundResult, Variant, Window
from ..wis import wis_select
from .base import ClearingPolicy, fixed_point_settle

__all__ = ["FairShare"]


@dataclass(frozen=True)
class FairShare(ClearingPolicy):
    """Age-boosted, win-spreading clearing.

    ``age_weight`` ≥ 0 scales the multiplicative age boost (0 disables);
    ``spread`` ≥ 0 scales the second-pass multi-win discount (0 disables,
    making FairShare a single age-weighted pass).
    """

    name = "fair_share"
    age_weight: float = 0.5
    spread: float = 0.25
    # the age-boost pass SELECTS on scores transformed by a host-known
    # per-bid multiplier, which the fused first pass applies in-dispatch
    # (prefetch_transform below) — so FairShare can consume the fused
    # score→clear path like the raw-score backends
    supports_prefetch = True

    def __post_init__(self):
        if self.age_weight < 0 or self.spread < 0:
            raise ValueError("age_weight and spread must be non-negative")

    def prefetch_transform(self, view, ages):
        """The age-boost multiplier ``1 + age_weight·A_i(t)``, float32.

        Quantized to float32 because the fused dispatch multiplies it with
        the float32 device scores; :meth:`settle` builds its selection
        scores from the SAME float32 product so the fused and host first
        passes agree bit-for-bit.
        """
        ages = ages or {}
        age = np.asarray(
            [float(np.clip(ages.get(j, 0.0), 0.0, 1.0)) for j in view.job_ids],
            np.float64,
        )
        return (1.0 + self.age_weight * age).astype(np.float32)

    def settle(
        self,
        windows: Sequence[Window],
        fit: Sequence[Variant],
        win_idx: Sequence[int],
        scores: np.ndarray,
        *,
        selector: Callable = wis_select,
        work_budget: Optional[Mapping[str, float]] = None,
        view: Optional[PoolView] = None,
        ages: Optional[Mapping[str, float]] = None,
        prefetch=None,
    ) -> RoundResult:
        common = dict(selector=selector, work_budget=work_budget, view=view)
        if not fit:
            return fixed_point_settle(windows, fit, win_idx, scores, **common)
        if view is None:
            view = PoolView.build(fit)
            common["view"] = view
        # float32 score×transform product, upcast: exactly the weights the
        # fused device dispatch gathers (see prefetch_transform), so the
        # prefetched first pass and a host sweep select identically
        transform = self.prefetch_transform(view, ages)
        eff = (np.asarray(scores, np.float32) * transform).astype(np.float64)
        first = fixed_point_settle(
            windows, fit, win_idx, scores, select_scores=eff,
            prefetch=prefetch, **common
        )
        if self.spread <= 0 or not first.selected:
            return first
        # positional discounts: the job's best win keeps its score, win k is
        # divided by 1 + spread·k, and its remaining bids (would-be extra
        # wins) carry the full-count discount
        pos = {id(v): i for i, v in enumerate(fit)}
        wins_by_job: dict = {}
        for v in first.selected:
            wins_by_job.setdefault(v.job_id, []).append(pos[id(v)])
        n_wins = Counter(v.job_id for v in first.selected)
        discount = np.asarray(
            [1.0 + self.spread * n_wins.get(j, 0) for j in view.job_ids],
            np.float64,
        )
        for job, win_idxs in wins_by_job.items():
            for k, i in enumerate(sorted(win_idxs, key=lambda i: -eff[i])):
                discount[i] = 1.0 + self.spread * k
        return fixed_point_settle(
            windows, fit, win_idx, scores, select_scores=eff / discount,
            **common,
        )
