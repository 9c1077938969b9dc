"""``GreedyWIS``: the default clearing backend (the historical greedy semantics).

Per-window optimal WIS, then greedy cross-window conflict resolution: a job
that wins overlapping intervals on two slices (or more total work than it
has) keeps only its best-scored wins; windows that lose a winner are
re-cleared within the round to a fixed point.  This is exactly the
pre-policy-API behavior — selections are byte-identical (pinned by a
property test against a frozen reference implementation), so the default
:class:`~repro.core.policy.presets.Policy` changes nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..types import PoolView, RoundResult, Variant, Window
from ..wis import wis_select
from .base import ClearingPolicy, fixed_point_settle

__all__ = ["GreedyWIS"]


@dataclass(frozen=True)
class GreedyWIS(ClearingPolicy):
    """Greedy keep-best-win clearing (the default backend, zero knobs)."""

    name = "greedy_wis"
    # selection runs on the raw auction scores, so a fused first-pass WIS
    # dispatched against the in-flight device scores is directly usable
    supports_prefetch = True

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
        return fixed_point_settle(
            windows, fit, win_idx, scores,
            selector=selector, work_budget=work_budget, view=view,
            prefetch=prefetch,
        )
