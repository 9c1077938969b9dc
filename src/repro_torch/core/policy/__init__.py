"""Policy-driven clearing: pluggable backends + the unified ``Policy`` API.

Public surface:

* :class:`ClearingPolicy` — the backend protocol (owns per-window selection,
  cross-window conflict resolution, tie-breaking).
* :class:`GreedyWIS` / :class:`GlobalAssignment` / :class:`FairShare` — the
  three shipped backends (see their module docstrings).
* :class:`Policy` — one frozen, validated configuration composing scoring /
  window / age / calibration knobs, the clearing backend and the θ-recheck
  mode, with :meth:`Policy.utilization` / :meth:`Policy.fairness` /
  :meth:`Policy.responsive` presets.
* :func:`fixed_point_settle` — the shared WIS + conflict-resolution core
  custom backends can build on.

Quickstart::

    from repro_torch.core import JasdaScheduler, SliceSpec
    from repro_torch.core.policy import Policy

    sched = JasdaScheduler(slices, Policy.utilization())
    sched.run_round(now)
"""
from .base import ClearingPolicy, fixed_point_settle  # noqa: F401
from .greedy import GreedyWIS  # noqa: F401
from .assignment import GlobalAssignment  # noqa: F401
from .fairshare import FairShare  # noqa: F401
from .presets import Policy  # noqa: F401

__all__ = [
    "ClearingPolicy",
    "fixed_point_settle",
    "GreedyWIS",
    "GlobalAssignment",
    "FairShare",
    "Policy",
]
