"""``GlobalAssignment``: min-cost matching over conflicting cross-window wins.

Greedy conflict resolution (``GreedyWIS``) keeps each conflicting job's
best-scored win and revokes the rest.  That is locally optimal for the job
but can be globally wasteful: if J0's best win sits in a window where a
near-equal substitute bid exists, while its revoked win sat in a window
nobody else can fill, the greedy pass throws away the substitute's score.
ROADMAP open item: "a global assignment (min-cost matching over conflicting
wins) could recover more utility" — this backend is that recovery.

Mechanism: the first per-window WIS pass exposes each job's *conflict
clusters* (connected components of its mutually-overlapping cross-window
wins).  Each cluster is a one-of-N choice: which window does the job keep?
The backend searches assignments of conflicted jobs to windows:

* exhaustively when the joint choice space is small (≤ ``max_configs``);
* otherwise seeded by a Hungarian assignment
  (``scipy.optimize.linear_sum_assignment`` on the job × window win-score
  profit matrix) and refined by bounded coordinate descent.

Every candidate assignment is evaluated by replaying the shared fixed-point
settle with the job's kept win pinned (``prefer``), so displaced windows
re-clear to their best substitutes and work budgets stay enforced.  The
greedy configuration is always evaluated first, therefore the cleared total
is **never lower than greedy's** (asserted by tests and the
``policy_clearing`` benchmark gate).

Replay cost is attacked on three axes (the ``policy_clearing`` benchmark's
``overhead=`` gate tracks the ratio vs. plain greedy):

* the ban-free FIRST pass is prefer-independent, so it is computed once and
  seeded into every replay (``first_pass``) instead of re-running the full
  per-window WIS sweep per candidate configuration;
* with a batched :class:`~repro.core.wis.RoundSelector` the replays share
  one set of retained packed buffers (``packed``) — no per-config re-pack;
* the independent replays of the exhaustive search run in LOCKSTEP: each
  generation gathers every live configuration's dirty windows into ONE
  batched dispatch (one dispatch per config batch, not per window per
  config).  The coordinate-descent refinement stays serial — its trials
  feed on the best-so-far assignment, so they are not independent.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..types import PoolView, RoundResult, Variant, Window
from ..wis import RoundSelector, wis_select
from .base import (ClearingPolicy, _FixedPointState, _pool_members,
                   fixed_point_settle)

__all__ = ["GlobalAssignment"]


@dataclass(frozen=True)
class GlobalAssignment(ClearingPolicy):
    """Assignment-search clearing: never clears less than ``GreedyWIS``.

    ``max_configs`` caps exhaustive enumeration of the joint cluster-choice
    space; above it the Hungarian seed + ``descent_passes`` rounds of
    coordinate descent bound the number of fixed-point evaluations
    (``max_evals`` is the hard stop).
    """

    name = "global_assignment"
    max_configs: int = 64
    descent_passes: int = 2
    max_evals: int = 200
    # selection runs on the raw auction scores (fused first pass usable)
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
        if view is None:
            view = PoolView.build(fit)
        windows = list(windows)
        rs = selector if isinstance(selector, RoundSelector) else None
        # shared replay state: the ban-free first pass is prefer-independent
        # and the packed buffers are score-independent, so every candidate
        # configuration replays from the same pair
        packed = None
        seed_pass: Optional[List[List[int]]] = None
        if prefetch is not None and fit:
            seed_pass, packed = prefetch.materialize(scores)
        elif rs is not None and fit:
            packed = rs.pack(_pool_members(len(windows), win_idx), view, scores)
        common = dict(selector=selector, work_budget=work_budget, view=view,
                      packed=packed)
        first_pass: List[List[int]] = []
        best = fixed_point_settle(windows, fit, win_idx, scores,
                                  first_pass_sink=first_pass,
                                  first_pass=seed_pass, **common)
        if best.n_conflicts == 0:
            return best  # greedy resolved nothing -> nothing to reassign

        clusters = self._conflict_clusters(first_pass, fit, win_idx)
        if not clusters:
            return best  # conflicts were budget-only: greedy order stands

        evals = 0
        members = packed.members if packed is not None else _pool_members(
            len(windows), win_idx)
        # replays compare on cheap state TOTALS (identical float-sum order
        # to packaged totals); only the winning state is packaged at the end
        best_total = best.total_score
        best_state: Optional[_FixedPointState] = None

        def to_prefer(choice: Sequence[Optional[int]]) -> Dict[str, tuple]:
            """Per-cluster choices → job_id → tuple of pinned pool indices."""
            prefer: Dict[str, tuple] = {}
            for (job, _), i in zip(clusters, choice):
                if i is not None:
                    prefer[job] = prefer.get(job, ()) + (i,)
            return prefer

        def run_state(choice) -> _FixedPointState:
            st = _FixedPointState(windows, fit, win_idx, scores, view,
                                  members, selector, packed, work_budget,
                                  to_prefer(choice))
            st.seed(first_pass)
            return st.run_to_fixed_point()

        def evaluate(choice: Sequence[Optional[int]]) -> bool:
            """Replay the fixed point under this assignment; keep if better.

            Returns False once the evaluation budget is spent.
            """
            nonlocal evals, best_total, best_state
            if evals >= self.max_evals:
                return False
            evals += 1
            st = run_state(choice)
            # strict improvement + deterministic first-seen tie-break
            total = st.total(scores)
            if total > best_total + 1e-12:
                best_total = total
                best_state = st
            return True

        def finish() -> RoundResult:
            return best_state.package(scores) if best_state is not None else best

        n_joint = 1
        for _, wins in clusters:
            n_joint *= len(wins)
            if n_joint > self.max_configs:
                break
        if n_joint <= self.max_configs:
            combos = list(itertools.product(*(wins for _, wins in clusters)))
            combos = combos[: max(0, self.max_evals - evals)]
            if rs is not None and len(combos) > 1:
                return self._lockstep_replays(
                    combos, to_prefer, best, windows, fit, win_idx, scores,
                    view, packed, first_pass, rs, work_budget)
            for combo in combos:
                if not evaluate(combo):
                    break  # evaluation budget spent
            return finish()

        # large joint space: Hungarian seed, then bounded coordinate descent
        current = self._hungarian_seed(clusters, scores, win_idx)
        evaluate(current)
        descent_mark = best_total
        for _ in range(self.descent_passes):
            improved = False
            for c, (_, wins) in enumerate(clusters):
                for i in wins:
                    if current[c] == i:
                        continue
                    trial = list(current)
                    trial[c] = i
                    if not evaluate(trial):
                        return finish()
                    if best_total > descent_mark + 1e-12:
                        descent_mark = best_total
                        current = trial
                        improved = True
            if not improved:
                break
        return finish()

    # -- lockstep config-batch replays (batched selector only) ----------------
    def _lockstep_replays(self, combos, to_prefer, best, windows, fit,
                          win_idx, scores, view, packed, first_pass, rs,
                          work_budget) -> RoundResult:
        """Run the exhaustive candidate configurations in lockstep.

        Every configuration's fixed point is independent, so each
        GENERATION gathers all live configurations' dirty windows into one
        batched dispatch (rows share the packed buffers; bans differ per
        configuration).  Results are byte-identical to the serial loop —
        states never interact — and the winner is chosen in enumeration
        order with the same strict-improvement tie-break.
        """
        members = packed.members
        states = []
        for combo in combos:
            st = _FixedPointState(windows, fit, win_idx, scores, view,
                                  members, rs, packed, work_budget,
                                  to_prefer(combo))
            st.seed(first_pass)
            st.resolve()
            states.append(st)
        while True:
            requests = []
            owners = []
            for st in states:
                if not st.active:
                    continue
                for k in st.take_dirty():
                    requests.append((k, st.banned))
                    owners.append((st, k))
            if not requests:
                break
            for (st, k), sel in zip(owners, rs.select_rows(packed, requests)):
                st.selected[k] = sel
            for st in states:
                if st.active:
                    st.resolve()
        best_total = best.total_score
        best_state = None
        for st in states:  # enumeration order: first-seen tie-break
            total = st.total(scores)
            if total > best_total + 1e-12:
                best_total = total
                best_state = st
        return best_state.package(scores) if best_state is not None else best

    # -- conflict structure ---------------------------------------------------
    @staticmethod
    def _conflict_clusters(
        first_pass: Sequence[Sequence[int]],
        fit: Sequence[Variant],
        win_idx: Sequence[int],
    ) -> List[Tuple[str, List[int]]]:
        """Per-job connected components of cross-window overlapping wins.

        ``first_pass`` is the ban-free per-window WIS selection captured by
        the baseline ``fixed_point_settle`` call (``first_pass_sink``) — the
        same wins the greedy pass starts revoking from, at no extra WIS
        cost.  Components of size ≥ 2 are the one-of-N choices the
        assignment search ranges over; budget conflicts are left to the
        fixed-point core.
        """
        from ..clearing import _overlap

        wins_by_job: Dict[str, List[int]] = {}
        for sel in first_pass:
            for i in sel:
                wins_by_job.setdefault(fit[i].job_id, []).append(i)

        clusters: List[Tuple[str, List[int]]] = []
        for job in sorted(wins_by_job):
            wins = sorted(wins_by_job[job])
            if len(wins) < 2:
                continue
            # union-find over the overlap graph (cross-window edges only)
            parent = {i: i for i in wins}

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            for a, b in itertools.combinations(wins, 2):
                if win_idx[a] != win_idx[b] and _overlap(fit[a], fit[b]):
                    parent[find(a)] = find(b)
            comps: Dict[int, List[int]] = {}
            for i in wins:
                comps.setdefault(find(i), []).append(i)
            for comp in comps.values():
                if len(comp) >= 2:
                    clusters.append((job, sorted(comp)))
        return clusters

    @staticmethod
    def _hungarian_seed(
        clusters: Sequence[Tuple[str, List[int]]],
        scores: np.ndarray,
        win_idx: Sequence[int],
    ) -> List[int]:
        """Per-cluster choices from a cluster↔window matching (search seed).

        ``scipy.optimize.linear_sum_assignment`` on the (cluster × window)
        profit matrix — profit = the cluster's best win-score in that
        window — yields one globally consistent keep-assignment.  It
        approximates the true objective (it ignores substitute recovery in
        displaced windows; coordinate descent refines that), and clusters
        the matching leaves unassigned fall back to their greedy choice
        (best score first, the same order the fixed point would use).
        """
        fallback = [
            max(wins, key=lambda i: (scores[i], -i)) for _, wins in clusters
        ]
        try:
            from scipy.optimize import linear_sum_assignment
        except Exception:  # pragma: no cover - scipy is a baked-in dep
            return fallback
        wset = sorted({int(win_idx[i]) for _, wins in clusters for i in wins})
        if not clusters or not wset:
            return fallback
        wpos = {w: c for c, w in enumerate(wset)}
        profit = np.full((len(clusters), len(wset)), -1e9)
        best_win: Dict[Tuple[int, int], int] = {}
        for r, (_, wins) in enumerate(clusters):
            for i in wins:
                c = wpos[int(win_idx[i])]
                if scores[i] > profit[r, c]:
                    profit[r, c] = scores[i]
                    best_win[(r, c)] = i
        rows, cols = linear_sum_assignment(profit, maximize=True)
        seed = list(fallback)
        for r, c in zip(rows, cols):
            if profit[r, c] > -1e8:
                seed[r] = best_win[(r, c)]
        return seed
