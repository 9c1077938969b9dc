"""The port's mirror of ``tests/test_policy.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

Policy-driven clearing API: backend equivalence/dominance properties,
unified Policy presets, legacy SchedulerConfig deprecation shim, per-agent θ
threading, and the shared epsilon constants.

The GreedyWIS byte-identity property is pinned against a FROZEN copy of the
PR-2 ``settle_round`` algorithm kept in this file: the production code moved
into ``repro.core.policy``, so only a literal reference copy can detect a
semantic drift of the default backend.  Property tests run under hypothesis
when available and fall back to seeded random pools otherwise (hypothesis is
not in the baked-in environment).
"""
import warnings

import numpy as np
import pytest

from repro_torch.core import (AgentConfig, JobAgent, JobSpec, ScoringPolicy,
                              SimConfig, SliceSpec, make_workload, simulate)
from repro_torch.core.clearing import _fits, _overlap, settle_round
from repro_torch.core.fairness import AgePolicy
from repro_torch.core.policy import (ClearingPolicy, FairShare,
                                     GlobalAssignment, GreedyWIS, Policy,
                                     fixed_point_settle)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.trp import fmp_standard
from repro_torch.core.types import (DEAD_WINDOW_EPS, TIME_EPS, RoundResult,
                                    Variant, Window)
from repro_torch.core.windows import DeadWindowRegistry, WindowPolicy
from repro_torch.core.wis import wis_select

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAS_HYPOTHESIS = False


# -- the port on the host: its "torch" / "cuda" backends run on the CPU only
# when asked, so every scheduler and round entry point gets device="cpu"
import dataclasses as _dc  # noqa: E402
import functools as _ft  # noqa: E402

import repro_torch.core as _port_core  # noqa: E402
import repro_torch.core.clearing as _port_clearing  # noqa: E402
import repro_torch.core.scoring as _port_scoring  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig as _Config  # noqa: E402


def on_cpu(config=None):
    """``config`` (None, a ``Policy`` or a ``SchedulerConfig``) with the
    device backends on the host."""
    if config is None:
        return _Config(device="cpu")
    if isinstance(config, _port_core.Policy):
        return _Config.from_policy(config, device="cpu")
    return _dc.replace(config, device="cpu")


def JasdaScheduler(slices, config=None):
    return _port_core.JasdaScheduler(slices, on_cpu(config))


clear_round = _ft.partial(_port_clearing.clear_round, device="cpu")
score_round = _ft.partial(_port_scoring.score_round, device="cpu")


GB = 1 << 30


def _variant(job, sid, t0, dur, h, *, work=None, vid=None, theta=1.0):
    return Variant(
        job_id=job, slice_id=sid, t_start=t0, duration=dur,
        fmp=fmp_standard(1 * GB, 2 * GB, 0.1 * GB),
        local_utility=h, declared_features={},
        payload={"work": work if work is not None else dur},
        variant_id=vid or f"{job}/{sid}/{t0}", theta=theta)


def _random_round(rng, *, n_windows=4, m=60, n_jobs=6, overlap_slices=True):
    """Random multi-window round with plenty of cross-window conflicts."""
    windows = [
        Window(f"s{k}", (4 + 2 * k) * GB,
               0.0 if overlap_slices else 120.0 * k, 100.0)
        for k in range(n_windows)
    ]
    pool = []
    for i in range(m):
        w = windows[int(rng.integers(0, n_windows))]
        t0 = w.t_min + float(rng.uniform(0, w.duration * 0.7))
        dur = float(rng.uniform(2.0, w.t_min + w.duration - t0))
        pool.append(_variant(f"J{i % n_jobs}", w.slice_id, t0, dur,
                             float(rng.uniform(0.1, 0.9)), vid=f"v{i}"))
    budget = {f"J{j}": float(rng.uniform(60.0, 200.0)) for j in range(n_jobs)}
    return windows, pool, budget


def _sig(rr: RoundResult):
    """Byte-comparable signature of a round outcome."""
    return (
        [tuple(v.variant_id for v in r.selected) for r in rr.results],
        [tuple(r.scores) for r in rr.results],
        rr.n_conflicts,
        round(rr.total_score, 12),
    )


# ---------------------------------------------------------------------------
# frozen PR-2 reference: the greedy settle algorithm as shipped before the
# policy API (verbatim semantics; do NOT refactor alongside production code)
# ---------------------------------------------------------------------------

def _reference_settle_pr2(windows, fit, win_idx, scores, *, work_budget=None):
    from repro_torch.core.types import ClearingResult, PoolView

    windows = list(windows)
    view = PoolView.build(fit)
    members = [[] for _ in windows]
    for i, k in enumerate(win_idx):
        members[k].append(i)
    banned = np.zeros(len(fit), dtype=bool)
    selected_per_window = [[] for _ in windows]
    dirty = list(range(len(windows)))
    n_conflicts = 0

    def _reclear(k):
        idx = [i for i in members[k] if not banned[i]]
        if not idx:
            selected_per_window[k] = []
            return
        ia = np.asarray(idx, np.intp)
        sel, _ = wis_select(view.t_start[ia], view.t_end[ia], scores[ia])
        selected_per_window[k] = [idx[int(j)] for j in np.asarray(sel)]

    def _olap(a, b):
        return (a.t_start < b.t_end - 1e-12 and b.t_start < a.t_end - 1e-12)

    while True:
        for k in dirty:
            _reclear(k)
        dirty = []
        wins_by_job = {}
        for k, sel in enumerate(selected_per_window):
            for i in sel:
                wins_by_job.setdefault(fit[i].job_id, []).append(i)
        newly_banned = False
        for job_id, wins in wins_by_job.items():
            if len(wins) < 2 and work_budget is None:
                continue
            wins.sort(key=lambda i: (-scores[i], fit[i].t_start, win_idx[i]))
            kept, used_work = [], 0.0
            budget = work_budget.get(job_id) if work_budget is not None else None
            for i in wins:
                drop = any(_olap(fit[i], fit[j]) and win_idx[i] != win_idx[j]
                           for j in kept)
                if not drop and budget is not None:
                    work = float(fit[i].payload["work"]) if fit[i].payload else 0.0
                    if used_work + work > budget + 1e-9:
                        drop = True
                    else:
                        used_work += work
                if drop:
                    banned[i] = True
                    newly_banned = True
                    n_conflicts += 1
                    if win_idx[i] not in dirty:
                        dirty.append(win_idx[i])
                else:
                    kept.append(i)
        if not newly_banned:
            break

    results, all_selected, all_scores = [], [], []
    for k, w in enumerate(windows):
        sel = sorted(selected_per_window[k], key=lambda i: fit[i].t_start)
        sel_set = set(sel)
        results.append(ClearingResult(
            window=w,
            selected=tuple(fit[i] for i in sel),
            scores=tuple(float(scores[i]) for i in sel),
            total_score=float(sum(scores[i] for i in sel)),
            n_bids=len(members[k]),
            rejected=tuple(fit[i] for i in members[k] if i not in sel_set),
        ))
        all_selected.extend(fit[i] for i in sel)
        all_scores.extend(float(scores[i]) for i in sel)
    return RoundResult(
        windows=tuple(windows), results=tuple(results),
        selected=tuple(all_selected), scores=tuple(all_scores),
        total_score=float(sum(all_scores)), n_bids=len(fit),
        n_conflicts=n_conflicts)


# ---------------------------------------------------------------------------
# GreedyWIS == frozen PR-2 reference (byte-identical), GA >= greedy
# ---------------------------------------------------------------------------

def _check_greedy_matches_reference(seed, *, with_budget):
    rng = np.random.default_rng(seed)
    windows, pool, budget = _random_round(rng)
    budget = budget if with_budget else None
    policy = ScoringPolicy()
    ages = {f"J{j}": 0.15 * j for j in range(6)}
    from repro_torch.core.clearing import assign_bids

    fit, win_idx, view = assign_bids(windows, pool)
    scores = score_round(fit, windows, win_idx, policy, ages=ages, view=view)

    got = GreedyWIS().settle(windows, fit, win_idx, scores,
                             work_budget=budget, view=view)
    ref = _reference_settle_pr2(windows, fit, win_idx, scores,
                                work_budget=budget)
    assert _sig(got) == _sig(ref), "GreedyWIS drifted from PR-2 semantics"
    # settle_round (the free function) must dispatch to the same default
    via_free = settle_round(windows, fit, win_idx, scores,
                            work_budget=budget, view=view)
    assert _sig(via_free) == _sig(ref)


def _check_global_assignment_dominates(seed, *, with_budget):
    rng = np.random.default_rng(seed)
    windows, pool, budget = _random_round(rng)
    budget = budget if with_budget else None
    policy = ScoringPolicy()
    greedy = clear_round(windows, pool, policy, work_budget=budget,
                         clearing=GreedyWIS())
    ga = clear_round(windows, pool, policy, work_budget=budget,
                     clearing=GlobalAssignment())
    assert ga.total_score >= greedy.total_score - 1e-9, \
        "GlobalAssignment cleared less total score than greedy"
    _assert_round_invariants(ga, budget)


def _assert_round_invariants(rr: RoundResult, budget):
    per_job, per_window = {}, {}
    for v in rr.selected:
        per_job.setdefault(v.job_id, []).append(v)
        per_window.setdefault(v.slice_id, []).append(v)
    for vs in per_job.values():
        vs.sort(key=lambda v: v.t_start)
        for a, b in zip(vs, vs[1:]):
            assert b.t_start >= a.t_end - 1e-9, "cross-window double booking"
    for vs in per_window.values():
        vs.sort(key=lambda v: v.t_start)
        for a, b in zip(vs, vs[1:]):
            assert b.t_start >= a.t_end - 1e-9
    if budget:
        for j, vs in per_job.items():
            assert sum(v.payload["work"] for v in vs) <= budget[j] + 1e-6


@pytest.mark.parametrize("with_budget", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_greedy_wis_byte_identical_to_pr2_reference(seed, with_budget):
    _check_greedy_matches_reference(seed, with_budget=with_budget)


@pytest.mark.parametrize("with_budget", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_global_assignment_never_below_greedy(seed, with_budget):
    _check_global_assignment_dominates(seed, with_budget=with_budget)


if HAS_HYPOTHESIS:

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), with_budget=st.booleans())
    def test_greedy_identity_property(seed, with_budget):
        _check_greedy_matches_reference(seed, with_budget=with_budget)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), with_budget=st.booleans())
    def test_global_assignment_dominance_property(seed, with_budget):
        _check_global_assignment_dominates(seed, with_budget=with_budget)


def test_global_assignment_strictly_recovers_dropped_utility():
    # J0 wins both windows with overlapping intervals; greedy keeps its best
    # (0.9 on sA) and leaves sB EMPTY after the re-clear, also displacing
    # J1's 0.85 substitute bid on sA.  The assignment moves J0 to sB so sA
    # re-clears to J1: total 1.65 vs greedy's 0.9.
    wa, wb = Window("sA", 8 * GB, 0.0, 20.0), Window("sB", 8 * GB, 0.0, 20.0)
    pool = [_variant("J0", "sA", 0.0, 10.0, 0.90, vid="j0a"),
            _variant("J0", "sB", 0.0, 10.0, 0.80, vid="j0b"),
            _variant("J1", "sA", 0.0, 10.0, 0.85, vid="j1a")]
    scoring = ScoringPolicy(lam=1.0, alphas={}, betas={})
    greedy = clear_round([wa, wb], pool, scoring, clearing=GreedyWIS())
    ga = clear_round([wa, wb], pool, scoring, clearing=GlobalAssignment())
    assert sorted(v.variant_id for v in greedy.selected) == ["j0a"]
    assert sorted(v.variant_id for v in ga.selected) == ["j0b", "j1a"]
    assert ga.total_score > greedy.total_score + 0.5


# ---------------------------------------------------------------------------
# FairShare: age-boosted selection + win spreading
# ---------------------------------------------------------------------------

def test_fairshare_promotes_starved_job():
    # same window, overlapping bids: J_new scores higher, J_starved has been
    # waiting (age 1.0).  GreedyWIS picks the raw-score winner; FairShare's
    # age boost flips the selection.  Reported scores stay RAW.
    w = Window("s0", 8 * GB, 0.0, 20.0)
    pool = [_variant("J_new", "s0", 0.0, 10.0, 0.80, vid="new"),
            _variant("J_starved", "s0", 0.0, 10.0, 0.70, vid="starved")]
    scoring = ScoringPolicy(lam=1.0, alphas={}, betas={})
    ages = {"J_new": 0.0, "J_starved": 1.0}
    greedy = clear_round([w], pool, scoring, ages=ages, clearing=GreedyWIS())
    fair = clear_round([w], pool, scoring, ages=ages,
                       clearing=FairShare(age_weight=0.5, spread=0.0))
    assert [v.variant_id for v in greedy.selected] == ["new"]
    assert [v.variant_id for v in fair.selected] == ["starved"]
    # raw auction score reported, not the boosted selection score
    assert fair.scores[0] == pytest.approx(0.70, abs=1e-6)


def test_fairshare_spreads_wins_across_jobs():
    # J_rich can fill both windows with slightly better bids; J_poor has one
    # bid per window.  With spreading, J_rich's second seat yields to J_poor.
    wa, wb = Window("sA", 8 * GB, 0.0, 20.0), Window("sB", 8 * GB, 30.0, 20.0)
    pool = [_variant("J_rich", "sA", 0.0, 10.0, 0.80, vid="ra"),
            _variant("J_rich", "sB", 30.0, 10.0, 0.78, vid="rb"),
            _variant("J_poor", "sA", 0.0, 10.0, 0.75, vid="pa"),
            _variant("J_poor", "sB", 30.0, 10.0, 0.74, vid="pb")]
    scoring = ScoringPolicy(lam=1.0, alphas={}, betas={})
    greedy = clear_round([wa, wb], pool, scoring, clearing=GreedyWIS())
    fair = clear_round([wa, wb], pool, scoring,
                       clearing=FairShare(age_weight=0.0, spread=0.5))
    assert sorted(v.variant_id for v in greedy.selected) == ["ra", "rb"]
    jobs_fair = sorted(v.job_id for v in fair.selected)
    assert jobs_fair == ["J_poor", "J_rich"], \
        "win spreading should give each job one window"


# ---------------------------------------------------------------------------
# unified Policy object + presets + deprecation shim
# ---------------------------------------------------------------------------

def test_policy_presets_compose_and_validate():
    util, fair, resp = Policy.utilization(), Policy.fairness(), Policy.responsive()
    assert isinstance(util.clearing, GlobalAssignment)
    assert isinstance(fair.clearing, FairShare)
    assert isinstance(resp.clearing, GreedyWIS)
    assert util.scoring.lam == 0.3 and resp.scoring.lam == 0.7
    assert util.window.kind == "best_fit"
    assert fair.scoring.beta_age == 0.5 and fair.age.tau == 30.0
    # presets accept overrides and stay frozen value objects
    p = Policy.responsive(per_agent_theta=True)
    assert p.per_agent_theta and p.name == "responsive"
    assert Policy() == Policy() and Policy() != util
    for preset in (util, fair, resp):
        assert preset.describe()
    with pytest.raises(ValueError):
        Policy(recheck_theta=0.0)
    with pytest.raises(ValueError):
        Policy(recheck_theta=1.5)
    with pytest.raises(TypeError):
        Policy(clearing="greedy")
    with pytest.raises(TypeError):
        Policy(scoring={"lam": 0.5})


def test_legacy_scheduler_config_deprecated_but_working():
    slices = [SliceSpec("s0", 20 * GB, n_chips=4)]
    legacy_cfg = SchedulerConfig(scoring=ScoringPolicy(lam=0.3),
                                 window=WindowPolicy(kind="largest"))
    with pytest.warns(DeprecationWarning, match="Policy"):
        sched = JasdaScheduler(slices, legacy_cfg)
    # fragments survive the conversion and the scheduler still schedules
    assert sched.policy.scoring.lam == 0.3
    assert sched.policy.window.kind == "largest"
    assert isinstance(sched.policy.clearing, GreedyWIS)
    for a in make_workload(5, seed=3, arrival_rate=5.0):
        sched.add_job(a, 0.0)
    assert sched.run_round(2.0) is not None

    # runtime-knob-only configs are NOT deprecated
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        JasdaScheduler(slices, SchedulerConfig(score_impl="torch", max_log_rows=10))
        JasdaScheduler(slices)
        # ...and neither is the blessed Policy + runtime-knobs combination,
        # including after dataclasses.replace of a from_policy config
        import dataclasses

        cfg = SchedulerConfig.from_policy(Policy.utilization(), score_impl="torch")
        sched = JasdaScheduler(slices, cfg)
        replaced = dataclasses.replace(cfg, max_log_rows=10)
        sched2 = JasdaScheduler(slices, replaced)
    # the original Policy (preset name, backend) survives both round-trips
    assert sched.policy == Policy.utilization()
    assert sched.config.score_impl == "torch"
    assert sched2.policy == Policy.utilization()
    assert sched2.config.max_log_rows == 10


def test_legacy_config_equals_policy_constructed_scheduler():
    slices = lambda: [SliceSpec("s0", 20 * GB, n_chips=4),
                      SliceSpec("s1", 10 * GB, n_chips=2)]
    with pytest.warns(DeprecationWarning):
        legacy = JasdaScheduler(slices(), SchedulerConfig(
            scoring=ScoringPolicy(lam=0.7)))
    unified = JasdaScheduler(slices(), Policy(scoring=ScoringPolicy(lam=0.7)))
    r1 = simulate(legacy, make_workload(10, seed=5, arrival_rate=0.8),
                  SimConfig(t_end=400.0, seed=2))
    r2 = simulate(unified, make_workload(10, seed=5, arrival_rate=0.8),
                  SimConfig(t_end=400.0, seed=2))
    assert [(c.variant_id, c.t_start) for c in legacy.commit_log] == \
        [(c.variant_id, c.t_start) for c in unified.commit_log]
    assert r1.total_score == pytest.approx(r2.total_score, abs=1e-9)
    assert r2.clearing == "greedy_wis"


@pytest.mark.parametrize("preset", ["utilization", "fairness", "responsive"])
def test_presets_run_end_to_end(preset):
    policy = getattr(Policy, preset)()
    sched = JasdaScheduler([SliceSpec("s20", 20 * GB, n_chips=4),
                            SliceSpec("s10", 10 * GB, n_chips=2)], policy)
    res = simulate(sched, make_workload(12, seed=7, arrival_rate=0.5),
                   SimConfig(t_end=800.0, seed=3))
    assert res.n_finished == 12
    assert res.policy == preset
    assert res.clearing == policy.clearing.name
    # the audit trail stays double-booking-free under every backend
    per_job = {}
    for r in sched.commit_log:
        if r.status in ("active", "completed"):
            per_job.setdefault(r.job_id, []).append(r.interval)
    for ivs in per_job.values():
        ivs.sort()
        for (s1, e1), (s2, e2) in zip(ivs, ivs[1:]):
            assert s2 >= e1 - 1e-9


def test_pipelined_rounds_byte_identical_under_policy():
    # acceptance: the default policy is byte-identical under the pipelined
    # and serial paths (the settle backend is pure, so speculation replays)
    def run(pipeline):
        sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4),
                                SliceSpec("s1", 10 * GB, n_chips=2)], Policy())
        simulate(sched, make_workload(10, seed=11, arrival_rate=0.8),
                 SimConfig(t_end=400.0, seed=4, pipeline=pipeline))
        return [(c.variant_id, c.t_start, c.score) for c in sched.commit_log]

    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# per-agent θ threading (satellite)
# ---------------------------------------------------------------------------

def test_variant_theta_flows_from_agent_config():
    spec = JobSpec(job_id="J0", arrival_time=0.0, total_work=50.0,
                   fmp=fmp_standard(1 * GB, 2 * GB, 0.1 * GB))
    agent = JobAgent(spec, AgentConfig(theta=0.17))
    w = Window("s0", 8 * GB, 0.0, 30.0)
    variants = agent.generate_variants_round([w], 0.0)
    assert variants and all(v.theta == 0.17 for v in variants)


def test_packed_round_thetas_are_per_agent():
    from repro_torch.core.clearing import assign_bids
    from repro_torch.kernels.jasda_score.ops import pool_to_arrays_round

    w = Window("s0", 8 * GB, 0.0, 30.0)
    pool = [_variant("J0", "s0", 0.0, 10.0, 0.5, vid="a", theta=0.02),
            _variant("J1", "s0", 10.0, 10.0, 0.5, vid="b", theta=0.4)]
    fit, win_idx, view = assign_bids([w], pool)
    packed = pool_to_arrays_round(
        fit, [w], win_idx, ScoringPolicy(), h=view.local_utility,
        pack_grids=True, theta=view.thetas, view=view)
    np.testing.assert_allclose(packed.thetas, [0.02, 0.4])


def test_per_agent_theta_recheck_discriminates():
    # identical bids except θ: the FMP sits close enough to capacity that
    # p_exceed falls between the strict and the loose agent bound, so the
    # in-dispatch recheck zeroes exactly the strict agent's bid
    from repro_torch.core.trp import prob_exceed_grid

    cap = 3.1 * GB
    fmp = fmp_standard(1 * GB, 3 * GB, 0.05 * GB, rel_sigma=0.01)
    mu, sigma = fmp.grid(32)
    p = prob_exceed_grid(mu, sigma, cap)  # ≈ 0.11 for this FMP/capacity
    assert 1e-6 < p < 0.5, f"test FMP mis-calibrated: p_exceed={p}"
    w = Window("s0", cap, 0.0, 30.0)
    strict = Variant(job_id="JS", slice_id="s0", t_start=0.0, duration=10.0,
                     fmp=fmp, local_utility=0.8, declared_features={},
                     payload={"work": 10.0}, variant_id="strict", theta=p / 10)
    loose = Variant(job_id="JL", slice_id="s0", t_start=10.0, duration=10.0,
                    fmp=fmp, local_utility=0.8, declared_features={},
                    payload={"work": 10.0}, variant_id="loose", theta=min(1.0, p * 10))
    scores = score_round([strict, loose], [w], [0, 0], ScoringPolicy(),
                         per_agent_theta=True, impl="numpy")
    assert scores[0] == 0.0, "strict-θ bid must fail its own recheck"
    assert scores[1] > 0.0, "loose-θ bid must pass its own recheck"
    # scheduler-wide override takes precedence over per-agent θ
    override = score_round([strict, loose], [w], [0, 0], ScoringPolicy(),
                           per_agent_theta=True, recheck_theta=min(1.0, p * 10),
                           impl="numpy")
    assert override[0] > 0.0 and override[1] > 0.0


def test_scheduler_per_agent_theta_end_to_end():
    # a policy with per_agent_theta wires Variant.theta into the dispatch;
    # with the workload's generation-time safety already enforced, the
    # recheck must not zero any honest bid (selections still commit)
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)],
                           Policy(per_agent_theta=True))
    for a in make_workload(5, seed=3, arrival_rate=5.0):
        sched.add_job(a, 0.0)
    rr = sched.run_round(2.0)
    assert rr is not None and rr.selected


# ---------------------------------------------------------------------------
# shared epsilon constants (satellite)
# ---------------------------------------------------------------------------

def test_epsilon_constants_are_shared():
    import inspect

    from repro_torch.core.types import OVERLAP_EPS, overlaps

    # one base constant, three derived tolerances with fixed relationships
    assert OVERLAP_EPS == 1e-3 * TIME_EPS
    assert DEAD_WINDOW_EPS == 1e3 * TIME_EPS
    assert OVERLAP_EPS < TIME_EPS < DEAD_WINDOW_EPS
    assert DeadWindowRegistry().eps == DEAD_WINDOW_EPS
    assert SchedulerConfig().dead_window_eps == DEAD_WINDOW_EPS
    # the clearing predicates take their defaults from the shared constants
    assert inspect.signature(_fits).parameters["eps"].default is TIME_EPS
    assert inspect.signature(_overlap).parameters["eps"].default is OVERLAP_EPS
    assert inspect.signature(overlaps).parameters["eps"].default is OVERLAP_EPS
    # semantics at the boundary: touching intervals are compatible,
    # sub-epsilon drift does not flip fit/overlap verdicts
    a = _variant("J0", "s0", 0.0, 10.0, 0.5)
    b = _variant("J1", "s0", 10.0, 5.0, 0.5)
    assert not _overlap(a, b)
    c = _variant("J2", "s0", 10.0 - OVERLAP_EPS / 2, 5.0, 0.5)
    assert not _overlap(a, c), "sub-epsilon overlap must be tolerated"
    w = Window("s0", 8 * GB, 0.0, 10.0)
    d = _variant("J3", "s0", 0.0, 10.0 + TIME_EPS / 2, 0.5)
    assert _fits(d, w), "sub-epsilon boundary excess must still fit"


# ---------------------------------------------------------------------------
# custom backends plug in through the same protocol
# ---------------------------------------------------------------------------

def test_custom_clearing_policy_dispatches():
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class FirstWindowOnly(ClearingPolicy):
        """Degenerate backend: clears only the first announced window."""

        name = "first_window_only"

        def settle(self, windows, fit, win_idx, scores, *, selector=wis_select,
                   work_budget=None, view=None, ages=None):
            keep = [i for i, k in enumerate(win_idx) if k == 0]
            sub_idx = [0] * len(keep)
            sub_fit = [fit[i] for i in keep]
            rr = fixed_point_settle([windows[0]], sub_fit, sub_idx,
                                    np.asarray(scores)[keep],
                                    selector=selector, work_budget=work_budget)
            from repro_torch.core.types import ClearingResult

            results = list(rr.results) + [
                ClearingResult(window=w, selected=(), scores=(),
                               total_score=0.0, n_bids=0)
                for w in windows[1:]
            ]
            return RoundResult(tuple(windows), tuple(results), rr.selected,
                               rr.scores, rr.total_score, len(fit),
                               n_conflicts=rr.n_conflicts)

    rng = np.random.default_rng(0)
    windows, pool, _ = _random_round(rng, overlap_slices=False)
    rr = clear_round(windows, pool, ScoringPolicy(),
                     clearing=FirstWindowOnly())
    assert rr.results[0].selected
    assert all(not r.selected for r in rr.results[1:])
    # and through the scheduler path via Policy
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)],
                           Policy(name="custom", clearing=FirstWindowOnly()))
    assert isinstance(sched.policy.clearing, FirstWindowOnly)


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------


def _round_in(types, trp, seed):
    """``_random_round``'s round, built from package ``types`` / ``trp``."""
    rng = np.random.default_rng(seed)
    windows = [types.Window(f"s{k}", (4 + 2 * k) * GB, 0.0, 100.0)
               for k in range(4)]
    pool = []
    for i in range(60):
        w = windows[int(rng.integers(0, 4))]
        t0 = w.t_min + float(rng.uniform(0, w.duration * 0.7))
        dur = float(rng.uniform(2.0, w.t_min + w.duration - t0))
        pool.append(types.Variant(
            job_id=f"J{i % 6}", slice_id=w.slice_id, t_start=t0, duration=dur,
            fmp=trp.fmp_standard(1 * GB, 2 * GB, 0.1 * GB),
            local_utility=float(rng.uniform(0.1, 0.9)), declared_features={},
            payload={"work": dur}, variant_id=f"v{i}"))
    budget = {f"J{j}": float(rng.uniform(60.0, 200.0)) for j in range(6)}
    return windows, pool, budget


@pytest.mark.parametrize("backend", ["GreedyWIS", "GlobalAssignment",
                                     "FairShare"])
@pytest.mark.parametrize("seed", range(3))
def test_clearing_backends_match_reference(backend, seed):
    """Each clearing backend on the same round through both packages: the
    host paths byte for byte, the port's torch backends against the
    reference's jnp backends (selections; scores within 3e-5)."""
    import repro.core.clearing as ref_clearing
    import repro.core.policy as ref_policy
    import repro.core.scoring as ref_scoring
    import repro.core.trp as ref_trp
    import repro.core.types as ref_types
    import repro_torch.core.policy as port_policy
    import repro_torch.core.trp as port_trp
    import repro_torch.core.types as port_types

    windows, pool, budget = _round_in(port_types, port_trp, seed)
    rwin, rpool, rbudget = _round_in(ref_types, ref_trp, seed)
    assert budget == rbudget
    ages = {f"J{j}": 0.15 * j for j in range(6)}
    ref_host = ref_clearing.clear_round(
        rwin, rpool, ref_scoring.ScoringPolicy(), ages=ages,
        work_budget=rbudget, clearing=getattr(ref_policy, backend)())
    host = clear_round(windows, pool, ScoringPolicy(), ages=ages,
                       work_budget=budget,
                       clearing=getattr(port_policy, backend)())
    assert _sig(host) == _sig(ref_host)
    ref_dev = ref_clearing.clear_round(
        rwin, rpool, ref_scoring.ScoringPolicy(), ages=ages,
        work_budget=rbudget, clearing=getattr(ref_policy, backend)(),
        score_impl="ref", wis_impl="ref")
    for impl in ("torch", "cuda"):
        dev = clear_round(windows, pool, ScoringPolicy(), ages=ages,
                          work_budget=budget,
                          clearing=getattr(port_policy, backend)(),
                          score_impl=impl, wis_impl=impl)
        assert _sig(dev)[0] == _sig(ref_dev)[0]
        assert _sig(dev)[2] == _sig(ref_dev)[2]
        for a, b in zip(_sig(dev)[1], _sig(ref_dev)[1]):
            np.testing.assert_allclose(a, b, atol=3e-5, rtol=0)
