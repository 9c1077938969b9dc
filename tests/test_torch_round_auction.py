"""The port's mirror of ``tests/test_round_auction.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

Round-based auction: equivalence with the legacy single-window path,
cross-window exclusivity, work conservation, failures, dead-window epsilon."""
import numpy as np
import pytest

from repro_torch.core import (AgentConfig, JobAgent, JobSpec, ScoringPolicy,
                              SimConfig, SliceSpec, simulate, make_workload)
from repro_torch.core.clearing import clear_window
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.scoring import score_pool
from repro_torch.core.trp import fmp_standard
from repro_torch.core.types import Variant, Window
from repro_torch.core.windows import (DeadWindowRegistry, SliceTimeline,
                                      WindowPolicy, announce_window,
                                      announce_windows)


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


def _variant(job, sid, t0, dur, h, *, work=None, vid=None):
    return Variant(
        job_id=job, slice_id=sid, t_start=t0, duration=dur,
        fmp=fmp_standard(1 * GB, 2 * GB, 0.1 * GB),
        local_utility=h, declared_features={},
        payload={"work": work if work is not None else dur},
        variant_id=vid or f"{job}/{sid}/{t0}")


def _pool_for(window, rng, n, jobs=4):
    out = []
    for i in range(n):
        t0 = window.t_min + rng.uniform(0, window.duration * 0.6)
        dur = rng.uniform(2.0, window.t_min + window.duration - t0)
        out.append(_variant(f"J{i % jobs}", window.slice_id, t0, dur,
                            float(rng.uniform(0.1, 0.9)), vid=f"v{i}"))
    return out


# ---------------------------------------------------------------------------
# single-window equivalence: round clearing == legacy per-window clearing
# ---------------------------------------------------------------------------

def test_single_window_round_equivalence():
    rng = np.random.default_rng(0)
    w = Window("s0", 8 * GB, 10.0, 60.0)
    pool = _pool_for(w, rng, 40)
    policy = ScoringPolicy()
    ages = {f"J{j}": 0.1 * j for j in range(4)}

    legacy = clear_window(w, pool, policy, ages=ages)
    rr = clear_round([w], pool, policy, ages=ages)

    assert [v.variant_id for v in rr.results[0].selected] == \
        [v.variant_id for v in legacy.selected]
    assert rr.n_bids == legacy.n_bids
    np.testing.assert_allclose(rr.results[0].scores, legacy.scores, atol=1e-5)


def test_scheduler_step_is_single_window_round():
    # step() (the compatibility wrapper) must behave like the legacy
    # iteration: one window announced, one ClearingResult returned, commits
    # recorded — driven on a live scheduler
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)])
    for a in make_workload(5, seed=3, arrival_rate=5.0):
        sched.add_job(a, 0.0)
    res = sched.step(2.0)
    assert res is not None and res.selected
    assert len(sched.commitments) == len(res.selected)
    assert all(c.variant.slice_id == "s0" for c in sched.commitments)


def test_score_round_matches_score_pool_per_window():
    rng = np.random.default_rng(1)
    windows = [Window("s0", 8 * GB, 0.0, 50.0), Window("s1", 4 * GB, 20.0, 40.0)]
    pools = [_pool_for(w, rng, 16) for w in windows]
    flat = pools[0] + pools[1]
    win_idx = [0] * 16 + [1] * 16
    policy = ScoringPolicy()
    ages = {f"J{j}": 0.2 * j for j in range(4)}

    batched = score_round(flat, windows, win_idx, policy, ages=ages)
    legacy = np.concatenate([
        score_pool(pools[k], windows[k], policy, ages=ages) for k in range(2)
    ])
    np.testing.assert_allclose(batched, legacy, atol=1e-5)
    # forced jnp path agrees with the auto (numpy small-pool) path
    ref = score_round(flat, windows, win_idx, policy, ages=ages, impl="torch")
    np.testing.assert_allclose(ref, legacy, atol=1e-5)


# ---------------------------------------------------------------------------
# cross-window exclusivity
# ---------------------------------------------------------------------------

def test_cross_window_job_keeps_best_win_only():
    # one job bids the same time span on two slices; higher-utility variant
    # must win, the other must be revoked
    wa = Window("sA", 8 * GB, 0.0, 20.0)
    wb = Window("sB", 8 * GB, 0.0, 20.0)
    va = _variant("J0", "sA", 0.0, 10.0, 0.9, vid="a")
    vb = _variant("J0", "sB", 0.0, 10.0, 0.3, vid="b")
    rr = clear_round([wa, wb], [va, vb], ScoringPolicy())
    assert [v.variant_id for v in rr.selected] == ["a"]
    assert rr.n_conflicts == 1


def test_cross_window_nonoverlapping_wins_both_kept():
    wa = Window("sA", 8 * GB, 0.0, 20.0)
    wb = Window("sB", 8 * GB, 0.0, 40.0)
    va = _variant("J0", "sA", 0.0, 10.0, 0.9, vid="a")
    vb = _variant("J0", "sB", 25.0, 10.0, 0.8, vid="b")
    rr = clear_round([wa, wb], [va, vb], ScoringPolicy())
    assert sorted(v.variant_id for v in rr.selected) == ["a", "b"]
    assert rr.n_conflicts == 0


def test_cross_window_work_budget_enforced():
    # two non-overlapping wins, but the job only has work for one of them
    wa = Window("sA", 8 * GB, 0.0, 20.0)
    wb = Window("sB", 8 * GB, 0.0, 60.0)
    va = _variant("J0", "sA", 0.0, 10.0, 0.9, work=10.0, vid="a")
    vb = _variant("J0", "sB", 30.0, 10.0, 0.8, work=10.0, vid="b")
    rr = clear_round([wa, wb], [va, vb], ScoringPolicy(),
                     work_budget={"J0": 10.0})
    assert [v.variant_id for v in rr.selected] == ["a"]
    assert rr.n_conflicts == 1


def test_freed_interval_recleared_within_round():
    # J0 wins on both windows; once its sB win is revoked, J1's bid (which
    # J0 was beating) must be promoted in the SAME round
    wa = Window("sA", 8 * GB, 0.0, 20.0)
    wb = Window("sB", 8 * GB, 0.0, 20.0)
    pool = [
        _variant("J0", "sA", 0.0, 10.0, 0.9, vid="j0a"),
        _variant("J0", "sB", 0.0, 10.0, 0.8, vid="j0b"),
        _variant("J1", "sB", 0.0, 10.0, 0.5, vid="j1b"),
    ]
    rr = clear_round([wa, wb], pool, ScoringPolicy())
    assert sorted(v.variant_id for v in rr.selected) == ["j0a", "j1b"]


@pytest.mark.parametrize("seed", range(4))
def test_round_invariants_random_pools(seed):
    rng = np.random.default_rng(seed)
    windows = [Window(f"s{k}", (4 + 2 * k) * GB, 0.0, 100.0) for k in range(4)]
    pool = []
    for k, w in enumerate(windows):
        pool.extend(_pool_for(w, rng, 20, jobs=6))
    budget = {f"J{j}": 120.0 for j in range(6)}
    rr = clear_round(windows, pool, ScoringPolicy(), work_budget=budget)

    per_job = {}
    per_window = {}
    for v in rr.selected:
        per_job.setdefault(v.job_id, []).append(v)
        per_window.setdefault(v.slice_id, []).append(v)
    # (i) no job holds two overlapping intervals — even across slices
    for vs in per_job.values():
        vs.sort(key=lambda v: v.t_start)
        for a, b in zip(vs, vs[1:]):
            assert b.t_start >= a.t_end - 1e-9, "cross-window double booking"
    # (ii) per-window selections are pairwise compatible
    for vs in per_window.values():
        vs.sort(key=lambda v: v.t_start)
        for a, b in zip(vs, vs[1:]):
            assert b.t_start >= a.t_end - 1e-9
    # (iii) work budgets respected
    for j, vs in per_job.items():
        assert sum(v.payload["work"] for v in vs) <= budget[j] + 1e-6


# ---------------------------------------------------------------------------
# multi-slice rounds end-to-end (with failures injected)
# ---------------------------------------------------------------------------

def test_multi_slice_round_with_failures():
    slices = [SliceSpec("s20", 20 * GB, n_chips=4),
              SliceSpec("s10", 10 * GB, n_chips=2),
              SliceSpec("s5", 5 * GB, n_chips=1)]
    sched = JasdaScheduler(slices)
    agents = make_workload(25, seed=9, arrival_rate=0.4, mem_range_gb=(1.0, 8.0))
    res = simulate(sched, agents,
                   SimConfig(t_end=4000.0, seed=5, failure_rate=0.003,
                             repair_time=40.0))
    assert res.n_finished == 25, "round auction must survive slice failures"
    per_job = {}
    for r in sched.commit_log:
        if r.status in ("active", "completed"):
            per_job.setdefault(r.job_id, []).append(r.interval)
    for job, ivs in per_job.items():
        ivs.sort()
        for (s1, e1), (s2, e2) in zip(ivs, ivs[1:]):
            assert s2 >= e1 - 1e-9, f"job {job} double-booked"
    for a in sched.agents.values():
        assert a.work_done <= a.spec.total_work + 1e-6


# ---------------------------------------------------------------------------
# window announcement (round form) + dead-window epsilon tolerance
# ---------------------------------------------------------------------------

def test_announce_windows_returns_all_gaps_policy_ordered():
    slices = {s.slice_id: SliceTimeline(s)
              for s in [SliceSpec("s0", 8 * GB), SliceSpec("s1", 4 * GB)]}
    slices["s0"].commit(10, 40)
    ws = announce_windows(slices, 0.0, WindowPolicy(kind="earliest", horizon=100))
    # s0 has gaps [0,10) and [40,100); s1 has [0,100)
    assert len(ws) == 3
    assert ws[0].t_min == 0.0
    assert announce_window(slices, 0.0,
                           WindowPolicy(kind="earliest", horizon=100)) == ws[0]
    wl = announce_windows(slices, 0.0, WindowPolicy(kind="largest", horizon=100))
    assert {(w.slice_id, w.t_min) for w in wl} == {(w.slice_id, w.t_min) for w in ws}
    assert wl[0].duration == max(w.duration for w in wl)


def test_dead_window_registry_epsilon_and_expiry():
    reg = DeadWindowRegistry(eps=1e-6)
    reg.add("s0", 100.0, expiry=50.0)
    # float drift (release / early finish re-derivation) must still match
    assert reg.suppressed("s0", 100.0 + 3e-7)
    assert reg.suppressed("s0", 100.0 - 3e-7)
    assert not reg.suppressed("s0", 100.001)
    assert not reg.suppressed("s1", 100.0)
    reg.prune(49.0)
    assert reg.suppressed("s0", 100.0)
    reg.prune(50.0)
    assert not reg.suppressed("s0", 100.0)
    assert len(reg) == 0


def test_dead_window_suppression_survives_drift_in_announce():
    slices = {"s0": SliceTimeline(SliceSpec("s0", 8 * GB))}
    policy = WindowPolicy(horizon=100)
    reg = DeadWindowRegistry(eps=1e-6)
    w = announce_window(slices, 0.0, policy)
    reg.add(w.slice_id, w.t_min, expiry=10.0)
    # commit + release perturbs the derived gap start by float noise
    slices["s0"].commit(w.t_min, w.t_min + 5.0)
    slices["s0"].release(w.t_min, w.t_min + 5.0 - 1e-9)
    ws = announce_windows(slices, 0.0, policy, exclude=reg)
    assert all(abs(x.t_min - w.t_min) > 1e-6 for x in ws), \
        "drifted dead window must stay suppressed"


# ---------------------------------------------------------------------------
# makespan: last completion − first arrival
# ---------------------------------------------------------------------------

def test_makespan_is_last_completion_minus_first_arrival():
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)])
    agents = make_workload(8, seed=11, arrival_rate=0.1)
    res = simulate(sched, agents, SimConfig(t_end=4000.0, seed=6))
    assert res.n_finished == 8
    arrivals = {a.spec.job_id: a.spec.arrival_time for a in agents}
    completions = [arrivals[j] + jct for j, jct in res.jct_per_job.items()]
    expected = max(completions) - min(arrivals.values())
    assert res.makespan == pytest.approx(expected, abs=1e-9)
    # the old (buggy) formula would have reported max per-job JCT instead
    assert res.makespan >= max(res.jct_per_job.values()) - 1e-9


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_random_rounds_match_reference(seed):
    """``test_round_invariants_random_pools``' rounds through both packages,
    each ``SMALL_POOL_M`` bids or more so the device backends score them
    (the auto choice too: the reference's jnp path, the port's torch path
    on the host), against the reference's jnp backends: the same
    selections, float32 scores within 3e-5."""
    import repro.core.clearing as ref_clearing
    import repro.core.scoring as ref_scoring
    import repro.core.trp as ref_trp
    import repro.core.types as ref_types

    def build(types, trp):
        rng = np.random.default_rng(seed)
        windows = [types.Window(f"s{k}", (4 + 2 * k) * GB, 0.0, 100.0)
                   for k in range(4)]
        pool = []
        for w in windows:
            for i in range(70):
                t0 = w.t_min + rng.uniform(0, w.duration * 0.6)
                dur = rng.uniform(2.0, w.t_min + w.duration - t0)
                pool.append(types.Variant(
                    job_id=f"J{i % 6}", slice_id=w.slice_id, t_start=t0,
                    duration=dur, fmp=trp.fmp_standard(1 * GB, 2 * GB, 0.1 * GB),
                    local_utility=float(rng.uniform(0.1, 0.9)),
                    declared_features={}, payload={"work": dur},
                    variant_id=f"{w.slice_id}/v{i}"))
        return windows, pool

    budget = {f"J{j}": 120.0 for j in range(6)}
    windows, pool = build(_port_core.types, _port_core.trp)
    rwin, rpool = build(ref_types, ref_trp)

    def sig(rr):
        return ([tuple(v.variant_id for v in r.selected) for r in rr.results],
                rr.selected_idx, rr.n_conflicts, np.asarray(rr.scores))

    assert len(pool) >= 256
    for ref_impl, impls in ((None, (None,)), ("ref", ("torch", "cuda"))):
        want = sig(ref_clearing.clear_round(
            rwin, rpool, ref_scoring.ScoringPolicy(), work_budget=budget,
            score_impl=ref_impl, wis_impl=ref_impl))
        for impl in impls:
            got = sig(clear_round(windows, pool, ScoringPolicy(),
                                  work_budget=budget, score_impl=impl,
                                  wis_impl=impl))
            assert got[:3] == want[:3]
            np.testing.assert_allclose(got[3], want[3], atol=3e-5, rtol=0)
