"""The port's mirror of ``tests/test_score_engine.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

Zero-recompile scoring engine + round pipelining.

Covers the PR 2 contracts:
  * per-variant capacity/θ parity across pallas-interpret / jnp ref / host
    numpy (incl. mixed-capacity pools and pack_grids=True safety rechecks)
  * scalar (λ, capacity, θ) compat overload == per-variant broadcast
  * M-bucketed dispatch: zero retraces across drifting pool sizes / λ /
    heterogeneous capacities
  * pipelining equivalence: run_rounds_pipelined and SimConfig(pipeline=True)
    selections byte-identical to serial rounds (incl. failure injection and
    the speculation filter/discard paths)
  * bounded bookkeeping: per-scheduler FMP grid cache, commitment pruning,
    commit_log statuses, max_log_rows caps
"""
import numpy as np
import pytest

from repro_torch.core import (ScoringPolicy, SimConfig, SliceSpec, Window,
                              make_workload, simulate)
from repro_torch.core.jobs import AgentConfig, JobAgent
from repro_torch.core.pipeline import RoundPipeline
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.trp import fmp_standard, prob_exceed_grid
from repro_torch.core.types import JobSpec, Variant
from repro_torch.kernels.jasda_score.ops import (FMPGridCache, bucket_m,
                                                 pool_to_arrays_round,
                                                 score_variants,
                                                 score_variants_numpy,
                                                 build_counts)


# -- the port on the host: its "torch" / "cuda" backends run on the CPU only
# when asked, so every scheduler and round entry point gets device="cpu"
import dataclasses as _dc  # noqa: E402
import functools as _ft  # noqa: E402

import repro_torch.core as _port_core  # noqa: E402
import repro_torch.core.clearing as _port_clearing  # noqa: E402
import repro_torch.core.scoring as _port_scoring  # noqa: E402
import repro_torch.core.pipeline as _port_pipeline  # noqa: E402
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
pipelined_clear_rounds = _ft.partial(_port_pipeline.pipelined_clear_rounds,
                                     device="cpu")
score_variants = _ft.partial(score_variants, device="cpu")  # noqa: F811


GB = 1 << 30


def _score_args(m, t, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        feat_job=rng.uniform(0, 1, (m, 3)).astype(np.float32),
        feat_sys=rng.uniform(0, 1, (m, 3)).astype(np.float32),
        alphas=np.array([.5, .3, .2], np.float32),
        betas=np.array([.4, .2, .2], np.float32),
        mu=rng.uniform(5, 21, (m, t)).astype(np.float32),
        sigma=rng.uniform(0.01, .8, (m, t)).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# kernel contract: per-variant runtime (λ, capacity, θ)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,t", [(64, 16), (300, 32)])
def test_per_variant_capacity_parity_three_backends(m, t):
    rng = np.random.default_rng(m)
    args = _score_args(m, t, seed=m)
    caps = rng.choice([12.0, 16.0, 20.0], m)
    ths = rng.choice([0.02, 0.05, 0.2], m)
    lam = 0.6

    s_p, e_p, _ = score_variants(**args, lam=lam, capacity=caps, theta=ths,
                                 impl="cuda")
    s_r, e_r, p_r = score_variants(**args, lam=lam, capacity=caps, theta=ths,
                                   impl="torch")
    s_n, e_n, p_n = score_variants_numpy(**args, lam=lam, capacity=caps,
                                         theta=ths)
    # pallas and jnp ref run identical f32 math
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_r), atol=3e-5)
    np.testing.assert_array_equal(np.asarray(e_p), np.asarray(e_r))
    # numpy runs float64: compare away from the θ decision boundary, where
    # f32-vs-f64 rounding of p_exceed can legitimately flip eligibility
    off_boundary = np.abs(p_n - ths) > 1e-4
    assert off_boundary.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(e_r)[off_boundary],
                                  e_n[off_boundary])
    np.testing.assert_allclose(np.asarray(s_r)[off_boundary],
                               s_n[off_boundary], atol=3e-5)


def test_per_variant_safety_matches_host_trp_evaluator():
    # each row checked against ITS OWN capacity must equal the host
    # prob_exceed_grid at that capacity
    rng = np.random.default_rng(7)
    m, t = 24, 48
    args = _score_args(m, t, seed=7)
    caps = rng.choice([14.0, 18.0, 22.0], m)
    _, _, p = score_variants(**args, lam=0.5, capacity=caps, theta=0.05,
                             impl="torch")
    mu64 = np.asarray(args["mu"], np.float64)
    sg64 = np.asarray(args["sigma"], np.float64)
    for i in range(m):
        p_host = prob_exceed_grid(mu64[i], sg64[i], float(caps[i]))
        assert float(p[i]) == pytest.approx(p_host, abs=1e-4)


def test_scalar_overload_equals_constant_vector():
    m, t = 100, 16
    args = _score_args(m, t, seed=3)
    for impl in ("cuda", "torch"):
        s_scalar, e_scalar, _ = score_variants(
            **args, lam=0.4, capacity=18.0, theta=0.05, impl=impl)
        s_vec, e_vec, _ = score_variants(
            **args, lam=np.full(m, 0.4), capacity=np.full(m, 18.0),
            theta=np.full(m, 0.05), impl=impl)
        np.testing.assert_array_equal(np.asarray(s_scalar), np.asarray(s_vec))
        np.testing.assert_array_equal(np.asarray(e_scalar), np.asarray(e_vec))


def test_bucketed_dispatch_zero_retraces():
    # warm both buckets, then drifting (M, λ, capacity, θ) must never retrace
    t = 16
    for m_warm in (256, 512):
        args = _score_args(m_warm, t, seed=m_warm)
        score_variants(**args, lam=0.5, capacity=10.0, theta=0.1, impl="torch")
    base = build_counts()
    rng = np.random.default_rng(1)
    for i, m in enumerate((180, 300, 256, 511, 400, 222, 512, 333)):
        args = _score_args(m, t, seed=i)
        caps = rng.choice([8.0, 12.0, 20.0], m)
        score_variants(**args, lam=float(rng.uniform(0, 1)), capacity=caps,
                       theta=float(rng.uniform(0.01, 0.5)), impl="torch")
    assert build_counts() == base, "runtime-arg dispatch retraced"
    assert bucket_m(180) == 256 and bucket_m(300) == 512


# ---------------------------------------------------------------------------
# round packing: per-variant capacities + mixed-capacity safety recheck
# ---------------------------------------------------------------------------

def _mk_variant(job, sid, t0, dur, fmp, h=0.5, vid=None):
    return Variant(job_id=job, slice_id=sid, t_start=t0, duration=dur,
                   fmp=fmp, local_utility=h, declared_features={},
                   payload={"work": dur}, variant_id=vid or f"{job}/{sid}/{t0}")


def test_pool_to_arrays_round_gathers_window_capacity_per_bid():
    small = Window("sA", 4 * GB, 0.0, 50.0)
    big = Window("sB", 16 * GB, 0.0, 50.0)
    fmp = fmp_standard(1 * GB, 2 * GB, 0.2 * GB)
    pool = [_mk_variant("J0", "sA", 0.0, 10.0, fmp),
            _mk_variant("J0", "sB", 0.0, 10.0, fmp),
            _mk_variant("J1", "sB", 20.0, 10.0, fmp)]
    packed = pool_to_arrays_round(pool, [small, big], [0, 1, 1],
                                  ScoringPolicy(), theta=0.07)
    np.testing.assert_array_equal(packed.caps, [4 * GB, 16 * GB, 16 * GB])
    np.testing.assert_array_equal(packed.thetas, [0.07] * 3)


@pytest.mark.parametrize("impl", ["numpy", "torch", "cuda"])
def test_mixed_capacity_recheck_zeroes_unsafe_bids(impl):
    # one FMP is unsafe on the small slice but safe on the big one: with the
    # in-dispatch recheck its small-window bid must score 0 (ineligible)
    # while its big-window bid survives — per-variant capacities at work
    small = Window("sA", 3 * GB, 0.0, 50.0)
    big = Window("sB", 16 * GB, 0.0, 50.0)
    risky = fmp_standard(1 * GB, 2.9 * GB, 0.5 * GB, rel_sigma=0.2)
    tame = fmp_standard(0.5 * GB, 1 * GB, 0.1 * GB)
    assert prob_exceed_grid(*risky.grid(32), 3 * GB) > 0.05
    assert prob_exceed_grid(*risky.grid(32), 16 * GB) <= 0.05
    pool = [_mk_variant("J0", "sA", 0.0, 10.0, risky, h=0.9, vid="risky-small"),
            _mk_variant("J0", "sB", 0.0, 10.0, risky, h=0.9, vid="risky-big"),
            _mk_variant("J1", "sA", 20.0, 10.0, tame, h=0.5, vid="tame-small")]
    scores = score_round(pool, [small, big], [0, 1, 0], ScoringPolicy(),
                         impl=impl, recheck_theta=0.05)
    assert scores[0] == 0.0, "unsafe bid must be zeroed on its own window"
    assert scores[1] > 0.0 and scores[2] > 0.0
    # without the recheck the unsafe bid would have scored normally
    no_recheck = score_round(pool, [small, big], [0, 1, 0], ScoringPolicy(),
                             impl=impl)
    assert no_recheck[0] > 0.0


def test_recheck_parity_across_backends():
    rng = np.random.default_rng(5)
    windows = [Window(f"s{k}", (3 + 5 * k) * GB, 0.0, 100.0) for k in range(3)]
    fmps = [fmp_standard(0.5 * GB, (1 + 2 * rng.uniform()) * GB,
                         0.4 * GB, rel_sigma=0.15) for _ in range(6)]
    pool, win_idx = [], []
    for i in range(60):
        k = int(rng.integers(0, 3))
        t0 = rng.uniform(0, 50)
        pool.append(_mk_variant(f"J{i % 6}", f"s{k}", t0, rng.uniform(2, 40),
                                fmps[i % 6], h=float(rng.uniform(0.2, 0.9)),
                                vid=f"v{i}"))
        win_idx.append(k)
    got = {impl: score_round(pool, windows, win_idx, ScoringPolicy(),
                             impl=impl, recheck_theta=0.05)
           for impl in ("numpy", "torch", "cuda")}
    np.testing.assert_allclose(got["numpy"], got["torch"], atol=3e-5)
    np.testing.assert_allclose(got["torch"], got["cuda"], atol=3e-5)


# ---------------------------------------------------------------------------
# FMP grid cache: per-scheduler scope + bound
# ---------------------------------------------------------------------------

def test_grid_cache_bounded_and_scoped():
    cache = FMPGridCache(maxsize=4)
    fmps = [fmp_standard(1 * GB, (1 + i) * GB, 0.1 * GB) for i in range(6)]
    for f in fmps:
        cache.grid(f, 32)
    assert len(cache) == 4  # LRU-bounded
    assert cache.misses == 6
    mu, sg, mean = cache.grid(fmps[-1], 32)
    assert cache.hits == 1
    np.testing.assert_allclose(mean, float(np.mean(fmps[-1].grid(32)[0])))
    # schedulers own independent caches (no process-global state)
    s1 = JasdaScheduler([SliceSpec("s0", 8 * GB)])
    s2 = JasdaScheduler([SliceSpec("s0", 8 * GB)])
    assert s1._grid_cache is not s2._grid_cache
    assert s1._grid_cache.maxsize == SchedulerConfig().grid_cache_size


# ---------------------------------------------------------------------------
# pipelining equivalence
# ---------------------------------------------------------------------------

def _mk_sched(n_jobs=18, score_impl="torch", **cfg_kw):
    sched = JasdaScheduler(
        [SliceSpec("s20", 20 * GB, n_chips=4),
         SliceSpec("s10", 10 * GB, n_chips=2),
         SliceSpec("s5", 5 * GB)],
        SchedulerConfig(score_impl=score_impl, **cfg_kw))
    for a in make_workload(n_jobs, seed=3, arrival_rate=2.0):
        sched.add_job(a, 0.0)
    return sched


def _round_sig(results):
    return [None if r is None else tuple(v.variant_id for v in r.selected)
            for r in results]


def test_run_rounds_pipelined_byte_identical_to_serial():
    times = [float(t) for t in range(30)]
    serial, piped = _mk_sched(), _mk_sched()
    rs = [serial.run_round(t) for t in times]
    rp = piped.run_rounds_pipelined(times)
    assert _round_sig(rs) == _round_sig(rp)
    assert ([(r.variant_id, r.status, r.score) for r in serial.commit_log]
            == [(r.variant_id, r.status, r.score) for r in piped.commit_log])
    assert ([(l.t, l.n_bidders, l.n_bids, l.n_selected, l.n_windows)
             for l in serial.log]
            == [(l.t, l.n_bidders, l.n_bids, l.n_selected, l.n_windows)
                for l in piped.log])
    assert ({j: (a.n_bids, a.n_wins) for j, a in serial.agents.items()}
            == {j: (a.n_bids, a.n_wins) for j, a in piped.agents.items()})


def test_simulate_pipelined_equals_serial():
    def run(pipeline):
        sched = JasdaScheduler(
            [SliceSpec("s20", 20 * GB, n_chips=4),
             SliceSpec("s10", 10 * GB, n_chips=2)],
            SchedulerConfig(score_impl="torch"))
        agents = make_workload(20, seed=7, arrival_rate=0.5)
        res = simulate(sched, agents,
                       SimConfig(t_end=1500.0, seed=4, pipeline=pipeline))
        return res, sched

    r1, s1 = run(False)
    r2, s2 = run(True)
    assert r1.jct_per_job == r2.jct_per_job
    assert r1.n_committed == r2.n_committed
    assert r1.total_score == pytest.approx(r2.total_score, abs=1e-9)
    assert r1.utilization == r2.utilization and r1.makespan == r2.makespan
    assert ({j: (a.n_bids, a.n_wins) for j, a in s1.agents.items()}
            == {j: (a.n_bids, a.n_wins) for j, a in s2.agents.items()})


def test_simulate_pipelined_equals_serial_under_failures():
    def run(pipeline):
        sched = JasdaScheduler(
            [SliceSpec("s20", 20 * GB, n_chips=4),
             SliceSpec("s10", 10 * GB, n_chips=2)],
            SchedulerConfig(score_impl="torch"))
        agents = make_workload(14, seed=9, arrival_rate=0.4)
        return simulate(sched, agents,
                        SimConfig(t_end=2500.0, seed=5, failure_rate=0.004,
                                  repair_time=40.0, pipeline=pipeline))

    r1, r2 = run(False), run(True)
    assert r1.jct_per_job == r2.jct_per_job
    assert r1.n_committed == r2.n_committed


def test_pipeline_filter_path_matches_fresh_preparation():
    # the settling round killed one speculatively-announced window (dead
    # window, epoch unchanged): validation must FILTER the speculation to
    # exactly what a fresh serial preparation would produce
    def mk():
        return _mk_sched(n_jobs=10)

    spec_s, fresh_s = mk(), mk()
    pipe = RoundPipeline(spec_s)
    spec = spec_s._prepare_round(2.0, speculative=True)
    assert len(spec.windows) >= 2
    dead = spec.windows[0]
    for s in (spec_s, fresh_s):
        s._dead_windows.add(dead.slice_id, dead.t_min, expiry=100.0)
    pipe._spec = spec
    prep = pipe._take_validated(2.0)
    assert prep is not None and pipe.stats["spec_filtered"] == 1
    fresh = fresh_s._prepare_round(2.0)
    assert [(w.slice_id, w.t_min) for w in prep.windows] == \
        [(w.slice_id, w.t_min) for w in fresh.windows]
    assert [v.variant_id for v in prep.pool] == \
        [v.variant_id for v in fresh.pool]
    assert ({j: a.n_bids for j, a in spec_s.agents.items()}
            == {j: a.n_bids for j, a in fresh_s.agents.items()})


def test_pipeline_discard_restores_bid_stats():
    sched = _mk_sched(n_jobs=10)
    before = {j: a.n_bids for j, a in sched.agents.items()}
    pipe = RoundPipeline(sched)
    spec = sched._prepare_round(2.0, speculative=True)
    assert any(a.n_bids != before[j] for j, a in sched.agents.items())
    pipe._spec = spec
    sched._epoch += 1  # any state mutation invalidates the speculation
    assert pipe._take_validated(2.0) is None
    assert {j: a.n_bids for j, a in sched.agents.items()} == before
    assert pipe.stats["spec_discarded"] == 1


def test_pipelined_clear_rounds_identical_selections():
    rng = np.random.default_rng(2)
    windows = [Window(f"s{k}", (6 + 2 * k) * GB, 0.0, 100.0) for k in range(4)]
    fmps = [fmp_standard(0.5 * GB, 1.5 * GB, 0.1 * GB) for _ in range(8)]
    rounds = []
    for _ in range(5):
        pool = []
        for i in range(50):
            k = int(rng.integers(0, 4))
            t0 = rng.uniform(0, 60)
            pool.append(_mk_variant(f"J{i % 8}", f"s{k}", t0,
                                    rng.uniform(2, 30), fmps[i % 8],
                                    h=float(rng.uniform(0.1, 0.9)),
                                    vid=f"v{i}"))
        rounds.append((windows, pool))
    policy = ScoringPolicy()
    serial = [clear_round(w, p, policy, score_impl="torch") for w, p in rounds]
    piped = pipelined_clear_rounds(rounds, policy, score_impl="torch")
    assert ([_round_sig([r])[0] for r in serial]
            == [_round_sig([r])[0] for r in piped])


# ---------------------------------------------------------------------------
# bounded bookkeeping: commitment pruning + log caps
# ---------------------------------------------------------------------------

def test_commitments_pruned_on_complete_and_fail():
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)])
    agents = make_workload(10, seed=11, arrival_rate=2.0)
    res = simulate(sched, agents, SimConfig(t_end=2000.0, seed=6))
    assert res.n_finished == 10
    # outstanding set drains as work completes; totals survive in counters
    assert len(sched.commitments) < sched.n_committed_total
    assert res.n_committed == sched.n_committed_total
    assert res.total_score == pytest.approx(sched.committed_score_total)
    statuses = {r.status for r in sched.commit_log}
    assert "completed" in statuses
    assert len(sched.commit_log) == sched.n_committed_total
    assert len(sched._commit_index) == len(sched.commitments)


def test_commit_log_records_failures_and_losses():
    sched = JasdaScheduler([SliceSpec("s0", 10 * GB, n_chips=2),
                            SliceSpec("s1", 10 * GB, n_chips=2)])
    agents = make_workload(8, seed=13, arrival_rate=1.0)
    simulate(sched, agents,
             SimConfig(t_end=2500.0, seed=3, failure_rate=0.01,
                       repair_time=30.0))
    statuses = {r.status for r in sched.commit_log}
    assert statuses & {"failed", "lost"}, "failure injection must be audited"
    # pruned commitments never linger in the outstanding set
    active_ids = {c.variant.variant_id for c in sched.commitments}
    for r in sched.commit_log:
        if r.status in ("failed", "lost", "completed"):
            assert r.variant_id not in active_ids or r.status == "completed"


def test_max_log_rows_caps_audit_trails():
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)],
                           SchedulerConfig(max_log_rows=25))
    agents = make_workload(12, seed=4, arrival_rate=2.0)
    simulate(sched, agents, SimConfig(t_end=3000.0, seed=2))
    assert len(sched.log) <= 25
    assert len(sched.commit_log) <= 25
    # totals keep counting past the cap
    assert sched.n_committed_total >= len(sched.commit_log)


def test_uncapped_log_by_default():
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)])
    agents = make_workload(6, seed=5, arrival_rate=2.0)
    simulate(sched, agents, SimConfig(t_end=800.0, seed=2))
    assert len(sched.log) > 25  # one row per tick, unbounded by default


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,t", [(64, 16), (300, 32), (1000, 33)])
def test_score_variants_match_reference(m, t):
    """The port's plain version and its CUDA wrapper (the plain version on
    host tensors) against the reference's jnp path and host numpy:
    scores within 3e-5, eligibility equal; numpy paths equal."""
    from repro.kernels.jasda_score import ops as ref_ops

    rng = np.random.default_rng(m + t)
    args = _score_args(m, t, seed=m + t)
    caps = rng.choice([12.0, 16.0, 20.0], m)
    ths = rng.choice([0.02, 0.05, 0.2], m)
    ref_s, ref_e, _ = ref_ops.score_variants(
        **args, lam=0.6, capacity=caps, theta=ths, impl="ref")
    for impl in ("torch", "cuda"):
        s, e, _ = score_variants(**args, lam=0.6, capacity=caps, theta=ths,
                                 impl=impl)
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=3e-5)
        np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e))
    host = score_variants_numpy(**args, lam=0.6, capacity=caps, theta=ths)
    ref_host = ref_ops.score_variants_numpy(**args, lam=0.6, capacity=caps,
                                            theta=ths)
    for a, b in zip(host, ref_host):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pipeline", [False, True])
def test_simulate_matches_reference(pipeline):
    """``_mk_sched``'s scheduler through both packages, the port on its
    torch backends: the same commit log, scores within 3e-5."""
    import repro.core as ref_core
    from repro.core.scheduler import SchedulerConfig as RefConfig

    def run(core, sched_cls, cfg):
        sched = sched_cls([core.SliceSpec("s0", 16 * GB, n_chips=2),
                           core.SliceSpec("s1", 10 * GB, n_chips=2)], cfg)
        core.simulate(sched, core.make_workload(18, seed=4, arrival_rate=0.6),
                      core.SimConfig(t_end=500.0, seed=3, pipeline=pipeline))
        return ([(c.variant_id, c.slice_id, c.t_start) for c in sched.commit_log],
                np.array([c.score for c in sched.commit_log]))

    port = run(_port_core, JasdaScheduler,
               SchedulerConfig(score_impl="torch", wis_impl="torch"))
    ref = run(ref_core, ref_core.JasdaScheduler,
              RefConfig(score_impl="ref", wis_impl="ref"))
    assert port[0] == ref[0] and len(port[0]) > 5
    np.testing.assert_allclose(port[1], ref[1], atol=3e-5, rtol=0)
