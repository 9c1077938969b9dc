"""The port's mirror of ``tests/test_negotiation.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

Bid-side negotiation API: typed round protocol, BiddingStrategy backends,
and the clearing→agent feedback channel.

The GreedyChunking byte-identity property is pinned against a FROZEN copy
of the pre-negotiation ``JobAgent.generate_variants`` chunk chain kept in
this file: the production code moved into ``repro.core.negotiation``, so
only a literal reference copy can detect a semantic drift of the default
strategy.  Property tests run under hypothesis when available and fall
back to seeded random cases otherwise (hypothesis is not in the baked-in
environment).
"""
import numpy as np
import pytest

from repro_torch.core import (AgentConfig, JobAgent, JobSpec, Policy,
                              SimConfig, SliceSpec, simulate)
from repro_torch.core.atomizer import chunk_candidates
from repro_torch.core.calibration import CalibrationConfig, Calibrator
from repro_torch.core.negotiation import (AdaptiveBidder, Award, BidBundle,
                                          BiddingStrategy, ConservativeSafety,
                                          GreedyChunking, LossReport,
                                          RoundFeedback, WindowAnnouncement,
                                          build_feedback)
from repro_torch.core.negotiation.messages import (LOSS_OUTSCORED,
                                                   LOSS_SELF_CONFLICT,
                                                   LOSS_WINDOW_EMPTY)
from repro_torch.core.trp import fmp_standard, prob_exceed_grid
from repro_torch.core.types import Variant, Window
from repro_torch.core.windows import WindowPolicy

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAS_HYPOTHESIS = False


# -- the port on the host: its "torch" / "cuda" backends run on the CPU only
# when asked, so every scheduler and round entry point gets device="cpu"
import dataclasses as _dc  # noqa: E402

import repro_torch.core as _port_core  # noqa: E402
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


GB = 1 << 30


# ---------------------------------------------------------------------------
# frozen pre-negotiation reference: the JobAgent generation as shipped before
# the strategy API (verbatim semantics; do NOT refactor alongside production)
# ---------------------------------------------------------------------------

def _ref_features(agent, work, duration, t_start, now):
    from repro_torch.core.scoring import JobFeatures

    finish = t_start + duration
    wait = max(0.0, t_start - now)
    phi_jct = float(np.clip(duration / max(duration + wait, 1e-9), 0.0, 1.0))
    if agent.spec.qos_deadline is None:
        phi_qos = 1.0
    else:
        rem_after = agent.work_remaining - work
        est_completion = finish + rem_after
        phi_qos = JobFeatures.qos(est_completion <= agent.spec.qos_deadline)
    phi_prog = JobFeatures.progress(work, agent.work_remaining)
    return {"jct": phi_jct, "qos": phi_qos, "progress": phi_prog}


def _ref_make_variant(agent, window, t_start, plan, now, seq):
    feats = _ref_features(agent, plan.work, plan.duration, t_start, now)
    declared = {
        k: float(np.clip(v * agent.cfg.misreport, 0.0, 1.0))
        for k, v in feats.items()
    }
    h = sum(agent.cfg.alphas.get(k, 0.0) * v for k, v in declared.items())
    vid = (f"{agent.spec.job_id}/{window.slice_id}"
           f"@{window.t_min:.9g}#{seq}")
    return Variant(
        job_id=agent.spec.job_id,
        slice_id=window.slice_id,
        t_start=t_start,
        duration=plan.duration,
        fmp=agent.spec.fmp,
        local_utility=float(np.clip(h, 0.0, 1.0)),
        declared_features=declared,
        payload={
            "work": plan.work,
            "activation": agent.atomizer.activation_cost,
            "true_features": feats,
        },
        variant_id=vid,
        theta=agent.cfg.theta,
    )


def _ref_generate_variants(agent, window, now, n_chips=1):
    from repro_torch.core.trp import is_safe

    if agent.finished or agent.biddable_work <= 1e-9:
        return []
    thr = agent.throughput_on(window.capacity, n_chips)
    if thr <= 0:
        return []
    if not is_safe(agent.spec.fmp, window.capacity, agent.cfg.theta,
                   method=agent.cfg.safety_method):
        return []

    variants = []
    remaining = agent.biddable_work
    t_cursor = window.t_min
    max_v = agent.atomizer.max_variants_per_window
    while remaining > 1e-9 and t_cursor < window.t_end - 1e-9 and len(variants) < max_v:
        span = window.t_end - t_cursor
        plans = chunk_candidates(remaining, thr, span, agent.atomizer)
        if not plans:
            break
        for plan in plans:
            if len(variants) >= max_v:
                break
            if t_cursor + plan.duration > window.t_end + 1e-9:
                continue
            if agent._overlaps_own(t_cursor, plan.duration):
                continue
            variants.append(
                _ref_make_variant(agent, window, t_cursor, plan, now, len(variants))
            )
        largest = plans[0]
        remaining -= largest.work
        t_cursor += largest.duration
    if variants:
        agent.n_bids += 1
    return variants


def _ref_generate_by_window(agent, windows, now, n_chips=None):
    if agent.finished or agent.biddable_work <= 1e-9:
        return [[] for _ in windows]
    out = []
    for w in windows:
        chips = n_chips.get(w.slice_id, 1) if n_chips else 1
        out.append(_ref_generate_variants(agent, w, now, chips))
    return out


# ---------------------------------------------------------------------------
# random agent/window construction shared by the property tests
# ---------------------------------------------------------------------------

def _random_case(seed):
    rng = np.random.default_rng(seed)
    steady = float(rng.uniform(1.0, 8.0)) * GB
    fmp = fmp_standard(0.4 * steady, steady, 0.1 * steady, rel_sigma=0.03)
    deadline = float(rng.uniform(50, 400)) if rng.uniform() < 0.5 else None
    spec = JobSpec(
        job_id=f"J{seed % 97}",
        arrival_time=0.0,
        total_work=float(rng.uniform(5.0, 120.0)),
        fmp=fmp,
        qos_deadline=deadline,
        min_capacity=float(rng.choice([0.0, 2.0 * GB])),
    )
    cfg = AgentConfig(
        theta=float(rng.choice([0.02, 0.05, 0.3])),
        misreport=float(rng.choice([1.0, 1.0, 1.4])),
    )

    def build():
        a = JobAgent(spec, cfg)
        a.work_done = spec.total_work * float(rng.uniform(0.0, 0.6))
        # a couple of outstanding commitments (own-overlap checks must fire)
        for _ in range(int(rng.integers(0, 3))):
            s = float(rng.uniform(0, 150))
            a.committed_intervals.append((s, s + float(rng.uniform(3, 20))))
            a.outstanding_work += float(rng.uniform(1.0, 5.0))
        a.outstanding_work = min(a.outstanding_work, a.work_remaining)
        return a

    # identical twin agents: production vs frozen reference
    rng = np.random.default_rng(seed)  # re-seed so both builds see same draws
    prod = build()
    rng = np.random.default_rng(seed)
    ref = build()

    wrng = np.random.default_rng(seed + 1)
    windows = []
    for k in range(int(wrng.integers(1, 5))):
        t0 = float(wrng.uniform(0, 120))
        windows.append(Window(
            slice_id=f"s{k}",
            capacity=float(wrng.uniform(1.0, 12.0)) * GB,
            t_min=t0,
            duration=float(wrng.uniform(3.0, 80.0)),
        ))
    chips = {w.slice_id: int(wrng.integers(1, 4)) for w in windows}
    now = float(wrng.uniform(0, 60))
    return prod, ref, windows, chips, now


def _variant_sig(v: Variant):
    return (
        v.variant_id, v.job_id, v.slice_id, v.t_start, v.duration,
        v.local_utility, v.theta,
        tuple(sorted(v.declared_features.items())),
        v.payload["work"], v.payload["activation"],
        tuple(sorted(v.payload["true_features"].items())),
    )


def _check_greedy_matches_legacy(seed):
    prod, ref, windows, chips, now = _random_case(seed)
    got = prod.generate_variants_by_window(windows, now, chips)
    want = _ref_generate_by_window(ref, windows, now, chips)
    assert [[_variant_sig(v) for v in g] for g in got] == \
        [[_variant_sig(v) for v in g] for g in want], \
        "GreedyChunking drifted from the legacy generation"
    assert prod.n_bids == ref.n_bids
    # the flat wrapper is exactly the grouped form flattened
    prod2, ref2 = _random_case(seed)[:2]
    flat = prod2.generate_variants_round(windows, now, chips)
    assert [_variant_sig(v) for v in flat] == \
        [_variant_sig(v) for g in want for v in g]
    # and the single-window wrapper is the one-window round
    if windows:
        w = windows[0]
        single = ref2.generate_variants(w, now, chips[w.slice_id])
        assert [_variant_sig(v) for v in single] == \
            [_variant_sig(v) for v in want[0]]


@pytest.mark.parametrize("seed", range(10))
def test_greedy_chunking_byte_identical_to_legacy(seed):
    _check_greedy_matches_legacy(seed)


if HAS_HYPOTHESIS:

    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def test_greedy_chunking_identity_property(seed):
        _check_greedy_matches_legacy(seed)


def test_greedy_identity_holds_serial_and_pipelined():
    """End-to-end: a GreedyChunking population schedules byte-identically
    through the strategy path, serial and pipelined (feedback channel on)."""

    def run(pipeline):
        sched = JasdaScheduler(
            [SliceSpec("s0", 20 * GB, n_chips=4),
             SliceSpec("s1", 10 * GB, n_chips=2)], Policy())
        from repro_torch.core import make_workload

        simulate(sched, make_workload(10, seed=11, arrival_rate=0.8),
                 SimConfig(t_end=400.0, seed=4, pipeline=pipeline))
        return [(c.variant_id, c.t_start, c.score) for c in sched.commit_log]

    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# typed round protocol
# ---------------------------------------------------------------------------

def _agent(job_id="J0", work=50.0, theta=0.05, strategy=None, misreport=1.0,
           mem_gb=2.0):
    spec = JobSpec(job_id=job_id, arrival_time=0.0, total_work=work,
                   fmp=fmp_standard(0.5 * GB, mem_gb * GB, 0.1 * GB))
    return JobAgent(spec, AgentConfig(theta=theta, strategy=strategy,
                                      misreport=misreport))


def test_respond_returns_aligned_bundle():
    agent = _agent()
    windows = (Window("s0", 8 * GB, 0.0, 30.0), Window("s1", 8 * GB, 5.0, 20.0))
    ann = WindowAnnouncement(now=0.0, windows=windows, chips={"s0": 2})
    bundle = agent.respond(ann)
    assert isinstance(bundle, BidBundle)
    assert bundle.job_id == "J0"
    assert len(bundle.by_window) == len(windows)
    assert all(v.slice_id == w.slice_id
               for w, g in zip(windows, bundle.by_window) for v in g)
    assert bundle.variants == tuple(v for g in bundle.by_window for v in g)
    assert len(bundle) == len(bundle.variants) > 0
    assert ann.chips_for("s0") == 2 and ann.chips_for("s1") == 1


def test_finished_agent_answers_empty_bundle_without_strategy_call():
    class Exploding(BiddingStrategy):
        name = "exploding"

        def bid(self, agent, state, announcement):  # pragma: no cover
            raise AssertionError("strategy must not be consulted")

    agent = _agent(strategy=Exploding())
    agent.record_progress(agent.spec.total_work)
    ann = WindowAnnouncement(0.0, (Window("s0", 8 * GB, 0.0, 30.0),))
    bundle = agent.respond(ann)
    assert bundle.by_window == ((),)


def test_custom_strategy_plugs_into_scheduler():
    class HeadOnly(BiddingStrategy):
        """Bids only the FIRST announced window (degenerate targeting)."""

        name = "head_only"

        def bid(self, agent, state, announcement):
            from repro_torch.core.negotiation import chunk_chain_bids

            out = [[] for _ in announcement.windows]
            if announcement.windows:
                w = announcement.windows[0]
                out[0] = chunk_chain_bids(
                    agent, w, announcement.now,
                    announcement.chips_for(w.slice_id))
            return out

    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4),
                            SliceSpec("s1", 10 * GB, n_chips=2)], Policy())
    agent = _agent(strategy=HeadOnly())
    sched.add_job(agent, 0.0)
    rr = sched.run_round(1.0)
    assert rr is not None and rr.selected
    assert agent.strategy.name == "head_only"
    assert all(v.slice_id == rr.windows[0].slice_id for v in rr.selected)


# ---------------------------------------------------------------------------
# the clearing→agent feedback channel
# ---------------------------------------------------------------------------

def test_round_feedback_contents():
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)], Policy())
    agents = [_agent(f"J{i}", work=30.0) for i in range(3)]
    for a in agents:
        sched.add_job(a, 0.0)
    rr = sched.run_round(1.0)
    fb = sched.last_feedback
    assert isinstance(fb, RoundFeedback)
    assert fb.t == 1.0
    assert fb.windows == tuple(rr.windows)
    assert fb.n_selected == len(rr.selected)
    # cutoffs: one per window, equal to the minimum winning score
    for k, w in enumerate(rr.windows):
        want = min(rr.results[k].scores) if rr.results[k].scores else 0.0
        assert fb.cutoff_for(w) == pytest.approx(want)
    # every selected variant appears as an award with its commit score
    awarded = {a.variant_id: a.score for aws in fb.awards.values() for a in aws}
    assert awarded == {
        v.variant_id: pytest.approx(s)
        for v, s in zip(rr.selected, rr.scores)
    }
    # calibration state is published for every agent in the round
    for a in agents:
        assert fb.reliability[a.spec.job_id] == 1.0
        assert fb.calibration_bias[a.spec.job_id] == 0.0


def test_feedback_loss_reasons():
    # one window, two jobs with overlapping bids: winner's alternatives are
    # self_conflict, the outbid rival is outscored
    w = Window("s0", 8 * GB, 0.0, 10.0)

    def mk(job, h, vid):
        return Variant(job_id=job, slice_id="s0", t_start=0.0, duration=8.0,
                       fmp=fmp_standard(0.5 * GB, 1 * GB, 0.1 * GB),
                       local_utility=h, declared_features={},
                       payload={"work": 8.0}, variant_id=vid)

    win, alt, rival = mk("JW", 0.9, "win"), mk("JW", 0.5, "alt"), mk("JL", 0.7, "rival")

    class A:
        def __init__(self, jid):
            self.spec = type("S", (), {"job_id": jid})()

    from repro_torch.core.types import ClearingResult, RoundResult

    rr = RoundResult(
        windows=(w,),
        results=(ClearingResult(window=w, selected=(win,), scores=(0.9,),
                                total_score=0.9, n_bids=3,
                                rejected=(alt, rival)),),
        selected=(win,), scores=(0.9,), total_score=0.9, n_bids=3)
    fb = build_feedback(0.0, [w], [A("JW"), A("JL")],
                        [[[win, alt]], [[rival]]], rr)
    assert fb.awards["JW"] == (Award("win", w, 0.9),)
    assert fb.losses["JW"] == (LossReport("alt", w, LOSS_SELF_CONFLICT, 0.9),)
    assert fb.losses["JL"] == (LossReport("rival", w, LOSS_OUTSCORED, 0.9),)

    # a window clearing empty reports window_empty at cutoff 0
    rr_empty = RoundResult(
        windows=(w,),
        results=(ClearingResult(window=w, selected=(), scores=(),
                                total_score=0.0, n_bids=1, rejected=(rival,)),),
        selected=(), scores=(), total_score=0.0, n_bids=1)
    fb2 = build_feedback(0.0, [w], [A("JL")], [[[rival]]], rr_empty)
    assert fb2.losses["JL"] == (LossReport("rival", w, LOSS_WINDOW_EMPTY, 0.0),)


def test_adaptation_bumps_epoch_stateless_does_not():
    def one_round(strategy):
        sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)], Policy())
        for i in range(3):
            sched.add_job(_agent(f"J{i}", strategy=strategy), 0.0)
        before = sched._epoch
        rr = sched.run_round(1.0)
        assert rr is not None and rr.selected
        return sched._epoch - before

    # stateless greedy: exactly the commit bump (pre-negotiation behavior)
    assert one_round(None) == 1
    # adaptive agents observe their own alternatives losing + cutoffs: the
    # feedback adaptation adds its own invalidation (same single bump —
    # selected and adapted share one epoch increment)
    sched = JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)], Policy())
    agents = [_agent(f"J{i}", strategy=AdaptiveBidder()) for i in range(3)]
    for a in agents:
        sched.add_job(a, 0.0)
    rr = sched.run_round(1.0)
    assert rr is not None
    # at least one adaptive agent learned a cutoff from the feedback
    assert any(a.strategy_state["cutoff"] for a in agents)


def test_mixed_strategy_pipelined_byte_identical_to_serial():
    """The acceptance property for the feedback channel: speculative rounds
    stay provably serial-equivalent even when strategies adapt from
    feedback (epoch invalidation), across all three shipped backends."""

    def run(pipeline):
        rng = np.random.default_rng(5)
        policy = Policy(window=WindowPolicy(horizon=40.0))
        sched = JasdaScheduler(
            [SliceSpec("s0", 8 * GB, n_chips=1),
             SliceSpec("s1", 6 * GB, n_chips=1)], policy)
        agents = []
        for i in range(4):
            mem = (1.5 + 2.0 * rng.uniform()) * GB
            fmp = fmp_standard(0.5 * GB, mem, 0.1 * GB, rel_sigma=0.03)
            for tag, strat in (("A", AdaptiveBidder()),
                               ("G", GreedyChunking()),
                               ("C", ConservativeSafety())):
                spec = JobSpec(job_id=f"J{tag}{i}", arrival_time=0.0,
                               total_work=30.0, fmp=fmp)
                agents.append(JobAgent(spec, AgentConfig(
                    misreport=1.4, strategy=strat)))
        simulate(sched, agents, SimConfig(t_end=200.0, seed=2,
                                          pipeline=pipeline))
        return [(c.variant_id, c.t_start, round(c.score, 12), c.status)
                for c in sched.commit_log]

    assert run(True) == run(False)


# ---------------------------------------------------------------------------
# AdaptiveBidder
# ---------------------------------------------------------------------------

def test_adaptive_equals_greedy_when_uncontended():
    # a lone bidder never sees an outscored loss: awards plus self-conflict
    # alternative losses leave the chunk scale at 1.0 (after the recovery
    # clamp) and its bids stay byte-identical to GreedyChunking's
    ga, aa = _agent("J0"), _agent("J0", strategy=AdaptiveBidder())
    w = Window("s0", 8 * GB, 0.0, 30.0)
    sweep = RoundFeedback(
        t=0.0, windows=(w,), cutoffs={w.key: 0.6},
        awards={"J0": (Award("win", w, 0.8),)},
        losses={"J0": (LossReport("alt", w, LOSS_SELF_CONFLICT, 0.6),)},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    for _ in range(3):
        aa.observe_feedback(sweep)
    assert aa.strategy_state["scale"] == 1.0
    assert aa.strategy_state["shade"] == 1.0
    got = aa.generate_variants(w, 0.0)
    want = ga.generate_variants(w, 0.0)
    assert [_variant_sig(v) for v in got] == [_variant_sig(v) for v in want]


def test_adaptive_shrinks_chunks_under_contention_and_recovers():
    agent = _agent("J0", strategy=AdaptiveBidder())
    strat, state = agent.strategy, agent.strategy_state
    w = Window("s0", 8 * GB, 0.0, 30.0)
    outscored = RoundFeedback(
        t=0.0, windows=(w,), cutoffs={w.key: 0.9},
        awards={}, losses={"J0": (LossReport("x", w, LOSS_OUTSCORED, 0.9),)},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    assert agent.observe_feedback(outscored)
    assert state["scale"] == pytest.approx(strat.shrink)
    agent.observe_feedback(outscored)
    assert state["scale"] == pytest.approx(strat.shrink ** 2)
    # shrunk bids: deeper chains of smaller chunks, no head alternatives
    small = agent.generate_variants(w, 0.0)
    starts = [v.t_start for v in small]
    assert len(set(starts)) == len(starts), "no overlapping head alternatives"
    assert len(starts) >= 2, "chunk-scale shrink must buy chain depth"
    # a clean sweep grows the scale back
    sweep = RoundFeedback(
        t=1.0, windows=(w,), cutoffs={w.key: 0.5},
        awards={"J0": (Award("y", w, 0.8),)}, losses={},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    before = state["scale"]
    assert agent.observe_feedback(sweep)
    assert state["scale"] == pytest.approx(min(1.0, before * strat.grow))


def test_adaptive_window_targeting_skips_hopeless_slices():
    strat = AdaptiveBidder(skip_after=2)
    agent = _agent("J0", strategy=strat)
    state = agent.strategy_state
    whot = Window("hot", 8 * GB, 0.0, 30.0)
    wok = Window("ok", 8 * GB, 0.0, 30.0)
    fb = RoundFeedback(
        t=0.0, windows=(whot,), cutoffs={whot.key: 0.95},
        awards={}, losses={"J0": (LossReport("x", whot, LOSS_OUTSCORED, 0.95),)},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    win_ok = RoundFeedback(
        t=0.0, windows=(wok,), cutoffs={wok.key: 0.4},
        awards={"J0": (Award("w", wok, 0.4),)}, losses={},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    agent.observe_feedback(win_ok)  # establish the agent's own score level
    agent.observe_feedback(fb)
    agent.observe_feedback(fb)
    assert state["streak"]["hot"] == 2
    groups = agent.generate_variants_by_window([whot, wok], 0.0)
    assert groups[0] == [], "hopeless slice must be skipped"
    assert groups[1], "winnable slice must still be bid"


def test_adaptive_shading_follows_calibration_bias():
    agent = _agent("J0", misreport=1.6, strategy=AdaptiveBidder())
    state = agent.strategy_state
    w = Window("s0", 8 * GB, 50.0, 30.0)
    over = RoundFeedback(
        t=0.0, windows=(w,), cutoffs={}, awards={}, losses={},
        reliability={"J0": 0.6}, calibration_error={"J0": 0.2},
        calibration_bias={"J0": 0.2})
    assert agent.observe_feedback(over)
    assert state["shade"] < 1.0
    shade1 = state["shade"]
    # shaded declarations sit strictly below the unshaded ones
    greedy_twin = _agent("J0", misreport=1.6)
    shaded = agent.generate_variants(w, 0.0)
    plain = greedy_twin.generate_variants(w, 0.0)
    assert shaded and plain
    assert shaded[0].local_utility < plain[0].local_utility
    # under-declaration (negative bias) relaxes the shade back toward 1
    under = RoundFeedback(
        t=1.0, windows=(w,), cutoffs={}, awards={}, losses={},
        reliability={"J0": 0.9}, calibration_error={"J0": 0.05},
        calibration_bias={"J0": -0.2})
    agent.observe_feedback(under)
    assert 1.0 >= state["shade"] > shade1
    # honest agents (|bias| inside the deadband) never shade
    honest = _agent("J1", strategy=AdaptiveBidder())
    neutral = RoundFeedback(
        t=0.0, windows=(w,), cutoffs={}, awards={}, losses={},
        reliability={"J1": 1.0}, calibration_error={"J1": 0.01},
        calibration_bias={"J1": 0.01})
    honest.observe_feedback(neutral)
    assert honest.strategy_state["shade"] == 1.0


def test_adaptive_outbids_greedy_on_contended_cluster():
    """The tentpole's market claim: paired identical jobs, half adaptive and
    half greedy, on a scarce 2-slice cluster — the adaptive half strictly
    clears more total score (the adaptive_bidding benchmark gates this)."""
    rng = np.random.default_rng(5)
    policy = Policy(window=WindowPolicy(horizon=40.0))
    sched = JasdaScheduler([SliceSpec("s0", 8 * GB, n_chips=1),
                            SliceSpec("s1", 6 * GB, n_chips=1)], policy)
    agents = []
    for i in range(5):
        mem = (1.5 + 2.0 * rng.uniform()) * GB
        fmp = fmp_standard(0.5 * GB, mem, 0.1 * GB, rel_sigma=0.03)
        for tag, strat in (("A", AdaptiveBidder()), ("G", GreedyChunking())):
            spec = JobSpec(job_id=f"J{tag}{i}", arrival_time=0.0,
                           total_work=40.0, fmp=fmp)
            agents.append(JobAgent(spec, AgentConfig(strategy=strat)))
    res = simulate(sched, agents, SimConfig(t_end=300.0, seed=2))
    stats = res.strategy_stats
    assert stats["adaptive"]["score_won"] > stats["greedy_chunking"]["score_won"]
    win_rate = lambda r: r["n_wins"] / max(r["n_bids"], 1)
    assert win_rate(stats["adaptive"]) > win_rate(stats["greedy_chunking"])
    assert res.iterations >= 20


# ---------------------------------------------------------------------------
# ConservativeSafety
# ---------------------------------------------------------------------------

def test_conservative_safety_tightens_theta_with_reliability():
    cap = 3.1 * GB
    fmp = fmp_standard(1 * GB, 3 * GB, 0.05 * GB, rel_sigma=0.01)
    mu, sigma = fmp.grid(32)
    p = prob_exceed_grid(mu, sigma, cap)
    assert 1e-6 < p < 0.5, f"test FMP mis-calibrated: p_exceed={p}"
    theta = min(1.0, p * 2)  # safe at full trust, unsafe once ρ < ~0.5
    spec = JobSpec(job_id="J0", arrival_time=0.0, total_work=50.0, fmp=fmp)
    agent = JobAgent(spec, AgentConfig(theta=theta,
                                       strategy=ConservativeSafety()))
    w = Window("s0", cap, 0.0, 30.0)

    # full trust: byte-identical to greedy (θ_eff == θ), and bids carry θ
    bids = agent.generate_variants(w, 0.0)
    twin = JobAgent(spec, AgentConfig(theta=theta))
    assert [_variant_sig(v) for v in bids] == \
        [_variant_sig(v) for v in twin.generate_variants(w, 0.0)]
    assert all(v.theta == theta for v in bids)

    # reliability collapse: θ_eff = θ·ρ < p_exceed → the marginal window is
    # refused outright (agent-side probabilistic safety policy)
    low = RoundFeedback(
        t=1.0, windows=(w,), cutoffs={}, awards={}, losses={},
        reliability={"J0": 0.2}, calibration_error={"J0": 0.5},
        calibration_bias={"J0": 0.4})
    assert agent.observe_feedback(low)
    assert agent.generate_variants(w, 1.0) == []
    # an ample window is still bid, at the tightened θ_eff
    roomy = Window("s1", 10 * GB, 0.0, 30.0)
    safe_bids = agent.generate_variants(roomy, 1.0)
    assert safe_bids
    assert all(v.theta == pytest.approx(theta * 0.2) for v in safe_bids)

    # recovery: trust back → bids on the marginal window return
    high = RoundFeedback(
        t=2.0, windows=(w,), cutoffs={}, awards={}, losses={},
        reliability={"J0": 1.0}, calibration_error={"J0": 0.0},
        calibration_bias={"J0": 0.0})
    assert agent.observe_feedback(high)
    assert agent.generate_variants(w, 2.0)
    # unchanged reliability is a no-op (no epoch churn)
    assert not agent.observe_feedback(high)


# ---------------------------------------------------------------------------
# Calibrator snapshot/restore (satellite)
# ---------------------------------------------------------------------------

def _verify_some(cal, rng, jobs=("J0", "J1"), n=6):
    for i in range(n):
        for j in jobs:
            v = Variant(job_id=j, slice_id="s0", t_start=float(i), duration=1.0,
                        fmp=None, local_utility=0.5,
                        declared_features={"jct": 0.9, "progress": 0.7},
                        payload={"work": 1.0}, variant_id=f"{j}/{i}")
            cal.verify(v, {"jct": float(rng.uniform(0.3, 1.0)),
                           "progress": float(rng.uniform(0.3, 1.0))})


def test_calibrator_snapshot_restore_round_trip():
    cfg = CalibrationConfig(error_window=4)
    cal = Calibrator(cfg)
    _verify_some(cal, np.random.default_rng(0))
    snap = cal.snapshot()
    assert snap["J0"]["errors"], "snapshot must carry the error history"

    restored = Calibrator(cfg).restore(snap)
    assert restored.snapshot() == snap
    # restored state calibrates identically...
    v = Variant(job_id="J0", slice_id="s0", t_start=0.0, duration=1.0,
                fmp=None, local_utility=0.5, declared_features={},
                payload={}, variant_id="probe")
    assert restored.calibrate(v, 0.8) == pytest.approx(cal.calibrate(v, 0.8))
    # ...and keeps evolving identically (the windowed E[ε] → ρ update needs
    # the restored error history)
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    _verify_some(cal, rng_a, n=3)
    _verify_some(restored, rng_b, n=3)
    assert restored.snapshot() == cal.snapshot()
    # pre-bias snapshots restore with neutral defaults
    legacy = {"J9": {"rho": 0.7, "hist_avg": 0.6}}
    old = Calibrator(cfg).restore(legacy)
    assert old.rho("J9") == 0.7 and old.state("J9").bias == 0.0


def test_simulator_checkpoint_preserves_calibration():
    from repro_torch.core import make_workload

    def sched():
        return JasdaScheduler([SliceSpec("s0", 20 * GB, n_chips=4)], Policy())

    s1 = sched()
    r1 = simulate(s1, make_workload(6, seed=3, arrival_rate=1.0,
                                    misreport_fraction=0.5),
                  SimConfig(t_end=200.0, seed=1))
    assert r1.calibration and any(
        row["n_verified"] > 0 for row in r1.calibration.values())
    # a fresh run restores the checkpointed trust state and starts from it
    s2 = sched()
    s2.calibrator.restore(r1.calibration)
    assert s2.calibrator.snapshot() == r1.calibration
    for jid, row in r1.calibration.items():
        assert s2.calibrator.rho(jid) == pytest.approx(row["rho"])


def test_calibrator_tracks_signed_bias():
    cal = Calibrator(CalibrationConfig(hist_half_life=1.0))
    over = Variant(job_id="JO", slice_id="s0", t_start=0.0, duration=1.0,
                   fmp=None, local_utility=0.9,
                   declared_features={"jct": 0.9}, payload={}, variant_id="o")
    under = Variant(job_id="JU", slice_id="s0", t_start=0.0, duration=1.0,
                    fmp=None, local_utility=0.2,
                    declared_features={"jct": 0.2}, payload={}, variant_id="u")
    for _ in range(6):
        cal.verify(over, {"jct": 0.5})
        cal.verify(under, {"jct": 0.5})
    assert cal.state("JO").bias > 0.1
    assert cal.state("JU").bias < -0.1
    assert abs(cal.state("JO").bias) <= cal.state("JO").mean_error() + 1e-9


# ---------------------------------------------------------------------------
# against the JAX package: a mixed-strategy population, three presets
# ---------------------------------------------------------------------------


def _probe(core, neg, config_cls, preset, pipeline, **cfg_kw):
    """60 jobs (seed 5) in a Greedy / Adaptive / Conservative population,
    30 % of them misreporting, on 4 slices under ``preset``."""
    cfg = config_cls.from_policy(getattr(core.Policy, preset)(), **cfg_kw)
    sched = core.JasdaScheduler(
        [core.SliceSpec("s20", 20 * GB, n_chips=4),
         core.SliceSpec("s10a", 10 * GB, n_chips=2),
         core.SliceSpec("s10b", 10 * GB, n_chips=2),
         core.SliceSpec("s5", 5 * GB, n_chips=1)], cfg)
    agents = core.make_workload(
        60, seed=5, misreport_fraction=0.3,
        strategies=[neg.GreedyChunking(), neg.AdaptiveBidder(),
                    neg.ConservativeSafety()])
    res = core.simulate(sched, agents,
                        core.SimConfig(t_end=800.0, seed=2, pipeline=pipeline))
    return ([(c.variant_id, c.slice_id, c.t_start) for c in sched.commit_log],
            np.array([c.score for c in sched.commit_log]), res.summary())


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("preset", ["utilization", "fairness", "responsive"])
def test_mixed_population_presets_match_reference(preset, pipeline):
    """The re-anchor probe, pinned: on the host paths the port's commit
    log, scores and summary equal the reference's exactly; on its torch and
    cuda backends (float32, the plain versions on the host) the commit log
    and summary are equal and the scores within 6e-8."""
    import repro.core as ref_core
    import repro.core.negotiation as ref_neg
    from repro.core.scheduler import SchedulerConfig as RefConfig
    import repro_torch.core.negotiation as port_neg

    ref = _probe(ref_core, ref_neg, RefConfig, preset, pipeline)
    assert len(ref[0]) > 50
    host = _probe(_port_core, port_neg, _Config, preset, pipeline,
                  device="cpu")
    assert host[0] == ref[0] and host[2] == ref[2]
    np.testing.assert_array_equal(host[1], ref[1])
    for impl in ("torch", "cuda"):
        dev = _probe(_port_core, port_neg, _Config, preset, pipeline,
                     device="cpu", score_impl=impl, wis_impl=impl)
        assert dev[0] == ref[0] and dev[2] == ref[2]
        np.testing.assert_allclose(dev[1], ref[1], atol=6e-8, rtol=0)
