"""The port's mirror of ``tests/test_scoring_calibration.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

Scoring model (Eqs. 1–4) + calibration/verification (§4.2.1)."""
import numpy as np
import pytest
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core.calibration import (CalibrationConfig, Calibrator,
                                          per_variant_error, reliability)
from repro_torch.core.scoring import (POLICY_BALANCED, ScoringPolicy,
                                      composite_score, job_utility, score_pool,
                                      system_utility)
from repro_torch.core.trp import fmp_standard
from repro_torch.core.types import Variant, Window


def _variant(job="J1", t0=0.0, dur=5.0, h=0.6, feats=None):
    return Variant(
        job_id=job, slice_id="s0", t_start=t0, duration=dur,
        fmp=fmp_standard(1e9, 2e9, 0.0), local_utility=h,
        declared_features=feats or {"jct": 0.7, "qos": 1.0, "progress": 0.4},
        payload={"work": 1.0})


def _window(cap=8e9, t0=0.0, dur=10.0):
    return Window("s0", cap, t0, dur)


# ---------------------------------------------------------------------------
# normalization bounds (paper: Score(v) ∈ [0,1] by construction)
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.floats(0, 1), st.floats(0, 1), st.floats(0, 1))
def test_composite_score_in_unit_interval(lam, h, f):
    assert 0.0 <= composite_score(h, f, lam) <= 1.0


def test_policy_weight_validation():
    with pytest.raises(ValueError):
        ScoringPolicy(lam=1.5)
    with pytest.raises(ValueError):
        ScoringPolicy(alphas={"jct": 0.9, "qos": 0.3})  # Σα > 1
    with pytest.raises(ValueError):
        ScoringPolicy(betas={"utilization": -0.1})


def test_score_pool_bounds_and_order():
    w = _window()
    pol = POLICY_BALANCED
    vs = [_variant(h=0.2), _variant(h=0.9)]
    scores = score_pool(vs, w, pol)
    assert np.all(scores >= 0) and np.all(scores <= 1)
    assert scores[1] > scores[0]  # higher declared utility → higher score


def test_system_utility_features():
    w = _window(dur=10.0)
    v_full = _variant(dur=10.0)  # fills the window
    v_half = _variant(dur=5.0)
    pol = ScoringPolicy(lam=0.0, betas={"utilization": 1.0})
    assert system_utility(v_full, w, pol) > system_utility(v_half, w, pol)


def test_age_term_raises_score():
    w = _window()
    pol = ScoringPolicy(lam=0.5, betas={"utilization": 0.5, "age": 0.5})
    v = _variant()
    s_young = score_pool([v], w, pol, ages={"J1": 0.0})[0]
    s_old = score_pool([v], w, pol, ages={"J1": 1.0})[0]
    assert s_old > s_young


# ---------------------------------------------------------------------------
# §4.2.1: ε, ρ, calibration dynamics
# ---------------------------------------------------------------------------

@settings(max_examples=50, deadline=None)
@given(st.dictionaries(st.sampled_from(["a", "b", "c"]),
                       st.floats(0, 1), min_size=1),
       st.dictionaries(st.sampled_from(["a", "b", "c"]),
                       st.floats(0, 1), min_size=1))
def test_per_variant_error_bounded(declared, observed):
    eps = per_variant_error(declared, observed)
    assert 0.0 <= eps <= 1.0


def test_reliability_bounds_and_decay():
    assert reliability(0.0, 3.0) == 1.0
    r = [reliability(e, 3.0) for e in (0.0, 0.1, 0.5, 1.0)]
    assert all(0 < x <= 1 for x in r)
    assert all(a > b for a, b in zip(r, r[1:]))  # monotone decay


def test_calibrator_penalizes_misreporting():
    cal = Calibrator(CalibrationConfig(kappa=3.0))
    honest, liar = _variant(job="H"), _variant(job="L")
    for _ in range(10):
        cal.verify(honest, dict(honest.declared_features))  # exact match
        observed = {k: max(0.0, v - 0.5) for k, v in liar.declared_features.items()}
        cal.verify(liar, observed)  # overstated by 0.5
    assert cal.rho("H") > 0.95
    assert cal.rho("L") < 0.5
    # calibrated score of the liar is pulled toward its history
    h_liar = cal.calibrate(liar, 0.9)
    assert h_liar < 0.9


def test_calibrate_modes():
    for mode in ("fixed", "reliability", "multiplicative"):
        cal = Calibrator(CalibrationConfig(mode=mode))
        v = _variant()
        h = cal.calibrate(v, 0.8)
        assert 0.0 <= h <= 1.0


def test_hist_avg_tracks_observations():
    cal = Calibrator(CalibrationConfig(hist_half_life=2.0))
    v = _variant(job="J")
    for _ in range(20):
        cal.verify(v, {"jct": 0.9, "qos": 0.9, "progress": 0.9},
                   observed_utility=0.9)
    assert cal.hist_avg("J") == pytest.approx(0.9, abs=0.05)


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------


def test_score_pool_and_calibration_match_reference():
    from repro.core import calibration as ref_cal
    from repro.core import scoring as ref_scoring
    from repro.core import trp as ref_trp
    from repro.core import types as ref_types

    rng = np.random.default_rng(7)
    specs = [dict(job=f"J{i % 3}", t0=float(rng.uniform(0, 4)),
                  dur=float(rng.uniform(1, 6)), h=float(rng.uniform(0, 1)),
                  feats={"jct": float(rng.uniform(0, 1)), "qos": 1.0,
                         "progress": float(rng.uniform(0, 1))})
             for i in range(12)]

    def ref_variant(job, t0, dur, h, feats):
        return ref_types.Variant(
            job_id=job, slice_id="s0", t_start=t0, duration=dur,
            fmp=ref_trp.fmp_standard(1e9, 2e9, 0.0), local_utility=h,
            declared_features=feats, payload={"work": 1.0})

    port_vs = [_variant(**s) for s in specs]
    ref_vs = [ref_variant(**s) for s in specs]
    for lam in (0.0, 0.3, 0.7, 1.0):
        pol = ScoringPolicy(lam=lam, betas={"utilization": 0.5, "slack": 0.3})
        rpol = ref_scoring.ScoringPolicy(
            lam=lam, betas={"utilization": 0.5, "slack": 0.3})
        ages = {"J0": 0.5, "J1": 0.0}
        np.testing.assert_array_equal(
            score_pool(port_vs, _window(), pol, ages=ages),
            ref_scoring.score_pool(ref_vs, ref_types.Window("s0", 8e9, 0.0, 10.0),
                                   rpol, ages=ages))
    port_cal = Calibrator(CalibrationConfig())
    ref_c = ref_cal.Calibrator(ref_cal.CalibrationConfig())
    for k in range(20):
        observed = {"jct": float(rng.uniform(0, 1)), "qos": 1.0,
                    "progress": float(rng.uniform(0, 1))}
        utility = float(rng.uniform(0, 1))
        assert port_cal.verify(port_vs[k % 12], observed, utility) == \
            ref_c.verify(ref_vs[k % 12], observed, utility)
        declared = float(rng.uniform(0.2, 1))
        assert port_cal.calibrate(port_vs[k % 12], declared) == \
            ref_c.calibrate(ref_vs[k % 12], declared)
    assert port_cal.snapshot() == ref_c.snapshot()
