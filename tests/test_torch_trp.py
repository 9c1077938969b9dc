"""The port's mirror of ``tests/test_trp.py``: the same tests on the same
inputs through ``repro_torch``, its backends mapped ("ref" -> "torch",
"pallas" -> "cuda", ``trace_counts`` -> ``build_counts``) and run on the
host through the port's own ``device="cpu"`` arguments.  Below, the
reference file's own description.

TRP/FMP: safety evaluators vs Monte-Carlo ground truth (paper §4.1a)."""
import numpy as np
import pytest
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro_torch.core.trp import (PhaseFMP, Phase, fmp_from_model,
                                  fmp_standard, fmp_static, is_safe,
                                  predict_duration, prob_exceed_grid,
                                  prob_exceed_union)


def test_grid_prob_matches_monte_carlo():
    fmp = fmp_standard(4e9, 10e9, 2e9, rel_sigma=0.05)
    mu, sigma = fmp.grid(64)
    cap = 12.5e9
    p_grid = prob_exceed_grid(mu, sigma, cap)
    rng = np.random.default_rng(0)
    n = 40000
    hits = 0
    for _ in range(n):
        traj = rng.normal(mu, sigma)
        hits += np.any(traj > cap)
    p_mc = hits / n
    assert p_grid == pytest.approx(p_mc, abs=0.01)


def test_union_bound_dominates_grid():
    fmp = fmp_standard(4e9, 10e9, 1e9, rel_sigma=0.1)
    mu, sigma = fmp.grid(64)
    for cap in (10.5e9, 11.5e9, 13e9):
        assert prob_exceed_union(mu, sigma, cap) >= prob_exceed_grid(mu, sigma, cap) - 1e-12


def test_deterministic_violation_certain():
    fmp = fmp_static(10e9, 0.0)
    mu, sigma = fmp.grid(8)
    assert prob_exceed_grid(mu, sigma, 9e9) == 1.0
    assert prob_exceed_grid(mu, sigma, 11e9) == 0.0


@settings(max_examples=40, deadline=None)
@given(st.floats(1e8, 1e10), st.floats(0.0, 0.2))
def test_safety_monotone_in_capacity(steady, rel_sigma):
    fmp = fmp_standard(steady * 0.3, steady, steady * 0.1,
                       rel_sigma=max(rel_sigma, 1e-4))
    mu, sigma = fmp.grid(32)
    caps = np.linspace(steady * 0.5, steady * 2.0, 8)
    ps = [prob_exceed_grid(mu, sigma, c) for c in caps]
    assert all(a >= b - 1e-12 for a, b in zip(ps, ps[1:]))


def test_is_safe_theta_boundary():
    fmp = fmp_standard(1e9, 2e9, 0.0, rel_sigma=0.02)
    assert is_safe(fmp, 3e9, theta=0.05)
    assert not is_safe(fmp, 1.9e9, theta=0.05)


def test_phase_fractions_validated():
    with pytest.raises(ValueError):
        PhaseFMP((Phase(0.5, 1, 1, 0),))


def test_predict_duration_quantile():
    # declared duration at q=0.9 exceeds the median but not wildly
    med = 100 / 4.0
    d = predict_duration(100, 4.0, cv=0.1, quantile=0.9)
    assert med < d < med * 1.25
    # q=0.5 returns the median
    assert predict_duration(100, 4.0, cv=0.1, quantile=0.5) == pytest.approx(med)


def test_fmp_from_model_shape():
    fmp = fmp_from_model(param_bytes=1e9, optimizer_bytes=2e9,
                         activation_bytes=5e8, kv_cache_bytes=1e8)
    assert fmp.peak_mean() > 3.1e9  # base + activations + burst
    mu, sigma = fmp.grid(16)
    assert mu.shape == (16,) and np.all(sigma >= 0)


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 32, 64])
def test_fmp_and_safety_evaluators_match_reference(n):
    from repro.core import trp as ref_trp

    for steady, burst, rel in ((4e9, 10e9, 0.05), (1e9, 2e9, 0.0),
                               (2e9, 3e9, 0.2)):
        port = fmp_standard(steady * 0.4, steady, burst * 0.1, rel_sigma=rel)
        ref = ref_trp.fmp_standard(steady * 0.4, steady, burst * 0.1,
                                   rel_sigma=rel)
        mu, sigma = port.grid(n)
        rmu, rsigma = ref.grid(n)
        np.testing.assert_array_equal(mu, rmu)
        np.testing.assert_array_equal(sigma, rsigma)
        for cap in (0.9 * steady, steady * 1.1, 2 * steady):
            assert prob_exceed_grid(mu, sigma, cap) == \
                ref_trp.prob_exceed_grid(rmu, rsigma, cap)
            assert prob_exceed_union(mu, sigma, cap) == \
                ref_trp.prob_exceed_union(rmu, rsigma, cap)
            for theta in (0.01, 0.05, 0.5):
                assert is_safe(port, cap, theta=theta) == \
                    ref_trp.is_safe(ref, cap, theta=theta)
    for q in (0.5, 0.9):
        assert predict_duration(100, 4.0, cv=0.1, quantile=q) == \
            ref_trp.predict_duration(100, 4.0, cv=0.1, quantile=q)
    kw = dict(param_bytes=1e9, optimizer_bytes=2e9, activation_bytes=5e8,
              kv_cache_bytes=1e8)
    for a, b in zip(fmp_from_model(**kw).grid(n),
                    ref_trp.fmp_from_model(**kw).grid(n)):
        np.testing.assert_array_equal(a, b)
