"""Scoring (K1): the port's plain version and dispatch against the JAX package.

The same seeded numpy inputs go through ``repro``'s jnp oracle, its Pallas
kernel (interpret mode on the CPU) and the port's torch version.  Scores
agree within 3e-5 (float32, different summation and erfc rounding) and
eligibility exactly; bucket padding self-masks at every boundary.  On the
CPU the CUDA wrapper runs the plain version (its tensors lie on the CPU),
so it is held to the torch result bit for bit and launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jasda_score.ops import score_variants as score_variants_jax
from repro.kernels.jasda_score.ref import (
    score_variants_reference as score_reference_jax)
from repro_torch import convert
from repro_torch.kernels.jasda_score import kernel as k1
from repro_torch.kernels.jasda_score.ops import (bucket_m, build_counts,
                                                 launch_counts, score_variants)
from repro_torch.kernels.jasda_score.ref import score_variants_reference

SCORE_ATOL = 3e-5


def _inputs(m, t, *, fj_cols=3, fs_cols=4, seed=None):
    rng = np.random.default_rng(m * 1000 + t if seed is None else seed)
    fj = rng.uniform(0, 1, (m, fj_cols)).astype(np.float32)
    fs = rng.uniform(0, 1, (m, fs_cols)).astype(np.float32)
    al = np.array([.5, .3, .2][:fj_cols], np.float32)
    be = np.array([.4, .2, .2, .1][:fs_cols], np.float32)
    mu = rng.uniform(5, 21, (m, t)).astype(np.float32)
    sg = rng.uniform(0.0, 0.8, (m, t)).astype(np.float32)
    sg[rng.uniform(size=(m, t)) < 0.1] = 0.0
    lam = rng.uniform(0.2, 0.8, m).astype(np.float32)
    cap = rng.uniform(15.0, 25.0, m).astype(np.float32)
    theta = rng.uniform(0.01, 0.2, m).astype(np.float32)
    return fj, fs, al, be, mu, sg, lam, cap, theta


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,t", [(8, 16), (64, 32), (256, 64), (300, 48)])
def test_plain_version_matches_jax(m, t):
    fj, fs, al, be, mu, sg, lam, cap, theta = _inputs(m, t)
    s_ref, e_ref, p_ref = score_reference_jax(
        jnp.array(fj), jnp.array(fs), jnp.array(al), jnp.array(be),
        jnp.array(mu), jnp.array(sg), lam=lam, capacity=cap, theta=theta)
    s_pal, e_pal, _ = score_variants_jax(
        fj, fs, al, be, mu, sg, lam=lam, capacity=cap, theta=theta,
        impl="pallas")
    s, e, p = score_variants_reference(*_torch(fj, fs, al, be, mu, sg),
                                       lam=lam, capacity=cap, theta=theta)
    assert s.dtype == torch.float32 and e.dtype == torch.bool
    for s_j, e_j in ((s_ref, e_ref), (s_pal, e_pal)):
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=SCORE_ATOL)
        np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=1e-5)
    # the recheck actually bites on this grid: some rows are ineligible
    assert 0 < int(e.sum()) < m or m <= 8


@pytest.mark.parametrize("m,t", [(64, 32), (300, 48)])
def test_cuda_wrapper_on_cpu_runs_plain_version(m, t):
    fj, fs, al, be, mu, sg, lam, cap, theta = _inputs(m, t, fj_cols=1)
    args = _torch(fj, fs, al, be, mu, sg)
    before = launch_counts()["cuda"]
    s_k, e_k = k1.score_variants_cuda(*args, *_torch(lam, cap, theta))
    s_p, e_p, _ = score_variants_reference(*args, lam=lam, capacity=cap,
                                           theta=theta)
    assert torch.equal(s_k, s_p) and torch.equal(e_k, e_p)
    assert launch_counts()["cuda"] == before  # nothing was launched
    assert build_counts()["cuda"] == 0  # nor built: CPU tensors need no nvcc


@pytest.mark.parametrize("m", [255, 256, 257, 1000])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_bucket_padding_self_masks(m, impl):
    fj, fs, al, be, mu, sg, lam, cap, theta = _inputs(m, 8, seed=m)
    kw = dict(lam=lam, capacity=cap, theta=theta, impl=impl, device="cpu")
    s_pad, e_pad, _ = score_variants(fj, fs, al, be, mu, sg, trim=False, **kw)
    m_pad = bucket_m(m)
    assert m_pad == max(256, 1 << (m - 1).bit_length())
    assert s_pad.shape == (m_pad,) and e_pad.shape == (m_pad,)
    assert not e_pad[m:].any() and not s_pad[m:].any()
    s, e, _ = score_variants(fj, fs, al, be, mu, sg, **kw)
    assert s.shape == (m,)
    assert torch.equal(s, s_pad[:m]) and torch.equal(e, e_pad[:m])
    s_j, e_j, _ = score_variants_jax(fj, fs, al, be, mu, sg, lam=lam,
                                     capacity=cap, theta=theta, impl="ref")
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=SCORE_ATOL)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))


def test_scalar_runtime_parameters_broadcast():
    fj, fs, al, be, mu, sg, *_ = _inputs(64, 32)
    s, e, _ = score_variants(fj, fs, al, be, mu, sg, lam=0.6, capacity=20.0,
                             theta=0.05, impl="torch", device="cpu")
    s_j, e_j, _ = score_variants_jax(fj, fs, al, be, mu, sg, lam=0.6,
                                     capacity=20.0, theta=0.05, impl="pallas")
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=SCORE_ATOL)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))


def test_packed_round_converted_from_reference():
    """A reference PackedRound, carried over by ``convert``, scores like the
    reference's own pack (the round path: ĥ column, α = [1], Fs = 4)."""
    from repro.core import Policy
    from repro.core.clearing import assign_bids
    from repro.core.trp import fmp_standard
    from repro.core.types import Variant, Window
    from repro.kernels.jasda_score.ops import pool_to_arrays_round

    gb = 1 << 30
    rng = np.random.default_rng(5)
    windows = [Window(f"s{k}", (8 + 4 * k) * gb, 0.0, 100.0) for k in range(4)]
    pool = []
    for i in range(300):
        w = windows[i % 4]
        t0 = float(rng.uniform(0, 60))
        steady = float(rng.uniform(2, 14)) * gb
        pool.append(Variant(
            job_id=f"J{i % 17}", slice_id=w.slice_id, t_start=t0,
            duration=float(rng.uniform(5, 40)),
            fmp=fmp_standard(0.3 * steady, steady, 0.1 * steady,
                             rel_sigma=0.05),
            local_utility=float(rng.uniform(0.1, 0.9)), declared_features={},
            payload={"work": 10.0}, variant_id=f"v{i}",
            theta=float(rng.uniform(0.01, 0.2))))
    fit, win_idx, view = assign_bids(windows, pool)
    policy = Policy(per_agent_theta=True)
    packed = pool_to_arrays_round(
        fit, windows, win_idx, policy.scoring, h=view.local_utility,
        pack_grids=True, theta=view.thetas)
    assert packed.mu.shape[1] == 32
    pr = convert.packed_round(packed, device="cpu")
    lam = policy.scoring.lam
    s, e, _ = score_variants_reference(pr.fj, pr.fs, pr.alphas, pr.betas,
                                       pr.mu, pr.sg, lam=lam,
                                       capacity=pr.caps, theta=pr.thetas)
    s_j, e_j, _ = score_variants_jax(
        packed.fj, packed.fs, packed.alphas, packed.betas, packed.mu,
        packed.sg, lam=lam, capacity=packed.caps, theta=packed.thetas,
        impl="pallas")
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=SCORE_ATOL)
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_j))
    assert convert.policy(policy).per_agent_theta
