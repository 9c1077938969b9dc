"""The frozen counts against the bounds the port's card runs stated
(PERF.md's kernel table: NVIDIA H100 SXM data sheet rates) and the model
FLOPs of the 32-layer train step (11c)."""

import pytest

from bench import harness
from bench.counts import kernels as k
from bench.counts import model


def ms(n_bytes, n_ops):
    return 1e3 * k.bound_s(n_bytes, n_ops)


def test_k1_bound_at_the_round_shape():
    assert ms(*k.k1(32768, 1, 4, 32)) == pytest.approx(0.0028660, rel=1e-4)


def test_k2_bound_at_the_settle_shape():
    assert ms(*k.k2(64, 2048, True, 32768)) == pytest.approx(0.00043046, rel=1e-4)


def test_k5_bound_at_the_prefill_shape():
    assert ms(*k.k5(1, 1024, 131072, 4)) == pytest.approx(0.48094, rel=1e-4)


def test_k5_backward_bound_at_the_training_shape():
    assert ms(*k.k5_bwd(4, 512, 131072, 4)) == pytest.approx(1.6026, rel=1e-4)


def test_every_bound_is_bytes_bound():
    for n_bytes, n_ops in (k.k1(32768, 1, 4, 32), k.k2(64, 2048, True, 32768),
                           k.k5(1, 1024, 131072, 4), k.k5_bwd(4, 512, 131072, 4)):
        assert n_bytes / k.HBM_BYTES_PER_S > n_ops / k.F32_OPS_PER_S


def test_model_flops_of_the_train_step():
    c = harness.config("falcon-mamba-7b-32l")
    assert model.train_flops(c, 4 * 512) == pytest.approx(4.7999e13, rel=1e-4)
    full = harness.config("falcon-mamba-7b")
    assert model.ssm_params(full) == 7275544576
