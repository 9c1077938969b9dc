"""The frozen counts against the bounds the port's card runs stated
(PERF.md's kernel tables: NVIDIA H100 SXM data sheet rates), the kernel
counters the harness reads, and the model FLOPs of the 32-layer train step
(11c)."""

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


@pytest.mark.parametrize("shape, want_ms, bound_by", [
    ((1, 40, 8, 4096, 4096, 128, True, None, 0), 0.17375190584428715, "operations"),
    ((1, 16, 16, 2048, 2048, 128, True, None, 0), 0.01737943153892821, "operations"),
    ((2, 4, 2, 128, 384, 64, True, None, 256), 0.00019562985074626866, "bytes"),
    ((4, 12, 12, 224, 1500, 64, False, None, 0), 0.006323734925373135, "bytes"),
], ids=["qwen3", "olmoe", "q_offset", "whisper_cross"])
def test_k4_bound_at_the_stated_shapes(shape, want_ms, bound_by):
    """K4's bounds in PERF.md's table of K4 shapes (bfloat16)."""
    n_bytes, n_ops = k.k4(*shape, size=2)
    got = 1e3 * k.bound_s(n_bytes, n_ops, k.BF16_FLOPS_PER_S)
    assert got == pytest.approx(want_ms, rel=1e-9)
    by_bytes = n_bytes / k.HBM_BYTES_PER_S > n_ops / k.BF16_FLOPS_PER_S
    assert by_bytes == (bound_by == "bytes")


def test_k4_counts_the_visible_pairs():
    assert k.keys_seen(5, 5, True, None, 0) == 5 * 6 // 2
    assert k.keys_seen(5, 7, False, None, 0) == 35
    # a window of 2 from offset 3: every row sees its own key and the one before
    assert k.keys_seen(4, 7, True, 2, 3) == 8
    n_bytes, n_ops = k.k4(2, 8, 2, 5, 5, 16, True, None, 0, 4)
    assert n_bytes == (2 * 2 * 8 * 5 * 16 + 2 * 2 * 2 * 5 * 16) * 4
    assert n_ops == 4 * 2 * 8 * 16 * 15


def test_the_harness_counts_k4_launches():
    counts = harness.kernel_counts()
    assert isinstance(counts["flash_attention"], int)
    assert isinstance(counts["flash_attention.shapes"], dict)
    since = harness.counts_since(counts, harness.kernel_counts())
    assert since["flash_attention"] == 0 and since["flash_attention.shapes"] == {}


def test_every_bound_is_bytes_bound():
    for n_bytes, n_ops in (k.k1(32768, 1, 4, 32), k.k2(64, 2048, True, 32768),
                           k.k5(1, 1024, 131072, 4), k.k5_bwd(4, 512, 131072, 4)):
        assert n_bytes / k.HBM_BYTES_PER_S > n_ops / k.F32_OPS_PER_S


def test_model_flops_of_the_train_step():
    c = harness.config("falcon-mamba-7b-32l")
    assert model.train_flops(c, 4 * 512) == pytest.approx(4.7999e13, rel=1e-4)
    full = harness.config("falcon-mamba-7b")
    assert model.ssm_params(full) == 7275544576
