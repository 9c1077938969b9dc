"""How the single-window DP kernel (K3) computes: a CPU model against JAX.

``wis_dp_stream_reference`` models K3 (the section of csrc/wis_batch.cu
after K2): the window split into the blocks of a cluster, each with dp for
its own lanes, the lanes streamed through a ring of stages and converted in
place (pred clamped, w+ where pred = j, an earlier block's dp folded into
w), the chain's pipelined forward (K2's, loads ``kDepth`` steps ahead) and
the hand-off of dp at each block boundary.  Seeded windows go through the
model, ``repro``'s ``wis_dp_pallas`` in interpret mode and its jnp oracle
``wis_dp_reference``: dp must be bit-equal and take equal.

The Pallas kernel reads dp scratch it never wrote where a pred lies past
its lane (a zero-length interval), and in interpret mode that read is not
0, so windows with such preds are held to the jnp oracle alone, whose dp
is 0 there as in every form of the port.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wis_dp.kernel import wis_dp_pallas
from repro.kernels.wis_dp.ref import wis_dp_reference as jax_wis_dp_reference
from repro_torch.kernels.wis_dp.ref import (_Ring, wis_dp_reference,
                                            wis_dp_stream_reference)

_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "kernels" / "csrc" / "wis_batch.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE).group(1))


#: the kernel's lookahead and ring, read from its source
DEPTH = _constant("kDepth")
STAGE_LANES = _constant("kDpStageLanes")
STAGES = _constant("kDpStages")
#: (lanes a block, lanes a stage, stages): the kernel's one block and a
#: small cluster layout with short stages, so that a few hundred lanes
#: cross many stage and block boundaries
LAYOUTS = {
    "one block": dict(stage_lanes=STAGE_LANES, stages=STAGES),
    "blocks of 48": dict(lanes_per_rank=48, stage_lanes=12, stages=2),
    "blocks of 20": dict(lanes_per_rank=20, stage_lanes=12, stages=3),
}
#: the branch an H100 (232,448 bytes of shared memory a block) takes at
#: the reference's sizes: one block up to 55,004 lanes, then a cluster
KERNEL_LAYOUTS = {2048: None, 16384: None, 65536: 32768}


def _window(m, seed, *, zero_frac=0.0, specials=False):
    """End-sorted float32 weights and host predecessors; ``zero_frac`` of
    the intervals zero-length (pred past the lane); ``specials`` puts -0,
    negative, +inf, -inf and NaN weights among the rest."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, m).astype(np.float32)
    ends = np.sort(rng.uniform(0, 100, m))
    starts = ends - rng.uniform(0.5, 20, m)
    starts = np.where(rng.random(m) < zero_frac, ends, starts)
    if specials:
        pick = rng.random(m)
        for lo, v in ((0.0, -0.0), (0.05, -0.5), (0.15, np.inf),
                      (0.2, -np.inf), (0.25, np.nan)):
            w = np.where((pick >= lo) & (pick < lo + 0.05), np.float32(v), w)
        w = w.astype(np.float32)
    pred = np.searchsorted(ends, starts, side="right").astype(np.int32)
    return w, pred


@functools.lru_cache(maxsize=None)
def _jax(m, seed, zero_frac=0.0, specials=False, pallas=True):
    w, pred = _window(m, seed, zero_frac=zero_frac, specials=specials)
    dp_r, take_r = jax_wis_dp_reference(jnp.asarray(w), jnp.asarray(pred))
    if pallas:
        dp_k, take_k = wis_dp_pallas(jnp.asarray(w), jnp.asarray(pred),
                                     interpret=True)
        np.testing.assert_array_equal(np.asarray(dp_k).view(np.int32),
                                      np.asarray(dp_r).view(np.int32))
        np.testing.assert_array_equal(np.asarray(take_k), np.asarray(take_r))
    return w, pred, np.asarray(dp_r), np.asarray(take_r)


def _model(w, pred, stats=None, **layout):
    dp, take = wis_dp_stream_reference(torch.from_numpy(w),
                                       torch.from_numpy(pred), DEPTH,
                                       stats=stats, **layout)
    return dp.numpy(), take.numpy()


def _assert_equal(dp, take, dp_j, take_j):
    assert dp.dtype == np.float32 and take.dtype == np.bool_
    # 0 ulps: the same float32 bit patterns
    np.testing.assert_array_equal(dp.view(np.int32), dp_j.view(np.int32))
    np.testing.assert_array_equal(take, take_j)


def test_kernel_constants_are_modelled():
    """The kernel's windows of 2 kDepth lanes lie in one stage, its
    converter warp takes whole rows of 32 lanes, and its ring holds a
    stage beside the one the chain reads."""
    assert DEPTH >= 2 and STAGES >= 2
    assert STAGE_LANES % (2 * DEPTH) == 0 and STAGE_LANES % 32 == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("m", [1, 2, 3, 5, 7, 11, 12, 13, 64, 100, 257, 300])
def test_model_matches_pallas(m, layout):
    w, pred, dp_j, take_j = _jax(m, m)
    _assert_equal(*_model(w, pred, **LAYOUTS[layout]), dp_j, take_j)


@pytest.mark.parametrize("m", sorted(KERNEL_LAYOUTS))
def test_model_matches_jax_at_kernel_layouts(m):
    """At the reference's sizes and the blocks an H100 runs them in; every
    block past the first folds preds from the one before."""
    w, pred, dp_j, take_j = _jax(m, 40 + m, pallas=False)
    stats = {}
    dp, take = _model(w, pred, stats, lanes_per_rank=KERNEL_LAYOUTS[m],
                      stage_lanes=STAGE_LANES, stages=STAGES)
    _assert_equal(dp, take, dp_j, take_j)
    assert stats["blocks"] == (2 if KERNEL_LAYOUTS[m] else 1)
    assert (stats["folded"] > 0) == (stats["blocks"] > 1)
    assert stats["stages"] == sum(-(-n // STAGE_LANES) for n in (
        [m] if KERNEL_LAYOUTS[m] is None else [KERNEL_LAYOUTS[m]] * 2))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("m", [23, 24, 25, 47, 48, 49, 95, 96, 97, 383, 384,
                               385, 769])
def test_boundaries_of_stages_and_blocks(m, layout):
    """M just under, at and just over a stage (12, 384 lanes) and a block
    (20, 48 lanes) boundary, the tail of the pipeline crossing into a new
    stage, and a block's last stage holding a ragged few lanes."""
    w, pred, dp_j, take_j = _jax(m, 7 * m, pallas=False)
    _assert_equal(*_model(w, pred, **LAYOUTS[layout]), dp_j, take_j)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("m", [64, 300, 2048])
@pytest.mark.parametrize("specials", [False, True])
def test_zero_length_and_special_weights(m, layout, specials):
    """Zero-length intervals (pred past j, read as 0), -0, negative, ±inf
    and NaN weights: the chain's one add or one max gives the plain
    version's bits for any float weight (dp is never NaN or -0, a NaN or
    -inf weight is never taken) and folding keeps the plain add."""
    w, pred, dp_j, take_j = _jax(m, 3 * m + specials, zero_frac=0.2,
                                 specials=specials, pallas=False)
    assert (pred > np.arange(m)).any()
    if specials:
        assert np.isnan(w).any() and np.isinf(w).any()
        assert (np.signbit(w) & (w == 0)).any()
    dp, take = _model(w, pred, **LAYOUTS[layout])
    _assert_equal(dp, take, dp_j, take_j)
    assert not np.isnan(dp).any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_preds_out_of_range_are_clamped(layout):
    """A pred below 0 reads dp[0], one past M reads the zero past j: the
    port's plain version (the kernel clamps to [0, M] as it does)."""
    m = 150
    w, pred = _window(m, 5)
    rng = np.random.default_rng(6)
    pred = np.where(rng.random(m) < 0.1, -3, pred)
    pred = np.where(rng.random(m) < 0.1, m + 7, pred).astype(np.int32)
    dp_t, take_t = wis_dp_reference(torch.from_numpy(w), torch.from_numpy(pred))
    _assert_equal(*_model(w, pred, **LAYOUTS[layout]), dp_t.numpy(),
                  take_t.numpy())


def test_layouts_reach_every_case():
    """The small layouts cross block boundaries with preds reaching back
    into earlier blocks (folded), and stream many stages."""
    w, pred, _, _ = _jax(300, 300)
    for layout in LAYOUTS.values():
        stats = {}
        _model(w, pred, stats, **layout)
        assert stats["stages"] >= 1
        if "lanes_per_rank" in layout:
            assert stats["blocks"] == -(-300 // layout["lanes_per_rank"])
            assert stats["folded"] > 0


def test_ring_model_catches_a_window_across_stages():
    """A stage that 2 depth does not divide puts a window of the chain's
    lanes across two stages: the ring model raises."""
    ring = _Ring(200, 4 * DEPTH + 2, 2)
    ring.window(0, 2 * DEPTH)
    ring.window(2 * DEPTH, 2 * DEPTH)
    with pytest.raises(AssertionError, match="spans two stages"):
        ring.window(4 * DEPTH, 2 * DEPTH)


def test_ring_model_catches_a_deadlock():
    """With one stage, the pipeline's tail waits on a stage the producer
    cannot issue before the chain frees the one it holds."""
    m = 4 * 2 * DEPTH + 1  # the tail's last lane opens a third stage
    w, pred = _window(m, 9)
    with pytest.raises(AssertionError, match="deadlock"):
        _model(w, pred, stage_lanes=2 * 2 * DEPTH, stages=1)
    _model(w, pred, stage_lanes=2 * 2 * DEPTH, stages=2)  # two suffice


def test_pred_past_j_reads_zero_as_the_jnp_oracle():
    """Three lanes, two of them zero-length (pred past the lane): the jnp
    oracle reads dp 0 there and takes all three, and the port, model and
    plain version, follows it.  ``wis_dp_pallas`` is not held here: it
    reads scratch it never wrote, so what it gives depends on how JAX
    fills that scratch."""
    w = np.array([1.0, 2.0, 3.0], np.float32)
    pred = np.array([1, 0, 3], np.int32)
    dp_j, take_j = jax_wis_dp_reference(jnp.asarray(w), jnp.asarray(pred))
    np.testing.assert_array_equal(np.asarray(dp_j), [1.0, 2.0, 3.0])
    for layout in LAYOUTS.values():
        _assert_equal(*_model(w, pred, **layout), np.asarray(dp_j),
                      np.asarray(take_j))
    dp_t, take_t = wis_dp_reference(torch.from_numpy(w), torch.from_numpy(pred))
    _assert_equal(dp_t.numpy(), take_t.numpy(), np.asarray(dp_j),
                  np.asarray(take_j))


def test_empty_window():
    dp, take = _model(np.zeros((0,), np.float32), np.zeros((0,), np.int32))
    assert dp.shape == (0,) and take.shape == (0,)
