"""How the batched settle kernel (K2) computes: CPU models against JAX.

``wis_forward_pipelined_reference`` models the kernel's forward DP (dp
loads issued ``depth`` steps ahead, the nearest predecessors' dp from
registers, an add and a max side by side on the chain) and
``wis_backtrack_doubling_reference`` its backtrack (pointer doubling, the
bounded walk for rows whose taken lanes climb).  Seeded
(W, L) rows with float32 weights of full mantissa go through both models
and through ``repro``'s jnp oracle and its Pallas kernel in interpret mode:
selections must be equal and totals 0 ulps apart.  Short, medium and long
intervals put the predecessors among the last few lanes, just past them
and far behind.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wis_dp.kernel import wis_batch_pallas
from repro.kernels.wis_dp.ref import wis_batch_reference as wis_batch_jax
from repro_torch.kernels.wis_dp.ref import (climbing_rows,
                                            wis_backtrack_doubling_reference,
                                            wis_forward_pipelined_reference,
                                            wis_forward_reference)

#: interval lengths in units where ~4 intervals end per unit of time
MIXES = {"short": (0.05, 1.0), "medium": (1.0, 12.0), "long": (12.0, 400.0)}
#: the kernel's own lookahead, read from its source
KERNEL_DEPTH = int(re.search(
    r"constexpr int kDepth = (\d+);",
    (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
     / "csrc" / "wis_batch.cu").read_text()).group(1))
DEPTHS = tuple(sorted({1, 4, 8, KERNEL_DEPTH}))


def _rows(seed, n_rows, lanes, mix, *, masked_frac=0.2, zero_frac=0.0,
          pad_frac=0.0):
    """End-sorted float32 weights and predecessors as the host pack builds
    them: masked lanes weigh 0, padded lanes (start = end = inf) sort last
    with pred = L, zero-length intervals have pred past their own lane."""
    rng = np.random.default_rng(seed)
    lo, hi = MIXES[mix]
    starts = rng.uniform(0.0, lanes / 4.0, (n_rows, lanes))
    ends = starts + rng.uniform(lo, hi, (n_rows, lanes))
    ends = np.where(rng.random((n_rows, lanes)) < zero_frac, starts, ends)
    pad = rng.random((n_rows, lanes)) < pad_frac
    starts = np.where(pad, np.inf, starts)
    ends = np.where(pad, np.inf, ends)
    weights = rng.random((n_rows, lanes)).astype(np.float32)
    weights[(rng.random((n_rows, lanes)) < masked_frac) | pad] = 0.0
    order = np.argsort(ends, axis=1, kind="stable")
    e_s = np.take_along_axis(ends, order, axis=1)
    s_s = np.take_along_axis(starts, order, axis=1)
    w_s = np.take_along_axis(weights, order, axis=1)
    pred = np.stack([np.searchsorted(e_s[k], s_s[k], side="right")
                     for k in range(n_rows)]).astype(np.int32)
    return np.ascontiguousarray(w_s), pred


def _jax(w, pred):
    sel_r, tot_r = wis_batch_jax(jnp.asarray(w), jnp.asarray(pred))
    sel_p, tot_p = wis_batch_pallas(jnp.asarray(w), jnp.asarray(pred),
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(sel_r), np.asarray(sel_p))
    np.testing.assert_array_equal(np.asarray(tot_r), np.asarray(tot_p))
    return np.asarray(sel_r), np.asarray(tot_r)


def test_kernel_depth_is_modelled():
    """The shipped lookahead is one of the depths the models run at."""
    assert KERNEL_DEPTH >= 2 and KERNEL_DEPTH in DEPTHS


@functools.lru_cache(maxsize=None)
def _case(lanes, mix):
    n_rows = 4 if lanes > 256 else 8
    w, pred = _rows(1000 * lanes + len(mix), n_rows, lanes, mix,
                    pad_frac=0.1)
    return w, pred, _jax(w, pred)


def _models(w, pred, depth):
    wt, pt = torch.from_numpy(w), torch.from_numpy(pred)
    dp, take = wis_forward_pipelined_reference(wt, pt, depth)
    sel = wis_backtrack_doubling_reference(take, pt)
    return dp, take, sel.numpy(), dp[:, -1].numpy()


def _assert_equal(sel, tot, sel_j, tot_j):
    assert sel.dtype == np.bool_ and tot.dtype == np.float32
    np.testing.assert_array_equal(sel, sel_j)
    # 0 ulps: the same float32 bit patterns
    np.testing.assert_array_equal(tot.view(np.int32), tot_j.view(np.int32))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("lanes", [32, 64, 1000, 2048])
def test_models_match_jax(lanes, mix, depth):
    w, pred, (sel_j, tot_j) = _case(lanes, mix)
    dp, take, sel, tot = _models(w, pred, depth)
    _assert_equal(sel, tot, sel_j, tot_j)
    # the whole dp table and take, not only the totals, equal the plain loop
    dp_r, take_r = wis_forward_reference(torch.from_numpy(w),
                                         torch.from_numpy(pred))
    np.testing.assert_array_equal(dp.numpy().view(np.int32),
                                  dp_r.numpy().view(np.int32))
    assert torch.equal(take, take_r)
    # padded lanes climb (pred = L) but are never taken: every row doubles
    assert (pred > np.arange(lanes)).any()
    assert not climbing_rows(take, torch.from_numpy(pred)).any()


def test_mixes_reach_every_pred_case():
    """Short intervals' predecessors lie within 8 lanes, long ones' past."""
    gaps = {}
    for mix in MIXES:
        w, pred, _ = _case(2048, mix)
        d = np.arange(2048) - pred
        gaps[mix] = ((0 <= d) & (d < 8)).mean(), (d >= 8).mean()
    assert gaps["short"][0] > 0.5
    assert gaps["long"][1] > 0.5
    assert 0.0 < gaps["medium"][0] < 1.0 and 0.0 < gaps["medium"][1] < 1.0


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("lanes", [64, 1000])
def test_zero_length_rows_take_the_bounded_walk(lanes, depth):
    """Zero-length intervals that are taken climb: those rows keep the
    L-step walk, the others double, and both match the reference."""
    w, pred = _rows(7 + lanes, 6, lanes, "medium", zero_frac=0.3)
    w[3:, :] = np.where(np.arange(lanes) - pred[3:] < 0, 0.0, w[3:])
    sel_j, tot_j = _jax(w, pred)
    dp, take, sel, tot = _models(w, pred, depth)
    _assert_equal(sel, tot, sel_j, tot_j)
    climbing = climbing_rows(take, torch.from_numpy(pred)).numpy()
    assert climbing[:3].all() and not climbing[3:].any()


@pytest.mark.parametrize("depth", DEPTHS)
def test_all_masked_and_empty_rows(depth):
    lanes = 64
    w, pred = _rows(11, 6, lanes, "short")
    w[1, :] = 0.0  # every lane masked
    w[4, :] = 0.0
    pred[4, :] = lanes  # every lane padded: start = end = inf
    sel_j, tot_j = _jax(w, pred)
    _, _, sel, tot = _models(w, pred, depth)
    _assert_equal(sel, tot, sel_j, tot_j)
    assert not sel[1].any() and not sel[4].any()
    assert tot[1] == 0.0 and tot[4] == 0.0
    # degenerate shapes: no rows, no lanes
    for shape in ((0, lanes), (3, 0)):
        dp, take = wis_forward_pipelined_reference(
            torch.zeros(shape), torch.zeros(shape, dtype=torch.int32), depth)
        sel0 = wis_backtrack_doubling_reference(
            take, torch.zeros(shape, dtype=torch.int32))
        assert sel0.shape == shape and dp.shape == (shape[0], shape[1] + 1)
        assert not dp.any()


@pytest.mark.parametrize("lanes", [1, 2, 3, 5, 8, 9])
def test_lanes_around_the_depth(lanes):
    """L below, at and just past D and 3 D: rows too short for the
    pipeline run unpipelined, longer ones end in the unpipelined tail."""
    w, pred = _rows(30 + lanes, 5, lanes, "short", masked_frac=0.1)
    sel_j, tot_j = _jax(w, pred)
    for depth in DEPTHS:
        _, _, sel, tot = _models(w, pred, depth)
        _assert_equal(sel, tot, sel_j, tot_j)


@pytest.mark.parametrize("depth", DEPTHS)
def test_signed_zero_and_negative_weights(depth):
    """The kernel's dp[j+1] = dp[j] + fmax(w, 0) for d = 0 and fmax(w +
    dp[pred], dp[j]) otherwise give the reference's bits for any weight a
    batched settle may pass: -0, negative, exact ties."""
    lanes = 256
    w, pred = _rows(5, 6, lanes, "short", masked_frac=0.0)
    rng = np.random.default_rng(6)
    pick = rng.random(w.shape)
    w = np.where(pick < 0.15, np.float32(-0.0), w)
    w = np.where((pick >= 0.15) & (pick < 0.35), -w, w)
    w = np.where((pick >= 0.35) & (pick < 0.5), np.float32(0.25), w)
    w = np.ascontiguousarray(w.astype(np.float32))
    sel_j, tot_j = _jax(w, pred)
    _, _, sel, tot = _models(w, pred, depth)
    _assert_equal(sel, tot, sel_j, tot_j)
