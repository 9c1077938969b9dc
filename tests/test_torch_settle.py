"""Batched settle (K2): the port's plain version against the JAX package.

Sorted (W, L) lanes made from seeded numpy interval grids go through
``repro``'s jnp oracle ``wis_batch_reference`` and its Pallas kernel in
interpret mode, and through the port's torch version, the CUDA wrapper
(which runs the plain version for CPU tensors) and the dispatch ops --
batched, and fused with and without a transform.  Selections and totals
are exactly equal: both sides run the same float32 adds in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wis_dp import ops as wis_ops_jax
from repro.kernels.wis_dp.kernel import wis_batch_pallas
from repro.kernels.wis_dp.ref import wis_batch_reference as wis_batch_jax
from repro_torch import convert
from repro_torch.core.wis import wis_select_batch
from repro_torch.kernels.wis_dp import kernel as k2
from repro_torch.kernels.wis_dp.ops import (launch_counts, wis_settle_batch,
                                            wis_settle_fused)
from repro_torch.kernels.wis_dp.ref import wis_batch_reference


def _grid_pool(rng, *, n_windows, lanes, masked_frac=0.2):
    """Padded (W, L) layout on a float32-exact grid (halves / 64ths)."""
    starts = rng.integers(0, 64, (n_windows, lanes)).astype(np.float64) / 2
    ends = starts + rng.integers(1, 32, (n_windows, lanes)) / 2
    weights = rng.integers(1, 64, (n_windows, lanes)).astype(np.float64) / 64
    valid = rng.random((n_windows, lanes)) > masked_frac
    return starts, ends, weights, valid


def _sorted_lanes(starts, ends, weights, valid):
    """End-sorted weights (0 on masked lanes) + predecessors, as the host
    pack builds them (float64 stable sort)."""
    s = np.where(valid, starts, np.inf)
    e = np.where(valid, ends, np.inf)
    wt = np.where(valid, weights, 0.0)
    order = np.argsort(e, axis=1, kind="stable")
    e_s = np.take_along_axis(e, order, axis=1)
    s_s = np.take_along_axis(s, order, axis=1)
    w_s = np.take_along_axis(wt, order, axis=1).astype(np.float32)
    pred = np.stack([np.searchsorted(e_s[k], s_s[k], side="right")
                     for k in range(len(e_s))]).astype(np.int32)
    return w_s, pred, order


def _jax_results(w, pred):
    sel_r, tot_r = wis_batch_jax(jnp.asarray(w), jnp.asarray(pred))
    sel_p, tot_p = wis_batch_pallas(jnp.asarray(w), jnp.asarray(pred),
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(sel_r), np.asarray(sel_p))
    np.testing.assert_array_equal(np.asarray(tot_r), np.asarray(tot_p))
    return np.asarray(sel_r), np.asarray(tot_r)


def _port_results(w, pred):
    wt, pt = torch.from_numpy(w), torch.from_numpy(pred)
    outs = [wis_batch_reference(wt, pt), k2.wis_batch_cuda(pt, weights=wt)]
    outs += [wis_settle_batch(w, pred, impl=impl, device="cpu")
             for impl in ("torch", "cuda")]
    return [(s.numpy(), t.numpy()) for s, t in outs]


def _assert_batch_parity(w, pred):
    sel_j, tot_j = _jax_results(w, pred)
    before = launch_counts()["cuda"]
    for sel, tot in _port_results(w, pred):
        assert sel.dtype == np.bool_ and tot.dtype == np.float32
        np.testing.assert_array_equal(sel, sel_j)
        np.testing.assert_array_equal(tot, tot_j)
    assert launch_counts()["cuda"] == before  # CPU tensors launch nothing
    return sel_j, tot_j


@pytest.mark.parametrize("seed", range(6))
def test_batch_matches_jax_seeded(seed):
    rng = np.random.default_rng(seed)
    w_rows = int(rng.integers(1, 9))
    lanes = 1 << int(rng.integers(5, 8))
    _assert_batch_parity(*_sorted_lanes(*_grid_pool(rng, n_windows=w_rows,
                                                    lanes=lanes))[:2])


def test_batch_empty_and_fully_masked_windows():
    rng = np.random.default_rng(0)
    starts, ends, weights, valid = _grid_pool(rng, n_windows=4, lanes=16)
    valid[1, :] = False  # all-masked window
    valid[3, :] = False
    sel, tot = _assert_batch_parity(
        *_sorted_lanes(starts, ends, weights, valid)[:2])
    assert not sel[1].any() and not sel[3].any()
    assert tot[1] == 0.0 and tot[3] == 0.0
    # zero windows: degenerate shape
    sel0, tot0 = wis_settle_batch(np.zeros((0, 32), np.float32),
                                  np.zeros((0, 32), np.int32), impl="torch",
                                  device="cpu")
    assert sel0.shape == (0, 32) and tot0.shape == (0,)


@pytest.mark.parametrize("lanes", [31, 32, 33, 63, 64, 65])
def test_batch_bucket_boundaries(lanes):
    rng = np.random.default_rng(3 + lanes)
    starts, ends, weights, valid = _grid_pool(rng, n_windows=3, lanes=lanes,
                                              masked_frac=0.1)
    sel, _ = _assert_batch_parity(
        *_sorted_lanes(starts, ends, weights, valid)[:2])
    # and through the selector API: padding never selects a masked lane
    sel_b, _ = wis_select_batch(starts, ends, weights, valid, impl="torch",
                                device="cpu")
    sel_n, _ = wis_select_batch(starts, ends, weights, valid, impl="numpy")
    assert (sel_b == sel_n).all() and not (sel_b & ~valid).any()


def test_zero_weight_banning_equals_removal():
    rng = np.random.default_rng(4)
    starts, ends, weights, _ = _grid_pool(rng, n_windows=2, lanes=24,
                                          masked_frac=0.0)
    ban = rng.random((2, 24)) < 0.4
    sel_removed, _ = wis_select_batch(starts, ends, weights, ~ban,
                                      impl="torch", device="cpu")
    w0 = np.where(ban, 0.0, weights)
    sel_zeroed, _ = wis_select_batch(starts, ends, w0, None, impl="torch",
                                     device="cpu")
    assert (sel_zeroed & ban).sum() == 0
    assert (sel_removed == (sel_zeroed & ~ban)).all()
    w_s, pred, _ = _sorted_lanes(starts, ends, w0, np.ones_like(ban))
    _assert_batch_parity(w_s, pred)


def test_zero_length_intervals_keep_bounded_walk():
    """A zero-length interval's predecessor lies past its own lane: the DP
    reads a not-yet-written (zero) entry and the backtrack may jump
    forward; the bounded L-step walk is the reference's, step for step."""
    rng = np.random.default_rng(9)
    starts, ends, weights, valid = _grid_pool(rng, n_windows=4, lanes=32,
                                              masked_frac=0.0)
    ends = np.where(rng.random(ends.shape) < 0.3, starts, ends)
    w_s, pred, _ = _sorted_lanes(starts, ends, weights, valid)
    assert (pred > np.arange(32)[None, :] + 1).any()
    _assert_batch_parity(w_s, pred)


@pytest.mark.parametrize("transformed", [False, True])
def test_fused_gather_matches_jax(transformed):
    rng = np.random.default_rng(21 + transformed)
    n_rows, lanes, m_pad = 8, 64, 512
    scores = (rng.integers(0, 1 << 12, m_pad) / (1 << 12)).astype(np.float32)
    idx = rng.integers(0, 400, (n_rows, lanes)).astype(np.int32)
    idx[rng.random((n_rows, lanes)) < 0.25] = -1  # padded lanes
    idx[5, :] = -1  # an empty window
    mask = idx >= 0
    ends = np.sort(rng.integers(1, 200, (n_rows, lanes)), axis=1) / 2.0
    starts = np.maximum(ends - rng.integers(1, 40, (n_rows, lanes)) / 2.0, 0)
    pred = np.stack([np.searchsorted(ends[k], starts[k], side="right")
                     for k in range(n_rows)]).astype(np.int32)
    transform = (1.0 + rng.random(m_pad) * 0.5).astype(np.float32) \
        if transformed else None

    ref = {impl: wis_ops_jax.wis_settle_fused(
        jnp.asarray(scores), idx, mask, pred, impl=impl, transform=transform)
        for impl in ("ref", "pallas")}
    sel_j, tot_j = (np.asarray(x) for x in ref["ref"])
    np.testing.assert_array_equal(sel_j, np.asarray(ref["pallas"][0]))
    np.testing.assert_array_equal(tot_j, np.asarray(ref["pallas"][1]))
    assert not sel_j[5].any()

    s_t = torch.from_numpy(scores)
    t_t = None if transform is None else torch.from_numpy(transform)
    arrays = convert.settle_arrays(idx, pred, device="cpu")
    outs = [wis_settle_fused(s_t, idx, mask, pred, impl=impl, transform=t_t)
            for impl in ("torch", "cuda")]
    outs.append(k2.wis_batch_cuda(arrays["pred"], scores=s_t,
                                  idx=arrays["idx"], mask=arrays["mask"],
                                  transform=t_t))
    for sel, tot in outs:
        np.testing.assert_array_equal(sel.numpy(), sel_j)
        np.testing.assert_array_equal(tot.numpy(), tot_j)


def test_table3_worked_example_through_torch_settle():
    """The paper's worked example: (40,47) and (47,50) are both selected."""
    starts = np.array([[40.0, 47.0, 40.0]])
    ends = np.array([[47.0, 50.0, 50.0]])
    weights = np.array([[0.67, 0.64, 0.72]])  # v_A1, v_A2, v_B1
    sel, totals = wis_select_batch(starts, ends, weights, impl="torch",
                                   device="cpu")
    assert sel[0].tolist() == [True, True, False]
    assert totals[0] == pytest.approx(1.31)
    w_s, pred, _ = _sorted_lanes(starts, ends, weights, np.ones((1, 3), bool))
    _, tot = wis_settle_batch(w_s, pred, impl="torch", device="cpu")
    assert float(tot[0]) == pytest.approx(1.31, abs=1e-6)
