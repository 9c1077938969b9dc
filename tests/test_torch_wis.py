"""Single-window WIS of the port (K3's plain path) against the JAX package.

``wis_dp`` is held to ``repro``'s ``wis_dp_pallas`` (interpret mode) and
``wis_dp_reference`` on numpy-seeded windows, as in
``tests/test_kernels.py``; ``wis_clear`` to the reference's ``wis_clear`` and
to the host ``wis_select``, as in ``tests/test_wis.py``.  On CPU tensors the
CUDA wrapper runs its plain version.  The DP is a chain of float32 adds in
one order on every side, so dp is compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.wis import wis_select as ref_wis_select
from repro.kernels.wis_dp.kernel import wis_dp_pallas
from repro.kernels.wis_dp.ops import wis_clear as ref_wis_clear
from repro.kernels.wis_dp.ref import wis_dp_reference as ref_wis_dp_reference
from repro_torch.core.wis import wis_select
from repro_torch.kernels import wis_clear
from repro_torch.kernels.wis_dp import kernel as k3
from repro_torch.kernels.wis_dp.ops import wis_dp


def _window(m, seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, m).astype(np.float32)
    ends = np.sort(rng.uniform(0, 100, m))
    starts = ends - rng.uniform(0.5, 20, m)
    pred = np.searchsorted(ends, starts, side="right").astype(np.int32)
    return w, pred


def _random_pool(rng, m):
    starts = rng.uniform(0, 100, m)
    ends = starts + rng.uniform(0.5, 30, m)
    w = rng.uniform(0.0, 1.0, m)
    return starts, ends, w


@pytest.mark.parametrize("m", [1, 7, 64, 300])
def test_wis_dp_matches_reference_kernel(m):
    w, pred = _window(m, m)
    before = k3.LAUNCHES["wis_dp"]
    dp, take = wis_dp(w, pred, impl="pallas", device="cpu")
    assert k3.LAUNCHES["wis_dp"] == before  # CPU: no kernel launched
    assert dp.dtype == torch.float32 and take.dtype == torch.bool
    dp_k, take_k = wis_dp_pallas(jnp.array(w), jnp.array(pred), interpret=True)
    dp_r, take_r = ref_wis_dp_reference(jnp.array(w), jnp.array(pred))
    for ref_dp, ref_take in ((dp_k, take_k), (dp_r, take_r)):
        np.testing.assert_array_equal(dp.numpy(), np.asarray(ref_dp))
        np.testing.assert_array_equal(take.numpy(), np.asarray(ref_take))
    dp_t, take_t = wis_dp(torch.from_numpy(w), torch.from_numpy(pred),
                          impl="torch")
    assert torch.equal(dp_t, dp) and torch.equal(take_t, take)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 12))
def test_wis_clear_agrees_with_reference_and_host(seed, m):
    rng = np.random.default_rng(seed)
    starts, ends, w = _random_pool(rng, m)
    sel_h, total_h = ref_wis_select(starts, ends, w)
    sel_r, total_r = ref_wis_clear(starts, ends, w, impl="pallas")
    sel_p, total_p = wis_select(starts, ends, w)
    assert total_p == total_h and sel_p.tolist() == sel_h.tolist()
    for impl in ("cuda", "torch"):
        sel_k, total_k = wis_clear(starts, ends, w, impl=impl, device="cpu")
        assert sel_k.dtype == np.int64
        assert sel_k.tolist() == sel_r.tolist()
        assert total_k == total_r
        assert total_k == pytest.approx(total_h, rel=1e-5)
        assert set(sel_k.tolist()) == set(sel_h.tolist())


def test_wis_clear_edge_cases():
    sel, total = wis_clear([], [], [], device="cpu")
    assert sel.shape == (0,) and total == 0.0
    # [40,47) + [47,50): touching intervals are compatible (paper Table 3)
    sel, total = wis_clear([40, 47, 40], [47, 50, 50], [0.67, 0.64, 0.72],
                           device="cpu")
    assert set(sel.tolist()) == {0, 1}
    assert total == pytest.approx(1.31, abs=1e-6)
    with pytest.raises(ValueError, match="settle impl"):
        wis_clear([0.0], [1.0], [1.0], impl="triangle", device="cpu")
