"""The port's torch ``log_ndtr`` against the JAX package's, in float32.

Same three branches at the same branch points (z ≥ −1, −10 ≤ z < −1,
z < −10).  Values agree within a float32 tolerance (the two packages'
erfc/log implementations may round differently in the last bits); the
branch chosen on each side of −1 and −10 is pinned exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import log_ndtr as log_ndtr_jax
from repro_torch.kernels.common import log_ndtr

# float32: 32 ulps relative.  The widest gap is the far right tail (z > 5),
# where log Φ(z) ≈ −erfc(z/√2)/2 is below 1e-6 and the two libraries' erfc
# differ by ~17 ulps; everywhere else the gap is under 8 ulps.  The absolute
# floor only matters where both sides round to 0.
RTOL = 32 * float(np.finfo(np.float32).eps)
ATOL = 1e-30


def _around(x: float) -> np.ndarray:
    x = np.float32(x)
    return np.array([np.nextafter(x, np.float32(-np.inf)), x,
                     np.nextafter(x, np.float32(np.inf))], np.float32)


def _grid() -> np.ndarray:
    z = np.linspace(-40.0, 10.0, 20001, dtype=np.float32)
    return np.concatenate([z, _around(-1.0), _around(-10.0)])


def test_log_ndtr_matches_jax_over_range():
    z = _grid()
    got = log_ndtr(torch.from_numpy(z)).numpy()
    ref = np.asarray(log_ndtr_jax(jnp.asarray(z)))
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("point", [-1.0, -10.0])
def test_log_ndtr_branch_points(point):
    """At and one ulp either side of each branch point, the port takes the
    reference's branch: its value is exactly that branch's formula."""
    z = torch.from_numpy(_around(point))
    x = z * 0.7071067811865476
    right = torch.log1p(-0.5 * torch.erfc(x))
    left = torch.log(torch.clamp(0.5 * torch.erfc(-x), min=0.0))
    asym = -0.5 * z * z - torch.log(-z * 2.5066282746310002 + 1e-30)
    below, at, above = log_ndtr(z).tolist()
    if point == -1.0:
        expect = (left[0], right[1], right[2])
    else:
        expect = (asym[0], left[1], left[2])
    assert [below, at, above] == [float(e) for e in expect]
    ref = np.asarray(log_ndtr_jax(jnp.asarray(z.numpy())))
    np.testing.assert_allclose([below, at, above], ref, rtol=RTOL, atol=ATOL)


def test_log_ndtr_is_not_torch_special():
    """The deep left tail is the reference's asymptote, not torch's own."""
    z = torch.tensor([-30.0, -20.0, -12.0])
    asym = -0.5 * z * z - torch.log(-z * 2.5066282746310002 + 1e-30)
    assert torch.equal(log_ndtr(z), asym)
