"""Linear scan (K5): the port's plain version against the JAX package.

Seeded numpy inputs go through ``repro``'s Pallas kernel in interpret mode
and its jnp oracle, and through the port's plain torch loop, the CUDA
wrapper (which runs the plain version for CPU tensors) and the dispatch
op.  Tolerance: atol 1e-4 in float32, the reference suite's scan tolerance
(``tests/test_kernels.py``); the sums are the same but XLA may contract a
multiply-add where the port rounds each op.  bfloat16 outputs are held to
one bf16 step of the largest magnitude (8e-3 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan.kernel import linear_scan_pallas
from repro.kernels.linear_scan.ref import linear_scan_reference as scan_jax
from repro_torch.kernels.linear_scan import kernel as k5
from repro_torch.kernels.linear_scan.ops import linear_scan, resolve_impl
from repro_torch.kernels.linear_scan.ref import linear_scan_reference

ATOL = 1e-4


def _inputs(seed, b, t, d, *, lo=0.8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 0.999, (b, t, d)).astype(dtype)
    x = (rng.standard_normal((b, t, d)) * 0.1).astype(dtype)
    h0 = rng.standard_normal((b, d)).astype(dtype)
    return a, x, h0


def _port(a, x, h0=None):
    out, h_t = linear_scan_reference(
        torch.from_numpy(a), torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0))
    return out.numpy(), h_t.numpy()


@pytest.mark.parametrize("b,t,d,bt,bd", [
    (2, 512, 256, 128, 128),
    (1, 1024, 512, 256, 512),
    (3, 256, 128, 256, 128),
])
def test_scan_matches_pallas_interpret(b, t, d, bt, bd):
    a, x, h0 = _inputs(3, b, t, d)
    o, h_t = linear_scan_pallas(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                                block_t=bt, block_d=bd, interpret=True)
    po, ph = _port(a, x, h0)
    np.testing.assert_allclose(po, np.asarray(o), atol=ATOL)
    np.testing.assert_allclose(ph, np.asarray(h_t), atol=ATOL)


@pytest.mark.parametrize("t", [1, 37, 300])
@pytest.mark.parametrize("with_h0", [True, False])
def test_scan_any_length(t, with_h0):
    """T that does not tile the Pallas kernel's time block."""
    a, x, h0 = _inputs(t, 2, t, 64, lo=0.5)
    h0 = h0 if with_h0 else None
    r, r_t = scan_jax(jnp.asarray(a), jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    po, ph = _port(a, x, h0)
    assert po.shape == (2, t, 64) and ph.shape == (2, 64)
    np.testing.assert_allclose(po, np.asarray(r), atol=ATOL)
    np.testing.assert_allclose(ph, np.asarray(r_t), atol=ATOL)


def test_scan_bf16_inputs():
    """bf16 a, b: f32 carry, outputs in bf16, as the Pallas kernel."""
    a, x, h0 = _inputs(5, 2, 256, 128)
    a_b, x_b = jnp.asarray(a, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    o, h_t = linear_scan_pallas(a_b, x_b, jnp.asarray(h0, jnp.bfloat16),
                                block_t=128, block_d=128, interpret=True)
    at = torch.from_numpy(a).to(torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    h0t = torch.from_numpy(h0).to(torch.bfloat16)
    # the two sides carry the same bf16 inputs
    np.testing.assert_array_equal(np.asarray(a_b, np.float32), at.float().numpy())
    po, ph = linear_scan_reference(at, xt, h0t)
    assert po.dtype == torch.bfloat16 and ph.dtype == torch.bfloat16
    ref_o = np.asarray(o, np.float32)
    scale = np.abs(ref_o).max()
    np.testing.assert_allclose(po.float().numpy(), ref_o, atol=8e-3 * scale)
    np.testing.assert_allclose(ph.float().numpy(), np.asarray(h_t, np.float32),
                               atol=8e-3 * scale)
    # h_T is the last h_t rounded once
    assert torch.equal(ph, po[:, -1])


def test_impl_names_map_to_port_backends():
    assert resolve_impl(None, "cuda") == "cuda"
    assert resolve_impl(None, "cpu") == "torch"
    assert resolve_impl("pallas", "cpu") == "cuda"
    assert resolve_impl("assoc", "cuda") == "torch"
    assert resolve_impl("scan", "cuda") == "torch"
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("triton", "cuda")
    a, x, h0 = _inputs(7, 1, 40, 32)
    at, xt, h0t = map(torch.from_numpy, (a, x, h0))
    want = linear_scan_reference(at, xt, h0t)
    for impl in (None, "pallas", "assoc", "scan", "cuda", "torch"):
        got = linear_scan(at, xt, h0t, impl=impl)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), impl


def test_cuda_route_on_cpu_tensors_runs_plain_version():
    a, x, h0 = _inputs(11, 2, 33, 48)
    at, xt, h0t = map(torch.from_numpy, (a, x, h0))
    before = k5.LAUNCHES["linear_scan"]
    got = k5.linear_scan_cuda(at, xt, h0t)
    want = linear_scan_reference(at, xt, h0t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert k5.LAUNCHES["linear_scan"] == before  # no kernel launched
