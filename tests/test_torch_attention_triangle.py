"""The ``triangle`` attention path of the port against the JAX package.

``models/layers.py::attention(impl="triangle")`` loops over query chunks
whose key extent grows with the chunk (and starts past the window), and
takes the full path when the chunk does not divide the queries.  The same
numpy-seeded (B, S, H, hd) inputs go through the reference's
``attention(impl="triangle")`` and the port's, causal, windowed, behind a
cache prefix and with S % chunk_q != 0, within 2e-5 in float32 and 2e-2
in bfloat16 (atol and rtol, ``tests/test_kernels.py``'s tolerances); the
triangle also agrees with the port's own full path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as ref_attention
from repro_torch.models.layers import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

CASES = [
    # b, hq, hkv, s, t, window, chunk_q
    (2, 4, 2, 64, 64, None, 16),      # causal self attention, 4 chunks
    (1, 4, 1, 48, 80, None, 16),      # behind a 32-key cache prefix
    (2, 2, 2, 64, 64, 20, 16),        # window: the key extent starts late
    (1, 4, 2, 40, 40, None, 16),      # 40 % 16: the full path
    (1, 2, 1, 50, 70, 24, 16),        # prefix, window and 50 % 16
    (1, 2, 2, 64, 64, None, 256),     # chunk longer than S: the full path
]


def _inputs(seed, b, hq, hkv, s, t, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,t,window,chunk_q", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triangle_matches_the_reference(b, hq, hkv, s, t, window, chunk_q,
                                        dtype):
    x = _inputs(b * 100 + s, b, hq, hkv, s, t)
    q_pos = np.broadcast_to(np.arange(t - s, t), (b, s)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    kw = dict(causal=True, window=window, impl="triangle", chunk_q=chunk_q)
    ref = ref_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in x),
                        q_positions=jnp.asarray(q_pos),
                        k_positions=jnp.asarray(k_pos), **kw)
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in x]
    qp, kp = torch.from_numpy(q_pos.copy()), torch.from_numpy(k_pos.copy())
    port = attention(*tt, q_positions=qp, k_positions=kp, **kw)
    assert port.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)
    full = attention(*tt, q_positions=qp, k_positions=kp, causal=True,
                     window=window, impl="full")
    np.testing.assert_allclose(port.float().numpy(), full.float().numpy(),
                               atol=tol, rtol=tol)
