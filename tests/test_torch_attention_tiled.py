"""The tensor-core flash-attention kernel's arithmetic, modelled on the CPU.

``mha_tiled_reference`` walks keys the way the kernel does (blocks of 128
rows ordered (position, head in group), 64- or 128-key tiles over the
block's key range, a running max, p rounded to bfloat16 before PV, l from
the float32 p).  The same numpy-seeded bfloat16 inputs go through it and through the
JAX package's ``mha_reference`` and ``mha_pallas`` (interpret mode), within
2e-2 atol and rtol (the bfloat16 tolerance of ``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import mha_pallas
from repro.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.flash_attention.ref import (
    mha_reference as port_reference, mha_tiled_reference)

TOL = 2e-2

# (B, Hq, Hkv, Sq, Sk, D, causal, window, q_offset)
CASES = [
    (1, 16, 1, 100, 100, 256, True, 48, 0),     # MQA, window < Sq, ragged
    (2, 10, 2, 72, 72, 64, True, 200, 0),       # group 5, window > Sq
    (1, 5, 1, 96, 224, 128, True, None, 128),   # q_offset, Sk > Sq
    (2, 2, 2, 130, 130, 64, False, None, 0),    # group 1, non-causal
    (1, 16, 1, 40, 200, 128, True, 64, 160),    # MQA, window and q_offset
    (1, 1, 1, 200, 200, 256, True, 32, 0),      # first tiles fully masked
    (1, 5, 1, 300, 300, 64, True, None, 0),     # group 5, several blocks
]


def _block(n):
    """The largest divisor of n up to 128 (mha_pallas needs tiling blocks)."""
    return max(x for x in range(1, min(n, 128) + 1) if n % x == 0)


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _tiled(arrays, **kw):
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return mha_tiled_reference(*t, **kw).float().numpy()


def _jax(fn, arrays, **kw):
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return np.asarray(fn(*j, **kw), np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_model_matches_reference(case):
    b, hq, hkv, sq, sk, d, causal, window, off = case
    x = _inputs(sum(case[:6]), b, hq, hkv, sq, sk, d)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = _tiled(x, **kw)
    np.testing.assert_allclose(got, _jax(mha_reference, x, **kw),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        got, _jax(mha_pallas, x, interpret=True, block_q=_block(sq),
                  block_k=_block(sk), **kw), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("block_rows,block_k", [(64, 16), (128, 64), (256, 128)])
def test_tiled_model_tile_sizes(block_rows, block_k):
    """Any cut into blocks and tiles computes the same attention."""
    x = _inputs(7, 1, 16, 1, 100, 100, 64)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in x]
    got = mha_tiled_reference(*t, causal=True, window=48,
                              block_rows=block_rows, block_k=block_k)
    want = port_reference(*t, causal=True, window=48)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=TOL, rtol=TOL)


def test_tiled_model_rejects_bad_groups():
    q = torch.zeros(1, 3, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="GQA"):
        mha_tiled_reference(q, kv, kv)
