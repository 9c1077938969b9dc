"""Flash attention of the port (K4's plain path) against the JAX package.

The same numpy-seeded inputs go through ``repro``'s Pallas kernel (interpret
mode on the CPU) and its ``mha_reference``, and through the port's
``flash_attention`` -- on CPU tensors the CUDA wrapper runs its plain
version.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32,
2e-2 in bfloat16 (atol and rtol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import mha_pallas
from repro.kernels.flash_attention.ref import mha_reference
from repro.models.layers import attention as ref_attention
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.kernels.flash_attention.ops import resolve_impl
from repro_torch.models.layers import attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _port(arrays, dtype, **kw):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return flash_attention(*t, impl="pallas", **kw).float().numpy()


def _jax(fn, arrays, dtype, **kw):
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    return np.asarray(fn(*j, **kw), np.float32)


def _close(a, b, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 384, 64),     # MQA + decode-style longer k
    (1, 4, 4, 256, 256, 128),    # MHA, wide head
    (2, 2, 2, 512, 512, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(b, hq, hkv, sq, sk, d, dtype):
    x = _inputs(0, b, hq, hkv, sq, sk, d)
    port = _port(x, dtype, causal=True, q_offset=sk - sq)
    _close(port, _jax(mha_reference, x, dtype, causal=True, q_offset=sk - sq),
           dtype)
    _close(port, _jax(mha_pallas, x, dtype, causal=True, q_offset=sk - sq,
                      interpret=True), dtype)


@pytest.mark.parametrize("window", [64, 128, 256])
def test_flash_attention_sliding_window(window):
    x = _inputs(1, 1, 2, 1, 256, 256, 64)
    port = _port(x, "float32", causal=True, window=window)
    _close(port, _jax(mha_reference, x, "float32", causal=True, window=window),
           "float32")
    _close(port, _jax(mha_pallas, x, "float32", causal=True, window=window,
                      interpret=True), "float32")


def test_flash_attention_noncausal():
    x = _inputs(2, 1, 2, 2, 128, 128, 64)
    port = _port(x, "float32", causal=False)
    _close(port, _jax(mha_reference, x, "float32", causal=False), "float32")
    _close(port, _jax(mha_pallas, x, "float32", causal=False, interpret=True),
           "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 48, 0), (True, 64, 56), (False, None, 0),
])
def test_flash_attention_any_length(dtype, causal, window, q_offset):
    """S = 200 does not tile by 128: the port takes it (the Pallas kernel
    does not), held against the reference's materialised softmax."""
    x = _inputs(3, 2, 4, 2, 200, 200 + q_offset, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(_port(x, dtype, **kw), _jax(mha_reference, x, dtype, **kw), dtype)


def test_attention_pallas_matches_reference():
    """As ``tests/test_models.py::test_attention_impls_agree``: the port's
    ``attention(impl="pallas")`` against the reference's pallas and full."""
    rng = np.random.default_rng(6)
    B, S, H, hd = 2, 64, 4, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    tp = torch.from_numpy(pos.copy())
    port = attention(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), q_positions=tp, k_positions=tp,
                     causal=True, impl="pallas").numpy()
    for impl in ("pallas", "full"):
        ref = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_positions=jnp.asarray(pos),
                            k_positions=jnp.asarray(pos), causal=True,
                            impl=impl)
        np.testing.assert_allclose(port, np.asarray(ref), atol=2e-5,
                                   err_msg=impl)


def test_attention_pallas_reads_offset_from_positions():
    """Keys a cache longer than the queries: the offset is q_positions[0],
    and the result is the full path's."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 1, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 1, 16)).astype(np.float32))
    for start in (0, 5, 32):
        qp = (start + torch.arange(8)).expand(2, 8)
        kp = torch.arange(40).expand(2, 40)
        for window in (None, 6):
            got = attention(q, k, v, q_positions=qp, k_positions=kp,
                            window=window, impl="pallas")
            want = attention(q, k, v, q_positions=qp, k_positions=kp,
                             window=window, impl="full")
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_attention_pallas_refuses_per_row_positions():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 1, 16)).astype(np.float32))
    kp = torch.arange(16).expand(2, 16)
    per_slot = torch.tensor([[3], [9]])  # slots at different depths
    with pytest.raises(ValueError, match="one query offset"):
        attention(q, k, k, q_positions=per_slot, k_positions=kp, impl="pallas")
    ring = torch.roll(kp, 3, dims=1)  # a ring cache's stored positions
    with pytest.raises(ValueError, match="one query offset"):
        attention(q, k, k, q_positions=torch.tensor([[9], [9]]),
                  k_positions=ring, impl="cuda")
    # one offset for the batch is fine: the full path's answer
    same = torch.tensor([[9], [9]])
    np.testing.assert_allclose(
        attention(q, k, k, q_positions=same, k_positions=kp,
                  impl="pallas").numpy(),
        attention(q, k, k, q_positions=same, k_positions=kp,
                  impl="full").numpy(), atol=2e-5)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, -1), (True, None, -40), (False, 4, 30), (True, 8, 30),
])
def test_rows_that_see_no_key_are_refused(causal, window, q_offset):
    x = [torch.zeros((1, 2, 8, 16)), torch.zeros((1, 1, 16, 16)),
         torch.zeros((1, 1, 16, 16))]
    for impl in ("cuda", "torch"):
        with pytest.raises(ValueError, match="sees no key"):
            flash_attention(*x, causal=causal, window=window,
                            q_offset=q_offset, impl=impl)


def test_impl_names_and_launch_counter():
    assert resolve_impl("pallas", "cpu") == "cuda"
    assert resolve_impl("xla", "cuda") == "torch"
    assert resolve_impl(None, "cuda") == "cuda"
    assert resolve_impl(None, "cpu") == "torch"
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("triangle", "cpu")
    x = _inputs(4, 1, 2, 1, 16, 16, 16)
    t = [torch.from_numpy(a) for a in x]
    before = k4.LAUNCHES["flash_attention"]
    a = flash_attention(*t, impl="cuda", block_q=64, block_k=32)
    b = flash_attention(*t, impl="xla")
    assert k4.LAUNCHES["flash_attention"] == before  # CPU: no kernel launched
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="window must be positive"):
        k4.mha_cuda(*t, causal=False, window=0)
