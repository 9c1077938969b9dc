"""Model zoo of the port against the JAX package (dense, ssm, hybrid).

Params are drawn by ``repro`` from a seeded PRNG key and carried over with
``repro_torch.convert.model_params``; tokens come from numpy seeds.  The
reference runs its default CPU scan (``linear_scan_associative``), whose
rounding differs from the port's sequential scan, so logits and cache
leaves are held to atol 3e-4 (the reference suite's prefill/decode
tolerance, ``tests/test_models.py``), not to bit-equality.  The mixers'
own tests run the reference through its Pallas scan in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import ModelConfig as RefConfig
from repro.models.rglru import rglru_seq as ref_rglru_seq
from repro.models.ssm import mamba_seq as ref_mamba_seq
from repro_torch import convert
from repro_torch.configs import get, reduced
from repro_torch.models import Model, ModelConfig
from repro_torch.models.config import PORT_FIELDS
from repro_torch.models.layers import attention
from repro_torch.models.rglru import rglru_seq
from repro_torch.models.ssm import mamba_seq

ATOL = 3e-4


def port_config(cfg: RefConfig) -> ModelConfig:
    """The reference config as the port's: its fields, torch's dtype."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name not in PORT_FIELDS}
    kw["dtype"] = getattr(torch, jnp.dtype(cfg.dtype).name)
    return ModelConfig(**kw)


def tiny(family, **kw):
    base = dict(name=f"tiny-{family}", family=family, n_layers=4, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                model_axis_size=2, dtype=jnp.float32)
    base.update(kw)
    return RefConfig(**base)


CFGS = {
    "dense": lambda: tiny("dense", qk_norm=True, qkv_bias=True),
    "ssm": lambda: tiny("ssm", n_heads=1, n_kv_heads=1, d_ff=0, ssm_state=8),
    "hybrid": lambda: tiny("hybrid", n_layers=8,
                           pattern=("rglru", "rglru", "attn"), window=16,
                           n_kv_heads=1),
    "falcon_mamba_7b": lambda: ref_reduced("falcon_mamba_7b"),
    "recurrentgemma_9b": lambda: ref_reduced("recurrentgemma_9b"),
}
B, S, PROMPT = 2, 24, 16


def _np(x):
    return np.asarray(x, np.float64)


def _ref_decode(rm):
    """The reference's decode step, jitted as its serving engine jits it."""
    return jax.jit(lambda p, tok, idx, cache: rm.decode_step(p, tok, idx, cache))


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request):
    """Reference and port outputs for one config: forward over S tokens,
    prefill of PROMPT tokens, then S - PROMPT decode steps."""
    rc = CFGS[request.param]()
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(1))
    pp = convert.model_params(rp, "cpu")
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    out = {"name": request.param}
    out["forward"] = (_np(rm.forward(rp, jnp.asarray(toks), remat=False)[0]),
                      pm.forward(pp, torch.from_numpy(toks))[0].double().numpy())
    rl, rc_, _ = rm.prefill(rp, jnp.asarray(toks[:, :PROMPT]), max_seq=S)
    pl, pc, _ = pm.prefill(pp, torch.from_numpy(toks[:, :PROMPT]), max_seq=S)
    out["prefill"] = (_np(rl), pl.double().numpy())
    out["cache"] = (jax.tree.leaves(rc_), [c.clone() for c in jax.tree.leaves(pc)])
    dec = []
    ref_decode = _ref_decode(rm)
    for t in range(PROMPT, S):
        rl, rc_ = ref_decode(rp, jnp.asarray(toks[:, t]), jnp.int32(t), rc_)
        pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, t]), t, pc)
        dec.append((_np(rl), pl.double().numpy()))
    out["decode"] = dec
    return out


def test_forward_logits(pair):
    ref, port = pair["forward"]
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=ATOL)


def test_prefill_logits_and_cache(pair):
    ref, port = pair["prefill"]
    np.testing.assert_allclose(port, ref, atol=ATOL)
    ref_leaves, port_leaves = pair["cache"]
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).replace("torch.", "") == str(r.dtype)
        np.testing.assert_allclose(p.double().numpy(), _np(r), atol=ATOL)


def test_decode_steps(pair):
    assert len(pair["decode"]) == S - PROMPT
    for t, (ref, port) in enumerate(pair["decode"], start=PROMPT):
        np.testing.assert_allclose(port, ref, atol=ATOL,
                                   err_msg=f"{pair['name']} position {t}")


def _block_params(rc, kind):
    params = RefModel(rc).init(jax.random.PRNGKey(2))
    rp = jax.tree.map(lambda a: a[0], params["blocks"][f"b0_{kind}"][kind])
    return rp, convert.model_params(rp, "cpu")


@pytest.mark.parametrize("kind,cfg", [
    ("mamba", "falcon_mamba_7b"), ("rglru", "recurrentgemma_9b")])
def test_mixer_matches_reference_pallas_scan(kind, cfg):
    """mamba_seq / rglru_seq against the reference running its Pallas scan
    in interpret mode, with and without the decode cache."""
    rc = ref_reduced(cfg)
    rp, pp = _block_params(rc, kind)
    x = np.random.default_rng(4).standard_normal((2, 32, rc.d_model)).astype(np.float32)
    ref_fn, port_fn = {"mamba": (ref_mamba_seq, mamba_seq),
                       "rglru": (ref_rglru_seq, rglru_seq)}[kind]
    r_out, r_cache = ref_fn(jnp.asarray(x), rp, rc, scan_impl="pallas",
                            return_cache=True)
    p_out, p_cache = port_fn(torch.from_numpy(x), pp, port_config(rc),
                             scan_impl="pallas", return_cache=True)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), atol=1e-4)
    for k in r_cache:
        np.testing.assert_allclose(p_cache[k].numpy(), np.asarray(r_cache[k]),
                                   atol=1e-4, err_msg=k)
    plain = port_fn(torch.from_numpy(x), pp, port_config(rc), scan_impl="torch")
    assert torch.equal(plain, p_out)  # on the CPU "pallas" → "cuda" → plain


def test_hybrid_ring_cache_beyond_window():
    """Decode past the window: the ring overwrite keeps the port on the
    reference (mirrors tests/test_models.py::test_hybrid_ring_cache_beyond_window)."""
    rc = CFGS["hybrid"]()  # window 16
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(4))
    pp = convert.model_params(rp, "cpu")
    n = 40
    toks = np.random.default_rng(5).integers(0, rc.vocab_size, (1, n)).astype(np.int32)
    full, _ = pm.forward(pp, torch.from_numpy(toks))
    _, rcache, _ = rm.prefill(rp, jnp.asarray(toks[:, :24]), max_seq=n)
    _, pcache, _ = pm.prefill(pp, torch.from_numpy(toks[:, :24]), max_seq=n)
    ref_decode = _ref_decode(rm)
    for t in range(24, n):
        rl, rcache = ref_decode(rp, jnp.asarray(toks[:, t]), jnp.int32(t), rcache)
        pl, pcache = pm.decode_step(pp, torch.from_numpy(toks[:, t]), t, pcache)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL,
                                   err_msg=f"port vs reference at {t}")
        np.testing.assert_allclose(pl.numpy(), full[:, t].numpy(), atol=ATOL,
                                   err_msg=f"decode vs forward at {t}")


def test_bf16_conversion_keeps_bits():
    rc = tiny("ssm", n_layers=2, n_heads=1, n_kv_heads=1, d_ff=0, ssm_state=8,
              dtype=jnp.bfloat16)
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(6))
    pp = convert.model_params(rp, "cpu")
    n_bf16 = 0
    for r, p in zip(jax.tree.leaves(rp), jax.tree.leaves(pp)):
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            n_bf16 += 1
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(p.numpy(), r)
    assert n_bf16 >= 5
    toks = np.random.default_rng(7).integers(0, rc.vocab_size, (1, 12)).astype(np.int32)
    ref = _np(jnp.asarray(rm.forward(rp, jnp.asarray(toks), remat=False)[0], jnp.float32))
    port = pm.forward(pp, torch.from_numpy(toks))[0]
    assert port.dtype == torch.bfloat16
    # bf16 rounds at other places in the two frameworks: one bf16 step of
    # the logits' scale
    np.testing.assert_allclose(port.double().numpy(), ref,
                               atol=2 ** -7 * np.abs(ref).max())


def test_embed_reads_like_jnp_take():
    """Ids past the table read NaN and negative ids count from the end."""
    rc = CFGS["ssm"]()
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(8))
    pp = convert.model_params(rp, "cpu")
    vp = rc.padded_vocab
    ids = np.array([[0, 5, vp - 1, vp, vp + 7, -1, -vp, -vp - 1]], np.int32)
    ref = np.asarray(rm.embed(rp, jnp.asarray(ids), None))
    port = pm.embed(pp, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(port), np.nan_to_num(ref))


def test_registry_serves_only_ported_archs():
    assert get("falcon-mamba-7b").n_layers == 64
    assert reduced("recurrentgemma_9b").family == "hybrid"
    with pytest.raises(KeyError, match="unknown arch"):
        get("gpt2")


def test_attention_impls():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
    pos = torch.arange(64).expand(2, 64)
    full = attention(q, k, v, q_positions=pos, k_positions=pos, impl="full")
    chunked = attention(q, k, v, q_positions=pos, k_positions=pos,
                        impl="chunked", chunk_q=16)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=2e-5)
    pallas = attention(q, k, v, q_positions=pos, k_positions=pos, impl="pallas")
    np.testing.assert_allclose(pallas.numpy(), full.numpy(), atol=2e-5)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b"])
def test_init_params_follow_reference_templates(arch):
    """Same tree, shapes and dtypes as the reference's init; the fixed
    recipes (alog, ones, zeros) equal, the random ones on their scale."""
    rc, pc = ref_reduced(arch), reduced(arch)
    rp = RefModel(rc).init(jax.random.PRNGKey(0))
    pp = Model(pc).init(0, device="cpu")
    r_leaves = jax.tree_util.tree_leaves_with_path(rp)
    p_flat = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert len(r_leaves) == len(p_flat)
    for path, r in r_leaves:
        p = p_flat[path]
        name = jax.tree_util.keystr(path)
        r = np.asarray(r)
        assert tuple(p.shape) == r.shape and str(p.dtype)[6:] == str(r.dtype), name
        if np.all(r == r.flat[0]) or "a_log" in name:  # deterministic recipes
            # one float32 ulp: torch's and XLA's log may round log(n) apart
            np.testing.assert_allclose(p.numpy(), r, rtol=1.2e-7, err_msg=name)
        else:
            np.testing.assert_allclose(p.double().std().item(), r.std(),
                                       rtol=0.2, err_msg=name)


def test_norms_match_reference():
    """layer_norm (used by no ported family yet) and rms_norm, float32."""
    from repro.models.layers import layer_norm as ref_layer_norm
    from repro.models.layers import rms_norm as ref_rms_norm
    from repro_torch.models.layers import layer_norm, rms_norm

    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    bias = rng.standard_normal(64).astype(np.float32) * 0.1
    t = [torch.from_numpy(v) for v in (x, scale, bias)]
    np.testing.assert_allclose(
        layer_norm(*t).numpy(),
        np.asarray(ref_layer_norm(*(jnp.asarray(v) for v in (x, scale, bias)))),
        atol=1e-5)
    np.testing.assert_allclose(
        rms_norm(t[0], t[1]).numpy(),
        np.asarray(ref_rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-5)
