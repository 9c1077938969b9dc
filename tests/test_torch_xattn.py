"""The cross-attention families (``vlm`` and ``encdec``) against the JAX package.

Params are drawn by ``repro`` from a seeded key and carried over with
``repro_torch.convert.model_params``; tokens and memories come from numpy
seeds.  The reference draws its LayerNorm scales and biases, the VLM's
tanh gates and the qkv / MLP biases as zeros: whisper's logits are then
identically zero and the VLM's cross attention reaches nothing.  So every
constant leaf is redrawn from a numpy seed before both packages read it
(``_live``), and the comparisons see the encoder and the cross attention.

The configs are the reference suite's tiny ``encdec`` and ``vlm``
(``tests/test_models.py``) and the two reduced configs, whose whisper
carries the qkv biases the tiny one lacks.  Logits, caches and gradients
are held at atol 3e-4, ``tests/test_torch_models.py``'s tolerance.

The reference's Pallas attention asserts that Sq and Sk tile by
``min(128, S)`` (``repro/kernels/flash_attention/kernel.py``), so its
``"pallas"`` runs here only where they do; the port's K4 path takes any
length (``test_encoder_seq_130_*``).  The reference's ``"pallas"`` also
reads ``q_offset = T − S`` (ROADMAP.md §3), wrong for a decoder cache
longer than the prompt: it is compared at ``max_seq`` = the prompt.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as ref_reduced
from repro.launch import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import ModelConfig as RefConfig
from repro.models import params as ref_params_mod
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.launch import serve, train
from repro_torch.models import Model, ModelConfig
from repro_torch.models.config import PORT_FIELDS
from repro_torch.models import layers as port_layers
from repro_torch.models import model as port_model
from repro_torch.models import params as port_params_mod

ATOL = 3e-4
#: a gradient leaf against the reference's, relative to its largest entry
GRAD_RTOL = 1e-4
B, S, PROMPT = 2, 20, 16


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
    "encdec": lambda: tiny("encdec", n_encoder_layers=2, encoder_seq=32,
                           max_pos_embed=128, gated_mlp=False, act="gelu"),
    "vlm": lambda: tiny("vlm", n_layers=10, cross_attn_every=5, vision_seq=16),
    "whisper_small": lambda: ref_reduced("whisper_small"),
    "llama3_2_vision_90b": lambda: ref_reduced("llama3_2_vision_90b"),
}


def _np(x):
    return np.asarray(x, np.float64)


def _live(params, family: str, seed: int):
    """Every constant leaf redrawn from a numpy seed: LayerNorm scales
    (``encdec``) around 1; RMSNorm scales (which add 1), biases and gates
    around 0."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a)
        if not a.size or not np.all(a == a.flat[0]):
            return jnp.asarray(a)
        name = jax.tree_util.keystr(path)
        scale = name.endswith("_scale']") or name.endswith("'final_norm']")
        base = 1.0 if family == "encdec" and scale else 0.0
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray((base + 0.3 * noise).astype(a.dtype))

    return jax.tree_util.tree_map_with_path(one, params)


def _memory(cfg, b, seed):
    t = cfg.encoder_seq or cfg.vision_seq
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _setup(rc, seed=1):
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = _live(rm.init(jax.random.PRNGKey(seed)), rc.family, seed)
    return rm, rp, pm, convert.model_params(rp, "cpu")


def _leaves(tree):
    return [t for t in jax.tree.leaves(tree)]


def _close(port_leaves, ref_leaves, what):
    assert len(port_leaves) == len(ref_leaves), what
    for n, (p, r) in enumerate(zip(port_leaves, ref_leaves)):
        assert tuple(p.shape) == np.shape(r), (what, n)
        np.testing.assert_allclose(p.double().numpy(), _np(r), atol=ATOL,
                                   err_msg=f"{what} leaf {n}")


@pytest.fixture(scope="module", params=list(CFGS))
def pair(request):
    """Reference and port outputs for one config: forward over S tokens,
    a prefill of PROMPT tokens (cache of S rows) and S - PROMPT decode
    steps against its cross stack, through "full"; the same prefill and
    steps through the port's "pallas"; a prefill through both packages'
    "pallas" at max_seq = PROMPT."""
    rc = CFGS[request.param]()
    rm, rp, pm, pp = _setup(rc)
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    mem = _memory(rc, B, 2)
    tj, mj = jnp.asarray(toks), jnp.asarray(mem)
    tt, mt = torch.from_numpy(toks), torch.from_numpy(mem)
    out = {"name": request.param, "cfg": rc, "rm": rm, "rp": rp, "pm": pm,
           "pp": pp, "mem": mem, "toks": toks}
    out["forward"] = (_np(rm.forward(rp, tj, memory=mj, remat=False)[0]),
                      pm.forward(pp, tt, memory=mt)[0].double().numpy())

    rl, rcache, rcross = rm.prefill(rp, tj[:, :PROMPT], memory=mj, max_seq=S)
    runs = {}
    for impl in ("full", "pallas"):
        pl, pcache, pcross = pm.prefill(pp, tt[:, :PROMPT], memory=mt,
                                        max_seq=S, impl=impl)
        run = {"prefill": pl.double().numpy(),
               "cache": [c.clone() for c in _leaves(pcache)],
               "cross": [c.clone() for c in _leaves(pcross)], "decode": []}
        for t in range(PROMPT, S):
            pl, pcache = pm.decode_step(pp, tt[:, t], t, pcache,
                                        cross_stack=pcross)
            run["decode"].append(pl.double().numpy())
        runs[impl] = run
    ref = {"prefill": _np(rl), "cache": _leaves(rcache),
           "cross": _leaves(rcross), "decode": []}
    for t in range(PROMPT, S):
        rl, rcache = rm.decode_step(rp, tj[:, t], jnp.int32(t), rcache,
                                    cross_stack=rcross)
        ref["decode"].append(_np(rl))
    out["ref"], out["runs"] = ref, runs

    rl, rcache, rcross = rm.prefill(rp, tj[:, :PROMPT], memory=mj,
                                    max_seq=PROMPT, impl="pallas")
    pl, pcache, pcross = pm.prefill(pp, tt[:, :PROMPT], memory=mt,
                                    max_seq=PROMPT, impl="pallas")
    out["pallas_vs_pallas"] = ((_np(rl), _leaves(rcache), _leaves(rcross)),
                               (pl.double().numpy(), _leaves(pcache),
                                _leaves(pcross)))
    return out


def test_forward_logits(pair):
    ref, port = pair["forward"]
    assert port.shape == ref.shape
    assert np.abs(ref).max() > 0.1  # the live leaves reach the logits
    np.testing.assert_allclose(port, ref, atol=ATOL)


@pytest.mark.parametrize("impl", ["full", "pallas"])
def test_prefill_logits_cache_and_cross_stack(pair, impl):
    """The port's prefill through ``impl`` against the reference's "full"
    (the cache is S rows, longer than the prompt)."""
    ref, run = pair["ref"], pair["runs"][impl]
    np.testing.assert_allclose(run["prefill"], ref["prefill"], atol=ATOL)
    _close(run["cache"], ref["cache"], "cache")
    _close(run["cross"], ref["cross"], "cross stack")
    rc = pair["cfg"]
    n_cross = rc.n_layers if rc.family == "encdec" else rc.n_layers // rc.cross_attn_every
    t = rc.encoder_seq or rc.vision_seq
    assert [tuple(c.shape) for c in run["cross"]] == \
        [(n_cross, B, t, rc.n_kv_heads, rc.hd)] * 2


@pytest.mark.parametrize("impl", ["full", "pallas"])
def test_decode_steps_against_the_cross_stack(pair, impl):
    run, ref = pair["runs"][impl], pair["ref"]
    assert len(run["decode"]) == S - PROMPT
    for t, (r, p) in enumerate(zip(ref["decode"], run["decode"]), start=PROMPT):
        np.testing.assert_allclose(p, r, atol=ATOL,
                                   err_msg=f"{pair['name']} position {t}")


def test_prefill_pallas_matches_reference_pallas(pair):
    """Both packages' flash attention (the reference's in interpret mode)
    where the shapes tile and the cache is the prompt."""
    (rl, rc_, rx), (pl, pc, px) = pair["pallas_vs_pallas"]
    np.testing.assert_allclose(pl, rl, atol=ATOL)
    _close(pc, rc_, "cache")
    _close(px, rx, "cross stack")


def test_encode_and_cross_kv_leaf_by_leaf(pair):
    rc, rm, rp, pm, pp = (pair[k] for k in ("cfg", "rm", "rp", "pm", "pp"))
    mem = pair["mem"]
    if rc.family == "encdec":
        ref_enc = rm.encode(rp, jnp.asarray(mem), remat=False)
        port_enc = pm.encode(pp, torch.from_numpy(mem), remat=False)
        np.testing.assert_allclose(port_enc.double().numpy(), _np(ref_enc),
                                   atol=ATOL)
        src_r, src_p = ref_enc, torch.from_numpy(np.asarray(ref_enc))
    else:
        src_r, src_p = jnp.asarray(mem), torch.from_numpy(mem)
    ref_kv, port_kv = rm.cross_kv(rp, src_r), pm.cross_kv(pp, src_p)
    assert sorted(port_kv) == sorted(ref_kv) == ["k", "v"]
    for k in ref_kv:
        assert tuple(port_kv[k].shape) == ref_kv[k].shape
        np.testing.assert_allclose(port_kv[k].double().numpy(), _np(ref_kv[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["whisper_small", "llama3_2_vision_90b"])
def test_loss_and_grad_match_jax(name):
    """``loss_fn`` (memory from the batch, remat on) and its gradient,
    leaf by leaf, against ``jax.value_and_grad``."""
    rc = CFGS[name]()
    rm, rp, pm, pp = _setup(rc, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rc.vocab_size, (2, 12)).astype(np.int32)
    mem = _memory(rc, 2, 5)
    r_loss, r_grads = jax.value_and_grad(lambda p: rm.loss_fn(p, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
        "memory": jnp.asarray(mem)}))(rp)
    leaves = list(jax.tree_util.tree_leaves_with_path(pp))
    for _, t in leaves:
        t.requires_grad_(True)
    p_loss = pm.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(toks),
                             "memory": torch.from_numpy(mem)})
    grads = torch.autograd.grad(p_loss, [t for _, t in leaves],
                                allow_unused=True)
    np.testing.assert_allclose(float(p_loss), float(r_loss), atol=ATOL)
    r_flat = dict(jax.tree_util.tree_leaves_with_path(r_grads))
    assert len(r_flat) == len(leaves)
    top = max(float(np.abs(_np(g)).max()) for g in r_flat.values())
    for (path, t), g in zip(leaves, grads):
        key = jax.tree_util.keystr(path)
        want = _np(r_flat[path])
        scale = float(np.abs(want).max())
        assert g is not None or scale == 0.0, f"{key}: no gradient reached it"
        got = np.zeros_like(want) if g is None else g.double().numpy()
        if key.endswith("['bk']"):
            # a key bias adds one constant to each query's logits, which the
            # softmax takes out: its gradient is zero but for rounding
            assert max(scale, float(np.abs(got).max())) <= 1e-6 * top, key
            continue
        # each leaf against its own largest gradient, so that a leaf reached
        # only through a small path (the encoder, through cross attention)
        # cannot pass with a missing or detached gradient
        assert scale > 1e-3 * top, f"{key}: gradient {scale} too small to hold"
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=min(ATOL, GRAD_RTOL * scale),
                                   err_msg=key)


@pytest.mark.parametrize("shape,dtype", [
    ((256, 64), jnp.float32), ((32, 64), jnp.float32),
    ((448, 768), jnp.bfloat16), ((1500, 768), jnp.bfloat16)])
def test_sinusoid_tables_bit_equal(shape, dtype):
    """The ``pos`` initialiser (the reduced whisper's decoder and encoder
    tables; whisper-small's 448-token context and 1500 frames in bf16)."""
    rc = ref_reduced("whisper_small").replace(dtype=dtype)
    ref = np.asarray(ref_params_mod._init_leaf(
        ref_params_mod.P(shape, (None, None), init="pos"), None, rc))
    port = port_params_mod._init_leaf(
        port_params_mod.P(shape, init="pos"), port_config(rc), None,
        torch.device("cpu"))
    assert tuple(port.shape) == shape
    if dtype == jnp.bfloat16:
        assert port.dtype == torch.bfloat16
        np.testing.assert_array_equal(port.view(torch.int16).numpy(),
                                      ref.view(np.int16))
    else:
        np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("name", ["whisper_small", "llama3_2_vision_90b"])
def test_init_params_follow_reference_templates(name):
    """Same tree, shapes and dtypes as the reference's init (encoder, cross
    stack, position tables, gates, biases); the position tables equal."""
    rp = RefModel(ref_reduced(name)).init(jax.random.PRNGKey(0))
    pp = Model(reduced(name)).init(0, device="cpu")
    r_leaves = jax.tree_util.tree_leaves_with_path(rp)
    p_flat = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert len(r_leaves) == len(p_flat)
    for path, r in r_leaves:
        p, r = p_flat[path], np.asarray(r)
        key = jax.tree_util.keystr(path)
        assert tuple(p.shape) == r.shape and str(p.dtype)[6:] == str(r.dtype), key
        if "pos_embed" in key:
            np.testing.assert_array_equal(p.numpy(), r, err_msg=key)


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_convert_carries_encoder_cross_stack_and_tables(family):
    """``convert.model_params`` walks the nested dicts: every leaf of a
    bf16 tree (the encoder, the cross stack, ``pos_embed``) lands on its
    path, bits kept."""
    rc = CFGS[family]().replace(dtype=jnp.bfloat16)
    rp = RefModel(rc).init(jax.random.PRNGKey(7))
    pp = convert.model_params(rp, "cpu")
    r_leaves = jax.tree_util.tree_leaves_with_path(rp)
    p_flat = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert len(p_flat) == len(r_leaves)
    wanted = {"encdec": ("'encoder'", "'cross'", "'pos_embed'"),
              "vlm": ("_cross'", "'gate_attn'", "'gate_mlp'")}[family]
    keys = [jax.tree_util.keystr(path) for path, _ in r_leaves]
    assert all(any(w in k for k in keys) for w in wanted)
    for path, r in r_leaves:
        p, r = p_flat[path], np.asarray(r)
        if r.dtype.name == "bfloat16":
            np.testing.assert_array_equal(p.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(p.numpy(), r)


@pytest.mark.parametrize("gate", [0.3, -1.7, 0.05])
def test_vlm_gate_product_promotes_to_float32_as_jax(gate):
    """The reference's float32 gate promotes the bf16 cross-attention and
    MLP outputs before the cast to bf16 (``(out * tanh(g)).astype``); the
    port multiplies in float32 and casts, bit for bit the same.  (torch
    types a bf16 × 0-dim float32 product bf16; the port does not rest on
    how a backend computes it.)"""
    out = np.random.default_rng(18).standard_normal((4, 16, 64)).astype(np.float32)
    out_j = jnp.asarray(out).astype(jnp.bfloat16)
    ref = np.asarray((out_j * jnp.tanh(jnp.asarray(np.float32(gate))))
                     .astype(jnp.bfloat16)).view(np.int16)
    out_t = torch.from_numpy(out).to(torch.bfloat16)
    g = torch.tensor(gate, dtype=torch.float32)
    port = port_model._gated(out_t, g, torch.bfloat16)
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.view(torch.int16).numpy(), ref)


def test_encoder_seq_130_pallas_diverges_from_the_reference():
    """130 frames do not tile by 128: the reference's "pallas" raises in
    the encoder, the port's matches the reference's "full" (ROADMAP.md §3,
    Divergences)."""
    rc = tiny("encdec", n_layers=2, n_encoder_layers=2, encoder_seq=130,
              max_pos_embed=128, gated_mlp=False, act="gelu")
    rm, rp, pm, pp = _setup(rc, seed=11)
    toks = np.random.default_rng(12).integers(0, rc.vocab_size, (2, PROMPT)).astype(np.int32)
    mem = _memory(rc, 2, 13)
    with pytest.raises(AssertionError):
        rm.prefill(rp, jnp.asarray(toks), memory=jnp.asarray(mem),
                   max_seq=PROMPT, impl="pallas")
    rl, rcache, rcross = rm.prefill(rp, jnp.asarray(toks), memory=jnp.asarray(mem),
                                    max_seq=S, impl="full")
    pl, pcache, pcross = pm.prefill(pp, torch.from_numpy(toks),
                                    memory=torch.from_numpy(mem), max_seq=S,
                                    impl="pallas")
    np.testing.assert_allclose(pl.double().numpy(), _np(rl), atol=ATOL)
    _close(_leaves(pcache), _leaves(rcache), "cache")
    _close(_leaves(pcross), _leaves(rcross), "cross stack")


def test_non_causal_pallas_reads_no_positions(monkeypatch):
    """A whisper prefill through "pallas" consults the one-offset check
    (a read back to the host) in its causal decoder layers only: the
    encoder and cross attention take offset 0 without it."""
    rc = ref_reduced("whisper_small")
    _, _, pm, pp = _setup(rc, seed=14)
    calls = []
    real = port_layers._one_offset
    monkeypatch.setattr(port_layers, "_one_offset",
                        lambda q, k: calls.append(1) or real(q, k))
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, rc.vocab_size, (2, PROMPT)).astype(np.int32))
    mem = torch.from_numpy(_memory(rc, 2, 16))
    pm.prefill(pp, toks, memory=mem, max_seq=S, impl="pallas")
    assert len(calls) == rc.n_layers
    # positions no single offset expresses: refused when causal, unread when not
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    qp = torch.from_numpy(rng.integers(0, 50, (2, 8)))
    kp = torch.from_numpy(rng.integers(0, 50, (2, 24)))
    with pytest.raises(ValueError, match="one query offset"):
        port_layers.attention(q, kv, kv, q_positions=qp, k_positions=kp,
                              causal=True, impl="pallas")
    flash = port_layers.attention(q, kv, kv, q_positions=qp, k_positions=kp,
                                  causal=False, impl="pallas")
    full = port_layers.attention(q, kv, kv, q_positions=qp, k_positions=kp,
                                 causal=False, impl="full")
    np.testing.assert_allclose(flash.numpy(), full.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", ["whisper_small", "llama3_2_vision_90b"])
def test_train_launcher_on_cpu(name, tmp_path):
    """The reduced configs train under the executor with a seeded memory
    from the data pipeline."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", name, "--reduced", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path)])
    out = buf.getvalue().splitlines()
    losses = json.loads(next(x for x in out if x.startswith("losses: "))[8:])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert out[-1].startswith("done: loss")


@pytest.mark.parametrize("name", ["whisper_small", "llama3_2_vision_90b"])
def test_serve_launcher_refuses_as_the_reference(name, monkeypatch):
    """``launch/serve.py`` drives decoder-only archs: the cross-attention
    families exit with the reference's message before any param is drawn
    (and before the card is asked for)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main(["--arch", name, "--reduced"])
    with pytest.raises(SystemExit) as port_exit:
        serve.main(["--arch", name, "--reduced"])
    assert str(port_exit.value) == str(ref_exit.value)
    assert "decoder-only" in str(port_exit.value)
