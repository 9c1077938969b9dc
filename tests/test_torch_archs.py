"""The dense configs the port serves, against the JAX package.

The four dense configs' reduced versions (qwen1.5's qkv bias, qwen3's qk
norm, starcoder2's non-gated tanh-GELU MLP, llama3's GQA) are held to the
reference model as ``tests/test_torch_models.py`` holds the other
families: forward logits, prefill logits and cache, then decode steps,
atol 3e-4.  The registry of the port is held to the reference's for the
dense, MoE and cross-attention configs, field by field, and the serving
launcher runs the decoder-only ones on the CPU (the cross-attention
families are held to the reference in ``tests/test_torch_xattn.py``).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, PORTED, get, info, reduced
from repro_torch.launch import serve, train
from repro_torch.models import Model, ModelConfig
from repro_torch.models.config import PORT_FIELDS

ATOL = 3e-4
DENSE = ("qwen1_5_4b", "qwen3_14b", "starcoder2_15b", "llama3_405b")
XATTN = ("whisper_small", "llama3_2_vision_90b")
NEW = DENSE + ("olmoe_1b_7b", "granite_moe_3b_a800m") + XATTN
DECODER_ONLY = tuple(a for a in NEW if a not in XATTN)
B, S, PROMPT = 2, 24, 16


def port_config(cfg) -> ModelConfig:
    """The reference config as the port's: its fields, torch's dtype."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name not in PORT_FIELDS}
    kw["dtype"] = getattr(torch, jnp.dtype(cfg.dtype).name)
    return ModelConfig(**kw)


def _np(x):
    return np.asarray(x, np.float64)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """Reference and port outputs for one reduced dense config: forward over
    S tokens, prefill of PROMPT tokens, then S - PROMPT decode steps."""
    rc = ref_reduced(request.param)
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(1))
    pp = convert.model_params(rp, "cpu")
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    out = {"name": request.param, "cfg": rc}
    out["forward"] = (_np(rm.forward(rp, jnp.asarray(toks), remat=False)[0]),
                      pm.forward(pp, torch.from_numpy(toks))[0].double().numpy())
    rl, rc_, _ = rm.prefill(rp, jnp.asarray(toks[:, :PROMPT]), max_seq=S)
    pl, pc, _ = pm.prefill(pp, torch.from_numpy(toks[:, :PROMPT]), max_seq=S)
    out["prefill"] = (_np(rl), pl.double().numpy())
    out["cache"] = (jax.tree.leaves(rc_), [c.clone() for c in jax.tree.leaves(pc)])
    ref_decode = jax.jit(lambda p, tok, idx, cache: rm.decode_step(p, tok, idx, cache))
    dec = []
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
    assert len(ref_leaves) == len(port_leaves) == 2  # k, v
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        np.testing.assert_allclose(p.double().numpy(), _np(r), atol=ATOL)


def test_decode_steps(pair):
    assert len(pair["decode"]) == S - PROMPT
    for t, (ref, port) in enumerate(pair["decode"], start=PROMPT):
        np.testing.assert_allclose(port, ref, atol=ATOL,
                                   err_msg=f"{pair['name']} position {t}")


def _fields(cfg):
    """Every field of the port's config, dtypes by name."""
    return {f.name: (str(getattr(cfg, f.name)).split(".")[-1]
                     if f.name == "dtype" else getattr(cfg, f.name))
            for f in dataclasses.fields(ModelConfig)}


@pytest.mark.parametrize("arch", NEW)
def test_registry_matches_reference(arch):
    """``get``, ``reduced`` and ``info`` give the reference's config and
    ArchInfo, field for field; the param counts follow."""
    assert arch in PORTED
    ref_cfg, ref_info = ref_get(arch)
    assert _fields(get(arch)) == _fields(port_config(ref_cfg))
    assert _fields(reduced(arch)) == _fields(port_config(ref_reduced(arch)))
    assert dataclasses.asdict(info(arch)) == dataclasses.asdict(ref_info)
    for cfg, rc in ((get(arch), ref_cfg), (reduced(arch), ref_reduced(arch))):
        assert cfg.param_count() == rc.param_count()
        assert cfg.active_param_count() == rc.active_param_count()


def test_port_fields_are_the_ones_the_reference_lacks():
    """The fields of the port's own configs are exactly those the JAX
    package's config lacks, and every reference config leaves them at
    their defaults."""
    from repro.models import ModelConfig as RefConfig

    ref = {f.name for f in dataclasses.fields(RefConfig)}
    port = {f.name for f in dataclasses.fields(ModelConfig)}
    assert port - ref == set(PORT_FIELDS)
    default = ModelConfig(name="d", family="dense", n_layers=1, d_model=8,
                          n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    for arch in ARCH_NAMES:
        for cfg in (get(arch), reduced(arch)):
            assert all(getattr(cfg, k) == getattr(default, k) for k in PORT_FIELDS)


def test_full_width_param_counts():
    """The widths served on the card: the reference's ``param_count``."""
    want = {"olmoe_1b_7b": 6_922_698_752, "granite_moe_3b_a800m": 3_380_477_952,
            "qwen1_5_4b": 3_958_374_400, "qwen3_14b": 14_784_921_600,
            "starcoder2_15b": 15_955_132_416}
    for arch, n in want.items():
        assert get(arch).param_count() == n, arch
    # granite's odd vocab pads to a multiple of 128 x 16
    assert get("granite_moe_3b_a800m").padded_vocab == 51_200


def _leaf_count(cfg) -> int:
    from repro_torch.models.params import P, build_template

    def walk(t):
        if isinstance(t, P):
            return math.prod(t.shape)
        return sum(walk(v) for v in t.values())
    return walk(build_template(cfg))


def test_cross_attention_param_counts():
    """The reference's ``param_count`` of the two cross-attention configs
    at full width, beside the leaves their templates hold: whisper's count
    leaves out the decoder's cross stack, the biases and both position
    tables, and the VLM's its gates (ROADMAP.md §3, Not faults).  The
    VLM is served cut to 20 of its 100 layers."""
    vlm, whisper = get("llama3_2_vision_90b"), get("whisper_small")
    assert vlm.param_count() == 87_677_730_816
    assert whisper.param_count() == 251_658_240
    assert _leaf_count(whisper) == 312_849_408
    assert _leaf_count(vlm) == 87_679_377_448
    assert _leaf_count(vlm.replace(n_layers=20)) == 19_227_025_416
    assert vlm.superblock == ("attn",) * 4 + ("cross",)
    assert whisper.superblock == ("attn",)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_serve_launcher_on_cpu(arch, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--json"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unfinished"] == [] and line["tokens"] == 8 * 16
    assert line["device"] == "cpu"


@pytest.mark.parametrize("arch", ["qwen1_5_4b", "granite_moe_3b_a800m"])
def test_serve_launcher_through_flash_attention_on_cpu(arch, capsys):
    """``--attn-impl pallas`` takes the prefills through flash attention's
    plain version on the CPU and serves the same tokens as ``auto``."""
    outs = []
    for impl in ("auto", "pallas"):
        assert serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--json", "--attn-impl", impl, "--requests", "3"]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert [o["tokens"] for o in outs] == [48, 48]
    assert outs[1]["attn_impl"] == "pallas" and outs[1]["unfinished"] == []


def test_train_launcher_olmoe_on_cpu(capsys, tmp_path):
    """The reduced MoE trains under the executor with the aux term."""
    train.main(["--arch", "olmoe_1b_7b", "--reduced", "--device", "cpu",
                "--steps", "5", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = json.loads(next(line for line in out.splitlines()
                             if line.startswith("losses: "))[len("losses: "):])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert "done:" in out

