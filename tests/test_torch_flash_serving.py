"""Prefill and serving through flash attention (K4's path) against the JAX package.

Params are drawn by ``repro`` from a seeded key and carried over with
``repro_torch.convert.model_params``; tokens come from numpy seeds.  The
reference's ``prefill(impl="pallas")`` runs its Pallas kernel in interpret
mode; its CPU scan rounds differently from the port's, so logits and cache
leaves are held to atol 3e-4, the tolerance ``tests/test_torch_models.py``
uses for the hybrid family.

The dense case pins a fault of the reference: its ``attention`` passes
``q_offset = T − S`` to the kernel, which is wrong when the keys are a
linear cache longer than the prompt.  The port reads the offset from the
positions and gives the reference's ``"full"`` result.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import ModelConfig as RefConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import Model, ModelConfig
from repro_torch.models.config import PORT_FIELDS
from repro_torch.serving import Request, ServeConfig, ServingEngine

ATOL = 3e-4


def port_config(cfg: RefConfig) -> ModelConfig:
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
    "hybrid": lambda: tiny("hybrid", n_layers=8,
                           pattern=("rglru", "rglru", "attn"), window=16,
                           n_kv_heads=1),
    "hybrid3": lambda: tiny("hybrid", n_layers=3,
                            pattern=("rglru", "rglru", "attn"), window=8,
                            n_kv_heads=1),
    "dense": lambda: tiny("dense", qk_norm=True),
    "recurrentgemma_9b": lambda: ref_reduced("recurrentgemma_9b"),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(config, reference model, its params, port model, port params); the
    reference's eager init is the slow part, so each config draws once."""
    rc = CFGS[name]()
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(1))
    return rc, rm, rp, pm, convert.model_params(rp, "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name,s,max_seq", [
    ("hybrid", 40, 48), ("recurrentgemma_9b", 32, 40),
])
def test_prefill_pallas_matches_reference_pallas(name, s, max_seq):
    """Prompts past the window: the ring cache keeps the last ``window``
    rows and the prefill attends over the in-flight k/v."""
    rc, rm, rp, pm, pp = _pair(name)
    toks = _tokens(rc, 2, s)
    rl, rcache, _ = rm.prefill(rp, jnp.asarray(toks), impl="pallas",
                               max_seq=max_seq)
    pl, pcache, _ = pm.prefill(pp, torch.from_numpy(toks), impl="pallas",
                               max_seq=max_seq)
    np.testing.assert_allclose(pl.double().numpy(), np.asarray(rl, np.float64),
                               atol=ATOL)
    ref_leaves, port_leaves = jax.tree.leaves(rcache), jax.tree.leaves(pcache)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(p.double().numpy(), np.asarray(r, np.float64),
                                   atol=ATOL)
    full, _, _ = pm.prefill(pp, torch.from_numpy(toks), impl="full",
                            max_seq=max_seq)
    np.testing.assert_allclose(pl.numpy(), full.numpy(), atol=2e-5)


def test_dense_linear_cache_prefill_pallas_equals_full():
    """max_seq 256 > S = 128: the attention runs over all 256 cache rows.
    The port's "pallas" equals the reference's "full" (the reference's
    own "pallas" reads q_offset = 128 there and differs)."""
    rc, rm, rp, pm, pp = _pair("dense")
    toks = _tokens(rc, 1, 128, seed=3)
    rl, rcache, _ = rm.prefill(rp, jnp.asarray(toks), impl="full", max_seq=256)
    pl, pcache, _ = pm.prefill(pp, torch.from_numpy(toks), impl="pallas",
                               max_seq=256)
    np.testing.assert_allclose(pl.double().numpy(), np.asarray(rl, np.float64),
                               atol=ATOL)
    for r, p in zip(jax.tree.leaves(rcache), jax.tree.leaves(pcache)):
        np.testing.assert_allclose(p.double().numpy(), np.asarray(r, np.float64),
                                   atol=ATOL)


def test_decode_through_pallas_takes_one_offset_or_raises():
    """A linear-cache decode step at one index for the batch is one offset
    (the full path's answer); a ring cache or per-slot indices are not."""
    rc, _, _, pm, pp = _pair("dense")
    toks = torch.from_numpy(_tokens(rc, 2, 20, seed=4))
    _, cache, _ = pm.prefill(pp, toks[:, :16], max_seq=32)
    kept = {k: v.clone() for k, v in cache["blocks"]["b0_attn"].items()}
    auto, _ = pm.decode_step(pp, toks[:, 16], 16, cache)
    cache["blocks"]["b0_attn"].update(kept)  # undo the in-place write
    flash, _ = pm.decode_step(pp, toks[:, 16], 16, cache, impl="pallas")
    np.testing.assert_allclose(flash.numpy(), auto.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="one query offset"):
        pm.decode_step(pp, toks[:, 16], torch.tensor([16, 12]), cache,
                       impl="pallas")

    _, _, _, hm, hp = _pair("hybrid3")
    _, hcache, _ = hm.prefill(hp, toks[:, :12], max_seq=32)
    with pytest.raises(ValueError, match="one query offset"):
        hm.decode_step(hp, toks[:, 12], 12, hcache, impl="pallas")


def _requests(cls, cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 40))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        out.append(cls(f"r{i:03d}", prompt, max_new_tokens=int(rng.integers(3, 9))))
    return out


def test_engine_pallas_prefill_serves_reference_tokens():
    """Reduced recurrentgemma-9b (window 16, prompts of 4-39 tokens):
    prefills through flash attention, decode through "auto"; the greedy
    tokens equal the reference engine's."""
    rc, rm, rp, _, pp = _pair("recurrentgemma_9b")
    pm = Model(port_config(rc))  # its own, so the spy below stays local
    ref_eng = RefEngine(rm, rp, RefServeConfig(batch_slots=3, max_seq=64))
    port_eng = ServingEngine(pm, pp, ServeConfig(batch_slots=3, max_seq=64),
                             device="cpu", attn_impl="pallas")
    calls = []
    prefill = pm.prefill
    pm.prefill = lambda *a, **kw: calls.append(kw["impl"]) or prefill(*a, **kw)
    ref_reqs = _requests(RefRequest, rc, 7, seed=1)
    port_reqs = _requests(Request, rc, 7, seed=1)
    for r in ref_reqs:
        ref_eng.submit(r)
    for r in port_reqs:
        port_eng.submit(r)
    ref_eng.run_until_done()
    port_eng.run_until_done()
    assert calls == ["pallas"] * 7
    assert all(r.done for r in port_reqs)
    for r, p in zip(ref_reqs, port_reqs):
        assert p.output == r.output, r.request_id


@pytest.mark.parametrize("impl", ["pallas", "cuda", "chunked"])
def test_serve_launcher_attn_impl_on_cpu(impl, capsys):
    rc = serve.main(["--arch", "recurrentgemma_9b", "--reduced", "--device",
                     "cpu", "--json", "--attn-impl", impl, "--requests", "3",
                     "--max-new", "4", "--max-seq", "48"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unfinished"] == [] and line["tokens"] == 12
    assert line["attn_impl"] == impl


def test_serve_launcher_rejects_unknown_attn_impl():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "recurrentgemma_9b", "--reduced", "--device",
                    "cpu", "--attn-impl", "triangle"])
