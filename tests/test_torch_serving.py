"""Serving engine of the port: continuous batching, and the reference's
greedy tokens reproduced on the same seeded requests.

The engine tests mirror ``tests/test_serving_runtime.py`` on the port (on
the CPU).  The parity test serves reduced falcon-mamba through both
packages' ``ServingEngine`` with the reference's params carried over by
``convert.model_params``: the greedy tokens must be identical, and on the
CPU every decode step runs eagerly.
"""
import dataclasses
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
from repro_torch.runtime import trace
from repro_torch.serving import Request, ServeConfig, ServingEngine


def _model():
    """The reference suite's dense model, its params carried over."""
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, model_axis_size=1)
    ref_params = RefModel(RefConfig(**kw, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0))
    cfg = ModelConfig(**kw, dtype=torch.float32)
    return Model(cfg), convert.model_params(ref_params, "cpu"), cfg


def _engine(m, params, **kw):
    return ServingEngine(m, params, ServeConfig(**kw), device="cpu")


def test_engine_completes_all_requests():
    m, params, cfg = _model()
    eng = _engine(m, params, batch_slots=2, max_seq=64)
    reqs = [Request(f"r{i}", (np.arange(4 + i) % 256).astype(np.int32),
                    max_new_tokens=6) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert all(len(r.output) == 6 for r in reqs)


def test_continuous_batching_matches_isolated():
    """Tokens generated with slot-sharing must equal a private engine run."""
    m, params, cfg = _model()
    prompts = [(np.arange(5) % 256).astype(np.int32),
               (np.arange(7)[::-1] % 256).astype(np.int32),
               ((np.arange(6) * 3) % 256).astype(np.int32)]
    solo_out = []
    for i, p in enumerate(prompts):
        eng = _engine(m, params, batch_slots=1, max_seq=64)
        r = Request(f"solo{i}", p, max_new_tokens=5)
        eng.submit(r)
        eng.run_until_done()
        solo_out.append(r.output)
    # shared: all three through 2 slots (forces queueing + slot reuse)
    eng = _engine(m, params, batch_slots=2, max_seq=64)
    reqs = [Request(f"shared{i}", p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    for r, expect in zip(reqs, solo_out):
        assert r.output == expect, "continuous batching changed results"


def test_eos_frees_slot():
    m, params, cfg = _model()
    eng = _engine(m, params, batch_slots=1, max_seq=64)
    probe = Request("probe", np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.submit(probe)
    eng.run_until_done()
    eos = probe.output[0]
    eng2 = _engine(m, params, batch_slots=1, max_seq=64)
    r = Request("r", np.arange(5, dtype=np.int32), max_new_tokens=50, eos_id=eos)
    eng2.submit(r)
    eng2.run_until_done()
    assert r.done and len(r.output) <= 2


def _requests(cls, cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 40))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        out.append(cls(f"r{i:03d}", prompt, max_new_tokens=int(rng.integers(3, 9))))
    return out


def test_reference_and_port_serve_identical_greedy_tokens():
    rc = ref_reduced("falcon_mamba_7b")
    rm = RefModel(rc)
    rp = rm.init(jax.random.PRNGKey(0))
    kw = {f.name: getattr(rc, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name not in PORT_FIELDS}
    pm = Model(ModelConfig(**{**kw, "dtype": torch.float32}))
    pp = convert.model_params(rp, "cpu")

    ref_eng = RefEngine(rm, rp, RefServeConfig(batch_slots=3, max_seq=64))
    port_eng = ServingEngine(pm, pp, ServeConfig(batch_slots=3, max_seq=64),
                             device="cpu")
    ref_reqs = _requests(RefRequest, rc, 7, seed=1)
    port_reqs = _requests(Request, rc, 7, seed=1)
    for r in ref_reqs:
        ref_eng.submit(r)
    for r in port_reqs:
        port_eng.submit(r)
    ref_eng.run_until_done()
    trace.reset()
    with trace.enable():
        port_eng.run_until_done()
    decode = trace.spans("engine.decode")
    trace.reset()
    # on the CPU every decode step launches its layers eagerly
    assert decode and {s.attrs["graph"] for s in decode} == {"eager"}
    assert all(r.done for r in port_reqs)
    for r, p in zip(ref_reqs, port_reqs):
        assert p.output == r.output, r.request_id
        assert len(p.output) == r.max_new_tokens


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_9b"])
def test_serve_launcher_on_cpu(arch, capsys):
    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--json",
                     "--requests", "3", "--max-new", "4", "--max-seq", "48"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["unfinished"] == [] and line["tokens"] == 12
    assert line["device"] == "cpu"


def test_serve_launcher_reports_unfinished_requests(monkeypatch, capsys):
    """A request left unfinished is named by its request_id and the launcher
    returns 1 (the reference reads a missing ``r.rid`` there)."""
    monkeypatch.setattr(ServingEngine, "run_until_done",
                        lambda self, max_steps=10_000: None)
    rc = serve.main(["--arch", "falcon_mamba_7b", "--reduced", "--device",
                     "cpu", "--requests", "2"])
    assert rc == 1
    assert "2 request(s) never finished: r000, r001" in capsys.readouterr().err
