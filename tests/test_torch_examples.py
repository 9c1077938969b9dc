"""The port's examples against the JAX package's, on the CPU.

``examples/{cluster_study,serve_batch,train_100m}_torch.py`` run here with
``device="cpu"`` passed through their own arguments; the reference
examples are loaded by path and left as they are (a test may patch a
loaded module's ``build_model`` or scheduler).  Tolerances:

- the cluster study prints the same tables, byte for byte, at a horizon cut
  to 150 (failures 225): the port's host path (``impl=None``: host numpy
  and the per-window host loop) against the reference's default, and the
  port's plain torch versions ("torch", float32) against the reference
  with its jnp backends ("ref", float32) forced;
- batched serving gives the same tokens, every one, through "auto" and
  "pallas" (the flash-attention kernel's plain version here), from the
  reference's params carried across; the printed lines are equal but for
  the wall time and tokens/s;
- the 100M-parameter example at a tiny config, params and optimizer state
  carried across: per-step losses within 1e-5 relative (the same float32
  operations; reductions may round apart in the last place), the same
  steps done, a falling loss, and a resume that restores the saved tree
  bit for bit and continues as a run that never stopped.  Chunk counts and
  ρ follow the wall clock and are not compared.
"""
import contextlib
import importlib.util
import io
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.store import tree_flatten
from repro_torch.models import ModelConfig

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

#: the cluster study's horizon here; the failure section runs 1.5x as long
T_END = 150.0
LOSS_RTOL = 1e-5


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


# ---------------------------------------------------------------------------
# cluster study
# ---------------------------------------------------------------------------

SECTIONS = {
    "steady": ("run", dict(title="steady state (heterogeneous MIG pool)",
                           t_end=T_END)),
    "failures": ("run", dict(
        title="with slice failures (MTBF ~5.5 min, repair 50 s)",
        t_end=1.5 * T_END, failure_rate=0.003)),
    "presets": ("run_presets", dict(t_end=T_END)),
    "strategies": ("run_strategies", dict(t_end=T_END)),
}


@pytest.fixture(scope="module")
def study():
    return _load("cluster_study"), _load("cluster_study_torch")


def _ref_forced(ref_mod):
    """The reference study's JASDA schedulers with the jnp backends
    ("ref") forced for scoring and settling."""
    from repro.core import JasdaScheduler, Policy
    from repro.core.scheduler import SchedulerConfig

    def forced(slices, config=None):
        policy = Policy() if config is None else config
        return JasdaScheduler(slices, SchedulerConfig.from_policy(
            policy, score_impl="ref", wis_impl="ref"))

    return forced


@pytest.fixture(scope="module")
def ref_tables(study):
    """Each section's table from the reference: default and "ref" forced."""
    ref, _ = study
    out = {}
    for name, (fn, kw) in SECTIONS.items():
        out[name, "default"] = _printed(getattr(ref, fn), **kw)[1]
    default = ref.JasdaScheduler
    ref.JasdaScheduler = _ref_forced(ref)
    try:
        for name, (fn, kw) in SECTIONS.items():
            out[name, "ref"] = _printed(getattr(ref, fn), **kw)[1]
    finally:
        ref.JasdaScheduler = default
    return out


@pytest.mark.parametrize("section", SECTIONS)
@pytest.mark.parametrize("impl,against", [(None, "default"), ("torch", "ref")])
def test_cluster_study_tables_match_reference(study, ref_tables, section,
                                              impl, against):
    """The port's host path prints the reference's default tables; its
    plain torch backends print the reference's tables with "ref" forced."""
    _, port = study
    fn, kw = SECTIONS[section]
    text = _printed(getattr(port, fn), device="cpu", impl=impl, **kw)[1]
    assert text == ref_tables[section, against]
    assert re.search(r"\d+/240", text) or "strategy" in text


def test_cluster_study_torch_equals_reference_default(ref_tables):
    """At this horizon the float32 backends and host float64 also agree:
    the reference's "ref" tables are its default ones."""
    for name in SECTIONS:
        assert ref_tables[name, "ref"] == ref_tables[name, "default"], name


def test_cluster_study_forces_the_device_backends(study, monkeypatch):
    """Every JASDA scheduler of the study asks for the device backends on
    the device it is given; the baselines stay on the host."""
    _, port = study
    made = []
    jasda = port.jasda

    def recorded(policy, device, impl):
        sched = jasda(policy, device, impl)
        made.append(sched)
        return sched

    monkeypatch.setattr(port, "jasda", recorded)
    names = {name: mk("cpu", "torch") for name, mk in port.SYSTEMS}
    assert type(names["FIFO"]).__name__ == "FifoScheduler"
    assert len(made) == 1
    for sched in made:
        assert sched.config.score_impl == sched.config.wis_impl == "torch"
        assert sched.config.device == "cpu"
    assert [name for name, _ in port.PRESETS] == [
        "balanced", "utilization", "fairness", "responsive"]


# ---------------------------------------------------------------------------
# batched serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_reference():
    """The reference example's requests, printed lines and params."""
    ref = _load("serve_batch")
    made = []

    class Recorded(ref.Request):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    ref.Request = Recorded
    _, text = _printed(ref.main)
    cfg = ref.ModelConfig(name="serve-demo", family="dense", n_layers=4,
                          d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
                          vocab_size=1024, model_axis_size=1,
                          dtype=jnp.float32)
    params = ref.Model(cfg).init(jax.random.PRNGKey(0))
    return made, text, params


def _without_speed(text: str) -> str:
    return re.sub(r"\([\d.]+s, [\d.]+ tok/s on ", "(", text)


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_serve_batch_matches_reference(served_reference, attn_impl,
                                       monkeypatch):
    """The 10 requests' outputs equal the reference's token for token, and
    the printed lines equal its lines but for wall time and tokens/s.
    Through "pallas" every prefill's attention, 4 layers a prefill, takes
    the flash-attention path (40 calls), and no decode step does."""
    ref_reqs, ref_text, ref_params = served_reference
    port = _load("serve_batch_torch")
    from repro_torch.models import Model
    from repro_torch.models import layers

    calls = []
    flash = layers.flash_attention

    def counted(q, *args, **kw):
        calls.append(tuple(q.shape))
        return flash(q, *args, **kw)

    monkeypatch.setattr(layers, "flash_attention", counted)
    model = Model(port.build_model())
    params = convert.model_params(ref_params, "cpu")
    (reqs, steps, wall), text = _printed(port.run, model, params,
                                         device="cpu", attn_impl=attn_impl)
    assert [r.request_id for r in reqs] == [r.request_id for r in ref_reqs]
    assert [list(r.prompt) for r in reqs] == [list(r.prompt) for r in ref_reqs]
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert all(len(r.output) == 16 for r in reqs)
    assert "tok/s on CPU)" in text
    lens = [len(r.prompt) for r in reqs]
    if attn_impl == "pallas":
        assert sorted(calls) == sorted((1, 8, n, 16) for n in lens
                                       for _ in range(4))
    else:
        assert calls == []
    assert _without_speed(text) == _without_speed(ref_text)


def test_serve_batch_config_is_the_reference_config(served_reference):
    """The port's decoder has the reference's widths: its params take the
    reference's leaf for leaf (head dim 16, the K4 shape on the card)."""
    _, _, ref_params = served_reference
    port = _load("serve_batch_torch")
    from repro_torch.models import Model

    cfg = port.build_model()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.dtype) == (4, 128, 8, 4, 16, torch.float32)
    mine = tree_flatten(Model(cfg).init(0, device="cpu"))[0]
    carried = tree_flatten(convert.model_params(ref_params, "cpu"))[0]
    assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in carried]


# ---------------------------------------------------------------------------
# 100M-parameter training at a tiny config
# ---------------------------------------------------------------------------

TINY = dict(name="lm-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
            model_axis_size=1)
FIRST, TOTAL, BATCH, SEQ = 8, 14, 8, 64


def _train_argv(steps: int, ckpt: Path):
    return ["--steps", str(steps), "--batch", str(BATCH), "--seq", str(SEQ),
            "--ckpt-dir", str(ckpt)]


@pytest.fixture(scope="module")
def ref_training(tmp_path_factory):
    """The reference example at the tiny config: a first run, a resumed
    one on its directory, and its initial params and optimizer state."""
    ref = _load("train_100m")
    ref.build_model = lambda: ref.ModelConfig(**TINY, dtype=jnp.float32)
    params = ref.Model(ref.build_model()).init(jax.random.PRNGKey(0))
    opt_state = ref.adamw(ref.warmup_cosine(3e-4, 50, FIRST)).init(params)
    losses = []

    def jit(fn):
        step = jax.jit(fn)

        def recorded(*args):
            out = step(*args)
            losses.append(float(out[2]["loss"]))
            return out

        return recorded

    ref.jax = types.SimpleNamespace(jit=jit, random=jax.random, tree=jax.tree)
    ckpt = tmp_path_factory.mktemp("ref_ckpt")
    runs = []
    argv = sys.argv
    try:
        for steps in (FIRST, TOTAL):
            losses.clear()
            sys.argv = ["train_100m.py"] + _train_argv(steps, ckpt)
            _, text = _printed(ref.main)
            runs.append((list(losses), text))
    finally:
        sys.argv = argv
    return runs, params, opt_state


def _port_training(ref_params, ref_opt_state, monkeypatch):
    port = _load("train_100m_torch")
    monkeypatch.setattr(port, "build_model",
                        lambda: ModelConfig(**TINY, dtype=torch.float32))
    monkeypatch.setattr(port, "init_params", lambda model, device:
                        convert.model_params(ref_params, device))
    adamw = port.adamw

    def carried(lr):
        opt = adamw(lr)
        return opt._replace(
            init=lambda params: convert.optimizer_state(ref_opt_state, "cpu"))

    monkeypatch.setattr(port, "adamw", carried)
    return port


def _done(text: str) -> int:
    return int(re.search(r"done: (\d+) steps", text).group(1))


def test_train_100m_matches_reference(ref_training, tmp_path, monkeypatch):
    """Both runs (the first and the resumed one) lose what the reference
    loses step for step, do as many steps, and the loss falls."""
    runs, ref_params, ref_opt_state = ref_training
    port = _port_training(ref_params, ref_opt_state, monkeypatch)
    # the carried state is the port's own initial one
    from repro_torch.training import adamw

    own = adamw(lambda s: 0.0).init(convert.model_params(ref_params, "cpu"))
    carried = convert.optimizer_state(ref_opt_state, "cpu")
    for a, b in zip(tree_flatten(own)[0], tree_flatten(carried)[0]):
        assert torch.equal(a, b)
    for steps, (ref_losses, ref_text) in zip((FIRST, TOTAL), runs):
        rec, text = _printed(port.main, _train_argv(steps, tmp_path)
                             + ["--device", "cpu"])
        assert rec["job"].steps_done == _done(ref_text) == len(ref_losses)
        np.testing.assert_allclose(rec["losses"], ref_losses, rtol=LOSS_RTOL)
        assert rec["losses"][-1] < rec["losses"][0]
        assert ("resumed from checkpoint step" in text) == (steps == TOTAL)
        assert text.splitlines()[0] == ref_text.splitlines()[0]


def test_train_100m_resume_is_bit_exact(ref_training, tmp_path, monkeypatch):
    """The store gives back the first run's final state bit for bit, and
    the resumed run's losses are those of a run that never stopped."""
    _, ref_params, ref_opt_state = ref_training
    port = _port_training(ref_params, ref_opt_state, monkeypatch)
    first, _ = _printed(port.main, _train_argv(FIRST, tmp_path / "a")
                        + ["--device", "cpu"])
    restored, step = first["store"].restore(first["state"])
    assert step == FIRST
    saved, back = tree_flatten(first["state"])[0], tree_flatten(restored)[0]
    assert len(saved) == len(back) == 3 * len(tree_flatten(ref_params)[0])
    for a, b in zip(saved, back):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    resumed, text = _printed(port.main, _train_argv(TOTAL, tmp_path / "a")
                             + ["--device", "cpu"])
    assert f"resumed from checkpoint step {FIRST}" in text
    assert resumed["start"] == FIRST
    assert resumed["job"].steps_done == TOTAL - FIRST
    whole, _ = _printed(port.main, _train_argv(TOTAL, tmp_path / "b")
                        + ["--device", "cpu"])
    assert whole["losses"] == first["losses"] + resumed["losses"]


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cluster_study_torch", "serve_batch_torch",
                                  "train_100m_torch"])
def test_examples_ask_for_the_card(name, monkeypatch, tmp_path):
    """Without ``--device`` each example asks for the card and raises
    where there is none; it never moves to the host by itself."""
    mod = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_100m_torch" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
