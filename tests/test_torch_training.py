"""Training substrate of the port against the JAX package.

Optimizers, schedules, the data pipeline, int8 compression and the train
step, fed the same seeded numpy inputs in both packages (params through
``repro_torch.convert.model_params``, optimizer state through
``convert.optimizer_state``).  Tolerances: the optimizers 1e-6 (the same
float32 operations in the same order; reductions and ``pow`` may round
apart in the last place); a train step of a reduced model 1e-5 relative on
the loss, 1e-4 on the grad norm and 1e-5 on the params, since the
reference scans with ``linear_scan_associative`` and the port with the
sequential loop, which sum in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticTokens as RefTokens  # noqa: E402
from repro.distributed.compression import compress as ref_compress  # noqa: E402
from repro.distributed.compression import decompress as ref_decompress  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.training import adafactor as ref_adafactor  # noqa: E402
from repro.training import adamw as ref_adamw  # noqa: E402
from repro.training import apply_updates as ref_apply  # noqa: E402
from repro.training import clip_by_global_norm as ref_clip  # noqa: E402
from repro.training import constant as ref_constant  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa: E402
from repro.training import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.store import tree_flatten  # noqa: E402
from repro_torch.configs import info, reduced  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens, prefetch  # noqa: E402
from repro_torch.kernels.adamw import ref as adamw_ref  # noqa: E402
from repro_torch.distributed import compress, decompress, init_error  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import (adafactor, adamw, apply_updates,  # noqa: E402
                                  clip_by_global_norm, constant, global_norm,
                                  make_accum_steps, make_eval_step,
                                  make_train_step, warmup_cosine)
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.trainer import _grad_fn  # noqa: E402

OPT_TOL = 1e-6


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu() if torch.is_tensor(tree) else tree)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assert_trees(a, b, *, atol, rtol=0.0, msg=""):
    la, lb = tree_flatten(_np_tree(a))[0], tree_flatten(_np_tree(b))[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64),
                                   atol=atol, rtol=rtol, err_msg=msg)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": {"k": rng.standard_normal((3, 4, 7)).astype(np.float32),
                      "b": rng.standard_normal((7,)).astype(np.float32)}}


def _grads(seed):
    rng = np.random.default_rng(seed)
    return _map_np(lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32),
                   _params(0))


def _map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_np(fn, v) for k, v in tree.items()}
    return fn(tree)


def _jnp(tree):
    return _map_np(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": (lambda lr: ref_adamw(lr), lambda lr: adamw(lr)),
    "adamw_no_decay": (lambda lr: ref_adamw(lr, weight_decay=0.0),
                       lambda lr: adamw(lr, weight_decay=0.0)),
    "adafactor": (lambda lr: ref_adafactor(lr), lambda lr: adafactor(lr)),
    "adafactor_decay": (lambda lr: ref_adafactor(lr, weight_decay=0.1),
                        lambda lr: adafactor(lr, weight_decay=0.1)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_three_updates_match(name, clip):
    ref_f, port_f = OPTIMIZERS[name]
    ref_opt = ref_f(ref_warmup_cosine(1e-2, 2, 10))
    opt = port_f(warmup_cosine(1e-2, 2, 10))
    rp = _jnp(_params(1))
    pp = convert.model_params(_params(1), device="cpu")
    rs, ps = ref_opt.init(rp), opt.init(pp)
    _assert_trees(rs, convert.optimizer_state(_np_tree(ps), device="cpu"), atol=0)
    for step in range(3):
        g = _grads(10 + step)
        rg, pg = _jnp(g), convert.model_params(g, device="cpu")
        scale = None
        if clip is not None:
            rg, _ = ref_clip(rg, clip)
            _, norm = clip_by_global_norm(pg, clip)
            scale = opt_mod.clip_factor(norm, clip)
        ru, rs = ref_opt.update(rg, rs, rp, jnp.int32(step))
        pu, ps = opt.update(pg, ps, pp, step, scale=scale)
        _assert_trees(ru, pu, atol=OPT_TOL, msg=f"updates, step {step}")
        rp = ref_apply(rp, ru)
        pp = apply_updates(pp, pu)
        _assert_trees(rp, pp, atol=OPT_TOL, msg=f"params, step {step}")
    _assert_trees(rs, ps, atol=OPT_TOL, msg="state")


def test_adafactor_state_is_factored():
    opt = adafactor(constant(1e-3))
    state = opt.init({"w": torch.zeros((64, 32)), "b": torch.zeros((32,))})
    assert state["stats"]["w"]["vr"].shape == (64,)
    assert state["stats"]["w"]["vc"].shape == (32,)
    assert state["stats"]["b"]["v"].shape == (32,)


def test_adamw_minimizes_quadratic():
    opt = adamw(constant(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for i in range(200):
        updates, state = opt.update({"w": 2 * params["w"]}, state, params, i)
        params = apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 1e-2


def test_clip_by_global_norm_matches():
    g = {"a": np.full((10,), 10.0, np.float32), "b": np.arange(6, dtype=np.float32)}
    rc, rn = ref_clip(_jnp(g), 1.0)
    pc, pn = clip_by_global_norm(convert.model_params(g, device="cpu"), 1.0)
    assert float(pn) == pytest.approx(float(rn), rel=1e-6)
    _assert_trees(rc, pc, atol=1e-7)
    assert float(global_norm(pc)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((10,), 1e-3)}
    same, _ = clip_by_global_norm(small, 1.0)
    assert torch.equal(same["a"], small["a"])


def test_bf16_clip_is_float32_as_in_the_reference():
    g = {"w": (np.random.default_rng(0).standard_normal((4, 8)) * 3).astype(np.float32)}
    rg = {"w": jnp.asarray(g["w"], jnp.bfloat16)}
    pg = {"w": torch.from_numpy(g["w"]).to(torch.bfloat16)}
    rc, rn = ref_clip(rg, 1.0)
    pc, pn = clip_by_global_norm(pg, 1.0)
    assert rc["w"].dtype == jnp.float32 and pc["w"].dtype == torch.float32
    np.testing.assert_allclose(pc["w"].numpy(), np.asarray(rc["w"]), rtol=1e-6)


def test_pieces_cut_the_leading_axis(monkeypatch):
    """AdamW and the norm over pieces of a leaf equal them over the whole
    leaf: force pieces of one row (the plain versions' ``CHUNK``)."""
    monkeypatch.setattr(adamw_ref, "CHUNK", 1)
    ref_opt = ref_adamw(ref_constant(1e-2))
    opt = adamw(constant(1e-2))
    rp, pp = _jnp(_params(2)), convert.model_params(_params(2), device="cpu")
    g = _grads(3)
    ru, _ = ref_opt.update(_jnp(g), ref_opt.init(rp), rp, jnp.int32(0))
    pu, _ = opt.update(convert.model_params(g, device="cpu"), opt.init(pp), pp, 0)
    _assert_trees(ru, pu, atol=OPT_TOL)
    assert float(global_norm(convert.model_params(g, device="cpu"))) == \
        pytest.approx(float(jnp.sqrt(sum(jnp.sum(jnp.square(x))
                                         for x in jax.tree.leaves(_jnp(g))))), rel=1e-6)


@pytest.mark.parametrize("args", [(1e-3, 100, 1000), (3e-4, 3, 8), (3e-4, 6, 20)])
def test_warmup_cosine_matches(args):
    ref_lr, lr = ref_warmup_cosine(*args), warmup_cosine(*args)
    for step in range(args[2] + 3):
        assert lr(step) == pytest.approx(float(ref_lr(jnp.int32(step))),
                                         rel=1e-6, abs=0)
    assert lr(0) < lr(args[1] - 1)
    assert constant(0.1)(7) == float(ref_constant(0.1)(jnp.int32(7)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_sharded_and_equal_to_reference():
    cfg = dict(vocab_size=1000, seq_len=32, global_batch=8)
    d1, d2 = SyntheticTokens(DataConfig(**cfg)), SyntheticTokens(DataConfig(**cfg))
    np.testing.assert_array_equal(d1.batch(5)["tokens"], d2.batch(5)["tokens"])
    ref = RefTokens(RefDataConfig(**cfg)).batch(5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(d1.batch(5)[k], ref[k])
    h0 = SyntheticTokens(DataConfig(**cfg, n_hosts=2, host_id=0)).batch(3)
    h1 = SyntheticTokens(DataConfig(**cfg, n_hosts=2, host_id=1)).batch(3)
    assert h0["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_labels_shift():
    b = SyntheticTokens(DataConfig(vocab_size=100, seq_len=16, global_batch=2)).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetch_preserves_order():
    out = [int(b["x"]) for b in prefetch(iter([{"x": np.array(i)} for i in range(10)]),
                                         depth=3)]
    assert out == list(range(10))


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_int8_compression_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(0, 1e-2, (257, 33)).astype(np.float32),
         "b": {"v": rng.normal(0, 1.0, (5000,)).astype(np.float32)}}
    e = _map_np(lambda x: rng.normal(0, 1e-4, x.shape).astype(np.float32), g)
    rc, re_ = ref_compress(_jnp(g), _jnp(e))
    pc, pe = compress(convert.model_params(g, device="cpu"),
                      convert.model_params(e, device="cpu"))
    for path in (("w",), ("b", "v")):
        r, p = rc, pc
        for k in path:
            r, p = r[k], p[k]
        np.testing.assert_array_equal(p["q"].numpy(), np.asarray(r["q"]))
        np.testing.assert_allclose(p["scale"].numpy(), np.asarray(r["scale"]), rtol=1e-7)
        assert p["shape"] == tuple(r["shape"])
    _assert_trees(re_, pe, atol=1e-9)
    _assert_trees(ref_decompress(rc), decompress(pc), atol=1e-9)
    # per-block int8: |error| <= max|g| / 127; the feedback is the residual
    deq = decompress(compress({"w": torch.from_numpy(g["w"])},
                              init_error({"w": torch.from_numpy(g["w"])}))[0])
    assert float((deq["w"] - torch.from_numpy(g["w"])).abs().max()) <= \
        float(np.abs(g["w"]).max()) / 127.0 + 1e-8


def test_error_feedback_reduces_bias():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(0, 1e-3, (64,))
                               .astype(np.float32))}
    err, acc = init_error(g), torch.zeros(64)
    for _ in range(50):
        comp, err = compress(g, err)
        acc = acc + decompress(comp)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(),
                               atol=float(g["w"].abs().max()) / 40)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

ARCHES = ["falcon_mamba_7b", "recurrentgemma_9b"]


def _batches(cfg, n, b=4, s=16):
    data = RefTokens(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                   global_batch=b))
    return [data.batch(i) for i in range(n)]


def _ref_run(arch, steps, batches):
    """The reference: params from PRNGKey(0), AdamW, clip 1.0, remat."""
    model = RefModel(ref_reduced(arch))
    params = model.init(jax.random.PRNGKey(0))
    opt = ref_adamw(ref_warmup_cosine(3e-4, 2, 8))
    state = opt.init(params)
    init = (_np_tree(params), _np_tree(state))
    step_fn = jax.jit(ref_make_train_step(model, opt))
    metrics, snaps = [], []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in batches[i].items()}
        params, state, m = step_fn(params, state, b, jnp.int32(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        snaps.append((_np_tree(params), _np_tree(state)))
    return init, metrics, snaps


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHES)
def ref_run(request):
    arch = request.param
    batches = _batches(ref_reduced(arch), 3)
    return arch, batches, _ref_run(arch, 3, batches)


def test_train_steps_match_reference(ref_run):
    arch, batches, (init, metrics, snaps) = ref_run
    assert info(arch).optimizer == "adamw"
    model = Model(reduced(arch))
    params = convert.model_params(init[0], device="cpu")
    opt = adamw(warmup_cosine(3e-4, 2, 8))
    state = opt.init(params)
    step = make_train_step(model, opt)
    for i in range(2):
        params, state, m = step(params, state, _torch_batch(batches[i]), i)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        assert m["loss"].dtype == m["grad_norm"].dtype == torch.float32
        assert loss == pytest.approx(metrics[i][0], rel=1e-5), i
        assert gnorm == pytest.approx(metrics[i][1], rel=1e-4), i
        _assert_trees(snaps[i][0], params, atol=1e-5, msg=f"params after {i}")
        assert m["step"] == i + 1


def test_eval_step_matches_reference(ref_run):
    """The eval loss of the initial params on batch 0 is the loss the
    reference's first train step reports (computed before its update)."""
    arch, batches, (init, metrics, _) = ref_run
    eval_step = make_eval_step(Model(reduced(arch)))
    loss = eval_step(convert.model_params(init[0], device="cpu"),
                     _torch_batch(batches[0]))
    assert loss.dtype == torch.float32 and loss.grad_fn is None
    assert float(loss) == pytest.approx(metrics[0][0], rel=1e-5)


def test_jax_train_state_resumes_in_the_port(ref_run):
    """Params and AdamW state after the reference's step 2, carried over,
    take step 3 in the port as the reference does."""
    arch, batches, (_, metrics, snaps) = ref_run
    params = convert.model_params(snaps[1][0], device="cpu")
    state = convert.optimizer_state(snaps[1][1], device="cpu")
    assert set(state) == {"m", "v"}
    opt = adamw(warmup_cosine(3e-4, 2, 8))
    step = make_train_step(Model(reduced(arch)), opt)
    params, state, m = step(params, state, _torch_batch(batches[2]), 2)
    assert float(m["loss"]) == pytest.approx(metrics[2][0], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(metrics[2][1], rel=1e-4)
    _assert_trees(snaps[2][0], params, atol=1e-5)
    _assert_trees(snaps[2][1], state, atol=1e-6)


def test_grads_of_bf16_params_are_bf16():
    cfg = reduced("falcon_mamba_7b").replace(dtype=torch.bfloat16)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    loss, grads = _grad_fn(model, attn_impl="auto", remat=True)(
        params, _torch_batch(_batches(cfg, 1)[0]))
    assert loss.dtype == torch.float32
    for p, g in zip(tree_flatten(params)[0], tree_flatten(grads)[0]):
        assert g.dtype == p.dtype and g.shape == p.shape
    assert not any(p.requires_grad for p in tree_flatten(params)[0])


@pytest.mark.parametrize("arch", ARCHES)
def test_microbatches_and_external_accumulation_agree(arch):
    """microbatches=2 against 1: the same loss, grad norm and gradients (the
    sums of two halves, in float32).  make_accum_steps over the two halves
    runs microbatches=2's arithmetic: the same loss, norm and params, bit
    for bit.  (After an AdamW update the params of 1 and 2 microbatches are
    not compared: its first step is lr·g/(|g| + eps), which turns a rounding
    difference in a gradient near eps into one of up to 2·lr.)"""
    cfg = reduced(arch)
    model = Model(cfg)
    params0 = model.init(0, device="cpu")
    batch = _torch_batch(_batches(cfg, 1, b=4)[0])
    halves = [{k: v[h] for k, v in batch.items()} for h in (slice(0, 2), slice(2, 4))]
    micro, _ = make_accum_steps(model, adamw(constant(1e-2)),
                                accum_dtype=torch.float32)
    whole, loss1 = micro(params0, _map_zeros(params0), batch)
    acc = _map_zeros(params0)
    losses = []
    for half in halves:
        acc, loss = micro(params0, acc, half)
        losses.append(loss)
    assert float((losses[0] + losses[1]) / 2) == pytest.approx(float(loss1), rel=1e-5)
    _assert_trees(whole, _map_halved(acc), atol=1e-6)

    runs = []
    for mb in (1, 2):
        opt = adamw(constant(1e-2))
        params = _clone(params0)
        step = make_train_step(model, opt, microbatches=mb)
        params, _, m = step(params, opt.init(params), batch, 0)
        runs.append((params, m["loss"], m["grad_norm"]))
    assert float(runs[1][1]) == pytest.approx(float(runs[0][1]), rel=1e-5)
    assert float(runs[1][2]) == pytest.approx(float(runs[0][2]), rel=1e-5)

    opt = adamw(constant(1e-2))
    params = _clone(params0)
    micro2, apply_step = make_accum_steps(model, opt, accum_dtype=torch.float32,
                                          microbatches=2)
    acc = _map_zeros(params)
    losses = []
    for half in halves:
        acc, loss = micro2(params, acc, half)
        losses.append(loss)
    params, _, m = apply_step(params, opt.init(params), acc, 0)
    assert torch.equal((losses[0] + losses[1]) / 2, runs[1][1])
    assert torch.equal(m["grad_norm"], runs[1][2])
    for a, b in zip(tree_flatten(params)[0], tree_flatten(runs[1][0])[0]):
        assert torch.equal(a, b)


def _map_halved(tree):
    if isinstance(tree, dict):
        return {k: _map_halved(v) for k, v in tree.items()}
    return tree / 2


def _map_zeros(tree):
    if isinstance(tree, dict):
        return {k: _map_zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32)
