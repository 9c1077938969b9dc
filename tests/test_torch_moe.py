"""The MoE family of the port against the JAX package.

``moe_ffn`` is held to ``repro.models.moe.moe_ffn`` on seeded numpy inputs:
routing (expert indices, slots, the keep mask) exactly, the output within
1e-5 and the aux loss within 1e-6.  The reference's routing is read from
its own calls, run eagerly: ``jax.lax.top_k`` returns its expert indices
and the first argument of its bfloat16 ``jax.nn.one_hot`` is its slot
array.  The reduced MoE configs are held to the reference model as
``tests/test_torch_models.py`` holds the other families (atol 3e-4), and
their loss with the aux term and its gradients within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro_torch import convert
from repro_torch.configs import reduced
from repro_torch.models import Model, ModelConfig
from repro_torch.models.config import PORT_FIELDS
from repro_torch.models.moe import moe_ffn, route
from repro_torch.training.trainer import _grad_fn

ATOL = 3e-4
ARCHS = ("olmoe_1b_7b", "granite_moe_3b_a800m")


def port_config(cfg) -> ModelConfig:
    """The reference config as the port's: its fields, torch's dtype."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name not in PORT_FIELDS}
    kw["dtype"] = getattr(torch, jnp.dtype(cfg.dtype).name)
    return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# moe_ffn alone
# ---------------------------------------------------------------------------

B, S, D, E, FE, GROUP = 2, 32, 16, 8, 24, 16

#: (gated, act, top_k, capacity_factor, tied router columns)
SETTINGS = {
    "gated_silu": (True, "silu", 2, 1.25, ()),
    "plain_gelu": (False, "gelu", 2, 1.25, ()),
    "tight_capacity": (True, "silu", 3, 0.5, ()),
    "tied_router": (True, "silu", 2, 1.25, (1, 4, 6)),
}


def _ffn_inputs(seed, tied):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.5,
         "w_gate": rng.standard_normal((E, D, FE)).astype(np.float32) / 4,
         "w_up": rng.standard_normal((E, D, FE)).astype(np.float32) / 4,
         "w_down": rng.standard_normal((E, FE, D)).astype(np.float32) / 5}
    if tied:  # equal columns, scaled up: where they lead, ties fall both
        col = p["router"][:, tied[0]] * 3  # inside the top k and at its edge
        for e in tied:
            p["router"][:, e] = col
    return x, p


def _ref_routing(monkeypatch, x, p, **kw):
    """The reference's output, aux, expert indices and slots, read from its
    ``jax.lax.top_k`` and bfloat16 ``jax.nn.one_hot`` calls."""
    seen = {}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def spy_top_k(operand, k):
        vals, idx = top_k(operand, k)
        seen["expert"] = np.asarray(idx)
        return vals, idx

    def spy_one_hot(a, n, *args, **kwargs):
        if kwargs.get("dtype") == jnp.bfloat16:
            seen["slot"], seen["cap"] = np.asarray(a), n
        return one_hot(a, n, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    out, aux = ref_moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                           group_size=GROUP, **kw)
    monkeypatch.undo()
    return np.asarray(out), float(aux), seen


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_moe_ffn_matches_reference(setting, monkeypatch):
    gated, act, top_k, cf, tied = SETTINGS[setting]
    x, p = _ffn_inputs(3, tied)
    kw = dict(top_k=top_k, capacity_factor=cf, act=act, gated=gated)
    ref_out, ref_aux, seen = _ref_routing(monkeypatch, x, p, **kw)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, aux = moe_ffn(torch.from_numpy(x), tp, group_size=GROUP, **kw)
    r = route(torch.from_numpy(x).reshape(-1, GROUP, D), tp["router"],
              top_k=top_k, capacity_factor=cf)

    assert r.capacity == seen["cap"]
    np.testing.assert_array_equal(r.expert.numpy(), seen["expert"])
    np.testing.assert_array_equal(r.slot.numpy(), seen["slot"])
    np.testing.assert_array_equal(r.keep.numpy(), seen["slot"] < seen["cap"])
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-5)
    assert abs(aux.item() - ref_aux) <= 1e-6
    if setting == "tight_capacity":
        assert 0 < int((~r.keep).sum()) < r.keep.numel()  # some choices drop
    if setting == "tied_router":
        # where the three tied experts lead, the two lower indices win, in order
        lead = r.expert.reshape(-1, 2).numpy()
        assert (lead == [tied[0], tied[1]]).all(axis=1).mean() > 0.3
        assert not (lead == tied[2]).any()


def test_decode_shape_keeps_every_choice():
    """S = 1: one-token groups, capacity 1, nothing dropped."""
    x, p = _ffn_inputs(5, ())
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    r = route(torch.from_numpy(x[:, :1]).reshape(B, 1, D), tp["router"],
              top_k=2, capacity_factor=1.25)
    assert r.capacity == 1 and bool(r.keep.all())
    out, _ = moe_ffn(torch.from_numpy(x[:, :1]), tp, top_k=2)
    ref, _ = ref_moe_ffn(jnp.asarray(x[:, :1]),
                         {k: jnp.asarray(v) for k, v in p.items()}, top_k=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bf16_moe_ffn_within_a_bf16_step():
    """bfloat16 activations and experts: the products round in other places
    in the two frameworks, so the output is held to one bf16 step of its
    scale; the routing (float32 router) is the same."""
    x, p = _ffn_inputs(7, ())
    xb = jnp.asarray(x, jnp.bfloat16)
    rp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
          for k, v in p.items()}
    ref, _ = ref_moe_ffn(xb, rp, top_k=2, group_size=GROUP)
    tp = convert.model_params(rp, "cpu")
    out, _ = moe_ffn(convert.model_params({"x": xb}, "cpu")["x"], tp,
                     top_k=2, group_size=GROUP)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2 ** -7 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the reduced MoE configs against the reference model
# ---------------------------------------------------------------------------

NB, NS, PROMPT = 2, 24, 16


def _np(x):
    return np.asarray(x, np.float64)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Reference and port outputs for one reduced MoE config: forward over
    NS tokens, prefill of PROMPT tokens, then NS - PROMPT decode steps."""
    rc = ref_reduced(request.param)
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(1))
    pp = convert.model_params(rp, "cpu")
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (NB, NS)).astype(np.int32)
    out = {"name": request.param}
    r_logits, r_aux = rm.forward(rp, jnp.asarray(toks), remat=False)
    p_logits, p_aux = pm.forward(pp, torch.from_numpy(toks))
    out["forward"] = (_np(r_logits), p_logits.double().numpy(), float(r_aux),
                      p_aux.item())
    rl, rc_, _ = rm.prefill(rp, jnp.asarray(toks[:, :PROMPT]), max_seq=NS)
    pl, pc, _ = pm.prefill(pp, torch.from_numpy(toks[:, :PROMPT]), max_seq=NS)
    out["prefill"] = (_np(rl), pl.double().numpy())
    out["cache"] = (jax.tree.leaves(rc_), [c.clone() for c in jax.tree.leaves(pc)])
    ref_decode = jax.jit(lambda p, tok, idx, cache: rm.decode_step(p, tok, idx, cache))
    dec = []
    for t in range(PROMPT, NS):
        rl, rc_ = ref_decode(rp, jnp.asarray(toks[:, t]), jnp.int32(t), rc_)
        pl, pc = pm.decode_step(pp, torch.from_numpy(toks[:, t]), t, pc)
        dec.append((_np(rl), pl.double().numpy()))
    out["decode"] = dec
    return out


def test_forward_logits_and_aux(pair):
    ref, port, ref_aux, port_aux = pair["forward"]
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=ATOL)
    assert ref_aux > 0 and abs(port_aux - ref_aux) <= 1e-5 * ref_aux


def test_prefill_logits_and_cache(pair):
    ref, port = pair["prefill"]
    np.testing.assert_allclose(port, ref, atol=ATOL)
    ref_leaves, port_leaves = pair["cache"]
    assert len(ref_leaves) == len(port_leaves) == 2  # k, v
    for r, p in zip(ref_leaves, port_leaves):
        assert tuple(p.shape) == r.shape
        assert str(p.dtype).replace("torch.", "") == str(r.dtype)
        np.testing.assert_allclose(p.double().numpy(), _np(r), atol=ATOL)


def test_decode_steps(pair):
    assert len(pair["decode"]) == NS - PROMPT == 8
    for t, (ref, port) in enumerate(pair["decode"], start=PROMPT):
        np.testing.assert_allclose(port, ref, atol=ATOL,
                                   err_msg=f"{pair['name']} position {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_past_one_group_must_divide(arch):
    """600 tokens at group size 512 raise in both packages (the reference
    asserts; the port raises ValueError rather than pad)."""
    rc = ref_reduced(arch)
    rp = RefModel(rc).init(jax.random.PRNGKey(0))
    toks = np.zeros((1, 600), np.int32)
    with pytest.raises(AssertionError, match="router groups"):
        RefModel(rc).prefill(rp, jnp.asarray(toks))
    pm = Model(port_config(rc))
    with pytest.raises(ValueError, match="router groups"):
        pm.prefill(convert.model_params(rp, "cpu"), torch.from_numpy(toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_with_aux_match_reference(arch):
    rc = ref_reduced(arch)
    rm, pm = RefModel(rc), Model(port_config(rc))
    rp = rm.init(jax.random.PRNGKey(3))
    pp = convert.model_params(rp, "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    r_loss, r_grads = jax.value_and_grad(
        lambda p: rm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}))(rp)
    p_loss, p_grads = _grad_fn(pm, attn_impl="auto", remat=True)(
        pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    # the aux term is in both losses
    _, r_aux = rm.forward(rp, jnp.asarray(toks), remat=False)
    assert float(r_aux) > 0 and rc.router_aux_weight > 0
    assert abs(p_loss.item() - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    r_leaves = jax.tree_util.tree_leaves_with_path(r_grads)
    p_flat = dict(jax.tree_util.tree_leaves_with_path(p_grads))
    assert len(r_leaves) == len(p_flat)
    for path, r in r_leaves:
        r = _np(r)
        p = p_flat[path].double().numpy()
        np.testing.assert_allclose(p, r, atol=1e-5 * np.abs(r).max(),
                                   err_msg=jax.tree_util.keystr(path))
    router = p_flat[next(k for k in p_flat if "router" in jax.tree_util.keystr(k))]
    assert router.abs().max() > 0  # the router learns through gates and aux


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follow_reference_templates(arch):
    """Same tree, shapes and dtypes as the reference's init (the float32
    router, the bf16 expert stacks at full width's dtype); the random
    leaves on their scale."""
    rc, pc = ref_reduced(arch), reduced(arch)
    rp = RefModel(rc).init(jax.random.PRNGKey(0))
    pp = Model(pc).init(0, device="cpu")
    r_leaves = jax.tree_util.tree_leaves_with_path(rp)
    p_flat = dict(jax.tree_util.tree_leaves_with_path(pp))
    assert len(r_leaves) == len(p_flat)
    for path, r in r_leaves:
        p, name, r = p_flat[path], jax.tree_util.keystr(path), np.asarray(r)
        assert tuple(p.shape) == r.shape and str(p.dtype)[6:] == str(r.dtype), name
        if np.all(r == r.flat[0]):
            np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
        else:
            np.testing.assert_allclose(p.double().std().item(), r.std(),
                                       rtol=0.2, err_msg=name)
    # in bfloat16, as at full width: the router stays float32
    ref_bf16 = jax.eval_shape(RefModel(rc.replace(dtype=jnp.bfloat16)).init,
                              jax.random.PRNGKey(0))
    port_bf16 = Model(pc.replace(dtype=torch.bfloat16)).init(0, device="cpu")
    p_flat = dict(jax.tree_util.tree_leaves_with_path(port_bf16))
    for path, r in jax.tree_util.tree_leaves_with_path(ref_bf16):
        p = p_flat[path]
        assert tuple(p.shape) == r.shape and str(p.dtype)[6:] == str(r.dtype)
    assert p_flat[next(k for k in p_flat if "router" in
                       jax.tree_util.keystr(k))].dtype == torch.float32


def test_convert_keeps_moe_bits():
    """A bf16 reference MoE tree crosses leaf for leaf: the float32 router
    and the bf16 expert stacks, bits kept."""
    rc = ref_reduced("olmoe_1b_7b").replace(dtype=jnp.bfloat16)
    rp = RefModel(rc).init(jax.random.PRNGKey(6))
    pp = convert.model_params(rp, "cpu")
    moe_r, moe_p = rp["blocks"]["b0_moe"]["moe"], pp["blocks"]["b0_moe"]["moe"]
    assert moe_p["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe_p["router"].numpy(), np.asarray(moe_r["router"]))
    for k in ("w_gate", "w_up", "w_down"):
        assert moe_p[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(moe_p[k].view(torch.int16).numpy(),
                                      np.asarray(moe_r[k]).view(np.int16))
