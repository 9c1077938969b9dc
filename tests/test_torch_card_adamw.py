"""AdamW's clip and update kernels (``kernels/csrc/adamw.cu``) on the card.

- ``adamw_update_kernel``, through AdamW's ``step``, is bit-equal to the
  plain ``update`` then ``apply_updates`` on p, m and v: each (gradient,
  param) dtype pair; lengths 1, 7 and 4,099, and 4,099 one element off a
  16-byte boundary (the scalar path); decay on (a 2-D leaf) and off (1-D);
  steps 0, 1 and 60; with and without a clip factor.  On one bfloat16 leaf
  of 2^31 + 5 elements (64-bit indices, a scalar tail) it is held to the
  plain version on slices at its ends and across element 2^31, and the
  norm kernel to the plain norm.
- A gradient in permuted strides (autograd's layout for a stacked leaf of
  whisper) takes both kernels through a contiguous copy.
- The norm is the same bits over three runs and within 1e-5 of the plain
  ``global_norm``; its clip factor is the plain factor of that norm.
- Three train steps of a reduced falcon-mamba (bfloat16, float32 norms and
  SSM leaves) take the update kernel on every element (the
  ``train.optimizer`` spans) and stay within 1e-5 of the plain path on
  every leaf of the params and moments.

Every test skips without a card (``tests/torch_card.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import tree_flatten
from repro_torch.configs import reduced
from repro_torch.kernels.adamw import kernel as kadamw
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.models import Model
from repro_torch.runtime import trace
from repro_torch.training import (adamw, apply_updates, global_norm,
                                  make_train_step, warmup_cosine)
from repro_torch.training.optimizer import norm_and_clip_factor
from torch_card import bits, card  # noqa: F401

pytestmark = pytest.mark.card

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
PAIRS = [(g, p) for g in DTYPES for p in DTYPES]
#: (elements, offset in elements from the allocation's start)
LENGTHS = [(1, 0), (7, 0), (4099, 0), (4099, 1)]
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)


def _leaf(gen, card, n, offset, shape, dtype, scale=1.0):
    base = (torch.randn(n + offset, generator=gen, device=card) * scale).to(dtype)
    return base[offset:].view(shape)


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("n, offset", LENGTHS)
@pytest.mark.parametrize("gdt, pdt", PAIRS)
def test_update_kernel_is_bit_equal(card, gdt, pdt, n, offset, decay, clip):
    gen = torch.Generator(device=card).manual_seed(7 * n + offset)
    shape = (1, n) if decay else (n,)
    opt = adamw(warmup_cosine(1e-2, 2, 100))
    p = _leaf(gen, card, n, offset, shape, DTYPES[pdt])
    pu = {"w": p.clone()}
    ps = {"w": p}
    ss, su = opt.init(ps), opt.init(pu)
    before = kadamw.LAUNCHES["adamw_update"]
    for step in (0, 1, 60):
        grads = {"w": _leaf(gen, card, n, offset, shape, DTYPES[gdt], 3.0)}
        scale = (torch.rand((), generator=gen, device=card) if clip else None)
        ps, ss, fused = opt.step(grads, ss, ps, step, scale=scale)
        updates, su = opt.update(grads, su, pu, step, scale=scale)
        pu = apply_updates(pu, updates)
        assert fused == n
    torch.cuda.synchronize()
    assert kadamw.LAUNCHES["adamw_update"] == before + 3
    for a, b in zip(tree_flatten((ps, ss))[0], tree_flatten((pu, su))[0]):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_gradients_in_other_strides_take_the_kernels(card):
    """A gradient laid out in permuted strides, as autograd gives a stacked
    leaf's in whisper, is read through a contiguous copy: bit-equal to the
    plain update, the norm within 1e-5 of the plain one."""
    gen = torch.Generator(device=card).manual_seed(18)
    opt = adamw(warmup_cosine(1e-2, 2, 100))
    p = torch.randn((2, 64, 4, 16), generator=gen, device=card)
    ps, pu = {"w": p}, {"w": p.clone()}
    ss, su = opt.init(ps), opt.init(pu)
    g = torch.randn((2, 4, 64, 16), generator=gen, device=card).transpose(1, 2)
    assert not g.is_contiguous()
    norm, scale = norm_and_clip_factor({"w": g}, 0.5)
    plain = torch.sqrt(adamw_ref.grad_sumsq_reference([g]))
    assert abs(norm.item() - plain.item()) <= 1e-5 * plain.item()
    ps, ss, fused = opt.step({"w": g}, ss, ps, 0, scale=scale)
    updates, su = opt.update({"w": g}, su, pu, 0, scale=scale)
    pu = apply_updates(pu, updates)
    assert fused == g.numel()
    for a, b in zip(tree_flatten((ps, ss))[0], tree_flatten((pu, su))[0]):
        assert torch.equal(bits(a), bits(b))


def test_update_and_norm_on_a_leaf_past_two_to_the_31(card):
    n = 2**31 + 5
    gen = torch.Generator(device=card).manual_seed(31)
    g = torch.randn(n, generator=gen, device=card, dtype=torch.bfloat16)
    p = torch.randn(n, generator=gen, device=card, dtype=torch.bfloat16)
    m = torch.randn(n, generator=gen, device=card).mul_(0.1)
    v = torch.rand(n, generator=gen, device=card).mul_(0.01)
    scale = torch.tensor(0.37, device=card)
    cuts = [slice(0, 4096), slice(2**30 - 3, 2**30 + 4093),
            slice(2**31 - 4096, n)]
    kept = [[t[c].clone() for t in (g, m, v, p)] for c in cuts]
    sf = np.float32(5.0) + np.float32(1.0)
    args = (np.float32(1.0) - np.float32(0.9) ** sf,
            np.float32(1.0) - np.float32(0.95) ** sf, -np.float32(3e-4))

    norm, _ = kadamw.grad_norm_cuda([g])
    want = torch.sqrt(adamw_ref.grad_sumsq_reference([g]))
    assert abs(norm.item() - want.item()) <= 1e-5 * want.item()

    kadamw.adamw_update_cuda(g, m, v, p, scale, *args, **HYPER)
    for c, (gg, mm, vv, pp) in zip(cuts, kept):
        adamw_ref.apply_reference(pp, adamw_ref.adamw_update_reference(
            gg, mm, vv, pp, scale, *args, **HYPER))
        for got, want in ((p[c], pp), (m[c], mm), (v[c], vv)):
            assert torch.equal(bits(got), bits(want)), c


def test_norm_is_deterministic_and_the_plain_norm(card):
    gen = torch.Generator(device=card).manual_seed(5)
    tree = {"big": torch.randn((64, 1 << 20), generator=gen, device=card,
                               dtype=torch.bfloat16),
            "odd": torch.randn(4099, generator=gen, device=card,
                               dtype=torch.bfloat16),
            "f32": torch.randn((3, 1000, 7), generator=gen, device=card),
            "off": torch.randn(70001, generator=gen, device=card)[1:],
            "one": torch.randn(1, generator=gen, device=card)}
    leaves = tree_flatten(tree)[0]
    runs = [kadamw.grad_norm_cuda(leaves, 1.0) for _ in range(3)]
    for norm, factor in runs[1:]:
        assert torch.equal(bits(norm), bits(runs[0][0]))
        assert torch.equal(bits(factor), bits(runs[0][1]))
    norm, factor = runs[0]
    assert norm.shape == factor.shape == () and norm.device.type == "cuda"
    plain = torch.sqrt(adamw_ref.grad_sumsq_reference(leaves))
    assert abs(norm.item() - plain.item()) <= 1e-5 * plain.item()
    assert torch.equal(bits(factor), bits(adamw_ref.clip_factor_reference(norm, 1.0)))
    assert torch.equal(bits(global_norm(tree)), bits(norm))
    small = [t * 1e-4 for t in leaves]
    assert kadamw.grad_norm_cuda(small, 1.0)[1].item() == 1.0


def _three_steps(card, optimizer):
    cfg = reduced("falcon_mamba_7b").replace(dtype=torch.bfloat16)
    model = Model(cfg)
    params = model.init(0, device=card)
    state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer, clip_norm=1.0)
    gen = torch.Generator().manual_seed(11)
    for i in range(3):
        x = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
        batch = {"tokens": x[:, :-1].contiguous().to(card),
                 "labels": x[:, 1:].contiguous().to(card)}
        params, state, _ = step_fn(params, state, batch, i)
    return params, state


def test_train_steps_take_the_kernels_and_agree_with_the_plain_path(card, monkeypatch):
    opt = adamw(warmup_cosine(1e-3, 2, 10))
    trace.reset()
    with trace.enable():
        fused = _three_steps(card, opt)
    spans = [s for s in trace.spans() if s.name == "train.optimizer"]
    trace.reset()
    assert len(spans) == 3 and {s.attrs["impl"] for s in spans} == {"cuda"}
    share = (100.0 * sum(s.attrs["fused_elems"] for s in spans)
             / sum(s.attrs["elems"] for s in spans))
    assert share == 100.0
    assert {p.dtype for p in tree_flatten(fused[0])[0]} == {torch.bfloat16,
                                                          torch.float32}
    monkeypatch.setattr(adamw_ops, "impl_of", lambda leaves: "torch")
    plain = _three_steps(card, opt._replace(step=None))
    for a, b in zip(tree_flatten(fused)[0], tree_flatten(plain)[0]):
        gap = torch.linalg.vector_norm(a.float() - b.float()).item()
        assert gap <= 1e-5 * torch.linalg.vector_norm(b.float()).item()
