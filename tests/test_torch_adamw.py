"""AdamW's in-place ``step`` and the clip and update kernels' contract, on
the CPU (the card's half is ``tests/test_torch_card_adamw.py``).

- ``step`` on CPU and ``meta`` leaves is today's ``update`` then
  ``apply_updates``, bit for bit, for each (gradient, param) dtype pair.
- The kernels' arithmetic, written out per element in numpy float32 in the
  order ``csrc/adamw.cu`` runs it, is bit-equal to the plain version; so
  is its clip factor.
- ``_clip_and_apply`` opens one ``train.optimizer`` span that says which
  path ran and how many elements the kernel updated.
- The wrappers refuse a leaf they do not take.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import tree_flatten
from repro_torch.kernels.adamw import kernel as kadamw
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.runtime import trace
from repro_torch.training import adafactor, adamw, apply_updates, warmup_cosine
from repro_torch.training.optimizer import Optimizer, norm_and_clip_factor
from repro_torch.training.trainer import _clip_and_apply

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
PAIRS = [(g, p) for g in DTYPES for p in DTYPES]


def bits(t):
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(view[t.dtype]) if t.dtype in view else t


def _tree(seed, dtype, device="cpu", scale=1.0):
    """A 2-D leaf (decayed), a 1-D leaf (not) and a 3-D leaf of odd length."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (7, 13), "b": (29,), "s": (2, 3, 5)}
    return {k: (torch.randn(s, generator=g) * scale).to(dtype).to(device)
            for k, s in shapes.items()}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("gdt, pdt", PAIRS)
def test_step_on_the_cpu_is_update_then_apply(gdt, pdt, clip):
    opt = adamw(warmup_cosine(1e-2, 2, 10))
    params = _tree(0, DTYPES[pdt])
    ps, pu = _clone(params), _clone(params)
    ss, su = opt.init(ps), opt.init(pu)
    for step in range(3):
        grads = _tree(10 + step, DTYPES[gdt], scale=3.0)
        scale = None if clip is None else norm_and_clip_factor(grads, clip)[1]
        ps, ss, fused = opt.step(grads, ss, ps, step, scale=scale)
        updates, su = opt.update(grads, su, pu, step, scale=scale)
        pu = apply_updates(pu, updates)
        assert fused == 0
    for a, b in zip(tree_flatten((ps, ss))[0], tree_flatten((pu, su))[0]):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_step_on_meta_leaves_runs_the_plain_path():
    opt = adamw(warmup_cosine(1e-2, 2, 10))
    params = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in _tree(0, torch.bfloat16).items()}
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    state = opt.init(params)
    norm, scale = norm_and_clip_factor(grads, 1.0)
    assert norm.device.type == scale.device.type == "meta"
    out, state2, fused = opt.step(grads, state, params, 0, scale=scale)
    assert fused == 0 and out is params and state2 is state
    assert all(p.device.type == "meta" for p in tree_flatten((out, state2))[0])


def _round(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values rounded to ``dtype`` (nearest even) and back."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _sqrt(x: np.ndarray) -> np.ndarray:
    """torch's square root: on this host's vector units it is not always
    the correctly rounded one that the kernel's ``__fsqrt_rn`` and the
    card's torch take (the card tests hold those two together)."""
    return torch.sqrt(torch.from_numpy(x)).numpy()


def kernel_model(g, p, m, v, scale, bc1, bc2, neg_lr, *, b1, b2, eps, wd):
    """``adamw_update_kernel``'s arithmetic, one numpy float32 op a rounding:
    returns (p, m, v) as float32 arrays, p rounded to its dtype."""
    f = np.float32
    g32 = g.float().numpy()
    if scale is not None:
        g32 = g32 * f(scale)
    p32 = p.float().numpy()
    m = m.numpy() * f(b1) + f(1 - b1) * g32
    v = v.numpy() * f(b2) + (f(1 - b2) * g32) * g32
    u = (m / f(bc1)) / (_sqrt(v / f(bc2)) + f(eps))
    u = u + f(wd) * p32
    o = _round(u * f(neg_lr), p.dtype)
    return _round(p32 + o, p.dtype), m, v


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("gdt, pdt", PAIRS)
def test_kernel_arithmetic_is_the_plain_version(gdt, pdt, scaled):
    gen = torch.Generator().manual_seed(3)
    n = 4099
    g = (torch.randn(n, generator=gen) * 4).to(DTYPES[gdt])
    p = torch.randn(n, generator=gen).to(DTYPES[pdt])
    m = torch.randn(n, generator=gen) * 0.1
    v = torch.rand(n, generator=gen) * 0.01
    scale = torch.tensor(0.37, dtype=torch.float32) if scaled else None
    for step in (0, 1, 60):
        sf = np.float32(step) + np.float32(1.0)
        bc1 = np.float32(1.0) - np.float32(0.9) ** sf
        bc2 = np.float32(1.0) - np.float32(0.95) ** sf
        hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
        want = kernel_model(g, p, m, v, scale, bc1, bc2, -np.float32(3e-4), **hyper)
        pp, mm, vv = p.clone(), m.clone(), v.clone()
        adamw_ref.apply_reference(pp, adamw_ref.adamw_update_reference(
            g, mm, vv, pp, scale, bc1, bc2, -np.float32(3e-4), **hyper))
        got = (pp.float().numpy(), mm.numpy(), vv.numpy())
        for a, b in zip(got, want):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_kernel_clip_factor_is_the_plain_one():
    """``grad_sumsq_finish_kernel``'s factor: min(1, max_norm / max(norm,
    1e-9)), a NaN kept."""
    f = np.float32
    for norm in (0.0, 1e-12, 0.5, 1.0, 3.7, 1e30, np.inf, np.nan):
        n = f(norm)
        den = n if np.isnan(n) else max(n, f(1e-9))
        q = f(1.0) / den
        want = q if np.isnan(q) else min(q, f(1.0))
        got = adamw_ref.clip_factor_reference(torch.tensor(n), 1.0)
        assert np.array_equal(np.float32(got.item()).view(np.int32),
                              np.float32(want).view(np.int32)), norm


class _FakeFused:
    """An optimizer whose ``step`` says the kernel updated every element."""

    def __init__(self):
        inner = adamw(warmup_cosine(1e-2, 2, 10))

        def step(grads, state, params, step, scale=None):
            params, state, _ = inner.step(grads, state, params, step, scale)
            return params, state, sum(g.numel() for g in tree_flatten(grads)[0])

        self.opt = Optimizer(inner.init, inner.update, step)


@pytest.mark.parametrize("name, impl, fused", [
    ("adamw", "torch", 0), ("adafactor", "torch", 0), ("fused", "cuda", 1)])
def test_clip_and_apply_opens_one_optimizer_span(name, impl, fused,
                                                  monkeypatch):
    """On the CPU ``update`` then ``apply_updates`` run; an optimizer with a
    ``step`` takes it where the leaves lie on the card (faked here)."""
    if name == "fused":
        monkeypatch.setattr(adamw_ops, "impl_of", lambda leaves: "cuda")
    opt = {"adamw": lambda: adamw(warmup_cosine(1e-2, 2, 10)),
           "adafactor": lambda: adafactor(warmup_cosine(1e-2, 2, 10)),
           "fused": lambda: _FakeFused().opt}[name]()
    params = _tree(0, torch.bfloat16)
    grads = _tree(1, torch.bfloat16)
    elems = sum(g.numel() for g in grads.values())
    trace.reset()
    with trace.enable():
        _clip_and_apply(opt, params, opt.init(params), grads, 0, 1.0)
    spans = [s for s in trace.spans() if s.name == "train.optimizer"]
    trace.reset()
    assert len(spans) == 1
    assert spans[0].attrs == {"impl": impl, "elems": elems,
                              "fused_elems": fused * elems}


def test_wrappers_refuse_leaves_they_do_not_take():
    n = 16
    g = torch.zeros(n, dtype=torch.bfloat16)
    p = torch.zeros(n, dtype=torch.bfloat16)
    m, v = torch.zeros(n), torch.zeros(n)
    args = (np.float32(0.1), np.float32(0.05), np.float32(-1e-3))
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kadamw.adamw_update_cuda(g, m, v, p.half(), None, *args, **hyper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kadamw.adamw_update_cuda(g.half(), m, v, p, None, *args, **hyper)
    with pytest.raises(TypeError, match="float32"):
        kadamw.adamw_update_cuda(g, m.bfloat16(), v, p, None, *args, **hyper)
    wide = torch.zeros((4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        kadamw.adamw_update_cuda(wide.t(), torch.zeros(8, 4), torch.zeros(8, 4),
                                 torch.zeros((8, 4), dtype=torch.bfloat16), None,
                                 *args, **hyper)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kadamw.grad_norm_cuda([g, g.half()])
    with pytest.raises(ValueError, match="contiguous"):
        kadamw.grad_norm_cuda([wide.t()])
    assert adamw_ops.impl_of([g, p]) == "torch"


def test_wrappers_on_the_cpu_are_the_plain_version():
    gen = torch.Generator().manual_seed(5)
    leaves = [torch.randn(s, generator=gen).to(dt) for s, dt in
              (((3, 5), torch.bfloat16), ((11,), torch.float32))]
    norm, factor = kadamw.grad_norm_cuda(leaves, 0.5)
    assert torch.equal(norm, torch.sqrt(adamw_ref.grad_sumsq_reference(leaves)))
    assert torch.equal(factor, adamw_ref.clip_factor_reference(norm, 0.5))
    g, p = leaves[0], torch.randn((3, 5), generator=gen).bfloat16()
    m, v = torch.zeros(3, 5), torch.zeros(3, 5)
    want_p, want_m, want_v = p.clone(), m.clone(), v.clone()
    args = (factor, np.float32(0.1), np.float32(0.05), np.float32(-1e-3))
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
    adamw_ref.apply_reference(want_p, adamw_ref.adamw_update_reference(
        g, want_m, want_v, want_p, *args, **hyper))
    assert kadamw.adamw_update_cuda(g, m, v, p, *args, **hyper) is p
    for a, b in ((p, want_p), (m, want_m), (v, want_v)):
        assert torch.equal(bits(a), bits(b))
