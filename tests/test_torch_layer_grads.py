"""Stacked params split into their layers once per forward.

While a gradient is recorded, ``models/model.py::_layers`` takes each
stacked leaf apart by one ``unbind`` (``_Unbind``), so the backward stacks
the layers' gradients once.  ``_layers_before`` keeps the per-layer indexing it
replaced (a frozen copy): a view a layer, whose backward zero-fills one
stack-sized gradient a layer and adds them all.  The two must give the
same gradients bit for bit, in every family and with remat on and off;
the new one must move about one stack's bytes in the backward, and serving
(no gradient recorded) must see the views that indexing gives.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.checkpoint.store import tree_flatten
from repro_torch.configs import reduced
from repro_torch.models import Model
from repro_torch.models import model as model_mod
from repro_torch.models.model import _index
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.training import adamw, constant, make_train_step
from repro_torch.training.trainer import _grad_fn

B, S = 2, 24


def _layers_before(tree, n):
    """``_layers`` as it was before: every leaf indexed layer by layer."""
    return [_index(tree, i) for i in range(n)]


def _config(family):
    if family == "ssm":
        return reduced("falcon_mamba_7b").replace(n_layers=8,
                                                  dtype=torch.bfloat16)
    if family == "hybrid":  # jamba: mamba + attention + dropless MoE
        return reduced("jamba2_mini")
    if family == "dense":
        return reduced("qwen1_5_4b").replace(n_layers=4)
    return reduced("whisper_small")


def _setup(family, seed=3):
    """Model, params (constant leaves redrawn, so no gradient is trivially
    zero: whisper's LayerNorm scales are zeros at init) and a batch."""
    cfg = _config(family)
    assert cfg.family == family
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    leaves, rebuild = tree_flatten(params)
    leaves = [p if p.numel() < 2 or not bool((p == p.flatten()[0]).all())
              else (0.5 + 0.3 * torch.randn(p.shape, generator=gen)).to(p.dtype)
              for p in leaves]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if family == "encdec":
        batch["memory"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    return model, rebuild(leaves), batch


def _clone(tree):
    leaves, rebuild = tree_flatten(tree)
    return rebuild([p.clone() for p in leaves])


def _assert_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _stacked(params):
    """The stacked leaves of an ``ssm`` param tree: its superblock's."""
    assert "tail" not in params
    return tree_flatten(params["blocks"])[0]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("family", ["ssm", "hybrid", "dense", "encdec"])
def test_grads_and_step_bit_equal_to_per_layer_indexing(family, remat,
                                                         monkeypatch):
    model, params, batch = _setup(family)
    grad_fn = _grad_fn(model, attn_impl="auto", remat=remat)
    opt = adamw(constant(1e-3))
    step = make_train_step(model, opt, remat=remat)

    def run():
        loss, grads = grad_fn(params, batch)
        p, s = _clone(params), opt.init(params)
        p, s, metrics = step(p, s, batch, 0)
        return loss, grads, p, s, metrics["grad_norm"]

    new = run()
    monkeypatch.setattr(model_mod, "_layers", _layers_before)
    old = run()
    assert torch.equal(new[0], old[0])
    assert all(bool(g.abs().sum() > 0) for g in tree_flatten(new[1])[0])
    _assert_equal(new[1], old[1])   # every gradient
    _assert_equal(new[2], old[2])   # params after one AdamW step
    _assert_equal(new[3], old[3])   # AdamW's moments and count
    assert torch.equal(new[4], old[4])


class _StackTraffic(TorchDispatchMode):
    """Bytes of the tensors of a stacked leaf's shape that each op reads
    or writes (views and allocations move none; a tensor counts once an
    op), and the names of the ops that touched one."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes, self.bytes, self.ops = shapes, 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        seen = {id(t): t for t in tree_flatten([args, kwargs or {}])[0] + outs
                if torch.is_tensor(t) and tuple(t.shape) in self.shapes}
        if seen:
            self.ops.add(name)
        if not (func.is_view or "empty" in name):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in seen.values())
        return out


def _backward_traffic(n_layers):
    cfg = reduced("falcon_mamba_7b").replace(n_layers=n_layers)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": tokens}
    stacked = _stacked(params)
    leaves, rebuild = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.loss_fn(rebuild(live), batch, remat=True)
    mode = _StackTraffic({tuple(p.shape) for p in stacked})
    with mode:
        torch.autograd.grad(loss, live)
    return mode, mode.bytes / sum(p.numel() * p.element_size() for p in stacked)


def test_backward_moves_one_stack_not_one_per_layer(monkeypatch):
    """16 layers: one ``stack`` a leaf writes its bytes once (1x), where
    the per-layer views wrote 16 zero-filled stacks (``select_backward``)
    and added them (15 adds of 2 reads and a write): 61x."""
    mode, ratio = _backward_traffic(16)
    assert "select_backward" not in mode.ops
    assert 1 <= ratio <= 3
    monkeypatch.setattr(model_mod, "_layers", _layers_before)
    mode, ratio_before = _backward_traffic(16)
    assert "select_backward" in mode.ops
    assert ratio_before >= 4 * 16 - 3


def _checked_layers(seen):
    """``_layers`` that notes, for each stacked leaf it splits, whether its
    layers are the views that indexing gives (same storage, offset and
    strides) and whether the split recorded an autograd node."""
    layers = model_mod._layers

    def wrapped(tree, n):
        out = layers(tree, n)
        if torch.is_tensor(tree):
            same = all(v.data_ptr() == tree[i].data_ptr()
                       and v.stride() == tree[i].stride()
                       and v.shape == tree[i].shape
                       for i, v in enumerate(out))
            seen.append((same, out[0].grad_fn is not None))
        return out
    return wrapped


def test_training_records_one_split_and_serving_sees_indexed_views(
        monkeypatch):
    model, params, batch = _setup("ssm")
    n_stacked = len(_stacked(params))
    seen = []
    monkeypatch.setattr(model_mod, "_layers", _checked_layers(seen))
    opt = adamw(constant(1e-3))
    make_train_step(model, opt)(_clone(params), opt.init(params), batch, 0)
    assert seen == [(True, True)] * n_stacked

    seen.clear()
    eng = ServingEngine(model, params, ServeConfig(batch_slots=2, max_seq=64),
                        device="cpu")
    for i, n in enumerate((5, 9)):
        eng.submit(Request(str(i), np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=3))
    eng.run_until_done()
    # two prefills and at least two decode steps: the views indexing
    # gives, and no autograd node
    assert len(seen) >= 4 * n_stacked and len(seen) % n_stacked == 0
    assert set(seen) == {(True, False)}
