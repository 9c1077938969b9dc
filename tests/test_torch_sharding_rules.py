"""The model half of sharding, against the JAX package.

``tests/test_sharding_rules.py``'s five tests run on the port's
``ShardingRules`` over a (data=2, model=2) ``Mesh`` of host placeholders,
the port's stand-in for the reference's ``AbstractMesh((2, 2))``.  Every
activation kind over a grid of rule settings, every arch's logical param
specs and their resolution are held to the reference's.  A spec is a plain
tuple in the port; a ``PartitionSpec`` keeps a one-axis entry ``("data",)``
as ``"data"``, so the two are compared in that canonical form.  Last, a
model run with rules must give bit for bit what it gives without: on the
port's single-controller mesh a constraint moves nothing.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from repro.configs import get as ref_get
from repro.distributed.sharding import ShardingRules as RefRules
from repro.distributed.sharding import guard_spec as ref_guard_spec
from repro.distributed.sharding import resolve_param_specs as ref_resolve
from repro.models.params import param_specs as ref_param_specs
from repro_torch.configs import ARCH_NAMES, get, reduced
from repro_torch.distributed.sharding import (NamedSharding, ShardingRules,
                                              guard_spec, named_sharding_tree,
                                              resolve_param_specs)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.params import param_specs

KINDS = ("btd", "btf", "btm", "bshk", "btkk", "btv", "bshk_seq", "btkk_full",
         "xbtkk", "gecd", "gecf")


@pytest.fixture(scope="module")
def mesh():
    # spec-resolution tests never execute on the mesh: four host
    # placeholders of the (data, model) shape stand in for an abstract mesh
    return Mesh((torch.device("cpu"),) * 4, ("data", "model"), (2, 2))


@pytest.fixture(scope="module")
def ref_mesh():
    return jax.sharding.AbstractMesh((2, 2), ("data", "model"))


def _canon(spec):
    """A spec with one-axis entries written as the axis name, the form a
    ``PartitionSpec`` keeps them in."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _canon_tree(tree):
    if isinstance(tree, dict):
        return {k: _canon_tree(v) for k, v in tree.items()}
    return _canon(tree)


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py on the port
# ---------------------------------------------------------------------------


def test_resolve_logical_axes(mesh):
    rules = ShardingRules(mesh=mesh, fsdp_axes=("data",))
    assert rules.resolve(("fsdp", "model")) == (("data",), ("model",))
    assert rules.resolve((None, "model")) == (None, ("model",))
    with pytest.raises(ValueError):
        rules.resolve(("bogus",))


def test_activation_kinds(mesh):
    rules = ShardingRules(mesh=mesh, batch_axes=("data",))
    for kind in ("btd", "btf", "btm", "bshk", "btkk", "btv", "gecd", "gecf"):
        spec = rules.spec(kind)
        assert isinstance(spec, tuple)
    with pytest.raises(ValueError):
        rules.spec("bogus")


def test_divisibility_guard_drops_invalid(mesh):
    rules = ShardingRules(mesh=mesh, batch_axes=("data",))
    # dim 3 not divisible by data=2 → entry dropped; dims 4/8 fine
    spec = guard_spec(rules.spec("btd"), (3, 4, 8), {"data": 2, "model": 2})
    assert spec == (None, None, None)
    spec2 = guard_spec(rules.spec("btd"), (4, 4, 8), {"data": 2, "model": 2})
    assert spec2 == (("data",), None, None)


def test_headdim_mode_kv_spec(mesh):
    rules = ShardingRules(mesh=mesh, attn_shard="headdim",
                          batch_axes=("data",))
    assert rules.spec("btkk") == (("data",), None, None, ("model",))
    rules2 = ShardingRules(mesh=mesh, shard_kv_seq=True, batch_axes=("data",))
    assert rules2.spec("btkk") == (("data",), ("model",), None, None)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_resolve_for_all_archs(arch, mesh):
    """Every arch's logical spec tree resolves; model-sharded dims divide 16
    (the production model-axis), guaranteed by config padding choices."""
    cfg = get(arch)
    model = Model(cfg)
    resolved = resolve_param_specs(model.specs(), ShardingRules(
        mesh=mesh, fsdp_axes=("data",)))
    params = model.init(device="meta")

    def check(path, spec, leaf):
        if isinstance(spec, dict):
            for k in spec:
                check(path + (k,), spec[k], leaf[k])
            return
        assert len(spec) == leaf.dim(), path
        for dim, entry in zip(leaf.shape, spec):
            if entry is not None and "model" in entry:
                assert dim % cfg.model_axis_size == 0, (arch, path, dim)

    check((), resolved, params)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

#: rule settings: each field over its values, the rest at the defaults
GRID = [dict(zip(("attn_shard", "kv_heads_shardable", "shard_kv_seq",
                  "shard_moe_expert"), v))
        for v in itertools.product(("heads", "headdim"), (True, False),
                                   (False, True), (True, False))]
AXES = [dict(batch_axes=("data",), seq_axes=()),
        dict(batch_axes=("data",), seq_axes=("model",)),
        dict(batch_axes=(), model_axes=(), fsdp_axes=()),
        dict(batch_axes=("data", "model"), seq_axes=("data",))]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: "-".join(
    f"{k[0]}{''.join(v)}" for k, v in a.items()))
def test_every_kind_matches_the_reference(axes, mesh, ref_mesh):
    for kw in GRID:
        rules = ShardingRules(mesh=mesh, **axes, **kw)
        ref = RefRules(mesh=ref_mesh, **axes, **kw)
        for kind in KINDS:
            assert _canon(rules.spec(kind)) == tuple(ref.spec(kind)), (kind, kw)
        for logical in (("fsdp", "model"), (None, "fsdp", None, "model"), ()):
            assert _canon(rules.resolve(logical)) == tuple(ref.resolve(logical))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, mesh, ref_mesh):
    logical = param_specs(get(arch))
    ref_logical = ref_param_specs(ref_get(arch)[0])
    assert logical == ref_logical
    for kw in (dict(fsdp_axes=("data",)), dict(fsdp_axes=()),
               dict(fsdp_axes=("data",), model_axes=())):
        got = resolve_param_specs(logical, ShardingRules(mesh=mesh, **kw))
        want = ref_resolve(ref_logical, RefRules(mesh=ref_mesh, **kw))
        assert _canon_tree(got) == jax.tree.map(
            tuple, want, is_leaf=lambda x: isinstance(x, PS))


def test_act_checks_its_spec_against_the_mesh():
    """``act`` guards the kind's spec against the mesh as the reference's
    does: an axis the mesh lacks raises, a dim the mesh does not divide is
    no error, and the tensor comes back as it was."""
    one_axis = Mesh((torch.device("cpu"),) * 2, ("data",), (2,))
    x = torch.zeros(3, 5, 7)
    rules = ShardingRules(mesh=one_axis)
    assert rules.act(x, "btd") is x
    with pytest.raises(KeyError):
        rules.act(x, "btf")
    with pytest.raises(KeyError):
        ref_guard_spec(RefRules(mesh=jax.sharding.AbstractMesh(
            (2,), ("data",))).spec("btf"), x.shape, {"data": 2})


def test_named_sharding_tree(mesh):
    specs = resolve_param_specs(param_specs(reduced("olmoe_1b_7b")),
                                ShardingRules(mesh=mesh))
    tree = named_sharding_tree(specs, mesh)
    leaf = tree["blocks"]["b0_moe"]["moe"]["w_up"]
    assert leaf == NamedSharding(mesh, (None, ("model",), ("data",), None))
    assert tree["embed"].spec == (("model",), ("data",))


# ---------------------------------------------------------------------------
# Rules change no value
# ---------------------------------------------------------------------------


def _live(params, seed):
    """Nonzero draws for the leaves the init leaves at zero, so every
    branch of the model reaches the logits."""
    gen = torch.Generator().manual_seed(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if t.is_floating_point() and not t.any():
            return (torch.randn(t.shape, generator=gen) * 0.1).to(t.dtype)
        return t

    return walk(params)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_change_no_value(arch, mesh):
    """Prefill, decode and the loss with rules (the dry run's rule
    settings for the arch) are bit-equal to the same calls without."""
    cfg = reduced(arch)
    model = Model(cfg)
    params = _live(model.init(0, device="cpu"), 1)
    rules = ShardingRules(
        mesh=mesh, attn_shard=cfg.attn_shard,
        kv_heads_shardable=cfg.n_kv_heads % cfg.model_axis_size == 0,
        shard_moe_expert=cfg.moe_shard == "expert")
    rng = np.random.default_rng(0)
    b, s = 2, 16
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 2)))
    memory = None
    if cfg.family in ("vlm", "encdec"):
        t = cfg.vision_seq if cfg.family == "vlm" else cfg.encoder_seq
        memory = torch.from_numpy(rng.standard_normal((b, t, cfg.d_model))
                                  .astype(np.float32))
    outs = []
    for r in (None, rules):
        logits, cache, cross = model.prefill(params, toks[:, :s], memory=memory,
                                             rules=r, max_seq=s + 4)
        steps = [logits]
        for i in range(2):
            lg, cache = model.decode_step(params, toks[:, s + i], s + i, cache,
                                          cross_stack=cross, rules=r)
            steps.append(lg)
        batch = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1]}
        if memory is not None:
            batch["memory"] = memory
        loss = model.loss_fn(params, batch, rules=r, remat=False)
        outs.append((steps, [c for c in _flat(cache)], loss))
    (s0, c0, l0), (s1, c1, l1) = outs
    assert all(torch.equal(a, b_) for a, b_ in zip(s0, s1))
    assert all(torch.equal(a, b_) for a, b_ in zip(c0, c1))
    assert torch.equal(l0, l1)


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    else:
        yield tree
