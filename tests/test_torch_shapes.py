"""The assigned shapes and each cell's input specs, against the JAX package.

For every arch × shape on the production meshes (single pod: data=16 x
model=16; multi-pod: pod=2 x data=16 x model=16), the port's dry-run rules
(``launch/dryrun.py::build_rules``) must equal the reference's field by
field, and the port's ``input_specs`` must equal the reference's
ShapeDtypeStructs in leaf paths, shapes, dtypes and (canonical) specs.
The reference's meshes are ``AbstractMesh``es; the port's are built over
meta placeholders.  Nothing is allocated: the decode caches come from
``init_cache(device="meta")``.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro_torch.configs import (ARCH_NAMES, SHAPES, Shape, batch_specs, get,
                                 info, input_specs)
from repro_torch.configs.shapes import TensorSpec
from repro_torch.launch.dryrun import build_rules
from repro_torch.launch.mesh import make_production_mesh

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref_build_rules():
    """The reference's ``build_rules``.  Its module sets XLA_FLAGS (512 host
    devices) when imported: the backend is brought up first, so the flag
    cannot resize it, and the variable is restored for later processes."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod.build_rules


@pytest.fixture(scope="module")
def meshes():
    return {mp: (make_production_mesh(multi_pod=mp,
                                      devices=["meta"] * (512 if mp else 256)),
                 jax.sharding.AbstractMesh(*MESHES[mp]))
            for mp in (False, True)}


def _canon(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    else:
        assert isinstance(tree, TensorSpec)
        yield path, tree


def _ref_leaves(tree):
    out = []
    for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(p.key for p in path), sds))
    return sorted(out, key=lambda kv: kv[0])


RULE_FIELDS = [f.name for f in dataclasses.fields(
    importlib.import_module("repro_torch.distributed.sharding").ShardingRules)
    if f.name != "mesh"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, multi_pod, meshes,
                                         ref_build_rules):
    mesh, ref_mesh = meshes[multi_pod]
    assert mesh.shape == dict(ref_mesh.shape)
    cfg, inf = get(arch), info(arch)
    rcfg, rinf = ref_get(arch)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        rules = build_rules(cfg, inf, shape, mesh, multi_pod=multi_pod)
        rrules = ref_build_rules(rcfg, rinf, rshape, ref_mesh,
                                 multi_pod=multi_pod)
        for f in RULE_FIELDS:
            assert getattr(rules, f) == getattr(rrules, f), (name, f)
        kv = inf.kv_cache_dtype if shape.kind == "decode" else None
        got = list(_port_leaves(input_specs(cfg, shape, rules, kv_dtype=kv)))
        want = _ref_leaves(ref_input_specs(rcfg, rshape, rrules, kv_dtype=kv))
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, spec), (_, sds) in zip(got, want):
            assert spec.shape == tuple(sds.shape), (name, path)
            assert str(spec.dtype).replace("torch.", "") == \
                jnp.dtype(sds.dtype).name, (name, path)
            assert _canon(spec.sharding.spec) == tuple(sds.sharding.spec), \
                (name, path)
            assert spec.sharding.mesh is mesh


def test_shapes_and_exports():
    """The four assigned shapes, and the package exports the reference's."""
    assert {k: (s.kind, s.seq, s.batch) for k, s in SHAPES.items()} == {
        k: (s.kind, s.seq, s.batch) for k, s in REF_SHAPES.items()}
    assert isinstance(SHAPES["decode_32k"], Shape)
    assert callable(batch_specs)


def test_a_43_gb_cache_is_never_allocated(meshes):
    """qwen3-14b's decode_32k k cache is 40 x 128 x 32768 x 8 x 128 bf16
    (43 GB): its spec is a placement, and its tensor is shape-only."""
    mesh, _ = meshes[False]
    cfg = get("qwen3_14b")
    shape = SHAPES["decode_32k"]
    rules = build_rules(cfg, info("qwen3_14b"), shape, mesh, multi_pod=False)
    k = input_specs(cfg, shape, rules)["cache"]["blocks"]["b0_attn"]["k"]
    assert k.shape == (40, 128, 32768, 8, 128)
    assert k.dtype == torch.bfloat16
    assert k.meta().is_meta
