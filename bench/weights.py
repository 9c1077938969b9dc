"""Model weights drawn by the benchmark from the seed, on the device.

The tree's structure, shapes and dtypes are the program's (read from its
shape-only ``meta`` init); the values come from the configuration file's
``init`` table, one generator a leaf seeded from ``(seed, leaf index)``,
so that any leaf can be drawn again alone (the reference does) and a
leaf is one or two large calls on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _named(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, 11, index]).generate_state(
        1, np.uint64)[0] >> 1)


def draw_leaf(name: str, meta: torch.Tensor, index: int, config: dict,
              seed: int, device) -> torch.Tensor:
    recipe = config["init"][name.rsplit(".", 1)[-1]]
    shape, dtype = tuple(meta.shape), meta.dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    kind = recipe[0]
    if kind == "normal":
        out = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return out.mul_(1.0 / math.sqrt(recipe[1]))
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "alog":  # A = -(1, 2, ..., state) on every channel
        n = shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        return base.expand(shape).to(dtype).contiguous()
    if kind == "dtbias":  # softplus^-1 of dt, log-uniform in [lo, hi]
        lo, hi = recipe[1], recipe[2]
        u = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        return torch.log(torch.expm1(dt)).to(dtype)
    raise ValueError(f"unknown init {recipe!r} for {name}")


def draw(meta_tree, config: dict, seed: int, device) -> dict:
    """A tree like ``meta_tree`` with every leaf drawn on ``device``."""
    flat = {name: draw_leaf(name, t, i, config, seed, device)
            for i, (name, t) in enumerate(_named(meta_tree))}
    return rebuild(meta_tree, flat)


def leaf_names(meta_tree) -> Dict[str, int]:
    """Leaf name → its index in the draw order."""
    return {name: i for i, (name, _) in enumerate(_named(meta_tree))}


def ssm_shapes(c: dict) -> dict:
    """The falcon-mamba weight tree the configuration ``c`` states, as
    ``(shape, dtype name)`` leaves: the embedding and untied unembedding
    over the padded vocabulary, the final norm, and each layer's stacked
    norm scale and mixer weights."""
    big = c["dtype"]
    f32 = "float32"
    L, D, Dm = c["layers"], c["d_model"], c["d_inner"]
    N, K, R, V = c["state"], c["conv"], c["dt_rank"], c["padded_vocab"]
    return {
        "embed": ((V, D), big), "unembed": ((D, V), big),
        "final_norm": ((D,), f32),
        "blocks": {"b0_mamba": {
            "ln1_scale": ((L, D), f32),
            "mamba": {
                "in_proj": ((L, D, 2, Dm), big), "conv_w": ((L, K, Dm), big),
                "conv_b": ((L, Dm), big), "x_proj": ((L, Dm, R + 2 * N), big),
                "dt_proj": ((L, R, Dm), big), "dt_bias": ((L, Dm), f32),
                "a_log": ((L, Dm, N), f32), "d_skip": ((L, Dm), f32),
                "out_proj": ((L, Dm, D), big)}}}}


def meta_tree(c: dict) -> dict:
    """:func:`ssm_shapes` as shape-only tensors on the ``meta`` device."""
    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        shape, dt = t
        return torch.empty(shape, dtype=getattr(torch, dt), device="meta")
    return build(ssm_shapes(c))


def same_layout(a, b) -> bool:
    """Two trees of tensors with the same keys, shapes and dtypes."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same_layout(a[k], b[k]) for k in a))
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = "") -> dict:
    return {k: (rebuild(v, flat, f"{prefix}{k}.") if isinstance(v, dict)
                else flat[prefix + k]) for k, v in tree.items()}
