"""Bytes AdamW's clip, update and apply need in one train step, each byte
counted once: the yardstick of ``adamw_roofline_pct``.

A leaf of n elements reads its gradient, its param and the float32 moments
m and v, and writes m, v and the param: n (g + 2 p + 16) bytes for a
gradient of g bytes an element and a param of p.  A bfloat16 leaf with a
bfloat16 gradient takes 22 bytes an element, a float32 leaf with a float32
gradient 28; a train step's gradient has its param's dtype.  Which leaves
are float32 comes from the configuration's ``float32_leaves``; the others
take its ``dtype``.  The norm's read of the gradient before the update is
not counted: a design that reads g twice reaches at most 22/24 (91.7 %) of
the bound on bfloat16 leaves.
"""
from __future__ import annotations

SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def leaf_bytes(n: int, param_size: int, grad_size: int = None) -> int:
    g = param_size if grad_size is None else grad_size
    return n * (g + 2 * param_size + 16)


def ssm_leaves(c: dict) -> dict:
    """Elements of each leaf of the falcon-mamba weight tree the
    configuration ``c`` states (each layer's leaves stacked over layers)."""
    L, D, Dm = c["layers"], c["d_model"], c["d_inner"]
    N, K, R, V = c["state"], c["conv"], c["dt_rank"], c["padded_vocab"]
    return {"embed": V * D, "unembed": D * V, "final_norm": D,
            "ln1_scale": L * D, "in_proj": L * D * 2 * Dm,
            "conv_w": L * K * Dm, "conv_b": L * Dm,
            "x_proj": L * Dm * (R + 2 * N), "dt_proj": L * R * Dm,
            "dt_bias": L * Dm, "a_log": L * Dm * N, "d_skip": L * Dm,
            "out_proj": L * Dm * D}


def step_bytes(c: dict) -> int:
    """One step's bytes over every leaf of ``c``'s weight tree."""
    f32 = set(c["float32_leaves"])
    return sum(leaf_bytes(n, 4 if name in f32 else SIZE[c["dtype"]])
               for name, n in ssm_leaves(c).items())
