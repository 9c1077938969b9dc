"""Int8 gradient compression with error feedback.

The port's counterpart of ``repro/distributed/compression.py``: per-block
int8 quantisation with a float32 scale, and the quantisation residual
carried in an error-feedback buffer so the bias vanishes over steps
(Seide et al. 2014 / 1-bit Adam lineage).

    comp, err = compress(grads, err)        # int8 payload + carried error
    grads = decompress(comp)                 # dequantized f32 view

``compressed_allreduce`` (the reduction over a mesh axis) waits for the
port's sharding (``ROADMAP.md`` §1, item 7).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..checkpoint.store import tree_flatten

__all__ = ["init_error", "compress", "decompress"]

BLOCK = 2048


def init_error(params):
    leaves, rebuild = tree_flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in leaves])


def _quant_one(g: torch.Tensor, e: torch.Tensor):
    g = g.float() + e
    flat = g.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:n].reshape(g.shape)
    err = g - deq
    return {"q": q, "scale": scale, "shape": tuple(g.shape)}, err


def compress(grads, err) -> Tuple[Any, Any]:
    g_leaves, rebuild = tree_flatten(grads)
    outs = [_quant_one(g, e) for g, e in zip(g_leaves, tree_flatten(err)[0])]
    return rebuild([o[0] for o in outs]), rebuild([o[1] for o in outs])


def _dequant(c) -> torch.Tensor:
    n = 1
    for d in c["shape"]:
        n *= d
    return (c["q"].float() * c["scale"]).reshape(-1)[:n].reshape(c["shape"])


def decompress(comp):
    if isinstance(comp, dict) and "q" in comp:
        return _dequant(comp)
    return {k: decompress(v) for k, v in comp.items()}
