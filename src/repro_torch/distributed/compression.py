"""Int8 gradient compression with error feedback.

The port's counterpart of ``repro/distributed/compression.py``: per-block
int8 quantisation with a float32 scale, and the quantisation residual
carried in an error-feedback buffer so the bias vanishes over steps
(Seide et al. 2014 / 1-bit Adam lineage).

    comp, err = compress(grads, err)        # int8 payload + carried error
    grads = decompress(comp)                 # dequantized f32 view

``compressed_allreduce`` is the reduction itself, over a
``torch.distributed`` process group (the reference's ``psum`` over a
``shard_map`` axis): gloo on the host; on cards, NCCL where each rank has
a card of its own, or gloo with CUDA tensors where ranks share one card
(NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..checkpoint.store import tree_flatten

__all__ = ["init_error", "compress", "decompress", "compressed_allreduce"]

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


def compressed_allreduce(grads, err, group=None):
    """Quantize → all-reduce the payload (SUM, in int32) → dequantize.

    Every rank of ``group`` (None: the default group) calls it with its
    own gradients and error buffer.  int8 payloads are summed in int32 (no
    overflow for ≤ 2^23 ranks), then rescaled by the mean of the per-block
    scales -- an approximation whose residual lands in the error-feedback
    buffer next step -- and divided by the rank count.  Returns
    ``(reduced, new_err)``: the reduced tree of float32 gradients, the
    same on every rank, and this rank's new error buffer.
    """
    comp, new_err = compress(grads, err)
    world = dist.get_world_size(group)

    def reduce_one(c):
        q32 = c["q"].to(torch.int32)
        dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
        scale = c["scale"].clone()
        dist.all_reduce(scale, op=dist.ReduceOp.SUM, group=group)
        scale = scale / world
        return _dequant({"q": q32, "scale": scale, "shape": c["shape"]}) / world

    def walk(node):
        if isinstance(node, dict) and "q" in node:
            return reduce_one(node)
        return {k: walk(v) for k, v in node.items()}

    return walk(comp), new_err
