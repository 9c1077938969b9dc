"""Assigned input shapes and per-cell input specs (placements, not tensors).

The port's counterpart of ``repro/configs/shapes.py``.  The four LM shapes
from the assignment:
  train_4k     seq 4,096   global_batch 256   → train_step
  prefill_32k  seq 32,768  global_batch 32    → prefill
  decode_32k   seq 32,768  global_batch 128   → decode_step (cache = seq_len)
  long_500k    seq 524,288 global_batch 1     → decode_step, sub-quadratic
                                                 archs only

``input_specs`` returns a :class:`TensorSpec` (shape, dtype and a
``NamedSharding`` on the rules' mesh, its spec guarded where the
reference guards it) for every input of the cell's function, with the
reference's leaf paths.  Nothing is allocated:
the decode cache's tree comes from ``Model.init_cache(device="meta")``
(qwen3-14b's k cache alone is 43 GB at ``decode_32k``), and
``TensorSpec.meta()`` gives the shape-only tensor the dry run feeds the
model (``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed.sharding import NamedSharding, ShardingRules, guard_spec
from ..models.config import ModelConfig
from ..models.model import Model

__all__ = ["Shape", "SHAPES", "TensorSpec", "input_specs", "batch_specs",
           "cache_specs", "cross_stack_specs"]


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class TensorSpec:
    """One input of a cell: its global shape, dtype and placement."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding

    def meta(self) -> torch.Tensor:
        """A tensor of this shape and dtype that holds no data."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _placed(shape, dtype, rules: ShardingRules, spec) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype, NamedSharding(rules.mesh, spec))


def _guarded(shape, dtype, rules: ShardingRules, entries) -> TensorSpec:
    """A TensorSpec with ``entries`` guarded against the mesh (an entry
    whose mesh extent does not divide its dim is dropped)."""
    shape = tuple(shape)
    return _placed(shape, dtype, rules,
                   guard_spec(tuple(entries)[:len(shape)], shape,
                              rules.mesh.shape))


def _memory_shape(cfg: ModelConfig, batch: int) -> Optional[Tuple[int, int, int]]:
    """Modality-stub memory input (frames/patches), already embedded."""
    if cfg.family == "encdec":
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        return (batch, cfg.vision_seq, cfg.d_model)
    return None


def batch_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules):
    """Train/prefill batch input specs."""
    b = rules.batch_axes if rules.batch_axes else None
    tok = (shape.batch, shape.seq)
    out = {"tokens": _placed(tok, torch.int32, rules, (b, None))}
    if shape.kind == "train":
        out["labels"] = _placed(tok, torch.int32, rules, (b, None))
    mem = _memory_shape(cfg, shape.batch)
    if mem is not None:
        out["memory"] = _placed(mem, torch.bfloat16, rules, (b, None, None))
    return out


def _cache_entries(leafname: str, nd: int, rules: ShardingRules):
    """The spec entries of one decode-cache leaf, by its name."""
    b = rules.batch_axes if rules.batch_axes else None
    m = rules.model_axes if rules.model_axes else None
    if leafname in ("k", "v"):
        # (L, B, T, Hkv, hd)
        if rules.shard_kv_seq:
            return (None, b, m, None, None)
        if rules.attn_shard == "heads" and rules.kv_heads_shardable:
            return (None, b, None, m, None)
        if rules.attn_shard == "headdim":
            return (None, b, None, None, m)
        return (None, b, None, None, None)
    if leafname == "slot_pos":
        return (None, b, m if rules.shard_kv_seq else None)
    if leafname == "conv":
        return (None, b, None, m)  # (L, B, K-1, Dm)
    if leafname == "ssm":
        return (None, b, m, None)  # (L, B, Dm, N)
    if leafname == "h":
        return (None, b, m)  # (L, B, Dr)
    return (None,) * nd


def cache_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules,
                kv_dtype=None):
    """The decode cache's tree of TensorSpecs (never allocated)."""
    cache = Model(cfg).init_cache(shape.batch, shape.seq, dtype=kv_dtype,
                                  device="meta")

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _guarded(node.shape, node.dtype, rules,
                        _cache_entries(name, node.dim(), rules))

    return walk(cache, "")


def cross_stack_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules):
    """Specs of the precomputed cross-attn K/V (encdec/vlm decode input)."""
    if cfg.family == "encdec":
        t, n = cfg.encoder_seq, cfg.n_layers
    elif cfg.family == "vlm":
        t, n = cfg.vision_seq, cfg.n_super
    else:
        return None
    b = rules.batch_axes if rules.batch_axes else None
    m = rules.model_axes if rules.model_axes else None
    if rules.attn_shard == "heads" and rules.kv_heads_shardable:
        entries = (None, b, None, m, None)
    elif rules.attn_shard == "headdim":
        entries = (None, b, None, None, m)
    else:
        entries = (None, b, None, None, None)
    kv = _guarded((n, shape.batch, t, cfg.n_kv_heads, cfg.hd), cfg.dtype,
                  rules, entries)
    return {"k": kv, "v": kv}


def input_specs(cfg: ModelConfig, shape: Shape, rules: ShardingRules,
                kv_dtype=None) -> Dict[str, Any]:
    """All inputs of the cell's function, as TensorSpecs."""
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape, rules)
    # decode: one new token against a filled cache
    b = rules.batch_axes if rules.batch_axes else None
    out = {
        "token": _placed((shape.batch,), torch.int32, rules, (b,)),
        "index": _placed((shape.batch,), torch.int32, rules, (b,)),
        "cache": cache_specs(cfg, shape, rules, kv_dtype=kv_dtype),
    }
    cross = cross_stack_specs(cfg, shape, rules)
    if cross is not None:
        out["cross_stack"] = cross
    return out
