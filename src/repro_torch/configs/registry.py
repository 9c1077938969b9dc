"""Architecture registry: the configs the port serves + reduced variants.

The port's counterpart of ``repro/configs/registry.py``.  ``ARCH_NAMES``
lists the reference's ten configs, and every one has a module in the port;
``PORT_ONLY`` lists the port's own configs, which the JAX package lacks
(the dry run and the cost model cover ``ARCH_NAMES``).  ``PORTED`` is
both.  ``get`` / ``reduced`` / ``info`` of another name raise.

``get`` returns the bare ``ModelConfig`` where the reference's returns
``(cfg, info)``; the ``ArchInfo`` (the optimizer the launcher trains with,
among the reference's per-arch choices) is ``info(name)``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Mapping

from ..models.config import ModelConfig

__all__ = ["ArchInfo", "ARCH_NAMES", "PORT_ONLY", "PORTED", "get", "info",
           "reduced"]

ARCH_NAMES = [
    "whisper_small",
    "starcoder2_15b",
    "qwen1_5_4b",
    "qwen3_14b",
    "llama3_405b",
    "falcon_mamba_7b",
    "olmoe_1b_7b",
    "granite_moe_3b_a800m",
    "recurrentgemma_9b",
    "llama3_2_vision_90b",
]


@dataclass(frozen=True)
class ArchInfo:
    optimizer: str = "adamw"  # adamw | adafactor
    # microbatch count per shape (train only; inference shapes run whole)
    microbatches: Mapping[str, int] = field(
        default_factory=lambda: {"train_4k": 4})
    # run the long_500k cell? (sub-quadratic sequence mixing only)
    long_context: bool = False
    # decode_32k KV-cache sharding: shard T on model (kv heads unshardable)
    decode_shard_kv_seq: bool = False
    # tiny models: replicate params, shard batch over the WHOLE mesh for
    # train/prefill (TP would trade cheap memory for expensive collectives)
    pure_dp: bool = False
    # gradient accumulation dtype ("float32" | "bfloat16"): the biggest
    # models accumulate in bf16 to fit (documented loss-of-precision trade)
    grad_accum_dtype: str = "float32"
    # Megatron-style sequence parallelism on the residual stream for train
    # cells (bounds the per-layer saved-activation stack of deep models)
    seq_shard_train: bool = False
    # lower train as micro_step+apply_step (external accumulation) instead
    # of one fused jit — halves peak gradient memory for the largest models
    external_accum: bool = False
    # decode KV-cache storage dtype (float8 halves MHA caches)
    kv_cache_dtype: str = "bfloat16"
    # attention impl for train cells ("auto"|"chunked"|"triangle"):
    # chunked bounds the O(S²) logits transient for wide-batch pure-DP cells
    train_attn_impl: str = "auto"
    # inference cells: replicate params over the fsdp axis (kills the
    # per-decode-step weight all-gathers; only for models whose TP-sharded
    # params fit replicated — ≲16 B)
    infer_replicate_fsdp: bool = False
    notes: str = ""


#: configs of the port alone
PORT_ONLY = ["jamba2_mini"]

#: configs with a module in the port: all of the reference's, and its own
PORTED = tuple(ARCH_NAMES + PORT_ONLY)


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(PORTED)}")
    return importlib.import_module(f".{name}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).config()


def info(name: str) -> ArchInfo:
    """The arch's ``ArchInfo`` (the second value of the reference's ``get``)."""
    return _module(name).INFO


def reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return _module(name).reduced()
