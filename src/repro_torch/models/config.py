"""Model configuration of the families the port runs.

The port's copy of ``repro/models/config.py`` with torch dtypes, cut to the
fields the ``dense``, ``ssm`` and ``hybrid`` families read.  ``family`` may
still name ``moe``, ``vlm`` or ``encdec``; ``Model`` and ``init_params``
raise for them.

Layers are organized into homogeneous *superblocks* whose params are
stacked on a leading axis (the port loops over it in Python):

  dense     : superblock = 1 block, n_super = n_layers
  ssm       : superblock = 1 mamba block
  hybrid    : superblock = pattern (e.g. rglru, rglru, attn), plus a tail
              stack for the remainder layers
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

__all__ = ["ModelConfig"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads

    # -- attention flavour ---------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False  # qwen3: RMSNorm on q,k per head
    qkv_bias: bool = False  # qwen1.5
    window: Optional[int] = None  # sliding-window for local-attn layers
    gated_mlp: bool = True  # llama/qwen SwiGLU vs whisper/starcoder GELU
    act: str = "silu"

    # -- SSM (mamba-1) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)

    # -- hybrid (recurrentgemma) --------------------------------------------------
    pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0  # 0 → d_model

    # -- numerics ------------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    # model-axis size the padding rules target (fixed by the production mesh)
    model_axis_size: int = 16

    # ---------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the 'model'-sharded dim divides the mesh axis."""
        return _round_up(self.vocab_size, 128 * self.model_axis_size)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    # superblock decomposition -------------------------------------------------
    @property
    def superblock(self) -> Tuple[str, ...]:
        if self.family == "dense":
            return ("attn",)
        if self.family == "ssm":
            return ("mamba",)
        if self.family == "hybrid":
            return self.pattern or ("rglru", "rglru", "attn")
        raise ValueError(self.family)

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.superblock)

    @property
    def n_tail(self) -> int:
        """Remainder layers that do not fill a superblock (hybrid: 38 % 3)."""
        return self.n_layers % len(self.superblock)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
