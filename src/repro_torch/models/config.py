"""Model configuration of the families the port runs.

The port's copy of ``repro/models/config.py`` with torch dtypes, cut to the
fields the port's families read (every family of the reference: ``dense``,
``moe``, ``ssm``, ``hybrid``, ``vlm`` and ``encdec``).

Layers are organized into homogeneous *superblocks* whose params are
stacked on a leading axis (the port loops over it in Python):

  dense/moe : superblock = 1 block, n_super = n_layers
  ssm       : superblock = 1 mamba block
  hybrid    : superblock = pattern (e.g. rglru, rglru, attn), plus a tail
              stack for the remainder layers; a pattern may also pair a
              mamba mixer with a dense or MoE FFN (``mamba_mlp``,
              ``mamba_moe``: jamba)
  vlm       : superblock = (cross_attn_every-1) self blocks + 1 cross block
  encdec    : separate encoder (bidirectional) and decoder (self+cross) stacks

Sharding-relevant knobs (``attn_shard``, ``moe_shard``) choose which weight
dim maps onto the mesh "model" axis, because head/expert counts are not
always divisible by 16 (whisper 12H, qwen1.5 20H, qwen3 40H, granite 40E).
``models/params.py`` and ``distributed/sharding.py`` read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

__all__ = ["ModelConfig", "PORT_FIELDS"]

#: fields of the port's own configs (jamba) that the JAX package's config
#: lacks; at their defaults a config computes as the reference's does
PORT_FIELDS = ("use_rope", "moe_routing", "held_experts", "mamba_norms")


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
    use_rope: bool = True  # False: no positional encoding (jamba)
    qk_norm: bool = False  # qwen3: RMSNorm on q,k per head
    qkv_bias: bool = False  # qwen1.5
    window: Optional[int] = None  # sliding-window for local-attn layers
    gated_mlp: bool = True  # llama/qwen SwiGLU vs whisper/starcoder GELU
    act: str = "silu"

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "capacity": GShard groups, top-k renormalised, overflow dropped;
    # "dropless": every choice computed, the top-k probabilities as they are
    moe_routing: str = "capacity"
    # (first, count) of the experts this model holds under its router of
    # n_experts outputs (expert parallelism; dropless only); None: all
    held_experts: Optional[Tuple[int, int]] = None

    # -- SSM (mamba-1) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)
    mamba_norms: bool = False  # RMSNorm on dt, B and C after x_proj (jamba)

    # -- hybrid (recurrentgemma) --------------------------------------------------
    pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0  # 0 → d_model

    # -- encoder-decoder (whisper) --------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # stubbed frontend length (whisper: 1500 frames)
    max_pos_embed: int = 0  # >0 → learned/sinusoidal pos table (no RoPE)

    # -- VLM (cross-attention image layers) -------------------------------------------
    cross_attn_every: int = 0  # 5 → one cross layer per 5
    vision_seq: int = 0  # stubbed patch-embedding length

    # -- numerics / sharding ----------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    attn_shard: str = "heads"  # heads | headdim (model-axis mapping)
    moe_shard: str = "expert"  # expert | ffn
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

    @property
    def held(self) -> Tuple[int, int]:
        """(first, count) of the experts held: all of them by default."""
        return self.held_experts or (0, self.n_experts)

    # superblock decomposition -------------------------------------------------
    @property
    def superblock(self) -> Tuple[str, ...]:
        if self.family == "dense":
            return ("attn",)
        if self.family == "moe":
            return ("moe",)
        if self.family == "ssm":
            return ("mamba",)
        if self.family == "hybrid":
            return self.pattern or ("rglru", "rglru", "attn")
        if self.family == "vlm":
            k = self.cross_attn_every or 5
            return ("attn",) * (k - 1) + ("cross",)
        if self.family == "encdec":
            return ("attn",)  # decoder superblock; encoder handled separately
        raise ValueError(self.family)

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.superblock)

    @property
    def n_tail(self) -> int:
        """Remainder layers that do not fill a superblock (hybrid: 38 % 3)."""
        return self.n_layers % len(self.superblock)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The block kind of every layer, in order (superblocks, then tail)."""
        sb = self.superblock
        return sb * self.n_super + sb[: self.n_tail]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline.

        The reference's own count: in ``encdec`` it is the encoder and
        decoder layers at attn + mlp each, without the decoder's cross
        stack, the biases or the position tables."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        H, Hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        n = V * D * (1 if self.tie_embeddings else 2)  # embed (+unembed)
        attn = D * hd * (H + 2 * Hkv) + H * hd * D
        mlp = (3 if self.gated_mlp else 2) * D * F
        e_mlp = (3 if self.gated_mlp else 2) * D * self.d_expert
        moe = self.held[1] * e_mlp + D * self.n_experts
        Dm, N, R = self.d_inner, self.ssm_state, self.dt_rank_actual
        mamba = D * 2 * Dm + Dm * self.ssm_conv + Dm * (R + 2 * N) \
            + R * Dm + Dm * N + Dm + Dm * D
        if self.mamba_norms:
            mamba += R + 2 * N
        if self.family == "hybrid":
            Dr = self.lru_dim
            rglru = D * 2 * Dr + Dr * self.ssm_conv + 2 * Dr + Dr * D + Dr * Dr // 8
            per_kind = {"attn": attn + mlp, "moe": attn + moe,
                        "rglru": rglru + mlp, "mamba_mlp": mamba + mlp,
                        "mamba_moe": mamba + moe}
            return n + sum(per_kind[k] for k in self.layer_kinds)
        if self.family == "moe":
            per_layer = attn + moe
        elif self.family == "ssm":
            per_layer = mamba
        elif self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + mlp
        else:
            raise ValueError(self.family)
        return n + (self.n_layers + self.n_encoder_layers) * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of experts; of held
        experts, the share of the top k routed to them)."""
        n_moe = sum(k in ("moe", "mamba_moe") for k in self.layer_kinds)
        if not n_moe:
            return self.param_count()
        e_mlp = (3 if self.gated_mlp else 2) * self.d_model * self.d_expert
        held = self.held[1]
        dense_part = self.param_count() - n_moe * held * e_mlp
        return dense_part + n_moe * e_mlp * self.top_k * held // self.n_experts
