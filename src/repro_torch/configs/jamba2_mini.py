"""AI21-Jamba2-Mini [hybrid]: 32L d4096, vocab 65536, untied head; 28
mamba-1 mixers (state 16, conv 4, expand 2, dt_rank 256, RMSNorm on dt, B
and C) and 4 GQA attention layers (32H, kv 8, head 128, no positional
encoding) where i % 8 == 4; a dropless top-2 MoE of 16 SwiGLU experts of
width 14336 (float32 softmax, not renormalised) where i % 2 == 1, a dense
SwiGLU of 14336 elsewhere.
[https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json]

The port's own config: the JAX package has no twin.  The layer order
follows transformers' ``JambaConfig.layers_block_type`` (the config gives
periods and offsets only).  The 8-layer superblock is (mamba+MLP,
mamba+MoE, mamba+MLP, mamba+MoE, attn+MLP, mamba+MoE, mamba+MLP,
mamba+MoE), 4 of them.  ``config()`` holds all 16 experts (51.6B
parameters, 103 GB in bfloat16); ``.replace(held_experts=(0, 8))`` is one
card of a two-way expert-parallel deployment (29.0B, 58 GB).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo

PATTERN = ("mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe",
           "attn", "mamba_moe", "mamba_mlp", "mamba_moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba2-mini", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536, pattern=PATTERN, use_rope=False,
        n_experts=16, top_k=2, d_expert=14336, moe_routing="dropless",
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        dt_rank=256, mamba_norms=True, norm_eps=1e-6,
        act="silu", gated_mlp=True, dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    optimizer="adamw",
    notes="mamba-1 + RoPE-free GQA 7:1, dropless top-2 MoE every other "
          "layer; linear KV cache on the 4 attention layers.",
)


def reduced() -> ModelConfig:
    """One period at d_model 128: 4 heads over 2 KV heads, 4 of 8 experts
    held, vocab 2048."""
    return config().replace(
        held_experts=(0, 4),
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, n_layers=8,
        d_ff=256, d_expert=256, n_experts=8, vocab_size=2048, dt_rank=8,
        model_axis_size=2, dtype=torch.float32)
