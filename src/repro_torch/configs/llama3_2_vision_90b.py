"""llama-3.2-vision-90b [vlm]: 100L d8192 64H (GQA kv=8) dff 28672
vocab 128256; cross-attention image layers every 5th layer (20 total);
vision frontend STUBBED — the caller supplies (B, 1601→1600, 8192)
precomputed patch embeddings as the memory. [hf:meta-llama; unverified]
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab_size=128256,
        cross_attn_every=5, vision_seq=1600,
        rope_theta=5e5, act="silu", gated_mlp=True, attn_shard="heads",
        dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    optimizer="adamw",
    microbatches={"train_4k": 8},
    long_context=False,
    grad_accum_dtype="bfloat16",
    seq_shard_train=True,
    external_accum=True,
    decode_shard_kv_seq=True,
    notes="20 superblocks of (4 self + 1 gated cross); kv=8 < 16 → "
          "decode cache seq-sharded.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, vision_seq=16, model_axis_size=2, dtype=torch.float32)
