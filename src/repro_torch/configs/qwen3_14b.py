"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) dff 17408 vocab 151936,
qk_norm. [hf:Qwen/Qwen3-8B; hf]

40 heads % 16 ≠ 0 → headdim-mode TP (hd 128 / 16 = 8).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab_size=151936, head_dim=128,
        qk_norm=True, rope_theta=1e6, act="silu", gated_mlp=True,
        attn_shard="headdim", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    decode_shard_kv_seq=True,
    infer_replicate_fsdp=True,
    optimizer="adamw",
    seq_shard_train=True,
    microbatches={"train_4k": 4},
    long_context=False,
    notes="qk-norm per head; headdim sharding (40H, 8kv).",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab_size=512, head_dim=16, model_axis_size=2, dtype=torch.float32)
