"""qwen1.5-4b [dense]: 40L d2560 20H (kv=20, MHA) dff 6912 vocab 151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

20 heads % 16 ≠ 0 → headdim-mode TP (hd 128 / 16 = 8); caches shard hd.
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=1e6, act="silu", gated_mlp=True,
        attn_shard="headdim", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    decode_shard_kv_seq=True,
    infer_replicate_fsdp=True,
    optimizer="adamw",
    seq_shard_train=True,
    microbatches={"train_4k": 4},
    long_context=False,
    kv_cache_dtype="float8_e4m3fn",  # MHA kv=20: 3.4 TB cache → 1.7 TB
    notes="MHA kv=20: headdim sharding keeps cache distributed 256-way.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=5, d_ff=192,
        vocab_size=512, model_axis_size=2, dtype=torch.float32)
