"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) dff 12288
vocab 256000; RG-LRU + local attention 1:2 (pattern rglru,rglru,attn),
window 2048. [arXiv:2402.19427; unverified]

38 = 12 superblocks × 3 + 2 tail rglru layers. Sub-quadratic (bounded
window + O(1) LRU state): long_500k RUNS.
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        pattern=("rglru", "rglru", "attn"), window=2048, lru_width=4096,
        act="gelu", gated_mlp=True, attn_shard="heads",
        dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    infer_replicate_fsdp=True,
    optimizer="adamw",
    seq_shard_train=True,
    microbatches={"train_4k": 4},
    long_context=True,
    notes="ring KV cache bounded at window=2048; kv=1 replicated.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512, head_dim=16, window=16, lru_width=64,
        model_axis_size=2, dtype=torch.float32)
