"""starcoder2-15b [dense]: 40L d6144 48H (GQA kv=4) dff 24576 vocab 49152.
GQA + RoPE; GELU FFN (non-gated), per the starcoder2 family.
[arXiv:2402.19173; hf]

48 heads / 16 = 3 → heads-mode TP; kv=4 replicated across the model axis
(weights are small); decode_32k therefore shards the KV cache's SEQ dim
on the model axis (flash-decode layout).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        gated_mlp=False, act="gelu", rope_theta=1e5,
        attn_shard="heads", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    infer_replicate_fsdp=True,
    optimizer="adamw",
    seq_shard_train=True,
    microbatches={"train_4k": 4},
    long_context=False,
    decode_shard_kv_seq=True,
    notes="kv=4 not divisible by model axis → cache seq-sharded at decode.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab_size=512, model_axis_size=2, dtype=torch.float32)
