"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) expert-dff 512
vocab 49155, MoE 40 experts top-8. [hf:ibm-granite; hf]

40 experts % 16 ≠ 0 → moe_shard="ffn" (expert-FFN dim 512/16=32, experts
replicated); 24 heads % 16 ≠ 0 → headdim TP (hd 64/16=4).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        n_experts=40, top_k=8, d_expert=512,
        act="silu", gated_mlp=True, attn_shard="headdim",
        moe_shard="ffn", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    decode_shard_kv_seq=True,
    infer_replicate_fsdp=True,
    optimizer="adamw",
    microbatches={"train_4k": 2},
    long_context=False,
    notes="E=40 unshardable on 16 → TP inside experts (moe_shard=ffn).",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=512, n_experts=6, top_k=2, d_expert=32,
        model_axis_size=2, dtype=torch.float32)
