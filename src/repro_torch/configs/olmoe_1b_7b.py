"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16) expert-dff 1024 vocab 50304,
MoE 64 experts top-8. [arXiv:2409.02060; hf]

64 experts / 16 = 4 → expert-parallel over the model axis (EP).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, top_k=8, d_expert=1024,
        act="silu", gated_mlp=True, attn_shard="heads",
        moe_shard="expert", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    infer_replicate_fsdp=True,
    optimizer="adamw",
    microbatches={"train_4k": 4},
    long_context=False,
    notes="EP over model axis; GShard capacity dispatch (cf=1.25).",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=512, n_experts=8, top_k=2, d_expert=64,
        model_axis_size=2, dtype=torch.float32)
