"""falcon-mamba-7b [ssm]: 64L d4096 attention-free, vocab 65024,
ssm_state=16 (mamba-1 blocks). [arXiv:2410.05355; unverified]

Sub-quadratic: long_500k RUNS (O(1) state per token). d_inner 8192/16 ✓.
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=65024,
        ssm_state=16, ssm_conv=4, ssm_expand=2,
        dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    infer_replicate_fsdp=True,
    optimizer="adamw",
    seq_shard_train=True,
    microbatches={"train_4k": 4},
    long_context=True,
    notes="attention-free; decode state is O(1) — long_500k applicable.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, d_ff=0, vocab_size=512, ssm_state=8,
        model_axis_size=2, dtype=torch.float32)
