"""llama3-405b [dense]: 126L d16384 128H (GQA kv=8) dff 53248 vocab 128256.
[arXiv:2407.21783; unverified]

Fit strategy on 256 chips (DESIGN §5): Adafactor (factored second moment,
no momentum), bf16 params, full remat, 16 microbatches for train_4k;
decode_32k shards the KV cache seq dim on the model axis (kv=8 < 16).
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab_size=128256,
        rope_theta=5e5, act="silu", gated_mlp=True,
        attn_shard="heads", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    optimizer="adafactor",
    microbatches={"train_4k": 16},
    long_context=False,
    grad_accum_dtype="bfloat16",
    seq_shard_train=True,
    external_accum=True,
    decode_shard_kv_seq=True,
    notes="largest assigned config; Adafactor + full remat to fit 4 TB HBM.",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384,
        vocab_size=512, model_axis_size=2, dtype=torch.float32)
