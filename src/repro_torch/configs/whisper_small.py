"""whisper-small [audio]: 12L enc + 12L dec, d768, 12H (kv=12), dff 3072,
vocab 51865; conv frontend STUBBED — the caller supplies (B, 1500, 768)
precomputed frame embeddings as the memory. [arXiv:2212.04356; unverified]

12 heads % 16 ≠ 0 → attn_shard="headdim" (hd 64 / 16 = 4). LayerNorm +
GELU FFN + learned positional table (no RoPE), per the whisper family.
"""
import torch

from ..models.config import ModelConfig
from .registry import ArchInfo


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        n_encoder_layers=12, encoder_seq=1500,
        max_pos_embed=40960,  # covers the decode_32k cache + headroom
        gated_mlp=False, act="gelu", qkv_bias=True,
        attn_shard="headdim", dtype=torch.bfloat16,
    )


INFO = ArchInfo(
    infer_replicate_fsdp=True,
    optimizer="adamw",
    microbatches={"train_4k": 1},
    long_context=False,
    decode_shard_kv_seq=True,  # seq-sharded cache: partial softmax, no hd psums
    pure_dp=True,
    train_attn_impl="chunked",  # 0.25B params: replicate, batch over the full mesh
    notes="enc-dec; decode shapes run the DECODER against a stubbed encoder "
          "memory of 1500 frames; long_500k skipped (full attention).",
)


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, encoder_seq=32, max_pos_embed=256,
        model_axis_size=2, dtype=torch.float32)
