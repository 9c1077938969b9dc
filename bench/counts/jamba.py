"""Model FLOPs of the jamba configurations: ``2 N tokens`` in inference,
where N counts the parameters a token passes through on this card.

N: the embedding and the untied unembedding over the padded vocabulary;
each mamba mixer (input projection, convolution, x, dt and output
projections, A, D and the dt/B/C norms; the count of the port's
``models/config.py::param_count``); each attention layer's four
projections; each dense SwiGLU; each MoE layer's router and, of its
experts, the routed share that lands here: ``top_k`` choices a token, of
which ``experts / num_experts`` fall on the held experts, each a SwiGLU of
``intermediate_size``.  Attention's score and value products are left out
(under 2 % of a prefill at 8k tokens).
"""
from __future__ import annotations


def kinds(c: dict):
    """(mixer, ffn) of every layer, from the published periods and offsets."""
    return [("attn" if i % c["attn_layer_period"] == c["attn_layer_offset"]
             else "mamba",
             "moe" if i % c["expert_layer_period"] == c["expert_layer_offset"]
             else "mlp") for i in range(c["num_hidden_layers"])]


def active_params(c: dict) -> float:
    d, f = c["hidden_size"], c["intermediate_size"]
    dm, n, r, k = c["d_inner"], c["mamba_d_state"], c["mamba_dt_rank"], c["mamba_d_conv"]
    hq, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    mamba = (d * 2 * dm + dm * k + dm * (r + 2 * n) + r * dm + dm * n + dm
             + dm * d + r + 2 * n)
    attn = d * hd * (hq + 2 * hkv) + hq * hd * d
    swiglu = 3 * d * f
    moe = d * c["num_experts"] + swiglu * c["num_experts_per_tok"] * c["experts"] / c["num_experts"]
    total = c["padded_vocab"] * d * 2
    for mixer, ffn in kinds(c):
        total += (attn if mixer == "attn" else mamba) + (moe if ffn == "moe" else swiglu)
    return total


def inference_flops(c: dict, tokens: int) -> float:
    return 2.0 * active_params(c) * tokens
