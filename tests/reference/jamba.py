"""Plain float32 AI21-Jamba2-Mini: the published forward pass, one sequence.

The architecture of https://huggingface.co/ai21labs/AI21-Jamba2-Mini
(config.json; the block of transformers' ``JambaForCausalLM``), written in
plain torch operations: no kernel, cache or batching of any package.
Token embedding; per layer ``x += mixer(rms_norm(x))``, then
``x += ffn(rms_norm(x))``; a final RMSNorm; an untied unembedding.  The
mixer is attention where ``i % attn_layer_period == attn_layer_offset``
and mamba-1 elsewhere; the FFN is the MoE where ``i % expert_layer_period
== expert_layer_offset`` and a dense SwiGLU elsewhere.

  * RMSNorm: ``w · x / sqrt(mean(x²) + eps)``.
  * Mamba-1 mixer: ``[x | z] = h W_in`` (no bias); a causal depthwise
    convolution of ``conv`` taps with bias, then SiLU; ``[dt | B | C] =
    x W_x``; RMSNorm of dt, of B and of C, each with its own weight;
    ``dt = softplus(dt W_dt + b_dt)``; the selective scan ``h_t =
    exp(dt_t A) h_{t-1} + dt_t x_t B_t`` with ``A = -exp(A_log)``, one step
    at a time; ``y_t = h_t C_t + D x_t``, gated by ``silu(z)``; ``y W_out``.
  * Attention: GQA, query head q reads KV head ``q // (H / Hkv)``, scores
    scaled by ``1/sqrt(head_dim)``, causal, no positional encoding, no
    bias.
  * MoE: router logits ``h W_r`` in float32, softmax, the top k (ties to
    the lower index) with their probabilities as they are (not
    renormalised); each chosen expert's SwiGLU ``W_d (silu(h W_g) * h
    W_u)`` weighted by its probability.  Every choice is computed
    (dropless).

Departures, as the program runs it:
  * the layer holds a share of the experts, ``held = (first, count)``:
    choices of the other experts add nothing (one card of an
    expert-parallel deployment, its exchange not run); ``(0, E)`` is the
    published layer;
  * the router's weight is kept in float32.

Weights (float32 or any dtype, computed in float32) are given as
``{"embed" (V, D), "unembed" (D, V), "final_norm" (D,), "layers": [...]}``,
each layer a dict of its norm weights ``ln1`` and ``ln2`` and its matrices
in ``x @ W`` form (see the keys read below); ``cfg`` holds the published
sizes under the names read below.  TF32 is off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def mamba(x, p, cfg):
    """x (S, D) → (S, D)."""
    s = x.shape[0]
    k, n, r = cfg["conv"], cfg["state"], cfg["dt_rank"]
    xz = x @ p["in_proj"].float()
    dm = xz.shape[1] // 2
    x1, z = xz[:, :dm], xz[:, dm:]
    xp = torch.cat([x1.new_zeros((k - 1, dm)), x1])
    w = p["conv_w"].float()  # (K, Dm): tap j reads x[t - K + 1 + j]
    x1 = F.silu(sum(w[j] * xp[j:j + s] for j in range(k)) + p["conv_b"].float())
    dt, b, c = torch.split(x1 @ p["x_proj"].float(), [r, n, n], dim=-1)
    eps = cfg["norm_eps"]
    dt = rms_norm(dt, p["dt_norm"], eps)
    b = rms_norm(b, p["b_norm"], eps)
    c = rms_norm(c, p["c_norm"], eps)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())  # (Dm, N)
    h = x1.new_zeros((dm, n))
    ys = []
    for t in range(s):
        h = torch.exp(dt[t][:, None] * a) * h + (dt[t] * x1[t])[:, None] * b[t]
        ys.append(h @ c[t])
    y = torch.stack(ys) + p["D"].float() * x1
    return (y * F.silu(z)) @ p["out_proj"].float()


def attention(x, p, cfg):
    """x (S, D) → (S, D): causal GQA without positions."""
    s = x.shape[0]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (x @ p["wq"].float()).reshape(s, hq, hd)
    k = (x @ p["wk"].float()).reshape(s, hkv, hd)
    v = (x @ p["wv"].float()).reshape(s, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", probs, v).reshape(s, hq * hd) @ p["wo"].float()


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate.float()) * (x @ w_up.float())) @ w_down.float()


def moe(x, p, cfg):
    """x (S, D) → (S, D): the held experts' part of the dropless top-k."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top.values[:, :cfg["top_k"]]
    expert = top.indices[:, :cfg["top_k"]]
    first, count = cfg["held"]
    out = torch.zeros_like(x)
    for e in range(first, first + count):
        tok, slot = (expert == e).nonzero(as_tuple=True)
        if len(tok):
            y = swiglu(x[tok], p["w_gate"][e - first], p["w_up"][e - first],
                       p["w_down"][e - first])
            out.index_add_(0, tok, gate[tok, slot][:, None] * y)
    return out


def logits(params, tokens, cfg):
    """(S,) token ids → (S, V) float32 logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["norm_eps"]
    x = params["embed"][tokens.long()].float()
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["ln1"], eps)
        if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]:
            x = x + attention(h, p, cfg)
        else:
            x = x + mamba(h, p, cfg)
        h = rms_norm(x, p["ln2"], eps)
        if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]:
            x = x + moe(h, p, cfg)
        else:
            x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return rms_norm(x, params["final_norm"], eps) @ params["unembed"].float()
