"""Plain float32 AI21-Jamba2-Mini, computed in blocks: the benchmark's frozen
copy of the reference, for one sequence at a time at the timed sizes.

The architecture of https://huggingface.co/ai21labs/AI21-Jamba2-Mini
(config.json; transformers' ``JambaForCausalLM``): token embedding; per
layer ``x += mixer(rms_norm(x))``, then ``x += ffn(rms_norm(x))``; a final
RMSNorm; an untied unembedding.  Layer i's mixer is attention where ``i %
attn_layer_period == attn_layer_offset``, mamba-1 elsewhere; its FFN is the
MoE where ``i % expert_layer_period == expert_layer_offset``, a dense
SwiGLU elsewhere.

  * RMSNorm: ``w · x / sqrt(mean(x²) + eps)``.
  * Mamba-1: ``[x | z] = h W_in``; causal depthwise convolution of
    ``conv`` taps with bias, SiLU; ``[dt | B | C] = x W_x``; RMSNorm of dt,
    B and C; ``dt = softplus(dt W_dt + b_dt)``; ``h_t = exp(dt_t A)
    h_{t-1} + dt_t x_t B_t``, ``A = -exp(A_log)``; ``y_t = h_t C_t + D
    x_t``, gated by ``silu(z)``; ``y W_out``.  The scan runs in blocks of
    ``scan_block`` steps, composed by doubling inside a block (after the
    passes, each step holds the block's sums from its start and the
    product of its decays), the state carried from block to block.
  * Attention: GQA (query head q reads KV head ``q // (H / Hkv)``),
    scaled by ``1/sqrt(head_dim)``, causal, no positional encoding, in
    blocks of ``query_block`` queries.
  * MoE: float32 router, softmax, top k (ties to the lower index), the
    probabilities as they are; every choice computed (dropless).

Departures, as the program runs it: the layer holds a share of the
experts, ``held = (first, count)``, and choices of the others add nothing
(one card of an expert-parallel deployment); the router's weight is
float32.  Weights are read in their stored dtype and computed in float32
(TF32 off): ``{"embed", "unembed", "final_norm", "layers": [...]}``, each
layer a dict of its norm weights ``ln1``, ``ln2`` and its matrices in
``x @ W`` form.  ``low`` turns the reference into the control: every
operand of a product with a stored bfloat16 weight rounded through that
dtype (float8 e4m3 with a per-tensor scale, the precision below
bfloat16); the float32 router is left as it is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.mamba import _round, no_tf32


def _mm(a: torch.Tensor, w: torch.Tensor, low) -> torch.Tensor:
    return _round(a, low) @ _round(w.float(), low)


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _scan(da, dbx, h0):
    """h_t = da_t h_{t-1} + dbx_t over dim 0 from h0, by doubling."""
    a, h = da, dbx
    k = 1
    while k < h.shape[0]:
        h = torch.cat([h[:k], a[k:] * h[:-k] + h[k:]])
        a = torch.cat([a[:k], a[k:] * a[:-k]])
        k *= 2
    return h + a * h0


def mamba(x, p, cfg, low=None, scan_block=256):
    s = x.shape[0]
    k, n, r = cfg["conv"], cfg["state"], cfg["dt_rank"]
    xz = _mm(x, p["in_proj"], low)
    dm = xz.shape[1] // 2
    x1, z = xz[:, :dm], xz[:, dm:]
    xp = torch.cat([x1.new_zeros((k - 1, dm)), x1])
    w = p["conv_w"].float()
    x1 = F.silu(sum(w[j] * xp[j:j + s] for j in range(k)) + p["conv_b"].float())
    del xp, xz
    dt, b, c = torch.split(_mm(x1, p["x_proj"], low), [r, n, n], dim=-1)
    eps = cfg["norm_eps"]
    dt = rms_norm(dt, p["dt_norm"], eps)
    b = rms_norm(b, p["b_norm"], eps)
    c = rms_norm(c, p["c_norm"], eps)
    dt = F.softplus(_mm(dt, p["dt_proj"], low) + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    h = x1.new_zeros((dm, n))
    y = torch.empty_like(x1)
    for t in range(0, s, scan_block):
        sl = slice(t, t + scan_block)
        hs = _scan(torch.exp(dt[sl, :, None] * a),
                   (dt[sl] * x1[sl])[:, :, None] * b[sl, None, :], h)
        y[sl] = torch.einsum("tdn,tn->td", hs, c[sl])
        h = hs[-1]
        del hs
    y = (y + p["D"].float() * x1) * F.silu(z)
    return _mm(y, p["out_proj"], low)


def attention(x, p, cfg, low=None, query_block=1024):
    s = x.shape[0]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _mm(x, p["wq"], low).reshape(s, hq, hd)
    k = _mm(x, p["wk"], low).reshape(s, hkv, hd).repeat_interleave(hq // hkv, 1)
    v = _mm(x, p["wv"], low).reshape(s, hkv, hd).repeat_interleave(hq // hkv, 1)
    out = torch.empty_like(q)
    for t in range(0, s, query_block):
        rows = torch.arange(t, min(t + query_block, s), device=x.device)
        scores = torch.einsum("shd,thd->hst", q[rows], k) / math.sqrt(hd)
        seen = torch.arange(s, device=x.device)[None, :] <= rows[:, None]
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
        out[rows] = torch.einsum("hst,thd->shd", probs, v)
        del scores, probs
    return _mm(out.reshape(s, hq * hd), p["wo"], low)


def swiglu(x, w_gate, w_up, w_down, low=None):
    return _mm(F.silu(_mm(x, w_gate, low)) * _mm(x, w_up, low), w_down, low)


def moe(x, p, cfg, low=None):
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top.values[:, :cfg["top_k"]]
    expert = top.indices[:, :cfg["top_k"]]
    first, count = cfg["held"]
    out = torch.zeros_like(x)
    for e in range(first, first + count):
        tok, slot = (expert == e).nonzero(as_tuple=True)
        if len(tok):
            i = e - first
            y = swiglu(x[tok], p["w_gate"][i], p["w_up"][i], p["w_down"][i], low)
            out.index_add_(0, tok, gate[tok, slot][:, None] * y)
    return out


def logits_at(params, tokens: torch.Tensor, cfg: dict, positions, *, low=None,
              scan_block: int = 256, query_block: int = 1024) -> torch.Tensor:
    """(S,) token ids → the float32 logits (len(positions), V) at
    ``positions``."""
    no_tf32()
    eps = cfg["norm_eps"]
    x = params["embed"][tokens.long()].float()
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["ln1"], eps)
        if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]:
            x = x + attention(h, p, cfg, low, query_block)
        else:
            x = x + mamba(h, p, cfg, low, scan_block)
        h = rms_norm(x, p["ln2"], eps)
        if i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]:
            x = x + moe(h, p, cfg, low)
        else:
            x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"], low)
        del h
    x = rms_norm(x[torch.as_tensor(positions, device=x.device).long()],
                 params["final_norm"], eps)
    return _mm(x, params["unembed"], low)
