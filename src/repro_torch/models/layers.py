"""Core layer primitives (plain functions over param dicts).

The port's counterpart of ``repro/models/layers.py``.  The reference
computes these outside any Pallas kernel, so they are plain torch here.
Layouts are the reference's: activations (B, S, D), heads (B, S, H, hd).

``attention``, ``mlp`` and the loss take an optional ``rules``
(``distributed.sharding.ShardingRules`` or None).  ``constrain`` applies
``rules.act(x, kind)``, which on the port's single-controller mesh checks
the constraint and returns ``x``: a run with rules computes what it
computes without.

Attention implementations:
  * ``full``     — materialized logits; fine for short seq / decode.
  * ``chunked``  — a loop over q chunks, full-T softmax per chunk; bounds
                   transient memory to O(cq·T).
  * ``triangle`` — a loop over q chunks whose key extent grows with the
                   chunk (causal): skips the logits past the diagonal.
  * ``pallas``   — flash attention (``kernels/flash_attention``): the
                   hand-written CUDA kernel K4 on the card, its plain
                   version on the CPU; ``"cuda"`` is the same path.  The
                   kernel takes ONE query offset per call, so the
                   positions must be ``q_offset + arange(S)`` in every row
                   and the keys' ``arange(T)``; anything else (per-slot
                   decode, a ring cache) raises ValueError.  The offset is
                   read from ``q_positions``, not taken as ``T − S`` as the
                   reference does: the two differ whenever the keys are a
                   cache longer than the prompt (ROADMAP.md §3).  A call
                   with ``causal=False`` and no window (an encoder, cross
                   attention) masks nothing by position: its offset is 0
                   and the positions are not read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention

__all__ = ["rms_norm", "layer_norm", "rope", "attention", "mlp", "gelu",
           "softmax_cross_entropy", "constrain"]

NEG_INF = -1e30


def constrain(x, rules, kind: str):
    return rules.act(x, kind) if rules is not None else x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (half-rotation, llama convention)
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _mask(q_pos, k_pos, causal, window):
    """(B,S),(B,T) → (B,S,T) boolean visibility mask."""
    b, s = q_pos.shape
    t = k_pos.shape[1]
    m = torch.ones((b, s, t), dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m = m & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return m


def _sdpa_full(q, k, v, q_pos, k_pos, *, causal, window, scale):
    """q (B,S,H,hd), k/v (B,T,Hkv,hd) — GQA via head grouping."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    # float32 logits, as the reference's preferred_element_type=float32
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = _mask(q_pos, k_pos, causal, window)  # (B, S, T)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, hd)


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, window, scale, chunk_q):
    s = q.shape[1]
    if s % chunk_q:
        chunk_q = s
    outs = [_sdpa_full(q[:, i:i + chunk_q], k, v, q_pos[:, i:i + chunk_q],
                       k_pos, causal=causal, window=window, scale=scale)
            for i in range(0, s, chunk_q)]
    return torch.cat(outs, dim=1)


def _sdpa_triangle(q, k, v, q_pos, k_pos, *, causal, window, scale, chunk_q):
    """Static q-chunk loop; k extent grows with the chunk (causal-only)."""
    s, t = q.shape[1], k.shape[1]
    if s % chunk_q:
        return _sdpa_full(q, k, v, q_pos, k_pos, causal=causal, window=window,
                          scale=scale)
    outs = []
    prefix = t - s  # cache prefix before q[0] (0 for self-attn training)
    for i in range(s // chunk_q):
        rows = slice(i * chunk_q, (i + 1) * chunk_q)
        k_hi = prefix + (i + 1) * chunk_q
        k_lo = 0
        if window is not None:
            k_lo = max(0, prefix + i * chunk_q - window + 1)
            k_lo = (k_lo // chunk_q) * chunk_q  # align for layout stability
        outs.append(_sdpa_full(q[:, rows], k[:, k_lo:k_hi], v[:, k_lo:k_hi],
                               q_pos[:, rows], k_pos[:, k_lo:k_hi],
                               causal=causal, window=window, scale=scale))
    return torch.cat(outs, dim=1)


def _one_offset(q_positions, k_positions) -> int:
    """The one query offset the positions express, or ValueError."""
    s, t = q_positions.shape[1], k_positions.shape[1]
    dev = q_positions.device
    rel = q_positions - torch.arange(s, device=dev)
    bad = (rel != rel[:1, :1]).any() | \
        (k_positions != torch.arange(t, device=dev)).any()
    offset, bad = torch.stack([rel[0, 0].long(), bad.long()]).tolist()
    if bad:
        raise ValueError(
            "attention impl 'pallas' runs a kernel that takes one query "
            "offset per call: q_positions must be q_offset + arange(S) in "
            "every row and k_positions arange(T) (per-slot decode and ring "
            "caches go through 'auto', 'full' or 'chunked')")
    return offset


def attention(
    q, k, v,
    *,
    q_positions,  # (B, S)
    k_positions,  # (B, T)
    causal: bool = True,
    window: Optional[int] = None,
    impl: str = "auto",
    chunk_q: int = 256,  # bounds the (B,H,cq,T) logits transient
    rules=None,
    scale: Optional[float] = None,
):
    """Dispatching scaled-dot-product attention. Layouts: (B, S, H, hd)."""
    s, hd = q.shape[1], q.shape[3]
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if impl == "auto":
        impl = "full" if (s * t <= 4096 * 4096 or s == 1) else "chunked"
    if impl in ("pallas", "cuda"):
        positional = causal or window is not None
        q_offset = _one_offset(q_positions, k_positions) if positional else 0
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale, q_offset=q_offset,
            impl="cuda")
        return out.transpose(1, 2)
    if impl == "full":
        return _sdpa_full(q, k, v, q_positions, k_positions, causal=causal,
                          window=window, scale=scale)
    if impl == "chunked":
        return _sdpa_chunked(q, k, v, q_positions, k_positions, causal=causal,
                             window=window, scale=scale, chunk_q=chunk_q)
    if impl == "triangle":
        return _sdpa_triangle(q, k, v, q_positions, k_positions, causal=causal,
                              window=window, scale=scale, chunk_q=chunk_q)
    raise ValueError(f"unknown attention impl {impl}")


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def gelu(x):
    """gelu with the tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else gelu(x)


def mlp(x, p, *, gated: bool, act: str, rules=None):
    """Gated (SwiGLU) or plain two-matrix FFN, with whisper's biases
    (``b_up``, ``b_down``) where ``p`` has them. x: (B, S, D)."""
    if gated:
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        u = torch.einsum("bsd,df->bsf", x, p["w_up"])
        h = _act(g, act) * u
    else:
        u = torch.einsum("bsd,df->bsf", x, p["w_up"])
        if "b_up" in p:
            u = u + p["b_up"]
        h = _act(u, act)
    h = constrain(h, rules, "btf")
    out = torch.einsum("bsf,fd->bsd", h, p["w_down"])
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits, labels, *, real_vocab: int, rules=None):
    """Mean CE over tokens; padded vocab entries are masked out.

    logits: (B, S, Vp) in model dtype; computed in f32 via logsumexp.
    labels: (B, S) integer (−1 = ignore).
    """
    vp = logits.shape[-1]
    logits = logits.float()
    if real_vocab < vp:
        pad_mask = torch.arange(vp, device=logits.device) >= real_vocab
        logits = torch.where(pad_mask, NEG_INF, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - gold
    valid = (labels >= 0).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
