"""Plain torch version of flash attention (GQA + causal + sliding window).

Counterpart of ``repro/kernels/flash_attention/ref.py::mha_reference``, with
its semantics: kv heads repeated for GQA, float32 logits times ``scale``,
masked logits set to the finite ``NEG_INF = -1e30`` (not ``-inf``), a
max-subtracted softmax, and the probabilities cast to v's dtype before the
PV product.  The CUDA kernels (csrc/flash_attention.cu) compute the same
function with an online softmax in float32.

``mha_tiled_reference`` is a model of the tensor-core kernel's arithmetic
(its blocks of rows, key tiles and rounding), for the tests and for holding
the kernel to on the card; nothing on the serving path calls it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["mha_reference", "mha_tiled_reference", "NEG_INF"]

NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding-window size (None = full)
    scale: Optional[float] = None,
    q_offset: int = 0,  # absolute position of q[0]
) -> torch.Tensor:
    """Materialised-softmax attention, (B, Hq, Sq, D) in v's dtype."""
    sq, d = q.shape[2], q.shape[3]
    hq, hkv, sk = q.shape[1], k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} and {hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)

    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, NEG_INF)

    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def mha_tiled_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_rows: int = 128,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Attention as the tensor-core kernel computes it, (B, Hq, Sq, D).

    The rows of each (batch, kv head) are ordered (position, head in group)
    and cut into blocks of ``block_rows``.  A block walks keys in tiles of
    ``block_k`` (by default the kernel's: 128 keys at D = 128, else 64) over
    its range [k_lo, k_hi) (keys past Sk read as zeros): scores in float32
    in log2 units (scale * log2 e folded in), masked keys at ``NEG_INF``, a
    running max, l summed from the float32 p, and p rounded to bfloat16 for
    the PV product.  All blocks step through their tiles together; a block
    past its last tile masks every key, which leaves its m, l and O exactly
    as they are.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} and {hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if block_k is None:
        block_k = 128 if d == 128 else 64
    dev = q.device
    n_rows = group * sq
    n_blk = -(-n_rows // block_rows)
    rows = n_blk * block_rows

    qr = q.float().reshape(b, hkv, group, sq, d).transpose(2, 3).reshape(
        b * hkv, n_rows, d)
    qr = torch.nn.functional.pad(qr, (0, 0, 0, rows - n_rows)).reshape(
        b * hkv, n_blk, block_rows, d)
    row = torch.arange(rows, device=dev).reshape(n_blk, block_rows)
    qp = row.clamp(max=n_rows - 1) // group + q_offset  # padded rows: never kept
    first = qp[:, 0]
    last = qp.max(dim=1).values
    k_lo = (first - window + 1).clamp(min=0) if window is not None else torch.zeros_like(first)
    k_hi = (last + 1).clamp(max=sk) if causal else torch.full_like(last, sk)
    lo = torch.maximum(k_lo[:, None], qp - window + 1) if window is not None else k_lo[:, None]
    hi = torch.minimum(k_hi[:, None], qp + 1) if causal else k_hi[:, None]
    n_tiles = ((k_hi - k_lo + block_k - 1) // block_k).clamp(min=0)

    kf = k.float().reshape(b * hkv, sk, d)
    vf = v.float().reshape(b * hkv, sk, d)
    c = scale * math.log2(math.e)
    m = torch.full((b * hkv, n_blk, block_rows), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qr)
    cols = torch.arange(block_k, device=dev)
    for j in range(int(n_tiles.max().item()) if n_blk else 0):
        keys = k_lo[:, None] + j * block_k + cols  # (n_blk, block_k)
        inside = (keys < sk)[None, :, :, None]
        idx = keys.clamp(max=sk - 1)
        kt = torch.where(inside, kf[:, idx], 0.0)
        vt = torch.where(inside, vf[:, idx], 0.0)
        s = torch.einsum("xnrd,xnkd->xnrk", qr, kt) * c
        seen = ((keys[:, None, :] >= lo[:, :, None]) & (keys[:, None, :] < hi[:, :, None])
                & (j < n_tiles)[:, None, None])
        s = torch.where(seen, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "xnrk,xnkd->xnrd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]
    o = o.reshape(b, hkv, rows, d)[:, :, :n_rows].reshape(b, hkv, sq, group, d)
    return o.transpose(2, 3).reshape(b, hq, sq, d).to(q.dtype)
