"""Plain torch version of flash attention (GQA + causal + sliding window).

Counterpart of ``repro/kernels/flash_attention/ref.py::mha_reference``, with
its semantics: kv heads repeated for GQA, float32 logits times ``scale``,
masked logits set to the finite ``NEG_INF = -1e30`` (not ``-inf``), a
max-subtracted softmax, and the probabilities cast to v's dtype before the
PV product.  The CUDA kernel (csrc/flash_attention.cu) computes the same
function with an online softmax in float32.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mha_reference", "NEG_INF"]

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
