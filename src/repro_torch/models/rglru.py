"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port's counterpart of ``repro/models/rglru.py``:

    r_t = σ(blockdiag(W_r) x_t + b_r)          recurrence gate
    i_t = σ(blockdiag(W_i) x_t + b_i)          input gate
    a_t = a^(c·r_t),  a = σ(Λ),  c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The sequence path runs ``kernels/linear_scan`` (K5 on the card); decode is
the O(1) update.  The full temporal-mixing block is: in_x branch →
conv1d(K) → RG-LRU, gated by gelu(in_gate branch), then out-projected.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.linear_scan.ops import linear_scan
from .layers import constrain, gelu
from .ssm import causal_conv1d, conv_step

__all__ = ["rglru_seq", "rglru_decode_step"]

_C = 8.0


def _gates(x, p):
    """Block-diagonal gate projections. x (..., Dr) → r, i (..., Dr)."""
    nb, bs, _ = p["gate_r"].shape
    xb = x.reshape(x.shape[:-1] + (nb, bs)).float()
    r = torch.einsum("...nb,nbc->...nc", xb, p["gate_r"].float())
    i = torch.einsum("...nb,nbc->...nc", xb, p["gate_i"].float())
    r = r.reshape(x.shape) + p["gate_r_b"]
    i = i.reshape(x.shape) + p["gate_i_b"]
    return torch.sigmoid(r), torch.sigmoid(i)


def _log_a(p):
    # log a = log σ(Λ) = -softplus(-Λ)
    return -F.softplus(-p["lam"].float())


def _gated_input(log_a_t, i, xc):
    return torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a_t), min=1e-12)) \
        * i * xc.float()


def rglru_seq(x: torch.Tensor, p: Dict, cfg, *, rules=None,
              scan_impl: Optional[str] = None, return_cache: bool = False):
    """x (B,S,D) → (B,S,D): conv + RG-LRU branch × gelu gate branch."""
    B = x.shape[0]
    K = cfg.ssm_conv
    xr_raw = torch.einsum("bsd,dm->bsm", x, p["in_x"])  # (B,S,Dr)
    xg = torch.einsum("bsd,dm->bsm", x, p["in_gate"])
    xr_raw = constrain(xr_raw, rules, "btm")
    xr = causal_conv1d(xr_raw, p["conv_w"], p["conv_b"])

    r, i = _gates(xr, p)
    log_a_t = _C * r * _log_a(p)  # (B,S,Dr), ≤ 0
    a_t = torch.exp(log_a_t)
    h, hT = linear_scan(a_t, _gated_input(log_a_t, i, xr), impl=scan_impl)
    y = (h * gelu(xg.float())).to(x.dtype)
    y = constrain(y, rules, "btm")
    out = torch.einsum("bsm,md->bsd", y, p["out_proj"])
    if not return_cache:
        return out
    pad = xr_raw.new_zeros((B, K - 1, xr_raw.shape[-1]))
    conv_tail = torch.cat([pad, xr_raw], dim=1)[:, -(K - 1):]
    return out, {"conv": conv_tail, "h": hT.float()}


def rglru_decode_step(
    x_t: torch.Tensor,  # (B, D)
    p: Dict,
    cfg,
    cache: Dict,  # {"conv": (B,K-1,Dr), "h": (B,Dr) f32}
    rules=None,
) -> Tuple[torch.Tensor, Dict]:
    xr = torch.einsum("bd,dm->bm", x_t, p["in_x"])
    xg = torch.einsum("bd,dm->bm", x_t, p["in_gate"])
    xc, new_conv = conv_step(xr, p["conv_w"], p["conv_b"], cache["conv"])

    r, i = _gates(xc, p)
    log_a_t = _C * r * _log_a(p)
    a_t = torch.exp(log_a_t)
    h = a_t * cache["h"] + _gated_input(log_a_t, i, xc)
    y = (h * gelu(xg.float())).to(x_t.dtype)
    out = torch.einsum("bm,md->bd", y, p["out_proj"])
    return out, {"conv": new_conv, "h": h}
