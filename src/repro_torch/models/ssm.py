"""Mamba-1 selective SSM block (falcon-mamba architecture).

The port's counterpart of ``repro/models/ssm.py``.  The sequence path
(prefill) runs the diagonal recurrence over the flattened (Dm·N) state
channels through ``kernels/linear_scan`` -- the CUDA kernel K5 on the card
-- and the decode path is the O(1) single-token state update.

Causal depthwise conv1d (K taps) is expressed as K shifted adds, exactly
matching the decode-side ring buffer.

``cfg.mamba_norms`` (jamba) normalises dt, B and C by RMS after ``x_proj``
(learned ``1 + scale``, as the model's other norms).  A pass longer than
``CHUNK`` tokens that records no gradient runs in chunks of ``CHUNK``, the
conv tail and the scan state carried from one to the next (the scan
through K5's ``h0``), so that the float32 (B, S, Dm, N) tensors of the scan
are a chunk long: 4.3 GB each at jamba's 8,192-token prompts whole.  A
pass that records a gradient runs whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.linear_scan.ops import linear_scan
from .layers import constrain, rms_norm

__all__ = ["mamba_seq", "mamba_decode_step", "causal_conv1d", "conv_step",
           "CHUNK"]

#: longest stretch of a prompt the mixer runs at once without a gradient
CHUNK = 2048


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,C), w (K,C), b (C); prefix (B,K-1,C) carries decode state."""
    k = w.shape[0]
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prefix, x], dim=1)  # (B, S+K-1, C)
    out = torch.zeros_like(x)
    s = x.shape[1]
    for i in range(k):
        out = out + w[i] * xp[:, i:i + s]
    return out + b


def conv_step(x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              prefix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv. x_t (B,C); prefix (B,K-1,C) → (y, new_prefix)."""
    window = torch.cat([prefix, x_t[:, None, :]], dim=1)  # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


def _ssm_inputs(x_conv, p, cfg):
    """Shared Δ/B/C computation. x_conv (B,S,Dm) post-conv post-silu."""
    R, N = cfg.dt_rank_actual, cfg.ssm_state
    proj = torch.einsum("bsd,dr->bsr", x_conv, p["x_proj"])  # (B,S,R+2N)
    dt_r, b_ssm, c_ssm = torch.split(proj, [R, N, N], dim=-1)
    if cfg.mamba_norms:
        dt_r = rms_norm(dt_r, p["dt_norm"], cfg.norm_eps)
        b_ssm = rms_norm(b_ssm, p["b_norm"], cfg.norm_eps)
        c_ssm = rms_norm(c_ssm, p["c_norm"], cfg.norm_eps)
    dt = torch.einsum("bsr,rd->bsd", dt_r, p["dt_proj"]) + p["dt_bias"]
    dt = F.softplus(dt.float())  # (B,S,Dm)
    a = -torch.exp(p["a_log"].float())  # (Dm,N)
    return dt, a, b_ssm.float(), c_ssm.float()


def mamba_seq(x: torch.Tensor, p: Dict, cfg, *, rules=None,
              scan_impl: Optional[str] = None, return_cache: bool = False):
    """Full-sequence mamba mixer. x (B,S,D) → (B,S,D) [, decode cache]."""
    S, chunk = x.shape[1], CHUNK
    if S <= chunk or (torch.is_grad_enabled() and x.requires_grad):
        return _mamba_piece(x, p, cfg, None, rules, scan_impl, return_cache)
    outs, state = [], None
    for i in range(0, S, chunk):
        out, state = _mamba_piece(x[:, i:i + chunk], p, cfg, state, rules,
                                  scan_impl, True)
        outs.append(out)
    out = torch.cat(outs, dim=1)
    return (out, state) if return_cache else out


def _mamba_piece(x, p, cfg, state, rules, scan_impl, return_cache):
    """The mixer over ``x`` (B,S,D) from ``state`` (a decode cache; None:
    the sequence's start) → out [, the cache after ``x``]."""
    B, S, _ = x.shape
    Dm, N = cfg.d_inner, cfg.ssm_state
    K = cfg.ssm_conv
    xz = torch.einsum("bsd,dcm->bscm", x, p["in_proj"])  # (B,S,2,Dm)
    x1_raw, z = xz[:, :, 0], xz[:, :, 1]
    x1_raw = constrain(x1_raw, rules, "btm")
    prefix = None if state is None else state["conv"]
    x1 = F.silu(causal_conv1d(x1_raw, p["conv_w"], p["conv_b"], prefix))

    dt, a, b_ssm, c_ssm = _ssm_inputs(x1, p, cfg)
    # discretize: ā = exp(dt·A) (B,S,Dm,N); b̄x = dt·x ⊗ B
    da = torch.exp(dt[..., None] * a)  # (B,S,Dm,N)
    dbx = (dt * x1.float())[..., None] * b_ssm[:, :, None, :]
    h0 = None if state is None else state["ssm"].reshape(B, Dm * N)
    h, hT = linear_scan(da.reshape(B, S, Dm * N), dbx.reshape(B, S, Dm * N),
                        h0, impl=scan_impl)
    h = h.reshape(B, S, Dm, N)
    y = torch.einsum("bsdn,bsn->bsd", h, c_ssm) + p["d_skip"] * x1.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    y = constrain(y, rules, "btm")
    out = torch.einsum("bsm,md->bsd", y, p["out_proj"])
    if not return_cache:
        return out
    if prefix is None:
        prefix = x1_raw.new_zeros((B, K - 1, Dm))
    conv_tail = torch.cat([prefix, x1_raw], dim=1)[:, -(K - 1):]
    return out, {"conv": conv_tail, "ssm": hT.reshape(B, Dm, N).float()}


def mamba_decode_step(
    x_t: torch.Tensor,  # (B, D) single token
    p: Dict,
    cfg,
    cache: Dict,  # {"conv": (B,K-1,Dm), "ssm": (B,Dm,N) f32}
    rules=None,
) -> Tuple[torch.Tensor, Dict]:
    xz = torch.einsum("bd,dcm->bcm", x_t, p["in_proj"])
    x1, z = xz[:, 0], xz[:, 1]  # (B, Dm)
    xc, new_conv = conv_step(x1, p["conv_w"], p["conv_b"], cache["conv"])
    xc = F.silu(xc)

    dt, a, b_ssm, c_ssm = _ssm_inputs(xc[:, None, :], p, cfg)
    dt, b_ssm, c_ssm = dt[:, 0], b_ssm[:, 0], c_ssm[:, 0]
    da = torch.exp(dt[..., None] * a)  # (B,Dm,N)
    dbx = (dt * xc.float())[..., None] * b_ssm[:, None, :]
    h = da * cache["ssm"] + dbx  # (B,Dm,N)
    y = torch.einsum("bdn,bn->bd", h, c_ssm) + p["d_skip"] * xc.float()
    y = (y * F.silu(z.float())).to(x_t.dtype)
    out = torch.einsum("bm,md->bd", y, p["out_proj"])
    return out, {"conv": new_conv, "ssm": h}
