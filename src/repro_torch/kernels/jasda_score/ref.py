"""Plain torch version of batched variant scoring + safety (paper §4.1–§4.2).

Counterpart of ``repro/kernels/jasda_score/ref.py``.  Given M variants
with job-side features X_j (M, Fj), system-side features X_s (M, Fs), and
per-variant FMP grids (mu, sigma) over T points:

    h̃        = clip(X_j · α, 0, 1)
    f̃_sys    = clip(X_s · β, 0, 1)
    score     = λ·h̃ + (1−λ)·f̃_sys                      (Eq. 4)
    log_surv  = Σ_t log Φ((c_i − μ_t)/σ_t)               (grid safety)
    p_exceed  = −expm1(log_surv)
    eligible  = p_exceed ≤ θ_i                            (condition (a))

A grid point with σ = 0 contributes 0 when μ ≤ c and −inf otherwise.
Scores of ineligible variants are zeroed.

Every step is an explicit float32 elementwise op in the CUDA kernel's
order (csrc/jasda_score.cu): the dots run left to right (never ``@``) and
the T-sum is a left-to-right loop, so on the card the kernel's scores are
bit-equal to this version.
"""
from __future__ import annotations

import torch

from ..common import log_ndtr

__all__ = ["score_variants_reference", "per_variant"]


def per_variant(x, m: int, device) -> torch.Tensor:
    """Normalize a scalar / (M,) / (M,1) runtime parameter to (M,) f32."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.ndim == 0:
        return x.expand(m).contiguous()
    return x.reshape(m)


def _dot(feat: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    acc = feat[:, 0] * weights[0]
    for i in range(1, feat.shape[1]):
        acc = acc + feat[:, i] * weights[i]
    return acc


def score_variants_reference(
    feat_job: torch.Tensor,  # (M, Fj)
    feat_sys: torch.Tensor,  # (M, Fs)
    alphas: torch.Tensor,  # (Fj,)
    betas: torch.Tensor,  # (Fs,)
    mu: torch.Tensor,  # (M, T)
    sigma: torch.Tensor,  # (M, T)
    *,
    lam,  # scalar or per-variant (M,)
    capacity,  # scalar or per-variant (M,)
    theta,  # scalar or per-variant (M,)
):
    """Returns ``(score (M,) f32, eligible (M,) bool, p_exceed (M,) f32)``."""
    m = feat_job.shape[0]
    dev = feat_job.device
    lam_v = per_variant(lam, m, dev)
    cap_v = per_variant(capacity, m, dev)
    th_v = per_variant(theta, m, dev)

    h = torch.clamp(_dot(feat_job, alphas), 0.0, 1.0)
    f = torch.clamp(_dot(feat_sys, betas), 0.0, 1.0)
    score = lam_v * h + (1.0 - lam_v) * f

    cap_c = cap_v[:, None]
    z = (cap_c - mu) / torch.clamp(sigma, min=1e-30)
    deterministic = torch.where(mu <= cap_c, 0.0, float("-inf"))
    logphi = torch.where(sigma <= 0.0, deterministic, log_ndtr(z))
    log_surv = logphi[:, 0]
    for t in range(1, logphi.shape[1]):
        log_surv = log_surv + logphi[:, t]
    p_exceed = -torch.expm1(log_surv)
    eligible = p_exceed <= th_v
    return torch.where(eligible, score, 0.0), eligible, p_exceed
