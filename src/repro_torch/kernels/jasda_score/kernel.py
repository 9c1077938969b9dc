"""Batched variant scoring + safety as a hand-written CUDA kernel (K1).

Replaces ``repro/kernels/jasda_score/kernel.py::score_variants_pallas``
(body ``_score_kernel``).  Source: ``kernels/csrc/jasda_score.cu`` (its
header says what bounds it on an H100 and what the design does about it):
a block of 512 threads per 128 bid rows computes the rows' log Φ terms
with coalesced loads into shared memory, then one thread per row sums its
T terms left to right and applies the safety check to its Eq. 4 score;
the reference's three ``log_ndtr`` branches, compiled without FMA
contraction.

λ, capacity and θ are per-row runtime columns, so one build serves every
policy, capacity mix and safety bound; the kernel is not specialised per
shape, so drifting pool sizes never rebuild it (``common.build_counts``).

``score_variants_cuda`` launches on ``torch.cuda.current_stream()`` and
returns without synchronising.  For tensors that lie on the CPU it runs the
plain torch version (ref.py) instead; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..common import check_launch, check_tensor, load_kernel_library
from .ref import score_variants_reference

__all__ = ["score_variants_cuda", "LAUNCHES", "SHAPES"]

#: kernel launches (the wrapper adds one where it launches, nowhere else)
LAUNCHES = {"jasda_score": 0}
#: (M, Fj, Fs, T) -> launches at that shape
SHAPES: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "jasda_score_launch": [_P] * 9 + [_I] * 4 + [_P, _P, _P],
}


def _lib() -> ctypes.CDLL:
    return load_kernel_library("jasda_score", _SIGNATURES)


def score_variants_cuda(
    feat_job: torch.Tensor,  # (M, Fj) f32
    feat_sys: torch.Tensor,  # (M, Fs) f32
    alphas: torch.Tensor,  # (Fj,) f32
    betas: torch.Tensor,  # (Fs,) f32
    mu: torch.Tensor,  # (M, T) f32
    sigma: torch.Tensor,  # (M, T) f32
    lam: torch.Tensor,  # (M,) f32
    capacity: torch.Tensor,  # (M,) f32
    theta: torch.Tensor,  # (M,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score (M,) f32, eligible (M,) bool); no p_exceed, like the TPU kernel."""
    device = feat_job.device
    if device.type == "cpu":
        score, elig, _ = score_variants_reference(
            feat_job, feat_sys, alphas, betas, mu, sigma,
            lam=lam, capacity=capacity, theta=theta)
        return score, elig

    m, n_fj = feat_job.shape
    n_fs = feat_sys.shape[1]
    t = mu.shape[1]
    if n_fj < 1 or n_fs < 1 or t < 1:
        raise ValueError(f"need Fj, Fs, T >= 1, got {(n_fj, n_fs, t)}")
    f32 = torch.float32
    check_tensor(feat_job, "feat_job", f32, (m, n_fj), device)
    check_tensor(feat_sys, "feat_sys", f32, (m, n_fs), device)
    check_tensor(alphas, "alphas", f32, (n_fj,), device)
    check_tensor(betas, "betas", f32, (n_fs,), device)
    check_tensor(mu, "mu", f32, (m, t), device)
    check_tensor(sigma, "sigma", f32, (m, t), device)
    for name, col in (("lam", lam), ("capacity", capacity), ("theta", theta)):
        check_tensor(col, name, f32, (m,), device)

    score = torch.empty((m,), dtype=f32, device=device)
    elig = torch.empty((m,), dtype=torch.bool, device=device)
    err = _lib().jasda_score_launch(
        feat_job.data_ptr(), feat_sys.data_ptr(), alphas.data_ptr(),
        betas.data_ptr(), mu.data_ptr(), sigma.data_ptr(), lam.data_ptr(),
        capacity.data_ptr(), theta.data_ptr(), m, n_fj, n_fs, t,
        score.data_ptr(), elig.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check_launch(err, "jasda_score")
    LAUNCHES["jasda_score"] += 1
    key = (m, n_fj, n_fs, t)
    SHAPES[key] = SHAPES.get(key, 0) + 1
    return score, elig
