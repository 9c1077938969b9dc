// Batched Eq. 4 variant scoring + FMP safety recheck, one thread per bid row.
//
// Replaces the TPU kernel src/repro/kernels/jasda_score/kernel.py
// (score_variants_pallas, body _score_kernel).
//
// What it computes for M rows (all float32):
//   h     = clip(sum_i fj[r,i] * alpha[i], 0, 1)          (left to right)
//   f     = clip(sum_i fs[r,i] * beta[i], 0, 1)
//   score = lam[r] * h + (1 - lam[r]) * f
//   logphi_t = 0 if sigma_t <= 0 and mu_t <= cap[r]; -inf if sigma_t <= 0
//              and mu_t > cap[r]; else log_ndtr((cap[r] - mu_t) / sigma_t)
//   log_surv = sum_t logphi_t                              (left to right)
//   elig  = -expm1(log_surv) <= theta[r];  score = elig ? score : 0
//
// Bound on an H100: bytes.  Each row reads (Fj + Fs + 2T + 3) floats and
// writes 5 bytes; at the round path's M = 32768, T = 32 that is about
// 9.6 MB, ~2.9 us at 3.35 TB/s.  The operations (~T transcendental
// evaluations per row) are far below the f32 peak.
//
// Design: the TPU kernel reduces a (BM, T) tile in one vector sum; here each
// thread owns one row and sums its T grid points sequentially in registers,
// so the arithmetic order is fixed and equals the plain torch version in
// jasda_score/ref.py.  Built with -fmad=false and written with __fmul_rn /
// __fadd_rn so no multiply-add is contracted: scores are bit-equal to the
// plain version on the card.  The three log_ndtr branches and their branch
// points are the reference's.  A row's mu/sigma loads are strided by T
// across a warp (uncoalesced per instruction, reused through L1): simple
// and right first; a warp-per-row or shared-memory transpose is the
// obvious next step.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float clip01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
}

// log Phi(z): the three branches of repro/kernels/common.py::log_ndtr.
__device__ __forceinline__ float log_ndtr_f(float z) {
    const float x = __fmul_rn(z, 0.7071067811865476f);
    if (z >= -1.0f) {
        return log1pf(__fmul_rn(-0.5f, erfcf(x)));
    }
    if (z >= -10.0f) {
        // the reference clips at 1e-300, which is 0 in float32
        return logf(fmaxf(__fmul_rn(0.5f, erfcf(-x)), 0.0f));
    }
    const float quad = __fmul_rn(__fmul_rn(-0.5f, z), z);
    return __fsub_rn(quad, logf(__fadd_rn(__fmul_rn(-z, 2.5066282746310002f), 1e-30f)));
}

__global__ void score_kernel(
    const float* __restrict__ fj, const float* __restrict__ fs,
    const float* __restrict__ alphas, const float* __restrict__ betas,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ lam, const float* __restrict__ cap,
    const float* __restrict__ theta,
    int m, int n_fj, int n_fs, int t,
    float* __restrict__ score_out, uint8_t* __restrict__ elig_out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= m) return;

    const float* fj_r = fj + (size_t)r * n_fj;
    float h = __fmul_rn(fj_r[0], alphas[0]);
#pragma unroll 4
    for (int i = 1; i < n_fj; ++i) h = __fadd_rn(h, __fmul_rn(fj_r[i], alphas[i]));
    const float* fs_r = fs + (size_t)r * n_fs;
    float f = __fmul_rn(fs_r[0], betas[0]);
#pragma unroll 4
    for (int i = 1; i < n_fs; ++i) f = __fadd_rn(f, __fmul_rn(fs_r[i], betas[i]));
    const float l = lam[r];
    const float score = __fadd_rn(__fmul_rn(l, clip01(h)),
                                  __fmul_rn(__fsub_rn(1.0f, l), clip01(f)));

    const float c = cap[r];
    const float* mu_r = mu + (size_t)r * t;
    const float* sg_r = sigma + (size_t)r * t;
    float log_surv = 0.0f;
    for (int k = 0; k < t; ++k) {
        const float m_k = mu_r[k];
        const float s_k = sg_r[k];
        float lp;
        if (s_k <= 0.0f) {
            lp = (m_k <= c) ? 0.0f : -CUDART_INF_F;
        } else {
            lp = log_ndtr_f(__fdiv_rn(__fsub_rn(c, m_k), fmaxf(s_k, 1e-30f)));
        }
        log_surv = (k == 0) ? lp : __fadd_rn(log_surv, lp);
    }
    const bool elig = -expm1f(log_surv) <= theta[r];
    score_out[r] = elig ? score : 0.0f;
    elig_out[r] = elig ? 1 : 0;
}

}  // namespace

// C interface (bound with ctypes by jasda_score/kernel.py).  Launches on
// the caller's stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported.
extern "C" int jasda_score_launch(
    const float* fj, const float* fs, const float* alphas, const float* betas,
    const float* mu, const float* sigma, const float* lam, const float* cap,
    const float* theta, int m, int n_fj, int n_fs, int t,
    float* score_out, uint8_t* elig_out, void* stream) {
    if (m <= 0) return 0;
    const int threads = 256;
    const int blocks = (m + threads - 1) / threads;
    score_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        fj, fs, alphas, betas, mu, sigma, lam, cap, theta, m, n_fj, n_fs, t,
        score_out, elig_out);
    return static_cast<int>(cudaGetLastError());
}
