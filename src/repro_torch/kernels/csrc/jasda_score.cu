// Batched Eq. 4 variant scoring + FMP safety recheck, a block per 128 bid rows.
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
// Design: the TPU kernel reduces a (BM, T) tile in one vector sum.  Here a
// block of 512 threads owns kRows = 128 rows and works in two steps inside
// one launch:
//  1. the log Phi terms: threads index (row, k) contiguously over the
//     block's rows, so each warp's mu and sigma loads are coalesced; each
//     thread issues the loads of its 8 terms before it evaluates them, and
//     writes the terms into a shared-memory table of 128 x (kChunk + 1)
//     floats (the odd row stride keeps step 2's reads free of bank
//     conflicts).  T past kChunk = 32 runs in passes of 32 grid points;
//  2. after __syncthreads(), one thread per row sums its terms from shared
//     memory left to right, in the plain version's order (across passes
//     too), and applies the safety check to the score it computed from
//     the Fj/Fs dots during step 1 (their loads overlap step 1's).
// Built with -fmad=false and written with __fmul_rn / __fadd_rn so no
// multiply-add is contracted: scores are bit-equal to the plain version in
// jasda_score/ref.py.  The three log_ndtr branches and their branch points
// are the reference's.  At M = 32768 the grid is 256 blocks of 16 warps,
// all resident on 132 SMs at once (2 blocks an SM at 61 registers).  What
// bounds it once the loads are coalesced is instruction issue in step 1:
// the division and the erfc and log1p / log of each term, with each warp
// running every log_ndtr branch any of its lanes takes (sigma = 0 lanes
// idle through them), well above the bytes' 2.9 us.
// T, Fj and Fs stay runtime arguments: no rebuild per shape.

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

// log Phi_t of one grid point, or its sigma = 0 limit
__device__ __forceinline__ float log_phi_term(float m_k, float s_k, float c) {
    if (s_k <= 0.0f) return (m_k <= c) ? 0.0f : -CUDART_INF_F;
    return log_ndtr_f(__fdiv_rn(__fsub_rn(c, m_k), fmaxf(s_k, 1e-30f)));
}

// Eq. 4 of row r: lam h + (1 - lam) f from the Fj and Fs dots
__device__ __forceinline__ float row_score(
    const float* __restrict__ fj, const float* __restrict__ fs,
    const float* __restrict__ alphas, const float* __restrict__ betas,
    const float* __restrict__ lam, int r, int n_fj, int n_fs) {
    const float* fj_r = fj + (size_t)r * n_fj;
    float h = __fmul_rn(fj_r[0], alphas[0]);
#pragma unroll 4
    for (int i = 1; i < n_fj; ++i) h = __fadd_rn(h, __fmul_rn(fj_r[i], alphas[i]));
    const float* fs_r = fs + (size_t)r * n_fs;
    float f = __fmul_rn(fs_r[0], betas[0]);
#pragma unroll 4
    for (int i = 1; i < n_fs; ++i) f = __fadd_rn(f, __fmul_rn(fs_r[i], betas[i]));
    const float l = lam[r];
    return __fadd_rn(__fmul_rn(l, clip01(h)), __fmul_rn(__fsub_rn(1.0f, l), clip01(f)));
}

constexpr int kThreads = 512;
constexpr int kRows = 128;   // rows a block
constexpr int kChunk = 32;   // grid points staged a pass
constexpr int kPerThread = kRows * kChunk / kThreads;  // terms a thread a pass

__global__ void __launch_bounds__(kThreads) score_kernel(
    const float* __restrict__ fj, const float* __restrict__ fs,
    const float* __restrict__ alphas, const float* __restrict__ betas,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ lam, const float* __restrict__ cap,
    const float* __restrict__ theta,
    int m, int n_fj, int n_fs, int t,
    float* __restrict__ score_out, uint8_t* __restrict__ elig_out) {
    __shared__ float terms[kRows * (kChunk + 1)];
    const int r0 = blockIdx.x * kRows;
    const int rows = min(kRows, m - r0);
    const bool owner = threadIdx.x < rows;  // runs step 2 for row r
    const int r = r0 + threadIdx.x;

    float score = 0.0f;
    float th = 0.0f;
    float log_surv = 0.0f;
    for (int k0 = 0; k0 < t; k0 += kChunk) {
        const int tc = min(kChunk, t - k0);
        // 1. the terms of (row, k) = divmod(threadIdx.x + n kThreads, tc):
        //    every load of the pass first, then the evaluations
        const int n_terms = rows * tc;
        const int step_r = kThreads / tc;
        const int step_k = kThreads - step_r * tc;
        int lr = threadIdx.x / tc;
        int lk = threadIdx.x - lr * tc;
        float mv[kPerThread], sv[kPerThread], cv[kPerThread];
        int slot[kPerThread];
#pragma unroll
        for (int n = 0; n < kPerThread; ++n) {
            slot[n] = -1;
            if (threadIdx.x + n * kThreads < n_terms) {
                const size_t g = static_cast<size_t>(r0 + lr) * t + k0 + lk;
                mv[n] = mu[g];
                sv[n] = sigma[g];
                cv[n] = cap[r0 + lr];
                slot[n] = lr * (kChunk + 1) + lk;
            }
            lk += step_k;
            lr += step_r;
            if (lk >= tc) {
                lk -= tc;
                ++lr;
            }
        }
        if (k0 == 0 && owner) {  // the row's score, its loads beside those above
            score = row_score(fj, fs, alphas, betas, lam, r, n_fj, n_fs);
            th = theta[r];
        }
#pragma unroll
        for (int n = 0; n < kPerThread; ++n) {
            if (slot[n] >= 0) terms[slot[n]] = log_phi_term(mv[n], sv[n], cv[n]);
        }
        __syncthreads();
        // 2a. this pass's terms into the row's sum, left to right
        if (owner) {
            const float* row_terms = terms + threadIdx.x * (kChunk + 1);
#pragma unroll 8
            for (int k = 0; k < tc; ++k) {
                log_surv = (k0 + k == 0) ? row_terms[k] : __fadd_rn(log_surv, row_terms[k]);
            }
        }
        __syncthreads();
    }
    if (!owner) return;

    // 2b. the safety check of row r
    const bool elig = -expm1f(log_surv) <= th;
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
    const int blocks = (m + kRows - 1) / kRows;
    score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        fj, fs, alphas, betas, mu, sigma, lam, cap, theta, m, n_fj, n_fs, t,
        score_out, elig_out);
    return static_cast<int>(cudaGetLastError());
}
