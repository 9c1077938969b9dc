// Batched weighted-interval-scheduling DP + backtrack, one block per window;
// and the single-window forward DP (K3) at the end of this file.
//
// Replaces the TPU kernel src/repro/kernels/wis_dp/kernel.py
// (wis_batch_pallas, body _batch_kernel) together with the score gather
// src/repro/kernels/wis_dp/ops.py::_fused_weights, which is folded into the
// load.
//
// Per window row of an end-sorted (W, L) layout:
//   w[j]    = weights[j], or (fused) mask[j] ? scores[c] * transform[c] : 0
//             with c = clip(idx[j], 0, M_pad - 1)
//   dp[0]   = 0;  dp[j+1] = w[j] + dp[pred[j]] if that is strictly > dp[j],
//             else dp[j]                                   (float32 adds)
//   backtrack: cursor j = L, at most L steps: if take[j-1], select lane j-1
//             and jump to pred[j-1], else step to j-1
//   out: sel (W, L) bytes in sorted-lane order, totals[row] = dp[L]
//
// Bound on an H100: neither bytes (~10 bytes a lane, ~1.3 MB at the round
// path's W = 64, L = 2048: well under a microsecond) nor operations (one add
// a lane) -- the DP is a chain of L dependent steps per window, so the
// kernel is latency-bound: about L shared-memory round trips per window,
// all windows in parallel on their own SMs.
//
// Design: the block's threads first stage the row cooperatively (coalesced
// loads of idx/mask/pred, the gather from the in-flight score vector, the
// transform multiply, and zeroing dp), then ONE thread runs the sequential
// DP and the backtrack from shared memory, exactly in the reference's
// order, so totals are bit-equal to the plain torch version.  The row's
// staging area (w, pred, dp, take: 13 L + 4 bytes) lives in dynamic shared
// memory -- above 48 KB after cudaFuncSetAttribute -- and, for an L whose
// row no longer fits the block's shared memory, in a global scratch buffer
// the wrapper allocates.  pred always comes from the host's float64 stable
// sort and is never recomputed here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t row_bytes(int L) {
    // w (4L) + pred (4L) + dp (4(L+1)) + take (L), rounded up to 16 bytes
    const size_t raw = 13 * static_cast<size_t>(L) + 4;
    return (raw + 15) & ~static_cast<size_t>(15);
}

__global__ void wis_batch_kernel(
    const float* __restrict__ weights,    // (W, L), or nullptr when fused
    const float* __restrict__ scores,     // (M_pad,) fused gather source
    const float* __restrict__ transform,  // (M_pad,) or nullptr
    const int32_t* __restrict__ idx,      // (W, L) fused
    const uint8_t* __restrict__ mask,     // (W, L) fused
    const int32_t* __restrict__ pred,     // (W, L)
    int L, int m_pad,
    uint8_t* __restrict__ sel,            // (W, L)
    float* __restrict__ totals,           // (W,)
    uint8_t* __restrict__ scratch) {      // nullptr: use shared memory
    extern __shared__ __align__(16) uint8_t smem[];
    const int row = blockIdx.x;
    uint8_t* base = scratch ? scratch + static_cast<size_t>(row) * row_bytes(L) : smem;
    float* w = reinterpret_cast<float*>(base);
    int32_t* pr = reinterpret_cast<int32_t*>(base + 4 * static_cast<size_t>(L));
    float* dp = reinterpret_cast<float*>(base + 8 * static_cast<size_t>(L));
    uint8_t* take = base + 12 * static_cast<size_t>(L) + 4;
    const size_t off = static_cast<size_t>(row) * L;

    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        float wj;
        if (weights != nullptr) {
            wj = weights[off + j];
        } else {
            const int c = min(max(idx[off + j], 0), m_pad - 1);
            float v = scores[c];
            if (transform != nullptr) v = __fmul_rn(v, transform[c]);
            wj = mask[off + j] ? v : 0.0f;
        }
        w[j] = wj;
        pr[j] = min(max(pred[off + j], 0), L);  // indexes dp[0..L]
        dp[j + 1] = 0.0f;  // a pred past j reads 0, as in the reference
        sel[off + j] = 0;
    }
    if (threadIdx.x == 0) dp[0] = 0.0f;
    __syncthreads();
    if (threadIdx.x != 0) return;

    float cur = 0.0f;  // dp[j]
    for (int j = 0; j < L; ++j) {
        const float with_j = __fadd_rn(w[j], dp[pr[j]]);
        const bool t = with_j > cur;
        cur = t ? with_j : cur;
        dp[j + 1] = cur;
        take[j] = t ? 1 : 0;
    }
    totals[row] = cur;

    int j = L;
    for (int step = 0; step < L && j > 0; ++step) {
        const int jm1 = j - 1;
        if (take[jm1]) {
            sel[off + jm1] = 1;
            j = pr[jm1];
        } else {
            j = jm1;
        }
    }
}

// ---------------------------------------------------------------------------
// Single-window forward DP (K3).
//
// Replaces the TPU kernel src/repro/kernels/wis_dp/kernel.py (wis_dp_pallas,
// body _dp_kernel): for M end-sorted lanes, dp[0] = 0 and
//   with_j = w[j] + dp[pred[j]];  take[j] = with_j > dp[j];
//   dp[j+1] = take[j] ? with_j : dp[j]
// out: dp[1..M] (M,) float32 and take (M,) int32.  The host sorts, computes
// pred and backtracks (kernels/wis_dp/ops.py::wis_clear).
//
// Bound on an H100: latency, like the batched form -- a chain of M dependent
// steps, each a shared-memory read of dp[pred[j]]; the bytes (~12 M) and the
// one add a lane are negligible.  Design: one block; its threads stage w,
// pred and a zeroed dp (12 M + 4 bytes) in shared memory, or, once that
// passes the block's opt-in limit, dp alone in a global scratch (w and pred
// are then read where they lie); then one thread runs the DP in the
// reference's order with rounded adds, so dp is bit-equal to the plain loop.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t dp_bytes(int M) {
    // w (4M) + pred (4M) + dp (4(M+1)), rounded up to 16 bytes
    const size_t raw = 12 * static_cast<size_t>(M) + 4;
    return (raw + 15) & ~static_cast<size_t>(15);
}

__global__ void wis_dp_kernel(const float* __restrict__ weights,  // (M,)
                              const int32_t* __restrict__ pred,   // (M,)
                              int M,
                              float* __restrict__ dp_out,         // (M,)
                              int32_t* __restrict__ take_out,     // (M,)
                              float* __restrict__ scratch) {      // (M+1,) or nullptr
    extern __shared__ __align__(16) uint8_t smem[];
    const float* w = weights;
    const int32_t* pr = pred;
    float* dp = scratch;
    if (scratch == nullptr) {
        float* ws = reinterpret_cast<float*>(smem);
        int32_t* ps = reinterpret_cast<int32_t*>(smem + 4 * static_cast<size_t>(M));
        dp = reinterpret_cast<float*>(smem + 8 * static_cast<size_t>(M));
        for (int j = threadIdx.x; j < M; j += blockDim.x) {
            ws[j] = weights[j];
            ps[j] = pred[j];
        }
        w = ws;
        pr = ps;
    }
    for (int j = threadIdx.x; j <= M; j += blockDim.x) dp[j] = 0.0f;  // a pred past j reads 0
    __syncthreads();
    if (threadIdx.x != 0) return;

    float cur = 0.0f;  // dp[j]
    for (int j = 0; j < M; ++j) {
        const int p = min(max(pr[j], 0), M);  // indexes dp[0..M]
        const float with_j = __fadd_rn(w[j], dp[p]);
        const bool t = with_j > cur;
        cur = t ? with_j : cur;
        dp[j + 1] = cur;
        dp_out[j] = cur;
        take_out[j] = t ? 1 : 0;
    }
}

}  // namespace

extern "C" {

// Bytes of shared memory the single-window DP stages for M lanes.
int wis_dp_smem_bytes(int M) { return static_cast<int>(dp_bytes(M)); }

// scratch == nullptr stages w, pred and dp in dynamic shared memory of
// wis_dp_smem_bytes(M); else scratch holds M + 1 floats for dp.  Launches on
// the caller's stream without synchronising and returns cudaGetLastError().
int wis_dp_launch(const float* weights, const int32_t* pred, int M,
                  float* dp_out, int32_t* take_out, float* scratch,
                  void* stream) {
    if (M <= 0) return 0;
    size_t smem = 0;
    if (scratch == nullptr) {
        smem = dp_bytes(M);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                wis_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
    }
    wis_dp_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        weights, pred, M, dp_out, take_out, scratch);
    return static_cast<int>(cudaGetLastError());
}


// Bytes of staging one window row needs (shared memory or global scratch).
int wis_batch_row_bytes(int L) { return static_cast<int>(row_bytes(L)); }

// The most dynamic shared memory a block of this kernel may request.
int wis_batch_smem_limit(int device, int* out) {
    return static_cast<int>(cudaDeviceGetAttribute(
        out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// Launches on the caller's stream without synchronising and returns
// cudaGetLastError().  scratch == nullptr stages rows in dynamic shared
// memory of row_bytes(L); else scratch holds W * row_bytes(L) bytes.
int wis_batch_launch(const float* weights, const float* scores,
                     const float* transform, const int32_t* idx,
                     const uint8_t* mask, const int32_t* pred,
                     int n_rows, int L, int m_pad,
                     uint8_t* sel, float* totals, uint8_t* scratch,
                     void* stream) {
    if (n_rows <= 0 || L <= 0) return 0;
    size_t smem = 0;
    if (scratch == nullptr) {
        smem = row_bytes(L);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                wis_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
    }
    wis_batch_kernel<<<n_rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        weights, scores, transform, idx, mask, pred, L, m_pad, sel, totals,
        scratch);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
