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
//   out: sel (W, L) bytes in sorted-lane order, totals[row] = dp[L], and
//        (wis_batch_launch_paths) paths[row]: 1 where the row took the
//        bounded walk of step 4 below, 0 where it took pointer doubling
//
// Bound on an H100: neither bytes (~10 bytes a lane, ~1.3 MB at the round
// path's W = 64, L = 2048: well under a microsecond) nor operations (one add
// a lane).  The DP is a chain of L dependent float32 adds per window, and
// the adds must happen in the plain version's order for bit-equal totals,
// so the kernel is bound by that chain: one thread's cycles a lane, all
// windows in parallel on their own SMs.
//
// Design, per block (one window row):
//  1. Staging.  All threads load the row coalesced (idx/mask/pred, the
//     gather from the in-flight score vector, the transform multiply), 4
//     lanes a thread in flight, and write one 8-byte lane {w[j], off[j] =
//     4 (pred[j] - j)} and a zeroed dp to the staging area.  A lane with
//     pred[j] = j carries w+ = fmaxf(w[j], 0) in place of w[j].
//  2. Forward DP, one thread, software-pipelined (wis_forward).  At step j,
//     right after it stores dp[j+1], the thread issues the load of
//     dp[pred] for step j + D and the lane of step j + 2D.  That dp value
//     is right for pred <= j + 1, i.e. d = step - pred >= D - 1; a pred
//     past the step reads the still-zero entry, the reference's 0.  d in
//     [1, D - 2] is picked from the last D - 2 dp values in registers, and
//     b = w + dp[pred] formed, one step ahead, off the chain.  The
//     loop-carried path is then ONE add or ONE max: dp[j+1] = dp[j] + w+
//     when pred = j, else fmaxf(b, dp[j]).  Both give the bits of "with >
//     dp[j] ? with : dp[j]" with with = w + dp[pred]: dp is never NaN or
//     -0, and w + dp[pred] is never -0.  take[j] = dp[j+1] > dp[j] is read
//     back from dp by the block afterwards, so the loop stores one float a
//     lane.  About 11 instructions a lane (sm_90a SASS, D = 3), against a
//     shared-memory round trip, an add and a select in a row (~45 cycles)
//     in a plain loop.  D = 2..5 time the same on the card; D = 3 keeps
//     every value in registers (ptxas spilled 24 bytes at D = 4).
//     Predicted ~16-20 us at L = 2048 (~16 cycles a lane at ~1.8 GHz).
//  3. Backtrack by pointer doubling, the whole block.  next(x) = take[x-1] ?
//     pred[x-1] : x-1 for x > 0.  The block first agrees (__syncthreads_or)
//     whether some TAKEN lane has pred[j] > j: a zero-length interval, whose
//     predecessor count includes itself.  Padded lanes (end = inf, so pred =
//     L) also have pred[j] > j, but weigh 0 and are never taken, so they do
//     not send a row to step 4.  Without such a lane next strictly
//     decreases, and the walk from L is a chain.  Starting from mark = {L}
//     and J = next, ceil(log2 L) rounds each mark J[m] for every marked m
//     and set J <- J o J (into a second table), one __syncthreads() a round:
//     after r rounds the marks hold next^i(L) for i < 2^r, the whole walk
//     once 2^r >= L.  Then sel[x-1] = mark[x] & take[x-1].  A thread that
//     reads a mark set in the same round only marks further along the same
//     chain, so the result does not depend on timing.  At L = 2048: 11
//     rounds of L / 512 lanes a thread, ~2-3 us.
//  4. Rows flagged in step 3 keep the single-thread bounded L-step walk:
//     only it reproduces the reference on a path that can climb.
// Predicted time at W = 64, L = 2048: ~16-20 us forward + ~3 us backtrack +
// ~2 us staging and launch: 0.015-0.035 ms.  What bounds it is the forward:
// one thread's instruction issue, ~11 instructions a lane.
//
// The staging area (lanes 8 L, dp 4 (L + 1), take L: 13 L + 4 bytes) is
// reused by the backtrack, so it needs nothing more: next and
// J o J alternate between the two words of each lane (entry x at lane
// x - 1; J[0] = 0 is implicit) and the marks are bytes over dp.  It lives
// in dynamic shared memory -- above 48 KB after cudaFuncSetAttribute --
// and, for an L whose row no longer fits the block's shared memory, in a
// global scratch buffer the wrapper allocates.  pred always comes from the
// host's float64 stable sort and is never recomputed here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatchThreads = 512;
// lookahead of the forward's dp loads, in steps (D)
constexpr int kDepth = 3;
// lanes a thread has in flight in the block-wide loops
constexpr int kBatch = 4;

__host__ __device__ inline size_t row_bytes(int L) {
    // lanes (8L) + dp (4(L+1)) + take (L), rounded up to 16 bytes
    const size_t raw = 13 * static_cast<size_t>(L) + 4;
    return (raw + 15) & ~static_cast<size_t>(15);
}

struct __align__(8) Lane {
    float w;
    int32_t off;  // 4 (pred - j): byte offset of dp[pred] from dp[j]
};

__device__ __forceinline__ float dp_at(const float* dp, int j, int32_t off) {
    return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(dp + j) + off);
}

// The forward DP of one row by one thread; writes dp[1..L] and returns
// dp[L].  dp[0..L] must be zero on entry, and a lane with pred = j carries
// w+ = fmaxf(w, 0) in place of w.  Steps run in order with rounded adds, as
// in the plain version; only the loads run ahead (header, step 2).
template <int D>
__device__ __forceinline__ float wis_forward(const Lane* lane, float* dp, int L) {
    static_assert(D >= 2, "the operands one step ahead need D >= 2");
    constexpr int S = 2 * D;  // lanes in registers: steps j .. j + 2D - 1
    Lane ln[S];         // the lane of the step in slot step % 2D
    float lv[D];        // dp[pred] of the step in slot step % D, loaded D ahead
    float back[D];      // back[k] = dp[j - 1 - k], k < D - 2
    float cur = 0.0f;   // dp[j]
    float b = 0.0f;     // step j's w + dp[pred], for pred != j
    // steps [0, body) pipelined: their loads reach lane[body - 1 + 2D] < L
    const int body = L >= 2 * D ? (L - 2 * D) / S * S : 0;
    if (body > 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) ln[s] = lane[s];
#pragma unroll
        for (int u = 0; u < D; ++u) {
            lv[u] = dp_at(dp, u, ln[u].off);
            back[u] = 0.0f;
        }
        b = __fadd_rn(ln[0].w, lv[0]);  // step 0: pred is 0 or past it
    }
    for (int j0 = 0; j0 < body; j0 += S) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int j = j0 + s;
            const int s1 = (s + 1) % S;
            // step j + 1's w + dp[pred], off the chain: dp[pred] for d in
            // [1, D - 2] from the registers, else as loaded
            float p1 = lv[(s + 1) % D];
#pragma unroll
            for (int k = D - 2; k >= 2; --k) {
                if (ln[s1].off == -4 * k) p1 = back[k - 2];
            }
            if (D >= 3 && ln[s1].off == -4) p1 = cur;
            const float b1 = __fadd_rn(ln[s1].w, p1);
            // the chain: one add or one max
            const float next = ln[s].off == 0 ? __fadd_rn(cur, ln[s].w) : fmaxf(b, cur);
            dp[j + 1] = next;
#pragma unroll
            for (int k = D - 1; k >= 1; --k) back[k] = back[k - 1];
            back[0] = cur;
            cur = next;
            b = b1;
            // issued after the store of dp[j + 1]: step j + D's dp[pred] and
            // step j + 2D's lane, into the slots step j has freed
            lv[s % D] = dp_at(dp, j + D, ln[(s + D) % S].off);
            ln[s] = lane[j + S];
        }
    }
    for (int j = body; j < L; ++j) {  // the last steps, unpipelined
        const Lane l = lane[j];
        const float v = l.off > 0 ? 0.0f : dp_at(dp, j, l.off);
        cur = l.off == 0 ? __fadd_rn(cur, l.w) : fmaxf(__fadd_rn(l.w, v), cur);
        dp[j + 1] = cur;
    }
    return cur;
}

// One window row: stage, forward, backtrack.  Inlined twice, with base in
// shared memory (the compiler then addresses it as such: 32-bit LDS/STS,
// not generic loads) and with base in the global scratch.
__device__ __forceinline__ void settle_row(
    uint8_t* base, const float* __restrict__ weights,
    const float* __restrict__ scores, const float* __restrict__ transform,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ pred, int L, int m_pad,
    uint8_t* __restrict__ sel, float* __restrict__ totals,
    uint8_t* __restrict__ paths) {
    const int row = blockIdx.x;
    Lane* lane = reinterpret_cast<Lane*>(base);
    float* dp = reinterpret_cast<float*>(base + 8 * static_cast<size_t>(L));
    uint8_t* take = base + 12 * static_cast<size_t>(L) + 4;
    const size_t off = static_cast<size_t>(row) * L;

    // 1. staging: kBatch lanes a thread loaded before any is stored
    for (int j0 = threadIdx.x; j0 < L; j0 += kBatch * blockDim.x) {
        float wv[kBatch];
        int pv[kBatch];
#pragma unroll
        for (int n = 0; n < kBatch; ++n) {
            const int j = j0 + n * blockDim.x;
            if (j >= L) continue;
            if (weights != nullptr) {
                wv[n] = weights[off + j];
            } else {
                const int c = min(max(idx[off + j], 0), m_pad - 1);
                float v = scores[c];
                if (transform != nullptr) v = __fmul_rn(v, transform[c]);
                wv[n] = mask[off + j] ? v : 0.0f;
            }
            pv[n] = min(max(pred[off + j], 0), L);  // indexes dp[0..L]
            if (pv[n] == j) wv[n] = fmaxf(wv[n], 0.0f);  // w+ (forward)
        }
#pragma unroll
        for (int n = 0; n < kBatch; ++n) {
            const int j = j0 + n * blockDim.x;
            if (j >= L) continue;
            lane[j] = Lane{wv[n], 4 * (pv[n] - j)};
            dp[j + 1] = 0.0f;  // a pred past j reads 0, as in the reference
        }
    }
    if (threadIdx.x == 0) dp[0] = 0.0f;
    __syncthreads();

    // 2. forward DP, then take from dp
    if (threadIdx.x == 0) totals[row] = wis_forward<kDepth>(lane, dp, L);
    __syncthreads();
    int climbs = 0;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
        const bool t = dp[j + 1] > dp[j];
        take[j] = t ? 1 : 0;
        climbs |= t && lane[j].off > 0;
    }
    const bool climbing = __syncthreads_or(climbs) != 0;
    if (paths != nullptr && threadIdx.x == 0) paths[row] = climbing ? 1 : 0;

    // 3./4. backtrack: marks over dp, mark[x] for cursor positions x = 0..L
    uint8_t* mark = reinterpret_cast<uint8_t*>(dp);
    int32_t* words = reinterpret_cast<int32_t*>(lane);
    if (!climbing) {
        int32_t* ja = words + 1;  // J[x] at ja[2 (x - 1)]: the off words
        int32_t* jb = words;      // then the w words, alternating
        for (int x = threadIdx.x; x <= L; x += blockDim.x) {
            mark[x] = x == L ? 1 : 0;
            if (x < L) ja[2 * x] = take[x] ? x + ja[2 * x] / 4 : x;  // next(x + 1)
        }
        __syncthreads();
        for (int span = 1; span < L; span *= 2) {
            for (int x0 = threadIdx.x + 1; x0 <= L; x0 += kBatch * blockDim.x) {
                int nx[kBatch], nn[kBatch];
                bool marked[kBatch];
#pragma unroll
                for (int n = 0; n < kBatch; ++n) {
                    const int x = x0 + n * blockDim.x;
                    nx[n] = x <= L ? ja[2 * (x - 1)] : 0;
                    marked[n] = x <= L && mark[x];
                }
#pragma unroll
                for (int n = 0; n < kBatch; ++n)
                    nn[n] = nx[n] > 0 ? ja[2 * (nx[n] - 1)] : 0;
#pragma unroll
                for (int n = 0; n < kBatch; ++n) {
                    const int x = x0 + n * blockDim.x;
                    if (x > L) continue;
                    if (nx[n] > 0 && marked[n]) mark[nx[n]] = 1;
                    jb[2 * (x - 1)] = nn[n];
                }
            }
            __syncthreads();
            int32_t* tmp = ja;
            ja = jb;
            jb = tmp;
        }
    } else {
        for (int x = threadIdx.x; x <= L; x += blockDim.x) mark[x] = 0;
        __syncthreads();
        if (threadIdx.x == 0) {
            int j = L;
            for (int step = 0; step < L && j > 0; ++step) {
                mark[j] = 1;
                j = take[j - 1] ? j - 1 + lane[j - 1].off / 4 : j - 1;
            }
        }
        __syncthreads();
    }
    for (int j = threadIdx.x; j < L; j += blockDim.x)
        sel[off + j] = mark[j + 1] & take[j];
}

__global__ void __launch_bounds__(kBatchThreads) wis_batch_kernel(
    const float* __restrict__ weights,    // (W, L), or nullptr when fused
    const float* __restrict__ scores,     // (M_pad,) fused gather source
    const float* __restrict__ transform,  // (M_pad,) or nullptr
    const int32_t* __restrict__ idx,      // (W, L) fused
    const uint8_t* __restrict__ mask,     // (W, L) fused
    const int32_t* __restrict__ pred,     // (W, L)
    int L, int m_pad,
    uint8_t* __restrict__ sel,            // (W, L)
    float* __restrict__ totals,           // (W,)
    uint8_t* __restrict__ scratch,        // nullptr: use shared memory
    uint8_t* __restrict__ paths) {        // (W,) backtrack taken, or nullptr
    extern __shared__ __align__(16) uint8_t smem[];
    if (scratch == nullptr) {
        settle_row(smem, weights, scores, transform, idx, mask, pred, L, m_pad,
                   sel, totals, paths);
    } else {
        settle_row(scratch + static_cast<size_t>(blockIdx.x) * row_bytes(L),
                   weights, scores, transform, idx, mask, pred, L, m_pad, sel,
                   totals, paths);
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

// As wis_batch_launch, and paths (W,) receives, per row, the backtrack the
// kernel took: 0 pointer doubling, 1 the bounded walk.
int wis_batch_launch_paths(const float* weights, const float* scores,
                           const float* transform, const int32_t* idx,
                           const uint8_t* mask, const int32_t* pred,
                           int n_rows, int L, int m_pad,
                           uint8_t* sel, float* totals, uint8_t* scratch,
                           uint8_t* paths, void* stream) {
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
    wis_batch_kernel<<<n_rows, kBatchThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        weights, scores, transform, idx, mask, pred, L, m_pad, sel, totals,
        scratch, paths);
    return static_cast<int>(cudaGetLastError());
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
    return wis_batch_launch_paths(weights, scores, transform, idx, mask, pred,
                                  n_rows, L, m_pad, sel, totals, scratch,
                                  nullptr, stream);
}

}  // extern "C"
