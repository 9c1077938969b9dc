// Batched weighted-interval-scheduling DP + backtrack, one block per window
// (K2); and the single-window forward DP (K3) at the end of this file, on
// the same forward with its lanes streamed through a ring and dp split
// across a cluster's shared memory (its own header below).
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

// Lanes of a row all staged before the forward starts (K2).
struct ResidentLanes {
    const Lane* lane;
    __device__ __forceinline__ const Lane* window(int j, int) const { return lane + j; }
    __device__ __forceinline__ Lane at(int j) const { return lane[j]; }
};

// The forward DP of one row by one thread; writes dp[1..L] and returns
// dp[L].  dp[0] must hold cur0 and dp[1..L] zero on entry, and a lane with
// pred = j carries w+ = fmaxf(w, 0) in place of w.  Steps run in order
// with rounded adds, as in the plain version; only the loads run ahead
// (header, step 2).  The lanes come from src: window(j, 2D) returns lanes
// j .. j + 2D - 1 once every lane before j has been read, at(j) one lane.
template <int D, class Src>
__device__ __forceinline__ float wis_forward(Src& src, float* dp, int L, float cur0) {
    static_assert(D >= 2, "the operands one step ahead need D >= 2");
    constexpr int S = 2 * D;  // lanes in registers: steps j .. j + 2D - 1
    Lane ln[S];         // the lane of the step in slot step % 2D
    float lv[D];        // dp[pred] of the step in slot step % D, loaded D ahead
    float back[D];      // back[k] = dp[j - 1 - k], k < D - 2
    float cur = cur0;   // dp[j]
    float b = 0.0f;     // step j's w + dp[pred], for pred != j
    // steps [0, body) pipelined: their loads reach lane[body - 1 + 2D] < L
    const int body = L >= 2 * D ? (L - 2 * D) / S * S : 0;
    if (body > 0) {
        const Lane* first = src.window(0, S);
#pragma unroll
        for (int s = 0; s < S; ++s) ln[s] = first[s];
#pragma unroll
        for (int u = 0; u < D; ++u) {
            lv[u] = dp_at(dp, u, ln[u].off);
            back[u] = 0.0f;
        }
        b = __fadd_rn(ln[0].w, lv[0]);  // step 0: pred is 0 or past it
    }
    for (int j0 = 0; j0 < body; j0 += S) {
        const Lane* next_lanes = src.window(j0 + S, S);
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
            ln[s] = next_lanes[s];
        }
    }
    for (int j = body; j < L; ++j) {  // the last steps, unpipelined
        const Lane l = src.at(j);
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
    if (threadIdx.x == 0) {
        ResidentLanes src{lane};
        totals[row] = wis_forward<kDepth>(src, dp, L, 0.0f);
    }
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
// with pred clamped to [0, M] and a pred past j reading 0 (the zero-length
// intervals; the plain version's dp is still 0 there).  out: dp[1..M] (M,)
// float32 and take (M,) int32.  The host sorts, computes pred and
// backtracks (kernels/wis_dp/ops.py::wis_clear).
//
// Bound on an H100: the chain.  Its bytes (16 M: w and pred in, dp and
// take out) take 10 ns at M = 2048 at 3.35 TB/s; its M dependent steps
// cannot overlap, and the adds must run in the plain version's order for a
// bit-equal dp.  The least a step can take is the loop-carried float add or
// max, ~4 cycles (the chain floor: ~4 us at M = 2048 at 1980 MHz); what the
// forward reaches is K2's, one thread issuing ~11 instructions a lane
// (header, step 2).  A TPU keeps all of dp in VMEM; a block here has 227 KB
// of shared memory, so what the design spends it on sets how far one SM
// reaches before dp leaves it.
//
// Design, per block of kDpThreads (4 warps, one role each, so the chain's
// warp has its scheduler to itself):
//  1. dp alone is resident: dp for the block's lanes (4 (n + 1) bytes) in
//     shared memory, zeroed first so that a pred past j reads 0.  A pred
//     past j is pointed at dp[j + 1], still zero when the chain loads it.
//  2. The lanes stream through a ring of kDpStages stages of kDpStageLanes
//     lanes (12 KB).  The producer thread bulk-copies (cp.async.bulk,
//     completion on the stage's mbarrier) w and pred of a stage side by
//     side into its slot; the converter warp turns them in place into K2's
//     8-byte lanes {w, 4 (pred - j)} (w+ = fmaxf(w, 0) where pred = j)
//     and arrives on the stage's full barrier; the chain frees a stage on
//     its empty barrier when it enters the next one, and the producer then
//     refills the slot.  A stage lasts ~6 us at the chain's rate, so four
//     cover the copies' latency many times over.  One block holds dp for
//     up to ~55k lanes (232,448 bytes less 12,416 for ring and barriers).
//  3. The chain is K2's software-pipelined forward (wis_forward<kDepth>) on
//     32-bit shared addressing, dp[pred] loaded kDepth steps ahead, the
//     loop-carried path one add or one max (exact for any float weight:
//     dp is never NaN or -0, NaN and -inf weights are never taken).  It
//     stores dp[j + 1] only; after it the block writes dp_out and take =
//     dp[j + 1] > dp[j], coalesced.
//  4. Past one block, a thread-block cluster (2..8 blocks, a launch
//     attribute) splits the window: block r owns lanes [r S, r S + S) and
//     dp[r S .. r S + S] in its shared memory.  The chain runs in the block
//     that owns lane j and hands off at the boundary: the last step stores
//     dp[(r + 1) S] into the next block's dp[0] (st.shared::cluster) and
//     arrives on that block's hand-off mbarrier (release at cluster
//     scope).  The next block's converter waits for the hand-off, then
//     folds each pred that reaches back into an earlier block (final by
//     then) into w with one remote load (ld.shared::cluster): w + dp[pred],
//     the plain version's add, and the lane then reads the zero at dp[j +
//     1].  So the chain reads only its own shared memory, and stores stay
//     local.  A cluster of 8 reaches ~440k lanes.
//  5. Past that, one block keeps dp in a global scratch (M + 1 floats),
//     the same kernel with the same ring: every dp[pred] is then an L2
//     round trip, still loaded kDepth steps ahead.
// The host chooses the branch from M and the device's limits before the
// launch (dp_plan: shared, else the smallest cluster that fits and can be
// resident, else global) and never after a failure: a launch the device
// refuses is returned as an error.
// ---------------------------------------------------------------------------

constexpr int kDpThreads = 128;     // warp 0 the chain, 1 the producer, 2 the converter
constexpr int kDpStageLanes = 384;  // lanes a ring stage holds
constexpr int kDpStages = 4;        // stages in the ring
constexpr int kDpMaxCluster = 8;    // the portable cluster size
constexpr int kDpRingBytes = kDpStages * kDpStageLanes * 8;
constexpr int kDpBarrierBytes = 128;  // raw_full, full, empty per stage + handoff
static_assert(kDpStageLanes % (2 * kDepth) == 0,
              "the chain's window of 2D lanes must lie in one stage");
static_assert(kDpStageLanes % 32 == 0, "the converter warp takes whole rows of 32");
static_assert(kDpStages >= 2, "the chain frees a stage before it waits for the next");
static_assert((3 * kDpStages + 1) * 8 <= kDpBarrierBytes, "barriers overflow");

// Shared memory of one block: the ring, the barriers and, on the shared
// branches, dp for the block's lanes (lanes + 1 floats, 16-byte rounded).
__host__ __device__ inline size_t dp_block_bytes(int lanes, bool shared_dp) {
    size_t bytes = kDpRingBytes + kDpBarrierBytes;
    if (shared_dp)
        bytes += (4 * (static_cast<size_t>(lanes) + 1) + 15) & ~static_cast<size_t>(15);
    return bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// Wait for the completion of the barrier's phase with this parity, with
// acquire at the block's scope or (kCluster) at the cluster's: the hand-off
// barrier is arrived on from the previous block of the cluster.  A wait
// that never ends traps (a launch error) instead of hanging the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t spins = 0; !done; ++spins) {
        if (spins == (1u << 28)) __trap();
        if (kCluster) {
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(bar), "r"(parity)
                : "memory");
        } else {
            asm volatile(
                "{\n.reg .pred p;\n"
                "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                "selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(bar), "r"(parity)
                : "memory");
        }
    }
}

// The address of this block's shared word `local` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
    return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(addr)
                 : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    // arrive with release, wait with acquire, at the cluster's scope
    asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16) from global to this block's
// shared memory, counted on the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Lanes streamed through the ring (K3): stage t of the block's lanes lands
// in slot t % kDpStages.  The chain's windows of 2D lanes start on a
// multiple of 2D, which divides kDpStageLanes, so a window lies in one stage
// and only the first window of a stage leaves the fast path: it hands the
// stage before back to the producer (its empty barrier) and waits for its
// own (its full barrier).
struct RingLanes {
    const Lane* ring;
    uint32_t full;     // full barrier of slot s at full + 8 s
    uint32_t empty;    // empty barrier of slot s at empty + 8 s
    int avail = 0;     // lanes [0, avail) are converted and waited for
    const Lane* shift = nullptr;  // lane j of the current stage at shift + j

    __device__ __forceinline__ void next_stage(int j) {
        const int t = j / kDpStageLanes;
        if (t > 0) mbar_arrive(empty + 8 * ((t - 1) % kDpStages));
        mbar_wait(full + 8 * (t % kDpStages), (t / kDpStages) & 1);
        avail = (t + 1) * kDpStageLanes;
        shift = ring + (t % kDpStages) * kDpStageLanes - t * kDpStageLanes;
    }
    __device__ __forceinline__ const Lane* window(int j, int) {
        if (__builtin_expect(j >= avail, 0)) next_stage(j);
        return shift + j;
    }
    __device__ __forceinline__ Lane at(int j) {  // the tail: never frees
        if (j >= avail) {
            const int t = j / kDpStageLanes;
            mbar_wait(full + 8 * (t % kDpStages), (t / kDpStages) & 1);
            avail = (t + 1) * kDpStageLanes;
            shift = ring + (t % kDpStages) * kDpStageLanes - t * kDpStageLanes;
        }
        return shift[j];
    }
};

// One block of the window's lanes [base, base + n), base = rank * lanes_per_rank.
// kSharedDp: dp[base .. base + n] in this block's shared memory (a cluster
// of gridDim.x blocks splits the window); else one block, dp in scratch.
template <bool kSharedDp>
__global__ void __launch_bounds__(kDpThreads) wis_dp_kernel(
    const float* __restrict__ weights,  // (M,), 16-byte aligned
    const int32_t* __restrict__ pred,   // (M,), 16-byte aligned
    int M, int lanes_per_rank,
    float* __restrict__ dp_out,         // (M,)
    int32_t* __restrict__ take_out,     // (M,)
    float* __restrict__ scratch) {      // (M + 1,) dp, or nullptr
    extern __shared__ __align__(16) uint8_t smem[];
    Lane* ring = reinterpret_cast<Lane*>(smem);
    const uint32_t raw_full = smem_u32(smem + kDpRingBytes);
    const uint32_t full = raw_full + 8 * kDpStages;
    const uint32_t empty = full + 8 * kDpStages;
    const uint32_t handoff = empty + 8 * kDpStages;
    float* dp;
    if constexpr (kSharedDp) {
        dp = reinterpret_cast<float*>(smem + kDpRingBytes + kDpBarrierBytes);
    } else {
        dp = scratch;
    }
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane_id = tid % 32;
    const int rank = blockIdx.x;
    const int ranks = gridDim.x;
    const int base = rank * lanes_per_rank;
    const int n = min(lanes_per_rank, M - base);
    const int n_stages = (n + kDpStageLanes - 1) / kDpStageLanes;

    // stage t: w and pred of its lanes side by side in slot t % kDpStages,
    // bulk-copied in whole 16 bytes (the converter loads a ragged end)
    auto issue = [&](int t) {
        const int slot = t % kDpStages;
        const int first = t * kDpStageLanes;
        const uint32_t bytes =
            4u * static_cast<uint32_t>(min(kDpStageLanes, n - first) & ~3);
        const uint32_t dst = smem_u32(ring + slot * kDpStageLanes);
        mbar_expect_tx(raw_full + 8 * slot, 2 * bytes);
        if (bytes > 0) {
            bulk_copy(dst, weights + base + first, bytes, raw_full + 8 * slot);
            bulk_copy(dst + 4 * kDpStageLanes, pred + base + first, bytes,
                      raw_full + 8 * slot);
        }
    };

    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < kDpStages; ++s) {
            mbar_init(raw_full + 8 * s, 1);
            mbar_init(full + 8 * s, 32);
            mbar_init(empty + 8 * s, 1);
        }
        mbar_init(handoff, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 32) {
        for (int t = 0; t < kDpStages && t < n_stages; ++t) issue(t);
    }
    // dp ahead of the chain reads zero: a pred past j is pointed at dp[j + 1]
    for (int i = tid; i <= n; i += kDpThreads) dp[i] = 0.0f;
    if (ranks > 1) {
        cluster_sync();  // every block's barriers and zeroed dp are ready
    } else {
        __syncthreads();
    }

    if (warp == 0) {
        if (lane_id == 0) {  // the chain
            float cur0 = 0.0f;
            if constexpr (kSharedDp) {
                if (rank > 0) {
                    mbar_wait<true>(handoff, 0);
                    cur0 = dp[0];  // dp[base], stored by the previous block
                }
            }
            RingLanes src{ring, full, empty};
            const float last = wis_forward<kDepth>(src, dp, n, cur0);
            if constexpr (kSharedDp) {
                if (rank + 1 < ranks) {  // hand off dp[base + n] to the next block
                    st_cluster(cluster_addr(smem_u32(dp), rank + 1), last);
                    mbar_arrive_remote(cluster_addr(handoff, rank + 1));
                }
            }
        }
    } else if (warp == 1) {
        if (lane_id == 0) {  // the producer: refill a slot once the chain freed it
            for (int t = kDpStages; t < n_stages; ++t) {
                mbar_wait(empty + 8 * (t % kDpStages), (t / kDpStages - 1) & 1);
                // the slot was written and read through the generic proxy
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                issue(t);
            }
        }
    } else if (warp == 2) {  // the converter: raw w, pred -> Lane, in place
        if constexpr (kSharedDp) {
            // dp before base is final once the chain has reached this block
            if (rank > 0) mbar_wait<true>(handoff, 0);
        }
        constexpr int kPer = kDpStageLanes / 32;
        for (int t = 0; t < n_stages; ++t) {
            const int slot = t % kDpStages;
            const int first = t * kDpStageLanes;
            const int lanes = min(kDpStageLanes, n - first);
            const int copied = lanes & ~3;
            Lane* stage = ring + slot * kDpStageLanes;
            const float* ws = reinterpret_cast<const float*>(stage);
            const int32_t* ps = reinterpret_cast<const int32_t*>(ws + kDpStageLanes);
            mbar_wait(raw_full + 8 * slot, (t / kDpStages) & 1);
            float wv[kPer];
            int32_t pv[kPer];
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                const int i = lane_id + 32 * m;
                wv[m] = 0.0f;
                pv[m] = 0;
                if (i < copied) {
                    wv[m] = ws[i];
                    pv[m] = ps[i];
                } else if (i < lanes) {
                    wv[m] = weights[base + first + i];
                    pv[m] = pred[base + first + i];
                }
            }
            __syncwarp();  // every raw word is read before a lane overwrites it
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                const int i = lane_id + 32 * m;
                if (i >= lanes) continue;
                const int j = base + first + i;
                // pred in [0, M], and one past j reads the zero at dp[j + 1]
                int p = min(max(pv[m], 0), j + 1);
                float w = wv[m];
                if (p == j) {
                    w = fmaxf(w, 0.0f);  // w+: the chain's add
                } else if (kSharedDp && p < base) {
                    // dp[p] lies in an earlier block and is final: fold it
                    // into w, and let the chain read the zero at dp[j + 1]
                    const int q = p / lanes_per_rank;
                    w = __fadd_rn(w, ld_cluster(cluster_addr(
                                         smem_u32(dp + (p - q * lanes_per_rank)), q)));
                    p = j + 1;
                }
                stage[i] = Lane{w, 4 * (p - j)};
            }
            mbar_arrive(full + 8 * slot);
        }
    }
    __syncthreads();

    // dp and take for the block's lanes, coalesced: take[j] = dp[j+1] > dp[j]
    for (int i = tid; i < n; i += kDpThreads) {
        const float before = dp[i];
        const float after = dp[i + 1];
        dp_out[base + i] = after;
        take_out[base + i] = after > before ? 1 : 0;
    }
    if (ranks > 1) cluster_sync();  // no block leaves while its dp may be read
}

// K3's launch plan: the branch, the blocks in the cluster, the lanes a block
// owns and its shared-memory bytes.
struct DpPlan {
    int path;  // 0 one block, dp in shared memory; 1 a cluster; 2 global scratch
    int cluster;
    int lanes;
    int smem;
};

cudaLaunchConfig_t dp_config(const DpPlan& plan, cudaLaunchAttribute* attr,
                             cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(plan.cluster);
    cfg.blockDim = dim3(kDpThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(plan.smem);
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = plan.cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Whether a cluster of `blocks` blocks, each with the whole opt-in shared
// memory, can be resident on this device at once (cached per device).
cudaError_t cluster_fits(int device, int blocks, int limit, bool* fits) {
    static int known[64][kDpMaxCluster + 1];  // 0 unknown, 1 fits, 2 does not
    if (device < 64 && known[device][blocks] != 0) {
        *fits = known[device][blocks] == 1;
        return cudaSuccess;
    }
    cudaError_t e = cudaFuncSetAttribute(
        wis_dp_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = dp_config(DpPlan{1, blocks, 0, limit}, &attr, nullptr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(&wis_dp_kernel<true>), &cfg);
    if (e != cudaSuccess) return e;
    *fits = clusters > 0;
    if (device < 64) known[device][blocks] = *fits ? 1 : 2;
    return cudaSuccess;
}

// want < 0 chooses: one block if its shared memory holds dp for M lanes,
// else the smallest cluster (2..kDpMaxCluster) whose blocks do and which the
// device can hold, else global scratch.  want = 0, 1, 2 forces a branch
// (a cluster of at least 2); cudaErrorInvalidValue if that branch cannot
// take M.
cudaError_t dp_plan(int M, int want, DpPlan* plan) {
    int device = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    // lanes whose dp (lanes + 1 floats) fits beside the ring, a multiple of 4
    const int fit = ((limit - kDpRingBytes - kDpBarrierBytes) / 4 - 1) & ~3;
    if (want <= 0 && M <= fit) {
        *plan = DpPlan{0, 1, M, static_cast<int>(dp_block_bytes(M, true))};
        return cudaSuccess;
    }
    if (want == 0) return cudaErrorInvalidValue;
    if (want < 0 || want == 1) {
        for (int c = 2; c <= kDpMaxCluster; ++c) {
            const int lanes = ((M + c - 1) / c + 3) & ~3;  // 16-byte copies
            if (lanes > fit || (c - 1) * lanes >= M) continue;
            bool fits = false;
            e = cluster_fits(device, c, limit, &fits);
            if (e != cudaSuccess) return e;
            if (fits) {
                *plan = DpPlan{1, c, lanes, static_cast<int>(dp_block_bytes(lanes, true))};
                return cudaSuccess;
            }
        }
        if (want == 1) return cudaErrorInvalidValue;
    }
    *plan = DpPlan{2, 1, M, static_cast<int>(dp_block_bytes(0, false))};
    return cudaSuccess;
}

}  // namespace

extern "C" {

// K3's plan for M lanes (dp_plan): plan[0] the branch (0 shared, 1 cluster,
// 2 global scratch), plan[1] the blocks in the cluster, plan[2] the lanes
// a block owns, plan[3] its dynamic shared memory.  path < 0 chooses, 0..2
// forces.  Returns a cudaError_t.
int wis_dp_plan(int M, int path, int* plan) {
    if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
    DpPlan p{};
    const cudaError_t e = dp_plan(M, path, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    plan[0] = p.path;
    plan[1] = p.cluster;
    plan[2] = p.lanes;
    plan[3] = p.smem;
    return 0;
}

// The forward DP of one window on a branch: path < 0 as wis_dp_plan
// chooses, 0..2 forced.  weights and pred must be 16-byte aligned;
// scratch holds M + 1 floats on the global branch and is ignored on the
// others.
// Launches on the caller's stream without synchronising and returns
// cudaGetLastError(): a launch the device refuses is an error, never a
// step to another branch.
int wis_dp_launch_on(int path, const float* weights, const int32_t* pred, int M,
                     float* dp_out, int32_t* take_out, float* scratch, void* stream) {
    if (M <= 0) return 0;
    DpPlan p{};
    cudaError_t e = dp_plan(M, path, &p);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = dp_config(p, &attr, static_cast<cudaStream_t>(stream));
    if (p.path == 2) {
        if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        e = cudaLaunchKernelEx(&cfg, wis_dp_kernel<false>, weights, pred, M, p.lanes,
                               dp_out, take_out, scratch);
    } else {
        if (p.smem > 48 * 1024) {
            e = cudaFuncSetAttribute(wis_dp_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        e = cudaLaunchKernelEx(&cfg, wis_dp_kernel<true>, weights, pred, M, p.lanes,
                               dp_out, take_out, static_cast<float*>(nullptr));
    }
    if (e != cudaSuccess) return static_cast<int>(e);
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
