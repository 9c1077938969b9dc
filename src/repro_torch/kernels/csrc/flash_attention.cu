// Flash attention (online softmax) with GQA, causal and sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (mha_pallas, body _attn_kernel).
//
// For q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), query head h reads kv head
// h / (Hq / Hkv).  Query row i sits at position qp = q_offset + i and sees
// key k when (!causal || k <= qp) && (window <= 0 || k > qp - window):
//   s_k = (q . k_k) * scale in float32, masked keys -1e30 (finite, as the
//   reference);  out = sum_k softmax(s)_k v_k / max(l, 1e-30), in q's dtype.
// q, k and v are float32 or bfloat16; softmax arithmetic is float32.
//
// Bound on an H100: operations.  4 * D flops for each (query row, visible
// key) pair -- at recurrentgemma's (1, 16, 4096, 256) with window 2048 about
// 1e11 flops, 0.1 ms at the bf16 tensor-core peak, 1.5 ms at the 67 TFLOP/s
// float32 CUDA-core peak -- against ~71 MB of q, k, v and out (0.02 ms).
//
// Two kernels; flash_attention_path() says which one a call takes.
//
// 1. Tensor cores (bfloat16, D = 64, 128 or 256): flash_attention_tc_kernel.
//    Bound by the tensor cores' 989 TFLOP/s; what stands between it and the
//    bound is feeding them: K/V bytes from L2, the softmax between the two
//    products, and the exp.
//   * one block owns 128 query rows of one (b, kv head) in two warpgroups of
//     64.  Rows are ordered (position, head in group), so for MQA a block is
//     8 positions x 16 heads and every K/V tile feeds all 16 heads; the
//     block's key range [k_lo, k_hi) is about window + 8 wide;
//   * Q is staged once, with 16-byte loads, in the 128-byte-swizzled K-major
//     layout a wgmma descriptor reads (16-byte chunk c of row r at c ^ r % 8);
//   * K and V tiles of Bk keys (64; 128 at D = 128) come in by TMA (one 3-D
//     tensor map each over (D, Sk, B * Hkv), 64-column boxes, 128-byte
//     swizzle; rows past Sk read as zeros) into a ring of 2 stages.  A
//     "full" mbarrier per stage counts the TMA bytes, an "empty" one the
//     256 threads done reading it; one thread issues tile j + 1 into the
//     stage tile j - 1 freed before the block computes on tile j, so the
//     two warpgroups drift up to a tile apart instead of meeting at a
//     block barrier every tile;
//   * S = Q K^T by wgmma m64nBk k16 with both operands in shared memory;
//     the descriptor steps 32 bytes per k16 inside a swizzle atom and one
//     box every 4 steps;
//   * online softmax on the f32 accumulator in registers: each thread owns 2
//     rows, exp2 with scale * log2(e) folded in, l summed from the f32 p, the
//     row max reduced over the 4 threads of a row with 2 shuffles.  Masks are
//     applied only on tiles that cross a causal, window or k_hi edge;
//   * O += P V by wgmma m64nDk16 with P in registers: the S accumulator
//     converts pairwise to the bf16 A fragment, no shuffles; V is read from
//     the same swizzled boxes as K through the descriptor's transpose bit.
//     p is rounded to bf16 there, as the reference casts probs to v's dtype;
//   * blocks with the most keys (the latest positions) are launched first.
//    Shared memory at D = 256: 64 KB of Q plus 2 x 64 KB of K/V stages;
//    registers at D = 256: 128 of O, 32 of S, 16 of P (208 in all).
//
// 2. CUDA cores (float32 at any D, and bfloat16 at D = 16 or 32):
//    flash_attention_kernel.  Bound by the 67 TFLOP/s float32 FMA rate (the
//    tensor cores would run float32 as TF32, too coarse for its 2e-5
//    tolerance):
//   * the TPU kernel walked the key blocks of one (b, h, q block) in grid
//     order with m, l and acc in VMEM scratch.  Here one block takes 32 query
//     rows of one (b, kv head): rows are ordered (position, head in group), so
//     for MQA the 16 heads of two positions share every K/V tile the block
//     stages in shared memory (32 keys at a time, 16-byte loads);
//   * one warp owns 4 rows, each lane D/32 of the head dimension (for D = 16,
//     lanes 16-31 hold zeros).  A key's 4 dot products take the warp's K row
//     once from shared memory, and lane partials are summed by xor shuffles;
//     lane j keeps the score of the tile's key j;
//   * the online softmax runs per 32-key tile in registers: running max from
//     -1e30, rescale by exp(m_old - m_new), and the PV product broadcasts
//     each key's probability with one shuffle.
//
// In both, fully masked key tiles are never visited: a block's key loop runs
// from max(0, first position - window + 1) to min(Sk, last position + 1)
// (causal), and any Sq and Sk work (the Pallas kernel needs them to tile by
// 128).  Every row sees at least one key (the wrapper refuses input where
// one does not); a row whose first tiles are all masked sums p = 1 garbage
// that alpha = exp(-1e30 - m) = 0 wipes once its first key arrives.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kRows = 4;                     // query rows a warp owns
constexpr int kBlockRows = kWarps * kRows;   // query rows a block owns
constexpr int kTile = 32;                    // keys a K/V tile holds

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline float from_f32<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = uint16_t; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// The head-dimension entries one lane owns: kPer of them, in chunks of kChunk
// contiguous entries; chunk c of lane l starts at (c * 32 + l) * kChunk, so
// each load instruction of a warp reads one contiguous run of a row.
template <typename T, int D>
struct Lane {
    static constexpr int kPer = D >= 32 ? D / 32 : 1;
    static constexpr int kMaxChunk = 16 / static_cast<int>(sizeof(T));
    static constexpr int kChunk = kPer < kMaxChunk ? kPer : kMaxChunk;
    static constexpr int kChunks = kPer / kChunk;
    using Vec = typename VecOf<kChunk * static_cast<int>(sizeof(T))>::type;

    __device__ static bool active(int lane) { return D >= 32 || lane < D; }

    __device__ static void load(const T* row, int lane, float (&out)[kPer]) {
        if (!active(lane)) {
#pragma unroll
            for (int i = 0; i < kPer; ++i) out[i] = 0.0f;
            return;
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            const Vec v = *reinterpret_cast<const Vec*>(row + (c * 32 + lane) * kChunk);
            const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
            for (int i = 0; i < kChunk; ++i) out[c * kChunk + i] = to_f32(e[i]);
        }
    }

    __device__ static void store(T* row, int lane, const float (&in)[kPer]) {
        if (!active(lane)) return;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
            Vec v;
            T* e = reinterpret_cast<T*>(&v);
#pragma unroll
            for (int i = 0; i < kChunk; ++i) e[i] = from_f32<T>(in[c * kChunk + i]);
            *reinterpret_cast<Vec*>(row + (c * 32 + lane) * kChunk) = v;
        }
    }
};

__device__ inline float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    return x;
}

__device__ inline float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
    return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int n_hq, int n_hkv, int sq, int sk, int group,
                       int causal, int window, int q_offset, float scale) {
    using L = Lane<T, D>;
    constexpr int kPer = L::kPer;
    constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));
    constexpr int kRowVecs = D / kVecElems;  // 16-byte vectors in one row

    extern __shared__ __align__(16) uint8_t smem[];
    T* k_tile = reinterpret_cast<T*>(smem);
    T* v_tile = k_tile + kTile * D;

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int bh = blockIdx.y;  // b * n_hkv + kv head
    const int b = bh / n_hkv;
    const int kvh = bh - b * n_hkv;
    const int64_t n_rows = static_cast<int64_t>(group) * sq;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBlockRows;

    // the keys any row of this block can see; tiles outside are never read
    const int first_pos = static_cast<int>(row0 / group);
    const int64_t last_row = row0 + kBlockRows - 1 < n_rows ? row0 + kBlockRows - 1
                                                             : n_rows - 1;
    const int last_pos = static_cast<int>(last_row / group);
    int k_lo = 0, k_hi = sk;
    if (window > 0) k_lo = max(0, first_pos + q_offset - window + 1);
    if (causal) k_hi = min(sk, last_pos + q_offset + 1);

    float qr[kRows][kPer], acc[kRows][kPer], m[kRows], l[kRows];
    int qpos[kRows];
    int64_t qoff[kRows];
    bool valid[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + warp * kRows + r;
        valid[r] = row < n_rows;
        const int64_t rr = valid[r] ? row : 0;
        const int pos = static_cast<int>(rr / group);
        const int h = kvh * group + static_cast<int>(rr - static_cast<int64_t>(pos) * group);
        qoff[r] = ((static_cast<int64_t>(b) * n_hq + h) * sq + pos) * D;
        L::load(q + qoff[r], lane, qr[r]);
        qpos[r] = pos + q_offset;
        m[r] = kNegInf;
        l[r] = 0.0f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[r][i] = 0.0f;
    }

    const T* k_head = k + static_cast<int64_t>(bh) * sk * D;
    const T* v_head = v + static_cast<int64_t>(bh) * sk * D;

    for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
        const int nk = min(kTile, k_hi - k0);
        __syncthreads();  // every warp is done with the previous tile
        for (int i = threadIdx.x; i < kTile * kRowVecs; i += blockDim.x) {
            const int j = i / kRowVecs;
            const int c = i - j * kRowVecs;
            uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (j < nk) {
                const int64_t at = static_cast<int64_t>(k0 + j) * D + c * kVecElems;
                kv = *reinterpret_cast<const uint4*>(k_head + at);
                vv = *reinterpret_cast<const uint4*>(v_head + at);
            }
            *reinterpret_cast<uint4*>(k_tile + j * D + c * kVecElems) = kv;
            *reinterpret_cast<uint4*>(v_tile + j * D + c * kVecElems) = vv;
        }
        __syncthreads();

        // scores: after the loop lane j holds key k0 + j's score of each row
        float s[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = kNegInf;
#pragma unroll 2
        for (int j = 0; j < nk; ++j) {
            float kr[kPer];
            L::load(k_tile + j * D, lane, kr);
            const int key = k0 + j;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                float part = 0.0f;
#pragma unroll
                for (int i = 0; i < kPer; ++i) part = fmaf(qr[r][i], kr[i], part);
                part = warp_sum(part);
                const bool seen = (!causal || key <= qpos[r]) &&
                                  (window <= 0 || key > qpos[r] - window);
                if (lane == j) s[r] = seen ? part * scale : kNegInf;
            }
        }

        // online softmax over the tile; lanes past the tile's keys weigh 0
        float p[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float m_new = fmaxf(m[r], warp_max(s[r]));
            p[r] = lane < nk ? expf(s[r] - m_new) : 0.0f;
            const float alpha = expf(m[r] - m_new);
            l[r] = alpha * l[r] + warp_sum(p[r]);
            m[r] = m_new;
#pragma unroll
            for (int i = 0; i < kPer; ++i) acc[r][i] *= alpha;
        }
#pragma unroll 2
        for (int j = 0; j < nk; ++j) {
            float vr[kPer];
            L::load(v_tile + j * D, lane, vr);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
                for (int i = 0; i < kPer; ++i) acc[r][i] = fmaf(pj, vr[i], acc[r][i]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (!valid[r]) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        float o[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) o[i] = acc[r][i] / denom;
        L::store(out + qoff[r], lane, o);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int n_batch,
           int n_hq, int n_hkv, int sq, int sk, int causal, int window,
           int q_offset, float scale, void* stream) {
    const int group = n_hq / n_hkv;
    const int64_t n_rows = static_cast<int64_t>(group) * sq;
    const int64_t blocks_x = (n_rows + kBlockRows - 1) / kBlockRows;
    const int64_t blocks_y = static_cast<int64_t>(n_batch) * n_hkv;
    if (blocks_x <= 0 || blocks_y <= 0) return 0;
    if (blocks_x > 0x7fffffff || blocks_y > 65535)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const size_t smem = 2 * static_cast<size_t>(kTile) * D * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_attention_kernel<T, D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
    flash_attention_kernel<T, D><<<grid, kWarps * 32, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), n_hq, n_hkv, sq, sk,
        group, causal, window, q_offset, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int n_batch, int n_hq, int n_hkv, int sq, int sk, int causal,
             int window, int q_offset, float scale, void* stream) {
#define FA_CASE(DIM)                                                          \
    case DIM:                                                                 \
        return launch<T, DIM>(q, k, v, out, n_batch, n_hq, n_hkv, sq, sk,     \
                              causal, window, q_offset, scale, stream);
    switch (d) {
        FA_CASE(16)
        FA_CASE(32)
        FA_CASE(64)
        FA_CASE(128)
        FA_CASE(256)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_CASE
}


// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16, D in {64, 128, 256}; wgmma on tiles TMA brings
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;     // query rows a block owns: 2 warpgroups x 64
constexpr int kTcThreads = 256;
constexpr int kTcStages = 2;     // K/V tiles in flight (ring of stages)
constexpr int kBoxCols = 64;     // head-dim columns of one TMA box: 128 bytes
constexpr int kSwizzleRow = 128; // bytes of one row of a 128-byte-swizzled box
constexpr int kAtom = 8 * kSwizzleRow;  // one swizzle atom: 8 rows
constexpr float kLog2e = 1.4426950408889634f;

// keys a K/V tile holds: 128 at D = 128, where it halves the per-tile
// softmax and barrier overhead; 64 at D = 256, where two stages of 128
// would not fit, and at D = 64, where 128 timed slower on an H100
template <int D>
struct TcTile {
    static constexpr int kKeys = D == 128 ? 128 : 64;
    static constexpr int kQBox = kTcRows * kSwizzleRow;   // 64 columns of Q
    static constexpr int kQ = kTcRows * D * 2;
    static constexpr int kKvBox = kKeys * kSwizzleRow;    // 64 columns of K or V
    static constexpr int kKv = kKeys * D * 2;              // one K or V tile
    static constexpr int kStage = 2 * kKv;                 // K then V
    // + 1 KB so the base can be aligned to a swizzle atom
    static constexpr int kBytes = kQ + kTcStages * kStage + kAtom;
};

__device__ inline uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
                 : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// wait for the completion of the barrier's phase with this parity; a load
// that never lands traps (a launch error) instead of hanging the card
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t spins = 0; !done; ++spins) {
        if (spins == (1u << 28)) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// one box of a 3-D tensor map into shared memory; completion counted on bar
__device__ inline void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                   int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ inline void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous region between issue and wait
template <int N>
__device__ inline void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled layout;
// lbo and sbo in bytes (stored in 16-byte units)
__device__ inline uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ inline float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) = scale_d * D + A (64 x 16) B (16 x 64); A and B K-major in shared memory
__device__ inline void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) = scale_d * D + A (64 x 16) B (16 x 128); A and B K-major in shared memory
__device__ inline void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) B (16 x 64); B MN-major (transposed) in shared memory
__device__ inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) B (16 x 128); B MN-major (transposed) in shared memory
__device__ inline void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) B (16 x 256); B MN-major (transposed) in shared memory
__device__ inline void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ inline void wgmma_qk(float (&s)[N / 2], uint64_t a, uint64_t b, int scale_d) {
    if constexpr (N == 64) wgmma_ss_n64(s, a, b, scale_d);
    if constexpr (N == 128) wgmma_ss_n128(s, a, b, scale_d);
}

template <int D>
__device__ inline void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (D == 64) wgmma_rs_n64(o, a, b);
    if constexpr (D == 128) wgmma_rs_n128(o, a, b);
    if constexpr (D == 256) wgmma_rs_n256(o, a, b);
}

// one thread brings the K and V tile at key k0 of kv row bh into a stage
template <int D>
__device__ inline void issue_kv(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                uint32_t full0, uint32_t kv_s, int stage, int k0, int bh) {
    using Tile = TcTile<D>;
    const uint32_t bar = full0 + 8 * stage;
    const uint32_t k_t = kv_s + stage * Tile::kStage;
    mbar_expect_tx(bar, Tile::kStage);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c) {
        tma_load_3d(k_t + c * Tile::kKvBox, k_map, bar, c * kBoxCols, k0, bh);
        tma_load_3d(k_t + Tile::kKv + c * Tile::kKvBox, v_map, bar, c * kBoxCols, k0, bh);
    }
}

// wgmma accumulator layout (m64nN, f32): thread t of a warpgroup holds rows
// 16 * (t / 32) + (t % 32) / 4 and that + 8; register 4 i + 2 x + e holds
// row x's column 8 i + 2 (t % 4) + e.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __nv_bfloat16* __restrict__ q,
                          __nv_bfloat16* __restrict__ out, int n_hq, int n_hkv,
                          int sq, int sk, int group, int causal, int window,
                          int q_offset, float scale_log2) {
    using Tile = TcTile<D>;
    constexpr int kKeys = Tile::kKeys;
    constexpr int kAcc = D / 2;           // O accumulator floats a thread holds
    constexpr int kSAcc = kKeys / 2;      // S accumulator floats a thread holds
    constexpr int kChunks = D / 8;        // 16-byte chunks in a row of Q

    extern __shared__ uint8_t smem_raw[];
    // full[s]: stage s's K and V tile has landed (TMA bytes); empty[s]:
    // every thread is done reading it (all 256 arrive)
    __shared__ __align__(8) uint64_t full[kTcStages], empty[kTcStages];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + kAtom - 1) & ~static_cast<uint32_t>(kAtom - 1);
    uint8_t* const base_ptr = smem_raw + (base - raw);
    const uint32_t q_s = base;               // Q: D / 64 boxes of 128 rows
    const uint32_t kv_s = base + Tile::kQ;   // stage s: K, then V, D / 64 boxes each
    const uint32_t full0 = smem_u32(&full[0]);
    const uint32_t empty0 = smem_u32(&empty[0]);

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int bh = blockIdx.y;  // b * n_hkv + kv head
    const int b = bh / n_hkv;
    const int kvh = bh - b * n_hkv;
    const int64_t n_rows = static_cast<int64_t>(group) * sq;
    // the latest positions see the most keys under a causal mask: start them first
    const int64_t row0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kTcRows;

    // the keys any row of this block can see; tiles outside are never read
    const int first_pos = static_cast<int>(row0 / group);
    const int64_t last_row = row0 + kTcRows - 1 < n_rows ? row0 + kTcRows - 1 : n_rows - 1;
    const int last_pos = static_cast<int>(last_row / group);
    int k_lo = 0, k_hi = sk;
    if (window > 0) k_lo = max(0, first_pos + q_offset - window + 1);
    if (causal) k_hi = min(sk, last_pos + q_offset + 1);
    const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < kTcStages; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, kTcThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid == 0)
        for (int t = 0; t < kTcStages - 1 && t < n_tiles; ++t)
            issue_kv<D>(&k_map, &v_map, full0, kv_s, t, k_lo + t * kKeys, bh);

    // Q rows (position, head in group), padded rows zero, swizzled K-major
    for (int i = tid; i < kTcRows * kChunks; i += kTcThreads) {
        const int r = i / kChunks;
        const int c = i - r * kChunks;
        const int64_t row = row0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row < n_rows) {
            const int pos = static_cast<int>(row / group);
            const int h = kvh * group + static_cast<int>(row - static_cast<int64_t>(pos) * group);
            val = *reinterpret_cast<const uint4*>(
                q + ((static_cast<int64_t>(b) * n_hq + h) * sq + pos) * D + c * 8);
        }
        *reinterpret_cast<uint4*>(base_ptr + (c >> 3) * Tile::kQBox + r * kSwizzleRow +
                                  (((c & 7) ^ (r & 7)) << 4)) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma
    __syncthreads();

    // this thread's 2 rows: their key range and their place in out
    int lo[2], hi[2];
    bool row_ok[2];
    int64_t o_off[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        const int64_t row = row0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * x;
        row_ok[x] = row < n_rows;
        const int64_t rr = row_ok[x] ? row : n_rows - 1;  // padded rows: never stored
        const int pos = static_cast<int>(rr / group);
        const int h = kvh * group + static_cast<int>(rr - static_cast<int64_t>(pos) * group);
        const int qp = pos + q_offset;
        lo[x] = window > 0 ? max(k_lo, qp - window + 1) : k_lo;
        hi[x] = causal ? min(k_hi, qp + 1) : k_hi;
        o_off[x] = ((static_cast<int64_t>(b) * n_hq + h) * sq + pos) * D + 2 * (lane & 3);
    }
    // a tile whose keys every row of the block sees needs no mask
    const int min_qp = first_pos + q_offset;
    const int max_qp = last_pos + q_offset;

    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const uint32_t q_wg = q_s + wg * 64 * kSwizzleRow;

    for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % kTcStages;
        const int k0 = k_lo + j * kKeys;
        // tile j + kTcStages - 1 goes into the stage tile j - 1 used, once
        // every thread is done with it
        const int next = j + kTcStages - 1;
        if (tid == 0 && next < n_tiles) {
            const int ns = next % kTcStages;
            if (j > 0) mbar_wait(empty0 + 8 * ns, ((j - 1) / kTcStages) & 1);
            issue_kv<D>(&k_map, &v_map, full0, kv_s, ns, k_lo + next * kKeys, bh);
        }
        __syncwarp();  // warp 0 reconverges before the warpgroup-wide wgmma
        mbar_wait(full0 + 8 * stage, (j / kTcStages) & 1);
        const uint32_t k_t = kv_s + stage * Tile::kStage;
        const uint32_t v_t = k_t + Tile::kKv;

        // S = Q K^T: k16 steps of 32 bytes inside a box, a new box every 4
        float s[kSAcc];
#pragma unroll
        for (int i = 0; i < kSAcc; ++i) s[i] = 0.0f;
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t step = (kk & 3) * 32;
            wgmma_qk<kKeys>(s, smem_desc(q_wg + (kk >> 2) * Tile::kQBox + step, 16, kAtom),
                            smem_desc(k_t + (kk >> 2) * Tile::kKvBox + step, 16, kAtom), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // online softmax, in log2 units
        const bool edge = k0 + kKeys > k_hi || (causal && k0 + kKeys - 1 > min_qp) ||
                          (window > 0 && k0 <= max_qp - window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < kSAcc / 4; ++i) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& t = s[4 * i + 2 * x + e];
                    t *= scale_log2;
                    if (edge) {
                        const int key = k0 + 8 * i + 2 * (lane & 3) + e;
                        if (key < lo[x] || key >= hi[x]) t = kNegInf;
                    }
                    mx[x] = fmaxf(mx[x], t);
                }
            }
        }
        float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int x = 0; x < 2; ++x) {
            mx[x] = fmaxf(mx[x], __shfl_xor_sync(kFull, mx[x], 1));
            mx[x] = fmaxf(mx[x], __shfl_xor_sync(kFull, mx[x], 2));
            alpha[x] = fast_exp2(m[x] - mx[x]);
            m[x] = mx[x];
        }
#pragma unroll
        for (int i = 0; i < kSAcc / 4; ++i) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& t = s[4 * i + 2 * x + e];
                    t = fast_exp2(t - m[x]);
                    sum[x] += t;
                }
            }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + sum[x];
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
                o[4 * i + 2 * x] *= alpha[x];
                o[4 * i + 2 * x + 1] *= alpha[x];
            }
        }

        // P as the A fragment of k16 step kk: columns 16 kk .. 16 kk + 15
        uint32_t p[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
            p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }

        // O += P V: V read MN-major (transposed) from the K-layout boxes;
        // 16 keys a step, 8-key atoms kAtom apart, 64-column boxes kKvBox apart
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
            wgmma_pv<D>(o, p[kk], smem_desc(v_t + kk * 16 * kSwizzleRow, Tile::kKvBox, kAtom));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        mbar_arrive(empty0 + 8 * stage);
    }

    // out = O / l, l summed over the 4 threads of a row
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        l[x] += __shfl_xor_sync(kFull, l[x], 1);
        l[x] += __shfl_xor_sync(kFull, l[x], 2);
        const float inv = 1.0f / fmaxf(l[x], 1e-30f);
        if (!row_ok[x]) continue;
        __nv_bfloat16* dst = out + o_off[x];
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i)
            *reinterpret_cast<uint32_t*>(dst + 8 * i) =
                pack_bf16(o[4 * i + 2 * x] * inv, o[4 * i + 2 * x + 1] * inv);
    }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so the
// library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// (D, Sk, B * Hkv) bf16, boxes of 64 columns x kKeys keys x 1 head
int kv_tensor_map(CUtensorMap* map, const void* ptr, int d, int keys, int sk, int n_bh) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(sk),
                                static_cast<cuuint64_t>(n_bh)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(sk) * d * 2};
    const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(keys), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int n_batch,
              int n_hq, int n_hkv, int sq, int sk, int causal, int window,
              int q_offset, float scale, void* stream) {
    const int group = n_hq / n_hkv;
    const int64_t n_rows = static_cast<int64_t>(group) * sq;
    const int64_t blocks_x = (n_rows + kTcRows - 1) / kTcRows;
    const int64_t blocks_y = static_cast<int64_t>(n_batch) * n_hkv;
    if (blocks_x <= 0 || blocks_y <= 0) return 0;
    if (blocks_x > 0x7fffffff || blocks_y > 65535)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    CUtensorMap k_map, v_map;
    const int keys = TcTile<D>::kKeys;
    int e = kv_tensor_map(&k_map, k, D, keys, sk, static_cast<int>(blocks_y));
    if (e == 0) e = kv_tensor_map(&v_map, v, D, keys, sk, static_cast<int>(blocks_y));
    if (e != 0) return e;
    const int smem = TcTile<D>::kBytes;
    const cudaError_t a = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return static_cast<int>(a);
    const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
    flash_attention_tc_kernel<D><<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out),
        n_hq, n_hkv, sq, sk, group, causal, window, q_offset, scale * kLog2e);
    return static_cast<int>(cudaGetLastError());
}

// 1 where bf16 at this head dim runs on the tensor cores, 0 for the CUDA cores
int tc_path(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128 || d == 256); }

}  // namespace

extern "C" {

// Which kernel flash_attention_launch takes for (dtype, d): 1 for the tensor
// cores (flash_attention_tc_kernel), 0 for the CUDA cores.
int flash_attention_path(int dtype, int d) { return tc_path(dtype, d); }

// flash_attention_launch on a chosen kernel: path 1 (tensor cores) takes
// what flash_attention_path gives 1 for; path 0 (CUDA cores) takes every
// dtype and d, so the two kernels can be timed on the same bfloat16 input.
int flash_attention_launch_on(int path, const void* q, const void* k, const void* v,
                              void* out, int n_batch, int n_hq, int n_hkv, int sq,
                              int sk, int d, int dtype, int causal, int window,
                              int q_offset, float scale, void* stream) {
    if (n_hkv <= 0 || n_hq % n_hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (path == 1) {
        if (!tc_path(dtype, d)) return static_cast<int>(cudaErrorInvalidValue);
#define FA_TC_CASE(DIM)                                                       \
    if (d == DIM)                                                             \
        return launch_tc<DIM>(q, k, v, out, n_batch, n_hq, n_hkv, sq, sk,     \
                              causal, window, q_offset, scale, stream);
        FA_TC_CASE(64)
        FA_TC_CASE(128)
        FA_TC_CASE(256)
#undef FA_TC_CASE
    }
    if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return launch_d<float>(d, q, k, v, out, n_batch, n_hq, n_hkv, sq, sk,
                               causal, window, q_offset, scale, stream);
    if (dtype == 1)
        return launch_d<__nv_bfloat16>(d, q, k, v, out, n_batch, n_hq, n_hkv,
                                       sq, sk, causal, window, q_offset, scale,
                                       stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  d is one of
// 16, 32, 64, 128, 256.  window <= 0 means no sliding window.  Launches on
// the caller's stream without synchronising and returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int n_batch, int n_hq, int n_hkv, int sq,
                           int sk, int d, int dtype, int causal, int window,
                           int q_offset, float scale, void* stream) {
    return flash_attention_launch_on(tc_path(dtype, d), q, k, v, out, n_batch, n_hq,
                                     n_hkv, sq, sk, d, dtype, causal, window, q_offset,
                                     scale, stream);
}

}  // extern "C"
