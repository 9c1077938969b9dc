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
// q, k and v are float32 or bfloat16; all arithmetic is float32.
//
// Bound on an H100: operations.  4 * D flops for each (query row, visible
// key) pair -- at recurrentgemma's (1, 16, 4096, 256) with window 2048 about
// 1e11 flops, 0.1 ms at the bf16 tensor-core peak, 1.5 ms at the 67 TFLOP/s
// float32 CUDA-core peak -- against ~71 MB of q, k, v and out (0.02 ms).
//
// Design (CUDA cores, float32; tensor cores, wgmma and TMA are later work):
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
//     each key's probability with one shuffle;
//   * fully masked key tiles are never visited: the block's key loop runs
//     from max(0, first position - window + 1) to min(Sk, last position + 1)
//     (causal), and any Sq and Sk work (the Pallas kernel needs them to tile
//     by 128).  Every row sees at least one key (the wrapper refuses input
//     where one does not).

#include <cstdint>
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  d is one of
// 16, 32, 64, 128, 256.  window <= 0 means no sliding window.  Launches on
// the caller's stream without synchronising and returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int n_batch, int n_hq, int n_hkv, int sq,
                           int sk, int d, int dtype, int causal, int window,
                           int q_offset, float scale, void* stream) {
    if (n_hkv <= 0 || n_hq % n_hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0)
        return launch_d<float>(d, q, k, v, out, n_batch, n_hq, n_hkv, sq, sk,
                               causal, window, q_offset, scale, stream);
    if (dtype == 1)
        return launch_d<__nv_bfloat16>(d, q, k, v, out, n_batch, n_hq, n_hkv,
                                       sq, sk, causal, window, q_offset, scale,
                                       stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
