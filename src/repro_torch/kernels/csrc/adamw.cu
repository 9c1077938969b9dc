// AdamW's clip, update and apply for one training step, in two passes.
//
// Replaces no TPU kernel: the reference's optimizer
// (src/repro/training/optimizer.py) is plain jnp, which XLA fuses.  The
// port's plain version (kernels/adamw/ref.py) runs each operation as its
// own torch pass: ~20 parameter-sized passes a leaf, 218 bytes a bf16
// parameter.
//
// grad_sumsq_kernel: one block a tile of kTile elements of one gradient
// leaf, read in its own dtype; each element squared and summed in f32,
// the block's sums added in a fixed tree; one partial a block.
// grad_sumsq_finish_kernel: one block sums every leaf's partials in a
// fixed order, takes the square root (the global norm) and forms the clip
// factor min(1, max_norm / max(norm, 1e-9)).  No atomics, so the norm is
// the same bits on every run; nothing is read back by the host.
//
// adamw_update_kernel: one pass over a leaf that reads g, p, m and v and
// writes m, v and p in place, in f32, in the plain version's order:
//   g32 = f32(g) * scale                      (no scale: f32(g))
//   m   = m*b1 + (1-b1)*g32
//   v   = v*b2 + ((1-b2)*g32)*g32
//   u   = (m / c1) / (sqrt(v / c2) + eps)
//   u   = u + wd*f32(p)
//   o   = to_P(u * nlr)                       (the update, in p's dtype)
//   p   = to_P(f32(p) + f32(o))
//
// Bound on an H100: bytes.  A few operations an element against 22 bytes
// a bf16 parameter (reads g 2, p 2, m 4, v 4; writes m 4, v 4, p 2) or 28
// an f32 one; the norm pass reads g once more.  falcon-mamba-7b's 32-layer
// stage (3.9 G parameters): ~94 GB a step, 28 ms at 3.35 TB/s.
//
// Design: one read of each operand.  16-byte vector loads and stores, 8
// elements a thread an iteration, a scalar tail for a length that is not a
// multiple of 8, and a scalar path for a leaf that is not 16-byte aligned.
// 64-bit element indices: in_proj at 32 layers holds 2^31 elements.  Every
// multiply, add, divide and square root rounds on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn; built with -fmad=false), so the update
// is bit-equal to the plain version; the norm sums in another order than
// torch.sum, a few ulps apart.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;    // elements a thread an iteration (16-byte bf16 loads)
constexpr int kBatch = 4;  // vectors a thread loads before it sums them
constexpr int kTileIters = 32;
constexpr int64_t kTile = int64_t(kThreads) * kVec * kTileIters;  // 65,536
constexpr int kFinishThreads = 1024;
constexpr int kBlocksPerSm = 8;

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

// x rounded to T and back (the plain version's .to(p.dtype), then .float())
template <typename T>
__device__ inline float round_to(float x) { return to_f32(from_f32<T>(x)); }

// 8 consecutive elements from a 16-byte-aligned address, as f32
__device__ inline void load8(const float* src, float out[kVec]) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ inline void load8(const __nv_bfloat16* src, float out[kVec]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: the low half comes first
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

__device__ inline void store8(float* dst, const float in[kVec]) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

// ``in`` holds values already rounded to bf16, so the conversion is exact
__device__ inline void store8(__nv_bfloat16* dst, const float in[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i]));
        const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i + 1]));
        w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// the block's sums added in a fixed tree (n_threads a power of two)
__device__ inline float block_sum(float acc, float* s, int n_threads) {
    const int t = static_cast<int>(threadIdx.x);
    s[t] = acc;
    __syncthreads();
    for (int w = n_threads / 2; w > 0; w >>= 1) {
        if (t < w) s[t] = __fadd_rn(s[t], s[t + w]);
        __syncthreads();
    }
    return s[0];
}

template <typename G>
__global__ void grad_sumsq_kernel(const G* __restrict__ g, int64_t n,
                                  int aligned, float* __restrict__ partials) {
    __shared__ float s[kThreads];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
    const int64_t end = base + kTile < n ? base + kTile : n;
    float acc = 0.0f;
    int64_t tail = base;
    if (aligned) {
        const int64_t vec_end = base + (end - base) / kVec * kVec;
        constexpr int64_t stride = int64_t(kThreads) * kVec;
        for (int64_t i0 = base + threadIdx.x * kVec; i0 < vec_end;
             i0 += kBatch * stride) {
            float x[kBatch][kVec];
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
                const int64_t i = i0 + b * stride;
                if (i < vec_end) {
                    load8(g + i, x[b]);
                } else {
#pragma unroll
                    for (int k = 0; k < kVec; ++k) x[b][k] = 0.0f;
                }
            }
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
#pragma unroll
                for (int k = 0; k < kVec; ++k)
                    acc = __fadd_rn(acc, __fmul_rn(x[b][k], x[b][k]));
        }
        tail = vec_end;
    }
    for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
        const float x = to_f32(g[i]);
        acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
    const float total = block_sum(acc, s, kThreads);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void grad_sumsq_finish_kernel(const float* __restrict__ partials,
                                         int64_t n, float max_norm,
                                         float* __restrict__ norm_out,
                                         float* __restrict__ factor_out) {
    __shared__ float s[kFinishThreads];
    float acc = 0.0f;
    for (int64_t i = threadIdx.x; i < n; i += kFinishThreads)
        acc = __fadd_rn(acc, partials[i]);
    const float total = block_sum(acc, s, kFinishThreads);
    if (threadIdx.x != 0) return;
    const float norm = __fsqrt_rn(total);
    *norm_out = norm;
    if (factor_out == nullptr) return;
    // torch.clamp keeps a NaN (x != x); fmaxf / fminf would drop it
    const float den = norm != norm ? norm : fmaxf(norm, 1e-9f);
    const float f = __fdiv_rn(max_norm, den);
    *factor_out = f != f ? f : fminf(f, 1.0f);
}

struct Hyper {
    float b1, omb1, b2, omb2, c1, c2, eps, wd, nlr;
};

// one element: updates m and v, returns the new p (in P, as f32)
template <typename P>
__device__ inline float adamw_one(float g32, float p32, float& m, float& v,
                                  const Hyper& h) {
    m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g32));
    v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g32), g32));
    float u = __fdiv_rn(__fdiv_rn(m, h.c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
    u = __fadd_rn(u, __fmul_rn(h.wd, p32));
    const float o = round_to<P>(__fmul_rn(u, h.nlr));
    return round_to<P>(__fadd_rn(p32, o));
}

template <typename G, typename P>
__global__ void adamw_update_kernel(const G* __restrict__ g, P* __restrict__ p,
                                    float* __restrict__ m, float* __restrict__ v,
                                    int64_t n, const float* __restrict__ scale,
                                    Hyper h, int aligned) {
    const float sc = scale != nullptr ? *scale : 1.0f;
    const bool scaled = scale != nullptr;
    const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    int64_t tail = 0;
    if (aligned) {
        const int64_t n_vec = n / kVec;
        for (int64_t j = t; j < n_vec; j += threads) {
            const int64_t i = j * kVec;
            float gv[kVec], pv[kVec], mv[kVec], vv[kVec];
            load8(g + i, gv);
            load8(p + i, pv);
            load8(m + i, mv);
            load8(v + i, vv);
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
                const float g32 = scaled ? __fmul_rn(gv[k], sc) : gv[k];
                pv[k] = adamw_one<P>(g32, pv[k], mv[k], vv[k], h);
            }
            store8(m + i, mv);
            store8(v + i, vv);
            store8(p + i, pv);
        }
        tail = n_vec * kVec;
    }
    for (int64_t i = tail + t; i < n; i += threads) {
        const float g32 = scaled ? __fmul_rn(to_f32(g[i]), sc) : to_f32(g[i]);
        float mi = m[i], vi = v[i];
        const float pn = adamw_one<P>(g32, to_f32(p[i]), mi, vi, h);
        m[i] = mi;
        v[i] = vi;
        p[i] = from_f32<P>(pn);
    }
}

int multiprocessors() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess || sms <= 0)
            sms = 132;
    }
    return sms;
}

template <typename G>
int launch_sumsq(const void* g, int64_t n, int aligned, float* partials,
                 void* stream) {
    const int64_t blocks = (n + kTile - 1) / kTile;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    grad_sumsq_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const G*>(g), n, aligned, partials);
    return static_cast<int>(cudaGetLastError());
}

template <typename G, typename P>
int launch_update(const void* g, void* p, float* m, float* v, int64_t n,
                  const float* scale, const Hyper& h, int aligned, void* stream) {
    const int64_t work = aligned ? (n + kVec - 1) / kVec : n;
    int64_t blocks = (work + kThreads - 1) / kThreads;
    const int64_t cap = static_cast<int64_t>(multiprocessors()) * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    adamw_update_kernel<G, P><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const G*>(g), static_cast<P*>(p), m, v, n, scale, h, aligned);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements a partial of grad_sumsq_launch covers: a leaf of n elements
// writes ceil(n / grad_sumsq_tile()) partials.
int grad_sumsq_tile() { return static_cast<int>(kTile); }

// dtype: 0 = float32, 1 = bfloat16.  aligned: g is 16-byte aligned.
// Writes ceil(n / tile) f32 partials from ``partials`` on.  Launches on the
// caller's stream without synchronising and returns cudaGetLastError().
int grad_sumsq_launch(const void* g, int dtype, int64_t n, int aligned,
                      float* partials, void* stream) {
    if (n <= 0) return 0;
    if (dtype == 0) return launch_sumsq<float>(g, n, aligned, partials, stream);
    if (dtype == 1)
        return launch_sumsq<__nv_bfloat16>(g, n, aligned, partials, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The norm, sqrt of the sum of the n partials, into norm (one f32); with
// a factor (one f32, or null), min(1, max_norm / max(norm, 1e-9)) there.
int grad_sumsq_finish_launch(const float* partials, int64_t n, float max_norm,
                             float* norm, float* factor, void* stream) {
    grad_sumsq_finish_kernel<<<1, kFinishThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        partials, n, max_norm, norm, factor);
    return static_cast<int>(cudaGetLastError());
}

// One AdamW step of one leaf of n elements, in place.  g_dtype and
// p_dtype: 0 = float32, 1 = bfloat16; m and v are f32.  scale: one f32 on
// the device (the clip factor), or null.  omb1, omb2: 1 - b1, 1 - b2 as the
// caller rounds them; c1, c2: the bias corrections; wd: the decay of this
// leaf (0 for none); nlr: -lr.  aligned: g, p, m and v are 16-byte aligned.
int adamw_update_launch(const void* g, int g_dtype, void* p, int p_dtype,
                        float* m, float* v, int64_t n, const float* scale,
                        float b1, float omb1, float b2, float omb2, float c1,
                        float c2, float eps, float wd, float nlr, int aligned,
                        void* stream) {
    if (n <= 0) return 0;
    const Hyper h{b1, omb1, b2, omb2, c1, c2, eps, wd, nlr};
    using bf16 = __nv_bfloat16;
    if (g_dtype == 0 && p_dtype == 0)
        return launch_update<float, float>(g, p, m, v, n, scale, h, aligned, stream);
    if (g_dtype == 0 && p_dtype == 1)
        return launch_update<float, bf16>(g, p, m, v, n, scale, h, aligned, stream);
    if (g_dtype == 1 && p_dtype == 0)
        return launch_update<bf16, float>(g, p, m, v, n, scale, h, aligned, stream);
    if (g_dtype == 1 && p_dtype == 1)
        return launch_update<bf16, bf16>(g, p, m, v, n, scale, h, aligned, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
