// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t, one thread per channel.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py
// (linear_scan_pallas, body _scan_kernel).
//
// Per channel (b, d) of a (B, T, D) layout, with an f32 carry:
//   h = h0[b, d] (or 0);  for t in 0..T-1:  h = a[b,t,d] * h + b[b,t,d]
//   out[b, t, d] = h in a's dtype;  hT[b, d] = h in a's dtype
//
// Bound on an H100: bytes.  Each a, b and out element is touched once
// (3 * B*T*D * size bytes); one multiply and one add an element is far
// below the card's f32 rate.  At the mamba prefill's D = d_inner * N =
// 131072, T = 512, f32: 805 MB, 0.24 ms at 3.35 TB/s.
//
// Design: the TPU kernel walked time blocks in grid order with the carry
// in VMEM scratch.  Here time is a loop inside each thread and the carry a
// register; channels are independent, so the grid is B*D threads with d
// fastest, and every timestep's loads and stores are coalesced across a
// warp.  Each thread loads kUnroll timesteps of a and b before it runs
// them, so the loads of a chunk are in flight together while the chain of
// dependent multiply-adds runs.  Any T: the tail chunk is a plain loop
// (the Pallas kernel needs T to tile by its time block).  Every multiply
// and add rounds on its own (__fmul_rn / __fadd_rn, built with
// -fmad=false), so the result is bit-equal to the plain torch loop.

// The backward (linear_scan_bwd_kernel) has no TPU kernel to replace: the
// reference differentiates its scan through XLA, and reverse mode through
// linear_scan_pallas raises in its JVP rule.  Per channel, with the saved
// a, the forward's h and h0, and the cotangents gh (B, T, D), ghT (B, D):
//   c = ghT[b, d] (or 0);  for t = T-1 down to 0:
//     g = gh[b,t,d] + c;  db[b,t,d] = g;  da[b,t,d] = g * h[b,t-1,d]
//     (h[b,-1,d] = h0[b, d], or 0);  c = a[b,t,d] * g
//   dh0[b, d] = c  (= a_0 * g_0)
// Bound: bytes again.  It reads a, h and gh and writes da and db: 5 * B*T*D
// * size bytes, 5.37 GB (1.60 ms at 3.35 TB/s) at falcon-mamba's training
// shape (4, 512, 131072) f32.  Design as the forward's, walking t downward:
// one thread a channel, d fastest, kUnroll timesteps' loads issued before
// their chain runs, each multiply and add rounded on its own, so it is
// bit-equal to the plain reverse loop in ref.py.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

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

template <typename T>
__global__ void linear_scan_kernel(const T* __restrict__ a,
                                   const T* __restrict__ b,
                                   const float* __restrict__ h0,  // or nullptr
                                   int n_batch, int n_t, int n_d,
                                   T* __restrict__ out,
                                   T* __restrict__ hT) {
    const int64_t ch = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (ch >= static_cast<int64_t>(n_batch) * n_d) return;
    const int64_t bi = ch / n_d;
    const int64_t d = ch - bi * n_d;
    const int64_t stride = n_d;
    int64_t off = bi * static_cast<int64_t>(n_t) * n_d + d;

    float h = h0 != nullptr ? h0[ch] : 0.0f;
    int t = 0;
    for (; t + kUnroll <= n_t; t += kUnroll) {
        float av[kUnroll], bv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            av[u] = to_f32(a[off + u * stride]);
            bv[u] = to_f32(b[off + u * stride]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
            out[off + u * stride] = from_f32<T>(h);
        }
        off += kUnroll * stride;
    }
    for (; t < n_t; ++t) {
        h = __fadd_rn(__fmul_rn(to_f32(a[off]), h), to_f32(b[off]));
        out[off] = from_f32<T>(h);
        off += stride;
    }
    hT[ch] = from_f32<T>(h);
}

template <typename T>
__global__ void linear_scan_bwd_kernel(const T* __restrict__ a,
                                       const T* __restrict__ h,
                                       const float* __restrict__ h0,   // or nullptr
                                       const T* __restrict__ gh,
                                       const float* __restrict__ ghT,  // or nullptr
                                       int n_batch, int n_t, int n_d,
                                       T* __restrict__ da,
                                       T* __restrict__ db,
                                       float* __restrict__ dh0) {      // or nullptr
    const int64_t ch = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (ch >= static_cast<int64_t>(n_batch) * n_d) return;
    const int64_t bi = ch / n_d;
    const int64_t d = ch - bi * n_d;
    const int64_t stride = n_d;
    const int64_t base = bi * static_cast<int64_t>(n_t) * n_d + d;
    const float h_first = h0 != nullptr ? h0[ch] : 0.0f;  // h[b, -1, d]

    float c = ghT != nullptr ? ghT[ch] : 0.0f;
    int t = n_t;  // timesteps t .. n_t-1 are done
    for (; t - kUnroll >= 0; t -= kUnroll) {
        // timesteps t-kUnroll .. t-1, loaded before the chain runs
        const int64_t off = base + static_cast<int64_t>(t - kUnroll) * stride;
        float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            av[u] = to_f32(a[off + u * stride]);
            gv[u] = to_f32(gh[off + u * stride]);
            hv[u] = (t - kUnroll + u == 0) ? h_first
                                            : to_f32(h[off + (u - 1) * stride]);
        }
#pragma unroll
        for (int u = kUnroll - 1; u >= 0; --u) {
            const float g = __fadd_rn(gv[u], c);
            db[off + u * stride] = from_f32<T>(g);
            da[off + u * stride] = from_f32<T>(__fmul_rn(g, hv[u]));
            c = __fmul_rn(av[u], g);
        }
    }
    for (--t; t >= 0; --t) {
        const int64_t off = base + static_cast<int64_t>(t) * stride;
        const float hp = t == 0 ? h_first : to_f32(h[off - stride]);
        const float g = __fadd_rn(to_f32(gh[off]), c);
        db[off] = from_f32<T>(g);
        da[off] = from_f32<T>(__fmul_rn(g, hp));
        c = __fmul_rn(to_f32(a[off]), g);
    }
    if (dh0 != nullptr) dh0[ch] = c;
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, int n_batch,
           int n_t, int n_d, void* out, void* hT, void* stream) {
    const int64_t channels = static_cast<int64_t>(n_batch) * n_d;
    if (channels <= 0) return 0;
    const int64_t blocks = (channels + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    linear_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), h0, n_batch, n_t,
        n_d, static_cast<T*>(out), static_cast<T*>(hT));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* a, const void* h, const float* h0, const void* gh,
               const float* ghT, int n_batch, int n_t, int n_d, void* da,
               void* db, float* dh0, void* stream) {
    const int64_t channels = static_cast<int64_t>(n_batch) * n_d;
    if (channels <= 0) return 0;
    const int64_t blocks = (channels + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    linear_scan_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(h), h0,
        static_cast<const T*>(gh), ghT, n_batch, n_t, n_d, static_cast<T*>(da),
        static_cast<T*>(db), dh0);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b, out and hT share it; h0 is f32).
// Launches on the caller's stream without synchronising and returns
// cudaGetLastError().
int linear_scan_launch(const void* a, const void* b, const float* h0,
                       int n_batch, int n_t, int n_d, int dtype, void* out,
                       void* hT, void* stream) {
    if (dtype == 0)
        return launch<float>(a, b, h0, n_batch, n_t, n_d, out, hT, stream);
    if (dtype == 1)
        return launch<__nv_bfloat16>(a, b, h0, n_batch, n_t, n_d, out, hT, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of linear_scan_launch.  dtype as there: a, h, gh, da and db
// share it; h0, ghT and dh0 are f32, and each may be null (no h0: the
// forward started from 0; no ghT: h_T's cotangent is 0; no dh0: not
// wanted).  Launches on the caller's stream and returns cudaGetLastError().
int linear_scan_bwd_launch(const void* a, const void* h, const float* h0,
                           const void* gh, const float* ghT, int n_batch,
                           int n_t, int n_d, int dtype, void* da, void* db,
                           float* dh0, void* stream) {
    if (dtype == 0)
        return launch_bwd<float>(a, h, h0, gh, ghT, n_batch, n_t, n_d, da, db,
                                 dh0, stream);
    if (dtype == 1)
        return launch_bwd<__nv_bfloat16>(a, h, h0, gh, ghT, n_batch, n_t, n_d,
                                         da, db, dh0, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
