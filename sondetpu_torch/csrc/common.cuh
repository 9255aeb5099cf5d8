// Shared definitions of the sondetpu_torch CUDA kernels.
//
// Every entry point is a plain C function: it launches on the stream it is
// given (PyTorch's current stream), does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch so that a
// refused launch reaches the Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SONDETPU_API extern "C" __attribute__((visibility("default")))

// Taps ride in the kernel's parameter space (the constant bank): every
// thread of a warp reads the same tap at the same time, which the constant
// cache serves as one broadcast.
#define SONDETPU_MAX_TAPS 64

struct Taps {
    float h[SONDETPU_MAX_TAPS];
};

// Asynchronous 4-byte copy from device to shared memory (cp.async): a
// thread issues all of its copies without waiting for any, so a tile's
// staging costs one memory latency, not one per element. With valid false
// nothing is read and the word is zero-filled (src must still be a valid
// address). cp_async_wait_all waits for this thread's copies; a
// __syncthreads() after it publishes them to the block.
static __device__ __forceinline__ void cp_async_f32(float* dst,
                                                    const float* src,
                                                    const bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// The same for 16 bytes (four floats): dst and src 16-byte aligned; with
// valid false the four words are zero-filled. .cg: cached in L2 only.
static __device__ __forceinline__ void cp_async_f32x4(float* dst,
                                                      const float* src,
                                                      const bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

static __host__ __device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Input element types of the kernels that read float32 or bfloat16
// planes: a bfloat16 value widens to float32 exactly, so a kernel that
// widens on the load and computes in float32 gives on bfloat16 input x
// bit for bit what it gives on x.float().
static __device__ __forceinline__ float to_f32(const float x) { return x; }
static __device__ __forceinline__ float to_f32(const __nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T>
static __device__ __forceinline__ T from_f32(const float x);
template <>
__device__ __forceinline__ float from_f32<float>(const float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    const float x) {
    return __float2bfloat16_rn(x);
}
// lo and hi each rounded to the nearest bfloat16 (ties to even) by one
// paired conversion, as a word (lo in the low half)
static __device__ __forceinline__ unsigned pack_bf16x2(const float lo,
                                                       const float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}

// A word of V = 1 or 4 bfloat16 values, loaded raw (2 or 8 bytes) and
// widened to float32 on its store to shared memory. A kernel that stages
// bfloat16 planes issues a batch of these loads before their stores, where
// one load and its store at a time would wait out every load's latency
// (float32 planes stage by cp.async, which does not wait).
template <int V>
struct Bf16Word;
template <>
struct Bf16Word<1> {
    unsigned short v;
};
template <>
struct Bf16Word<4> {
    uint2 v;
};

// the word at src (aligned to V values), or zeros when valid is false
// (then nothing is read)
template <int V>
static __device__ __forceinline__ Bf16Word<V> load_bf16(
    const __nv_bfloat16* src, const bool valid) {
    Bf16Word<V> w{};
    if (valid) {
        if constexpr (V == 4)
            w.v = *reinterpret_cast<const uint2*>(src);
        else
            w.v = *reinterpret_cast<const unsigned short*>(src);
    }
    return w;
}

// dst[0 .. V) = the word's values as floats (dst 16-byte aligned for V = 4)
template <int V>
static __device__ __forceinline__ void store_widened(float* dst,
                                                     const Bf16Word<V> w) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            __uint_as_float(w.v.x << 16), __uint_as_float(w.v.x & 0xffff0000u),
            __uint_as_float(w.v.y << 16),
            __uint_as_float(w.v.y & 0xffff0000u));
    } else {
        *dst = __uint_as_float((unsigned)w.v << 16);
    }
}

static __device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

// Register blocking of a tap loop over shared memory (K1 and K8). Output
// r < NR of a thread reads p[D*r - u] at tap u = 0 .. T-1, and
// step(u, r, value) folds that value into output r, taps in ascending
// order. From one tap to the next every read moves down one element, so a
// window of D*(NR-1)+1 registers slides by one: one shared load per tap
// feeds NR outputs. With TT > 0 the tap loop is unrolled at compile time,
// the slide is register renaming, and a tap h[u] of the parameter space is
// an immediate constant-bank operand. With TT == 0 the count T comes at run
// time and the slide costs register moves. p[-(T-1)] .. p[D*(NR-1)] must
// lie in shared memory.
template <int NR, int D, int TT, typename Step>
static __device__ __forceinline__ void slide_window(
    const float* __restrict__ p, const int T, Step step) {
    constexpr int W = D * (NR - 1) + 1;
    float w[W];
#pragma unroll
    for (int j = 0; j < W; ++j) w[j] = p[j];
    auto tap = [&](const int u) {
        if (u > 0) {
#pragma unroll
            for (int j = W - 1; j > 0; --j) w[j] = w[j - 1];
            w[0] = p[-u];
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) step(u, r, w[D * r]);
    };
    if constexpr (TT > 0) {
#pragma unroll
        for (int u = 0; u < TT; ++u) tap(u);
    } else {
#pragma unroll 1
        for (int u = 0; u < T; ++u) tap(u);
    }
}

// The forward twin of slide_window (K2): output r < NR reads p[r + u] at
// tap u = 0 .. T-1, taps in ascending order. From one tap to the next every
// read moves up one element, so a window of NR registers slides by one: one
// shared load per tap feeds NR outputs. TT > 0 unrolls the taps (the slide
// is renaming, h[u] an immediate operand); TT == 0 takes T at run time.
// p[0] .. p[T - 1 + NR - 1] must lie in shared memory.
template <int NR, int TT, typename Step>
static __device__ __forceinline__ void slide_window_up(
    const float* __restrict__ p, const int T, Step step) {
    float w[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) w[j] = p[j];
    auto tap = [&](const int u) {
        if (u > 0) {
#pragma unroll
            for (int j = 0; j < NR - 1; ++j) w[j] = w[j + 1];
            w[NR - 1] = p[u + NR - 1];
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) step(u, r, w[r]);
    };
    if constexpr (TT > 0) {
#pragma unroll
        for (int u = 0; u < TT; ++u) tap(u);
    } else {
#pragma unroll 1
        for (int u = 0; u < T; ++u) tap(u);
    }
}

// Octant reduction + odd minimax polynomial, exactly as
// sondetpu/pallas/frontend.py:fast_atan2 (max error ~1e-6 rad).
static __device__ __forceinline__ float fast_atan2(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float den = fmaxf(ax, ay), num = fminf(ax, ay);
    const float z = __fdiv_rn(num, fmaxf(den, 1e-30f));
    const float z2 = __fmul_rn(z, z);
    float p = -0.01172120f;
    p = __fadd_rn(0.05265332f, __fmul_rn(z2, p));
    p = __fadd_rn(-0.11643287f, __fmul_rn(z2, p));
    p = __fadd_rn(0.19354346f, __fmul_rn(z2, p));
    p = __fadd_rn(-0.33262347f, __fmul_rn(z2, p));
    p = __fadd_rn(0.99997726f, __fmul_rn(z2, p));
    p = __fmul_rn(z, p);
    if (ay > ax) p = __fsub_rn(1.57079632679489662f, p);
    if (x < 0.0f) p = __fsub_rn(3.14159265358979324f, p);
    return y < 0.0f ? -p : p;
}
