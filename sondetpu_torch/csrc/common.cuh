// Shared definitions of the sondetpu_torch CUDA kernels.
//
// Every entry point is a plain C function: it launches on the stream it is
// given (PyTorch's current stream), does not synchronise, allocates
// nothing, and returns cudaGetLastError() right after the launch so that a
// refused launch reaches the Python wrapper, which raises.
#pragma once

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
