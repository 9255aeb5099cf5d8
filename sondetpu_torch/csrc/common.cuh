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
