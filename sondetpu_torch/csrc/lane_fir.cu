// 41-tap FIR in the lane experiment's form: y[m] = sum_t x[m + t] * h[t],
// t ascending, the first product not added to zero.
//
// Replaces tools/exp_chanfilt.py:lane_fir (its local Pallas `kernel`), the
// experiment that held a lane-shift FIR against XLA's depthwise conv and
// was kept as a negative result.
//
// What bounds it: shared-memory loads. At [2048, 192000] the input read and
// the output write are 3.1 GB, ~0.9 ms at 3.35 TB/s, but the 41 shared
// loads per output (1.6e10) take ~2.2 ms at ~7.4e12 loads/s. Design: one
// thread block per (channel, tile of TILE outputs), the tile's
// TILE + T - 1 inputs staged in shared memory once, neighbouring threads
// on neighbouring outputs; the taps ride in the parameter space. The TPU
// kernel's 128-lane halo block and channel padding have no counterpart.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order of the plain twin
// (sondetpu_torch/kernels/lane_fir.py:lane_fir_plain): the two agree bit
// for bit.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) lane_fir_kernel(
    const float* __restrict__ x, const Taps h, const int T, const int ln,
    float* __restrict__ y) {
    __shared__ float xs[TILE + SONDETPU_MAX_TAPS - 1];
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int n = ln - T + 1;
    const float* row = x + (size_t)c * ln;
    for (int j = threadIdx.x; j < TILE + T - 1; j += THREADS) {
        const int g = g0 + j;
        xs[j] = g < ln ? row[g] : 0.0f;      // past the row: feeds no output
    }
    __syncthreads();
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
        const int m = g0 + t;
        if (m >= n) break;
        const float* p = xs + t;
        float acc = __fmul_rn(p[0], h.h[0]);
        for (int k = 1; k < T; ++k)
            acc = __fadd_rn(acc, __fmul_rn(p[k], h.h[k]));
        y[(size_t)c * n + m] = acc;
    }
}

}  // namespace

// x [C, ln]; h: host array of T taps; y [C, ln - T + 1].
SONDETPU_API int sondetpu_lane_fir(const float* x, const float* h, int T,
                                   int C, int ln, float* y, void* stream) {
    if (T < 1 || T > SONDETPU_MAX_TAPS || C < 1 || ln < T)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    for (int k = 0; k < T; ++k) th.h[k] = h[k];
    const dim3 grid((ln - T + 1 + TILE - 1) / TILE, C);
    lane_fir_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, th, T, ln,
                                                                 y);
    return (int)cudaGetLastError();
}
