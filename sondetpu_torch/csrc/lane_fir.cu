// FIR in the lane experiment's form: y[m] = sum_t x[m + t] * h[t], t
// ascending, the first product not added to zero.
//
// Replaces tools/exp_chanfilt.py:lane_fir (its local Pallas `kernel`), the
// experiment that held a lane-shift FIR against XLA's depthwise conv and
// was kept as a negative result.
//
// What bounds it: at [2048, 192000] with 41 taps the products and sums,
// each rounded alone, are 81 operations per output (3.19e10, 0.95 ms at
// the FP32 rate); the input read and the output written are 3.1 GB,
// 0.94 ms at 3.35 TB/s.
//
// Design (K2's separately rounded body, csrc/corr.cu, without its 1/L
// scale): one thread block per (channel, tile of SPAN = R x THREADS
// outputs). The tile and its T - 1 halo are staged in shared memory with
// cp.async, 16 bytes a copy where the rows allow it. Each thread takes R
// consecutive outputs and slides a window of R inputs up the taps
// (slide_window_up in common.cuh): one shared load per tap feeds R
// outputs, and with T = 41 compiled in every tap h[u] is an immediate
// constant-bank operand; any other T <= 64 takes a body with T at run
// time. R is odd, so threads at stride R read 32 distinct banks; the
// outputs go back through shared memory so the global store is coalesced.
//
// Exactness: tap 0 sets acc = x * h[0] (not 0 + x * h[0], which differs in
// the sign of a zero) and every later tap adds its product, each rounded
// alone (__fmul_rn/__fadd_rn, no FMA contraction), in the order of the
// plain twin (sondetpu_torch/kernels/lane_fir.py:lane_fir_plain): the two
// agree bit for bit.
#include "common.cuh"

#ifndef SONDETPU_LANE_FIR_R
#define SONDETPU_LANE_FIR_R 15
#endif

namespace {

constexpr int R = SONDETPU_LANE_FIR_R;           // outputs per thread
constexpr int THREADS = 256;
constexpr int SPAN = R * THREADS;                // outputs per block
constexpr int T_FIXED = 41;                      // the experiment's taps

template <int TT>
__global__ void __launch_bounds__(THREADS, 4) lane_fir_kernel(
    const float* __restrict__ x, const Taps h, const int t_run,
    const int ln, const bool vec, float* __restrict__ y) {
    // [SPAN + T - 1, up to 4]
    __shared__ __align__(16) float xs[SPAN + SONDETPU_MAX_TAPS];
    const int T = TT > 0 ? TT : t_run;
    const int c = blockIdx.y;
    const int m0 = blockIdx.x * SPAN;
    const int n = ln - T + 1;
    const int nx = SPAN + T - 1;
    const float* row = x + (size_t)c * ln;
    if (vec) {          // ln % 4 == 0 and x aligned: whole chunks
        for (int j = 4 * threadIdx.x; j < nx; j += 4 * THREADS) {
            const int g = m0 + j;
            cp_async_f32x4(xs + j, row + (g < ln ? g : 0), g < ln);
        }
    } else {
        for (int j = threadIdx.x; j < nx; j += THREADS) {
            const int g = m0 + j;
            cp_async_f32(xs + j, row + (g < ln ? g : 0), g < ln);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // y[m0 + t0 + r] = sum_u h[u] * xs[t0 + r + u], r < R
    const int t0 = threadIdx.x * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;   // every value set at tap 0
    slide_window_up<R, TT>(xs + t0, T, [&](int u, int r, float v) {
        const float p = __fmul_rn(v, h.h[u]);
        acc[r] = u == 0 ? p : __fadd_rn(acc[r], p);
    });
    __syncthreads();                             // every window read
#pragma unroll
    for (int r = 0; r < R; ++r) xs[t0 + r] = acc[r];
    __syncthreads();
    float* orow = y + (size_t)c * n + m0;
    for (int j = threadIdx.x; j < SPAN && m0 + j < n; j += THREADS)
        orow[j] = xs[j];
}

template <int TT>
int launch(const float* x, const Taps& h, int T, int C, int ln, float* y,
           cudaStream_t stream) {
    const dim3 grid((ln - T + 1 + SPAN - 1) / SPAN, C);
    const bool vec = ln % 4 == 0 && aligned16(x);
    lane_fir_kernel<TT><<<grid, THREADS, 0, stream>>>(x, h, T, ln, vec, y);
    return (int)cudaGetLastError();
}

}  // namespace

// x [C, ln]; h: host array of T taps (T <= 64); y [C, ln - T + 1].
// T = 41 runs the compile-time body, any other T the run-time one.
SONDETPU_API int sondetpu_lane_fir(const float* x, const float* h, int T,
                                   int C, int ln, float* y, void* stream) {
    if (T < 1 || T > SONDETPU_MAX_TAPS || C < 1 || C > 65535 || ln < T)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    for (int k = 0; k < T; ++k) th.h[k] = h[k];
    cudaStream_t s = (cudaStream_t)stream;
    if (T == T_FIXED) return launch<T_FIXED>(x, th, T, C, ln, y, s);
    return launch<0>(x, th, T, C, ln, y, s);
}
