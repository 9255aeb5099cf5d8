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
//
// The second entry, sondetpu_plain_corr, is the plain syncword correlation
// (sondetpu_torch/sync/correlator.py:correlate_syncword, the correlation of
// every route but the fused front end's) on the same design:
// corr[c, i] = (sum_k t[k] * x[c, i + k]) / L, t[k] in ascending k from a
// zero accumulator, every product and sum rounded alone, then divided by
// L correctly rounded: dsp/fir.py:conv1d's order and rounding, and the
// division by a 0-d L tensor (not a multiply by 1/L, which is K2's). Tap
// 0 adds its product to +0 (__fadd_rn(0, p)), as conv1d's zeros += p
// does, so a -0 product gives +0. Its rows are float32 or bfloat16, with a
// row stride of their own (a view of a wider buffer); a bfloat16 row is
// widened on its way into shared memory, exactly. The taps ride in the
// launch (up to CORR_MAX_TAPS, a bound of this entry's own), so no copy to
// the card precedes it; m10's two template lengths, L = 80 and 64, are
// compiled in, any other L takes the run-time body.
//
// What bounds it: at m10's fleet ring [614, 40044] (L = 80) the products
// and sums are 2L = 160 operations per output (3.9e9, 0.12 ms at the FP32
// rate) and the division ~10 more; a bfloat16 row read and the float32
// result written are 0.15 GB, 0.05 ms at 3.35 TB/s.
//
// The third entry, sondetpu_plain_fir, is the plain-op front end's filter
// (sondetpu_torch/dsp/fir.py:apply_windows on a CUDA tensor: the channel
// filter at stride decim, the matched filter, the AFSK and dual-tone
// boxcars), which no TPU kernel implements: the original runs it as a jnp
// conv. y[c, m] = sum_u h[u] * x[c, D*m + T - 1 - u], u ascending from a
// +0 accumulator (tap 0 is __fadd_rn(0, p), as window_sum's zeros += p),
// every product and sum rounded alone: dsp/fir.py:window_sum's order and
// rounding, and K1's channel filter's (csrc/frontend.cu, stage 1), which
// this entry's design follows. A thread takes R consecutive outputs (R =
// 15 at D = 1, K1's 9 at D = 2) and slides a register window of D*(R-1)+1
// inputs down the taps (slide_window in common.cuh), one shared load per
// tap; the tile and its D*(SPAN - 1) + T window are staged by
// stage_row (float32 or bfloat16 rows, a row stride of their own); the
// store goes through shared memory. T = 41 at D = 1 and 2 (RS41's matched
// and channel filters) is compiled in; any other T, or a stride of 3 or
// more (one output a thread from the cache), runs at run time. The taps
// ride in the launch, so nothing is copied to the card; a launch holds 256,
// and more taps chain launches, each going on from the sums left in y.
//
// What bounds it: at RS41's channel filter, [2048, 192040] at D = 2 with
// 41 taps, the 1.97e8 outputs of 82 operations are 1.6e10 (0.48 ms at the
// FP32 rate); the row read and the output written are 2.36 GB, 0.70 ms at
// 3.35 TB/s. The matched filter, [2048, 96040] at D = 1: 1.6e10 operations
// (0.48 ms) and 1.57 GB (0.47 ms).
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

// ---- the plain syncword correlation --------------------------------------

namespace {

constexpr int CORR_MAX_TAPS = 256;   // this entry's own tap bound
constexpr int CORR_NX = SPAN + CORR_MAX_TAPS;

// The template in the parameter space (1 KB of the launch's 4 KB).
struct CorrTaps {
    float h[CORR_MAX_TAPS];
};

// xs[0 .. nx) = row[m0 .. m0 + nx), zeros past ln, nx <= NX. float32 rows
// by cp.async, 16 bytes a copy where vec (row stride % 4 == 0 and x aligned
// to 16 bytes) and the chunk lies inside the row, else 4.
template <int NX>
static __device__ __forceinline__ void stage_row(float* xs, const float* row,
                                                 const int m0, const int nx,
                                                 const int ln,
                                                 const bool vec) {
    if (vec) {
        for (int j = 4 * threadIdx.x; j < nx; j += 4 * THREADS) {
            const int g = m0 + j;
            if (g + 4 <= ln) {
                cp_async_f32x4(xs + j, row + g, true);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    cp_async_f32(xs + j + e, row + (g + e < ln ? g + e : 0),
                                 g + e < ln);
            }
        }
    } else {
        for (int j = threadIdx.x; j < nx; j += THREADS) {
            const int g = m0 + j;
            cp_async_f32(xs + j, row + (g < ln ? g : 0), g < ln);
        }
    }
    cp_async_wait_all();
}

// The same for bfloat16 rows: every load of a thread issued before its
// first store, each value widened on its store to shared memory; 8 bytes
// a load where vec (row stride % 4 == 0 and x aligned to 8 bytes), else 2.
template <int NX>
static __device__ __forceinline__ void stage_row(float* xs,
                                                 const __nv_bfloat16* row,
                                                 const int m0, const int nx,
                                                 const int ln,
                                                 const bool vec) {
    if (vec) {
        constexpr int K = (NX + 4 * THREADS - 1) / (4 * THREADS);
        Bf16Word<4> w[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = 4 * (threadIdx.x + k * THREADS);
            const int g = m0 + j;
            w[k] = load_bf16<4>(row + (g + 4 <= ln ? g : 0),
                                j < nx && g + 4 <= ln);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = 4 * (threadIdx.x + k * THREADS);
            const int g = m0 + j;
            if (j >= nx) break;
            store_widened<4>(xs + j, w[k]);
            if (g + 4 > ln) {    // the chunk the row's end cuts: by value
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    store_widened<1>(xs + j + e,
                                     load_bf16<1>(row + (g + e < ln ? g + e
                                                                    : 0),
                                                  g + e < ln));
            }
        }
    } else {
        constexpr int K = (NX + THREADS - 1) / THREADS;
        Bf16Word<1> w[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = threadIdx.x + k * THREADS;
            const int g = m0 + j;
            w[k] = load_bf16<1>(row + (g < ln ? g : 0), j < nx && g < ln);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = threadIdx.x + k * THREADS;
            if (j < nx) store_widened<1>(xs + j, w[k]);
        }
    }
}

template <int TT, typename E>
__global__ void __launch_bounds__(THREADS, 4) plain_corr_kernel(
    const E* __restrict__ x, const CorrTaps h, const int t_run,
    const int ln, const long long ld, const bool vec,
    float* __restrict__ y) {
    __shared__ __align__(16) float xs[CORR_NX];  // [SPAN + T - 1]
    const int T = TT > 0 ? TT : t_run;
    const int c = blockIdx.y;
    const int m0 = blockIdx.x * SPAN;
    const int n = ln - T + 1;
    stage_row<CORR_NX>(xs, x + (size_t)c * ld, m0, SPAN + T - 1, ln, vec);
    __syncthreads();

    // acc_r = sum_u h[u] * xs[t0 + r + u] from +0, r < R
    const int t0 = threadIdx.x * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    slide_window_up<R, TT>(xs + t0, T, [&](int u, int r, float v) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(h.h[u], v));
    });
    __syncthreads();                             // every window read
    const float l = (float)T;
#pragma unroll
    for (int r = 0; r < R; ++r) xs[t0 + r] = __fdiv_rn(acc[r], l);
    __syncthreads();
    float* orow = y + (size_t)c * n + m0;
    for (int j = threadIdx.x; j < SPAN && m0 + j < n; j += THREADS)
        orow[j] = xs[j];
}

template <int TT, typename E>
int launch_corr(const E* x, const CorrTaps& h, int T, int C, int ln,
                long long ld, float* y, cudaStream_t stream) {
    const int n = ln - T + 1;
    const bool vec = ld % 4 == 0 &&
                     (sizeof(E) == 4 ? aligned16(x)
                                     : (reinterpret_cast<uintptr_t>(x) & 7) ==
                                           0);
    // the grid's rows in runs of 65535
    for (int c0 = 0; c0 < C; c0 += 65535) {
        const int rows = C - c0 < 65535 ? C - c0 : 65535;
        const dim3 grid((n + SPAN - 1) / SPAN, rows);
        plain_corr_kernel<TT, E><<<grid, THREADS, 0, stream>>>(
            x + (size_t)c0 * ld, h, T, ln, ld, vec, y + (size_t)c0 * n);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return 0;
}

template <typename E>
int dispatch_corr(const E* x, const CorrTaps& h, int T, int C, int ln,
                  long long ld, float* y, cudaStream_t s) {
    if (T == 80) return launch_corr<80, E>(x, h, T, C, ln, ld, y, s);
    if (T == 64) return launch_corr<64, E>(x, h, T, C, ln, ld, y, s);
    return launch_corr<0, E>(x, h, T, C, ln, ld, y, s);
}

}  // namespace

// x [C, ln] with row stride ld elements (float32, or bfloat16 with bf16
// set); t: host array of T template taps (T <= 256, each already rounded
// to bfloat16 for bfloat16 rows, as the plain correlation takes them);
// y [C, ln - T + 1] float32, contiguous. T = 80 and 64 run compile-time
// bodies, any other T the run-time one.
SONDETPU_API int sondetpu_plain_corr(const void* x, int bf16, const float* t,
                                     int T, int C, int ln, long long ld,
                                     float* y, void* stream) {
    if (T < 1 || T > CORR_MAX_TAPS || C < 1 || ln < T || ld < 0 ||
        (C > 1 && ld < ln))
        return (int)cudaErrorInvalidValue;
    CorrTaps th{};
    for (int k = 0; k < T; ++k) th.h[k] = t[k];
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch_corr(static_cast<const __nv_bfloat16*>(x), th, T, C,
                             ln, ld, y, s);
    return dispatch_corr(static_cast<const float*>(x), th, T, C, ln, ld, y, s);
}

// ---- the plain-op front end's filter -------------------------------------

namespace {

constexpr int FIR_CHUNK_TAPS = 256;  // taps a launch holds; more chain

// The taps of one launch in the parameter space (1 KB of the launch's 4 KB).
struct FirTaps {
    float h[FIR_CHUNK_TAPS];
};

// Outputs per thread: R (lane_fir's) at stride 1; 9 at stride 2, as K1's
// decim-2 channel filter, whose register window is 2 * (9 - 1) + 1 = 17.
template <int D>
__host__ __device__ constexpr int fir_r() {
    return D == 1 ? R : 9;
}
// The staged window's bound, a multiple of 4 (the 16- and 8-byte staging
// writes whole chunks of 4).
template <int D>
__host__ __device__ constexpr int fir_nx() {
    return (D * (fir_r<D>() * THREADS - 1) + FIR_CHUNK_TAPS + 3) / 4 * 4;
}

// y[c, m] (+)= sum_u h[u] * x[c, D*m + T - 1 - u], u ascending, m < n; with
// chain the sum goes on from the y a launch before left (the taps before
// these), else from +0.
template <int TT, int D, typename E>
__global__ void __launch_bounds__(THREADS, 4) plain_fir_kernel(
    const E* __restrict__ x, const FirTaps h, const int t_run, const int ln,
    const long long ld, const int n, const bool vec, const bool chain,
    float* __restrict__ y) {
    constexpr int RD = fir_r<D>();
    constexpr int SPAN_D = RD * THREADS;
    constexpr int NX = fir_nx<D>();
    __shared__ __align__(16) float xs[NX];   // x[D*m0 .. D*m0 + nx)
    const int T = TT > 0 ? TT : t_run;
    const int c = blockIdx.y;
    const int m0 = blockIdx.x * SPAN_D;
    stage_row<NX>(xs, x + (size_t)c * ld, D * m0, D * (SPAN_D - 1) + T, ln,
                  vec);
    __syncthreads();

    // y[m0 + t0 + r] from xs[D*(t0 + r) + T - 1 - u], r < RD
    const int t0 = threadIdx.x * RD;
    float* orow = y + (size_t)c * n + m0;
    float acc[RD];
#pragma unroll
    for (int r = 0; r < RD; ++r)
        acc[r] = chain && m0 + t0 + r < n ? orow[t0 + r] : 0.0f;
    slide_window<RD, D, TT>(xs + D * t0 + T - 1, T,
                            [&](int u, int r, float v) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(h.h[u], v));
    });
    __syncthreads();                             // every window read
#pragma unroll
    for (int r = 0; r < RD; ++r) xs[t0 + r] = acc[r];
    __syncthreads();
    for (int j = threadIdx.x; j < SPAN_D && m0 + j < n; j += THREADS)
        orow[j] = xs[j];
}

// Any other stride: one output a thread, its window read from device
// memory through the cache (no path of the pipeline strides by more than
// 2).
template <typename E>
__global__ void __launch_bounds__(THREADS) plain_fir_strided_kernel(
    const E* __restrict__ x, const FirTaps h, const int T, const int D,
    const long long ld, const int n, const bool chain,
    float* __restrict__ y) {
    const int m = blockIdx.x * THREADS + threadIdx.x;
    if (m >= n) return;
    const E* p = x + (size_t)blockIdx.y * ld + (size_t)m * D + T - 1;
    float* out = y + (size_t)blockIdx.y * n + m;
    float acc = chain ? *out : 0.0f;
#pragma unroll 1
    for (int u = 0; u < T; ++u)
        acc = __fadd_rn(acc, __fmul_rn(h.h[u], to_f32(p[-u])));
    *out = acc;
}

template <typename E>
int launch_fir(const E* x, const FirTaps& h, int T, int D, int C, int ln,
               long long ld, int n, bool chain, float* y,
               cudaStream_t stream) {
    const bool vec = ld % 4 == 0 &&
                     (sizeof(E) == 4 ? aligned16(x)
                                     : (reinterpret_cast<uintptr_t>(x) & 7) ==
                                           0);
    const bool t41 = T == 41;
    // the grid's rows in runs of 65535
    for (int c0 = 0; c0 < C; c0 += 65535) {
        const int rows = C - c0 < 65535 ? C - c0 : 65535;
        const E* xr = x + (size_t)c0 * ld;
        float* yr = y + (size_t)c0 * n;
        if (D == 1 || D == 2) {
            const int span = (D == 1 ? fir_r<1>() : fir_r<2>()) * THREADS;
            const dim3 grid((n + span - 1) / span, rows);
            if (D == 2 && t41)
                plain_fir_kernel<41, 2, E><<<grid, THREADS, 0, stream>>>(
                    xr, h, T, ln, ld, n, vec, chain, yr);
            else if (D == 2)
                plain_fir_kernel<0, 2, E><<<grid, THREADS, 0, stream>>>(
                    xr, h, T, ln, ld, n, vec, chain, yr);
            else if (t41)
                plain_fir_kernel<41, 1, E><<<grid, THREADS, 0, stream>>>(
                    xr, h, T, ln, ld, n, vec, chain, yr);
            else
                plain_fir_kernel<0, 1, E><<<grid, THREADS, 0, stream>>>(
                    xr, h, T, ln, ld, n, vec, chain, yr);
        } else {
            const dim3 grid((n + THREADS - 1) / THREADS, rows);
            plain_fir_strided_kernel<E><<<grid, THREADS, 0, stream>>>(
                xr, h, T, D, ld, n, chain, yr);
        }
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    return 0;
}

template <typename E>
int chain_fir(const E* x, const float* h, int T, int D, int C, int ln,
              long long ld, float* y, cudaStream_t s) {
    const int n = (ln - T) / D + 1;
    // taps [u0, u0 + tk) read x from element T - u0 - tk of each row on
    for (int u0 = 0; u0 < T; u0 += FIR_CHUNK_TAPS) {
        const int tk = T - u0 < FIR_CHUNK_TAPS ? T - u0 : FIR_CHUNK_TAPS;
        FirTaps th{};
        for (int k = 0; k < tk; ++k) th.h[k] = h[u0 + k];
        const int off = T - u0 - tk;
        const int err = launch_fir(x + off, th, tk, D, C, ln - off, ld, n,
                                   u0 > 0, y, s);
        if (err != 0) return err;
    }
    return 0;
}

}  // namespace

// x [C, ln] with row stride ld elements (float32, or bfloat16 with bf16
// set); h: host array of T taps (each already rounded to bfloat16 for
// bfloat16 rows, as the plain filter takes them); stride D >= 1;
// y [C, (ln - T) / D + 1] float32, contiguous. T = 41 at D = 1 and 2 runs
// compile-time bodies, any other T or D run-time ones; more than 256 taps
// take one launch per 256 (a launch's taps ride in its parameters), each
// going on from the sums the one before left.
SONDETPU_API int sondetpu_plain_fir(const void* x, int bf16, const float* h,
                                    int T, int D, int C, int ln,
                                    long long ld, float* y, void* stream) {
    if (T < 1 || D < 1 || C < 1 || ln < T || ld < 0 || (C > 1 && ld < ln))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return chain_fir(static_cast<const __nv_bfloat16*>(x), h, T, D, C, ln,
                         ld, y, s);
    return chain_fir(static_cast<const float*>(x), h, T, D, C, ln, ld, y, s);
}
