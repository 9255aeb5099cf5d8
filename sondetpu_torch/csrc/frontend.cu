// Fused RS41 front end: channel filter (with decimation) -> FM quadrature
// discriminator -> matched FIR, plus per-tile sums of the discriminator
// audio for the block DC.
//
// Replaces sondetpu/pallas/frontend.py:fused_frontend (bodies
// _frontend_kernel_d2 for decim 2 and _frontend_kernel for decim 1).
//
// On the virtual stream x = concat(tail, block), negative indices reading
// the carried raw tail, for every processing-rate index g of the block:
//   cf[g]    = sum_u hc[u] * x[D*g - u]                  (I and Q planes)
//   audio[g] = fast_atan2(cf_q[g]cf_i[g-1] - cf_i[g]cf_q[g-1],
//                         cf_i[g]cf_i[g-1] + cf_q[g]cf_q[g-1]) * scale
//   filt[g]  = sum_u hm[u] * audio[g - u]
// and partial[c, tile] = sum of audio[g] over the tile's g < n/D. The
// wrapper turns the partials into the block DC and subtracts it.
//
// What bounds it: the FP32 issue rate. Every product and sum is rounded on
// its own (__fmul_rn/__fadd_rn, no FMA contraction) in the order of the
// plain twin (sondetpu_torch/kernels/frontend.py:fused_frontend_plain), so
// a multiply-add is two instructions and tensor cores cannot hold the
// twin's rounding. Per output: the channel filter 2 planes x 41 taps x 2,
// the discriminator ~35 (with an IEEE division), the matched FIR 41 x 2:
// ~285 instructions. At [2048, 192000] decim 2 that is 5.6e10, ~1.9 ms at
// 132 SMs x 128 lanes x ~1.75 GHz (chip_smoke.py's bound, at the published
// 67 TFLOP/s, counts 1.6 ms); decim 1 with identity matched taps skips the
// FIR, ~200 per output x 3.9e8, ~2.7 ms (2.2). Device memory is below that:
// the planes in and filt out are 3.9 GB (decim 2) and 4.7 GB (decim 1),
// 1.2 and 1.4 ms at 3.35 TB/s.
//
// Design: one thread block per (channel, tile of TILE outputs). The tile's
// input window is staged in shared memory once (coalesced, plus a
// (D+1)*T halo), then three stages run over it:
//  1. channel filter: each thread takes R consecutive cf outputs and slides
//     a register window of D*(R-1)+1 inputs per plane (slide_window in
//     common.cuh): one shared load per tap for R outputs, and with T = 41
//     known at compile time each tap is an immediate constant-bank operand
//     of its FMUL (no LDC). Other T take a body with T at run time.
//  2. discriminator: one thread per output, cf read from shared memory;
//     audio overwrites the input window.
//  3. matched FIR: R consecutive outputs per thread, as in stage 1; results
//     go through shared memory so the global store is coalesced. When the
//     host finds the matched taps are exactly [0, ..., 0, 1] (the AFSK
//     path), sum_u hm[u] * audio[g - u] = audio[g - T + 1] exactly for
//     finite audio, so the identity body writes the delayed audio from
//     stage 2 and skips stage 3 and its 41 multiply-adds per output.
// R = 9 measured faster than 7 and as fast as 11 at [2048, 192000] (11
// runs at the 64-register cap). R is odd, so threads reading at stride R
// hit 32 distinct banks; the decim-2 channel filter reads at stride 2R, a
// 2-way conflict that the shared pipe absorbs (2 loads per 4R = 36 FP32
// instructions). The staging is cp.async (one memory latency per tile).
// Shared memory per block: 55.6 KB at decim 2, 37.2 KB at decim 1 (T = 41);
// __launch_bounds__(256, 4) caps registers at 64, so 4 blocks (32 warps,
// 50% occupancy) run per SM, each thread with R independent sums.
// The TPU kernel's HALO alignment, even/odd deinterleave pass and chunk
// padding are layout artefacts of the TPU and have no counterpart here.
//
// The planes and tails come in float32 or bfloat16 (the bf16 compute dtype
// stores the sample-rate planes in bfloat16 before the front end, as the
// original does; its Pallas kernel casts them to float32 in VMEM). A
// bfloat16 word is widened to float32 on its way into shared memory (plain
// loads, four of each plane in flight, where float32 takes cp.async), and
// every operation after the staging is the float32 body's: on bfloat16
// input x each body gives bit for bit what it gives on x.float().
#include "common.cuh"

namespace {

constexpr int R = 9;                              // outputs per thread
constexpr int THREADS = 256;
constexpr int SPAN = R * THREADS;                 // outputs of one pass
constexpr int TILE = SPAN - SONDETPU_MAX_TAPS;    // filt outputs per block
constexpr int T_FIXED = 41;                       // every path's tap count

template <int D, int TT, bool IDENT, typename In>
__global__ void __launch_bounds__(THREADS, 4) frontend_kernel(
    const In* __restrict__ xi, const In* __restrict__ xq,
    const In* __restrict__ ti, const In* __restrict__ tq,
    const Taps hc, const Taps hm, const int t_run, const float scale,
    const int n, const int halo,
    float* __restrict__ filt, float* __restrict__ partial) {
    extern __shared__ float smem[];
    const int T = TT > 0 ? TT : t_run;
    const int N = n / D;
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int nx = D * (SPAN - 1) + T;       // input window per plane
    const int ncf = TILE + T;                // cf[g0 - T .. g0 + TILE - 1]
    const int na = TILE + T - 1;             // audio[g0 - T + 1 .. ]
    float* xs_i = smem;
    float* xs_q = xs_i + nx;
    float* cf_i = xs_q + nx;                 // SPAN each
    float* cf_q = cf_i + SPAN;
    float* au = xs_i;                        // stage 2 overwrites the input
    float* out = cf_i;                       // stage 3 overwrites cf

    const In* row_i = xi + (size_t)c * n;
    const In* row_q = xq + (size_t)c * n;
    const In* tail_i = ti + (size_t)c * halo;
    const In* tail_q = tq + (size_t)c * halo;
    // xs[j] = x[x0 + j]; x0 >= -halo is checked by the entry point
    const long x0 = (long)D * (g0 - T) - (T - 1);
    if constexpr (sizeof(In) == 4) {
        for (int j = threadIdx.x; j < nx; j += THREADS) {
            const long gi = x0 + j;      // past the block: zeros, no output
            const bool tail = gi < 0;
            const long at = tail ? halo + gi : (gi < n ? gi : 0);
            cp_async_f32(xs_i + j, (tail ? tail_i : row_i) + at, gi < n);
            cp_async_f32(xs_q + j, (tail ? tail_q : row_q) + at, gi < n);
        }
    } else {
        // bfloat16: BATCH loads of each plane in flight, then their stores
        constexpr int BATCH = 4;
        for (int j0 = threadIdx.x; j0 < nx; j0 += BATCH * THREADS) {
            Bf16Word<1> wi[BATCH], wq[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int j = j0 + b * THREADS;
                const long gi = x0 + j;
                const bool tail = gi < 0, in = j < nx && gi < n;
                const long at = tail ? halo + gi : (in ? gi : 0);
                wi[b] = load_bf16<1>((tail ? tail_i : row_i) + at, in);
                wq[b] = load_bf16<1>((tail ? tail_q : row_q) + at, in);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int j = j0 + b * THREADS;
                if (j < nx) {
                    store_widened<1>(xs_i + j, wi[b]);
                    store_widened<1>(xs_q + j, wq[b]);
                }
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // 1. cf[g0 - T + k] = sum_u hc[u] * xs[D*k + T - 1 - u], k = k0 .. k0+R-1
    const int k0 = threadIdx.x * R;
    if (k0 < ncf) {
        float y[R];
#pragma unroll
        for (int r = 0; r < R; ++r) y[r] = 0.0f;
        slide_window<R, D, TT>(xs_i + D * k0 + T - 1, T,
                               [&](int u, int r, float x) {
            y[r] = __fadd_rn(y[r], __fmul_rn(hc.h[u], x));
        });
#pragma unroll
        for (int r = 0; r < R; ++r) {
            cf_i[k0 + r] = y[r];
            y[r] = 0.0f;
        }
        slide_window<R, D, TT>(xs_q + D * k0 + T - 1, T,
                               [&](int u, int r, float x) {
            y[r] = __fadd_rn(y[r], __fmul_rn(hc.h[u], x));
        });
#pragma unroll
        for (int r = 0; r < R; ++r) cf_q[k0 + r] = y[r];
    }
    __syncthreads();

    // 2. audio[g0 - T + 1 + m] from cf[k = m + 1] and cf[k = m]; the
    // identity body writes filt[g0 + m] = audio[g0 + m - T + 1] here
    float s = 0.0f;
    for (int m = threadIdx.x; m < na; m += THREADS) {
        const float a = cf_i[m + 1], b = cf_q[m + 1];
        const float pa = cf_i[m], pb = cf_q[m];
        const float dre = __fadd_rn(__fmul_rn(a, pa), __fmul_rn(b, pb));
        const float dim = __fsub_rn(__fmul_rn(b, pa), __fmul_rn(a, pb));
        const float v = __fmul_rn(fast_atan2(dim, dre), scale);
        if (IDENT) {
            if (m < TILE && g0 + m < N) filt[(size_t)c * N + g0 + m] = v;
            const int g = g0 + m - (T - 1);
            if (m >= T - 1 && g < N) s += v;
        } else {
            au[m] = v;
        }
    }

    if (!IDENT) {
        __syncthreads();
        // 3. filt[g0 + t] = sum_u hm[u] * au[t + T - 1 - u], t = t0 .. t0+R-1
        const int t0 = threadIdx.x * R;
        if (t0 < TILE) {
            float y[R];
#pragma unroll
            for (int r = 0; r < R; ++r) y[r] = 0.0f;
            slide_window<R, 1, TT>(au + t0 + T - 1, T,
                                   [&](int u, int r, float x) {
                y[r] = __fadd_rn(y[r], __fmul_rn(hm.h[u], x));
            });
#pragma unroll
            for (int r = 0; r < R; ++r) {
                out[t0 + r] = y[r];
                if (t0 + r < TILE && g0 + t0 + r < N) s += au[t0 + r + T - 1];
            }
        }
        __syncthreads();
        for (int t = threadIdx.x; t < TILE && g0 + t < N; t += THREADS)
            filt[(size_t)c * N + g0 + t] = out[t];
    }

    // block sum of this tile's audio -> partial[c, tile]
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    __shared__ float warp_sums[THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.0f;
        for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
        partial[(size_t)c * gridDim.x + blockIdx.x] = tot;
    }
}

template <int D, int TT, bool IDENT, typename In>
int launch(const In* xi, const In* xq, const In* ti, const In* tq,
           const Taps& th, const Taps& tm, int T, float scale, int C, int n,
           int halo, float* filt, float* partial, cudaStream_t stream) {
    const int N = n / D;
    const dim3 grid((N + TILE - 1) / TILE, C);
    const size_t shm = sizeof(float) * (2 * (D * (SPAN - 1) + T) + 2 * SPAN);
    const cudaError_t err = cudaFuncSetAttribute(
        frontend_kernel<D, TT, IDENT, In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
    frontend_kernel<D, TT, IDENT, In><<<grid, THREADS, shm, stream>>>(
        xi, xq, ti, tq, th, tm, T, scale, n, halo, filt, partial);
    return (int)cudaGetLastError();
}

template <int D, typename In>
int dispatch(const void* xi, const void* xq, const void* ti, const void* tq,
             const Taps& th, const Taps& tm, int T, float scale,
             bool identity, int C, int n, int halo, float* filt,
             float* partial, cudaStream_t s) {
    const In* pi = static_cast<const In*>(xi);
    const In* pq = static_cast<const In*>(xq);
    const In* ptq = static_cast<const In*>(tq);
    const In* pti = static_cast<const In*>(ti);
    if (T == T_FIXED)
        return identity
            ? launch<D, T_FIXED, true>(pi, pq, pti, ptq, th, tm, T, scale, C,
                                       n, halo, filt, partial, s)
            : launch<D, T_FIXED, false>(pi, pq, pti, ptq, th, tm, T, scale,
                                        C, n, halo, filt, partial, s);
    return identity
        ? launch<D, 0, true>(pi, pq, pti, ptq, th, tm, T, scale, C, n, halo,
                             filt, partial, s)
        : launch<D, 0, false>(pi, pq, pti, ptq, th, tm, T, scale, C, n, halo,
                              filt, partial, s);
}

template <typename In>
int dispatch_decim(const void* xi, const void* xq, const void* ti,
                   const void* tq, const Taps& th, const Taps& tm, int T,
                   float scale, int decim, bool identity, int C, int n,
                   int halo, float* filt, float* partial, cudaStream_t s) {
    if (decim == 2)
        return dispatch<2, In>(xi, xq, ti, tq, th, tm, T, scale, identity, C,
                               n, halo, filt, partial, s);
    return dispatch<1, In>(xi, xq, ti, tq, th, tm, T, scale, identity, C, n,
                           halo, filt, partial, s);
}

}  // namespace

// Tiles per channel for a block of n samples at decimation `decim`: the
// width of the `partial` output.
SONDETPU_API int sondetpu_frontend_tiles(int n, int decim) {
    return (n / decim + TILE - 1) / TILE;
}

// xi, xq [C, n]; ti, tq [C, halo], float32, or bfloat16 when bf16 is
// set; hc, hm: host arrays of T taps; identity: hm is exactly [0, ..., 0,
// 1] (the caller's host check; checked again here); filt [C, n/decim];
// partial [C, sondetpu_frontend_tiles]. T = 41 runs the compile-time body,
// any other T the run-time one.
SONDETPU_API int sondetpu_fused_frontend(
    const void* xi, const void* xq, const void* ti, const void* tq,
    const float* hc, const float* hm, int T, float scale, int decim,
    int identity, int bf16, int C, int n, int halo, float* filt,
    float* partial, void* stream) {
    if (T < 1 || T > SONDETPU_MAX_TAPS || (decim != 1 && decim != 2) ||
        decim * T + T - 1 > halo || n % decim != 0 || C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    Taps th{}, tm{};
    for (int u = 0; u < T; ++u) {
        th.h[u] = hc[u];
        tm.h[u] = hm[u];
        if (identity && hm[u] != (u == T - 1 ? 1.0f : 0.0f))
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch_decim<__nv_bfloat16>(xi, xq, ti, tq, th, tm, T, scale,
                                             decim, identity != 0, C, n, halo,
                                             filt, partial, s);
    return dispatch_decim<float>(xi, xq, ti, tq, th, tm, T, scale, decim,
                                 identity != 0, C, n, halo, filt, partial, s);
}
