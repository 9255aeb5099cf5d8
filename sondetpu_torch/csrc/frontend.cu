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
// What bounds it: at 2048 channels x 192000 samples the two f32 input
// planes are 3.1 GB a block and filt 0.8 GB, so device-memory bytes set the
// floor (~1.2 ms at 3.35 TB/s). Design: one thread block per (channel, tile
// of TILE outputs); the tile's input window, then cf, then audio are staged
// in shared memory, so each input sample is read from device memory once
// (plus a (D+1)*ntaps halo per tile) and neighbouring threads take
// neighbouring outputs. Taps ride in the parameter space (broadcast reads).
// As written, one shared-memory load per multiply-add bounds it instead:
// 5.4 ms at that shape on an H100 80GB HBM3 (700 W), ~22% of the memory
// bandwidth. Register tiling (several outputs per thread) is the next step.
// The TPU kernel's HALO alignment, even/odd deinterleave pass and chunk
// padding are layout artefacts of the TPU and have no counterpart here.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the same order as the plain torch twin
// (sondetpu_torch/kernels/frontend.py:fused_frontend_plain), so the two
// agree bit for bit up to the order of the DC sum.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

template <int D>
__global__ void __launch_bounds__(THREADS) frontend_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ ti, const float* __restrict__ tq,
    const Taps hc, const Taps hm, const int T, const float scale,
    const int n, const int halo,
    float* __restrict__ filt, float* __restrict__ partial) {
    extern __shared__ float smem[];
    const int N = n / D;
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int nx = D * (TILE + T - 1) + T;   // input window per plane
    const int ncf = TILE + T;                // cf[g0 - T .. g0 + TILE - 1]
    const int na = TILE + T - 1;             // audio[g0 - T + 1 .. ]
    float* xs_i = smem;
    float* xs_q = xs_i + nx;
    float* cf_i = xs_q + nx;
    float* cf_q = cf_i + ncf;
    float* au = cf_q + ncf;

    const float* row_i = xi + (size_t)c * n;
    const float* row_q = xq + (size_t)c * n;
    const float* tail_i = ti + (size_t)c * halo;
    const float* tail_q = tq + (size_t)c * halo;
    // xs[j] = x[x0 + j]; x0 >= -halo is checked by the wrapper
    const long x0 = (long)D * (g0 - T) - (T - 1);
    for (int j = threadIdx.x; j < nx; j += THREADS) {
        const long gi = x0 + j;
        float vi = 0.0f, vq = 0.0f;
        if (gi < 0) {
            vi = tail_i[halo + gi];
            vq = tail_q[halo + gi];
        } else if (gi < n) {             // past the block: feeds no output
            vi = row_i[gi];
            vq = row_q[gi];
        }
        xs_i[j] = vi;
        xs_q[j] = vq;
    }
    __syncthreads();

    // cf[g0 - T + k] = sum_u hc[u] * xs[D*k + T - 1 - u]
    for (int k = threadIdx.x; k < ncf; k += THREADS) {
        const float* pi = xs_i + D * k + T - 1;
        const float* pq = xs_q + D * k + T - 1;
        float ai = 0.0f, aq = 0.0f;
        for (int u = 0; u < T; ++u) {
            ai = __fadd_rn(ai, __fmul_rn(hc.h[u], pi[-u]));
            aq = __fadd_rn(aq, __fmul_rn(hc.h[u], pq[-u]));
        }
        cf_i[k] = ai;
        cf_q[k] = aq;
    }
    __syncthreads();

    // audio[g0 - T + 1 + m] from cf[k = m + 1] and cf[k = m]
    for (int m = threadIdx.x; m < na; m += THREADS) {
        const float a = cf_i[m + 1], b = cf_q[m + 1];
        const float pa = cf_i[m], pb = cf_q[m];
        const float dre = __fadd_rn(__fmul_rn(a, pa), __fmul_rn(b, pb));
        const float dim = __fsub_rn(__fmul_rn(b, pa), __fmul_rn(a, pb));
        au[m] = __fmul_rn(fast_atan2(dim, dre), scale);
    }
    __syncthreads();

    // filt[g0 + t] = sum_u hm[u] * au[t + T - 1 - u]
    float s = 0.0f;
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
        const int g = g0 + t;
        if (g >= N) break;
        const float* pa = au + t + T - 1;
        float acc = 0.0f;
        for (int u = 0; u < T; ++u)
            acc = __fadd_rn(acc, __fmul_rn(hm.h[u], pa[-u]));
        filt[(size_t)c * N + g] = acc;
        s += pa[0];
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

template <int D>
int launch(const float* xi, const float* xq, const float* ti, const float* tq,
           const float* hc, const float* hm, int T, float scale, int C,
           int n, int halo, float* filt, float* partial, cudaStream_t stream) {
    Taps th{}, tm{};
    for (int u = 0; u < T; ++u) {
        th.h[u] = hc[u];
        tm.h[u] = hm[u];
    }
    const int N = n / D;
    const dim3 grid((N + TILE - 1) / TILE, C);
    const size_t shm = sizeof(float) *
        (2 * (D * (TILE + T - 1) + T) + 2 * (TILE + T) + (TILE + T - 1));
    frontend_kernel<D><<<grid, THREADS, shm, stream>>>(
        xi, xq, ti, tq, th, tm, T, scale, n, halo, filt, partial);
    return (int)cudaGetLastError();
}

}  // namespace

// Tiles per channel for a block of n samples at decimation `decim`: the
// width of the `partial` output.
SONDETPU_API int sondetpu_frontend_tiles(int n, int decim) {
    return (n / decim + TILE - 1) / TILE;
}

// xi, xq [C, n]; ti, tq [C, halo]; hc, hm: host arrays of T taps;
// filt [C, n/decim]; partial [C, sondetpu_frontend_tiles(n, decim)].
SONDETPU_API int sondetpu_fused_frontend(
    const float* xi, const float* xq, const float* ti, const float* tq,
    const float* hc, const float* hm, int T, float scale, int decim, int C,
    int n, int halo, float* filt, float* partial, void* stream) {
    if (T < 1 || T > SONDETPU_MAX_TAPS || (decim != 1 && decim != 2) ||
        decim * T + T - 1 > halo || n % decim != 0 || C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (decim == 2)
        return launch<2>(xi, xq, ti, tq, hc, hm, T, scale, C, n, halo, filt,
                         partial, s);
    return launch<1>(xi, xq, ti, tq, hc, hm, T, scale, C, n, halo, filt,
                     partial, s);
}
