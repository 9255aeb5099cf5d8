// Fused dual-tone noncoherent FSK front end (m10): optional channel
// filter -> +/-dev mix -> nb-tap boxcar on four planes -> envelope metric,
// plus per-tile sums of the metric (block DC) and, on request, of the
// envelope-rotation products (the AFC discriminant).
//
// Replaces sondetpu/pallas/frontend.py:fused_dualtone_frontend (body
// _dualtone_kernel).
//
// On the virtual stream x = concat(tail, block), negative positions reading
// the carried HALO-sample tail, for positions P of the block:
//   cf[P]  = sum_u hc[u] * x[P - u]                (or x[P] when skipped)
//   p+[P]  = cf[P] * e^{-j ang(P)},  p-[P] = cf[P] * e^{+j ang(P)}
//            (ang from the host f64 tables cos/sin[P mod n]: dev*n/fs is an
//            integer, so the tables are periodic in n and negative
//            positions wrap)
//   lp[P]  = (sum_{v<nb} plane[P - v]) * (1/nb)    (each of the 4 planes)
//   metric = (P+ - P-) / (P+ + P- + 1e-12),  P+- = lpI^2 + lpQ^2
//   rot_re/im: sums over 1 <= P < n of the adjacent-sample rotation
//            products of the lp planes.
// The wrapper adds the per-tile partials up.
//
// What bounds it: device memory. At [616, 192000] (the m10 group of the
// 2048-bin fleet) the two input planes are 0.95 GB and the metric 0.47 GB,
// ~0.4 ms at 3.35 TB/s; the ~30 flops per sample (with the chanfilt
// skipped) are far below the card's rate. Design: one thread block per
// (channel, tile of TILE positions), as in frontend.cu: the tile's input
// window [nb + halo | body] is staged in shared memory, then the four mixed
// planes, then the four boxcar outputs, so each input sample is read from
// device memory once (plus an (nb + ntaps - 1)-sample halo per tile) and
// neighbouring threads take neighbouring positions. The TPU kernel's
// per-chunk table windows, SUMW lane padding and chunk padding have no
// counterpart here.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order of the plain twin
// (sondetpu_torch/kernels/dualtone.py:fused_dualtone_plain), so the metric
// agrees bit for bit and the sums up to their order of summation.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

__device__ __forceinline__ float block_sum(float s, float* warp_sums) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    float tot = 0.0f;
    if (threadIdx.x == 0)
        for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
    return tot;
}

template <bool SKIP, bool AFC>
__global__ void __launch_bounds__(THREADS) dualtone_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ ti, const float* __restrict__ tq,
    const Taps hc, const int T, const int nb, const float inv_nb,
    const float* __restrict__ tab_cos, const float* __restrict__ tab_sin,
    const int n, const int halo, float* __restrict__ metric,
    float* __restrict__ dc_part, float* __restrict__ re_part,
    float* __restrict__ im_part) {
    extern __shared__ float smem[];
    __shared__ float warp_sums[THREADS / 32];
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int fh = SKIP ? 0 : T - 1;         // chanfilt history
    const int nx = TILE + nb + fh;           // x[g0 - nb - fh .. g0 + TILE)
    const int np = TILE + nb;                // planes at [g0 - nb, g0 + TILE)
    const int nl = TILE + 1;                 // lp at [g0 - 1, g0 + TILE)
    float* xs_i = smem;
    float* xs_q = xs_i + nx;
    float* pl = xs_q + nx;                   // 4 planes of np
    float* lp = pl + 4 * np;                 // 4 planes of nl

    const float* row_i = xi + (size_t)c * n;
    const float* row_q = xq + (size_t)c * n;
    const float* tail_i = ti + (size_t)c * halo;
    const float* tail_q = tq + (size_t)c * halo;
    const long x0 = (long)g0 - nb - fh;      // >= -halo, checked by the host
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

    // channel filter (or pass-through) and the +/-dev mix at position
    // P = g0 - nb + k
    for (int k = threadIdx.x; k < np; k += THREADS) {
        float ci, cq;
        if (SKIP) {
            ci = xs_i[k];
            cq = xs_q[k];
        } else {
            const float* pi = xs_i + k + T - 1;
            const float* pq = xs_q + k + T - 1;
            ci = 0.0f;
            cq = 0.0f;
            for (int u = 0; u < T; ++u) {
                ci = __fadd_rn(ci, __fmul_rn(hc.h[u], pi[-u]));
                cq = __fadd_rn(cq, __fmul_rn(hc.h[u], pq[-u]));
            }
        }
        long p = ((long)g0 - nb + k) % n;
        if (p < 0) p += n;
        const float cv = tab_cos[p], sv = tab_sin[p];
        pl[k] = __fadd_rn(__fmul_rn(ci, cv), __fmul_rn(cq, sv));           // +I
        pl[np + k] = __fsub_rn(__fmul_rn(cq, cv), __fmul_rn(ci, sv));      // +Q
        pl[2 * np + k] = __fsub_rn(__fmul_rn(ci, cv), __fmul_rn(cq, sv));  // -I
        pl[3 * np + k] = __fadd_rn(__fmul_rn(cq, cv), __fmul_rn(ci, sv));  // -Q
    }
    __syncthreads();

    // boxcar: lp[l] at position g0 - 1 + l sums plane positions
    // g0 - 1 + l - v, v < nb, i.e. plane index l - 1 - v + nb
    for (int l = threadIdx.x; l < nl; l += THREADS) {
        for (int a = 0; a < 4; ++a) {
            const float* p = pl + a * np + l - 1 + nb;
            float acc = 0.0f;
            for (int v = 0; v < nb; ++v) acc = __fadd_rn(acc, p[-v]);
            lp[a * nl + l] = __fmul_rn(acc, inv_nb);
        }
    }
    __syncthreads();

    const float* lpi = lp;
    const float* lpq = lp + nl;
    const float* lmi = lp + 2 * nl;
    const float* lmq = lp + 3 * nl;
    float s_dc = 0.0f, s_re = 0.0f, s_im = 0.0f;
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
        const int g = g0 + t;
        if (g >= n) break;
        const int l = t + 1;
        const float pp = __fadd_rn(__fmul_rn(lpi[l], lpi[l]),
                                   __fmul_rn(lpq[l], lpq[l]));
        const float pm = __fadd_rn(__fmul_rn(lmi[l], lmi[l]),
                                   __fmul_rn(lmq[l], lmq[l]));
        const float met = __fdiv_rn(__fsub_rn(pp, pm),
                                    __fadd_rn(__fadd_rn(pp, pm), 1e-12f));
        metric[(size_t)c * n + g] = met;
        s_dc += met;
        if (AFC && g >= 1) {
            float a = __fmul_rn(lpi[l], lpi[l - 1]);
            a = __fadd_rn(a, __fmul_rn(lpq[l], lpq[l - 1]));
            a = __fadd_rn(a, __fmul_rn(lmi[l], lmi[l - 1]));
            a = __fadd_rn(a, __fmul_rn(lmq[l], lmq[l - 1]));
            float b = __fmul_rn(lpq[l], lpi[l - 1]);
            b = __fsub_rn(b, __fmul_rn(lpi[l], lpq[l - 1]));
            b = __fadd_rn(b, __fmul_rn(lmq[l], lmi[l - 1]));
            b = __fsub_rn(b, __fmul_rn(lmi[l], lmq[l - 1]));
            s_re += a;
            s_im += b;
        }
    }
    const size_t cell = (size_t)c * gridDim.x + blockIdx.x;
    const float tot = block_sum(s_dc, warp_sums);
    if (threadIdx.x == 0) dc_part[cell] = tot;
    if (AFC) {
        const float tre = block_sum(s_re, warp_sums);
        if (threadIdx.x == 0) re_part[cell] = tre;
        const float tim = block_sum(s_im, warp_sums);
        if (threadIdx.x == 0) im_part[cell] = tim;
    }
}

template <bool SKIP, bool AFC>
int launch(const float* xi, const float* xq, const float* ti, const float* tq,
           const Taps& th, int T, int nb, const float* tc, const float* ts,
           int C, int n, int halo, float* metric, float* dcp, float* rep,
           float* imp, cudaStream_t stream) {
    const int fh = SKIP ? 0 : T - 1;
    const size_t shm = sizeof(float) *
        (2 * (TILE + nb + fh) + 4 * (TILE + nb) + 4 * (TILE + 1));
    if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + TILE - 1) / TILE, C);
    dualtone_kernel<SKIP, AFC><<<grid, THREADS, shm, stream>>>(
        xi, xq, ti, tq, th, T, nb, (float)(1.0 / nb), tc, ts, n, halo, metric,
        dcp, rep, imp);
    return (int)cudaGetLastError();
}

}  // namespace

// Tiles per channel for a block of n samples: the width of the partials.
SONDETPU_API int sondetpu_dualtone_tiles(int n) {
    return (n + TILE - 1) / TILE;
}

// xi, xq [C, n]; ti, tq [C, halo]; hc: host array of T taps (read unless
// skip_chanfilt); tab_cos, tab_sin [n] (device); metric [C, n];
// dc_part, re_part, im_part [C, sondetpu_dualtone_tiles(n)] (the last two
// written only when want_afc).
SONDETPU_API int sondetpu_dualtone_frontend(
    const float* xi, const float* xq, const float* ti, const float* tq,
    const float* hc, int T, int nb, const float* tab_cos,
    const float* tab_sin, int skip_chanfilt, int want_afc, int C, int n,
    int halo, float* metric, float* dc_part, float* re_part,
    float* im_part, void* stream) {
    const int fh = skip_chanfilt ? 0 : T - 1;
    if (T < 1 || T > SONDETPU_MAX_TAPS || nb < 1 || nb + fh > halo ||
        C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    if (!skip_chanfilt)
        for (int u = 0; u < T; ++u) th.h[u] = hc[u];
    cudaStream_t s = (cudaStream_t)stream;
    if (skip_chanfilt) {
        if (want_afc)
            return launch<true, true>(xi, xq, ti, tq, th, T, nb, tab_cos,
                                      tab_sin, C, n, halo, metric, dc_part,
                                      re_part, im_part, s);
        return launch<true, false>(xi, xq, ti, tq, th, T, nb, tab_cos,
                                   tab_sin, C, n, halo, metric, dc_part,
                                   re_part, im_part, s);
    }
    if (want_afc)
        return launch<false, true>(xi, xq, ti, tq, th, T, nb, tab_cos,
                                   tab_sin, C, n, halo, metric, dc_part,
                                   re_part, im_part, s);
    return launch<false, false>(xi, xq, ti, tq, th, T, nb, tab_cos, tab_sin,
                                C, n, halo, metric, dc_part, re_part,
                                im_part, s);
}
