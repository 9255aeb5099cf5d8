// Fused dual-tone noncoherent FSK front end (m10, ims100, mrzn1): optional
// channel filter -> +/-dev mix -> nb-tap boxcar on four planes -> envelope
// metric, plus per-tile sums of the metric (block DC) and, on request, of
// the envelope-rotation products (the AFC discriminant).
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
//   lp[P]  = (plane[P] + plane[P-1] + ... + plane[P-nb+1]) * (1/nb),
//            summed from zero in that order (each of the 4 planes)
//   metric = (P+ - P-) / (P+ + P- + 1e-12),  P+- = lpI^2 + lpQ^2
//   rot_re/im: sums over 1 <= P < n of the adjacent-sample rotation
//            products of the lp planes.
// The wrapper adds the per-tile partials up.
//
// What bounds it. Without the channel filter (m10, the fleet's group: nb
// 5), device memory: at [616, 192000] the two input planes are 0.95 GB and
// the metric 0.47 GB, 0.42 ms at 3.35 TB/s; the ~47 operations per
// position are 0.17 ms at the FP32 rate, and the ~65 instructions a thread
// issues per position (loads and the IEEE division included) ~0.26 ms.
// With it (ims100 and mrzn1: 41 taps, nb 20), the FP32 issue rate. Every
// product and sum is rounded on its own, so a multiply-add is two
// instructions, and a position takes 2 planes x 41 taps x 2 in the channel
// filter, 12 in the mix, 4 x 21 in the boxcars and their scaling and 11 in
// the metric and its sum: 271 operations, 3.18 ms at [2048, 192000] at
// 33.5e12 a second, where the planes and the metric take 1.4 ms of device
// memory. The body issues ~350 instructions a position (shared loads, the
// IEEE division's sequence, the channel filter's lead recomputed at every
// tile).
//
// Design: one thread block per (CH = 8 channel rows, tile of TILE = 32 x R
// positions); each warp owns one row. The tile's two LO-table windows are
// staged once in shared memory and shared by the eight rows (every channel
// reads the same tables), and each warp stages its own row, all with
// cp.async, 16 bytes a copy where the rows allow it; whether a word comes
// from the tail or the row is a choice of address. One barrier in all,
// after the staging. Then each warp, on its own row:
//  1. The channel filter (the chanfilt bodies): each lane takes RC = 10
//     consecutive cf positions and slides a register window over the
//     staged row (slide_window in common.cuh): one shared load a tap feeds
//     RC sums, taps in ascending order from zero. With T = 41 (every
//     path's count) compiled in, the taps unroll and each is an immediate
//     constant-bank operand of its FMUL. The I and Q planes go through one
//     copy of the unrolled taps, a rolled loop of two: a copy for each
//     made the body 4% slower (twice the code for the instruction cache).
//     Other T take a body with T at run time and one cf position a lane at
//     a time (a register window with T at run time timed 8% faster in
//     float32 but 27% slower on bfloat16 input). The row's TILE + lead cf
//     positions (lead: nb - 1, one more with AFC, rounded up to whole words
//     of four; 308 at nb 20) take one pass of 32 x RC = 320. RC is even, a
//     2-way bank conflict on one load a tap per 20 FP32 instructions. cf
//     goes to the warp's own rows of shared memory.
//  2. The mix and the boxcars: each lane takes R consecutive positions:
//     walking the window of R + nb - 1 positions downward, it forms the
//     four mixed plane values of a position in registers and adds each into
//     the boxcar sums of the (up to nb) outputs it feeds, so every output
//     sums its plane values newest first from zero, the twin's order, with
//     4 shared loads per window position and no shared traffic for the
//     boxcars. With nb compiled in (5 without the channel filter, m10's; 20
//     with 41 taps, ims100's and mrzn1's) the walk unrolls and a position
//     issues only the adds of the outputs it feeds; other widths take a
//     run-time body that tests every output at every position. Mixing each
//     position once before the walk (four mixed planes in shared memory)
//     timed 2% slower: the walk's shared loads stay four a position and
//     the pass adds its own.
//  3. The metric, its DC sum (and the AFC sums) in registers; the metric
//     goes back through the warp's own row of shared memory so the global
//     store is coalesced, and each tile partial is a warp sum.
// R is odd, so lanes at stride R read 32 distinct banks. R = 9 timed
// faster than 7 and within 2% of 11 at [616, 192000] on an H100 (PR 5);
// at 11 the skip_nb5_afc body spills at the 64 registers that
// __launch_bounds__(256, 4) allows, which the compiled chanfilt bodies use
// in full, without spills.
// The chanfilt times above are at [2048, 192000], 41 taps, nb 20 on an
// NVIDIA H100 80GB HBM3 at 700 W (PR 17), where the compiled body takes
// 4.79 ms on float32 and 4.83 on bfloat16 input, and the run-time body it
// replaced on those paths 9.41 and 9.49.
//
// The planes and tails come in float32 or bfloat16 (bf16 groups and the
// bf16 compute dtype store the sample-rate planes in bfloat16; the Pallas
// kernel casts them to float32 in VMEM). A bfloat16 row is widened to
// float32 on its way into shared memory, 8 bytes (four values) a load and
// four loads of each plane in flight where float32 takes a 16-byte
// cp.async, and every operation after the staging is the float32 body's:
// on bfloat16 input x each body gives bit for bit what it gives on
// x.float().
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction: cos and sin are not +/-1) in the order of the plain twin
// (sondetpu_torch/kernels/dualtone.py:fused_dualtone_plain), so the metric
// agrees bit for bit and the sums up to their order of summation.
#include "common.cuh"

namespace {

constexpr int R = 9;                     // positions per lane
constexpr int CH = 8;                    // channel rows per block, one a warp
constexpr int THREADS = 32 * CH;
constexpr int TILE = 32 * R;             // positions per block and row
constexpr int RC = 10;                   // channel-filter outputs per lane
constexpr int T_FIXED = 41;              // every path's channel-filter taps
constexpr int NB_FIXED = 20;             // ims100's and mrzn1's boxcar

// cf positions a row computes: the tile and its lead, in whole passes of
// 32 lanes x RC
__host__ __device__ __forceinline__ int cf_len(const int lead) {
    return (TILE + lead + 32 * RC - 1) / (32 * RC) * (32 * RC);
}

// positions staged a row, from xlead before the tile: with the channel
// filter every input its passes read, rounded up to whole words of four
__host__ __device__ __forceinline__ int staged_len(const bool skip,
                                                   const int xlead,
                                                   const int fh) {
    return skip ? TILE + xlead : (fh + cf_len(xlead - fh) + 3) / 4 * 4;
}

// a row pointer from which four values copy as one word: 16 bytes of
// float32, 8 of bfloat16
__host__ __device__ __forceinline__ bool aligned_words4(const float* p) {
    return aligned16(p);
}
__host__ __device__ __forceinline__ bool aligned_words4(
    const __nv_bfloat16* p) {
    return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

template <int V>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src,
                                           const bool valid) {
    if constexpr (V == 4)
        cp_async_f32x4(dst, src, valid);
    else
        cp_async_f32(dst, src, valid);
}

// Stage positions x0 .. x0 + nx - 1 in words of V values: the tables
// (position mod n) by the whole block, the row's I and Q (the tail below 0)
// by its warp; past n nothing is read and the words are zero (they feed no
// output). With V = 4, x0, nx, n and halo are multiples of 4.
template <int V, typename In>
__device__ __forceinline__ void stage(
    const int x0, const int nx, const int n, const int halo,
    const float* __restrict__ tab_cos, const float* __restrict__ tab_sin,
    const In* __restrict__ row_i, const In* __restrict__ row_q,
    const In* __restrict__ tail_i, const In* __restrict__ tail_q,
    const bool row_valid, float* tc, float* ts, float* xr_i, float* xr_q) {
    for (int k = V * threadIdx.x; k < nx; k += V * THREADS) {
        const int P = x0 + k;
        int p = P;
        if (P < 0) {                       // the first tile only
            p = P % n;
            if (p < 0) p += n;
        }
        const bool in = P < n;
        cp_async_v<V>(tc + k, tab_cos + (in ? p : 0), in);
        cp_async_v<V>(ts + k, tab_sin + (in ? p : 0), in);
    }
    if (!row_valid) return;
    const int lane = threadIdx.x & 31;
    if constexpr (sizeof(In) == 4) {
        for (int k = V * lane; k < nx; k += V * 32) {
            const int P = x0 + k;          // >= -halo, checked by the host
            const bool tail = P < 0, in = P < n;
            const int at = tail ? halo + P : (in ? P : 0);
            cp_async_v<V>(xr_i + k, (tail ? tail_i : row_i) + at, in);
            cp_async_v<V>(xr_q + k, (tail ? tail_q : row_q) + at, in);
        }
    } else {
        // bfloat16: BATCH words of each plane in flight, then their stores
        constexpr int BATCH = 4;
        for (int k0 = V * lane; k0 < nx; k0 += BATCH * V * 32) {
            Bf16Word<V> wi[BATCH], wq[BATCH];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int k = k0 + b * V * 32;
                const int P = x0 + k;
                const bool tail = P < 0, in = k < nx && P < n;
                const int at = tail ? halo + P : (in ? P : 0);
                wi[b] = load_bf16<V>((tail ? tail_i : row_i) + at, in);
                wq[b] = load_bf16<V>((tail ? tail_q : row_q) + at, in);
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int k = k0 + b * V * 32;
                if (k < nx) {
                    store_widened<V>(xr_i + k, wi[b]);
                    store_widened<V>(xr_q + k, wq[b]);
                }
            }
        }
    }
}

__device__ __forceinline__ float warp_sum(float s) {
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

template <int NB, int TT, bool SKIP, bool AFC, typename In>
__global__ void __launch_bounds__(THREADS, 4) dualtone_kernel(
    const In* __restrict__ xi, const In* __restrict__ xq,
    const In* __restrict__ ti, const In* __restrict__ tq,
    const Taps hc, const int t_run, const int nb_run, const float inv_nb,
    const float* __restrict__ tab_cos, const float* __restrict__ tab_sin,
    const int C, const int n, const int halo, const int xlead,
    const bool vec, float* __restrict__ metric,
    float* __restrict__ dc_part, float* __restrict__ re_part,
    float* __restrict__ im_part) {
    extern __shared__ __align__(16) float smem[];
    constexpr int A = AFC ? 1 : 0;       // output 0 is the previous lp
    constexpr int RO = R + A;            // boxcar outputs per lane
    const int nb = NB > 0 ? NB : nb_run;
    const int T = TT > 0 ? TT : t_run;
    const int fh = SKIP ? 0 : T - 1;     // chanfilt history
    const int lead = xlead - fh;         // cf positions before g0
    const int ncf = SKIP ? 0 : cf_len(lead);
    // staged: g0 - xlead .. g0 - xlead + nx - 1 (at least g0 + TILE - 1)
    const int nx = staged_len(SKIP, xlead, fh);
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.y * CH + w;
    const int g0 = blockIdx.x * TILE;
    float* tc = smem;                    // tables, index k: g0 - xlead + k
    float* ts = tc + nx;
    float* xr_i = ts + nx + 2 * w * nx;  // this warp's row, same indexing
    float* xr_q = xr_i + nx;
    // cf at positions g0 - lead + k (the input itself when skipped)
    float* cf_i = SKIP ? xr_i + fh : ts + nx + 2 * CH * nx + 2 * w * ncf;
    float* cf_q = SKIP ? xr_q + fh : cf_i + ncf;

    const bool row_valid = c < C;
    const size_t rc = row_valid ? (size_t)c : 0;
    if (vec)
        stage<4, In>(g0 - xlead, nx, n, halo, tab_cos, tab_sin, xi + rc * n,
                 xq + rc * n, ti + rc * halo, tq + rc * halo, row_valid, tc,
                 ts, xr_i, xr_q);
    else
        stage<1, In>(g0 - xlead, nx, n, halo, tab_cos, tab_sin, xi + rc * n,
                 xq + rc * n, ti + rc * halo, tq + rc * halo, row_valid, tc,
                 ts, xr_i, xr_q);
    cp_async_wait_all();
    __syncthreads();                     // the tables are the block's
    if (!row_valid) return;

    if constexpr (!SKIP) {
        // cf[k] = sum_u hc[u] * x[position - u], ascending u from zero, for
        // k < TILE + lead
        if constexpr (TT > 0) {
            // RC consecutive k a lane on a register window, the I plane and
            // then the Q plane (a rolled loop: one copy of the unrolled
            // taps), in one pass when 32 RC covers the row, as at 41 taps
            // and nb 20
            for (int kc = RC * lane; kc < TILE + lead; kc += 32 * RC) {
#pragma unroll 1
                for (int p = 0; p < 2; ++p) {
                    float y[RC];
#pragma unroll
                    for (int r = 0; r < RC; ++r) y[r] = 0.0f;
                    slide_window<RC, 1, TT>((p ? xr_q : xr_i) + fh + kc, T,
                                            [&](int u, int r, float x) {
                        y[r] = __fadd_rn(y[r], __fmul_rn(hc.h[u], x));
                    });
                    float* out = p ? cf_q : cf_i;
#pragma unroll
                    for (int r = 0; r < RC; ++r) out[kc + r] = y[r];
                }
            }
        } else {
            // T at run time: one k a lane at a time
            for (int k = lane; k < TILE + lead; k += 32) {
                const float* pi = xr_i + k + fh;
                const float* pq = xr_q + k + fh;
                float ci = 0.0f, cq = 0.0f;
                for (int u = 0; u < T; ++u) {
                    ci = __fadd_rn(ci, __fmul_rn(hc.h[u], pi[-u]));
                    cq = __fadd_rn(cq, __fmul_rn(hc.h[u], pq[-u]));
                }
                cf_i[k] = ci;
                cf_q[k] = cq;
            }
        }
        __syncwarp();
    }

    // window position j (0 .. RO + nb - 2) is g0 + t0 - A - (nb - 1) + j;
    // boxcar output o (0 .. RO - 1), at g0 + t0 - A + o, sums positions
    // j = o + nb - 1 down to o, so the walk goes down j
    const int t0 = lane * R;
    const int k0 = lead + t0 - A - (nb - 1);
    const float* pi = cf_i + k0;
    const float* pq = cf_q + k0;
    const float* pc = tc + fh + k0;
    const float* psn = ts + fh + k0;
    float acc[4][RO];
#pragma unroll
    for (int o = 0; o < RO; ++o)
        acc[0][o] = acc[1][o] = acc[2][o] = acc[3][o] = 0.0f;
    auto position = [&](const int j) {
        const float ci = pi[j], cq = pq[j], cv = pc[j], sv = psn[j];
        const float ic = __fmul_rn(ci, cv), qs = __fmul_rn(cq, sv);
        const float qc = __fmul_rn(cq, cv), is = __fmul_rn(ci, sv);
        const float pl[4] = {__fadd_rn(ic, qs),    // +tone I
                             __fsub_rn(qc, is),    // +tone Q
                             __fsub_rn(ic, qs),    // -tone I
                             __fadd_rn(qc, is)};   // -tone Q
#pragma unroll
        for (int o = 0; o < RO; ++o) {
            const bool feeds = NB > 0 ? (o <= j && j < o + NB)
                                      : (unsigned)(j - o) < (unsigned)nb;
            if (feeds) {
#pragma unroll
                for (int a = 0; a < 4; ++a)
                    acc[a][o] = __fadd_rn(acc[a][o], pl[a]);
            }
        }
    };
    if constexpr (NB > 0) {
#pragma unroll
        for (int j = RO + NB - 2; j >= 0; --j) position(j);
    } else {
#pragma unroll 1
        for (int j = RO + nb - 2; j >= 0; --j) position(j);
    }
#pragma unroll
    for (int o = 0; o < RO; ++o)
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][o] = __fmul_rn(acc[a][o], inv_nb);

    float* orow = xr_i;                  // the metric, staged for the store
    __syncwarp();                        // every lane's window is read
    float s_dc = 0.0f, s_re = 0.0f, s_im = 0.0f;
#pragma unroll
    for (int o = A; o < RO; ++o) {
        const float lpi = acc[0][o], lpq = acc[1][o];
        const float lmi = acc[2][o], lmq = acc[3][o];
        const float pp = __fadd_rn(__fmul_rn(lpi, lpi), __fmul_rn(lpq, lpq));
        const float pm = __fadd_rn(__fmul_rn(lmi, lmi), __fmul_rn(lmq, lmq));
        const float met = __fdiv_rn(__fsub_rn(pp, pm),
                                    __fadd_rn(__fadd_rn(pp, pm), 1e-12f));
        orow[t0 + o - A] = met;
        const int g = g0 + t0 + o - A;
        if (g < n) s_dc += met;
        if (AFC && g >= 1 && g < n) {
            float a = __fmul_rn(lpi, acc[0][o - A]);
            a = __fadd_rn(a, __fmul_rn(lpq, acc[1][o - A]));
            a = __fadd_rn(a, __fmul_rn(lmi, acc[2][o - A]));
            a = __fadd_rn(a, __fmul_rn(lmq, acc[3][o - A]));
            float b = __fmul_rn(lpq, acc[0][o - A]);
            b = __fsub_rn(b, __fmul_rn(lpi, acc[1][o - A]));
            b = __fadd_rn(b, __fmul_rn(lmq, acc[2][o - A]));
            b = __fsub_rn(b, __fmul_rn(lmi, acc[3][o - A]));
            s_re += a;
            s_im += b;
        }
    }
    __syncwarp();
    float* mrow = metric + (size_t)c * n + g0;
    if (vec) {
        for (int k = 4 * lane; k < TILE && g0 + k < n; k += 4 * 32)
            *reinterpret_cast<float4*>(mrow + k) =
                *reinterpret_cast<const float4*>(orow + k);
    } else {
        for (int k = lane; k < TILE && g0 + k < n; k += 32) mrow[k] = orow[k];
    }
    s_dc = warp_sum(s_dc);
    if (AFC) {
        s_re = warp_sum(s_re);
        s_im = warp_sum(s_im);
    }
    if (lane == 0) {
        const size_t cell = (size_t)c * gridDim.x + blockIdx.x;
        dc_part[cell] = s_dc;
        if (AFC) {
            re_part[cell] = s_re;
            im_part[cell] = s_im;
        }
    }
}

template <int NB, int TT, bool SKIP, bool AFC, typename In>
int launch(const In* xi, const In* xq, const In* ti, const In* tq,
           const Taps& th, int T, int nb, const float* tc, const float* ts,
           int C, int n, int halo, float* metric, float* dcp, float* rep,
           float* imp, cudaStream_t stream) {
    const int fh = SKIP ? 0 : T - 1;
    // stage from a multiple of 4 before the block where the tail allows,
    // so that rows and tables copy in words of four values
    const int need = nb - 1 + (AFC ? 1 : 0) + fh;
    const int up = (need + 3) / 4 * 4;
    const int xlead = up <= halo ? up : need;
    const int nx = staged_len(SKIP, xlead, fh);
    const bool vec = xlead % 4 == 0 && n % 4 == 0 && halo % 4 == 0 &&
                     aligned_words4(xi) && aligned_words4(xq) &&
                     aligned_words4(ti) && aligned_words4(tq) &&
                     aligned16(tc) && aligned16(ts) && aligned16(metric);
    // the tables and CH rows, then the chanfilt rows
    const size_t shm = sizeof(float) *
        (2 * nx + 2 * CH * nx + (SKIP ? 0 : 2 * CH * cf_len(xlead - fh)));
    const cudaError_t err = cudaFuncSetAttribute(
        dualtone_kernel<NB, TT, SKIP, AFC, In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + TILE - 1) / TILE, (C + CH - 1) / CH);
    dualtone_kernel<NB, TT, SKIP, AFC, In><<<grid, THREADS, shm, stream>>>(
        xi, xq, ti, tq, th, T, nb, (float)(1.0 / nb), tc, ts, C, n, halo,
        xlead, vec, metric, dcp, rep, imp);
    return (int)cudaGetLastError();
}

template <bool AFC, typename In>
int dispatch(const void* xi_, const void* xq_, const void* ti_,
             const void* tq_, const Taps& th, int T, int nb, const float* tc,
             const float* ts, bool skip, int C, int n, int halo,
             float* metric, float* dcp, float* rep, float* imp,
             cudaStream_t s) {
    const In* xi = static_cast<const In*>(xi_);
    const In* xq = static_cast<const In*>(xq_);
    const In* ti = static_cast<const In*>(ti_);
    const In* tq = static_cast<const In*>(tq_);
    if (!skip) {
        if (T == T_FIXED && nb == NB_FIXED)
            return launch<NB_FIXED, T_FIXED, false, AFC>(
                xi, xq, ti, tq, th, T, nb, tc, ts, C, n, halo, metric, dcp,
                rep, imp, s);
        return launch<0, 0, false, AFC>(xi, xq, ti, tq, th, T, nb, tc, ts, C,
                                        n, halo, metric, dcp, rep, imp, s);
    }
    if (nb == 5)
        return launch<5, 0, true, AFC>(xi, xq, ti, tq, th, T, nb, tc, ts, C,
                                       n, halo, metric, dcp, rep, imp, s);
    return launch<0, 0, true, AFC>(xi, xq, ti, tq, th, T, nb, tc, ts, C, n,
                                   halo, metric, dcp, rep, imp, s);
}

template <typename In>
int dispatch_afc(const void* xi, const void* xq, const void* ti,
                 const void* tq, const Taps& th, int T, int nb,
                 const float* tc, const float* ts, bool skip, bool afc,
                 int C, int n, int halo, float* metric, float* dcp,
                 float* rep, float* imp, cudaStream_t s) {
    if (afc)
        return dispatch<true, In>(xi, xq, ti, tq, th, T, nb, tc, ts, skip, C,
                                  n, halo, metric, dcp, rep, imp, s);
    return dispatch<false, In>(xi, xq, ti, tq, th, T, nb, tc, ts, skip, C, n,
                               halo, metric, dcp, rep, imp, s);
}

}  // namespace

// Tiles per channel for a block of n samples: the width of the partials.
SONDETPU_API int sondetpu_dualtone_tiles(int n) {
    return (n + TILE - 1) / TILE;
}

// xi, xq [C, n]; ti, tq [C, halo], float32, or bfloat16 when bf16 is set;
// hc: host array of T taps (read unless skip_chanfilt); tab_cos, tab_sin
// [n] (device); metric [C, n]; dc_part, re_part, im_part [C,
// sondetpu_dualtone_tiles(n)] (the last two written only when want_afc).
// Skipped chanfilt with nb = 5 runs the compile-time body, other nb the
// run-time one; with the channel filter, T = 41 and nb = 20 run the body
// with both compiled in, any other T or nb the run-time one.
SONDETPU_API int sondetpu_dualtone_frontend(
    const void* xi, const void* xq, const void* ti, const void* tq,
    const float* hc, int T, int nb, const float* tab_cos,
    const float* tab_sin, int skip_chanfilt, int want_afc, int bf16, int C,
    int n, int halo, float* metric, float* dc_part, float* re_part,
    float* im_part, void* stream) {
    const int fh = skip_chanfilt ? 0 : T - 1;
    if (T < 1 || T > SONDETPU_MAX_TAPS || nb < 1 || nb + fh > halo ||
        C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    if (!skip_chanfilt)
        for (int u = 0; u < T; ++u) th.h[u] = hc[u];
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return dispatch_afc<__nv_bfloat16>(
            xi, xq, ti, tq, th, T, nb, tab_cos, tab_sin, skip_chanfilt != 0,
            want_afc != 0, C, n, halo, metric, dc_part, re_part, im_part, s);
    return dispatch_afc<float>(xi, xq, ti, tq, th, T, nb, tab_cos, tab_sin,
                               skip_chanfilt != 0, want_afc != 0, C, n, halo,
                               metric, dc_part, re_part, im_part, s);
}
