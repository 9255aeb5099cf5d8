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
// original does; its Pallas kernel casts them to float32 in VMEM). Every
// operation on a sample is the float32 body's: on bfloat16 input x each
// body gives bit for bit what it gives on x.float(), DC included.
//
// The run-time-T bodies widen bfloat16 on its way into shared memory
// (plain loads, four of each plane in flight). The four compiled bfloat16
// bodies (41 taps; decim1_t41_bf16 runs once a step on m10's FM fallback)
// are frontend_walk_kernel. What bounds frontend_kernel is the FP32 issue
// of its three stages (at [2048, 192000] decim 1: the channel filter ~2.3
// ms, the matched FIR ~1.1, the discriminator ~0.4), and on bfloat16 a
// staging that cost 0.34-0.46 ms more than float32's (PR 18, a split of
// every body's stages). The walking body stages the raw words by 16-byte
// cp.async (half the bytes of a widened window) into one
// of two buffers while the block computes the tile before, widens each
// word by a shift at its register-window load (ld_f32), keeps the channel
// filter's outputs in registers for the discriminator, carries the FIR's
// lead from tile to tile and takes three barriers a tile instead of five.
// Its stages still add up: the arithmetic's issue bounds it, and without
// the wrapper's DC pass it takes ~5.0 ms against the float32 body's ~5.5
// on an H100 (PERF.md §6). One bulk copy (TMA) a plane and tile in
// place of the cp.async timed within 1%, waiting for no copy changed
// nothing, and walks of 1 to 16 tiles within 4%.
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

// ---- The walking bodies (41 taps compiled in; bfloat16 planes) ----------

constexpr int LEAD = T_FIXED - 1;     // audio before a tile that its FIR reads
// A thread computes cf at R consecutive positions of a tile from its first
// position gs - 1 on: lane l of warp w from 287 w + R l - 1 (relative to
// gs), so that lane 0's first position is the warp below's last and every
// lane has the cf before each of its audio positions but lane 0's first.
constexpr int WARP_POS = 32 * R - 1;
__host__ __device__ constexpr int walk_first(const int tid) {
    return WARP_POS * (tid / 32) + R * (tid % 32) - 1;
}
// the last position the threads that start below npos compute
__host__ __device__ constexpr int walk_last(const int npos) {
    int t = THREADS - 1;
    while (walk_first(t) >= npos) --t;
    return walk_first(t) + R - 1;
}
// a walk's first tile computes its lead too
constexpr int LAST_FIRST = walk_last(TILE + LEAD);
constexpr int LAST_NEXT = walk_last(TILE);
static_assert(walk_first(THREADS - 1) + R >= TILE + LEAD, "a pass covers");
// audio a tile holds (its lead and its TILE), and the FIR's one read past
constexpr int AU = TILE + LEAD + R;

template <int D, typename In>
struct Walk {
    static constexpr int V = 16 / (int)sizeof(In);     // values a 16-byte copy
    static constexpr int NX = D * (LAST_FIRST + 1) + T_FIXED;  // a plane
    // room for the row's misalignment, in whole 16-byte chunks
    static constexpr int NXA = (NX + 2 * V - 2) / V * V;
    static constexpr size_t RAW = 2 * (size_t)NXA * sizeof(In);  // 2 planes
    static constexpr size_t BYTES = 2 * RAW + 2 * AU * sizeof(float);
    static_assert(RAW >= SPAN * sizeof(float), "out aliases a raw buffer");
};

template <typename In>
struct RawWord {
    using type = unsigned;
};
template <>
struct RawWord<__nv_bfloat16> {
    using type = unsigned short;
};

// x[xw] of a row (x[0] at row, negative x in the tail) lies this many
// values past a 16-byte boundary
template <typename In>
__device__ __forceinline__ int misalign(const In* row, const long xw) {
    return (int)(((reinterpret_cast<uintptr_t>(row) +
                   (uintptr_t)(xw * (long)sizeof(In))) & 15) / sizeof(In));
}

// buf[misalign(row, xw) + j] = x[xw + j] for j < cnt, x < 0 from the tail
// and zeros past the block (they feed no output). Every 16-byte chunk of
// the row that lies wholly in [0, n) is one cp.async; the chunks at the
// row's two ends (the tail, the last partial chunk) are copied a value at a
// time, so nothing outside the row or its tail is read.
template <typename In>
__device__ __forceinline__ void stage_plane(In* buf, const In* row,
                                            const In* tail, const long xw,
                                            const int cnt, const int n,
                                            const int halo) {
    using W = typename RawWord<In>::type;
    constexpr int V = 16 / (int)sizeof(In);
    const int a = misalign(row, xw);
    const long xb = xw - a;
    const int nq = (a + cnt + V - 1) / V;
    W* wb = reinterpret_cast<W*>(buf);
    const W* wr = reinterpret_cast<const W*>(row);
    const W* wt = reinterpret_cast<const W*>(tail);
    for (int q = threadIdx.x; q < nq; q += THREADS) {
        const long x = xb + (long)q * V;
        if (x >= 0 && x + V <= n) {
            cp_async_f32x4(reinterpret_cast<float*>(wb + q * V),
                           reinterpret_cast<const float*>(wr + x), true);
        } else {
            W v[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const long xe = x + e;
                v[e] = xe < xw || xe >= xw + cnt || xe >= n ? W(0)
                       : xe < 0                             ? wt[halo + xe]
                                                            : wr[xe];
            }
#pragma unroll
            for (int e = 0; e < V; ++e) wb[q * V + e] = v[e];
        }
    }
}

// A block walks tiles [kbeg, kend) of row c: tile k+1's raw input is in
// flight (cp.async into the other of two buffers) while tile k computes,
// and the last LEAD audio values of tile k are the lead of tile k+1's FIR,
// so only a walk's first tile computes its lead. Per tile:
//  B1; issue tile k+1's copies
//  1+2. each thread R consecutive positions: cf of both planes on register
//       windows over the raw words, then their audio in registers (cf of
//       the position before from the lane below by a shuffle); audio to
//       shared memory
//  B2; 3. the matched FIR as in frontend_kernel, the DC sum at its tap 0
//       (identity: the delayed audio to filt and the DC sum, strided as
//       frontend_kernel's stage 2); warp sums
//  B3; coalesced stores of filt; thread 0 writes the tile's partial.
// Each thread adds the same outputs in the same order as frontend_kernel,
// the warp and block sums are the same trees: partial is bit for bit the
// same.
template <int D, bool IDENT, typename In>
__global__ void __launch_bounds__(THREADS, 4) frontend_walk_kernel(
    const In* __restrict__ xi, const In* __restrict__ xq,
    const In* __restrict__ ti, const In* __restrict__ tq, const Taps hc,
    const Taps hm, const float scale, const int n, const int halo,
    float* __restrict__ filt, float* __restrict__ partial) {
    using L = Walk<D, In>;
    constexpr int T = T_FIXED;
    extern __shared__ __align__(16) unsigned char smem_walk[];
    In* raw = reinterpret_cast<In*>(smem_walk);     // [buffer][plane][NXA]
    float* aus = reinterpret_cast<float*>(smem_walk + 2 * L::RAW);
    __shared__ float warp_sums[THREADS / 32];

    const int N = n / D;
    const int tiles = (N + TILE - 1) / TILE;
    const int c = blockIdx.y;
    const int kbeg = (int)((long)blockIdx.x * tiles / gridDim.x);
    const int kend = (int)((long)(blockIdx.x + 1) * tiles / gridDim.x);
    const In* row_i = xi + (size_t)c * n;
    const In* row_q = xq + (size_t)c * n;
    const In* tail_i = ti + (size_t)c * halo;
    const In* tail_q = tq + (size_t)c * halo;
    const int lane = threadIdx.x & 31;
    const bool vec = N % 4 == 0 && aligned16(filt);

    // tile k computes positions gs .. gs + npos - 1 from x[xw ..]
    auto first_pos = [&](const int k) {
        return k * TILE - (k == kbeg ? LEAD : 0);
    };
    auto stage = [&](const int k) {
        In* buf = raw + 2 * ((k - kbeg) & 1) * L::NXA;
        const long xw = (long)D * (first_pos(k) - 1) - (T - 1);
        const int cnt = D * ((k == kbeg ? LAST_FIRST : LAST_NEXT) + 1) + T;
        stage_plane(buf, row_i, tail_i, xw, cnt, n, halo);
        stage_plane(buf + L::NXA, row_q, tail_q, xw, cnt, n, halo);
        cp_async_commit();
    };

    stage(kbeg);
    for (int k = kbeg; k < kend; ++k) {
        const int b = (k - kbeg) & 1;
        const int g0 = k * TILE;
        const int gs = first_pos(k);
        const int npos = g0 - gs + TILE;
        const long xw = (long)D * (gs - 1) - (T - 1);
        In* buf = raw + 2 * b * L::NXA;
        const In* pi = buf + misalign(row_i, xw);
        const In* pq = buf + L::NXA + misalign(row_q, xw);
        float* au = aus + b * AU;               // audio[g0 - LEAD + j]
        float* au_next = aus + (b ^ 1) * AU;    // the next tile's
        float* out = reinterpret_cast<float*>(buf);  // free after B2
        cp_async_wait_all();
        __syncthreads();                                          // B1
        if (k + 1 < kend) stage(k + 1);

        // 1+2. positions gs + k0 .. gs + k0 + R - 1 (k0 = walk_first):
        // pp[D*r - u] is the input of position gs + k0 + r at tap u; the
        // I plane, then the Q plane through one copy of the taps
        const int k0 = walk_first(threadIdx.x);
        float ci[R], cq[R];
#pragma unroll
        for (int r = 0; r < R; ++r) ci[r] = cq[r] = 0.0f;
        if (k0 < npos) {
#pragma unroll 1
            for (int p = 0; p < 2; ++p) {
                const In* pp = (p == 0 ? pi : pq) + D * (k0 + 1) + T - 1;
                float y[R];
#pragma unroll
                for (int r = 0; r < R; ++r) y[r] = 0.0f;
                slide_window<R, D, T>(pp, T, [&](int u, int r, float x) {
                    y[r] = __fadd_rn(y[r], __fmul_rn(hc.h[u], x));
                });
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (p == 0)
                        ci[r] = y[r];
                    else
                        cq[r] = y[r];
                }
            }
        }
        // audio from cf of the position and of the one before, which is
        // the lane below's last; lane 0's first position is the warp
        // below's last, whose audio that warp writes
        float pa = __shfl_up_sync(0xffffffffu, ci[R - 1], 1);
        float pb = __shfl_up_sync(0xffffffffu, cq[R - 1], 1);
        if (k0 < npos) {
            const int j0 = gs - g0 + LEAD + k0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float a = ci[r], bq = cq[r];
                const float dre = __fadd_rn(__fmul_rn(a, pa), __fmul_rn(bq, pb));
                const float dim = __fsub_rn(__fmul_rn(bq, pa), __fmul_rn(a, pb));
                const float v = __fmul_rn(fast_atan2(dim, dre), scale);
                pa = a;
                pb = bq;
                const int j = j0 + r;
                if ((lane > 0 || r > 0) && k0 + r < npos) {
                    au[j] = v;
                    if (j >= TILE) au_next[j - TILE] = v;
                }
            }
        }
        __syncthreads();                                          // B2

        float s = 0.0f;
        if constexpr (IDENT) {
            for (int m = threadIdx.x; m < TILE + LEAD; m += THREADS) {
                const float v = au[m];
                if (m < TILE && g0 + m < N) filt[(size_t)c * N + g0 + m] = v;
                if (m >= LEAD && g0 + m - LEAD < N) s += v;
            }
        } else {
            // 3. filt[g0 + t] = sum_u hm[u] * au[t + T - 1 - u]
            const int t0 = R * threadIdx.x;
            if (t0 < TILE) {
                float y[R];
#pragma unroll
                for (int r = 0; r < R; ++r) y[r] = 0.0f;
                slide_window<R, 1, T>(au + t0 + T - 1, T,
                                      [&](int u, int r, float x) {
                    y[r] = __fadd_rn(y[r], __fmul_rn(hm.h[u], x));
                    if (u == 0 && t0 + r < TILE && g0 + t0 + r < N) s += x;
                });
#pragma unroll
                for (int r = 0; r < R; ++r) out[t0 + r] = y[r];
            }
        }
        for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) warp_sums[threadIdx.x >> 5] = s;
        __syncthreads();                                          // B3
        if (!IDENT) {
            float* frow = filt + (size_t)c * N + g0;
            if (vec) {
                for (int t = 4 * threadIdx.x; t < TILE && g0 + t < N;
                     t += 4 * THREADS)
                    *reinterpret_cast<float4*>(frow + t) =
                        *reinterpret_cast<const float4*>(out + t);
            } else {
                for (int t = threadIdx.x; t < TILE && g0 + t < N;
                     t += THREADS)
                    frow[t] = out[t];
            }
        }
        if (threadIdx.x == 0) {
            float tot = 0.0f;
            for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
            partial[(size_t)c * tiles + k] = tot;
        }
    }
}

template <int D, bool IDENT, typename In>
int launch_walk(const In* xi, const In* xq, const In* ti, const In* tq,
                const Taps& th, const Taps& tm, float scale, int C, int n,
                int halo, int walk, float* filt, float* partial,
                cudaStream_t stream) {
    const int tiles = (n / D + TILE - 1) / TILE;
    const dim3 grid((tiles + walk - 1) / walk, C);
    const size_t shm = Walk<D, In>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        frontend_walk_kernel<D, IDENT, In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
    frontend_walk_kernel<D, IDENT, In><<<grid, THREADS, shm, stream>>>(
        xi, xq, ti, tq, th, tm, scale, n, halo, filt, partial);
    return (int)cudaGetLastError();
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
             bool identity, int C, int n, int halo, int walk, float* filt,
             float* partial, cudaStream_t s) {
    const In* pi = static_cast<const In*>(xi);
    const In* pq = static_cast<const In*>(xq);
    const In* ptq = static_cast<const In*>(tq);
    const In* pti = static_cast<const In*>(ti);
    if (T == T_FIXED) {
        // float32 planes do not walk: at decim 2 the walk took 3.443 ms
        // against frontend_kernel's 3.255 on an H100 (PR 18)
        if constexpr (sizeof(In) == 2)
            return identity
                ? launch_walk<D, true>(pi, pq, pti, ptq, th, tm, scale, C, n,
                                       halo, walk, filt, partial, s)
                : launch_walk<D, false>(pi, pq, pti, ptq, th, tm, scale, C,
                                        n, halo, walk, filt, partial, s);
        else
            return identity
                ? launch<D, T_FIXED, true>(pi, pq, pti, ptq, th, tm, T, scale,
                                           C, n, halo, filt, partial, s)
                : launch<D, T_FIXED, false>(pi, pq, pti, ptq, th, tm, T,
                                            scale, C, n, halo, filt, partial,
                                            s);
    }
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
                   int halo, int walk, float* filt, float* partial,
                   cudaStream_t s) {
    if (decim == 2)
        return dispatch<2, In>(xi, xq, ti, tq, th, tm, T, scale, identity, C,
                               n, halo, walk, filt, partial, s);
    return dispatch<1, In>(xi, xq, ti, tq, th, tm, T, scale, identity, C, n,
                           halo, walk, filt, partial, s);
}

}  // namespace

// Tiles per channel for a block of n samples at decimation `decim`: the
// width of the `partial` output.
SONDETPU_API int sondetpu_frontend_tiles(int n, int decim) {
    return (n / decim + TILE - 1) / TILE;
}

// xi, xq [C, n]; ti, tq [C, halo], float32, or bfloat16 when bf16 is
// set; hc, hm: host arrays of T taps; identity: hm is exactly [0, ..., 0,
// 1] (the caller's host check; checked again here); walk: tiles a block of
// the walking bodies takes at most (the caller's choice,
// kernels/frontend.py:frontend_walk); filt [C, n/decim]; partial [C,
// sondetpu_frontend_tiles]. T = 41 runs a compiled body (the walking one
// on bfloat16), any other T the run-time one.
SONDETPU_API int sondetpu_fused_frontend(
    const void* xi, const void* xq, const void* ti, const void* tq,
    const float* hc, const float* hm, int T, float scale, int decim,
    int identity, int bf16, int C, int n, int halo, int walk, float* filt,
    float* partial, void* stream) {
    if (T < 1 || T > SONDETPU_MAX_TAPS || (decim != 1 && decim != 2) ||
        decim * T + T - 1 > halo || n % decim != 0 || C < 1 || n < 1 ||
        walk < 1)
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
                                             walk, filt, partial, s);
    return dispatch_decim<float>(xi, xq, ti, tq, th, tm, T, scale, decim,
                                 identity != 0, C, n, halo, walk, filt,
                                 partial, s);
}
