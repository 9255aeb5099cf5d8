// FM discriminator -> block DC removal -> matched FIR over one block of
// channel IQ, with the carried previous sample and audio tail.
//
// Replaces sondetpu/pallas/frontend.py:fused_demod_fir (body _kernel), the
// r4 front end that fused_frontend superseded.
//
// For every channel row c and position P of the block (P = -1 reading the
// carried previous sample prev[c]):
//   audio[P] = fast_atan2(q[P] i[P-1] - i[P] q[P-1],
//                         i[P] i[P-1] + q[P] q[P-1]) * scale
//   a[P]     = audio[P] - mean(audio)        (when dc_block)
//   filt[P]  = sum_k h[k] * a[P - k]          (k ascending, from zero; a at
//                                              P < 0 is the carried tail)
//   tail     = a[n - T + 1 .. n - 1]
//
// What bounds it: device memory. The DC needs the whole row before any
// output, and at [2048, 96000] a row's audio (384 KB) does not fit in one
// block's shared memory, so the work takes two passes over the audio. The
// kernel's bound (the planes read once, filt written once, 12 bytes per
// sample) is 0.70 ms; two passes move at least 20 bytes per sample (the
// planes, the audio written and read back, filt), 1.17 ms at 3.35 TB/s.
// The FIR's 2T rounded operations per output are 0.48 ms at the FP32 rate.
//
// Design: two launches on the caller's stream, many blocks per row in each.
// 1. demod_audio_kernel: each block takes AUDIO_SPAN positions of a row,
//    four consecutive positions a thread in 16-byte loads and stores where
//    the row allows it, forms the discriminator audio (the previous sample
//    by a warp shuffle, lane 0 reading it from memory), writes it, and
//    writes the sum of its positions to partial[c, block] (each thread's
//    positions in order, then a butterfly over the warp, then the warps in
//    order).
// 2. demod_fir_kernel: K1's register-blocked FIR (slide_window in
//    common.cuh) over a - dc: one block per (row, tile of SPAN = R x THREADS
//    outputs). The block loads its tile (16 bytes a load where the row
//    allows it) and the T - 1 positions before it into registers while
//    warp 0 sums the row's partials in one fixed order (lane l the partials
//    l, l + 32, ..., then a butterfly), so dc is the same number in every
//    block and in every run; it subtracts dc in registers and stores the
//    tile to shared memory. Each thread then takes R consecutive outputs on
//    a sliding register window: one shared load per tap feeds R outputs,
//    and with T = 41 compiled in each tap h[k] is an immediate
//    constant-bank operand; any other T <= 64 takes a body with T at run
//    time. R is odd, so threads at stride R read 32 distinct banks; the
//    outputs go back through shared memory so the global store is
//    coalesced. R = 21 was the fastest of 9, 15 and 21 on an H100 (63
//    registers in the t41 body, no spill; chip_smoke.py --tune).
//
// Exactness: every product and sum of the discriminator and the FIR is
// rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction) in the order
// of the plain twin (sondetpu_torch/kernels/frontend.py:
// fused_demod_fir_plain), tap 0 added to zero as the twin adds it (so a
// zero output is +0 as there); only the order of the DC sum differs from
// torch.mean. Without dc_block the kernel and the twin agree bit for bit.
#include "common.cuh"

#ifndef SONDETPU_DEMOD_FIR_R
#define SONDETPU_DEMOD_FIR_R 21
#endif

namespace {

constexpr int THREADS = 256;
constexpr int AUDIO_SPAN = 16 * THREADS;          // positions a launch-1 block
constexpr int R = SONDETPU_DEMOD_FIR_R;           // FIR outputs per thread
constexpr int SPAN = R * THREADS;                 // FIR outputs per block
constexpr int NV = (SPAN / 4 + THREADS - 1) / THREADS;  // float4s a thread
constexpr int HIST = SONDETPU_MAX_TAPS;           // history slots, >= T - 1
constexpr int T_FIXED = 41;                       // RS41's matched filter
constexpr unsigned FULL = 0xffffffffu;

static __device__ __forceinline__ float disc(float i, float q, float ip,
                                             float qp, float scale) {
    const float dre = __fadd_rn(__fmul_rn(i, ip), __fmul_rn(q, qp));
    const float dim = __fsub_rn(__fmul_rn(q, ip), __fmul_rn(i, qp));
    return __fmul_rn(fast_atan2(dim, dre), scale);
}

// W consecutive floats from or to p (W = 4: one 16-byte access)
template <int W>
static __device__ __forceinline__ void load(const float* p, float* x) {
    if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
        x[0] = *p;
    }
}

template <int W>
static __device__ __forceinline__ void store(float* p, const float* x) {
    if constexpr (W == 4)
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    else
        *p = x[0];
}

// W consecutive positions a thread (W = 4: float4 loads and stores, the
// rows' length a multiple of 4 and the planes 16-byte aligned), 16 / W at
// stride THREADS * W
template <int W>
__global__ void __launch_bounds__(THREADS) demod_audio_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ prev, const float scale, const int n,
    float* __restrict__ audio, float* __restrict__ partial) {
    __shared__ float warp_sums[THREADS / 32];
    const int c = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const size_t row = (size_t)c * n;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 16 / W; ++k) {
        const int g = blockIdx.x * AUDIO_SPAN + (k * THREADS + threadIdx.x) * W;
        const bool in = g < n;
        float i[W] = {}, q[W] = {};
        if (in) load<W>(xi + row + g, i);
        if (in) load<W>(xq + row + g, q);
        // the sample before g: the lane below's last, lane 0 its own read
        float ip = __shfl_up_sync(FULL, i[W - 1], 1);
        float qp = __shfl_up_sync(FULL, q[W - 1], 1);
        if (lane == 0 && in) {
            ip = g ? xi[row + g - 1] : prev[2 * c];
            qp = g ? xq[row + g - 1] : prev[2 * c + 1];
        }
        if (in) {
            float a[W];
#pragma unroll
            for (int e = 0; e < W; ++e) {
                a[e] = disc(i[e], q[e], ip, qp, scale);
                ip = i[e];
                qp = q[e];
                s = __fadd_rn(s, a[e]);
            }
            store<W>(audio + row + g, a);
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
    if (lane == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = warp_sums[0];
        for (int w = 1; w < THREADS / 32; ++w) tot = __fadd_rn(tot, warp_sums[w]);
        partial[(size_t)c * gridDim.x + blockIdx.x] = tot;
    }
}

template <int TT>
__global__ void __launch_bounds__(THREADS, 4) demod_fir_kernel(
    const float* __restrict__ audio, const float* __restrict__ atail,
    const float* __restrict__ partial, const int nparts, const Taps h,
    const int t_run, const int dc_block, const int n, const bool vec,
    float* __restrict__ filt, float* __restrict__ tail_out) {
    // body[j] holds a at position p0 + j, j in [-(T - 1), SPAN)
    __shared__ __align__(16) float xs[HIST + SPAN];
    __shared__ float dc_s;
    const int T = TT > 0 ? TT : t_run;
    const int hh = T - 1;
    const int c = blockIdx.y;
    const int p0 = blockIdx.x * SPAN;
    const float* arow = audio + (size_t)c * n;
    float* body = xs + HIST;
    // the tile into registers (zero past n) and the T - 1 positions before
    // it (the carried tail before the block)
    float4 v[NV];
    if (vec) {          // n % 4 == 0 and audio aligned: whole chunks
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int j = 4 * (k * THREADS + threadIdx.x);
            v[k] = j < SPAN && p0 + j < n
                       ? *reinterpret_cast<const float4*>(arow + p0 + j)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    } else {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            float e[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int j = 4 * k * THREADS + m * THREADS + threadIdx.x;
                e[m] = j < SPAN && p0 + j < n ? arow[p0 + j] : 0.0f;
            }
            v[k] = make_float4(e[0], e[1], e[2], e[3]);
        }
    }
    float hv = 0.0f;
    const int gh = p0 - hh + threadIdx.x;
    if (threadIdx.x < hh)
        hv = gh < 0 ? atail[(size_t)c * hh + hh + gh] : arow[gh];
    if (dc_block && threadIdx.x < 32) {
        // the row's DC from its partials, in the same order in every block
        const float* prow = partial + (size_t)c * nparts;
        float s = 0.0f;
        for (int k = threadIdx.x; k < nparts; k += 32)
            s = __fadd_rn(s, prow[k]);
        for (int o = 16; o > 0; o >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(FULL, s, o));
        if (threadIdx.x == 0) dc_s = __fdiv_rn(s, (float)n);
    }
    if (dc_block) {
        __syncthreads();
        // the audio of the row minus dc; the carried tail is already so
        const float dc = dc_s;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            v[k].x = __fsub_rn(v[k].x, dc);
            v[k].y = __fsub_rn(v[k].y, dc);
            v[k].z = __fsub_rn(v[k].z, dc);
            v[k].w = __fsub_rn(v[k].w, dc);
        }
        if (gh >= 0) hv = __fsub_rn(hv, dc);
    }
    if (threadIdx.x < hh) body[threadIdx.x - hh] = hv;
    if (vec) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int j = 4 * (k * THREADS + threadIdx.x);
            if (j < SPAN) *reinterpret_cast<float4*>(body + j) = v[k];
        }
    } else {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                const int j = 4 * k * THREADS + m * THREADS + threadIdx.x;
                if (j < SPAN) body[j] = e[m];
            }
        }
    }
    __syncthreads();
    if (p0 + SPAN > n - hh) {
        // the next block's tail, positions n - T + 1 .. n - 1, where this
        // tile holds them
        for (int j = threadIdx.x; j < SPAN; j += THREADS) {
            const int g = p0 + j;
            if (g >= n - hh && g < n)
                tail_out[(size_t)c * hh + g - (n - hh)] = body[j];
        }
    }

    // filt[p0 + t0 + r] = sum_k h[k] * body[t0 + r - k], r < R
    const int t0 = threadIdx.x * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    slide_window<R, 1, TT>(body + t0, T, [&](int u, int r, float x) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(h.h[u], x));
    });
    __syncthreads();                             // every window read
#pragma unroll
    for (int r = 0; r < R; ++r) body[t0 + r] = acc[r];
    __syncthreads();
    float* orow = filt + (size_t)c * n + p0;
    for (int j = threadIdx.x; j < SPAN && p0 + j < n; j += THREADS)
        orow[j] = body[j];
}

template <int TT>
int launch_fir(const float* audio, const float* atail, const float* partial,
               int nparts, const Taps& h, int T, int dc_block, int C, int n,
               float* filt, float* tail_out, cudaStream_t stream) {
    const dim3 grid((n + SPAN - 1) / SPAN, C);
    const bool vec = n % 4 == 0 && aligned16(audio);
    demod_fir_kernel<TT><<<grid, THREADS, 0, stream>>>(
        audio, atail, partial, nparts, h, T, dc_block, n, vec, filt, tail_out);
    return (int)cudaGetLastError();
}

}  // namespace

// Partial sums per row that sondetpu_demod_audio writes for a block of n.
SONDETPU_API int sondetpu_demod_audio_parts(int n) {
    return (n + AUDIO_SPAN - 1) / AUDIO_SPAN;
}

// Launch 1. xi, xq [C, n]; prev [C, 2] -> audio [C, n], partial [C, parts].
SONDETPU_API int sondetpu_demod_audio(const float* xi, const float* xq,
                                      const float* prev, float scale, int C,
                                      int n, float* audio, float* partial,
                                      void* stream) {
    if (C < 1 || C > 65535 || n < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid(sondetpu_demod_audio_parts(n), C);
    cudaStream_t s = (cudaStream_t)stream;
    if (n % 4 == 0 && aligned16(xi) && aligned16(xq) && aligned16(audio))
        demod_audio_kernel<4><<<grid, THREADS, 0, s>>>(xi, xq, prev, scale, n,
                                                     audio, partial);
    else
        demod_audio_kernel<1><<<grid, THREADS, 0, s>>>(xi, xq, prev, scale, n,
                                                     audio, partial);
    return (int)cudaGetLastError();
}

// Launch 2. audio [C, n] and partial [C, parts] from launch 1; atail
// [C, T - 1]; hm: host array of T taps -> filt [C, n], tail_out [C, T - 1].
// T = 41 runs the compile-time body, any other T the run-time one.
SONDETPU_API int sondetpu_demod_fir(const float* audio, const float* atail,
                                    const float* partial, const float* hm,
                                    int T, int dc_block, int C, int n,
                                    float* filt, float* tail_out,
                                    void* stream) {
    if (T < 2 || T > SONDETPU_MAX_TAPS || C < 1 || C > 65535 || n < T - 1)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    for (int k = 0; k < T; ++k) th.h[k] = hm[k];
    const int parts = sondetpu_demod_audio_parts(n);
    cudaStream_t s = (cudaStream_t)stream;
    if (T == T_FIXED)
        return launch_fir<T_FIXED>(audio, atail, partial, parts, th, T,
                                   dc_block, C, n, filt, tail_out, s);
    return launch_fir<0>(audio, atail, partial, parts, th, T, dc_block, C, n,
                         filt, tail_out, s);
}
