// Fused AFSK tone discriminator (iMet-4, SRS-C50): mark/space mix of the
// DC-removed discriminator audio -> win-tap boxcar on the I and Q product
// of each tone -> normalized envelope difference.
//
// Replaces sondetpu/pallas/frontend.py:fused_afsk_frontend (body
// _afsk_kernel).
//
// On the virtual stream a = concat(atail, audio), negative positions
// reading the carried HALO-sample audio tail, for positions P of the block:
//   pm_i[P] = a[P] * mark_cos[P],  pm_q[P] = a[P] * mark_sin[P]   (and the
//             same with the space tables; tables are host f64 values at
//             entry HALO + P, so no LO phase is carried)
//   fi[P]   = (pm_i[P] + pm_i[P-1] + ... + pm_i[P-win+1]) * (1/win)
//             (summed from zero in that order, as the Pallas box())
//   Em      = fi^2 + fq^2 of the mark products, Es of the space products
//   soft[P] = (Em - Es) / (Em + Es + 1e-9)
//
// What bounds it: the FP32 issue rate of the boxcar. Every sum is rounded
// on its own in the twin's order (sondetpu_torch/kernels/afsk.py:
// fused_afsk_frontend_plain), so the four boxcars are 4 * win ordered adds
// per output, plus ~26 instructions of mixing, scaling, energies and the
// IEEE division: at [2048, 192000] 3.9e8 outputs x ~186 (win 40), ~2.5 ms
// at 132 SMs x 128 lanes x ~1.75 GHz (2.1 at the published 67 TFLOP/s, as
// chip_smoke.py counts); ~1.4 ms (1.15) at win 20. The audio read and
// the soft write are 3.1 GB, ~0.94 ms at 3.35 TB/s. A running or prefix sum
// would need ~4 adds per output but rounds differently from the Pallas
// kernel's order; it is left open.
//
// Design: one thread block per (channel, tile of TILE positions); the four
// product planes of the tile and its win - 1 positions of history are
// formed once and staged in shared memory, so each audio sample is read
// from device memory once (plus a win - 1 halo per tile). Each thread then
// takes R consecutive positions, one plane at a time, with R sums and a
// register window that slides down one product per step (slide_window in
// common.cuh): one shared load feeds R adds. win 40 and 20 (the iMet-4 and
// C50 paths) are compile-time bodies; other widths take a run-time body.
// R = 9 measured faster than 7, 11 and 13 at [2048, 192000] (11 and 13
// spill at the 64-register cap); R is odd, so threads reading at stride R
// hit 32 distinct banks. The results go through shared memory so the
// global store is coalesced.
// Staging: cp.async copies the audio and the four table windows into shared
// memory (one memory latency per tile), and each thread forms the products
// of the words it copied in place. Shared memory per block: 46.8 KB at
// win 40, 46.5 KB at win 20; __launch_bounds__(256, 4) caps registers at
// 64: 4 blocks (32 warps) per SM.
// The TPU kernel's per-chunk table windows and chunk padding have no
// counterpart here.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order of the plain twin, so the two agree bit for
// bit.
#include "common.cuh"

namespace {

constexpr int R = 9;                     // positions per thread
constexpr int THREADS = 256;
constexpr int TILE = R * THREADS;

// f[r] = (p[r] + p[r - 1] + ... + p[r - win + 1]) * inv_win, from zero
template <int WIN>
__device__ __forceinline__ void boxcar(const float* __restrict__ p,
                                       const int win, const float inv_win,
                                       float (&f)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = 0.0f;
    slide_window<R, 1, WIN>(p, win, [&](int, int r, float x) {
        f[r] = __fadd_rn(f[r], x);
    });
#pragma unroll
    for (int r = 0; r < R; ++r) f[r] = __fmul_rn(f[r], inv_win);
}

template <int WIN>
__global__ void __launch_bounds__(THREADS, 4) afsk_kernel(
    const float* __restrict__ audio, const float* __restrict__ atail,
    const float* __restrict__ mc, const float* __restrict__ ms,
    const float* __restrict__ sc, const float* __restrict__ ss,
    const int win_run, const float inv_win, const int n, const int halo,
    float* __restrict__ soft) {
    extern __shared__ float smem[];
    const int win = WIN > 0 ? WIN : win_run;
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int h = win - 1;
    const int np = TILE + h;                 // positions [g0 - h, g0 + TILE)
    float* p_mi = smem;                      // each first holds its table
    float* p_mq = p_mi + np;
    float* p_si = p_mq + np;
    float* p_sq = p_si + np;
    float* au = p_sq + np;

    const float* row = audio + (size_t)c * n;
    const float* tail = atail + (size_t)c * halo;
    for (int j = threadIdx.x; j < np; j += THREADS) {
        const long g = (long)g0 - h + j;     // >= -halo, checked by the host
        const bool in = g < n;               // past the block: zeros
        const long t = in ? halo + g : 0;
        cp_async_f32(au + j, g < 0 ? tail + t : row + (in ? g : 0), in);
        cp_async_f32(p_mi + j, mc + t, in);
        cp_async_f32(p_mq + j, ms + t, in);
        cp_async_f32(p_si + j, sc + t, in);
        cp_async_f32(p_sq + j, ss + t, in);
    }
    cp_async_wait_all();
    for (int j = threadIdx.x; j < np; j += THREADS) {   // this thread's words
        const float a = au[j];
        p_mi[j] = __fmul_rn(a, p_mi[j]);
        p_mq[j] = __fmul_rn(a, p_mq[j]);
        p_si[j] = __fmul_rn(a, p_si[j]);
        p_sq[j] = __fmul_rn(a, p_sq[j]);
    }
    __syncthreads();

    // positions g0 + t0 .. g0 + t0 + R - 1, product index t0 + h onwards
    const int t0 = threadIdx.x * R;
    const int l0 = t0 + h;
    float em[R], es[R], fi[R], fq[R];
    boxcar<WIN>(p_mi + l0, win, inv_win, fi);
    boxcar<WIN>(p_mq + l0, win, inv_win, fq);
#pragma unroll
    for (int r = 0; r < R; ++r)
        em[r] = __fadd_rn(__fmul_rn(fi[r], fi[r]), __fmul_rn(fq[r], fq[r]));
    boxcar<WIN>(p_si + l0, win, inv_win, fi);
    boxcar<WIN>(p_sq + l0, win, inv_win, fq);
#pragma unroll
    for (int r = 0; r < R; ++r)
        es[r] = __fadd_rn(__fmul_rn(fi[r], fi[r]), __fmul_rn(fq[r], fq[r]));
    __syncthreads();                         // every plane read: reuse p_mi
#pragma unroll
    for (int r = 0; r < R; ++r)
        p_mi[t0 + r] = __fdiv_rn(__fsub_rn(em[r], es[r]),
                                 __fadd_rn(__fadd_rn(em[r], es[r]), 1e-9f));
    __syncthreads();
    for (int t = threadIdx.x; t < TILE && g0 + t < n; t += THREADS)
        soft[(size_t)c * n + g0 + t] = p_mi[t];
}

template <int WIN>
int launch(const float* audio, const float* atail, const float* mc,
           const float* ms, const float* sc, const float* ss, int win,
           float inv_win, int C, int n, int halo, float* soft,
           cudaStream_t stream) {
    const size_t shm = sizeof(float) * 5 * (TILE + win - 1);
    const cudaError_t err = cudaFuncSetAttribute(
        afsk_kernel<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + TILE - 1) / TILE, C);
    afsk_kernel<WIN><<<grid, THREADS, shm, stream>>>(
        audio, atail, mc, ms, sc, ss, win, inv_win, n, halo, soft);
    return (int)cudaGetLastError();
}

}  // namespace

// audio [C, n]; atail [C, halo]; mark_cos, mark_sin, space_cos, space_sin
// [halo + n] (device; entry halo + P for position P); soft [C, n].
// win 40 and 20 run compile-time bodies, any other width the run-time one.
SONDETPU_API int sondetpu_afsk_frontend(
    const float* audio, const float* atail, const float* mark_cos,
    const float* mark_sin, const float* space_cos, const float* space_sin,
    int win, float inv_win, int C, int n, int halo, float* soft,
    void* stream) {
    if (win < 2 || win - 1 > halo || C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (win == 40)
        return launch<40>(audio, atail, mark_cos, mark_sin, space_cos,
                          space_sin, win, inv_win, C, n, halo, soft, s);
    if (win == 20)
        return launch<20>(audio, atail, mark_cos, mark_sin, space_cos,
                          space_sin, win, inv_win, C, n, halo, soft, s);
    return launch<0>(audio, atail, mark_cos, mark_sin, space_cos, space_sin,
                     win, inv_win, C, n, halo, soft, s);
}
