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
// What bounds it: shared-memory loads. At [2048, 192000] the audio read and
// the soft write are 3.1 GB, ~1 ms at 3.35 TB/s, but the boxcar as written
// takes 4 * win shared loads per output (6.3e10 at win 40), ~8.5 ms at the
// ~7.4e12 loads/s an H100 serves. Design: one thread block per (channel,
// tile of TILE positions); the four product planes of the tile and its
// win - 1 positions of history are formed once and staged in shared memory,
// so each audio sample is read from device memory once (plus a win - 1
// halo per tile) and neighbouring threads take neighbouring positions. A
// running or prefix sum would need ~4 loads per output but rounds
// differently from the Pallas kernel's order; that redesign is left for
// later. The TPU kernel's per-chunk table windows and chunk padding have no
// counterpart here.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA
// contraction) in the order of the plain twin
// (sondetpu_torch/kernels/afsk.py:fused_afsk_frontend_plain), so the two
// agree bit for bit.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) afsk_kernel(
    const float* __restrict__ audio, const float* __restrict__ atail,
    const float* __restrict__ mc, const float* __restrict__ ms,
    const float* __restrict__ sc, const float* __restrict__ ss,
    const int win, const float inv_win, const int n, const int halo,
    float* __restrict__ soft) {
    extern __shared__ float smem[];
    const int c = blockIdx.y;
    const int g0 = blockIdx.x * TILE;
    const int h = win - 1;
    const int np = TILE + h;                 // positions [g0 - h, g0 + TILE)
    float* p_mi = smem;
    float* p_mq = p_mi + np;
    float* p_si = p_mq + np;
    float* p_sq = p_si + np;

    const float* row = audio + (size_t)c * n;
    const float* tail = atail + (size_t)c * halo;
    for (int j = threadIdx.x; j < np; j += THREADS) {
        const long g = (long)g0 - h + j;     // >= -halo, checked by the host
        float a = 0.0f, tmc = 0.0f, tms = 0.0f, tsc = 0.0f, tss = 0.0f;
        if (g < n) {                         // past the block: feeds no output
            a = g < 0 ? tail[halo + g] : row[g];
            const long t = halo + g;
            tmc = mc[t];
            tms = ms[t];
            tsc = sc[t];
            tss = ss[t];
        }
        p_mi[j] = __fmul_rn(a, tmc);
        p_mq[j] = __fmul_rn(a, tms);
        p_si[j] = __fmul_rn(a, tsc);
        p_sq[j] = __fmul_rn(a, tss);
    }
    __syncthreads();

    for (int t = threadIdx.x; t < TILE; t += THREADS) {
        const int g = g0 + t;
        if (g >= n) break;
        const int l = t + h;                 // product index of position g
        float mi = 0.0f, mq = 0.0f, si = 0.0f, sq = 0.0f;
        for (int v = 0; v < win; ++v) {
            mi = __fadd_rn(mi, p_mi[l - v]);
            mq = __fadd_rn(mq, p_mq[l - v]);
            si = __fadd_rn(si, p_si[l - v]);
            sq = __fadd_rn(sq, p_sq[l - v]);
        }
        mi = __fmul_rn(mi, inv_win);
        mq = __fmul_rn(mq, inv_win);
        si = __fmul_rn(si, inv_win);
        sq = __fmul_rn(sq, inv_win);
        const float em = __fadd_rn(__fmul_rn(mi, mi), __fmul_rn(mq, mq));
        const float es = __fadd_rn(__fmul_rn(si, si), __fmul_rn(sq, sq));
        soft[(size_t)c * n + g] = __fdiv_rn(
            __fsub_rn(em, es), __fadd_rn(__fadd_rn(em, es), 1e-9f));
    }
}

}  // namespace

// audio [C, n]; atail [C, halo]; mark_cos, mark_sin, space_cos, space_sin
// [halo + n] (device; entry halo + P for position P); soft [C, n].
SONDETPU_API int sondetpu_afsk_frontend(
    const float* audio, const float* atail, const float* mark_cos,
    const float* mark_sin, const float* space_cos, const float* space_sin,
    int win, float inv_win, int C, int n, int halo, float* soft,
    void* stream) {
    if (win < 2 || win - 1 > halo || C < 1 || n < 1)
        return (int)cudaErrorInvalidValue;
    const size_t shm = sizeof(float) * 4 * (TILE + win - 1);
    if (shm > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + TILE - 1) / TILE, C);
    afsk_kernel<<<grid, THREADS, shm, (cudaStream_t)stream>>>(
        audio, atail, mark_cos, mark_sin, space_cos, space_sin, win, inv_win,
        n, halo, soft);
    return (int)cudaGetLastError();
}
