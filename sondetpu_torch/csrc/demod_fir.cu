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
// What bounds it: device memory and the row-wide DC. The DC needs the
// whole row before any output, and at [2048, 96000] a row's audio (384 KB)
// does not fit in shared memory. Design: one thread block per row, as the
// TPU kernel's (8, n) block; pass 1 writes the raw audio into the filt
// buffer and sums it, pass 2 walks the row in tiles, stages the tile's
// DC-removed audio after the T - 1 samples of history carried in shared
// memory from the tile before (initially the audio tail), and overwrites
// the tile with its FIR output. Traffic is the two input planes once and
// the row three times (write, read, write): ~3.9 GB at that shape, ~1.2 ms
// at 3.35 TB/s; the 41 shared loads per output add ~1.1 ms.
//
// Every product and sum of the discriminator and the FIR is rounded on its
// own (__fmul_rn/__fadd_rn, no FMA contraction) in the order of the plain
// twin (sondetpu_torch/kernels/frontend.py:fused_demod_fir_plain); only the
// order of the DC sum differs from torch.mean.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int TILE = 1024;

__global__ void __launch_bounds__(THREADS) demod_fir_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ prev, const float* __restrict__ atail,
    const Taps hm, const int T, const float scale, const int dc_block,
    const int n, float* __restrict__ filt, float* __restrict__ tail_out) {
    __shared__ float ap[TILE + SONDETPU_MAX_TAPS - 1];
    __shared__ float warp_sums[THREADS / 32];
    __shared__ float dc_s;
    const int c = blockIdx.x;
    const int h = T - 1;
    const float* row_i = xi + (size_t)c * n;
    const float* row_q = xq + (size_t)c * n;
    float* out = filt + (size_t)c * n;

    // pass 1: the discriminator audio into `out`, and its row sum
    float s = 0.0f;
    for (int g = threadIdx.x; g < n; g += THREADS) {
        const float i = row_i[g], q = row_q[g];
        const float ip = g ? row_i[g - 1] : prev[2 * c];
        const float qp = g ? row_q[g - 1] : prev[2 * c + 1];
        const float dre = __fadd_rn(__fmul_rn(i, ip), __fmul_rn(q, qp));
        const float dim = __fsub_rn(__fmul_rn(q, ip), __fmul_rn(i, qp));
        const float a = __fmul_rn(fast_atan2(dim, dre), scale);
        out[g] = a;
        s += a;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.0f;
        for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
        dc_s = dc_block ? __fdiv_rn(tot, (float)n) : 0.0f;
    }
    __syncthreads();
    const float dc = dc_s;

    // the next block's tail, read before pass 2 overwrites the audio; the
    // tile loop's history starts as the carried tail
    for (int j = threadIdx.x; j < h; j += THREADS) {
        tail_out[(size_t)c * h + j] = __fsub_rn(out[n - h + j], dc);
        ap[j] = atail[(size_t)c * h + j];
    }
    __syncthreads();

    // pass 2: ap[j] holds a at position g0 - h + j
    for (int g0 = 0; g0 < n; g0 += TILE) {
        for (int j = threadIdx.x; j < TILE; j += THREADS) {
            const int g = g0 + j;
            ap[h + j] = g < n ? __fsub_rn(out[g], dc) : 0.0f;
        }
        __syncthreads();
        float acc[TILE / THREADS];
        for (int r = 0; r < TILE / THREADS; ++r) {
            const float* pa = ap + threadIdx.x + r * THREADS + h;
            float y = 0.0f;
            for (int k = 0; k < T; ++k)
                y = __fadd_rn(y, __fmul_rn(hm.h[k], pa[-k]));
            acc[r] = y;
        }
        __syncthreads();                     // every thread has read ap
        for (int r = 0; r < TILE / THREADS; ++r) {
            const int g = g0 + threadIdx.x + r * THREADS;
            if (g < n) out[g] = acc[r];
        }
        // history of the next tile: the last h staged positions
        for (int j = threadIdx.x; j < h; j += THREADS) ap[j] = ap[TILE + j];
        __syncthreads();
    }
}

}  // namespace

// xi, xq [C, n]; prev [C, 2]; atail [C, T - 1]; hm: host array of T taps;
// filt [C, n]; tail_out [C, T - 1].
SONDETPU_API int sondetpu_demod_fir(const float* xi, const float* xq,
                                    const float* prev, const float* atail,
                                    const float* hm, int T, float scale,
                                    int dc_block, int C, int n, float* filt,
                                    float* tail_out, void* stream) {
    if (T < 2 || T > SONDETPU_MAX_TAPS || C < 1 || n < T - 1)
        return (int)cudaErrorInvalidValue;
    Taps th{};
    for (int k = 0; k < T; ++k) th.h[k] = hm[k];
    demod_fir_kernel<<<C, THREADS, 0, (cudaStream_t)stream>>>(
        xi, xq, prev, atail, th, T, scale, dc_block, n, filt, tail_out);
    return (int)cudaGetLastError();
}
