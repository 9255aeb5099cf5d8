// Syncword correlator: corr[c, i] = (sum_k t[k] * buf[c, i + k]) * (1/L).
//
// Replaces sondetpu/pallas/corr.py:corr_kernel (body _kernel). The main
// template and any alternate templates go through this same kernel.
//
// What bounds it: at 2048 channels x 21760 chips the chip buffer is 178 MB
// read and the output 178 MB written, against 2 x 64 flops per output; the
// L-fold reuse of each input is kept on chip, so the bytes cost ~0.1 ms and
// the shared-memory loads (two per multiply-add) bound it: 0.54-0.60 ms on
// an H100 80GB HBM3 (700 W).
// Design: one thread block per (channel, tile of TILE outputs); the tile and
// its L-1 halo, and the template, sit in shared memory; neighbouring
// threads take neighbouring outputs. One launch covers the whole buffer
// (the TPU kernel's loop of time-chunk launches bounded VMEM, which a
// shared-memory tile does by construction).
//
// Products and sums are rounded one at a time (no FMA contraction) in
// ascending k, the order of the plain twin
// (sondetpu_torch/kernels/corr.py:corr_plain), so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) corr_kernel(
    const float* __restrict__ buf, const float* __restrict__ tmpl,
    const int L, const int buf_len, const float inv_l,
    float* __restrict__ out) {
    extern __shared__ float smem[];
    float* ts = smem;             // [L]
    float* xs = smem + L;         // [TILE + L - 1]
    const int c = blockIdx.y;
    const int i0 = blockIdx.x * TILE;
    const int n_out = buf_len - L + 1;
    const float* row = buf + (size_t)c * buf_len;
    for (int k = threadIdx.x; k < L; k += THREADS) ts[k] = tmpl[k];
    for (int j = threadIdx.x; j < TILE + L - 1; j += THREADS) {
        const int gi = i0 + j;
        xs[j] = gi < buf_len ? row[gi] : 0.0f;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
        const int i = i0 + t;
        if (i >= n_out) break;
        float acc = 0.0f;
        for (int k = 0; k < L; ++k)
            acc = __fadd_rn(acc, __fmul_rn(ts[k], xs[t + k]));
        out[(size_t)c * n_out + i] = __fmul_rn(acc, inv_l);
    }
}

}  // namespace

// buf [C, buf_len] f32, tmpl [L] f32 (device) -> out [C, buf_len - L + 1];
// inv_l is float32(1/L) as the caller rounds it.
SONDETPU_API int sondetpu_corr(const float* buf, const float* tmpl, int L,
                               float inv_l, int C, int buf_len, float* out,
                               void* stream) {
    if (L < 1 || L > 2048 || buf_len < L || C < 1)
        return (int)cudaErrorInvalidValue;
    const int n_out = buf_len - L + 1;
    const dim3 grid((n_out + TILE - 1) / TILE, C);
    const size_t shm = sizeof(float) * (TILE + 2 * L - 1);
    corr_kernel<<<grid, THREADS, shm, (cudaStream_t)stream>>>(
        buf, tmpl, L, buf_len, inv_l, out);
    return (int)cudaGetLastError();
}
