// The PFB's DFT across branches, written channel-major.
//
// Replaces sondetpu/pallas/pfb.py:pfb_dft_perm (body _dft_kernel). It
// computes the same function in natural channel order:
//   y[k, r] = sum_j u[r, j] * exp(-2 pi i j k / N)      (I/Q planes)
// for u [m, N] and y [N, m]. The TPU kernel's dft_perm row order existed so
// that the fleet's row gather absorbed it; the port has no use for it.
//
// What bounds it: device memory. The TPU form (GR-point adds, then GR
// [TM, L] x [L, L] matrix products) does 4*N*L real MACs per row, ~1.6
// TFLOP per 4-s block at N = 2048: tens of ms in f32 on the CUDA cores. A
// radix-2 FFT per row does ~5*N*log2(N) flops (~22 GFLOP per block), so the
// 6.3 GB of traffic (two planes in, two out) sets the floor, ~1.9 ms at
// 3.35 TB/s. Design: each thread block takes a strip of TM time rows,
// loads them coalesced along j into shared memory in bit-reversed order,
// runs the log2(N) in-place radix-2 stages there in fused pairs (four
// elements per thread in registers), and writes the transposed
// [N, TM] tile so that consecutive threads store consecutive rows r of one
// channel. Shared index i is stored at i + i/32, and rows are
// N + N/32 + 1 floats apart, which keeps the bit-reversed stores and the
// transposed reads to at most 2-way bank conflicts. Twiddles come from a
// table built on the host in f64 and rounded once to f32 (never
// __sinf/__cosf), staged in shared memory. Everything is f32.
//
// Covers power-of-two N from 8 to 4096; the wrapper raises for any other N.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
// time rows per block: TM * N ~ 16384 floats per plane, 143 KB of shared
// memory at N = 2048 (TM = 8), so one block fills an SM. Each channel's
// store is then TM consecutive floats: at TM = 8 a full 32-byte sector.
// At [192000, 2048] this measured 6.8 ms, against 9.9 ms with TM = 4 and
// 512 threads (H100 80GB HBM3, 700 W).
constexpr int SMEM_FLOATS = 16384;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(THREADS) pfb_dft_kernel(
    const float* __restrict__ ui, const float* __restrict__ uq,
    const float* __restrict__ twc, const float* __restrict__ tws,
    const int m, const int n, const int logn, const int tm,
    float* __restrict__ yi, float* __restrict__ yq) {
    extern __shared__ float smem[];
    const int stride = n + (n >> 5) + 1;
    float* re = smem;                       // [tm][stride]
    float* im = re + tm * stride;           // [tm][stride]
    float* wc = im + tm * stride;           // [n / 2]
    float* ws = wc + n / 2;                 // [n / 2]
    const long r0 = (long)blockIdx.x * tm;
    const int rows = (int)((long)m - r0 < tm ? (long)m - r0 : tm);
    const int half = n >> 1;

    for (int x = threadIdx.x; x < half; x += THREADS) {
        wc[x] = twc[x];
        ws[x] = tws[x];
    }
    const float* pi = ui + r0 * n;
    const float* pq = uq + r0 * n;
    for (int e = threadIdx.x; e < rows * n; e += THREADS) {
        const int row = e >> logn;
        const int j = e & (n - 1);
        const int jr = __brev((unsigned)j) >> (32 - logn);
        re[row * stride + pad(jr)] = pi[e];
        im[row * stride + pad(jr)] = pq[e];
    }
    __syncthreads();

    // radix-2 decimation in time on bit-reversed input: the stage of half
    // size h combines (i0, i0 + h) in groups of 2h with the twiddle
    // exp(-2 pi i k / (2h)) = wc[k*N/(2h)] - i ws[k*N/(2h)]. Stages run in
    // fused pairs (h, 2h) on four elements held in registers, which halves
    // the passes over shared memory; an odd log2(N) starts with one single
    // stage of h = 1.
    int lh = 0;
    if (logn & 1) {
        for (int b = threadIdx.x; b < rows * half; b += THREADS) {
            const int row = b >> (logn - 1);
            const int i0 = (b & (half - 1)) << 1;
            const int a0 = row * stride + pad(i0);
            const int a1 = row * stride + pad(i0 + 1);
            const float ar = re[a0], aq = im[a0], br = re[a1], bq = im[a1];
            re[a0] = ar + br;
            im[a0] = aq + bq;
            re[a1] = ar - br;
            im[a1] = aq - bq;
        }
        __syncthreads();
        lh = 1;
    }
    const int quarter = n >> 2;
    for (; lh < logn; lh += 2) {
        const int h = 1 << lh;
        const int s2 = half >> lh;          // twiddle stride of stage h
        const int s4 = s2 >> 1;             // and of stage 2h
        for (int b = threadIdx.x; b < rows * quarter; b += THREADS) {
            const int row = b >> (logn - 2);
            const int bi = b & (quarter - 1);
            const int k = bi & (h - 1);
            const int i0 = ((bi >> lh) << (lh + 2)) | k;
            const int base = row * stride;
            const int a0 = base + pad(i0), a1 = base + pad(i0 + h);
            const int a2 = base + pad(i0 + 2 * h);
            const int a3 = base + pad(i0 + 3 * h);
            float x0r = re[a0], x0q = im[a0], x1r = re[a1], x1q = im[a1];
            float x2r = re[a2], x2q = im[a2], x3r = re[a3], x3q = im[a3];
            // stage h: (x0, x1) and (x2, x3), twiddle index k
            float c = wc[k * s2], s = ws[k * s2];
            float tr = c * x1r + s * x1q, tq = c * x1q - s * x1r;
            x1r = x0r - tr; x1q = x0q - tq; x0r = x0r + tr; x0q = x0q + tq;
            tr = c * x3r + s * x3q; tq = c * x3q - s * x3r;
            x3r = x2r - tr; x3q = x2q - tq; x2r = x2r + tr; x2q = x2q + tq;
            // stage 2h: (x0, x2) with twiddle index k, (x1, x3) with k + h
            c = wc[k * s4]; s = ws[k * s4];
            tr = c * x2r + s * x2q; tq = c * x2q - s * x2r;
            re[a0] = x0r + tr; im[a0] = x0q + tq;
            re[a2] = x0r - tr; im[a2] = x0q - tq;
            c = wc[(k + h) * s4]; s = ws[(k + h) * s4];
            tr = c * x3r + s * x3q; tq = c * x3q - s * x3r;
            re[a1] = x1r + tr; im[a1] = x1q + tq;
            re[a3] = x1r - tr; im[a3] = x1q - tq;
        }
        __syncthreads();
    }

    // y[k, r0 + row]: consecutive threads take consecutive rows of one k
    for (int e = threadIdx.x; e < rows * n; e += THREADS) {
        const int k = e / rows;
        const int row = e - k * rows;
        const size_t o = (size_t)k * m + r0 + row;
        yi[o] = re[row * stride + pad(k)];
        yq[o] = im[row * stride + pad(k)];
    }
}

int rows_per_block(int n) {
    int tm = SMEM_FLOATS / n;
    return tm < 1 ? 1 : (tm > 64 ? 64 : tm);
}

}  // namespace

// u_i, u_q [m, n]; twc, tws [n/2] = cos, sin(2 pi x / n) (device);
// y_i, y_q [n, m].
SONDETPU_API int sondetpu_pfb_dft(
    const float* ui, const float* uq, const float* twc, const float* tws,
    int m, int n, float* yi, float* yq, void* stream) {
    int logn = 0;
    while ((1 << logn) < n) ++logn;
    if (n < 8 || n > 4096 || (1 << logn) != n || m < 1)
        return (int)cudaErrorInvalidValue;
    const int tm = rows_per_block(n);
    const size_t shm =
        sizeof(float) * ((size_t)2 * tm * (n + (n >> 5) + 1) + n);
    cudaError_t err = cudaFuncSetAttribute(
        pfb_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const long blocks = ((long)m + tm - 1) / tm;
    if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
    pfb_dft_kernel<<<(unsigned)blocks, THREADS, shm, (cudaStream_t)stream>>>(
        ui, uq, twc, tws, m, n, logn, tm, yi, yq);
    return (int)cudaGetLastError();
}
