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
// TFLOP per 4-s block at N = 2048: tens of ms in f32 on the CUDA cores. An
// FFT per row does ~5*N*log2(N) flops (~22 GFLOP per block), so the 6.3 GB
// of traffic (two planes in, two out) sets the floor, ~1.9 ms at 3.35 TB/s.
//
// N = 2048 (the fleet's PFB) has a body of its own, dft2048_kernel: a
// block takes 8 time rows with 128 threads each, and every thread holds 16
// complex points in registers. 2048 = 16 x 16 x 8: pass 1 reads
// u[r, t + 128 s] straight from device memory (coalesced, all loads in
// flight at once) and takes the 16-point DFT over s, times exp(-2 pi i t
// k1 / 2048); pass 2 the 16-point DFT over t2 of t = t1 + 8 t2, times
// exp(-2 pi i t1 k2 / 128); pass 3 two 8-point DFTs over t1. Shared memory
// carries only the two exchanges between passes (padded so that every
// access of a warp hits 32 distinct banks) and the transposed [N, 8] tile
// of the store, where consecutive threads write consecutive rows r of one
// channel (32-byte runs). That is 6 shared passes per row against 16 for
// the radix-2 body below, and one memory latency per tile instead of one
// per element. Shared memory 155.6 KB, 1024 threads: one block per SM.
//
// Other N (8 to 4096, powers of two) take pfb_dft_kernel: each thread block
// takes a strip of TM time rows, loads them coalesced along j into shared
// memory in bit-reversed order, runs the log2(N) in-place radix-2 stages
// there in fused pairs (four elements per thread in registers), and writes
// the transposed [N, TM] tile. Shared index i is stored at i + i/32, and
// rows are N + N/32 + 1 floats apart, which keeps the bit-reversed stores
// and the transposed reads to at most 2-way bank conflicts.
//
// Twiddles come from a table built on the host in f64 and rounded once to
// f32 (never __sinf/__cosf), staged in shared memory; the 16- and 8-point
// DFTs use f32 literals of the same values. Everything is f32.
//
// With bf16 set, u and y are bfloat16: each u value is widened to float32
// on its load, the FFT runs in float32 as above, and each y value is
// rounded to bfloat16 once, on its store. That is the Pallas DFT's bf16
// form (bfloat16 operands, float32 accumulation, one rounding on the
// store) with the FFT's order of operations.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
// time rows per block: TM * N ~ 16384 floats per plane (TM = 8 at N =
// 2048), so each channel's store is TM consecutive floats: at TM >= 8 a
// full 32-byte sector.
constexpr int SMEM_FLOATS = 16384;

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T>
__global__ void __launch_bounds__(THREADS) pfb_dft_kernel(
    const T* __restrict__ ui, const T* __restrict__ uq,
    const float* __restrict__ twc, const float* __restrict__ tws,
    const int m, const int n, const int logn, const int tm,
    T* __restrict__ yi, T* __restrict__ yq) {
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
    const T* pi = ui + r0 * n;
    const T* pq = uq + r0 * n;
    for (int e = threadIdx.x; e < rows * n; e += THREADS) {
        const int row = e >> logn;
        const int j = e & (n - 1);
        const int jr = __brev((unsigned)j) >> (32 - logn);
        re[row * stride + pad(jr)] = to_f32(pi[e]);
        im[row * stride + pad(jr)] = to_f32(pq[e]);
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
        yi[o] = from_f32<T>(re[row * stride + pad(k)]);
        yq[o] = from_f32<T>(im[row * stride + pad(k)]);
    }
}

int rows_per_block(int n) {
    int tm = SMEM_FLOATS / n;
    return tm < 1 ? 1 : (tm > 64 ? 64 : tm);
}

// --- N = 2048: three register passes ----------------------------------------

constexpr int N2K = 2048;
constexpr int ROWS2K = 8;                 // time rows per block
constexpr int RT = 128;                   // threads per row
constexpr int ABUF = 16 * 136;            // per-row exchange buffer, floats
constexpr int TBUF = N2K * (ROWS2K + 1);  // transposed tile [N][rows + 1]
constexpr int SMEM2K = 2 * TBUF + N2K;    // >= 2 * ROWS2K * ABUF, + twiddles

// cos and sin of 2 pi e / 16 for e < 8
__device__ __forceinline__ void w16(const int e, float& c, float& s) {
    switch (e) {
        case 1: c = 0.923879533f; s = 0.382683432f; break;
        case 2: c = 0.707106781f; s = 0.707106781f; break;
        case 3: c = 0.382683432f; s = 0.923879533f; break;
        case 5: c = -0.382683432f; s = 0.923879533f; break;
        case 6: c = -0.707106781f; s = 0.707106781f; break;
        case 7: c = -0.923879533f; s = 0.382683432f; break;
        default: c = 1.0f; s = 0.0f; break;      // e = 0 and 4 are special
    }
}

// x *= exp(-2 pi i e / L), L = 8 or 16, e < L / 2
template <int L>
__device__ __forceinline__ void rotate(const int e, float& xr, float& xi) {
    if (e == 0) return;
    if (4 * e == L) {                             // times -i
        const float t = xr;
        xr = xi;
        xi = -t;
        return;
    }
    float c, s;
    w16(e * (16 / L), c, s);
    const float tr = xr * c + xi * s;
    xi = xi * c - xr * s;
    xr = tr;
}

// radix-2 stages of half size H, 2H, ... < L on re[OFF .. OFF + L): one
// template level per stage, so every loop has constant bounds and unrolls,
// and every index is a constant (a register array indexed at run time goes
// to local memory)
template <int L, int OFF, int H, int M>
__device__ __forceinline__ void dft_stages(float (&re)[M], float (&im)[M]) {
    if constexpr (H < L) {
#pragma unroll
        for (int b = OFF; b < OFF + L; b += 2 * H) {
#pragma unroll
            for (int k = 0; k < H; ++k) {
                float tr = re[b + k + H], ti = im[b + k + H];
                rotate<L>(k * (L / (2 * H)), tr, ti);
                re[b + k + H] = re[b + k] - tr;
                im[b + k + H] = im[b + k] - ti;
                re[b + k] += tr;
                im[b + k] += ti;
            }
        }
        dft_stages<L, OFF, 2 * H>(re, im);
    }
}

// in-register radix-2 DFT (sign -1) of the L = 8 or 16 points
// re[OFF .. OFF + L), natural order
template <int L, int OFF = 0, int M>
__device__ __forceinline__ void dft_reg(float (&re)[M], float (&im)[M]) {
#pragma unroll
    for (int i = 0; i < L; ++i) {
        const int r = L == 8 ? ((i & 1) << 2) | (i & 2) | ((i & 4) >> 2)
                             : ((i & 1) << 3) | ((i & 2) << 1) |
                                   ((i & 4) >> 1) | ((i & 8) >> 3);
        if (r > i) {
            const float a = re[OFF + i], b = im[OFF + i];
            re[OFF + i] = re[OFF + r];
            im[OFF + i] = im[OFF + r];
            re[OFF + r] = a;
            im[OFF + r] = b;
        }
    }
    dft_stages<L, OFF, 1>(re, im);
}

// x *= exp(-2 pi i e / 2048), e < 2048, from the half table of cos and sin
__device__ __forceinline__ void rotate2k(const float* wc, const float* ws,
                                         const int e, float& xr, float& xi) {
    const int x = e & (N2K / 2 - 1);
    float c = wc[x], s = ws[x];
    if (e >= N2K / 2) {
        c = -c;
        s = -s;
    }
    const float tr = xr * c + xi * s;
    xi = xi * c - xr * s;
    xr = tr;
}

template <typename T>
__global__ void __launch_bounds__(ROWS2K * RT, 1)   // 64 registers a thread
dft2048_kernel(
    const T* __restrict__ ui, const T* __restrict__ uq,
    const float* __restrict__ twc, const float* __restrict__ tws,
    const int m, T* __restrict__ yi, T* __restrict__ yq) {
    extern __shared__ float smem[];
    const int row = threadIdx.x / RT;
    const int j = threadIdx.x % RT;
    const long r0 = (long)blockIdx.x * ROWS2K;
    const bool live = r0 + row < m;
    float* are = smem + row * ABUF;               // pass exchanges
    float* aim = smem + (ROWS2K + row) * ABUF;
    float* tre = smem;                            // the transposed tile
    float* tim = smem + TBUF;
    float* wc = smem + 2 * TBUF;
    float* ws = wc + N2K / 2;

    // pass 1: thread j holds u[r, j + 128 s], s < 16
    float xr[16], xi[16];
    const size_t base = (size_t)(live ? r0 + row : 0) * N2K + j;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        xr[s] = live ? to_f32(ui[base + RT * s]) : 0.0f;
        xi[s] = live ? to_f32(uq[base + RT * s]) : 0.0f;
    }
    for (int x = threadIdx.x; x < N2K / 2; x += ROWS2K * RT) {
        wc[x] = twc[x];
        ws[x] = tws[x];
    }
    __syncthreads();
    dft_reg<16>(xr, xi);
#pragma unroll
    for (int k1 = 1; k1 < 16; ++k1) rotate2k(wc, ws, j * k1, xr[k1], xi[k1]);
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {           // A[t = j][k1]
        are[k1 * 136 + j] = xr[k1];
        aim[k1 * 136 + j] = xi[k1];
    }
    __syncthreads();

    // pass 2: (t1, k1) = (j % 8, j / 8) takes A[t1 + 8 t2][k1], t2 < 16
    const int t1 = j & 7, k1 = j >> 3;
#pragma unroll
    for (int t2 = 0; t2 < 16; ++t2) {
        xr[t2] = are[k1 * 136 + t1 + 8 * t2];
        xi[t2] = aim[k1 * 136 + t1 + 8 * t2];
    }
    __syncthreads();                            // B overwrites A
    dft_reg<16>(xr, xi);
#pragma unroll
    for (int k2 = 1; k2 < 16; ++k2)
        rotate2k(wc, ws, 16 * t1 * k2, xr[k2], xi[k2]);
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {           // B[t1][g = k1 + 16 k2]
        are[t1 * 260 + k1 + 16 * k2] = xr[k2];
        aim[t1 * 260 + k1 + 16 * k2] = xi[k2];
    }
    __syncthreads();

    // pass 3: groups g = j and j + 128, 8 points over t1 each;
    // y[g + 256 k3] for k3 < 8
#pragma unroll
    for (int t = 0; t < 16; ++t) {              // x[8 h + t1] of group j + 128 h
        xr[t] = are[(t & 7) * 260 + j + RT * (t >> 3)];
        xi[t] = aim[(t & 7) * 260 + j + RT * (t >> 3)];
    }
    dft_reg<8, 0>(xr, xi);
    dft_reg<8, 8>(xr, xi);
    __syncthreads();                            // the tile overwrites B
#pragma unroll
    for (int t = 0; t < 16; ++t) {
        const int k = j + RT * (t >> 3) + 256 * (t & 7);
        tre[k * (ROWS2K + 1) + row] = xr[t];
        tim[k * (ROWS2K + 1) + row] = xi[t];
    }
    __syncthreads();

    // y[k, r0 + rr]: consecutive threads take consecutive rows of one k
#pragma unroll 4
    for (int e = threadIdx.x; e < N2K * ROWS2K; e += ROWS2K * RT) {
        const int k = e / ROWS2K, rr = e % ROWS2K;
        if (r0 + rr < m) {
            const size_t o = (size_t)k * m + r0 + rr;
            yi[o] = from_f32<T>(tre[k * (ROWS2K + 1) + rr]);
            yq[o] = from_f32<T>(tim[k * (ROWS2K + 1) + rr]);
        }
    }
}

template <typename T>
int launch_2048(const T* ui, const T* uq, const float* twc, const float* tws,
                int m, T* yi, T* yq, cudaStream_t stream) {
    const size_t shm = sizeof(float) * SMEM2K;
    cudaError_t err = cudaFuncSetAttribute(
        dft2048_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const long blocks = ((long)m + ROWS2K - 1) / ROWS2K;
    if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
    dft2048_kernel<T><<<(unsigned)blocks, ROWS2K * RT, shm, stream>>>(
        ui, uq, twc, tws, m, yi, yq);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dft(const void* ui_, const void* uq_, const float* twc,
               const float* tws, int m, int n, int logn, void* yi_,
               void* yq_, cudaStream_t stream) {
    const T* ui = static_cast<const T*>(ui_);
    const T* uq = static_cast<const T*>(uq_);
    T* yi = static_cast<T*>(yi_);
    T* yq = static_cast<T*>(yq_);
    if (n == N2K) return launch_2048<T>(ui, uq, twc, tws, m, yi, yq, stream);
    const int tm = rows_per_block(n);
    const size_t shm =
        sizeof(float) * ((size_t)2 * tm * (n + (n >> 5) + 1) + n);
    cudaError_t err = cudaFuncSetAttribute(
        pfb_dft_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const long blocks = ((long)m + tm - 1) / tm;
    if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
    pfb_dft_kernel<T><<<(unsigned)blocks, THREADS, shm, stream>>>(
        ui, uq, twc, tws, m, n, logn, tm, yi, yq);
    return (int)cudaGetLastError();
}

}  // namespace

// u_i, u_q [m, n]; twc, tws [n/2] = cos, sin(2 pi x / n) (device, float32);
// y_i, y_q [n, m]; u and y float32, or bfloat16 when bf16 is set. N = 2048
// runs dft2048_kernel, other N pfb_dft_kernel.
SONDETPU_API int sondetpu_pfb_dft(
    const void* ui, const void* uq, const float* twc, const float* tws,
    int m, int n, int bf16, void* yi, void* yq, void* stream) {
    int logn = 0;
    while ((1 << logn) < n) ++logn;
    if (n < 8 || n > 4096 || (1 << logn) != n || m < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return launch_dft<__nv_bfloat16>(ui, uq, twc, tws, m, n, logn, yi, yq,
                                         s);
    return launch_dft<float>(ui, uq, twc, tws, m, n, logn, yi, yq, s);
}
