// The PFB's DFT across branches, written channel-major.
//
// Replaces sondetpu/pallas/pfb.py:pfb_dft_perm (body _dft_kernel). It
// computes the same function in natural channel order:
//   y[k, r] = sum_j u[r, j] * exp(-2 pi i j k / N)      (I/Q planes)
// for u [m, N] and y [N, m]. The TPU kernel's dft_perm row order existed so
// that the fleet's row gather absorbed it; the port has no use for it.
//
// The TPU form (GR-point adds, then GR [TM, L] x [L, L] matrix products)
// does 4*N*L real MACs per row, ~1.6 TFLOP per 4-s block at N = 2048: tens
// of ms in f32 on the CUDA cores. An FFT per row does ~5*N*log2(N) flops
// (~22 GFLOP per block), so device memory sets the floor: 6.3 GB in f32
// (two planes in, two out), ~1.9 ms at 3.35 TB/s, and 3.1 GB in bf16, ~0.94
// ms.
//
// N = 2048 (the fleet's PFB) has two bodies of their own. Both split 2048
// = 16 x 16 x 8 over 128 threads a time row, each thread holding 16
// complex points in registers: pass 1 takes the 16-point DFT over s of
// u[r, t + 128 s] (t the thread), times exp(-2 pi i t k1 / 2048); pass 2
// the 16-point DFT over t2 of t = t1 + 8 t2, times exp(-2 pi i t1 k2 /
// 128); pass 3 two 8-point DFTs over t1. Shared memory carries the two
// exchanges between passes and the transposed tile of the store. 8 rows
// of 128 threads at 64 registers fill an SM's registers, so one block of
// 1024 threads runs on an SM.
//
// dft2048_kernel (float32) takes one 8-row tile a block in
// strict phases: loads straight into registers, the passes (exchanges
// padded to 136 and 260 words a row), the transposed [N][8 + 1] tile and
// its store of 32 bytes a channel. Nothing overlaps a block's memory
// traffic with its passes.
//
// dft2048_bf16_kernel reads and writes bfloat16 (each u widened on its
// load, the transform in float32, each y rounded to bfloat16 once, on its
// way into the store tile). Run in bf16, the float32 body's design spends
// most of its time in its 2-byte stores of 16 contiguous bytes a channel,
// and the rest in its phases one after another (PERF.md), so this body:
// - is persistent: one block per SM, in clusters of two, walks the 16-row
//   tiles t, t + clusters, ...; a thread of each time row moves the row's
//   next input (8 KB, both planes) into shared memory by two bulk copies
//   (TMA) that complete on the row's mbarrier as soon as the row's pass 1
//   has read the current one, so the loads run under passes 2 and 3 and
//   the store. The rows meet only where they share memory: the passes'
//   exchanges are row-local (a named barrier of 128 threads), and the
//   block and cluster barriers come once a tile each around the store;
// - trades its outputs inside the cluster: block b stores channels
//   [1024 b, 1024 b + 1024) for all 16 rows of the cluster's tile, so each
//   block writes its 8 rows of those channels, rounded to bf16, into the
//   owner's [plane][16 rows][1024] store tile, its own or the peer's
//   through distributed shared memory (64 contiguous bytes a warp), and
//   after a cluster barrier stores 32 contiguous bytes a channel: 8 lanes
//   of 4 bytes a channel, 4 channels a warp store (2-byte stores where
//   m % 8 != 0 or the tile is ragged; a block without rows still reaches
//   every cluster barrier). Wider stores that span more channels a warp,
//   and reading the peer's tile instead of writing it, measured slower;
// - reads its twiddles without bank conflicts: pass 1's from a [k1][t]
//   table (lane t reads word t), pass 2's from [k2][t1] (the 8 t1 of a
//   warp, 8 words), both built in shared memory from the host's table;
// - keeps the exchange in place and unpadded: A[k1][t] sits at column t
//   XOR f(k1) of row k1, which puts every pass's accesses on 32 distinct
//   banks, and pass 2 writes its outputs over the 16 words it read, so it
//   needs no barrier between its reads and writes.
// What bounds it then (PERF.md): the passes, their exchanges and the
// output trade, issued at 64 registers a thread with some spilled, take
// about as long as the float32 body's passes (~1.6 ms at [192000, 2048]);
// the stores, ~1.3 ms alone, overlap them only in part, as a block issues
// all of a tile's stores at once after the cluster barrier; the loads
// hide under them.
//
// Other N (8 to 4096, powers of two) take pfb_dft_kernel: each thread block
// takes a strip of TM time rows, loads them coalesced along j into shared
// memory in bit-reversed order, runs the log2(N) in-place radix-2 stages
// there in fused pairs (four elements per thread in registers), and writes
// the transposed [N, TM] tile. Shared index i is stored at i + i/32, and
// rows are N + N/32 + 1 floats apart, which keeps the bit-reversed stores
// and the transposed reads to at most 2-way bank conflicts. With bf16 set,
// u and y are bfloat16, widened on the load and rounded once on the store.
//
// Twiddles come from a table built on the host in f64 and rounded once to
// f32 (never __sinf/__cosf); the 16- and 8-point DFTs use f32 literals of
// the same values. The arithmetic is f32 in every body: the Pallas DFT's
// bf16 form (bfloat16 operands, float32 accumulation, one rounding on the
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
constexpr int ABUF = 16 * 136;            // f32: per-row exchange, floats
constexpr int TBUF = N2K * (ROWS2K + 1);  // f32: transposed tile [N][rows + 1]
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


// --- N = 2048, float32: one 8-row tile a block ----------------------------

__global__ void __launch_bounds__(ROWS2K * RT, 1)   // 64 registers a thread
dft2048_kernel(
    const float* __restrict__ ui, const float* __restrict__ uq,
    const float* __restrict__ twc, const float* __restrict__ tws,
    const int m, float* __restrict__ yi, float* __restrict__ yq) {
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
        xr[s] = live ? ui[base + RT * s] : 0.0f;
        xi[s] = live ? uq[base + RT * s] : 0.0f;
    }
    for (int x = threadIdx.x; x < N2K / 2; x += ROWS2K * RT) {
        wc[x] = twc[x];
        ws[x] = tws[x];
    }
    __syncthreads();
    dft_reg<16>(xr, xi);
#pragma unroll
    for (int k1 = 1; k1 < 16; ++k1)
        rotate2k(wc, ws, j * k1, xr[k1], xi[k1]);
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {       // A[t = j][k1]
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
    __syncthreads();                        // B overwrites A
    dft_reg<16>(xr, xi);
#pragma unroll
    for (int k2 = 1; k2 < 16; ++k2)
        rotate2k(wc, ws, 16 * t1 * k2, xr[k2], xi[k2]);
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {       // B[t1][g = k1 + 16 k2]
        are[t1 * 260 + k1 + 16 * k2] = xr[k2];
        aim[t1 * 260 + k1 + 16 * k2] = xi[k2];
    }
    __syncthreads();

    // pass 3: groups g = j and j + 128, 8 points over t1 each;
    // y[g + 256 k3] for k3 < 8
#pragma unroll
    for (int t = 0; t < 16; ++t) {  // x[8 h + t1] of group j + 128 h
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
            yi[o] = tre[k * (ROWS2K + 1) + rr];
            yq[o] = tim[k * (ROWS2K + 1) + rr];
        }
    }
}

// --- N = 2048, bfloat16: persistent 2-block clusters ----------------------

// shared memory of dft2048_bf16_kernel, bytes: the exchange of both planes
// (float32; the bf16 store tile over it), the input tile (bf16, both
// planes), the twiddle tables of passes 1 and 2, an mbarrier a row of the
// input tile
constexpr int BF_X = 2 * ROWS2K * N2K * 4;
constexpr int BF_IN = 2 * ROWS2K * N2K * 2;
constexpr int BF_TW1 = 15 * RT * 8;
constexpr int BF_TW2 = 15 * 8 * 8;
constexpr int BF_SMEM = BF_X + BF_IN + BF_TW1 + BF_TW2 + 8 * ROWS2K;
// blocks a cluster: its tile is CL x 8 rows, and block b stores channels
// [b N / CL, (b + 1) N / CL) of them, 32 contiguous bytes a channel
constexpr int CL = 2;
constexpr int CH = N2K / CL;                      // channels a block stores
// the store tile of a block: [plane][16 rows][CH channels] bf16, rows
// SROW apart (514 words: the store phase's reads of a warp, rows 2 li < 16
// of 4 channel pairs, hit 32 banks), planes SPLANE apart (16 banks on: a
// warp writes both planes at once)
constexpr int SROW = 2 * CH + 8;                  // bytes
constexpr int SPLANE = ROWS2K * CL * SROW + 64;
static_assert(2 * SPLANE <= BF_X, "the store tile lies over the exchange");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the column of A[k1][t] in its exchange row: t XOR f(k1), with f mapping
// k1's bits (b3 b2 b1 b0) to (b0 b1 b3 b2 b1), which puts the accesses of
// all three passes on 32 distinct banks (pass 1: 32 t of one k1; pass 2:
// 8 t1 x 4 k1; pass 3: 16 k1 x 2 t)
__device__ __forceinline__ int swz(const int k1, const int t) {
    const int f = (k1 >> 1) | ((k1 & 2) << 2) | ((k1 & 1) << 4);
    return k1 * RT + (t ^ f);
}

__device__ __forceinline__ bool mbar_try_wait(const unsigned bar,
                                              const unsigned phase) {
    unsigned ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(bar), "r"(phase)
        : "memory");
    return ok != 0;
}

// one thread: row r of both planes (none where live is false) into the
// input tile's row at in (I) and in + BF_IN / 2 (Q) by two bulk copies
// (TMA) that complete on bar
__device__ __forceinline__ void load_row(const __nv_bfloat16* ui,
                                         const __nv_bfloat16* uq,
                                         const long r, const bool live,
                                         const unsigned in,
                                         const unsigned bar) {
    constexpr unsigned bytes = N2K * 2;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(live ? 2 * bytes : 0u)
        : "memory");
    if (!live) return;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(in),
        "l"(ui + r * N2K), "r"(bytes), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(in + BF_IN / 2),
        "l"(uq + r * N2K), "r"(bytes), "r"(bar)
        : "memory");
}

// the 128 threads of one time row (named barrier 1 + row)
__device__ __forceinline__ void row_sync(const int row) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + row), "r"(RT) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// x *= (c - i s)
__device__ __forceinline__ void rotate_by(const float2 w, float& xr,
                                          float& xi) {
    const float tr = xr * w.x + xi * w.y;
    xi = xi * w.x - xr * w.y;
    xr = tr;
}

__global__ void __cluster_dims__(CL, 1, 1)
__launch_bounds__(ROWS2K * RT, 1)                   // 64 registers a thread
dft2048_bf16_kernel(
    const __nv_bfloat16* __restrict__ ui, const __nv_bfloat16* __restrict__ uq,
    const float* __restrict__ twc, const float* __restrict__ tws,
    const int m, const int tiles, const bool bulk, const bool vec,
    __nv_bfloat16* __restrict__ yi, __nv_bfloat16* __restrict__ yq) {
    extern __shared__ __align__(128) unsigned char sm[];
    float* xs = reinterpret_cast<float*>(sm);                 // [2][8][2048]
    auto* in = reinterpret_cast<__nv_bfloat16*>(sm + BF_X);   // [2][8][2048]
    float2* tw1 = reinterpret_cast<float2*>(sm + BF_X + BF_IN);  // [15][128]
    float2* tw2 = tw1 + 15 * RT;                                 // [15][8]
    const int tid = threadIdx.x;
    const int row = tid / RT;
    const int j = tid % RT;
    // this row's mbarrier and input rows
    const unsigned bar =
        smem_u32(sm + BF_X + BF_IN + BF_TW1 + BF_TW2 + 8 * row);
    const unsigned in_row = smem_u32(in + row * N2K);
    unsigned rank;
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    const int step = gridDim.x / CL;

    // the twiddles exp(-2 pi i j k1 / 2048) [k1 - 1][j] and
    // exp(-2 pi i t1 k2 / 128) [k2 - 1][t1] from the half table of cos, sin
    // (rounded once from float64): lane j reads word j, lanes of one t1 one
    // word
    for (int x = tid; x < 15 * RT + 15 * 8; x += ROWS2K * RT) {
        const int e = x < 15 * RT ? (x % RT) * (x / RT + 1)
                                  : 16 * (x % 8) * ((x - 15 * RT) / 8 + 1);
        const float sg = e >= N2K / 2 ? -1.0f : 1.0f;
        const int h = e & (N2K / 2 - 1);
        tw1[x] = make_float2(sg * twc[h], sg * tws[h]);
    }
    if (j == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                     "r"(1u)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const int first = blockIdx.x / CL;
    auto rows_of = [&](const int t) {
        const long r = (long)t * CL * ROWS2K + rank * ROWS2K;
        return (int)(r >= m ? 0 : (m - r < ROWS2K ? m - r : ROWS2K));
    };
    if (bulk && j == 0 && first < tiles)
        load_row(ui, uq, (long)first * CL * ROWS2K + rank * ROWS2K + row,
                 row < rows_of(first), in_row, bar);
    // the cluster's store tiles in the cluster window
    unsigned stile0, stile1;
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(stile0) : "r"(smem_u32(sm)), "r"(0u));
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(stile1) : "r"(smem_u32(sm)), "r"(1u));
    unsigned phase = 0;
    for (int t = first; t < tiles; t += step) {
        const long c0 = (long)t * CL * ROWS2K;      // the cluster's rows
        const long r0 = c0 + rank * ROWS2K;         // this block's rows
        if (bulk) {
            while (!mbar_try_wait(bar, phase)) {
            }
            phase ^= 1;
        } else {
            const int rows = rows_of(t);
            for (int e = tid; e < rows * N2K; e += ROWS2K * RT) {
                in[e] = ui[r0 * N2K + e];
                in[ROWS2K * N2K + e] = uq[r0 * N2K + e];
            }
            __syncthreads();
        }

        // pass 1: thread j holds u[r, j + 128 s], s < 16; a 16-point DFT
        // over s, times exp(-2 pi i j k1 / 2048): A[k1][t = j]
        float xr[16], xi[16];
#pragma unroll
        for (int s = 0; s < 16; ++s) {
            xr[s] = __bfloat162float(in[row * N2K + j + RT * s]);
            xi[s] = __bfloat162float(in[(ROWS2K + row) * N2K + j + RT * s]);
        }
        float* are = xs + row * N2K;
        float* aim = xs + (ROWS2K + row) * N2K;
        dft_reg<16>(xr, xi);
#pragma unroll
        for (int k1 = 1; k1 < 16; ++k1)
            rotate_by(tw1[(k1 - 1) * RT + j], xr[k1], xi[k1]);
        __syncthreads();            // the store tile (over A) is read
#pragma unroll
        for (int k1 = 0; k1 < 16; ++k1) {
            are[swz(k1, j)] = xr[k1];
            aim[swz(k1, j)] = xi[k1];
        }
        // the row's A written and its input row read: the row's next
        // input row may come in
        row_sync(row);
        if (bulk && j == 0 && t + step < tiles)
            load_row(ui, uq, r0 + (long)step * CL * ROWS2K + row,
                     row < rows_of(t + step), in_row, bar);

        // pass 2: (t1, k1) = (j % 8, j / 8) takes A[k1][t1 + 8 t2],
        // t2 < 16; a 16-point DFT over t2, times exp(-2 pi i t1 k2 /
        // 128): B(t1, g = k1 + 16 k2), written where it read A[k1][t1 +
        // 8 k2] (its own 16 words: no barrier between)
        const int t1 = j & 7, k1 = j >> 3;
#pragma unroll
        for (int t2 = 0; t2 < 16; ++t2) {
            xr[t2] = are[swz(k1, t1 + 8 * t2)];
            xi[t2] = aim[swz(k1, t1 + 8 * t2)];
        }
        dft_reg<16>(xr, xi);
#pragma unroll
        for (int k2 = 1; k2 < 16; ++k2)
            rotate_by(tw2[(k2 - 1) * 8 + t1], xr[k2], xi[k2]);
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) {
            are[swz(k1, t1 + 8 * k2)] = xr[k2];
            aim[swz(k1, t1 + 8 * k2)] = xi[k2];
        }
        row_sync(row);          // the row's B written

        // pass 3: groups g = j and j + 128, 8 points over t1 each:
        // x[8 h + t1] = B(t1, j + 128 h); y[g + 256 k3] for k3 < 8
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            const int g = j + RT * (x >> 3);
            xr[x] = are[swz(g & 15, (x & 7) + 8 * (g >> 4))];
            xi[x] = aim[swz(g & 15, (x & 7) + 8 * (g >> 4))];
        }
        dft_reg<8, 0>(xr, xi);
        dft_reg<8, 8>(xr, xi);
        // the cluster's blocks have read their B: the store tiles (over
        // the exchange) may be written, here and in the peers
        cluster_arrive();
        cluster_wait();
        // the outputs in bfloat16, rounded once, into the store tile of
        // the block that stores their channel (k / CH): row 8 rank + row
        // of [plane][8 CL rows][CH]. Lanes j and j + 1 trade one value, so
        // the even lane writes the I pair of channels (k, k + 1) and the odd
        // lane the Q pair: a warp writes 64 contiguous bytes of each plane,
        // in this block or through the cluster window in a peer
        const bool odd = j & 1;
#pragma unroll
        for (int x = 0; x < 16; ++x) {
            const int k0 = RT * (x >> 3) + 256 * (x & 7);  // k = j + k0
            const float other =
                __shfl_xor_sync(0xffffffffu, odd ? xr[x] : xi[x], 1);
            const unsigned v = odd ? pack_bf16x2(other, xi[x])
                                   : pack_bf16x2(xr[x], other);
            const unsigned a = (k0 / CH ? stile1 : stile0) +
                               (odd ? SPLANE : 0) +
                               (ROWS2K * rank + row) * SROW +
                               2 * ((j & ~1) + k0 % CH);
            asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v)
                         : "memory");
        }
        cluster_arrive();
        cluster_wait();             // the store tiles are complete
        // channels [CH rank, CH rank + CH) of the cluster's 8 CL rows
        // c0 ..: item e is (plane, channel pair 2c, 2c + 1, rows 2 li, 2 li
        // + 1); 4 CL lanes write a channel's 16 CL bytes, 8 / CL channels
        // a warp store
        const bool full = vec && c0 + CL * ROWS2K <= m;
        const unsigned char* st = sm;
#pragma unroll 2
        for (int it = 0; it < 8; ++it) {
            const int e = tid + it * ROWS2K * RT;
            const int li = e & 7, c = (e >> 3) & (CH / 2 - 1), p = e >> 12;
            const unsigned char* q = st + p * SPLANE + 2 * li * SROW + 4 * c;
            const unsigned w0 = *reinterpret_cast<const unsigned*>(q);
            const unsigned w1 = *reinterpret_cast<const unsigned*>(q + SROW);
            const unsigned v[2] = {__byte_perm(w0, w1, 0x5410),
                                   __byte_perm(w0, w1, 0x7632)};
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int k = (int)rank * CH + 2 * c + b;
                __nv_bfloat16* y =
                    (p ? yq : yi) + (size_t)k * m + c0 + 2 * li;
                if (full) {
                    *reinterpret_cast<unsigned*>(y) = v[b];
                } else {
                    if (c0 + 2 * li < m)
                        reinterpret_cast<unsigned short*>(y)[0] =
                            (unsigned short)v[b];
                    if (c0 + 2 * li + 1 < m)
                        reinterpret_cast<unsigned short*>(y)[1] =
                            (unsigned short)(v[b] >> 16);
                }
            }
        }
    }
}

int launch_2048_f32(const float* ui, const float* uq, const float* twc,
                    const float* tws, int m, float* yi, float* yq,
                    cudaStream_t stream) {
    const size_t shm = sizeof(float) * SMEM2K;
    cudaError_t err = cudaFuncSetAttribute(
        dft2048_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const long blocks = ((long)m + ROWS2K - 1) / ROWS2K;
    if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
    dft2048_kernel<<<(unsigned)blocks, ROWS2K * RT, shm, stream>>>(
        ui, uq, twc, tws, m, yi, yq);
    return (int)cudaGetLastError();
}

// one cluster per pair of SMs that can hold one (the card's count, asked
// once): each walks the 16-row tiles t, t + clusters, ...
int launch_2048_bf16(const __nv_bfloat16* ui, const __nv_bfloat16* uq,
                     const float* twc, const float* tws, int m,
                     __nv_bfloat16* yi, __nv_bfloat16* yq,
                     cudaStream_t stream) {
    static int active = 0;
    cudaError_t err = cudaFuncSetAttribute(
        dft2048_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BF_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (active < 1) {
        cudaLaunchAttribute attr{};
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = CL;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg{};
        cfg.gridDim = dim3(CL, 1, 1);
        cfg.blockDim = dim3(ROWS2K * RT, 1, 1);
        cfg.dynamicSmemBytes = BF_SMEM;
        cfg.stream = stream;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int n = 0;
        err = cudaOccupancyMaxActiveClusters(
            &n, (const void*)dft2048_bf16_kernel, &cfg);
        if (err != cudaSuccess) return (int)err;
        if (n < 1) return (int)cudaErrorInvalidConfiguration;
        active = n;
    }
    const int tiles = (m + CL * ROWS2K - 1) / (CL * ROWS2K);
    const int clusters = tiles < active ? tiles : active;
    // bulk copies need 16-byte aligned planes (else every thread copies
    // its share of the tile, without overlap); 4-byte stores of a
    // channel's rows need m % 8 == 0 (else 2-byte ones)
    const bool bulk = aligned16(ui) && aligned16(uq);
    const bool vec = m % 8 == 0 && aligned16(yi) && aligned16(yq);
    dft2048_bf16_kernel<<<CL * clusters, ROWS2K * RT, BF_SMEM, stream>>>(
        ui, uq, twc, tws, m, tiles, bulk, vec, yi, yq);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_radix2(const void* ui_, const void* uq_, const float* twc,
                  const float* tws, int m, int n, int logn, void* yi_,
                  void* yq_, cudaStream_t stream) {
    const T* ui = static_cast<const T*>(ui_);
    const T* uq = static_cast<const T*>(uq_);
    T* yi = static_cast<T*>(yi_);
    T* yq = static_cast<T*>(yq_);
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
// runs dft2048_kernel (float32) or dft2048_bf16_kernel, other N
// pfb_dft_kernel.
SONDETPU_API int sondetpu_pfb_dft(
    const void* ui, const void* uq, const float* twc, const float* tws,
    int m, int n, int bf16, void* yi, void* yq, void* stream) {
    int logn = 0;
    while ((1 << logn) < n) ++logn;
    if (n < 8 || n > 4096 || (1 << logn) != n || m < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n == N2K && bf16)
        return launch_2048_bf16(static_cast<const __nv_bfloat16*>(ui),
                                static_cast<const __nv_bfloat16*>(uq), twc,
                                tws, m, static_cast<__nv_bfloat16*>(yi),
                                static_cast<__nv_bfloat16*>(yq), s);
    if (n == N2K)
        return launch_2048_f32(static_cast<const float*>(ui),
                               static_cast<const float*>(uq), twc, tws, m,
                               static_cast<float*>(yi),
                               static_cast<float*>(yq), s);
    if (bf16)
        return launch_radix2<__nv_bfloat16>(ui, uq, twc, tws, m, n, logn, yi,
                                            yq, s);
    return launch_radix2<float>(ui, uq, twc, tws, m, n, logn, yi, yq, s);
}
