// Polyphase filter-bank branch FIR, time-major, for both I and Q planes.
//
// Replaces sondetpu/pallas/pfb.py:pfb_fir_stream (body _kernel_stream) and
// sondetpu/pallas/pfb.py:pfb_fir_timemajor (body _kernel): two entry points
// into one kernel.
//
// On the virtual stream vv = concat(tail [TPP, N], x [m, N]) (row k < TPP
// reads tail row k, row k >= TPP reads x row k - TPP), for every output
// row r < m and column j < N:
//   u[r, j] = sum_t hcol[t, j] * vv[r + TPP - 1 - t + s_j, j],  s_j = (j == 0)
// (column 0 holds branch 0, which taps one row later). pfb_fir_stream
// reads x and the carried tail through separate pointers, so nothing is
// concatenated in memory; pfb_fir_timemajor reads a pre-concatenated vv,
// which is the same kernel with tail = vv and x = vv + TPP*N.
//
// What bounds it: device memory. At [192000, 2048] the f32 body reads the
// two planes once and writes them once, 6.3 GB per 4-s block, ~1.9 ms at
// 3.35 TB/s; the 8 MACs per sample are nothing beside that. Design: each
// thread owns one column j of a ROWS-row strip and walks down it with a
// TPP-deep register window, so a warp's loads and stores are 32 consecutive
// floats of one row (coalesced) and each input is read once per strip
// (plus TPP - 1 rows of halo, 5% at ROWS = 128). The taps of the column sit
// in registers, and the loads of BATCH rows are issued together to keep
// enough bytes in flight.
// The TPU kernel's (TM, TN) tiles, halo BlockSpec and VMEM budget have no
// counterpart here.
//
// Products and sums are rounded one at a time (__fmul_rn/__fadd_rn, no FMA
// contraction) in ascending t, the order of the plain twin
// (sondetpu_torch/kernels/pfb.py:pfb_fir_plain), so the two agree bit for
// bit.
//
// The bf16 body (pfb_fir_bf16_kernel) is the Pallas body with cdt =
// bfloat16 (_kernel_stream): it reads the float32 planes and tail, rounds
// each sample to bfloat16 on the read, takes the taps rounded to bfloat16,
// and rounds each product and each running sum to bfloat16, starting from
// the product of tap 0, then writes bfloat16. It does that arithmetic in
// packed bfloat16 pairs: one mul.rn.bf16x2 for each product and one
// add.rn.bf16x2 for each running sum, each a correctly rounded bfloat16
// operation (round to nearest even, subnormals kept). The twin computes
// each operation in float32 and rounds it to bfloat16: the product of two
// bfloat16 values is exact in float32, and a float32 sum of two bfloat16
// values rounded to bfloat16 is their correctly rounded bfloat16 sum (24 >=
// 2 * 8 + 2 bits), so the two are the same operation: torch.equal to the
// twin run in bfloat16. No fma: it would round once where the twin rounds
// twice. A thread owns two adjacent columns (j, j + 1) of both planes, so a
// pair of bfloat16 values is two columns of one plane: each row costs one
// 8-byte load and one paired conversion per plane, 15 packed operations per
// plane for both columns, and one 4-byte store per plane. Column 0's
// one-row shift pairs vv[k + 1, 0] with vv[k, 1]: the thread of columns 0
// and 1 walks one row ahead and takes the high half of each pair from the
// row before (one byte permute a row, the identity in every other thread).
// An odd N or an unaligned plane takes the same body with scalar loads and
// stores (VEC false). It moves 8 bytes in and 4 out for every pair of
// samples of a plane, so bytes bound it (1.41 ms at [192000, 2048]).
#include "common.cuh"

namespace {

constexpr int TPP = 8;
constexpr int THREADS = 256;
constexpr int ROWS = 128;
constexpr int BATCH = 4;

__device__ __forceinline__ float vv_at(const float* __restrict__ x,
                                       const float* __restrict__ tail,
                                       long k, int n, int j) {
    return k < TPP ? tail[k * n + j] : x[(k - TPP) * n + j];
}

__global__ void __launch_bounds__(THREADS) pfb_fir_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ ti, const float* __restrict__ tq,
    const float* __restrict__ hcol, const int m, const int n,
    float* __restrict__ ui, float* __restrict__ uq) {
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= n) return;
    const long r0 = (long)blockIdx.y * ROWS;
    const long r1 = r0 + ROWS < m ? r0 + ROWS : (long)m;
    const long s = (j == 0) ? 1 : 0;
    float h[TPP];
#pragma unroll
    for (int t = 0; t < TPP; ++t) h[t] = hcol[t * n + j];
    // window w[d] = vv[r + s + d], d < TPP; row r takes tap t on w[TPP-1-t]
    float wi[TPP], wq[TPP];
#pragma unroll
    for (int d = 0; d < TPP - 1; ++d) {
        wi[d] = vv_at(xi, ti, r0 + s + d, n, j);
        wq[d] = vv_at(xq, tq, r0 + s + d, n, j);
    }
    // rows go in batches of BATCH: their BATCH new loads per plane are
    // issued together, so each thread keeps 2*BATCH loads in flight
    for (long r = r0; r < r1; r += BATCH) {
        float ni[BATCH], nq[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const bool in = r + u < r1;
            ni[u] = in ? vv_at(xi, ti, r + u + s + TPP - 1, n, j) : 0.0f;
            nq[u] = in ? vv_at(xq, tq, r + u + s + TPP - 1, n, j) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            if (r + u >= r1) break;
            wi[TPP - 1] = ni[u];
            wq[TPP - 1] = nq[u];
            float ai = __fmul_rn(h[0], wi[TPP - 1]);
            float aq = __fmul_rn(h[0], wq[TPP - 1]);
#pragma unroll
            for (int t = 1; t < TPP; ++t) {
                ai = __fadd_rn(ai, __fmul_rn(h[t], wi[TPP - 1 - t]));
                aq = __fadd_rn(aq, __fmul_rn(h[t], wq[TPP - 1 - t]));
            }
            ui[(r + u) * n + j] = ai;
            uq[(r + u) * n + j] = aq;
#pragma unroll
            for (int d = 0; d < TPP - 1; ++d) {
                wi[d] = wi[d + 1];
                wq[d] = wq[d + 1];
            }
        }
    }
}

// --- bf16: packed pairs of columns ------------------------------------------

// the correctly rounded bfloat16 product and sum of each half; .rn keeps
// ptxas from contracting a product and a sum into one fma
__device__ __forceinline__ unsigned mul_bf16x2(const unsigned a,
                                               const unsigned b) {
    unsigned d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ unsigned add_bf16x2(const unsigned a,
                                               const unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// vv row k at columns (j, j + 1) of one plane, as float32; the high half
// is 0 where j + 1 == n (odd N). VEC: one 8-byte load (n even, the planes
// 8-byte aligned)
template <bool VEC>
__device__ __forceinline__ float2 vv_pair(const float* __restrict__ x,
                                          const float* __restrict__ tail,
                                          const long k, const int n,
                                          const int j, const bool hi) {
    const float* p = k < TPP ? tail + k * n + j : x + (k - TPP) * n + j;
    if constexpr (VEC) return *reinterpret_cast<const float2*>(p);
    return make_float2(p[0], hi ? p[1] : 0.0f);
}

template <bool VEC>
__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ u,
                                           const long o, const unsigned v,
                                           const bool hi) {
    if constexpr (VEC) {
        *reinterpret_cast<unsigned*>(u + o) = v;
    } else {
        reinterpret_cast<unsigned short*>(u)[o] = (unsigned short)v;
        if (hi) reinterpret_cast<unsigned short*>(u)[o + 1] =
                    (unsigned short)(v >> 16);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) pfb_fir_bf16_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ ti, const float* __restrict__ tq,
    const float* __restrict__ hcol, const int m, const int n,
    __nv_bfloat16* __restrict__ ui, __nv_bfloat16* __restrict__ uq) {
    const int j = 2 * (blockIdx.x * THREADS + threadIdx.x);
    if (j >= n) return;
    const bool hi = j + 1 < n;
    const long r0 = (long)blockIdx.y * ROWS;
    const long r1 = r0 + ROWS < m ? r0 + ROWS : (long)m;
    // W[k] = (vv[k + s, j], vv[k, j + 1]): column 0 (s = 1) takes the low
    // half of row k + 1 and the high half of row k; every other thread
    // the pair of row k (s = 0)
    const int s = (j == 0) ? 1 : 0;
    const unsigned sel = s ? 0x7610u : 0x3210u;
    unsigned h[TPP];
#pragma unroll
    for (int t = 0; t < TPP; ++t)
        h[t] = pack_bf16x2(hcol[t * n + j], hi ? hcol[t * n + j + 1] : 0.0f);
    // window w[d] = W[r + d], d < TPP; row r takes tap t on w[TPP-1-t]
    unsigned wi[TPP], wq[TPP];
    unsigned pi = 0, pq = 0;                   // the pair of the row before
    if (s) {
        const float2 a = vv_pair<VEC>(xi, ti, r0, n, j, hi);
        const float2 b = vv_pair<VEC>(xq, tq, r0, n, j, hi);
        pi = pack_bf16x2(a.x, a.y);
        pq = pack_bf16x2(b.x, b.y);
    }
#pragma unroll
    for (int d = 0; d < TPP - 1; ++d) {
        const float2 a = vv_pair<VEC>(xi, ti, r0 + s + d, n, j, hi);
        const float2 b = vv_pair<VEC>(xq, tq, r0 + s + d, n, j, hi);
        const unsigned ni = pack_bf16x2(a.x, a.y);
        const unsigned nq = pack_bf16x2(b.x, b.y);
        wi[d] = __byte_perm(ni, pi, sel);
        wq[d] = __byte_perm(nq, pq, sel);
        pi = ni;
        pq = nq;
    }
    for (long r = r0; r < r1; r += BATCH) {
        float2 ni[BATCH], nq[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const bool in = r + u < r1;
            const float2 z = make_float2(0.0f, 0.0f);
            ni[u] = in ? vv_pair<VEC>(xi, ti, r + u + s + TPP - 1, n, j, hi)
                       : z;
            nq[u] = in ? vv_pair<VEC>(xq, tq, r + u + s + TPP - 1, n, j, hi)
                       : z;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            if (r + u >= r1) break;
            const unsigned ci = pack_bf16x2(ni[u].x, ni[u].y);
            const unsigned cq = pack_bf16x2(nq[u].x, nq[u].y);
            wi[TPP - 1] = __byte_perm(ci, pi, sel);
            wq[TPP - 1] = __byte_perm(cq, pq, sel);
            pi = ci;
            pq = cq;
            unsigned ai = mul_bf16x2(h[0], wi[TPP - 1]);
            unsigned aq = mul_bf16x2(h[0], wq[TPP - 1]);
#pragma unroll
            for (int t = 1; t < TPP; ++t) {
                ai = add_bf16x2(ai, mul_bf16x2(h[t], wi[TPP - 1 - t]));
                aq = add_bf16x2(aq, mul_bf16x2(h[t], wq[TPP - 1 - t]));
            }
            store_pair<VEC>(ui, (r + u) * n + j, ai, hi);
            store_pair<VEC>(uq, (r + u) * n + j, aq, hi);
#pragma unroll
            for (int d = 0; d < TPP - 1; ++d) {
                wi[d] = wi[d + 1];
                wq[d] = wq[d + 1];
            }
        }
    }
}

bool aligned(const void* p, const uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int launch(const float* xi, const float* xq, const float* ti, const float* tq,
           const float* hcol, int tpp, int m, int n, int bf16, void* ui,
           void* uq, void* stream) {
    const long strips = ((long)m + ROWS - 1) / ROWS;
    if (tpp != TPP || m < 1 || n < 1 || strips > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        auto* oi = static_cast<__nv_bfloat16*>(ui);
        auto* oq = static_cast<__nv_bfloat16*>(uq);
        const int pairs = (n + 1) / 2;
        const dim3 grid((pairs + THREADS - 1) / THREADS, (unsigned)strips);
        const bool vec = n % 2 == 0 && aligned(xi, 8) && aligned(xq, 8) &&
                         aligned(ti, 8) && aligned(tq, 8) && aligned(ui, 4) &&
                         aligned(uq, 4);
        if (vec)
            pfb_fir_bf16_kernel<true><<<grid, THREADS, 0, st>>>(
                xi, xq, ti, tq, hcol, m, n, oi, oq);
        else
            pfb_fir_bf16_kernel<false><<<grid, THREADS, 0, st>>>(
                xi, xq, ti, tq, hcol, m, n, oi, oq);
    } else {
        const dim3 grid((n + THREADS - 1) / THREADS, (unsigned)strips);
        pfb_fir_kernel<<<grid, THREADS, 0, st>>>(
            xi, xq, ti, tq, hcol, m, n, static_cast<float*>(ui),
            static_cast<float*>(uq));
    }
    return (int)cudaGetLastError();
}

}  // namespace

// x_i, x_q [m, n]; tail_i, tail_q [tpp, n]; hcol [tpp, n] (device, all
// float32); u_i, u_q [m, n], float32, or bfloat16 from the bf16 body.
SONDETPU_API int sondetpu_pfb_fir_stream(
    const float* xi, const float* xq, const float* ti, const float* tq,
    const float* hcol, int tpp, int m, int n, int bf16, void* ui, void* uq,
    void* stream) {
    return launch(xi, xq, ti, tq, hcol, tpp, m, n, bf16, ui, uq, stream);
}

// vv_i, vv_q [tpp + m, n]; hcol [tpp, n] (device, float32); u_i, u_q
// [m, n] as above.
SONDETPU_API int sondetpu_pfb_fir_timemajor(
    const float* vvi, const float* vvq, const float* hcol, int tpp, int m,
    int n, int bf16, void* ui, void* uq, void* stream) {
    if (tpp != TPP) return (int)cudaErrorInvalidValue;
    const size_t off = (size_t)TPP * n;
    return launch(vvi + off, vvq + off, vvi, vvq, hcol, tpp, m, n, bf16, ui,
                  uq, stream);
}
