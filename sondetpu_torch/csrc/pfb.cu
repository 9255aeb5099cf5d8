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
// What bounds it: device memory. At [192000, 2048] the two planes are read
// once and written once, 6.3 GB per 4-s block, ~1.9 ms at 3.35 TB/s; the
// 8 MACs per sample are nothing beside that. Design: each thread owns one
// column j of a ROWS-row strip and walks down it with a TPP-deep register
// window, so a warp's loads and stores are 32 consecutive floats of one row
// (coalesced) and each input is read once per strip (plus TPP - 1 rows of
// halo, 5% at ROWS = 128). The taps of the column sit in registers, and
// the loads of BATCH rows are issued together to keep enough bytes in
// flight.
// The TPU kernel's (TM, TN) tiles, halo BlockSpec and VMEM budget have no
// counterpart here.
//
// Products and sums are rounded one at a time (__fmul_rn/__fadd_rn, no FMA
// contraction) in ascending t, the order of the plain twin
// (sondetpu_torch/kernels/pfb.py:pfb_fir_plain), so the two agree bit for
// bit.
//
// The bf16 body is the Pallas body with cdt = bfloat16 (_kernel_stream):
// it reads the float32 planes and tail and rounds each sample to bfloat16
// on the read, takes the taps rounded to bfloat16, and rounds each product
// and each running sum to bfloat16, starting from the product of tap 0,
// then writes bfloat16. The product of two bfloat16 values is exact in
// float32, and a float32 sum of two bfloat16 values rounded to bfloat16 is
// their correctly rounded bfloat16 sum (24 >= 2 * 8 + 2 bits), so the
// float32 arithmetic rounded after each operation is bfloat16 arithmetic:
// torch.equal to the twin run in bfloat16. It moves 4 bytes a sample in
// and 2 out, but its 16 roundings an output (each a conversion to
// bfloat16 and back) bound it: the conversion unit issues a quarter of the
// FP32 rate, so the I and Q values of a column are rounded in pairs, one
// packed conversion for both.
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

// a value of the compute dtype: bfloat16 rounding in the bf16 body
template <bool BF>
__device__ __forceinline__ float cdt(const float v) {
    return BF ? round_bf16(v) : v;
}

// the I and Q values of a column rounded together: one paired conversion
// (F2FP) where two single ones would take twice the conversion unit, which
// bounds the bf16 body
template <bool BF>
__device__ __forceinline__ void cdt2(float& a, float& b) {
    if constexpr (BF) {
        const float2 r = __bfloat1622float2(__floats2bfloat162_rn(a, b));
        a = r.x;
        b = r.y;
    }
}

template <bool BF, typename Out>
__global__ void __launch_bounds__(THREADS) pfb_fir_kernel(
    const float* __restrict__ xi, const float* __restrict__ xq,
    const float* __restrict__ ti, const float* __restrict__ tq,
    const float* __restrict__ hcol, const int m, const int n,
    Out* __restrict__ ui, Out* __restrict__ uq) {
    const int j = blockIdx.x * THREADS + threadIdx.x;
    if (j >= n) return;
    const long r0 = (long)blockIdx.y * ROWS;
    const long r1 = r0 + ROWS < m ? r0 + ROWS : (long)m;
    const long s = (j == 0) ? 1 : 0;
    float h[TPP];
#pragma unroll
    for (int t = 0; t < TPP; ++t) h[t] = cdt<BF>(hcol[t * n + j]);
    // window w[d] = vv[r + s + d], d < TPP; row r takes tap t on w[TPP-1-t]
    float wi[TPP], wq[TPP];
#pragma unroll
    for (int d = 0; d < TPP - 1; ++d) {
        wi[d] = vv_at(xi, ti, r0 + s + d, n, j);
        wq[d] = vv_at(xq, tq, r0 + s + d, n, j);
        cdt2<BF>(wi[d], wq[d]);
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
            cdt2<BF>(ni[u], nq[u]);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            if (r + u >= r1) break;
            wi[TPP - 1] = ni[u];
            wq[TPP - 1] = nq[u];
            float ai = __fmul_rn(h[0], wi[TPP - 1]);
            float aq = __fmul_rn(h[0], wq[TPP - 1]);
            cdt2<BF>(ai, aq);
#pragma unroll
            for (int t = 1; t < TPP; ++t) {
                float pi = __fmul_rn(h[t], wi[TPP - 1 - t]);
                float pq = __fmul_rn(h[t], wq[TPP - 1 - t]);
                cdt2<BF>(pi, pq);
                ai = __fadd_rn(ai, pi);
                aq = __fadd_rn(aq, pq);
                cdt2<BF>(ai, aq);
            }
            ui[(r + u) * n + j] = from_f32<Out>(ai);
            uq[(r + u) * n + j] = from_f32<Out>(aq);
#pragma unroll
            for (int d = 0; d < TPP - 1; ++d) {
                wi[d] = wi[d + 1];
                wq[d] = wq[d + 1];
            }
        }
    }
}

int launch(const float* xi, const float* xq, const float* ti, const float* tq,
           const float* hcol, int tpp, int m, int n, int bf16, void* ui,
           void* uq, void* stream) {
    const long strips = ((long)m + ROWS - 1) / ROWS;
    if (tpp != TPP || m < 1 || n < 1 || strips > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((n + THREADS - 1) / THREADS, (unsigned)strips);
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        pfb_fir_kernel<true, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
            xi, xq, ti, tq, hcol, m, n, static_cast<__nv_bfloat16*>(ui),
            static_cast<__nv_bfloat16*>(uq));
    else
        pfb_fir_kernel<false, float><<<grid, THREADS, 0, s>>>(
            xi, xq, ti, tq, hcol, m, n, static_cast<float*>(ui),
            static_cast<float*>(uq));
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
