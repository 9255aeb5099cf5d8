// Syncword correlator: corr[c, i] = (sum_k t[k] * buf[c, i + k]) * (1/L).
//
// Replaces sondetpu/pallas/corr.py:corr_kernel (body _kernel). The main
// template and any alternate templates go through this same kernel.
//
// What bounds it: at 2048 channels x 21760 chips (the RS41 chip ring, L 64)
// the buffer read and the output written are 0.356 GB, 0.106 ms at
// 3.35 TB/s. Products and sums rounded alone are 129 operations per output,
// 0.171 ms at the FP32 rate; the sign body below does 65, 0.086 ms, so it
// is bound by bytes.
//
// Design: one thread block per (channel, tile of SPAN = R x THREADS
// outputs). The tile and its L - 1 halo are staged in shared memory with
// cp.async (16 bytes a copy where the rows allow it). Each thread takes R
// consecutive outputs and slides a window of R inputs up the taps
// (slide_window_up in common.cuh): one shared load per tap feeds R
// outputs, and with L = 64 or 32 compiled in every tap t[u] is an
// immediate constant-bank operand. Other L <= 64 take a body with L at
// run time; L above 64 (up to 2048) keeps the shared-template body
// (long_kernel). R is odd, so threads at stride R read 32 distinct banks;
// the outputs go back through shared memory so the global store is
// coalesced. R = 15 timed faster than 9 and 21 at [2048, 21760] on an H100
// (PR 5); the sign bodies take 32 registers.
//
// Exactness. The plain twin (sondetpu_torch/kernels/corr.py:corr_plain)
// sums t[k] * x in ascending k from zero, every product and sum rounded
// alone; the rounded bodies do the same (__fmul_rn/__fadd_rn). The sign
// bodies run when every tap is exactly +1.0 or -1.0 (every template of the
// port, sondes/base.py:sync_chip_template; the host's is_sign_template,
// checked again here): t * x is then exact, so __fmaf_rn(t, x, acc) rounds
// once the same value that __fadd_rn(acc, __fmul_rn(t, x)) rounds, signed
// zeros included, in half the instructions. Either way the result is the
// twin's bit for bit, scaled by the float32 1/L the caller rounds.
#include "common.cuh"

namespace {

constexpr int R = 15;                            // outputs per thread
constexpr int THREADS = 256;
constexpr int SPAN = R * THREADS;                // outputs per block
constexpr int LONG_TILE = 1024;                  // long_kernel's tile

template <int LL, bool SIGN>
__global__ void __launch_bounds__(THREADS, 4) corr_blocked_kernel(
    const float* __restrict__ buf, const Taps t, const int l_run,
    const int buf_len, const float inv_l, const bool vec,
    float* __restrict__ out) {
    extern __shared__ __align__(16) float xs[];  // [SPAN + L - 1, up to 4]
    const int L = LL > 0 ? LL : l_run;
    const int c = blockIdx.y;
    const int i0 = blockIdx.x * SPAN;
    const int n_out = buf_len - L + 1;
    const int nx = SPAN + L - 1;
    const float* row = buf + (size_t)c * buf_len;
    if (vec) {          // buf_len % 4 == 0 and buf aligned: whole chunks
        for (int j = 4 * threadIdx.x; j < nx; j += 4 * THREADS) {
            const int gi = i0 + j;
            cp_async_f32x4(xs + j, row + (gi < buf_len ? gi : 0),
                           gi < buf_len);
        }
    } else {
        for (int j = threadIdx.x; j < nx; j += THREADS) {
            const int gi = i0 + j;
            cp_async_f32(xs + j, row + (gi < buf_len ? gi : 0), gi < buf_len);
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // out[i0 + t0 + r] = sum_u t[u] * xs[t0 + r + u], r < R
    const int t0 = threadIdx.x * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    slide_window_up<R, LL>(xs + t0, L, [&](int u, int r, float x) {
        if constexpr (SIGN)
            acc[r] = __fmaf_rn(t.h[u], x, acc[r]);
        else
            acc[r] = __fadd_rn(acc[r], __fmul_rn(t.h[u], x));
    });
    __syncthreads();                             // every window read
#pragma unroll
    for (int r = 0; r < R; ++r) xs[t0 + r] = __fmul_rn(acc[r], inv_l);
    __syncthreads();
    float* orow = out + (size_t)c * n_out + i0;
    for (int j = threadIdx.x; j < SPAN && i0 + j < n_out; j += THREADS)
        orow[j] = xs[j];
}

// L above 64: the template in shared memory beside the tile, one thread
// per output, two shared loads per multiply-add.
__global__ void __launch_bounds__(THREADS) long_kernel(
    const float* __restrict__ buf, const float* __restrict__ tmpl,
    const int L, const int buf_len, const float inv_l,
    float* __restrict__ out) {
    extern __shared__ float smem[];
    float* ts = smem;                            // [L]
    float* xs = smem + L;                        // [LONG_TILE + L - 1]
    const int c = blockIdx.y;
    const int i0 = blockIdx.x * LONG_TILE;
    const int n_out = buf_len - L + 1;
    const float* row = buf + (size_t)c * buf_len;
    for (int k = threadIdx.x; k < L; k += THREADS)
        cp_async_f32(ts + k, tmpl + k, true);
    for (int j = threadIdx.x; j < LONG_TILE + L - 1; j += THREADS) {
        const int gi = i0 + j;
        cp_async_f32(xs + j, row + (gi < buf_len ? gi : 0), gi < buf_len);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int j = threadIdx.x; j < LONG_TILE; j += THREADS) {
        const int i = i0 + j;
        if (i >= n_out) break;
        float acc = 0.0f;
        for (int k = 0; k < L; ++k)
            acc = __fadd_rn(acc, __fmul_rn(ts[k], xs[j + k]));
        out[(size_t)c * n_out + i] = __fmul_rn(acc, inv_l);
    }
}

template <int LL, bool SIGN>
int launch(const float* buf, const Taps& t, int L, float inv_l, int C,
           int buf_len, float* out, cudaStream_t stream) {
    const int n_out = buf_len - L + 1;
    const dim3 grid((n_out + SPAN - 1) / SPAN, C);
    const size_t shm = sizeof(float) * ((SPAN + L - 1 + 3) / 4 * 4);
    const bool vec = buf_len % 4 == 0 && aligned16(buf);
    corr_blocked_kernel<LL, SIGN><<<grid, THREADS, shm, stream>>>(
        buf, t, L, buf_len, inv_l, vec, out);
    return (int)cudaGetLastError();
}

template <bool SIGN>
int dispatch(const float* buf, const Taps& t, int L, float inv_l, int C,
             int buf_len, float* out, cudaStream_t s) {
    if (L == 64)
        return launch<64, SIGN>(buf, t, L, inv_l, C, buf_len, out, s);
    if (L == 32)
        return launch<32, SIGN>(buf, t, L, inv_l, C, buf_len, out, s);
    return launch<0, SIGN>(buf, t, L, inv_l, C, buf_len, out, s);
}

}  // namespace

// buf [C, buf_len] f32 (device) -> out [C, buf_len - L + 1]. L <= 64: the
// template comes from the host array tmpl_host, and sign says that every
// tap is exactly +1 or -1 (checked here); L = 64 and 32 run compile-time
// bodies, others the run-time one. L > 64: the long body reads the device
// copy tmpl_dev and ignores sign. inv_l is float32(1/L) as the caller
// rounds it.
SONDETPU_API int sondetpu_corr(const float* buf, const float* tmpl_dev,
                               const float* tmpl_host, int L, float inv_l,
                               int sign, int C, int buf_len, float* out,
                               void* stream) {
    if (L < 1 || L > 2048 || buf_len < L || C < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (L > SONDETPU_MAX_TAPS) {
        if (tmpl_dev == nullptr) return (int)cudaErrorInvalidValue;
        const int n_out = buf_len - L + 1;
        const dim3 grid((n_out + LONG_TILE - 1) / LONG_TILE, C);
        const size_t shm = sizeof(float) * (LONG_TILE + 2 * L - 1);
        long_kernel<<<grid, THREADS, shm, s>>>(buf, tmpl_dev, L, buf_len,
                                               inv_l, out);
        return (int)cudaGetLastError();
    }
    if (tmpl_host == nullptr) return (int)cudaErrorInvalidValue;
    Taps t{};
    for (int u = 0; u < L; ++u) {
        t.h[u] = tmpl_host[u];
        if (sign && t.h[u] != 1.0f && t.h[u] != -1.0f)
            return (int)cudaErrorInvalidValue;
    }
    if (sign) return dispatch<true>(buf, t, L, inv_l, C, buf_len, out, s);
    return dispatch<false>(buf, t, L, inv_l, C, buf_len, out, s);
}
