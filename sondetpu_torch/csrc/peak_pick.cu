// Peak pick: up to K syncword-correlation peaks a row, as frame starts
// sorted by position (sondetpu_torch/sync/correlator.py:find_frame_starts
// on a CUDA tensor). The original, sondetpu/sync/correlator.py:
// find_frame_starts, is jnp ops and not a Pallas kernel, so this kernel
// replaces no TPU kernel; on the card it replaces the eager twin
// (sondetpu_torch/kernels/peak_pick.py:find_frame_starts_plain), whose
// K rounds were ~5 tiny launches each, 157 to 365 launches a group step.
//
// What it computes, bit for bit as the twin: pad the row with -inf to
// nb * half columns (half = max(min_distance / 2, 1)); in every
// half-window take the max and the max after masking the first max's
// column, each at its first column (-inf equals -inf, so the second of a
// window with one real column is that window's column 0, at -inf). The
// candidates are [all first maxima | all second maxima]. Each of K rounds
// takes the first-index argmax over the candidates, records its position
// and v >= threshold (the threshold rounded to float32, as the eager ge
// against a Python float compares it), and sets every candidate within
// min_distance of that position to -inf; once all are -inf a round picks
// candidate 0's position, not ok. The picks are then sorted stably by
// (ok ? position : n + 1), by counting ranks.
//
// What bounds it: one read of the correlation, C x n x 4 bytes. At RS41's
// 2048 x 21697 that is 178 MB, 0.053 ms at 3.35 TB/s; the fleet's three
// groups (1230 x 21697, 614 x 39969, 204 x 10529) read 213 MB, 0.064 ms.
// The rounds are K x 2nb / 32 shared-memory steps a row (RS41: 9 rounds
// over 136 candidates), hidden under other rows' reads.
//
// Design: one block of 8 warps a row. The warps take the half-windows in
// turn; each lane reads the columns lane, lane + 32, ... of its window
// (a warp reads 128 contiguous bytes at a time, U of them in flight per
// lane) and keeps its top two under the order (value, then the lower
// column), and 5 xor-shuffle steps merge the lanes' pairs. The candidates
// and their positions go to shared memory (dynamic, 16 nb bytes, plus
// 8 K for the picks; the host refuses a plan above 48 KB, which c50's 4-s
// block, the largest of the registered families, fills to 18 KB). Then
// warp 0 alone runs the K rounds: a lane scans its candidates (masking
// those within min_distance of the previous pick as it goes, so a round
// is one pass), 5 xor shuffles find the first-index argmax, and no block
// barrier is needed; the same warp counts the stable ranks and writes
// each pick to its place.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;                     // loads in flight per lane
constexpr int NO_COLUMN = 0x7fffffff;    // loses to every real (v, i)
constexpr unsigned FULL = 0xffffffffu;

// (v, i) comes before (bv, bi): the larger value, then the lower index
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS) peak_pick_kernel(
    const float* __restrict__ corr, const int n, const int half, const int nb,
    const float threshold, const int K, const int min_distance,
    int* __restrict__ starts, bool* __restrict__ ok) {
    extern __shared__ int smem[];
    float* cand_v = reinterpret_cast<float*>(smem);   // [2 nb]
    int* cand_p = smem + 2 * nb;                      // [2 nb]
    int* pick_p = cand_p + 2 * nb;                    // [K]
    int* pick_ok = pick_p + K;                        // [K]
    const float NEG = -CUDART_INF_F;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float* x = corr + (size_t)blockIdx.x * n;

    for (int w = warp; w < nb; w += WARPS) {
        const int base = w * half;
        float v1 = NEG, v2 = NEG;
        int i1 = NO_COLUMN, i2 = NO_COLUMN;
        for (int k0 = lane; k0 < half; k0 += 32 * U) {
            float xs[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int k = k0 + 32 * u;
                xs[u] = k < half && base + k < n ? x[base + k] : NEG;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int k = k0 + 32 * u;
                if (k >= half) break;                // the padding is -inf
                if (before(xs[u], k, v1, i1)) {
                    v2 = v1;
                    i2 = i1;
                    v1 = xs[u];
                    i1 = k;
                } else if (before(xs[u], k, v2, i2)) {
                    v2 = xs[u];
                    i2 = k;
                }
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov1 = __shfl_xor_sync(FULL, v1, o);
            const float ov2 = __shfl_xor_sync(FULL, v2, o);
            const int oi1 = __shfl_xor_sync(FULL, i1, o);
            const int oi2 = __shfl_xor_sync(FULL, i2, o);
            if (before(ov1, oi1, v1, i1)) {
                if (!before(v1, i1, ov2, oi2)) {
                    v2 = ov2;
                    i2 = oi2;
                } else {
                    v2 = v1;
                    i2 = i1;
                }
                v1 = ov1;
                i1 = oi1;
            } else if (before(ov1, oi1, v2, i2)) {
                v2 = ov1;
                i2 = oi1;
            }
        }
        // the masked first max is a -inf column too: a second max of -inf
        // (or none, half == 1) sits at the lower of the two columns
        if (v2 == NEG && i1 < i2) i2 = i1;
        if (lane == 0) {
            cand_v[w] = v1;
            cand_p[w] = base + i1;
            cand_v[nb + w] = v2;
            cand_p[nb + w] = base + i2;
        }
    }
    __syncthreads();
    if (warp != 0) return;

    const int nc = 2 * nb;
    int p = 0;
    for (int r = 0; r < K; ++r) {
        float bv = NEG;
        int bj = NO_COLUMN;
        for (int j = lane; j < nc; j += 32) {
            float v = cand_v[j];
            if (r > 0 && abs(cand_p[j] - p) <= min_distance) {
                v = NEG;
                cand_v[j] = NEG;
            }
            if (before(v, j, bv, bj)) {
                bv = v;
                bj = j;
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(FULL, bv, o);
            const int oj = __shfl_xor_sync(FULL, bj, o);
            if (before(ov, oj, bv, bj)) {
                bv = ov;
                bj = oj;
            }
        }
        p = cand_p[bj];
        if (lane == 0) {
            pick_p[r] = p;
            pick_ok[r] = bv >= threshold;
        }
    }
    __syncwarp();

    const long long last = (long long)n + 1;
    int* srow = starts + (size_t)blockIdx.x * K;
    bool* orow = ok + (size_t)blockIdx.x * K;
    for (int i = lane; i < K; i += 32) {
        const long long ki = pick_ok[i] ? pick_p[i] : last;
        int rank = 0;
        for (int j = 0; j < K; ++j) {
            const long long kj = pick_ok[j] ? pick_p[j] : last;
            rank += kj < ki || (kj == ki && j < i);
        }
        srow[rank] = pick_p[i];
        orow[rank] = pick_ok[i] != 0;
    }
}

// The shared memory a row's block takes: the 2 nb candidates' values and
// positions, and the K picks' positions and flags (kernels/peak_pick.py:
// shared_bytes)
long long smem_bytes(int nb, int K) { return 4LL * (4LL * nb + 2LL * K); }

}  // namespace

// corr [C, n] float32, contiguous; half and nb as the host computes them
// (nb = ceil(n / half)); min_distance in [-1, n]; starts [C, K] int32 and
// ok [C, K] bool.
SONDETPU_API int sondetpu_peak_pick(const float* corr, int C, int n, int half,
                                    int nb, float threshold, int K,
                                    int min_distance, int* starts, bool* ok,
                                    void* stream) {
    const long long smem = smem_bytes(nb, K);
    if (C < 1 || n < 1 || half < 1 || K < 1 || nb < 1 ||
        (long long)nb * half < n || (long long)(nb - 1) * half >= n ||
        smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    peak_pick_kernel<<<C, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        corr, n, half, nb, threshold, K, min_distance, starts, ok);
    return (int)cudaGetLastError();
}
