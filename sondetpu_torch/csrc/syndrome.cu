// RS syndrome check: one clean/suspect flag per frame row.
//
// Replaces sondetpu/pallas/syndrome.py:rs_clean_kernel (called through
// rs_clean_flags_pallas). A frame is clean iff bits(frame) @ W == 0 over
// GF(2), W = fec/syndrome.py:frame_syndrome_matrix, rows byte-major
// (row = 8*byte + bit). The TPU kernel takes that product on the MXU in
// f32 and reduces mod 2; here it is taken exactly, as XOR parity: the host
// packs each row of W into nw 32-bit words (column 32*k + j -> bit j of
// word k), and a row's syndrome is the XOR of the packed W rows of its set
// bits.
//
// What bounds it: at 18432 rows x 320 bytes the frames are 5.9 MB, and
// each set bit costs nw (12 for RS41) word loads from the 120 KB packed W,
// which stays in L1/L2; so it is bound by those cached loads, not by device
// memory. Design: one warp per row; each lane takes the row's bytes
// lane, lane + 32, ..., keeps nw words in registers, and the warp combines
// its lanes with __shfl_xor_sync. No float round trip and no row padding.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXW = 16;   // packed words per W row (up to 512 syndrome bits)

__global__ void __launch_bounds__(THREADS) rs_clean_kernel(
    const uint8_t* __restrict__ frames, const uint32_t* __restrict__ w,
    const int R, const int fb, const int nw, bool* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (r >= R) return;   // the whole warp shares r
    uint32_t acc[MAXW];
#pragma unroll
    for (int k = 0; k < MAXW; ++k) acc[k] = 0u;
    const uint8_t* row = frames + (size_t)r * fb;
    for (int b = lane; b < fb; b += 32) {
        uint32_t v = row[b];
        while (v) {
            const int bit = __ffs(v) - 1;
            v &= v - 1;
            const uint32_t* wr = w + ((size_t)b * 8 + bit) * nw;
#pragma unroll
            for (int k = 0; k < MAXW; ++k)
                if (k < nw) acc[k] ^= __ldg(wr + k);
        }
    }
    uint32_t any = 0u;
#pragma unroll
    for (int k = 0; k < MAXW; ++k) {
        if (k < nw) {
            uint32_t a = acc[k];
            for (int o = 16; o > 0; o >>= 1)
                a ^= __shfl_xor_sync(0xffffffffu, a, o);
            any |= a;
        }
    }
    if (lane == 0) out[r] = (any == 0u);
}

}  // namespace

// frames [R, fb] uint8, w [8*fb, nw] uint32 (device) -> out [R] bool.
SONDETPU_API int sondetpu_rs_clean(const uint8_t* frames, const uint32_t* w,
                                   int R, int fb, int nw, bool* out,
                                   void* stream) {
    if (R < 1 || fb < 1 || nw < 1 || nw > MAXW)
        return (int)cudaErrorInvalidValue;
    const int grid = (R + WARPS - 1) / WARPS;
    rs_clean_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        frames, w, R, fb, nw, out);
    return (int)cudaGetLastError();
}
