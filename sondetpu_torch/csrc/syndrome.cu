// RS syndrome check: one clean/suspect flag per frame row.
//
// Replaces sondetpu/pallas/syndrome.py:rs_clean_kernel (called through
// rs_clean_flags_pallas). A frame is clean iff bits(frame) @ W == 0 over
// GF(2), W = fec/syndrome.py:frame_syndrome_matrix, rows byte-major
// (row = 8*byte + bit). The TPU kernel takes that product on the MXU in
// f32 and reduces mod 2; here it is taken exactly, as column parities.
//
// The form. Read as little-endian 32-bit words, a frame is already the bit
// vector in W's row order: bit t of word k is bit t % 8 of byte 4k + t / 8,
// which is W's row 32k + t. The host packs W by column
// (kernels/syndrome.py:pack_syndrome_columns): WT[k][c] holds W[32k + t, c]
// in bit t, zero past W's last row and in the padding columns. Parity is
// linear, so syndrome bit c = popc(XOR_k (F[k] & WT[k][c])) & 1: one LOP3
// (acc ^= f & w) per (frame, column, word), no branch and no address that
// depends on the data. A frame is clean iff every column parity is 0.
//
// What bounds it: at 18432 rows x 320 bytes (RS41, 384 columns, 80 words)
// that is 5.7e8 LOP3 on the integer pipe (64 a clock per SM), ~0.04 ms;
// the frames are 5.9 MB, ~0.002 ms at 3.35 TB/s. Design: 8 warps per
// block, F frames per warp. Lane l owns columns l, l + 32, ... (NCJ of
// them), so one shared load of WT feeds F LOP3 and the 32 lanes read 32
// consecutive words (no bank conflict); the F frame words are broadcast.
// WT is walked in chunks of KC words x all columns, double-buffered with
// cp.async, while the block's frame tile stays in shared memory for the
// whole walk. Rows need not be 4-byte aligned (518-byte rs41x frames): the
// tile is packed into words from bytes, zero past the row. The frame's flag
// is __any_sync over its lanes' OR of column parities. The F x NCJ
// accumulators take most of the 99-122 registers, so two 256-thread blocks
// share an SM (__launch_bounds__(256, 2)), not four as elsewhere.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 16;       // WT words (rows) per staged chunk

// Frames per warp of the c384 body: 6 (99 registers) timed faster than 4
// and 8 at 18432 x 320 and x 518 bytes on an H100 (PR 7)
constexpr int C384_F = 6;

// The frame tile's row stride in words for F frames per warp: even (8-byte
// loads), 4 more than the block's frames so that the staging stores of 32
// consecutive k spread over 8 banks, not 1.
template <int F>
__host__ __device__ constexpr int tile_stride() { return WARPS * F + 4; }

// F (even) consecutive words of shared memory, 8-byte aligned, broadcast
// to the warp in F / 2 loads.
template <int F>
static __device__ __forceinline__ void load_words(const uint32_t* p,
                                                  uint32_t (&x)[F]) {
    static_assert(F % 2 == 0, "F must be even");
#pragma unroll
    for (int q = 0; q < F / 2; ++q) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[q];
        x[2 * q] = v.x;
        x[2 * q + 1] = v.y;
    }
}

static __device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NCJ column words per lane (32 * NCJ padded columns), F frames per warp.
template <int NCJ, int F>
__global__ void __launch_bounds__(THREADS, 2) rs_clean_kernel(
    const uint8_t* __restrict__ frames, const uint32_t* __restrict__ wt,
    const int R, const int fb, const bool words, bool* __restrict__ out) {
    constexpr int NC = 32 * NCJ;
    constexpr int FB = WARPS * F;                // frames per block
    constexpr int FBP = tile_stride<F>();
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* wbuf = smem;                       // [2][KC][NC]
    uint32_t* fw = smem + 2 * KC * NC;           // [nw][FBP]
    const int nw = (fb + 3) >> 2;
    const int nchunks = (nw + KC - 1) / KC;
    const int r0 = blockIdx.x * FB;

    auto stage = [&](const int c) {              // WT rows of chunk c
        const int kn = min(KC, nw - c * KC);
        const uint32_t* src = wt + (size_t)c * KC * NC;
        uint32_t* dst = wbuf + (c & 1) * KC * NC;
        for (int j = 4 * threadIdx.x; j < kn * NC; j += 4 * THREADS)
            cp_async_f32x4(reinterpret_cast<float*>(dst + j),
                           reinterpret_cast<const float*>(src + j), true);
        cp_async_commit();
    };
    stage(0);

    // the block's frames as little-endian words, k-major so that a warp's
    // F words of one k are adjacent (8-byte broadcast loads); rows past R
    // are zero
    const int rows = min(FB, R - r0);
    const uint8_t* base = frames + (size_t)r0 * fb;
#pragma unroll 4
    for (int i = threadIdx.x; i < FB * nw; i += THREADS) {
        const int f = i / nw, k = i - f * nw;
        uint32_t v = 0u;
        if (f < rows) {
            const uint8_t* p = base + (size_t)f * fb + 4 * k;
            if (words) {                         // fb % 4 == 0, aligned
                v = __ldg(reinterpret_cast<const uint32_t*>(p));
            } else {
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (4 * k + b < fb) v |= (uint32_t)__ldg(p + b) << (8 * b);
            }
        }
        fw[k * FBP + f] = v;
    }

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const uint32_t* mine = fw + warp * F;
    uint32_t acc[F][NCJ];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
        for (int j = 0; j < NCJ; ++j) acc[f][j] = 0u;

    for (int c = 0; c < nchunks; ++c) {
        if (c + 1 < nchunks) {
            stage(c + 1);                        // its buffer was freed below
            cp_async_wait_group<1>();
        } else {
            cp_async_wait_group<0>();
        }
        __syncthreads();                         // chunk c and the tile ready
        const uint32_t* wc = wbuf + (c & 1) * KC * NC + lane;
        const int k0 = c * KC;
        const int kn = min(KC, nw - k0);
        for (int k = 0; k < kn; ++k) {
            uint32_t x[F];
            load_words<F>(mine + (k0 + k) * FBP, x);
#pragma unroll
            for (int j = 0; j < NCJ; ++j) {
                const uint32_t w = wc[k * NC + 32 * j];
#pragma unroll
                for (int f = 0; f < F; ++f) acc[f][j] ^= x[f] & w;
            }
        }
        __syncthreads();                         // chunk c's buffer read
    }

#pragma unroll
    for (int f = 0; f < F; ++f) {
        uint32_t odd = 0u;
#pragma unroll
        for (int j = 0; j < NCJ; ++j) odd |= __popc(acc[f][j]) & 1;
        const bool dirty = __any_sync(0xffffffffu, odd != 0u);
        const int r = r0 + warp * F + f;
        if (lane == 0 && r < R) out[r] = !dirty;
    }
}

template <int NCJ, int F>
int launch(const uint8_t* frames, const uint32_t* wt, int R, int fb,
           bool* out, cudaStream_t stream) {
    constexpr int FB = WARPS * F;
    const int nw = (fb + 3) / 4;
    const size_t shm = sizeof(uint32_t) *
                       (2 * KC * 32 * NCJ + (size_t)tile_stride<F>() * nw);
    if (shm > 232448) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        rs_clean_kernel<NCJ, F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
    const bool words = fb % 4 == 0 && (reinterpret_cast<uintptr_t>(frames) & 3) == 0;
    rs_clean_kernel<NCJ, F><<<(R + FB - 1) / FB, THREADS, shm, stream>>>(
        frames, wt, R, fb, words, out);
    return (int)cudaGetLastError();
}

}  // namespace

// frames [R, fb] uint8; wt [ceil(fb/4), ncols] uint32 (device, 16-byte
// aligned), the column-packed W with its columns padded with zeros to
// ncols = 384 (body c384) or 512 (body c512) -> out [R] bool.
SONDETPU_API int sondetpu_rs_clean(const uint8_t* frames, const uint32_t* wt,
                                   int R, int fb, int ncols, bool* out,
                                   void* stream) {
    if (R < 1 || fb < 1 || !aligned16(wt)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (ncols == 384) return launch<12, C384_F>(frames, wt, R, fb, out, s);
    if (ncols == 512) return launch<16, 6>(frames, wt, R, fb, out, s);
    return (int)cudaErrorInvalidValue;
}
