// Midpoint DC: the per-row midpoint 0.5 * (q10 + q90) of the dual-tone
// metric (sondetpu_torch/runtime/pipeline.py:midpoint_dc on a CUDA tensor,
// kernels/midpoint.py). The original, sondetpu/runtime/pipeline.py's
// midpoint DC, is jnp.quantile and not a Pallas kernel, so this kernel
// replaces no TPU kernel; on the card it replaces the twin
// (kernels/midpoint.py:midpoint_dc_plain): four torch.kthvalue selects over
// the whole metric, an isnan mask of its size and two blocking uploads of
// the quantile weights, 52.6 device ms a block at [2048, 192000].
//
// What it computes, bit for bit as the twin: the order statistics x_lo,
// x_hi at the ranks the host takes from q * (n - 1) in float32 for q = 0.1
// and 0.9 (exact: a rank is a count); each quantile fmaf(x_lo, 1 - w,
// fl(x_hi * w)) in float32 (the twin's _fma_f32), cast to the row's dtype;
// the midpoint (q0 + q1) * 0.5 rounded in that dtype as PyTorch rounds it
// (on bfloat16 the sum is rounded to bfloat16 before the product). A row
// holding a NaN gives NaN. The order is torch.kthvalue's on the card: a
// float maps to an unsigned key that orders as the float does (all bits
// flipped when negative, the sign bit alone when not), so -0 comes before
// +0, as PyTorch's radix select has it; the keys are 32 bits on float32
// and 16 on bfloat16.
//
// What bounds it: one read of x, C x n x 4 bytes; at [2048, 192000] float32
// 1.57 GB, 0.47 ms at 3.35 TB/s (bfloat16 0.23 ms). This design reads a
// row at least twice where the ranks' bins hold more than CAP keys (a
// histogram pass, then the copy), so its own bound there is 0.94 ms.
//
// Design: one block of 512 threads a row (rows at any stride: the CPU's K7
// twin hands over a view), two blocks to an SM, a radix select on the keys
// whose passes the counts in the row decide. A pass over the row
// histograms the next 12 key bits of one group of ranks (the ranks whose
// resolved key prefix is the same) in shared memory. A warp reads 512
// contiguous bytes a load, four loads in flight a thread, and a thread adds
// a run of equal bins in its 16-byte word (4 float32, 8 bfloat16 elements)
// with one atomic: the Meisei metric keeps ~75% of a row in the bin of -1,
// and neighbouring samples share a bin. Before such a pass the first 8192
// elements of the row (a sample; the pass reads them again from L2) guess
// the ranks' bins, and the first two bins that the sample puts above CAP / 2
// keys get histograms of their next 12 bits in the same pass, so that one
// pass resolves 24 bits there. Once the groups left hold at most CAP keys,
// one pass copies them into shared memory (a lane marks its hits in four
// words, the warp reserves their slots with one atomic) and the select ends
// there; a row of at most CAP elements is copied at once. A near-constant
// row (heavy ties) never fits: its passes go on over the row until every
// bit is resolved. On the Meisei metric a row takes the sample, one pass of
// 24 bits at q10 (12 at q90) and the copy: two reads. Each pass reads at
// ~0.5 ms and issues ~20 instructions an element, which the card hides
// under the read: 1.42 ms at [2048, 192000] float32 on an H100 SXM (700 W),
// against 2.9 ms with an atomic a key and a vote an element. The NaN check is the least and the
// largest key a thread sees in a full pass (NaN keys lie outside -inf's and
// +inf's). Nothing is copied from the host: the ranks and weights are launch
// arguments.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DIGIT = 12;                  // key bits a histogram resolves
constexpr int BINS = 1 << DIGIT;
constexpr int CAP = 22528;                 // keys the candidate buffer holds
constexpr int RANKS = 4;                   // lo and hi of q10, of q90
constexpr int U = 4;                       // chunks a thread loads at once
constexpr int SAMPLE = 8192;               // elements of the guessing sample
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM = sizeof(unsigned) * (BINS + CAP);

struct Quantiles {
    int rank[RANKS];     // 0-based order statistics: lo0, hi0, lo1, hi1
    float w[2];          // the weight of hi0, of hi1
    float omw[2];        // 1 - w, as the host rounds it
};

template <typename T>
struct Keys;

template <>
struct Keys<float> {
    static constexpr int BITS = 32;
    static constexpr unsigned INF = 0xff800000u;      // key(+inf)
    static constexpr unsigned NEG_INF = 0x007fffffu;  // key(-inf)
    static __device__ __forceinline__ unsigned key(const unsigned raw) {
        return raw ^ ((unsigned)((int)raw >> 31) | 0x80000000u);
    }
    static __device__ __forceinline__ float value(const unsigned key) {
        return __uint_as_float((key & 0x80000000u) ? key & 0x7fffffffu
                                                   : ~key);
    }
};

template <>
struct Keys<__nv_bfloat16> {
    static constexpr int BITS = 16;
    static constexpr unsigned INF = 0xff80u;
    static constexpr unsigned NEG_INF = 0x007fu;
    static __device__ __forceinline__ unsigned key(const unsigned raw) {
        return raw ^ (((unsigned)((int)(raw << 16) >> 31) & 0xffffu) | 0x8000u);
    }
    static __device__ __forceinline__ float value(const unsigned key) {
        const unsigned raw = (key & 0x8000u) ? key & 0x7fffu : ~key & 0xffffu;
        return __uint_as_float(raw << 16);
    }
};

// A chunk is one 16-byte word of the row: V<T> elements, the word's 32-bit
// words a float each, or two bfloat16 each (the lower first).
template <typename T>
constexpr int V = 16 / (int)sizeof(T);
template <typename T>
constexpr unsigned WHOLE = (1u << V<T>) - 1;    // ok of a whole chunk

__device__ __forceinline__ unsigned element(const uint4 w, const int i,
                                            const float*) {
    return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}
__device__ __forceinline__ unsigned element(const uint4 w, const int i,
                                            const __nv_bfloat16*) {
    const unsigned h = element(w, i >> 1, (const float*)nullptr);
    return (i & 1) ? h >> 16 : h & 0xffffu;
}

__device__ __forceinline__ unsigned raw_bits(const float* p) {
    return __float_as_uint(*p);
}
__device__ __forceinline__ unsigned raw_bits(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
}

// The chunk of the row's elements [e0, e0 + V) as a word, the bits of the
// elements inside [0, n) set in ok (the others read as zero). A whole chunk
// starts on a 16-byte boundary of the allocation and is one load.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row,
                                            const int n, const int e0,
                                            unsigned& ok) {
    constexpr int W = V<T>;
    if (e0 >= 0 && e0 + W <= n) {
        ok = WHOLE<T>;
        return __ldg(reinterpret_cast<const uint4*>(row + e0));
    }
    unsigned b[W];
    ok = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const int e = e0 + i;
        const bool in = e >= 0 && e < n;
        b[i] = in ? raw_bits(row + e) : 0u;
        ok |= (unsigned)in << i;
    }
    if constexpr (W == 4) {
        return make_uint4(b[0], b[1], b[2], b[3]);
    } else {
        return make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16,
                          b[4] | b[5] << 16, b[6] | b[7] << 16);
    }
}

// f(words, oks) on chunks 0 .. c1 - 1, U chunks a thread at a time;
// chunk c holds the elements c * V - head .. c * V - head + V - 1 of the
// row. A warp takes 32 * U consecutive chunks at a time, lane l the chunks
// l, l + 32, ..., so that each of its U loads reads 512 contiguous bytes,
// and all U are in flight before f runs. The 32 lanes of a warp call f
// together (a lane past c1 with ok = 0), so f may vote across the warp.
template <typename T, typename F>
__device__ __forceinline__ void walk(const T* __restrict__ row, const int n,
                                     const int head, const int c1, F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int base = warp * 32 * U; base < c1; base += THREADS * U) {
        uint4 w[U];
        unsigned ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = base + 32 * u + lane;
            w[u] = load_chunk(row, n, c < c1 ? c * V<T> - head : n, ok[u]);
        }
        f(w, ok);
    }
}

// The largest offset from a prefix of KB - bits key bits: the keys under
// the prefix are pfx .. pfx + span_of(bits).
__device__ __forceinline__ unsigned span_of(const int bits) {
    return bits >= 32 ? FULL : (1u << bits) - 1u;
}

// a[j] for a j known only at run time, with every a[i] in a register
template <typename A, int N>
__device__ __forceinline__ A pick(const A (&a)[N], const int j) {
    A v = a[0];
#pragma unroll
    for (int i = 1; i < N; ++i)
        if (i == j) v = a[i];
    return v;
}

// For each rank j of the mask act, the bin of h[0 .. D) holding rank t[j]
// of the counted keys (with den > 0: rank t[j] * total / den, the rank in
// a sample of a group of den keys) into bin[j], the rank inside that bin
// into k[j] and the bin's count into cnt[j]; a rank no bin holds leaves its
// slots as they were. Returns the total count. The caller's barrier orders
// h before the call; the results are visible to every thread on return.
__device__ int find_bins(const unsigned* h, const int D, const unsigned act,
                         const long long (&t)[RANKS], const long long den,
                         int* bin, int* k, int* cnt, int* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (D + THREADS - 1) / THREADS;
    const int b0 = min(tid * per, D), b1 = min(b0 + per, D);
    int s = 0;
    for (int b = b0; b < b1; ++b) s += (int)h[b];
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int below = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int v = wsum[w];
        below += w < warp ? v : 0;
        total += v;
    }
    const int excl = below + incl - s;
#pragma unroll
    for (int j = 0; j < RANKS; ++j) {
        if (!((act >> j) & 1u)) continue;
        const long long want = den > 0 ? t[j] * total / den : t[j];
        if (want < excl || want >= excl + s) continue;
        int acc = excl;
        for (int b = b0; b < b1; ++b) {
            const int c = (int)h[b];
            if (want < acc + c) {
                bin[j] = b;
                k[j] = (int)(want - acc);
                cnt[j] = c;
                break;
            }
            acc += c;
        }
    }
    __syncthreads();
    return total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    midpoint_kernel(const T* __restrict__ x, const int n, const long long ld,
                    const Quantiles q, T* __restrict__ out) {
    using K = Keys<T>;
    constexpr int KB = K::BITS;
    extern __shared__ unsigned smem[];
    unsigned* hist = smem;         // [BINS]
    unsigned* cand = smem + BINS;  // [CAP]; during a histogram pass over the
                                   // row, the guessed bins' histograms at
                                   // cand and cand + BINS
    // each rank's state: its resolved key prefix (pfx, the top pb of the KB
    // key bits) and its rank among the cnt keys under that prefix; once the
    // groups left are copied, cand[0 .. kept) holds their keys
    __shared__ unsigned st_pfx[RANKS];
    __shared__ int st_pb[RANKS], st_k[RANKS], st_cnt[RANKS];
    __shared__ int f_bin[RANKS], f_k[RANKS], f_cnt[RANKS];
    __shared__ int f2_bin[RANKS], f2_k[RANKS], f2_cnt[RANKS];
    __shared__ int wsum[WARPS];
    __shared__ unsigned cursor;
    __shared__ int kept;

    const int tid = threadIdx.x, lane = tid & 31;
    const T* row = x + (size_t)blockIdx.x * ld;
    constexpr int W = V<T>;
    const int head = (int)((reinterpret_cast<uintptr_t>(row) % 16) / sizeof(T));
    const int nch = (head + n + W - 1) / W;
    if (tid < RANKS) {
        st_pfx[tid] = 0;
        st_pb[tid] = 0;
        st_k[tid] = q.rank[tid];
        st_cnt[tid] = n;
    }
    if (tid == 0) kept = 0;
    bool row_nan = false;  // the block saw a NaN
    // NaN keys lie above +inf's and below -inf's: a thread has seen a NaN
    // when the largest key it saw is above the one or the least below the
    // other (the zeros of a partial chunk read as +0, inside both)
    unsigned kmax = 0, kmin = FULL;

    // a histogram pass over the keys of a group, (key - gpfx) <= span: a key
    // adds to hist[(key - gpfx) >> sh1], or, where that is a guessed bin
    // gs0 or gs1, to slot ((key - gpfx) >> sh2) & m2 of the bin's own
    // histogram at cand (gs0) or cand + BINS (gs1); runs of keys of one
    // slot add at once
    unsigned gpfx = 0, span = 0;
    int sh1 = 0, sh2 = 0, m2 = 0, gs0 = -1, gs1 = -1;
    auto count_word = [&](const uint4 word, const unsigned ok) {
        int cur = -1, run = 0;
#pragma unroll
        for (int i = 0; i < W; ++i) {
            const unsigned key = K::key(element(word, i, x));
            kmax = max(kmax, key);
            kmin = min(kmin, key);
            const unsigned off = key - gpfx;
            const int sub = (int)((off >> sh2) & m2);
            int slot = (int)(off >> sh1);
            slot = slot == gs0   ? BINS + sub
                   : slot == gs1 ? 2 * BINS + sub
                                 : slot;
            if (!((ok >> i) & 1u) || off > span) slot = -1;
            if (slot != cur) {
                if (cur >= 0) atomicAdd(&smem[cur], (unsigned)run);
                cur = slot;
                run = 1;
            } else {
                ++run;
            }
        }
        if (cur >= 0) atomicAdd(&smem[cur], (unsigned)run);
    };
    auto count = [&](const uint4 (&w)[U], const unsigned (&ok)[U]) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (ok[u] == WHOLE<T>)
                count_word(w[u], WHOLE<T>);
            else
                count_word(w[u], ok[u]);
        }
    };

    // a copy pass: the keys of every group left, (key - clo[j]) <= cwid[j]
    // for a j < ngroups, into cand in any order. A lane marks its hits in a
    // batch; the warp sums them and reserves its slots with one atomic.
    unsigned clo[RANKS], cwid[RANKS];
    int ngroups = 0;
    auto copy = [&](const uint4 (&w)[U], const unsigned (&ok)[U]) {
        unsigned hits = 0, valid = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            valid |= ok[u] << (u * W);
#pragma unroll
            for (int i = 0; i < W; ++i) {
                const unsigned key = K::key(element(w[u], i, x));
                kmax = max(kmax, key);
                kmin = min(kmin, key);
                bool hit = false;
#pragma unroll
                for (int j = 0; j < RANKS; ++j)
                    hit |= j < ngroups && key - clo[j] <= cwid[j];
                hits |= (unsigned)hit << (u * W + i);
            }
        }
        hits &= valid;
        const int c = __popc(hits);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += v;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        if (total == 0) return;
        unsigned at = 0;
        if (lane == 31) at = atomicAdd(&cursor, (unsigned)total);
        at = __shfl_sync(FULL, at, 31) + (unsigned)(incl - c);
        while (hits) {
            const int b = __ffs(hits) - 1;
            hits &= hits - 1;
            const unsigned key = K::key(element(pick(w, b / W), b % W, x));
            if (at < CAP) cand[at] = key;
            ++at;
        }
    };

    for (;;) {
        __syncthreads();
        unsigned pfx[RANKS];
        int pb[RANKS], kk[RANKS], cnt[RANKS];
#pragma unroll
        for (int j = 0; j < RANKS; ++j) {
            pfx[j] = st_pfx[j];
            pb[j] = st_pb[j];
            kk[j] = st_k[j];
            cnt[j] = st_cnt[j];
        }
        const int in_cand = kept;
        __syncthreads();
        // lead[j]: the first rank of j's group (unresolved, same prefix)
        int lead[RANKS];
#pragma unroll
        for (int j = 0; j < RANKS; ++j) {
            lead[j] = j;
#pragma unroll
            for (int i = j - 1; i >= 0; --i)
                if (pb[i] < KB && pb[i] == pb[j] && pfx[i] == pfx[j])
                    lead[j] = i;
        }
        // the next group: one already in cand first, else the largest of
        // the groups left over the row
        int j0 = -1, big = -1, left = 0;
#pragma unroll
        for (int j = RANKS - 1; j >= 0; --j)
            if (pb[j] < KB && in_cand > 0) j0 = j;
        if (j0 < 0) {
#pragma unroll
            for (int j = 0; j < RANKS; ++j) {
                if (pb[j] >= KB || lead[j] != j) continue;
                left += cnt[j];
                if (big < 0 || cnt[j] > pick(cnt, big)) big = j;
            }
            if (big < 0) break;                    // every rank resolved
        }
        if (j0 < 0 && left <= CAP) {
            // one pass copies every group left into cand
            ngroups = 0;
#pragma unroll
            for (int j = 0; j < RANKS; ++j) {
                clo[j] = 1u;
                cwid[j] = 0u;
            }
#pragma unroll
            for (int j = 0; j < RANKS; ++j) {
                if (pb[j] >= KB || lead[j] != j) continue;
#pragma unroll
                for (int g = 0; g < RANKS; ++g) {
                    if (g != ngroups) continue;
                    clo[g] = pfx[j];
                    cwid[g] = span_of(KB - pb[j]);
                }
                ++ngroups;
            }
            if (tid == 0) cursor = 0;
            __syncthreads();
            walk(row, n, head, nch, copy);
            if (__syncthreads_or(kmax > K::INF || kmin < K::NEG_INF)) {
                row_nan = true;
                break;
            }
            if (tid == 0) kept = left;
            continue;
        }
        const int g0 = j0 >= 0 ? j0 : big;
        const int gb = pick(pb, g0);
        gpfx = pick(pfx, g0);
        span = span_of(KB - gb);
        unsigned act = 0;          // the ranks of g0's group
        long long t[RANKS];
#pragma unroll
        for (int j = 0; j < RANKS; ++j) {
            act |= (unsigned)(pb[j] < KB && pb[j] == gb && pfx[j] == gpfx) << j;
            t[j] = kk[j];
        }
        const int d1 = min(DIGIT, KB - gb), d2 = min(DIGIT, KB - gb - d1);
        sh1 = KB - gb - d1;
        sh2 = sh1 - d2;
        m2 = (1 << d2) - 1;
        gs0 = gs1 = -1;
        for (int i = tid; i < 1 << d1; i += THREADS) hist[i] = 0;
        if (tid < RANKS) f_cnt[tid] = 0;
        __syncthreads();
        if (j0 >= 0) {
            // the group's keys in cand
            for (int i = tid; i < in_cand; i += THREADS) {
                const unsigned off = cand[i] - gpfx;
                if (off <= span) atomicAdd(&hist[off >> sh1], 1u);
            }
            __syncthreads();
            find_bins(hist, 1 << d1, act, t, 0, f_bin, f_k, f_cnt, wsum);
            if (tid == 0) {
#pragma unroll
                for (int j = 0; j < RANKS; ++j) {
                    if (!((act >> j) & 1u)) continue;
                    st_pfx[j] = gpfx | ((unsigned)f_bin[j] << sh1);
                    st_pb[j] = gb + d1;
                    st_k[j] = f_k[j];
                    st_cnt[j] = f_cnt[j];
                }
            }
            continue;
        }
        // a pass over the row; first the sample guesses the ranks' bins,
        // and the first two bins it puts above CAP / 2 keys get a second
        // histogram
        if (d2 > 0) {
            walk(row, n, head, min(nch, SAMPLE / W), count);
            __syncthreads();
            const long long seen = find_bins(hist, 1 << d1, act, t,
                                             pick(cnt, g0), f_bin, f_k, f_cnt,
                                             wsum);
#pragma unroll
            for (int j = 0; j < RANKS; ++j) {
                const int b = f_bin[j];
                if (!((act >> j) & 1u) || b == gs0 || b == gs1 ||
                    (long long)f_cnt[j] * pick(cnt, g0) <=
                        (long long)(CAP / 2) * seen)
                    continue;
                if (gs0 < 0)
                    gs0 = b;
                else if (gs1 < 0)
                    gs1 = b;
            }
            for (int i = tid; i < 1 << d1; i += THREADS) hist[i] = 0;
            for (int i = tid; i <= m2; i += THREADS) {
                if (gs0 >= 0) cand[i] = 0;
                if (gs1 >= 0) cand[BINS + i] = 0;
            }
            __syncthreads();
        }
        walk(row, n, head, nch, count);
        if (__syncthreads_or(kmax > K::INF || kmin < K::NEG_INF)) {
            row_nan = true;
            break;
        }
        // a guessed bin's count is its own histogram's sum
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int g = s == 0 ? gs0 : gs1;
            if (g < 0) continue;
            unsigned sum = 0;
            for (int i = tid; i <= m2; i += THREADS) sum += cand[s * BINS + i];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
            if (lane == 0) atomicAdd(&hist[g], sum);
        }
        __syncthreads();
        find_bins(hist, 1 << d1, act, t, 0, f_bin, f_k, f_cnt, wsum);
        int b1[RANKS], k1[RANKS], c1[RANKS];
        long long t2[RANKS];
#pragma unroll
        for (int j = 0; j < RANKS; ++j) {
            b1[j] = f_bin[j];
            k1[j] = f_k[j];
            c1[j] = f_cnt[j];
            t2[j] = k1[j];
        }
        // the ranks that fell in a guessed bin, by its own histogram
        unsigned two = 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int g = s == 0 ? gs0 : gs1;
            if (g < 0) continue;
            unsigned in = 0;
#pragma unroll
            for (int j = 0; j < RANKS; ++j)
                in |= (unsigned)(((act >> j) & 1u) && b1[j] == g) << j;
            if (in == 0) continue;
            find_bins(cand + s * BINS, m2 + 1, in, t2, 0, f2_bin, f2_k, f2_cnt,
                      wsum);
            two |= in;
        }
        if (tid == 0) {
#pragma unroll
            for (int j = 0; j < RANKS; ++j) {
                if (!((act >> j) & 1u)) continue;
                const bool fine = (two >> j) & 1u;
                st_pfx[j] = gpfx | ((unsigned)b1[j] << sh1) |
                            (fine ? (unsigned)f2_bin[j] << sh2 : 0u);
                st_pb[j] = gb + d1 + (fine ? d2 : 0);
                st_k[j] = fine ? f2_k[j] : k1[j];
                st_cnt[j] = fine ? f2_cnt[j] : c1[j];
            }
        }
        gs0 = gs1 = -1;
    }
    if (tid != 0) return;
    if (row_nan) {
        out[blockIdx.x] = from_f32<T>(__uint_as_float(0x7fc00000u));
        return;
    }
    float qv[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const float lo = K::value(st_pfx[2 * p]);
        const float hi = K::value(st_pfx[2 * p + 1]);
        const float hw = __fmul_rn(hi, q.w[p]);
        qv[p] = to_f32(from_f32<T>(__fmaf_rn(lo, q.omw[p], hw)));
    }
    out[blockIdx.x] =
        from_f32<T>(__fmul_rn(to_f32(from_f32<T>(__fadd_rn(qv[0], qv[1]))),
                              0.5f));
}

template <typename T>
int launch(const void* x, const int C, const int n, const long long ld,
           const Quantiles& q, void* out, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        midpoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    midpoint_kernel<T><<<C, THREADS, SMEM, stream>>>(
        static_cast<const T*>(x), n, ld, q, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

// x [C, n] float32, or bfloat16 when bf16 is set, row r at x + r * ld
// elements, the elements of a row adjacent; lo0, hi0, lo1, hi1 in [0, n),
// the 0-based order statistics of q10 and q90; w0, w1 their upper weights
// and omw0, omw1 = 1 - w rounded to float32; out [C] of x's dtype.
SONDETPU_API int sondetpu_midpoint_dc(const void* x, int C, int n,
                                      long long ld, int bf16,
                                      int lo0, int hi0, int lo1, int hi1,
                                      float w0, float omw0, float w1,
                                      float omw1, void* out, void* stream) {
    const Quantiles q{{lo0, hi0, lo1, hi1}, {w0, w1}, {omw0, omw1}};
    if (C < 1 || n < 1 || ld < 0) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < RANKS; ++r)
        if (q.rank[r] < 0 || q.rank[r] >= n) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(x, C, n, ld, q, out, s)
                : launch<float>(x, C, n, ld, q, out, s);
}
