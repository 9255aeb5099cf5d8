// Native host-side FEC: batched Reed-Solomon / BCH / CRC16 decode.
//
// The reference's entire decode layer is a native C library (sondedump,
// SURVEY.md §2.3); this framework keeps the DSP on TPU but the per-frame
// FEC + integrity checks run on host, and at fleet scale (thousands of
// channels, hundreds of frames per block) they must be native too. The
// NumPy implementations in sondetpu_torch/fec/ remain the oracle and
// fallback; semantics here are matched to them exactly (same ok/nerr/revert
// rules) and locked by equivalence tests (tests/test_torch_host.py).
//
// A copy of sondetpu/native/sondefec.cpp, exposed via ctypes from
// sondetpu_torch/fec/native.py, which compiles it at first use. All arrays
// row-major, caller-allocated.

#include <cstddef>
#include <cstdint>
#include <atomic>
#include <cstring>
#include <mutex>

namespace {

constexpr int kMaxRoots = 32;  // >= any nroots we use (RS41: 24)

// ---------------------------------------------------------------------------
// GF(2^8) log/antilog tables (per primitive polynomial, cached)
// ---------------------------------------------------------------------------

struct GF256 {
  int prim = 0;
  int32_t exp[512];
  int32_t log[256];

  void init(int prim_poly) {
    prim = prim_poly;
    int x = 1;
    for (int i = 0; i < 255; ++i) {
      exp[i] = x;
      log[x] = i;
      x <<= 1;
      if (x & 0x100) x ^= prim_poly;
    }
    for (int i = 255; i < 510; ++i) exp[i] = exp[i - 255];
    exp[510] = exp[511] = exp[0];
    log[0] = 0;  // by convention; mul/div guard zero operands
  }

  inline int mul(int a, int b) const {
    return (a && b) ? exp[log[a] + log[b]] : 0;
  }
  inline int div(int a, int b) const {  // b != 0
    return a ? exp[(log[a] - log[b] + 255) % 255] : 0;
  }
};

const GF256 &gf256_for(int prim_poly) {
  // thread-safe bounded cache: host-worker pools call the batch decoders
  // concurrently. Readers see an entry only after its release-store, the
  // miss path serializes under a mutex, and a 5th+ distinct polynomial
  // lands in a thread_local scratch table instead of evicting (so no
  // reference another thread may still hold is ever invalidated).
  static GF256 cache[4];
  static std::atomic<int> n_cached{0};
  static std::mutex mu;
  int n = n_cached.load(std::memory_order_acquire);
  for (int i = 0; i < n; ++i)
    if (cache[i].prim == prim_poly) return cache[i];
  std::lock_guard<std::mutex> lk(mu);
  n = n_cached.load(std::memory_order_acquire);
  for (int i = 0; i < n; ++i)
    if (cache[i].prim == prim_poly) return cache[i];
  if (n < 4) {
    cache[n].init(prim_poly);
    n_cached.store(n + 1, std::memory_order_release);
    return cache[n];
  }
  thread_local GF256 scratch;
  if (scratch.prim != prim_poly) scratch.init(prim_poly);
  return scratch;
}

// ---------------------------------------------------------------------------
// Reed-Solomon decode, one (possibly shortened) codeword.
// Mirrors sondetpu/fec/rs.py semantics: Chien roots counted inside the
// received window only; magnitudes applied only where lambda'(Xinv) != 0;
// ok = no_err | (nroots_found == L && 0 < L <= t); input reverted when !ok.
// ---------------------------------------------------------------------------

void rs_decode_one(uint8_t *r, int n, int nroots, int fcr, const GF256 &gf,
                   int32_t *nerr_out, uint8_t *ok_out) {
  int S[kMaxRoots];
  bool any = false;
  for (int i = 0; i < nroots; ++i) S[i] = 0;
  for (int j = 0; j < n; ++j) {
    const int c = r[j];
    if (!c) continue;
    const int lc = gf.log[c];
    const int deg = n - 1 - j;
    for (int i = 0; i < nroots; ++i)
      S[i] ^= gf.exp[(lc + deg * (fcr + i)) % 255];
  }
  for (int i = 0; i < nroots; ++i) any |= (S[i] != 0);
  if (!any) {
    *nerr_out = 0;
    *ok_out = 1;
    return;
  }

  // Berlekamp-Massey
  int C[kMaxRoots + 1] = {1}, B[kMaxRoots + 1] = {1}, T[kMaxRoots + 1];
  int L = 0, m = 1, b = 1;
  for (int i = 0; i < nroots; ++i) {
    int d = S[i];
    for (int j = 1; j <= L; ++j) d ^= gf.mul(C[j], S[i - j]);
    if (d == 0) {
      ++m;
    } else if (2 * L <= i) {
      std::memcpy(T, C, sizeof(T));
      const int coef = gf.div(d, b);
      for (int j = 0; j + m <= nroots; ++j) C[j + m] ^= gf.mul(coef, B[j]);
      L = i + 1 - L;
      std::memcpy(B, T, sizeof(B));
      b = d;
      m = 1;
    } else {
      const int coef = gf.div(d, b);
      for (int j = 0; j + m <= nroots; ++j) C[j + m] ^= gf.mul(coef, B[j]);
      ++m;
    }
  }

  // Omega = S * C mod x^nroots
  int Om[kMaxRoots];
  for (int i = 0; i < nroots; ++i) {
    int acc = 0;
    for (int j = 0; j <= i; ++j) acc ^= gf.mul(S[j], C[i - j]);
    Om[i] = acc;
  }

  // Chien search over the received window (degree p = 0..n-1) + Forney
  int n_found = 0, n_applied = 0;
  int applied_idx[kMaxRoots];
  uint8_t applied_mag[kMaxRoots];
  for (int p = 0; p < n; ++p) {
    // lambda(alpha^{-p}); all nroots+1 coefficients, matching the NumPy
    // oracle exactly even for degenerate >t-error locator polynomials
    int lam = 0;
    for (int i = 0; i <= nroots; ++i) {
      if (!C[i]) continue;
      lam ^= gf.exp[(gf.log[C[i]] + ((255 - p) % 255) * i % 255) % 255];
    }
    if (lam != 0) continue;
    ++n_found;
    // lambda'(alpha^{-p}): odd-power terms, derivative shifts degree by 1
    int dlam = 0;
    for (int i = 1; i <= nroots; i += 2) {
      if (!C[i]) continue;
      dlam ^= gf.exp[(gf.log[C[i]] + ((255 - p) % 255) * (i - 1) % 255) % 255];
    }
    if (dlam == 0) continue;  // counted as root, magnitude not applicable
    int om = 0;
    for (int i = 0; i < nroots; ++i) {
      if (!Om[i]) continue;
      om ^= gf.exp[(gf.log[Om[i]] + ((255 - p) % 255) * i % 255) % 255];
    }
    const int xfcr = gf.exp[((1 - fcr) * p % 255 + 255) % 255];
    const int mag = gf.mul(xfcr, gf.div(om, dlam));
    if (n_applied < kMaxRoots) {
      applied_idx[n_applied] = n - 1 - p;
      applied_mag[n_applied] = static_cast<uint8_t>(mag);
      ++n_applied;
    }
  }

  const bool ok = (n_found == L) && (L > 0) && (L <= nroots / 2);
  if (ok) {
    for (int a = 0; a < n_applied; ++a) r[applied_idx[a]] ^= applied_mag[a];
  }
  *nerr_out = n_found;
  *ok_out = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// GF(2^6) for BCH(63,51) t=2 (Meisei iMS-100 / RS-11G)
// ---------------------------------------------------------------------------

struct GF64 {
  int32_t exp[128];
  int32_t log[64];
  GF64() {
    int x = 1;
    for (int i = 0; i < 63; ++i) {
      exp[i] = x;
      log[x] = i;
      x <<= 1;
      if (x & 0x40) x ^= 0x43;  // x^6 + x + 1
    }
    for (int i = 63; i < 126; ++i) exp[i] = exp[i - 63];
    exp[126] = exp[127] = exp[0];
    log[0] = 0;
  }
  inline int mul(int a, int b) const {
    return (a && b) ? exp[log[a] + log[b]] : 0;
  }
  inline int div(int a, int b) const {
    return a ? exp[(log[a] - log[b] + 63) % 63] : 0;
  }
};

const GF64 kGF64;

void bch63_decode_one(uint8_t *bits, int32_t *nerr_out, uint8_t *ok_out) {
  constexpr int n = 63, t = 2, t2 = 4;
  const GF64 &gf = kGF64;
  int S[t2] = {0, 0, 0, 0};
  for (int j = 0; j < n; ++j) {
    if (!bits[j]) continue;
    const int deg = n - 1 - j;
    for (int i = 1; i <= t2; ++i) S[i - 1] ^= gf.exp[(deg * i) % 63];
  }
  if (!(S[0] | S[1] | S[2] | S[3])) {
    *nerr_out = 0;
    *ok_out = 1;
    return;
  }

  int C[t2 + 1] = {1}, B[t2 + 1] = {1}, T[t2 + 1];
  int L = 0, m = 1, b = 1;
  for (int i = 0; i < t2; ++i) {
    int d = S[i];
    for (int j = 1; j <= L; ++j) d ^= gf.mul(C[j], S[i - j]);
    if (d == 0) {
      ++m;
    } else if (2 * L <= i) {
      std::memcpy(T, C, sizeof(T));
      const int coef = gf.div(d, b);
      for (int j = 0; j + m <= t2; ++j) C[j + m] ^= gf.mul(coef, B[j]);
      L = i + 1 - L;
      std::memcpy(B, T, sizeof(B));
      b = d;
      m = 1;
    } else {
      const int coef = gf.div(d, b);
      for (int j = 0; j + m <= t2; ++j) C[j + m] ^= gf.mul(coef, B[j]);
      ++m;
    }
  }

  int n_found = 0;
  int flip_idx[t2];
  for (int p = 0; p < n; ++p) {
    int lam = 0;
    for (int i = 0; i <= t2; ++i) {
      if (!C[i]) continue;
      lam ^= gf.exp[(gf.log[C[i]] + ((63 - p) % 63) * i % 63) % 63];
    }
    if (lam == 0) {
      if (n_found < t2) flip_idx[n_found] = n - 1 - p;
      ++n_found;
    }
  }
  const bool ok = (n_found == L) && (L > 0) && (L <= t);
  if (ok)
    for (int a = 0; a < n_found; ++a) bits[flip_idx[a]] ^= 1;
  *nerr_out = n_found;
  *ok_out = ok ? 1 : 0;
}

// ---------------------------------------------------------------------------
// CRC16-CCITT (poly 0x1021), table-driven
// ---------------------------------------------------------------------------

struct CrcTable {
  uint16_t t[256];
  CrcTable() {
    for (int bb = 0; bb < 256; ++bb) {
      uint32_t r = bb << 8;
      for (int k = 0; k < 8; ++k)
        r = (r & 0x8000) ? ((r << 1) ^ 0x1021) & 0xFFFF : (r << 1) & 0xFFFF;
      t[bb] = static_cast<uint16_t>(r);
    }
  }
};
const CrcTable kCrc;

}  // namespace

extern "C" {

// recv: [batch, n] row-major, corrected in place. nerr/ok: [batch].
void fec_rs_decode_batch(uint8_t *recv, int64_t batch, int64_t n, int nroots,
                         int fcr, int prim_poly, int32_t *nerr, uint8_t *ok) {
  const GF256 &gf = gf256_for(prim_poly);
  for (int64_t f = 0; f < batch; ++f)
    rs_decode_one(recv + f * n, static_cast<int>(n), nroots, fcr, gf,
                  nerr + f, ok + f);
}

// bits: [batch, 63] 0/1 bytes, corrected in place. BCH(63,51) t=2.
void fec_bch63_decode_batch(uint8_t *bits, int64_t batch, int32_t *nerr,
                            uint8_t *ok) {
  for (int64_t f = 0; f < batch; ++f)
    bch63_decode_one(bits + f * 63, nerr + f, ok + f);
}

// data: [batch, n] row-major -> out: [batch] CRC16-CCITT with given init.
void fec_crc16_batch(const uint8_t *data, int64_t batch, int64_t n,
                     uint16_t init, uint16_t *out) {
  for (int64_t f = 0; f < batch; ++f) {
    const uint8_t *row = data + f * n;
    uint16_t crc = init;
    for (int64_t i = 0; i < n; ++i)
      crc = static_cast<uint16_t>((crc << 8) ^ kCrc.t[(crc >> 8) ^ row[i]]);
    out[f] = crc;
  }
}

}  // extern "C"
