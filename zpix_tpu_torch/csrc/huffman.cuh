// Bit reading and canonical Huffman decode shared by the entropy kernels
// (K1, K2, K8-K10, K19), with the packed table layout they read.
#pragma once
#include <cstdint>

namespace zpix {

// Layout of the int32 table tensor (keep in step with ops/entropy.py).
constexpr int kTabLims = 0;       // [8 tables][16] code-length limits
constexpr int kTabAoff = 128;     // [8 tables][16] value-index offsets
constexpr int kTabVals = 256;     // [2048] symbol bytes, all tables concatenated
constexpr int kTabSlotDc = 2304;  // [16] DC table of each MCU slot
constexpr int kTabSlotAc = 2320;  // [16] AC table of each MCU slot
constexpr int kTabNvals = 2336;   // number of symbol bytes
constexpr int kTabQuant = 2368;   // [4 components][64] natural-order quant
constexpr int kTabEntropyWords = 2340;  // the part K1/K2 stage in shared memory

static __constant__ int8_t kUnzig[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A 64-bit big-endian window of the stream.  ``at(pos)`` makes bits
// [pos, pos + 32) readable; the caller has checked that the 8 bytes from
// pos >> 3 lie inside the buffer.
struct BitWindow {
  const uint8_t* s;
  int64_t wbyte;  // byte index of the window's first bit
  uint64_t win;

  __device__ void at(int64_t pos) {
    if (pos - wbyte * 8 > 32 || pos < wbyte * 8) {
      const int64_t b = pos >> 3;
      uint64_t v = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) v = (v << 8) | __ldg(s + b + i);
      win = v;
      wbyte = b;
    }
  }
  // n in [1, 32] bits from pos, right-aligned; pos + n within the window.
  __device__ uint32_t bits(int64_t pos, int n) const {
    const int off = static_cast<int>(pos - wbyte * 8);
    return static_cast<uint32_t>((win << off) >> (64 - n));
  }
};

struct Sym {
  int len, sym;
  bool bad;
};

// Canonical decode of the 16-bit lookahead ``look`` with table t, by the
// limit-compare form of zpix_tpu's CmpTables (device_entropy.py:76-140):
// len = 1 + #{i < 15 : look >= lims[i]}, invalid iff look >= lims[15].
__device__ __forceinline__ Sym decode_sym(const int32_t* tab, int t,
                                          int32_t look) {
  const int32_t* lims = tab + kTabLims + 16 * t;
  const int32_t* aoff = tab + kTabAoff + 16 * t;
  int len = 1, a = aoff[0];
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    if (look >= lims[i]) {
      ++len;
      a += aoff[i + 1] - aoff[i];
    }
  }
  Sym r;
  r.len = len;
  r.bad = look >= lims[15];
  const int vidx = a + (look >> (16 - len));
  r.sym = (vidx >= 0 && vidx < tab[kTabNvals]) ? tab[kTabVals + vidx] : 0;
  return r;
}

// Whether table t's limits lims[0..14] never decrease (every table
// ops/entropy.py::pack_tables writes): then the compares that hold are a
// prefix of them.
__device__ __forceinline__ bool lims_sorted(const int32_t* tab, int t) {
  const int32_t* lims = tab + kTabLims + 16 * t;
  bool ok = true;
#pragma unroll
  for (int i = 1; i < 15; ++i) ok &= lims[i - 1] <= lims[i];
  return ok;
}

// decode_sym's result.  With sorted limits (lims_sorted) the compares that
// hold are a prefix, found by binary search, and the value offset
// telescopes to aoff[len - 1].
__device__ __forceinline__ Sym decode_full(const int32_t* tab, bool sorted, int t,
                                           int32_t look) {
  if (!sorted) return decode_sym(tab, t, look);
  const int32_t* lims = tab + kTabLims + 16 * t;
  int c = 0;  // #{i < 15 : look >= lims[i]}
#pragma unroll
  for (int step = 8; step; step >>= 1) {
    if (c + step <= 15 && look >= lims[c + step - 1]) c += step;
  }
  Sym r;
  r.len = c + 1;
  r.bad = look >= lims[15];
  const int vidx = tab[kTabAoff + 16 * t + c] + (look >> (15 - c));
  r.sym = (vidx >= 0 && vidx < tab[kTabNvals]) ? tab[kTabVals + vidx] : 0;
  return r;
}

// RECEIVE + EXTEND (T.81 F.2.2.1) of ``size`` bits at pos, with the JAX
// value pass's clipping: at most 16 bits are read.
__device__ __forceinline__ int32_t receive_extend(const BitWindow& w,
                                                  int64_t pos, int size) {
  if (size <= 0) return 0;
  const int sz = size < 16 ? size : 16;
  const int32_t raw = static_cast<int32_t>(w.bits(pos, sz));
  const int top = size - 1 < 15 ? size - 1 : 15;
  return raw < (1 << top) ? raw - ((1 << sz) - 1) : raw;
}

}  // namespace zpix
