// Native PNG defilter: the host defilter of the port's default PNG route.
//
// A whole copy, with the same C ABI, of zpix_tpu/runtime/defilter.cpp
// (zpix_defilter :146, zpix_defilter_batch :216, the SSE2 arms behind
// __SSE2__).  Filter semantics mirror the reference's
// src/png/decoder.zig:806-842 and filterPaeth (:1152-1182): per-row filter
// byte, wrapping adds, Paeth tie-break a <= b <= c.  Rows are serially
// dependent (previous row), the byte recurrences within Sub/Avg/Paeth are
// stride-bpp dependent; images in a batch are independent and decode on a
// thread pool.
//
// Built by zpix_tpu_torch/runtime/host.py with
//   g++ -O3 -std=c++17 -fPIC -shared -lpthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#define ZPIX_SSE2 1
#endif

namespace {

inline uint8_t paeth(uint8_t a, uint8_t b, uint8_t c) {
  int p = int(a) + int(b) - int(c);
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

#ifdef ZPIX_SSE2
// SIMD row kernels for bpp 3/4 (tc8/tca8, the hot color depths).  The
// math matches the scalar loops bit-for-bit: wrapping byte adds, floor
// average, Paeth tie-break a <= b <= c (decoder.zig:1152-1182).  Loads
// are 4-byte; for bpp=3 the 4th lane is masked garbage (input has the
// next row's filter byte as slack; prev-row reads stay inside out).
// Stores write only bpp bytes.

inline __m128i load4(const uint8_t* p) {
  // memcpy: unaligned type-punned loads are UB; this compiles to one mov
  int32_t w;
  memcpy(&w, p, 4);
  return _mm_cvtsi32_si128(w);
}
inline void store_px(uint8_t* p, __m128i v, int32_t bpp) {
  int32_t w = _mm_cvtsi128_si32(v);
  if (bpp == 4) {
    memcpy(p, &w, 4);
  } else {
    p[0] = uint8_t(w);
    p[1] = uint8_t(w >> 8);
    p[2] = uint8_t(w >> 16);
  }
}

// filter 1 (Sub): cur[i] = src[i] + cur[i-bpp]
inline void row_sub_sse(const uint8_t* src, uint8_t* cur, int64_t row_bytes,
                        int32_t bpp) {
  int64_t i = 0;
  for (; i < bpp && i < row_bytes; i++) cur[i] = src[i];
  __m128i d = load4(cur);
  for (; i + 4 <= row_bytes; i += bpp) {
    d = _mm_add_epi8(d, load4(src + i));
    store_px(cur + i, d, bpp);
  }
  for (; i < row_bytes; i++) cur[i] = uint8_t(src[i] + cur[i - bpp]);
}

// filter 2 (Up): cur[i] = src[i] + prev[i] — fully vector
inline void row_up_sse(const uint8_t* src, const uint8_t* prev, uint8_t* cur,
                       int64_t row_bytes) {
  int64_t i = 0;
  for (; i + 16 <= row_bytes; i += 16) {
    __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
    __m128i p = _mm_loadu_si128(reinterpret_cast<const __m128i*>(prev + i));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(cur + i), _mm_add_epi8(s, p));
  }
  for (; i < row_bytes; i++) cur[i] = uint8_t(src[i] + prev[i]);
}

// filter 3 (Average): cur[i] = src[i] + (cur[i-bpp] + prev[i]) / 2
inline void row_avg_sse(const uint8_t* src, const uint8_t* prev, uint8_t* cur,
                        int64_t row_bytes, int32_t bpp) {
  const __m128i zero = _mm_setzero_si128();
  const __m128i lo8 = _mm_set1_epi16(0xFF);
  int64_t i = 0;
  for (; i < bpp && i < row_bytes; i++)
    cur[i] = uint8_t(src[i] + prev[i] / 2);
  __m128i a16 = _mm_unpacklo_epi8(load4(cur), zero);
  for (; i + 4 <= row_bytes; i += bpp) {
    __m128i s16 = _mm_unpacklo_epi8(load4(src + i), zero);
    __m128i b16 = _mm_unpacklo_epi8(load4(prev + i), zero);
    __m128i avg = _mm_srli_epi16(_mm_add_epi16(a16, b16), 1);
    a16 = _mm_and_si128(_mm_add_epi16(s16, avg), lo8);
    store_px(cur + i, _mm_packus_epi16(a16, zero), bpp);
  }
  for (; i < row_bytes; i++)
    cur[i] = uint8_t(src[i] + (int(cur[i - bpp]) + int(prev[i])) / 2);
}

// filter 4 (Paeth), branchless 16-bit select per pixel
inline void row_paeth_sse(const uint8_t* src, const uint8_t* prev,
                          uint8_t* cur, int64_t row_bytes, int32_t bpp) {
  const __m128i zero = _mm_setzero_si128();
  const __m128i lo8 = _mm_set1_epi16(0xFF);
  int64_t i = 0;
  for (; i < bpp && i < row_bytes; i++) cur[i] = uint8_t(src[i] + prev[i]);
  __m128i a16 = _mm_unpacklo_epi8(load4(cur), zero);
  __m128i c16 = _mm_unpacklo_epi8(load4(prev), zero);
  for (; i + 4 <= row_bytes; i += bpp) {
    __m128i b16 = _mm_unpacklo_epi8(load4(prev + i), zero);
    __m128i s16 = _mm_unpacklo_epi8(load4(src + i), zero);
    __m128i p = _mm_sub_epi16(_mm_add_epi16(a16, b16), c16);
    __m128i da = _mm_sub_epi16(p, a16);
    __m128i db = _mm_sub_epi16(p, b16);
    __m128i dc = _mm_sub_epi16(p, c16);
    __m128i pa = _mm_max_epi16(da, _mm_sub_epi16(zero, da));
    __m128i pb = _mm_max_epi16(db, _mm_sub_epi16(zero, db));
    __m128i pc = _mm_max_epi16(dc, _mm_sub_epi16(zero, dc));
    // choose a iff pa<=pb && pa<=pc; else b iff pb<=pc; else c
    __m128i not_a =
        _mm_or_si128(_mm_cmpgt_epi16(pa, pb), _mm_cmpgt_epi16(pa, pc));
    __m128i not_b = _mm_cmpgt_epi16(pb, pc);
    __m128i bc = _mm_or_si128(_mm_and_si128(not_b, c16),
                              _mm_andnot_si128(not_b, b16));
    __m128i pred =
        _mm_or_si128(_mm_and_si128(not_a, bc), _mm_andnot_si128(not_a, a16));
    a16 = _mm_and_si128(_mm_add_epi16(s16, pred), lo8);
    store_px(cur + i, _mm_packus_epi16(a16, zero), bpp);
    c16 = b16;
  }
  for (; i < row_bytes; i++)
    cur[i] = uint8_t(src[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
}
#endif  // ZPIX_SSE2

}  // namespace

extern "C" {

// Defilter `height` rows of (1 + row_bytes) input into out[height][row_bytes].
// Returns 0, or 1 on an invalid filter byte.
int zpix_defilter(const uint8_t* raw, int64_t height, int64_t row_bytes,
                  int32_t bpp, uint8_t* out) {
  std::vector<uint8_t> zero(row_bytes, 0);
  const uint8_t* prev = zero.data();
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* in = raw + y * (row_bytes + 1);
    uint8_t* cur = out + y * row_bytes;
    uint8_t f = in[0];
    const uint8_t* src = in + 1;
#ifdef ZPIX_SSE2
    const bool simd = (bpp == 3 || bpp == 4) && row_bytes >= 8;
#else
    const bool simd = false;
#endif
    switch (f) {
      case 0:
        memcpy(cur, src, row_bytes);
        break;
      case 1:
#ifdef ZPIX_SSE2
        if (simd) {
          row_sub_sse(src, cur, row_bytes, bpp);
          break;
        }
#endif
        memcpy(cur, src, bpp < row_bytes ? bpp : row_bytes);
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + cur[i - bpp]);
        break;
      case 2:
#ifdef ZPIX_SSE2
        row_up_sse(src, prev, cur, row_bytes);
#else
        for (int64_t i = 0; i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + prev[i]);
#endif
        break;
      case 3:
#ifdef ZPIX_SSE2
        if (simd) {
          row_avg_sse(src, prev, cur, row_bytes, bpp);
          break;
        }
#endif
        for (int64_t i = 0; i < bpp && i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + prev[i] / 2);
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + (int(cur[i - bpp]) + int(prev[i])) / 2);
        break;
      case 4:
#ifdef ZPIX_SSE2
        if (simd) {
          row_paeth_sse(src, prev, cur, row_bytes, bpp);
          break;
        }
#endif
        for (int64_t i = 0; i < bpp && i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + prev[i]);
        for (int64_t i = bpp; i < row_bytes; i++)
          cur[i] = uint8_t(src[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        break;
      default:
        return 1;
    }
    prev = cur;
  }
  return 0;
}

// Batch variant: n independent images on a thread pool.
int zpix_defilter_batch(const uint8_t** raws, int64_t height,
                        int64_t row_bytes, int32_t bpp, uint8_t** outs,
                        int32_t n_images, int32_t n_threads) {
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> err{0};
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n_images) return;
      if (zpix_defilter(raws[i], height, row_bytes, bpp, outs[i]) != 0)
        err.store(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return err.load();
}

}  // extern "C"
