// K17: PNG expansion -- defiltered rows -> premultiplied RGBA8, placed on
// the canvas (the Adam7 scatter included).
//
// Replaces zpix_tpu/parallel/png_batch.py::_expand_graph (:299) with its
// arms (:129-276), and the strided scatter of _interlaced_graph (:278).
// Input: rows [B, h, row_bytes] u8 (one pass's, or the image's), the
// per-image palettes [B, 256, 4] u8 (premultiplied on the host, opaque
// black past the real palette; paletted depths only) and tRNS keys
// [B, 3] int32 (-1 = no key, never matches; or null).  Pixel x of row y of
// the pass lands at (yo + y * yf, xo + x * xf) of the canvas [B, H, W, 4];
// a whole image is the pass (0, 0, 1, 1).
// Per arm, exactly as the JAX graph and the host decoder's rgba_pixels:
//  * g1/g2/g4: the sample is bits [x * d, x * d + d) of the row, MSB
//    first, scaled by 0xFF/0x55/0x11; g8 the byte; g16 the big-endian
//    word >> 8; gray to (g, g, g, 255);
//  * tc8 (r, g, b, 255); tc16 each word >> 8;
//  * the key (g*, tc8, tc16): a pixel whose samples all equal the image's
//    key -- compared in the 16-bit domain for g16/tc16, after scaling for
//    g1/g2/g4 (the key arrives scaled by _parse_trns) -- becomes (0,0,0,0);
//  * tca8/ga8: ((c | c << 8) * a / 0xFF) >> 8, alpha a;
//  * tca16/ga16: (c * a / 0xFFFF) >> 8, alpha a >> 8, in uint32 (the JAX
//    graph multiplies in int32 and wraps for c * a >= 2^31; the port
//    follows the host decoder there, see ROADMAP queue 3);
//  * p1/p2/p4/p8: the index as the gray sample, then the palette entry.
// A CTA of 256 threads takes whole rows of one image: the image is
// blockIdx.y (a grid-stride loop past 65,535 images), the row blockIdx.x *
// (rows a CTA) + the thread's row slot, a power of two of threads a row, so
// that no thread divides.  A thread computes 4 consecutive pixels at a
// time: it reads their bytes as words (16-byte loads where the arm takes 16
// or 32 bytes and the rows are 16-byte aligned), or, for g1/g2/g4 and
// p1/p2/p4, the word that holds their bits, and writes them with one
// 16-byte store where the placement allows (xf == 1 and an aligned canvas
// row).  Other placements (Adam7's xf of 2, 4, 8) pass a warp's pixels
// through shared memory, so that each word store of the warp writes 32
// consecutive pixels of the pass.  The paths are picked at launch from the
// pointers' alignment, row_bytes and the placement; rows not 4-byte
// aligned, and a row's last group when the width is no multiple of 4, read
// bytes (bounds-checked).  A paletted CTA stages its image's palette in
// shared memory; the key is read once a thread.  One template instance an
// arm and depth, so a thread's byte picks are constants.
// Bound on the H100: bytes (the rows in, 4 bytes a pixel out); a few
// integer operations a pixel.
#include <cuda_runtime.h>

#include <cstdint>

#include "timing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // pixels a thread computes at a time

// Arms, as ops/png.py's ARMS numbers them.
enum Arm { kGray = 0, kGray16 = 1, kTc8 = 2, kTc16 = 3, kTca8 = 4, kTca16 = 5, kGa8 = 6,
           kGa16 = 7, kPal = 8 };

__host__ __device__ constexpr int pixel_bits(int arm, int depth) {
  return arm == kGray || arm == kPal ? depth
         : arm == kGray16 || arm == kGa8 ? 16
         : arm == kTc8 ? 24
         : arm == kTca8 || arm == kGa16 ? 32
         : arm == kTc16 ? 48
         : 64;  // kTca16
}

__device__ __forceinline__ uint32_t pre8(uint32_t c, uint32_t a) {
  return (((c | c << 8) * a) / 0xFF) >> 8;
}

__device__ __forceinline__ uint32_t pre16(uint32_t c, uint32_t a) {
  return ((c * a) / 0xFFFF) >> 8;  // c * a <= 0xFFFE0001 fits uint32
}

__device__ __forceinline__ uint32_t rgba(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return r | (g << 8) | (b << 16) | (a << 24);  // the bytes R, G, B, A
}

struct ExpandArgs {
  const uint8_t* rows;
  const uint32_t* pal;
  const int32_t* key;
  uint32_t* out;
  int B, h, w, row_bytes, out_h, out_w, xo, yo, xf, yf;
  int lg_tpr;           // log2 of the threads a row
  bool words, vec16;    // rows 4-byte (16-byte) aligned, row_bytes too
  bool vec_out;         // xf == 1, xo % 4 == 0, out_w % 4 == 0, out 16-byte aligned
};

// The bytes of a group of 4 pixels (arms of 8 bits a pixel or more: kNW
// words, byte i at bits 8 * (i % 4) of word i / 4), or the word that holds
// them (sub-byte depths).
template <int kBits>
struct Group {
  static constexpr int kNW = kBits >= 8 ? kBits / 8 : 1;
  uint32_t wd[kNW];
  __device__ __forceinline__ uint32_t byte(int i) const {
    return (wd[i >> 2] >> (8 * (i & 3))) & 0xFF;
  }
  __device__ __forceinline__ uint32_t be16(int i) const { return byte(i) << 8 | byte(i + 1); }
};

// Group g of a row: word loads where ``fast`` (the rows word-aligned and
// the group inside the row), else bytes, zero past the row's end.
template <int kBits>
__device__ __forceinline__ Group<kBits> load_group(const uint8_t* row, int g, int row_bytes,
                                                   bool fast, bool vec16) {
  Group<kBits> grp;
  constexpr int kNW = Group<kBits>::kNW;
  // byte offset of the group (of its word, for sub-byte depths)
  const int at = kBits >= 8 ? g * kNW * 4 : ((g * kGroup * kBits) >> 5) << 2;
  if (fast) {
    if (kNW % 4 == 0 && vec16) {
#pragma unroll
      for (int j = 0; j < kNW / 4; ++j) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + at) + j);
        grp.wd[4 * j] = v.x;
        grp.wd[4 * j + 1] = v.y;
        grp.wd[4 * j + 2] = v.z;
        grp.wd[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNW; ++j) grp.wd[j] = __ldg(reinterpret_cast<const uint32_t*>(row + at) + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNW; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = at + 4 * j + i;
        if (o < row_bytes) v |= static_cast<uint32_t>(row[o]) << (8 * i);
      }
      grp.wd[j] = v;
    }
  }
  return grp;
}

// Pixel k (0-3) of group g, by the arm's arithmetic; k0-k2 the image's key
// (-1: none, never matches).
template <int kArm, int kDepth>
__device__ __forceinline__ uint32_t pixel(const Group<pixel_bits(kArm, kDepth)>& grp, int g,
                                          int k, const uint32_t* s_pal, int k0, int k1, int k2) {
  if (kArm == kGray || kArm == kPal) {
    uint32_t v;
    if (kDepth == 8) {
      v = grp.byte(k);
    } else {  // MSB first: the big-endian word's bits from the top
      const int bit = ((g * kGroup * kDepth) & 31) + k * kDepth;
      v = (__byte_perm(grp.wd[0], 0, 0x0123) >> (32 - kDepth - bit)) & ((1u << kDepth) - 1);
    }
    if (kArm == kPal) return s_pal[v];
    const uint32_t gv = (v * (kDepth == 1 ? 0xFF : kDepth == 2 ? 0x55 : kDepth == 4 ? 0x11 : 1))
                        & 0xFF;
    return static_cast<int>(gv) == k0 ? 0 : rgba(gv, gv, gv, 0xFF);
  } else if (kArm == kGray16) {
    const uint32_t gv = grp.be16(2 * k);
    return static_cast<int>(gv) == k0 ? 0 : rgba(gv >> 8, gv >> 8, gv >> 8, 0xFF);
  } else if (kArm == kTc8) {
    const uint32_t r = grp.byte(3 * k), gg = grp.byte(3 * k + 1), b = grp.byte(3 * k + 2);
    const bool hit = static_cast<int>(r) == k0 && static_cast<int>(gg) == k1 &&
                     static_cast<int>(b) == k2;
    return hit ? 0 : rgba(r, gg, b, 0xFF);
  } else if (kArm == kTc16) {
    const uint32_t r = grp.be16(6 * k), gg = grp.be16(6 * k + 2), b = grp.be16(6 * k + 4);
    const bool hit = static_cast<int>(r) == k0 && static_cast<int>(gg) == k1 &&
                     static_cast<int>(b) == k2;
    return hit ? 0 : rgba(r >> 8, gg >> 8, b >> 8, 0xFF);
  } else if (kArm == kTca8) {
    const uint32_t a = grp.byte(4 * k + 3);
    return rgba(pre8(grp.byte(4 * k), a), pre8(grp.byte(4 * k + 1), a),
                pre8(grp.byte(4 * k + 2), a), a);
  } else if (kArm == kTca16) {
    const uint32_t a = grp.be16(8 * k + 6);
    return rgba(pre16(grp.be16(8 * k), a), pre16(grp.be16(8 * k + 2), a),
                pre16(grp.be16(8 * k + 4), a), a >> 8);
  } else if (kArm == kGa8) {
    const uint32_t a = grp.byte(2 * k + 1), gv = pre8(grp.byte(2 * k), a);
    return rgba(gv, gv, gv, a);
  } else {  // kGa16
    const uint32_t a = grp.be16(4 * k + 2), gv = pre16(grp.be16(4 * k), a);
    return rgba(gv, gv, gv, a >> 8);
  }
}

// The 4 pixels of group g of a row (zero past the row's end).
template <int kArm, int kDepth>
__device__ __forceinline__ void group_pixels(const ExpandArgs& a, const uint8_t* row, int g,
                                             bool full, const uint32_t* s_pal, int k0, int k1,
                                             int k2, uint32_t* px) {
  const Group<pixel_bits(kArm, kDepth)> grp = load_group<pixel_bits(kArm, kDepth)>(
      row, g, a.row_bytes, a.words && full, a.vec16);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) px[k] = pixel<kArm, kDepth>(grp, g, k, s_pal, k0, k1, k2);
}

// kExchange: the placement takes word stores (a.vec_out false), made
// through shared memory so that each store of a warp writes 32
// consecutive pixels of the pass; else 16-byte stores.
template <int kArm, int kDepth, bool kExchange>
__global__ void __launch_bounds__(kThreads) expand_kernel(const ExpandArgs a) {
  __shared__ uint32_t s_pal[kArm == kPal ? 256 : 1];
  __shared__ __align__(16) uint32_t s_px[kExchange ? kThreads * kGroup : 4];
  const int tid = threadIdx.x, lane = tid & 31, warp0 = tid & ~31;
  const int tpr = 1 << a.lg_tpr;
  const int y0 = blockIdx.x * (kThreads >> a.lg_tpr);  // the CTA's first row
  const int y = y0 + (tid >> a.lg_tpr);
  const int j = tid & (tpr - 1);
  const int groups = (a.w + kGroup - 1) / kGroup;
  const int64_t row_step = static_cast<int64_t>(a.yf) * a.out_w;  // canvas words a pass row
  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    if (kArm == kPal) {
      __syncthreads();  // the last image's palette is read
      s_pal[tid] = __ldg(a.pal + static_cast<int64_t>(b) * 256 + tid);
      __syncthreads();
    }
    int k0 = -1, k1 = -1, k2 = -1;
    if (a.key != nullptr) {
      k0 = __ldg(a.key + 3 * b);
      k1 = __ldg(a.key + 3 * b + 1);
      k2 = __ldg(a.key + 3 * b + 2);
    }
    const uint8_t* const rows = a.rows + static_cast<int64_t>(b) * a.h * a.row_bytes;
    uint32_t* const canvas = a.out + (static_cast<int64_t>(b) * a.out_h + a.yo) * a.out_w + a.xo;
    if (!kExchange) {
      if (y >= a.h) continue;
      const uint8_t* row = rows + static_cast<int64_t>(y) * a.row_bytes;
      uint32_t* orow = canvas + y * row_step;
      for (int g = j; g < groups; g += tpr) {
        const int x0 = g * kGroup;
        const bool full = x0 + kGroup <= a.w;
        uint32_t px[kGroup];
        group_pixels<kArm, kDepth>(a, row, g, full, s_pal, k0, k1, k2, px);
        if (full) {
          *reinterpret_cast<uint4*>(orow + x0) = make_uint4(px[0], px[1], px[2], px[3]);
        } else {  // a row's last group
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (x0 + k < a.w) orow[x0 + k] = px[k];
          }
        }
      }
    } else {
      for (int g0 = 0; g0 < groups; g0 += tpr) {  // as many rounds for every thread
        const int g = g0 + j;
        uint32_t px[kGroup] = {};
        if (y < a.h && g < groups) {
          group_pixels<kArm, kDepth>(a, rows + static_cast<int64_t>(y) * a.row_bytes, g,
                                     (g + 1) * kGroup <= a.w, s_pal, k0, k1, k2, px);
        }
        // the warp's pixel i is thread i / 4's pixel i % 4
        reinterpret_cast<uint4*>(s_px)[tid] = make_uint4(px[0], px[1], px[2], px[3]);
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int i = 32 * k + lane, src = warp0 + (i >> 2);
          const int sy = y0 + (src >> a.lg_tpr);
          const int sx = (g0 + (src & (tpr - 1))) * kGroup + (i & 3);
          if (sy < a.h && sx < a.w)
            canvas[sy * row_step + static_cast<int64_t>(sx) * a.xf] = s_px[warp0 * kGroup + i];
        }
        __syncwarp();
      }
    }
  }
}

template <int kArm, int kDepth>
void launch(const ExpandArgs& a, dim3 grid, cudaStream_t st) {
  if (a.vec_out) expand_kernel<kArm, kDepth, false><<<grid, kThreads, 0, st>>>(a);
  else expand_kernel<kArm, kDepth, true><<<grid, kThreads, 0, st>>>(a);
}

}  // namespace

// rows u8 [B, h, row_bytes]; pal u8 [B, 256, 4] (4-byte aligned) or null;
// key int32 [B, 3] or null; out u8 [B, out_h, out_w, 4] (4-byte aligned).
extern "C" int zpix_png_expand(const void* rows, const void* pal, const void* key, void* out,
                               int64_t batch, int h, int w, int row_bytes, int arm, int depth,
                               int out_h, int out_w, int xo, int yo, int xf, int yf,
                               void* stream) {
  const zpix::TimedEntry timed(stream);
  if (batch > 0 && h > 0 && w > 0) {
    ExpandArgs a;
    a.rows = static_cast<const uint8_t*>(rows);
    a.pal = static_cast<const uint32_t*>(pal);
    a.key = static_cast<const int32_t*>(key);
    a.out = static_cast<uint32_t*>(out);
    a.B = static_cast<int>(batch);
    a.h = h;
    a.w = w;
    a.row_bytes = row_bytes;
    a.out_h = out_h;
    a.out_w = out_w;
    a.xo = xo;
    a.yo = yo;
    a.xf = xf;
    a.yf = yf;
    const int groups = (w + kGroup - 1) / kGroup;
    a.lg_tpr = 0;
    while ((1 << a.lg_tpr) < groups && (1 << a.lg_tpr) < kThreads) ++a.lg_tpr;
    const uintptr_t rp = reinterpret_cast<uintptr_t>(rows);
    a.words = rp % 4 == 0 && row_bytes % 4 == 0;
    a.vec16 = rp % 16 == 0 && row_bytes % 16 == 0;
    a.vec_out = xf == 1 && xo % 4 == 0 && out_w % 4 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int rpc = kThreads >> a.lg_tpr;  // rows a CTA
    const dim3 grid(static_cast<unsigned>((h + rpc - 1) / rpc),
                    static_cast<unsigned>(batch < 65535 ? batch : 65535));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (arm * 100 + depth) {
      case kGray * 100 + 1: launch<kGray, 1>(a, grid, st); break;
      case kGray * 100 + 2: launch<kGray, 2>(a, grid, st); break;
      case kGray * 100 + 4: launch<kGray, 4>(a, grid, st); break;
      case kGray * 100 + 8: launch<kGray, 8>(a, grid, st); break;
      case kGray16 * 100 + 16: launch<kGray16, 16>(a, grid, st); break;
      case kTc8 * 100 + 8: launch<kTc8, 8>(a, grid, st); break;
      case kTc16 * 100 + 16: launch<kTc16, 16>(a, grid, st); break;
      case kTca8 * 100 + 8: launch<kTca8, 8>(a, grid, st); break;
      case kTca16 * 100 + 16: launch<kTca16, 16>(a, grid, st); break;
      case kGa8 * 100 + 8: launch<kGa8, 8>(a, grid, st); break;
      case kGa16 * 100 + 16: launch<kGa16, 16>(a, grid, st); break;
      case kPal * 100 + 1: launch<kPal, 1>(a, grid, st); break;
      case kPal * 100 + 2: launch<kPal, 2>(a, grid, st); break;
      case kPal * 100 + 4: launch<kPal, 4>(a, grid, st); break;
      case kPal * 100 + 8: launch<kPal, 8>(a, grid, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
