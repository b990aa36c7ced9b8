// K18: BMP rows -> premultiplied RGBA8.
//
// Replaces zpix_tpu/parallel/bmp_batch.py::_bmp_graph (:21), the whole
// device side of a BMP decode.  Input: the stored rows [B, H, row_bytes]
// u8 (each row padded to 4 bytes, bottom-up unless top_down) and the
// palettes [B, 256, 4] u8 RGBA (zero past each image's colours, so an
// index past them gives 0, 0, 0, 0).  Per pixel:
//  * 1/2/4/8 bpp: the index is bits [x * bpp, x * bpp + bpp) of the row,
//    MSB first (numpy.unpackbits order), then the palette entry;
//  * 24 bpp: B, G, R -> R, G, B, 255;
//  * 32 bpp: B, G, R, A -> R, G, B, A premultiplied exactly as
//    rgba_pixels does, ((c | c << 8) * a / 0xFF) >> 8, when the header is
//    V4/V5 (allow_alpha); else R, G, B, 255;
//  * row y of the output reads stored row y (top-down) or H - 1 - y.
// The design is K17's (csrc/png_expand.cu), with its own copy of the row
// helpers.  A CTA of 256 threads takes whole rows of one image: the image
// is blockIdx.y (a grid-stride loop past 65,535 images), the row
// blockIdx.x * (rows a CTA) + the thread's row slot, a power of two of
// threads a row, so that no thread divides; the stored row is found once
// a row.  A thread takes the same 4 pixels of kRowSteps rows, kThreads /
// (threads a row) apart, and issues their loads before its first store
// (tools/torch_expand_stages.py --sweep times 1, 2, 4 and 8 steps; PERF.md
// section 6 holds the choice).  It computes 4 consecutive pixels
// from words: 8 bpp one word, 24 bpp three, 32 bpp one 16-byte load (rows
// and row_bytes 16-byte aligned) or four words, 1/2/4 bpp the word that
// holds the group's bits; a group that passes the row's bytes (the last
// one, 24 and 32 bpp, when the width is no multiple of 4) reads bytes,
// bounds-checked.
// It writes the group with one 16-byte store where the output's rows are
// 16-byte aligned (out 16-byte aligned, W % 4 == 0), else a word a pixel;
// the path is picked at launch from the pointers and W.  A paletted CTA
// stages its image's 1 KiB palette in shared memory.  One template
// instance a bit depth, so a thread's byte picks are constants.
// Bound on the H100: bytes (the rows in, 4 bytes a pixel out); a few
// integer operations a pixel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // pixels a thread computes at a time
constexpr int kRowSteps = 2;  // rows a thread takes in turn, their loads issued together

__device__ __forceinline__ uint32_t pre8(uint32_t c, uint32_t a) {
  return (((c | c << 8) * a) / 0xFF) >> 8;
}

__device__ __forceinline__ uint32_t rgba(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return r | (g << 8) | (b << 16) | (a << 24);  // the bytes R, G, B, A
}

struct UnpackArgs {
  const uint8_t* rows;
  const uint32_t* pal;
  uint32_t* out;
  int B, H, W, row_bytes;
  int lg_tpr;      // log2 of the threads a row
  bool top_down, allow_alpha;
  bool vec16;      // rows and row_bytes 16-byte aligned
  bool vec_out;    // out 16-byte aligned and W % 4 == 0
};

// The bytes of a group of 4 pixels (8 bits a pixel or more: kNW words,
// byte i at bits 8 * (i % 4) of word i / 4), or the word that holds them
// (1/2/4 bpp).
template <int kBpp>
struct Group {
  static constexpr int kNW = kBpp >= 8 ? kBpp / 8 : 1;
  uint32_t wd[kNW];
  __device__ __forceinline__ uint32_t byte(int i) const {
    return (wd[i >> 2] >> (8 * (i & 3))) & 0xFF;
  }
};

// Group g of a row: word loads (16-byte ones where ``vec16``) when its
// words lie inside the row, else bytes, zero past the row's end.  Rows are
// 4-byte aligned (the wrapper refuses others; row_bytes % 4 == 0).
template <int kBpp>
__device__ __forceinline__ Group<kBpp> load_group(const uint8_t* row, int g, int row_bytes,
                                                  bool vec16) {
  Group<kBpp> grp;
  constexpr int kNW = Group<kBpp>::kNW;
  // byte offset of the group (of its word, for 1/2/4 bpp)
  const int at = kBpp >= 8 ? g * kNW * 4 : ((g * kGroup * kBpp) >> 5) << 2;
  if (at + 4 * kNW <= row_bytes) {
    if constexpr (kNW == 4) {
      if (vec16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + at));
        grp.wd[0] = v.x;
        grp.wd[1] = v.y;
        grp.wd[2] = v.z;
        grp.wd[3] = v.w;
        return grp;
      }
    }
#pragma unroll
    for (int j = 0; j < kNW; ++j)
      grp.wd[j] = __ldg(reinterpret_cast<const uint32_t*>(row + at) + j);
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

// Pixel k (0-3) of group g.
template <int kBpp>
__device__ __forceinline__ uint32_t pixel(const Group<kBpp>& grp, int g, int k,
                                          const uint32_t* s_pal, bool allow_alpha) {
  if constexpr (kBpp == 8) {
    return s_pal[grp.byte(k)];
  } else if constexpr (kBpp < 8) {  // MSB first: the big-endian word's bits from the top
    const int bit = ((g * kGroup * kBpp) & 31) + k * kBpp;
    return s_pal[(__byte_perm(grp.wd[0], 0, 0x0123) >> (32 - kBpp - bit)) & ((1u << kBpp) - 1)];
  } else if constexpr (kBpp == 24) {  // B, G, R
    return rgba(grp.byte(3 * k + 2), grp.byte(3 * k + 1), grp.byte(3 * k), 0xFF);
  } else {  // 32: B, G, R, A
    const uint32_t r = grp.byte(4 * k + 2), gg = grp.byte(4 * k + 1), b = grp.byte(4 * k);
    if (!allow_alpha) return rgba(r, gg, b, 0xFF);
    const uint32_t a = grp.byte(4 * k + 3);
    return rgba(pre8(r, a), pre8(gg, a), pre8(b, a), a);
  }
}

template <int kBpp>
__global__ void __launch_bounds__(kThreads) unpack_kernel(const UnpackArgs a) {
  constexpr bool kPal = kBpp <= 8;
  __shared__ uint32_t s_pal[kPal ? 256 : 1];
  const int tid = threadIdx.x;
  const int tpr = 1 << a.lg_tpr, rpc = kThreads >> a.lg_tpr;
  const int y0 = blockIdx.x * kRowSteps * rpc + (tid >> a.lg_tpr);  // + s * rpc, step s
  const int j = tid & (tpr - 1);
  const int groups = (a.W + kGroup - 1) / kGroup;
  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    if constexpr (kPal) {
      __syncthreads();  // the last image's palette is read
      s_pal[tid] = __ldg(a.pal + static_cast<int64_t>(b) * 256 + tid);
      __syncthreads();
    }
    const uint8_t* row[kRowSteps];
    uint32_t* orow[kRowSteps];
#pragma unroll
    for (int s = 0; s < kRowSteps; ++s) {  // the stored row, once a row
      const int y = y0 + s * rpc;
      row[s] = a.rows + (static_cast<int64_t>(b) * a.H + (a.top_down ? y : a.H - 1 - y)) *
                            a.row_bytes;
      orow[s] = a.out + (static_cast<int64_t>(b) * a.H + y) * a.W;
    }
    for (int g = j; g < groups; g += tpr) {
      Group<kBpp> grp[kRowSteps];  // every step's loads before the first store
#pragma unroll
      for (int s = 0; s < kRowSteps; ++s) {
        if (y0 + s * rpc < a.H) grp[s] = load_group<kBpp>(row[s], g, a.row_bytes, a.vec16);
      }
      const int x0 = g * kGroup;
#pragma unroll
      for (int s = 0; s < kRowSteps; ++s) {
        if (y0 + s * rpc >= a.H) break;
        uint32_t px[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) px[k] = pixel<kBpp>(grp[s], g, k, s_pal, a.allow_alpha);
        if (a.vec_out && x0 + kGroup <= a.W) {
          *reinterpret_cast<uint4*>(orow[s] + x0) = make_uint4(px[0], px[1], px[2], px[3]);
        } else {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (x0 + k < a.W) orow[s][x0 + k] = px[k];
          }
        }
      }
    }
  }
}

}  // namespace

// rows u8 [B, H, row_bytes] (4-byte aligned, row_bytes % 4 == 0), pal u8
// [B, 256, 4] (4-byte aligned), out u8 [B, H, W, 4] (4-byte aligned).
extern "C" int zpix_bmp_unpack(const void* rows, const void* pal, void* out, int64_t batch,
                               int H, int W, int row_bytes, int bpp, int top_down,
                               int allow_alpha, void* stream) {
  if (reinterpret_cast<uintptr_t>(rows) % 4 || row_bytes % 4 ||
      static_cast<int64_t>(row_bytes) * 8 < static_cast<int64_t>(W) * bpp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && H > 0 && W > 0) {
    UnpackArgs a;
    a.rows = static_cast<const uint8_t*>(rows);
    a.pal = static_cast<const uint32_t*>(pal);
    a.out = static_cast<uint32_t*>(out);
    a.B = static_cast<int>(batch < 0x7fffffff ? batch : 0x7fffffff);
    a.H = H;
    a.W = W;
    a.row_bytes = row_bytes;
    const int groups = (W + kGroup - 1) / kGroup;
    a.lg_tpr = 0;
    while ((1 << a.lg_tpr) < groups && (1 << a.lg_tpr) < kThreads) ++a.lg_tpr;
    a.top_down = top_down != 0;
    a.allow_alpha = allow_alpha != 0;
    a.vec16 = reinterpret_cast<uintptr_t>(rows) % 16 == 0 && row_bytes % 16 == 0;
    a.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && W % 4 == 0;
    const int rows_cta = kRowSteps * (kThreads >> a.lg_tpr);
    const dim3 grid(static_cast<unsigned>((H + rows_cta - 1) / rows_cta),
                    static_cast<unsigned>(batch < 65535 ? batch : 65535));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (bpp) {
      case 1: unpack_kernel<1><<<grid, kThreads, 0, st>>>(a); break;
      case 2: unpack_kernel<2><<<grid, kThreads, 0, st>>>(a); break;
      case 4: unpack_kernel<4><<<grid, kThreads, 0, st>>>(a); break;
      case 8: unpack_kernel<8><<<grid, kThreads, 0, st>>>(a); break;
      case 24: unpack_kernel<24><<<grid, kThreads, 0, st>>>(a); break;
      case 32: unpack_kernel<32><<<grid, kThreads, 0, st>>>(a); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
