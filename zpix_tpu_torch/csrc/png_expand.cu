// K17: PNG expansion -- defiltered rows -> premultiplied RGBA8, placed on
// the canvas (the Adam7 scatter included).
//
// Replaces zpix_tpu/parallel/png_batch.py::_expand_graph (:299) with its
// arms (:129-276), and the strided scatter of _interlaced_graph (:278).
// Input: rows [B, h, row_bytes] u8 (one pass's, or the image's), the
// per-image palettes [B, 256, 4] u8 (premultiplied on the host, opaque
// black past the real palette; paletted depths only) and tRNS keys
// [B, 3] int32 (-1 = no key, never matches; or null).  One thread a pixel
// of the pass writes one 4-byte store at (yo + y * yf, xo + x * xf) of
// the canvas [B, H, W, 4]; a whole image is the pass (0, 0, 1, 1).
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
// Bound on the H100: bytes (the rows in, 4 bytes a pixel out); a few
// integer operations a pixel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Arms, as ops/png.py's ARMS numbers them.
enum Arm { kGray = 0, kGray16 = 1, kTc8 = 2, kTc16 = 3, kTca8 = 4, kTca16 = 5, kGa8 = 6,
           kGa16 = 7, kPal = 8 };

__device__ __forceinline__ uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

__device__ __forceinline__ uint32_t pre8(uint32_t c, uint32_t a) {
  return (((c | c << 8) * a) / 0xFF) >> 8;
}

__device__ __forceinline__ uint32_t pre16(uint32_t c, uint32_t a) {
  return ((c * a) / 0xFFFF) >> 8;  // c * a <= 0xFFFE0001 fits uint32
}

__device__ __forceinline__ uint32_t rgba(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return r | (g << 8) | (b << 16) | (a << 24);  // the bytes R, G, B, A
}

__global__ void expand_kernel(const uint8_t* __restrict__ rows, const uint32_t* __restrict__ pal,
                              const int32_t* __restrict__ key, uint32_t* __restrict__ out,
                              int64_t n, int h, int w, int row_bytes, int arm, int depth,
                              int out_h, int out_w, int xo, int yo, int xf, int yf) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int x = static_cast<int>(t % w);
  const int64_t by = t / w;  // b * h + y
  const int64_t b = by / h;
  const int y = static_cast<int>(by - b * h);
  const uint8_t* row = rows + by * row_bytes;
  const int32_t* k = key == nullptr ? nullptr : key + b * 3;
  uint32_t px;
  if (arm == kGray || arm == kPal) {
    uint32_t v;
    if (depth == 8) {
      v = row[x];
    } else {
      const int bit = x * depth;
      v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
    }
    if (arm == kPal) {
      px = pal[b * 256 + v];
    } else {
      const uint32_t g = (v * (depth == 1 ? 0xFF : depth == 2 ? 0x55 : depth == 4 ? 0x11 : 1))
                         & 0xFF;
      px = k != nullptr && static_cast<int32_t>(g) == k[0] ? 0 : rgba(g, g, g, 0xFF);
    }
  } else if (arm == kGray16) {
    const uint32_t g = be16(row + 2 * x);
    px = k != nullptr && static_cast<int32_t>(g) == k[0] ? 0 : rgba(g >> 8, g >> 8, g >> 8, 0xFF);
  } else if (arm == kTc8) {
    const uint8_t* s = row + 3 * x;
    const bool hit = k != nullptr && s[0] == k[0] && s[1] == k[1] && s[2] == k[2];
    px = hit ? 0 : rgba(s[0], s[1], s[2], 0xFF);
  } else if (arm == kTc16) {
    const uint8_t* s = row + 6 * x;
    const uint32_t r = be16(s), g = be16(s + 2), bl = be16(s + 4);
    const bool hit = k != nullptr && static_cast<int32_t>(r) == k[0] &&
                     static_cast<int32_t>(g) == k[1] && static_cast<int32_t>(bl) == k[2];
    px = hit ? 0 : rgba(r >> 8, g >> 8, bl >> 8, 0xFF);
  } else if (arm == kTca8) {
    const uint8_t* s = row + 4 * x;
    const uint32_t a = s[3];
    px = rgba(pre8(s[0], a), pre8(s[1], a), pre8(s[2], a), a);
  } else if (arm == kTca16) {
    const uint8_t* s = row + 8 * x;
    const uint32_t a = be16(s + 6);
    px = rgba(pre16(be16(s), a), pre16(be16(s + 2), a), pre16(be16(s + 4), a), a >> 8);
  } else if (arm == kGa8) {
    const uint32_t a = row[2 * x + 1], g = pre8(row[2 * x], a);
    px = rgba(g, g, g, a);
  } else {  // kGa16
    const uint32_t a = be16(row + 4 * x + 2), g = pre16(be16(row + 4 * x), a);
    px = rgba(g, g, g, a >> 8);
  }
  out[(b * out_h + yo + static_cast<int64_t>(y) * yf) * out_w + xo +
      static_cast<int64_t>(x) * xf] = px;
}

}  // namespace

// rows u8 [B, h, row_bytes]; pal u8 [B, 256, 4] (4-byte aligned) or null;
// key int32 [B, 3] or null; out u8 [B, out_h, out_w, 4] (4-byte aligned).
extern "C" int zpix_png_expand(const void* rows, const void* pal, const void* key, void* out,
                               int64_t batch, int h, int w, int row_bytes, int arm, int depth,
                               int out_h, int out_w, int xo, int yo, int xf, int yf,
                               void* stream) {
  const int64_t n = batch * h * static_cast<int64_t>(w);
  if (n > 0) {
    expand_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), static_cast<const uint32_t*>(pal),
        static_cast<const int32_t*>(key), static_cast<uint32_t*>(out), n, h, w, row_bytes,
        arm, depth, out_h, out_w, xo, yo, xf, yf);
  }
  return static_cast<int>(cudaGetLastError());
}
