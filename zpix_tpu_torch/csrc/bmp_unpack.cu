// K18: BMP rows -> premultiplied RGBA8.
//
// Replaces zpix_tpu/parallel/bmp_batch.py::_bmp_graph (:21), the whole
// device side of a BMP decode.  Input: the stored rows [B, H, row_bytes]
// u8 (each row padded to 4 bytes, bottom-up unless top_down) and the
// palettes [B, 256, 4] u8 RGBA (zero past each image's colours, so an
// index past them gives 0, 0, 0, 0).  One thread an output pixel:
//  * 1/2/4/8 bpp: the index is bits [x * bpp, x * bpp + bpp) of the row,
//    MSB first (numpy.unpackbits order), then the palette entry;
//  * 24 bpp: B, G, R -> R, G, B, 255;
//  * 32 bpp: B, G, R, A -> R, G, B, A premultiplied exactly as
//    rgba_pixels does, ((c | c << 8) * a / 0xFF) >> 8, when the header is
//    V4/V5 (allow_alpha); else R, G, B, 255;
//  * row y of the output reads stored row y (top-down) or H - 1 - y.
// A pixel is written as one 4-byte store, so a warp writes 128
// contiguous bytes.  Bound on the H100: bytes (the rows in, 4 bytes a
// pixel out); a few integer operations a pixel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void bmp_unpack_kernel(const uint8_t* __restrict__ rows,
                                  const uint32_t* __restrict__ pal, uint32_t* __restrict__ out,
                                  int64_t n, int H, int W, int row_bytes, int bpp,
                                  int top_down, int allow_alpha) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int x = static_cast<int>(t % W);
  const int64_t by = t / W;  // b * H + y
  const int64_t b = by / H;
  const int y = static_cast<int>(by - b * H);
  const uint8_t* row = rows + (b * H + (top_down ? y : H - 1 - y)) * row_bytes;
  uint32_t px;  // little-endian word of the bytes R, G, B, A
  if (bpp <= 8) {
    const int bit = x * bpp;
    const uint32_t idx = (row[bit >> 3] >> (8 - bpp - (bit & 7))) & ((1u << bpp) - 1);
    px = pal[b * 256 + idx];
  } else if (bpp == 24) {
    const uint8_t* s = row + 3 * x;
    px = s[2] | (s[1] << 8) | (s[0] << 16) | 0xFF000000u;
  } else {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[x];  // B, G, R, A
    uint32_t r = (w >> 16) & 0xFF, g = (w >> 8) & 0xFF, bl = w & 0xFF, a = w >> 24;
    if (allow_alpha) {
      r = (((r | r << 8) * a) / 0xFF) >> 8;
      g = (((g | g << 8) * a) / 0xFF) >> 8;
      bl = (((bl | bl << 8) * a) / 0xFF) >> 8;
    } else {
      a = 0xFF;
    }
    px = r | (g << 8) | (bl << 16) | (a << 24);
  }
  out[t] = px;
}

}  // namespace

// rows u8 [B, H, row_bytes] (4-byte aligned for 32 bpp), pal u8 [B, 256, 4],
// out u8 [B, H, W, 4].
extern "C" int zpix_bmp_unpack(const void* rows, const void* pal, void* out, int64_t batch,
                               int H, int W, int row_bytes, int bpp, int top_down,
                               int allow_alpha, void* stream) {
  const int64_t n = batch * H * W;
  if (n > 0) {
    bmp_unpack_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), static_cast<const uint32_t*>(pal),
        static_cast<uint32_t*>(out), n, H, W, row_bytes, bpp, top_down, allow_alpha);
  }
  return static_cast<int>(cudaGetLastError());
}
