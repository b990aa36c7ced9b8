// The per-MCU pixel stage shared by the back-end (K4, backend.cu) and the
// component-plane kernel (K6, planes.cu): one CUDA block holds one MCU's
// dequantised blocks in shared memory, runs the exact Wang IDCT on them,
// adds 128 and clamps to u8, and writes each output pixel of the MCU once,
// cropped, from the MCU's own blocks (chroma replication never crosses an
// MCU), through the gray, ycbcr, rgb, cmyk or ycck colour arm.
//
// The colour arithmetic is the reference's (util.zig:40-86), as
// zpix_tpu/ops/ycbcr.py computes it; the arms follow
// zpix_tpu/parallel/device_entropy.py::_soa_backend and
// zpix_tpu/parallel/batch.py's _ycbcr/_gray/_rgb/_ycck/_cmyk graphs.
#pragma once
#include <cstdint>

#include "wang_idct.cuh"

namespace zpix {

constexpr int kMaxBpm = 10;

enum Mode { kGray = 0, kYcbcr = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };

__device__ __forceinline__ uint8_t clamp_shift16(int32_t v) {
  // the reference's branchless clamp (util.zig:58-77): in 24 bits -> v >> 16
  return (v >> 24) == 0 ? static_cast<uint8_t>(v >> 16)
                        : static_cast<uint8_t>(~(v >> 31) & 0xFF);
}

// One MCU's layout, in shared memory.  Component c is packed by the host
// as h | v << 4 | fh << 8 | fv << 12: its blocks per MCU (h x v) and the
// replication (fh, fv) that maps an output pixel to its sample.
struct McuGeo {
  int8_t comp_of_slot[kMaxBpm];
  int geo[4][5];  // per component: h, v, fh, fv, first slot
};

// Thread 0 fills ``g``; the caller synchronises before reading it.
__device__ __forceinline__ void load_geo(McuGeo& g, int ncomp, int c0, int c1,
                                         int c2, int c3) {
  const int packed[4] = {c0, c1, c2, c3};
  int s0 = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int h = packed[c] & 15, v = (packed[c] >> 4) & 15;
    g.geo[c][0] = h;
    g.geo[c][1] = v;
    g.geo[c][2] = (packed[c] >> 8) & 15;
    g.geo[c][3] = (packed[c] >> 12) & 15;
    g.geo[c][4] = s0;
    for (int j = 0; j < h * v; ++j) g.comp_of_slot[s0 + j] = static_cast<int8_t>(c);
    s0 += h * v;
  }
}

// blk: bpm dequantised int32 blocks (natural order) -> pix: +128, clamped.
// Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void idct_to_pixels(int32_t* blk, uint8_t* pix, int bpm) {
  const int tid = threadIdx.x;
  if (tid < bpm * 8) wang_row(blk + (tid >> 3) * 64 + (tid & 7) * 8);
  __syncthreads();
  if (tid < bpm * 8) {
    int32_t* col = blk + (tid >> 3) * 64 + (tid & 7);
    wang_col(col, 8);
    for (int r = 0; r < 8; ++r) {
      const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(col[8 * r]) + 128u);
      pix[(tid >> 3) * 64 + 8 * r + (tid & 7)] =
          static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
  __syncthreads();
}

// MCU (my, mx) of image b -> its pixels in out, [B, C, H, W] when planar,
// else [B, H, W, C] ([B, H, W] for gray).
__device__ __forceinline__ void write_mcu(const uint8_t* pix, const McuGeo& g,
                                          int64_t b, int my, int mx, int height,
                                          int width, int ncomp, int mode,
                                          int nchan, int planar, uint8_t* out) {
  const int rw = 8 * g.geo[0][0], rh = 8 * g.geo[0][1];  // the MCU's pixel region
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int i = threadIdx.x; i < rw * rh; i += blockDim.x) {
    const int ly = i / rw, lx = i - ly * rw;
    const int y = my * rh + ly, x = mx * rw + lx;
    if (y >= height || x >= width) continue;
    int val[4];
    for (int c = 0; c < ncomp; ++c) {
      const int py = ly / g.geo[c][3], px = lx / g.geo[c][2];
      const int slot = g.geo[c][4] + (py >> 3) * g.geo[c][0] + (px >> 3);
      val[c] = pix[slot * 64 + (py & 7) * 8 + (px & 7)];
    }
    uint8_t o[4];
    if (mode == kGray) {
      o[0] = val[0];
    } else if (mode == kRgb) {
      o[0] = val[0];
      o[1] = val[1];
      o[2] = val[2];
    } else if (mode == kCmyk) {
      for (int c = 0; c < 4; ++c) o[c] = 255 - val[c];
    } else {  // ycbcr, ycck: exact YCbCr->RGB (util.zig:40-86)
      const int32_t yy = val[0] * 0x10101, cb = val[1] - 128, cr = val[2] - 128;
      o[0] = clamp_shift16(yy + 91881 * cr);
      o[1] = clamp_shift16(yy - 22554 * cb - 46802 * cr);
      o[2] = clamp_shift16(yy + 116130 * cb);
      if (mode == kYcck) o[3] = 255 - val[3];
    }
    const int64_t pixel = static_cast<int64_t>(y) * width + x;
    for (int ch = 0; ch < nchan; ++ch) {
      const int64_t at = planar ? (b * nchan + ch) * plane + pixel
                                : (b * plane + pixel) * nchan + ch;
      out[at] = o[ch];
    }
  }
}

}  // namespace zpix
