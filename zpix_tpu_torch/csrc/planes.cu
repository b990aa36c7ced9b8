// K6: component planes and colour, from dense coefficient grids.
//
// Replaces zpix_tpu/parallel/batch.py::_component_plane (:84) and the
// _ycbcr_graph, _gray_graph, _rgb_graph, _ycck_graph and _cmyk_graph arms
// (:107-173): per-image dequant, the exact Wang IDCT, +128 and clamp to
// u8, blocks to planes, chroma replication by the ratio's factors (or the
// cmyk arm's 2x2 for subsampled components) and the colour arm, into an
// interleaved [B, H, W, C] u8 tensor ([B, H, W] for gray).
// The JAX graph builds every full-size plane and then upsamples and
// converts; here one CUDA block takes one MCU (the blocks of every
// component that cover the same pixels): it gathers them from the grids,
// dequantises them by the image's own quant rows, and hands them to the
// pixel stage it shares with K4 (mcu_pixels.cuh), which writes each
// output pixel once.
//
// The grids are int16 (the baseline routes) or int32 (the progressive
// store, which is int32 as in JAX, progressive_onchip.py:1807): one
// template, so the progressive store needs no cast and no copy, and a
// value outside the int16 range stays exact.
//
// Bound on the H100: bytes (128 or 256 per block in, the pixels out).
#include <cuda_runtime.h>

#include <cstdint>

#include "mcu_pixels.cuh"

namespace {

constexpr int kThreads = 128;
using zpix::kMaxBpm;

template <typename T>
struct Grids {
  const T* coef[4];  // [B, myy*v, mxx*h, 64] per component
  const int32_t* quant[4];  // [B, 64] per component, natural order
};

template <typename T>
__global__ void planes_kernel(Grids<T> in, uint8_t* __restrict__ out, int n_mcu,
                              int mxx, int myy, int bpm, int height, int width,
                              int ncomp, int c0, int c1, int c2, int c3,
                              int mode, int nchan) {
  __shared__ int32_t blk[kMaxBpm * 64];
  __shared__ uint8_t pix[kMaxBpm * 64];
  __shared__ zpix::McuGeo g;

  const int tid = threadIdx.x;
  if (tid == 0) zpix::load_geo(g, ncomp, c0, c1, c2, c3);
  __syncthreads();

  const int64_t mcu = blockIdx.x;  // over batch * n_mcu
  const int64_t b = mcu / n_mcu;
  const int m = static_cast<int>(mcu - b * n_mcu);
  const int my = m / mxx, mx = m - my * mxx;

  // gather and dequantise (per-image quant); int32 wraps
  for (int i = tid; i < bpm * 64; i += blockDim.x) {
    const int slot = i >> 6, p = i & 63;
    const int c = g.comp_of_slot[slot];
    const int h = g.geo[c][0], v = g.geo[c][1], j = slot - g.geo[c][4];
    const int64_t by = static_cast<int64_t>(my) * v + j / h;
    const int64_t bx = static_cast<int64_t>(mx) * h + j % h;
    const int64_t row = (b * myy * v + by) * (static_cast<int64_t>(mxx) * h) + bx;
    const int32_t x = in.coef[c][row * 64 + p];
    const int32_t q = in.quant[c][b * 64 + p];
    blk[i] = static_cast<int32_t>(static_cast<uint32_t>(x) * static_cast<uint32_t>(q));
  }
  __syncthreads();
  zpix::idct_to_pixels(blk, pix, bpm);
  zpix::write_mcu(pix, g, b, my, mx, height, width, ncomp, mode, nchan, 0, out);
}

template <typename T>
void launch_planes(const void* const* g, const void* const* q, void* out, int batch,
                   int mxx, int myy, int bpm, int height, int width, int ncomp, int c0,
                   int c1, int c2, int c3, int mode, int nchan, cudaStream_t stream) {
  Grids<T> in{{static_cast<const T*>(g[0]), static_cast<const T*>(g[1]),
               static_cast<const T*>(g[2]), static_cast<const T*>(g[3])},
              {static_cast<const int32_t*>(q[0]), static_cast<const int32_t*>(q[1]),
               static_cast<const int32_t*>(q[2]), static_cast<const int32_t*>(q[3])}};
  const int64_t grid = static_cast<int64_t>(batch) * mxx * myy;
  if (grid > 0) {
    planes_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        in, static_cast<uint8_t*>(out), mxx * myy, mxx, myy, bpm, height, width,
        ncomp, c0, c1, c2, c3, mode, nchan);
  }
}

}  // namespace

// ``coef_i32`` picks the grids' type: 0 int16, 1 int32.
extern "C" int zpix_component_planes(const void* g0, const void* g1, const void* g2,
                                     const void* g3, const void* q0, const void* q1,
                                     const void* q2, const void* q3, void* out,
                                     int batch, int mxx, int myy, int bpm,
                                     int height, int width, int ncomp, int c0,
                                     int c1, int c2, int c3, int mode, int nchan,
                                     int coef_i32, void* stream) {
  if (bpm > kMaxBpm || ncomp > 4) return static_cast<int>(cudaErrorInvalidValue);
  const void* g[4] = {g0, g1, g2, g3};
  const void* q[4] = {q0, q1, q2, q3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coef_i32) {
    launch_planes<int32_t>(g, q, out, batch, mxx, myy, bpm, height, width, ncomp, c0, c1,
                           c2, c3, mode, nchan, s);
  } else {
    launch_planes<int16_t>(g, q, out, batch, mxx, myy, bpm, height, width, ncomp, c0, c1,
                           c2, c3, mode, nchan, s);
  }
  return static_cast<int>(cudaGetLastError());
}
