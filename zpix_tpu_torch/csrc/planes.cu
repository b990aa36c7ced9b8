// K6: component planes and colour, from dense coefficient grids.
//
// Replaces zpix_tpu/parallel/batch.py::_component_plane (:84) and the
// _ycbcr_graph, _gray_graph, _rgb_graph, _ycck_graph and _cmyk_graph arms
// (:107-173): per-image dequant, the exact Wang IDCT, +128 and clamp to
// u8, blocks to planes, chroma replication by the ratio's factors (or the
// cmyk arm's 2x2 for subsampled components) and the colour arm, into an
// interleaved [B, H, W, C] u8 tensor ([B, H, W] for gray).
// The JAX graph builds every full-size plane and then upsamples and
// converts; here each output pixel is computed once from its MCU's own
// blocks (the blocks of every component that cover the same pixels), in
// the strip pixel stage K6 shares with K4 (mcu_pixels.cuh).
//
// A persistent grid of 256-thread CTAs walks strips of MCUs along MCU
// rows.  A strip's coefficients are v contiguous runs a component (one a
// block row of its grid, strip * h blocks each), fetched by 16-byte
// cp.async together with the image's quant rows (4-byte cp.async) into one
// of two buffers while the CTA computes the other.
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

using zpix::StripGeo;

template <typename T>
struct Grids {
  const T* coef[4];  // [B, myy*v, mxx*h, 64] per component
  const int32_t* quant[4];  // [B, 64] per component, natural order
};

template <typename T>
__global__ void __launch_bounds__(zpix::kStripThreads)
    planes_kernel(const __grid_constant__ Grids<T> in, uint8_t* __restrict__ out,
                  const __grid_constant__ StripGeo g, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const zpix::StripSmem L = zpix::strip_smem(g.strip * g.bpm, sizeof(T), 4 * 64 * 4);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + L.tab);
  zpix::build_block_table(g, tab);
  __syncthreads();

  constexpr int kChunks = 64 * sizeof(T) / 16, kPer = 16 / sizeof(T);  // a block's 16-byte chunks
  auto issue = [&](int64_t s, int buf) {
    const zpix::Strip t = zpix::strip_at(g, s);
    const int nb = t.nm * g.bpm;
    T* dst = reinterpret_cast<T*>(smem + L.coef + buf * L.coef_bytes);
    int32_t* q = reinterpret_cast<int32_t*>(smem + L.aux + buf * L.aux_bytes);
    const int64_t row0 = t.b * g.myy + t.my;  // the MCU row, in units of v block rows
    if (vec) {
      for (int i = threadIdx.x; i < nb * kChunks; i += zpix::kStripThreads) {
        const int k = i / kChunks, e = i - k * kChunks, x = tab[k], c = x & 15;
        const int64_t by = row0 * g.v[c] + ((x >> 4) & 15);
        const T* src = in.coef[c] + ((by * g.mxx + t.mx0) * g.h[c] + (x >> 8)) * 64 + e * kPer;
        zpix::cp_async16(dst + k * 64 + e * kPer, src);
      }
    } else {  // a grid base that is not 16-byte aligned: plain loads
      for (int i = threadIdx.x; i < nb * 64; i += zpix::kStripThreads) {
        const int k = i >> 6, x = tab[k], c = x & 15;
        const int64_t by = row0 * g.v[c] + ((x >> 4) & 15);
        dst[i] = in.coef[c][((by * g.mxx + t.mx0) * g.h[c] + (x >> 8)) * 64 + (i & 63)];
      }
    }
    for (int i = threadIdx.x; i < g.ncomp * 64; i += zpix::kStripThreads)
      zpix::cp_async4(q + i, in.quant[i >> 6] + t.b * 64 + (i & 63));
  };
  zpix::run_strips<T, false, false>(g, L, smem, nullptr, issue, out);
}

template <typename T>
void launch_planes(const void* const* gp, const void* const* qp, void* out, const StripGeo& g,
                   cudaStream_t stream) {
  Grids<T> in{{static_cast<const T*>(gp[0]), static_cast<const T*>(gp[1]),
               static_cast<const T*>(gp[2]), static_cast<const T*>(gp[3])},
              {static_cast<const int32_t*>(qp[0]), static_cast<const int32_t*>(qp[1]),
               static_cast<const int32_t*>(qp[2]), static_cast<const int32_t*>(qp[3])}};
  int vec = 1;
  for (int c = 0; c < g.ncomp; ++c) vec &= reinterpret_cast<uintptr_t>(gp[c]) % 16 == 0;
  static zpix::GridCache cache;
  const auto smem_of = [](int nb) { return zpix::strip_smem(nb, sizeof(T), 4 * 64 * 4).total; };
  const int nb = g.strip * g.bpm, smem = smem_of(nb);
  const int grid = zpix::strip_grid(cache, planes_kernel<T>, nb, smem,
                                    smem_of(zpix::kStripBlocks), g.n_strips);
  planes_kernel<T><<<grid, zpix::kStripThreads, smem, stream>>>(
      in, static_cast<uint8_t*>(out), g, vec);
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
  const int packed[4] = {c0, c1, c2, c3};
  StripGeo g;
  const cudaError_t err = zpix::make_strip_geo(g, batch, mxx, myy, bpm, ncomp, packed, height,
                                               width, mode, nchan, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // ops/planes.py::mcu_layout gives the least replicated component one
  // block across, so an MCU 3 blocks wide means a replication of 3
  if (g.hmax == 3) return static_cast<int>(cudaErrorInvalidValue);
  const void* gp[4] = {g0, g1, g2, g3};
  const void* qp[4] = {q0, q1, q2, q3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.n_strips > 0) {
    if (coef_i32)
      launch_planes<int32_t>(gp, qp, out, g, s);
    else
      launch_planes<int16_t>(gp, qp, out, g, s);
  }
  return static_cast<int>(cudaGetLastError());
}
