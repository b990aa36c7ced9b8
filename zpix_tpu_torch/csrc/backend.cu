// K4: the back-end, from restored coefficients to output pixels.
//
// Replaces zpix_tpu/parallel/device_entropy.py::_soa_backend (:1289-1418):
// dequant, the exact Wang IDCT (ops/idct.py's butterflies, here
// wang_idct.cuh), +128 and clamp to u8, MCU->raster, chroma replication
// (ops/ycbcr.py::upsample_chroma_jnp) and the exact YCbCr->RGB
// (ycbcr_to_rgb8_jnp), with the gray, ycbcr, rgb, cmyk and ycck arms.
// The JAX back-end builds full-size planes and then upsamples and
// converts them; here each output pixel is computed from its MCU's own
// blocks (chroma replication never crosses an MCU) and written once,
// cropped, to [B,C,H,W] or [B,H,W,C].
//
// A persistent grid of 256-thread CTAs walks strips of MCUs along MCU
// rows (mcu_pixels.cuh).  A strip's coefficients are one contiguous run
// of strip * bpm lanes (MCU m of image b starts at lane (b*m_pad + m)*bpm):
// strip * bpm * 128 bytes of AC by 16-byte cp.async and the lanes' DC by
// 4-byte cp.async, into one of two buffers while the CTA computes the
// other.  The quant rows are staged once a CTA.
//
// Bound on the H100: bytes (128 + 4 per block in, the pixels out); the
// exact integer work is about 70% of that time at the main shapes, so the
// design spends few instructions on anything but the butterflies and the
// colour arithmetic.
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"
#include "mcu_pixels.cuh"
#include "timing.cuh"

namespace {

using zpix::StripGeo;

template <bool kThirds>
__global__ void __launch_bounds__(zpix::kStripThreads)
    backend_kernel(const int16_t* __restrict__ ac, const int32_t* __restrict__ dc,
                   const int32_t* __restrict__ tables, uint8_t* __restrict__ out,
                   const __grid_constant__ StripGeo g, int64_t m_pad, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nb = g.strip * g.bpm;
  const zpix::StripSmem L = zpix::strip_smem(nb, 2, nb * 4);
  int32_t* tab = reinterpret_cast<int32_t*>(smem + L.tab);
  int32_t* quant = tab + zpix::align16(nb * 4) / 4;  // [4][64]
  zpix::build_block_table(g, tab);
  for (int i = threadIdx.x; i < 4 * 64; i += zpix::kStripThreads)
    quant[i] = tables[zpix::kTabQuant + i];
  __syncthreads();

  auto issue = [&](int64_t s, int buf) {
    const zpix::Strip t = zpix::strip_at(g, s);
    const int64_t lane0 = (t.b * m_pad + static_cast<int64_t>(t.my) * g.mxx + t.mx0) * g.bpm;
    const int n = t.nm * g.bpm;  // this strip's blocks
    int16_t* dst = reinterpret_cast<int16_t*>(smem + L.coef + buf * L.coef_bytes);
    int32_t* ddc = reinterpret_cast<int32_t*>(smem + L.aux + buf * L.aux_bytes);
    const int16_t* src = ac + lane0 * 64;
    if (vec) {
      for (int i = threadIdx.x; i < n * 8; i += zpix::kStripThreads)
        zpix::cp_async16(dst + i * 8, src + i * 8);
    } else {  // an AC base that is not 16-byte aligned: plain loads
      for (int i = threadIdx.x; i < n * 64; i += zpix::kStripThreads) dst[i] = src[i];
    }
    for (int i = threadIdx.x; i < n; i += zpix::kStripThreads)
      zpix::cp_async4(ddc + i, dc + lane0 + i);
  };
  zpix::run_strips<int16_t, true, kThirds>(g, L, smem, quant, issue, out);
}

zpix::StripSmem smem_of(int nb) { return zpix::strip_smem(nb, 2, nb * 4); }

template <bool kThirds>
void launch(const StripGeo& g, const void* ac, const void* dc, const void* tables, void* out,
            int64_t m_pad, cudaStream_t stream) {
  static zpix::GridCache cache;
  const int nb = g.strip * g.bpm, smem = smem_of(nb).total;
  const int grid = zpix::strip_grid(cache, backend_kernel<kThirds>, nb, smem,
                                    smem_of(zpix::kStripBlocks).total, g.n_strips);
  const int vec = reinterpret_cast<uintptr_t>(ac) % 16 == 0;
  backend_kernel<kThirds><<<grid, zpix::kStripThreads, smem, stream>>>(
      static_cast<const int16_t*>(ac), static_cast<const int32_t*>(dc),
      static_cast<const int32_t*>(tables), static_cast<uint8_t*>(out), g, m_pad, vec);
}

}  // namespace

extern "C" int zpix_backend(const void* ac, const void* dc, const void* tables,
                            void* out, int batch, int n_mcu, int m_pad, int mxx,
                            int bpm, int height, int width, int ncomp, int c0,
                            int c1, int c2, int c3, int mode, int nchan,
                            int planar, void* stream) {
  const zpix::TimedEntry timed(stream);
  const int packed[4] = {c0, c1, c2, c3};
  StripGeo g;
  if (mxx < 1 || n_mcu % mxx) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = zpix::make_strip_geo(g, batch, mxx, n_mcu / mxx, bpm, ncomp, packed,
                                               height, width, mode, nchan, planar);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.n_strips > 0) {
    if (g.hmax == 3)
      launch<true>(g, ac, dc, tables, out, m_pad, s);
    else
      launch<false>(g, ac, dc, tables, out, m_pad, s);
  }
  return static_cast<int>(cudaGetLastError());
}
