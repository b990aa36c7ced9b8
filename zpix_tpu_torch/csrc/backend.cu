// K4: the back-end, from restored coefficients to output pixels.
//
// Replaces zpix_tpu/parallel/device_entropy.py::_soa_backend (:1289-1418):
// dequant, the exact Wang IDCT (ops/idct.py's butterflies, here
// wang_idct.cuh), +128 and clamp to u8, MCU->raster, chroma replication
// (ops/ycbcr.py::upsample_chroma_jnp) and the exact YCbCr->RGB
// (ycbcr_to_rgb8_jnp), with the gray, ycbcr, rgb, cmyk and ycck arms.
// The JAX back-end builds full-size planes and then upsamples and
// converts them; here one CUDA block takes one MCU: its blocks are
// dequantised and transformed in shared memory, and each output pixel of
// the MCU is computed from the MCU's own blocks (chroma replication never
// crosses an MCU) and written once, cropped, to [B,C,H,W] or [B,H,W,C].
// The IDCT and pixel stage is mcu_pixels.cuh, which K6 (planes.cu) shares.
//
// Bound on the H100: bytes (128 + 4 per block in, the pixels out).
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"
#include "mcu_pixels.cuh"

namespace {

constexpr int kThreads = 128;
using zpix::kMaxBpm;

__global__ void backend_kernel(const int16_t* __restrict__ ac,
                               const int32_t* __restrict__ dc,
                               const int32_t* __restrict__ tables,
                               uint8_t* __restrict__ out, int n_mcu, int m_pad,
                               int mxx, int bpm, int height, int width,
                               int ncomp, int c0, int c1, int c2, int c3,
                               int mode, int nchan, int planar) {
  __shared__ int32_t blk[kMaxBpm * 64];
  __shared__ uint8_t pix[kMaxBpm * 64];
  __shared__ zpix::McuGeo g;

  const int tid = threadIdx.x;
  if (tid == 0) zpix::load_geo(g, ncomp, c0, c1, c2, c3);
  __syncthreads();

  const int64_t mcu = blockIdx.x;  // over batch * n_mcu
  const int64_t b = mcu / n_mcu;
  const int m = static_cast<int>(mcu - b * n_mcu);
  const int64_t lane0 = (b * m_pad + m) * bpm;  // block of slot 0

  // dequant (natural order, per-component quant); int32 wraps
  for (int i = tid; i < bpm * 64; i += blockDim.x) {
    const int slot = i >> 6, p = i & 63;
    const int32_t v = p == 0 ? dc[lane0 + slot] : ac[(lane0 + slot) * 64 + p];
    const int32_t q = tables[zpix::kTabQuant + g.comp_of_slot[slot] * 64 + p];
    blk[i] = static_cast<int32_t>(static_cast<uint32_t>(v) * static_cast<uint32_t>(q));
  }
  __syncthreads();
  zpix::idct_to_pixels(blk, pix, bpm);
  const int my = m / mxx;
  zpix::write_mcu(pix, g, b, my, m - my * mxx, height, width, ncomp, mode, nchan,
                  planar, out);
}

}  // namespace

extern "C" int zpix_backend(const void* ac, const void* dc, const void* tables,
                            void* out, int batch, int n_mcu, int m_pad, int mxx,
                            int bpm, int height, int width, int ncomp, int c0,
                            int c1, int c2, int c3, int mode, int nchan,
                            int planar, void* stream) {
  const int64_t grid = static_cast<int64_t>(batch) * n_mcu;
  if (bpm > kMaxBpm) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0) {
    backend_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(ac), static_cast<const int32_t*>(dc),
        static_cast<const int32_t*>(tables), static_cast<uint8_t*>(out), n_mcu,
        m_pad, mxx, bpm, height, width, ncomp, c0, c1, c2, c3, mode, nchan,
        planar);
  }
  return static_cast<int>(cudaGetLastError());
}
