// Split of the per-MCU back-end (K4 as it was before the strip design of
// csrc/mcu_pixels.cuh: a 128-thread CUDA block an MCU), for
// tools/torch_backend_stages.py.  Built against a checkout whose csrc/
// still has that design (``McuGeo``, ``idct_to_pixels``, ``write_mcu``):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I CHECKOUT/zpix_tpu_torch/csrc -o OUT.so THIS.cu
//
// Variants, each on the same inputs as K4:
//   full       the kernel as it was (kMcus MCUs a CUDA block of 128 * kMcus threads)
//   no_store   loads, dequant and the IDCT; no pixel stage
//   no_idct    the pixel stage alone, on pixels made in shared memory
//   load_only  loads and dequant alone
// A variant that drops a stage folds what it kept into a conditional
// atomic on ``sink``, so the compiler keeps the work.
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"
#include "mcu_pixels.cuh"

namespace {

using zpix::kMaxBpm;
enum Variant { kFull = 0, kNoStore = 1, kNoIdct = 2, kLoadOnly = 3 };

template <int kVariant, int kMcus>
__global__ void variant_kernel(const int16_t* __restrict__ ac, const int32_t* __restrict__ dc,
                               const int32_t* __restrict__ tables, uint8_t* __restrict__ out,
                               int* sink, int64_t total, int n_mcu, int m_pad, int mxx, int bpm,
                               int height, int width, int ncomp, int c0, int c1, int c2, int c3,
                               int mode, int nchan, int planar) {
  __shared__ int32_t blk[kMcus * kMaxBpm * 64];
  __shared__ uint8_t pix[kMcus * kMaxBpm * 64];
  __shared__ zpix::McuGeo g;
  const int tid = threadIdx.x;
  if (tid == 0) zpix::load_geo(g, ncomp, c0, c1, c2, c3);
  __syncthreads();
  const int64_t mcu0 = static_cast<int64_t>(blockIdx.x) * kMcus;
  const int nm = static_cast<int>(total - mcu0 < kMcus ? total - mcu0 : kMcus);
  const int per = bpm * 64;
  if (kVariant != kNoIdct) {  // as the kernel did: b and m once an MCU
    for (int u = 0; u < nm; ++u) {
      const int64_t mcu = mcu0 + u, b = mcu / n_mcu;
      const int64_t lane0 = (b * m_pad + (mcu - b * n_mcu)) * bpm;
      for (int i = tid; i < per; i += blockDim.x) {
        const int slot = i >> 6, p = i & 63;
        const int32_t v = p == 0 ? dc[lane0 + slot] : ac[(lane0 + slot) * 64 + p];
        const int32_t q = tables[zpix::kTabQuant + g.comp_of_slot[slot] * 64 + p];
        blk[u * per + i] =
            static_cast<int32_t>(static_cast<uint32_t>(v) * static_cast<uint32_t>(q));
      }
    }
    __syncthreads();
  }
  if (kVariant == kLoadOnly) {
    if (tid < nm * per && blk[tid] == 0x7fffffff) atomicAdd(sink, 1);
    return;
  }
  if (kVariant == kNoIdct) {
    for (int i = tid; i < nm * per; i += blockDim.x) pix[i] = static_cast<uint8_t>(i * 37);
    __syncthreads();
  } else {
    zpix::idct_to_pixels(blk, pix, nm * bpm);
  }
  if (kVariant == kNoStore) {
    if (tid < nm * per && pix[tid] == 201 && pix[(tid + 7) % (nm * per)] == 3) atomicAdd(sink, 1);
    return;
  }
  for (int u = 0; u < nm; ++u) {
    const int64_t mcu = mcu0 + u, b = mcu / n_mcu;
    const int m = static_cast<int>(mcu - b * n_mcu), my = m / mxx;
    zpix::write_mcu(pix + u * per, g, b, my, m - my * mxx, height, width, ncomp, mode, nchan,
                    planar, out);
  }
}

template <int kVariant, int kMcus>
void launch(const void* ac, const void* dc, const void* tables, void* out, void* sink,
            int batch, int n_mcu, int m_pad, int mxx, int bpm, int height, int width,
            int ncomp, int c0, int c1, int c2, int c3, int mode, int nchan, int planar,
            cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(batch) * n_mcu;
  const int64_t grid = (total + kMcus - 1) / kMcus;
  if (grid > 0) {
    variant_kernel<kVariant, kMcus><<<static_cast<unsigned>(grid), 128 * kMcus, 0, stream>>>(
        static_cast<const int16_t*>(ac), static_cast<const int32_t*>(dc),
        static_cast<const int32_t*>(tables), static_cast<uint8_t*>(out),
        static_cast<int*>(sink), total, n_mcu, m_pad, mxx, bpm, height, width, ncomp, c0, c1,
        c2, c3, mode, nchan, planar);
  }
}

}  // namespace

// ``variant``: 0 full, 1 no_store, 2 no_idct, 3 load_only; ``mcus``: MCUs a
// CUDA block (1 or 2; 2 only with the full variant).
extern "C" int zpix_backend_variant(int variant, int mcus, const void* ac, const void* dc,
                                    const void* tables, void* out, void* sink, int batch,
                                    int n_mcu, int m_pad, int mxx, int bpm, int height,
                                    int width, int ncomp, int c0, int c1, int c2, int c3,
                                    int mode, int nchan, int planar, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ZPIX_VARIANT(V, M)                                                                   \
  launch<V, M>(ac, dc, tables, out, sink, batch, n_mcu, m_pad, mxx, bpm, height, width,      \
               ncomp, c0, c1, c2, c3, mode, nchan, planar, s)
  if (mcus == 2 && variant == kFull)
    ZPIX_VARIANT(kFull, 2);
  else if (mcus != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  else if (variant == kFull)
    ZPIX_VARIANT(kFull, 1);
  else if (variant == kNoStore)
    ZPIX_VARIANT(kNoStore, 1);
  else if (variant == kNoIdct)
    ZPIX_VARIANT(kNoIdct, 1);
  else if (variant == kLoadOnly)
    ZPIX_VARIANT(kLoadOnly, 1);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef ZPIX_VARIANT
  return static_cast<int>(cudaGetLastError());
}
