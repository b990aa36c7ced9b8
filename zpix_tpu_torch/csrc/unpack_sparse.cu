// K7: sparse coefficient unpack.
//
// Replaces zpix_tpu/parallel/batch.py::_unpack_sparse_graph (:560) with
// _apply_perm (:573), the per-component step of the flat-buffer carve in
// _ycbcr_graph_flat (:630-642).  A block of 64 coefficients arrives as a
// 64-bit nonzero bitmap (MSB first in each byte: coefficient k is bit
// 7 - k%8 of byte k/8, numpy.packbits order) and the image's nonzero
// values, int16, back to back in stream order.  A set bit's value index
// is the number of set bits before it in the whole image (the JAX graph's
// cumsum(bits) - 1), clipped to [0, cap - 1]; the blocks then move from
// stream order to grid order, out[g] = unpacked[perm[g]].
//
// Two kernels behind one entry point:
//  1. block_offsets: one CUDA block per image runs a block-wide exclusive
//     scan of the blocks' popcounts, in chunks of blockDim.x blocks with a
//     carried total, into offs [B, nb] (int32 scratch the wrapper owns);
//  2. expand: one thread per (image, grid block, bitmap byte) takes the
//     stream block perm[g], ranks its set bits from offs and the earlier
//     bytes' popcounts, gathers the values and writes its 8 coefficients
//     as one 16-byte store, so a warp writes 512 contiguous bytes.
// Bound on the H100: bytes (8 bitmap bytes and the nonzero values in, 128
// bytes out per block); the expand pass is fully parallel, the scan pass
// reads only the bitmaps.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kExpandThreads = 256;

__global__ void block_offsets_kernel(const uint2* __restrict__ bitmap,
                                     int32_t* __restrict__ offs, int64_t nb) {
  __shared__ uint32_t warp_sum[32];
  __shared__ uint32_t carry;
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint2* bm = bitmap + b * nb;
  int32_t* out = offs + b * nb;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += blockDim.x) {
    const int64_t i = base + tid;
    uint32_t c = 0;
    if (i < nb) {
      const uint2 w = bm[i];
      c = __popc(w.x) + __popc(w.y);
    }
    uint32_t incl = c;  // warp-level inclusive scan
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // scan of the warp totals
      uint32_t t = lane < (blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += v;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const uint32_t before = (warp ? warp_sum[warp - 1] : 0) + incl - c;
    if (i < nb) out[i] = static_cast<int32_t>(carry + before);
    __syncthreads();
    if (tid == 0) carry += warp_sum[31];
    __syncthreads();
  }
}

__global__ void expand_kernel(const uint8_t* __restrict__ bitmap,
                              const int16_t* __restrict__ vals,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ offs,
                              int16_t* __restrict__ out, int64_t batch,
                              int64_t nb, int64_t cap) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= batch * nb * 8) return;
  const int byte = static_cast<int>(t & 7);
  const int64_t row = t >> 3;  // (image, grid block)
  const int64_t b = row / nb, g = row - b * nb;
  const int64_t s = perm ? perm[g] : g;  // the block's stream index
  const uint8_t* bm = bitmap + (b * nb + s) * 8;
  int64_t idx = offs[b * nb + s];
  for (int j = 0; j < byte; ++j) idx += __popc(bm[j]);
  const uint32_t m = bm[byte];
  const int16_t* v = vals + b * cap;
  __align__(16) int16_t coef[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool set = (m >> (7 - k)) & 1u;
    coef[k] = set ? v[idx < cap ? idx : cap - 1] : 0;
    idx += set;
  }
  reinterpret_cast<uint4*>(out)[t] = *reinterpret_cast<const uint4*>(coef);
}

}  // namespace

// bitmap u8 [B, nb, 8] (8-byte aligned), vals i16 [B, cap], perm i32 [nb]
// grid -> stream or null, offs i32 [B, nb] scratch, out i16 [B, nb, 64].
extern "C" int zpix_unpack_sparse(const void* bitmap, const void* vals,
                                  const void* perm, void* offs, void* out,
                                  int64_t batch, int64_t nb, int64_t cap,
                                  void* stream) {
  if (batch > 0 && nb > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    block_offsets_kernel<<<static_cast<unsigned>(batch), kScanThreads, 0, s>>>(
        static_cast<const uint2*>(bitmap), static_cast<int32_t*>(offs), nb);
    const int64_t n = batch * nb * 8;
    expand_kernel<<<static_cast<unsigned>((n + kExpandThreads - 1) / kExpandThreads),
                    kExpandThreads, 0, s>>>(
        static_cast<const uint8_t*>(bitmap), static_cast<const int16_t*>(vals),
        static_cast<const int32_t*>(perm), static_cast<const int32_t*>(offs),
        static_cast<int16_t*>(out), batch, nb, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
