// K5: standalone exact Wang IDCT over [N, 8, 8] int32 blocks.
//
// Replaces zpix_tpu/ops/idct.py::idct_pallas (the repo's one Pallas
// kernel, pallas_call at :286), which puts the block index on the TPU's
// 128-wide lane axis.  Here a CUDA block of 128 threads takes 16 blocks:
// the rows are loaded coalesced into shared memory, one thread runs the
// row butterfly of one row and then the column butterfly of one column,
// and the rows go back out coalesced.
//
// Bound on the H100: bytes.  Each block is read once and written once
// (512 bytes); the two butterflies are ~950 integer operations a block,
// far below what the SMs execute in the time the bytes take.
#include <cuda_runtime.h>

#include <cstdint>

#include "timing.cuh"
#include "wang_idct.cuh"

namespace {

constexpr int kBlocksPerCta = 16;

__global__ void idct_blocks_kernel(const int32_t* __restrict__ in,
                                   int32_t* __restrict__ out, int64_t n) {
  __shared__ int32_t s[kBlocksPerCta * 64];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kBlocksPerCta;
  const int64_t nvals = (n - b0 < kBlocksPerCta ? n - b0 : kBlocksPerCta) * 64;
  for (int i = threadIdx.x; i < nvals; i += blockDim.x) s[i] = in[b0 * 64 + i];
  __syncthreads();
  const int blk = threadIdx.x >> 3, r = threadIdx.x & 7;
  const bool live = blk * 64 < nvals;
  if (live) zpix::wang_row(s + blk * 64 + r * 8);
  __syncthreads();
  if (live) zpix::wang_col(s + blk * 64 + r, 8);
  __syncthreads();
  for (int i = threadIdx.x; i < nvals; i += blockDim.x) out[b0 * 64 + i] = s[i];
}

}  // namespace

extern "C" int zpix_idct_blocks(const void* in, void* out, int64_t n,
                                void* stream) {
  const zpix::TimedEntry timed(stream);
  if (n > 0) {
    const int64_t grid = (n + kBlocksPerCta - 1) / kBlocksPerCta;
    idct_blocks_kernel<<<static_cast<unsigned>(grid), kBlocksPerCta * 8, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
