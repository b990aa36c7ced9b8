// K3: DC predictor restore.
//
// Replaces zpix_tpu/parallel/device_entropy.py::_restore_dc_T_split
// (:836-851).  A component's predictor chain visits its blocks in (MCU,
// slot) order and restarts at every restart segment (T.81 F.2.1.3.1,
// decoder.zig:1366-1376), so the restored DC is the inclusive prefix sum
// of the diffs along each (segment, component) chain.  Two forms:
//  - thread per chain (zpix_dc_restore): one thread walks one chain, for
//    short chains (24,576 chains of 32 or 8 blocks at DRI 8);
//  - block per chain (zpix_dc_restore_long): one CUDA block scans one
//    chain in chunks of blockDim.x blocks, a block-wide scan per chunk
//    with the carried total, for the whole-image chains of restart-free
//    streams (48 chains of 16,384 or 4,096 blocks for 16 1024^2 4:2:0
//    images), where a lone thread would walk 16,384 dependent adds.
// Both add in uint32: addition mod 2^32 is associative, so the scan
// gives the int32-wrapping sums of numpy and XLA exactly.
// Bound on the H100: bytes, 4 read and 4 written per block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void dc_restore_kernel(const int32_t* __restrict__ dc,
                                  int32_t* __restrict__ out, int n_seg,
                                  int m_pad, int bpm, int ncomp, int nb0,
                                  int nb1, int nb2, int nb3) {
  const int chain = blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= n_seg * ncomp) return;
  const int seg = chain / ncomp, c = chain % ncomp;
  const int nb[4] = {nb0, nb1, nb2, nb3};
  int s0 = 0;
  for (int i = 0; i < c; ++i) s0 += nb[i];
  const int64_t base = static_cast<int64_t>(seg) * m_pad * bpm + s0;
  uint32_t acc = 0;  // int32 wraps, as in numpy and XLA
  for (int m = 0; m < m_pad; ++m) {
    for (int j = 0; j < nb[c]; ++j) {
      const int64_t i = base + static_cast<int64_t>(m) * bpm + j;
      acc += static_cast<uint32_t>(dc[i]);
      out[i] = static_cast<int32_t>(acc);
    }
  }
}

constexpr int kLongThreads = 1024;

__global__ void dc_restore_long_kernel(const int32_t* __restrict__ dc,
                                       int32_t* __restrict__ out, int ncomp,
                                       int m_pad, int bpm, int nb0, int nb1,
                                       int nb2, int nb3) {
  __shared__ uint32_t warp_sum[32];
  __shared__ uint32_t carry;
  const int seg = blockIdx.x / ncomp, c = blockIdx.x % ncomp;
  const int nb[4] = {nb0, nb1, nb2, nb3};
  int s0 = 0;
  for (int i = 0; i < c; ++i) s0 += nb[i];
  const int64_t base = static_cast<int64_t>(seg) * m_pad * bpm + s0;
  const int64_t len = static_cast<int64_t>(m_pad) * nb[c];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int64_t e0 = 0; e0 < len; e0 += blockDim.x) {
    const int64_t e = e0 + tid;  // chain position: (MCU, block of c)
    const int64_t i = base + (e / nb[c]) * bpm + e % nb[c];
    uint32_t incl = e < len ? static_cast<uint32_t>(dc[i]) : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      uint32_t t = lane < (blockDim.x >> 5) ? warp_sum[lane] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += v;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    if (e < len)
      out[i] = static_cast<int32_t>(carry + (warp ? warp_sum[warp - 1] : 0u) + incl);
    __syncthreads();
    if (tid == 0) carry += warp_sum[31];
    __syncthreads();
  }
}

}  // namespace

extern "C" int zpix_dc_restore_long(const void* dc, void* out, int n_seg, int m_pad,
                                    int bpm, int ncomp, int nb0, int nb1, int nb2,
                                    int nb3, void* stream) {
  if (n_seg > 0) {
    dc_restore_long_kernel<<<n_seg * ncomp, kLongThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dc), static_cast<int32_t*>(out), ncomp, m_pad,
        bpm, nb0, nb1, nb2, nb3);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zpix_dc_restore(const void* dc, void* out, int n_seg, int m_pad,
                               int bpm, int ncomp, int nb0, int nb1, int nb2,
                               int nb3, void* stream) {
  const int n = n_seg * ncomp;
  if (n > 0) {
    dc_restore_kernel<<<(n + 127) / 128, 128, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(dc), static_cast<int32_t*>(out), n_seg,
        m_pad, bpm, ncomp, nb0, nb1, nb2, nb3);
  }
  return static_cast<int>(cudaGetLastError());
}
