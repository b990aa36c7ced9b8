// The zlib trailer check of K16's output: each image's adler32 (RFC 1950
// section 8.2) against the trailer the host tokenizer found after the
// final deflate block.  The JAX package has no counterpart: its
// device_inflate route checks no trailer, where the host decoder's zlib
// does (ops/inflate.py).
//
// adler32 of bytes d_0 .. d_{n-1}: A = 1 + sum d_i and
// B = n + sum (n - i) d_i, both mod 65521; the checksum is B << 16 | A.
// Both sums are linear in the bytes, so any split of an image adds up.
// One block an image: each thread sums its part in uint64 (n - i < 2^31
// and a thread adds fewer than 2^21 terms below 2^39), reduces it mod
// 65521, and the block adds the partial sums by warp shuffles.  Bytes are
// read 16 at a time from the first 16-byte boundary of the image's row.
// Bound on the H100: bytes, the B x n read once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint64_t kMod = 65521;
constexpr int kThreads = 1024;

__device__ __forceinline__ void add_byte(uint64_t& s1, uint64_t& s2, uint32_t d, int64_t n,
                                         int64_t i) {
  s1 += d;
  s2 += static_cast<uint64_t>(n - i) * d;
}

__global__ void adler32_kernel(const uint8_t* __restrict__ flat, int64_t n,
                               const uint32_t* __restrict__ want, uint32_t* __restrict__ sums,
                               int* bad) {
  __shared__ uint64_t part[2][kThreads / 32];
  const uint8_t* p = flat + static_cast<int64_t>(blockIdx.x) * n;
  uint64_t s1 = 0, s2 = 0;
  const int64_t head_max = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  const int64_t head = head_max < n ? head_max : n;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) add_byte(s1, s2, p[i], n, i);
  const int64_t nvec = (n - head) / 16;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int64_t j = threadIdx.x; j < nvec; j += blockDim.x) {
    const uint4 q = v[j];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    const int64_t i0 = head + 16 * j;
#pragma unroll
    for (int k = 0; k < 16; ++k) add_byte(s1, s2, (w[k >> 2] >> (8 * (k & 3))) & 0xFF, n, i0 + k);
  }
  for (int64_t i = head + 16 * nvec + threadIdx.x; i < n; i += blockDim.x)
    add_byte(s1, s2, p[i], n, i);
  s1 %= kMod;
  s2 %= kMod;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, d);
    s2 += __shfl_down_sync(0xffffffffu, s2, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t a = 1, b = static_cast<uint64_t>(n) % kMod;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
      a += part[0][w];
      b += part[1][w];
    }
    const uint32_t got = static_cast<uint32_t>((b % kMod) << 16 | (a % kMod));
    sums[blockIdx.x] = got;
    if (got != want[blockIdx.x]) atomicOr(bad, 2);  // ops/inflate.py ADLER_BAD
  }
}

}  // namespace

// flat u8 [batch, n] contiguous; want, sums [batch] (uint32 bits); bad
// int32 [1], ORed with 2 where an image's sum differs from its trailer.
extern "C" int zpix_adler32_check(const void* flat, int64_t n, const void* want, void* sums,
                                  void* bad, int64_t batch, void* stream) {
  if (batch > 0) {
    adler32_kernel<<<static_cast<unsigned>(batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), n, static_cast<const uint32_t*>(want),
        static_cast<uint32_t*>(sums), static_cast<int*>(bad));
  }
  return static_cast<int>(cudaGetLastError());
}
