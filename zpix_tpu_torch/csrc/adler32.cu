// The zlib trailer check of K16's output: each image's adler32 (RFC 1950
// section 8.2) against the trailer the host tokenizer found after the
// final deflate block.  The JAX package has no counterpart: its
// device_inflate route checks no trailer, where the host decoder's zlib
// does (ops/inflate.py).
//
// adler32 of bytes d_0 .. d_{n-1}: A = 1 + sum d_i and
// B = n + sum (n - i) d_i, both mod 65521; the checksum is B << 16 | A.
// Both sums are linear in the bytes, so any split of an image adds up.
// Each image is cut into spans of L bytes (a power of two, 16 <= L <=
// 2^20; ops/inflate.py ADLER_SPAN), a CTA a span, so that the whole card
// reads (the main shape, 16 images of 3 MiB, is 768 CTAs where one CTA an
// image left 116 of 132 SMs idle).  A span starting at i0 with
// S = sum d_i and T = sum (i - i0) d_i adds S to A and (n - i0) S - T to
// B.  Thread t of kThreads reads the span's head bytes (up to the first
// 16-byte boundary) t, its 16-byte groups t, t + kThreads, ..., and its
// tail bytes t, as one byte or one 16-byte load each; a group's S and
// sum k d_k (k = 0..15) are eight __dp4a, and its offset r in the span
// adds r S_group + sum k d_k to T, one 32 x 32 -> 64 multiply-add.
// Largest values, an all-0xFF span: a group's S 4,080 and sum k d_k
// 30,600; a thread's s (uint32) at most 255 (16 ceil(L / (16 kThreads))
// + 2), 65,790 at L = 2^16, and its w (uint64) at most that s times
// (L - 1), 4.3e9 at L = 2^16 (an all-0xFF span reaches 2.27e9 there) and
// 1.1e12 at L = 2^20, past 2^32 from L = 2^17; each is reduced mod 65521
// before the CTA adds them (< 2^24).  The CTA writes its span's (S, B term) mod
// 65521 to scratch, and the last CTA of an image (a ticket an image,
// zeroed by a memset in the entry; __threadfence before the ticket)
// adds the image's terms, writes the checksum and ORs ADLER_BAD into
// ``bad`` on a mismatch: one launch, no CTA waits on another.
// Bound on the H100: bytes, the B x n read once.
#include <cuda_runtime.h>

#include <cstdint>

#include "timing.cuh"

namespace {

constexpr uint32_t kMod = 65521;
constexpr int kThreads = 256;  // ops/inflate.py ADLER_THREADS
constexpr int kUnroll = 4;     // 16-byte loads a thread has in flight

__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// One 16-byte group at offset r of the span: s += S, w += r S + sum k d_k.
__device__ __forceinline__ void add_group(uint32_t& s, uint64_t& w, const uint4 q, uint32_t r) {
  uint32_t gs = __dp4a(q.x, 0x01010101u, 0u);
  gs = __dp4a(q.y, 0x01010101u, gs);
  gs = __dp4a(q.z, 0x01010101u, gs);
  gs = __dp4a(q.w, 0x01010101u, gs);
  uint32_t gw = __dp4a(q.x, 0x03020100u, 0u);
  gw = __dp4a(q.y, 0x07060504u, gw);
  gw = __dp4a(q.z, 0x0B0A0908u, gw);
  gw = __dp4a(q.w, 0x0F0E0D0Cu, gw);
  s += gs;
  w += static_cast<uint64_t>(r) * gs + gw;
}

__global__ void __launch_bounds__(kThreads)
adler32_kernel(const uint8_t* __restrict__ flat, int64_t n, int lg_span, int64_t spans,
               int64_t work, const uint32_t* __restrict__ want, uint32_t* __restrict__ sums,
               int* bad, unsigned* tickets, uint32_t* parts) {
  __shared__ uint32_t red[kThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int64_t span = int64_t{1} << lg_span;
  for (int64_t item = blockIdx.x; item < work; item += gridDim.x) {
    const int64_t b = item / spans, k = item - b * spans;  // once a CTA
    const int64_t i0 = k << lg_span;
    const int64_t len = n - i0 < span ? n - i0 : span;
    const uint8_t* p = flat + b * n + i0;
    const int64_t head_max = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
    const uint32_t head = static_cast<uint32_t>(head_max < len ? head_max : len);
    const uint32_t nvec = static_cast<uint32_t>((len - head) >> 4);
    uint32_t s = 0;
    uint64_t w = 0;
    if (static_cast<uint32_t>(tid) < head) {
      const uint32_t d = p[tid];
      s += d;
      w += static_cast<uint64_t>(tid) * d;
    }
    const uint4* v = reinterpret_cast<const uint4*>(p + head);
    uint32_t j = tid;
    for (; j + (kUnroll - 1) * kThreads < nvec; j += kUnroll * kThreads) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) q[u] = __ldcs(v + j + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_group(s, w, q[u], head + 16 * (j + u * kThreads));
    }
    for (; j < nvec; j += kThreads) add_group(s, w, __ldcs(v + j), head + 16 * j);
    const uint32_t t = head + 16 * nvec + tid;
    if (t < len) {
      const uint32_t d = p[t];
      s += d;
      w += static_cast<uint64_t>(t) * d;
    }
    const uint32_t S = block_sum(s % kMod, red) % kMod;
    const uint32_t T = block_sum(static_cast<uint32_t>(w % kMod), red) % kMod;
    if (tid == 0) {
      const uint64_t bt = static_cast<uint64_t>((n - i0) % kMod) * S + (kMod - T);
      uint32_t* part = parts + 2 * item;
      part[0] = S;
      part[1] = static_cast<uint32_t>(bt % kMod);
      __threadfence();  // the terms are visible before the ticket
      last = atomicAdd(tickets + b, 1u) == spans - 1;
    }
    __syncthreads();
    if (last) {  // every span of image b has written its terms
      __threadfence();
      uint64_t a = 0, bb = 0;
      for (int64_t q = tid; q < spans; q += kThreads) {
        a += __ldcg(parts + 2 * (b * spans + q));
        bb += __ldcg(parts + 2 * (b * spans + q) + 1);
      }
      const uint32_t A = block_sum(static_cast<uint32_t>(a % kMod), red) % kMod;
      const uint32_t B = block_sum(static_cast<uint32_t>(bb % kMod), red) % kMod;
      if (tid == 0) {
        const uint32_t A1 = (A + 1) % kMod, B1 = static_cast<uint32_t>((B + n % kMod) % kMod);
        const uint32_t got = B1 << 16 | A1;
        sums[b] = got;
        if (got != want[b]) atomicOr(bad, 2);  // ops/inflate.py ADLER_BAD
      }
    }
    __syncthreads();  // ``last`` and ``red`` are read before the next item
  }
}

}  // namespace

// flat u8 [batch, n] contiguous; want, sums [batch] (uint32 bits); bad
// int32 [1], ORed with 2 where an image's sum differs from its trailer;
// scratch uint32 [batch + 2 * batch * spans] (ops/inflate.py
// adler32_scratch_words), spans = max(1, ceil(n / 2^lg_span)): a ticket an
// image (zeroed here), then each span's two terms.
extern "C" int zpix_adler32_check(const void* flat, int64_t n, const void* want, void* sums,
                                  void* bad, int64_t batch, int lg_span, void* scratch,
                                  void* stream) {
  const zpix::TimedEntry timed(stream);
  if (lg_span < 4 || lg_span > 20) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t spans = n > 0 ? ((n - 1) >> lg_span) + 1 : 1;  // n = 0: one empty span
    const int64_t work = batch * spans;
    unsigned* tickets = static_cast<unsigned*>(scratch);
    const cudaError_t err = cudaMemsetAsync(tickets, 0, batch * sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t grid = work < 0x7fffffff ? work : 0x7fffffff;
    adler32_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(flat), n, lg_span, spans, work,
        static_cast<const uint32_t*>(want), static_cast<uint32_t*>(sums), static_cast<int*>(bad),
        tickets, static_cast<uint32_t*>(scratch) + batch);
  }
  return static_cast<int>(cudaGetLastError());
}
