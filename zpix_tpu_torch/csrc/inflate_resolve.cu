// K16: LZ77 copy resolve -- a batch's DEFLATE tokens -> the inflated bytes.
//
// Replaces zpix_tpu/ops/inflate.py::resolve_tokens_jnp (:33), vmapped an
// image (zpix_tpu/parallel/png_batch.py:498-500).  Input: the host
// symbol-resolve pass's tokens (csrc/host/inflate.cpp) of each image,
// lens and dists int32, lits u8, [B, NT] through a row stride (zero-length
// padding after each image's last token); output [B, per] u8.  The
// function, per image: byte pos belongs to the last token whose start
// (exclusive prefix sum of lens) is <= pos; a literal byte is its token's
// lit, a copy byte is the byte at pos - dist (RFC 1951's overlapping copy:
// the chain pos -> pos - dist -> ... ends at a literal).  Domain: every
// real length >= 1, the lengths summing to per, 1 <= dist <= the bytes
// before the token, lit 0 on copies.  Outside it the kernels stay inside
// their buffers by clamping (the decoder never passes such tokens).
//
// Kernels, all on the caller's stream:
//  1. tile_sums: the sum of lens over each 4,096-token tile;
//  2. tile_offsets: a per-image exclusive scan of the tile sums;
//  3. fill: a block scans its tile's lens, and a thread a token writes,
//     over [start, start + len), the source pointer (pos for a literal,
//     pos - dist for a copy) into src [B, per] int32 and, for a literal,
//     its byte into out;
//  4. double (``rounds`` launches): pointer doubling src[q] = src[src[q]],
//     in place.  In place is exact: every value src[q] ever holds is an
//     ancestor of q on its chain (or its literal root), so a value read
//     mid-update is too, and after round k every pointer has moved at
//     least 2^k steps up its chain (or reached the root), as with ping-pong
//     buffers.  Chains strictly decrease, so ceil(log2 per) rounds always
//     reach the fixed point.  Round k sets changed[k] when it moved any
//     pointer; a round that finds changed[k - 1] == 0 returns at once, so
//     the rounds after the fixed point cost a launch each and no host sync;
//  5. gather: out[pos] = out[src[pos]] for copy bytes (src[pos] is then a
//     literal's position, whose byte is final).
// Bound on the H100: bytes -- the tokens read (9 bytes a token) and the
// output written once; the doubling rounds re-read the int32 pointer field
// (4 bytes a byte of output, a gather and a write a round).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kScanThreads * kItems;  // tokens a tile
constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 16;  // grid-stride kernels: 16 blocks an SM

// Block-wide exclusive scan of one value a thread (blockDim.x == 1024);
// *block_total gets the sum.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sum,
                                                        int32_t* block_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t t = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  const int32_t before = (warp ? warp_sum[warp - 1] : 0) + incl - v;
  *block_total = warp_sum[31];
  __syncthreads();
  return before;
}

// grid (tiles, B): the sum of each tile's lens.
__global__ void tile_sums_kernel(const int32_t* __restrict__ lens, int64_t ts, int64_t nt,
                                 int32_t* __restrict__ tile_sum, int tiles) {
  __shared__ int32_t warp_sum[32];
  const int64_t b = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int32_t v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < nt) v += lens[b * ts + i0 + k];
  }
  int32_t total;
  block_exclusive_scan(v, warp_sum, &total);
  if (threadIdx.x == 0) tile_sum[b * tiles + blockIdx.x] = total;
}

// grid B: tile sums -> exclusive tile offsets, in place.
__global__ void tile_offsets_kernel(int32_t* __restrict__ tile_sum, int tiles) {
  __shared__ int32_t warp_sum[32];
  int32_t* t = tile_sum + static_cast<int64_t>(blockIdx.x) * tiles;
  int32_t carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t v = i < tiles ? t[i] : 0;
    int32_t sum;
    const int32_t before = block_exclusive_scan(v, warp_sum, &sum);
    if (i < tiles) t[i] = carry + before;
    carry += sum;
  }
}

// grid (tiles, B): each token's bytes get their source pointer; literals
// their byte.
__global__ void fill_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ dists,
                            const uint8_t* __restrict__ lits, int64_t ts, int64_t nt,
                            const int32_t* __restrict__ tile_off, int tiles,
                            int32_t* __restrict__ src, uint8_t* __restrict__ out,
                            int64_t per) {
  __shared__ int32_t warp_sum[32];
  const int64_t b = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int32_t len[kItems], v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    len[k] = i0 + k < nt ? lens[b * ts + i0 + k] : 0;
    len[k] = len[k] > 0 ? len[k] : 0;
    v += len[k];
  }
  int32_t total;
  int64_t start =
      tile_off[b * tiles + blockIdx.x] + block_exclusive_scan(v, warp_sum, &total);
  int32_t* s = src + b * per;
  uint8_t* o = out + b * per;
  for (int k = 0; k < kItems; ++k) {
    if (len[k] > 0) {
      const int32_t d = dists[b * ts + i0 + k];
      // [lo, end) within the image, also where lengths past the domain
      // wrapped the int32 scan
      const int64_t lo = start > 0 ? start : 0;
      const int64_t end = start + len[k] < per ? start + len[k] : per;
      if (d > 0) {
        for (int64_t pos = lo; pos < end; ++pos) {
          s[pos] = static_cast<int32_t>(pos - d > 0 ? pos - d : 0);
        }
      } else {
        const uint8_t lit = lits[b * ts + i0 + k];
        for (int64_t pos = lo; pos < end; ++pos) {
          s[pos] = static_cast<int32_t>(pos);
          o[pos] = lit;
        }
      }
    }
    start += len[k];
  }
}

// One doubling round over the batch's pointer field, in place.
__global__ void double_kernel(int32_t* src, int64_t per, int64_t n, int* changed, int round) {
  if (round > 0 && changed[round - 1] == 0) return;  // the fixed point was reached
  bool moved = false;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t base = t / per * per;
    int32_t s = src[t];
    s = s < 0 ? 0 : (s >= per ? static_cast<int32_t>(per - 1) : s);
    int32_t s2 = src[base + s];
    s2 = s2 < 0 ? 0 : (s2 >= per ? static_cast<int32_t>(per - 1) : s2);
    if (s2 != s) {
      src[t] = s2;
      moved = true;
    }
  }
  if (__syncthreads_or(moved) && threadIdx.x == 0) changed[round] = 1;
}

// Copy bytes take their literal root's byte.
__global__ void gather_kernel(const int32_t* __restrict__ src, uint8_t* out, int64_t per,
                              int64_t n) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t pos = t % per;
    int32_t s = src[t];
    s = s < 0 ? 0 : (s >= per ? static_cast<int32_t>(per - 1) : s);
    if (s != pos) out[t] = out[t - pos + s];
  }
}

}  // namespace

// lens, dists int32 and lits u8 [B, nt] with row stride ts (elements);
// scratch: src int32 [B, per], tile_sum int32 [B, ceil(nt / 4096)],
// changed int32 [rounds] zeroed; out u8 [B, per].
extern "C" int zpix_inflate_resolve(const void* lens, const void* dists, const void* lits,
                                    int64_t ts, int64_t nt, void* src, void* tile_sum,
                                    void* changed, void* out, int64_t batch, int64_t per,
                                    int rounds, void* stream) {
  if (batch > 0 && per > 0 && nt > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = static_cast<int>((nt + kTile - 1) / kTile);
    const dim3 grid(tiles, static_cast<unsigned>(batch));
    auto* tsum = static_cast<int32_t*>(tile_sum);
    auto* s = static_cast<int32_t*>(src);
    auto* o = static_cast<uint8_t*>(out);
    tile_sums_kernel<<<grid, kScanThreads, 0, st>>>(static_cast<const int32_t*>(lens), ts, nt,
                                                     tsum, tiles);
    tile_offsets_kernel<<<static_cast<unsigned>(batch), kScanThreads, 0, st>>>(tsum, tiles);
    fill_kernel<<<grid, kScanThreads, 0, st>>>(
        static_cast<const int32_t*>(lens), static_cast<const int32_t*>(dists),
        static_cast<const uint8_t*>(lits), ts, nt, tsum, tiles, s, o, per);
    const int64_t n = batch * per;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < kMaxGrid ? want : kMaxGrid);
    for (int r = 0; r < rounds; ++r) {
      double_kernel<<<blocks, kThreads, 0, st>>>(s, per, n, static_cast<int*>(changed), r);
    }
    gather_kernel<<<blocks, kThreads, 0, st>>>(s, o, per, n);
  }
  return static_cast<int>(cudaGetLastError());
}
