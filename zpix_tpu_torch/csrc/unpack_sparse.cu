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
// Design (Hopper).  One launch for every component of a decode (a small
// descriptor a component: bitmap, values, cap, blocks, stream -> grid map,
// output), and no memset: the look-back words and the ticket counter
// live in a scratch kept between calls, each launch its own epoch
// (lookback.cuh).
// A CTA of kTile threads takes a tile of kTile stream-order blocks of one
// (image, component) by ticket (tiles of one component in order, images
// interleaved, so a tile waits only on tiles whose tickets came before;
// a ticket is taken when its CTA starts):
// - a thread loads one block's bitmap as an 8-byte word and popcounts
//   it; the CTA scans the counts (warp shuffles) into each block's offset
//   in the tile;
// - warp 0 publishes the tile's count and finds the image's count before
//   the tile by decoupled look-back over its earlier tiles (lookback.cuh);
// - the tile's values are one contiguous range of the image's values:
//   they arrive in shared memory by 16-byte cp.async (2-byte loads for
//   the unaligned head and tail), clipped at cap (an index at or past cap
//   reads value cap - 1, loaded once); the stage holds a dense tile
//   (staging only a window of it, with global reads past it, was no
//   faster: PERF.md, K7);
// - a thread expands one bitmap byte of a block from shared memory (8
//   coefficients, one 16-byte store), so 8 lanes write a block's whole
//   128-byte row, at its grid place through the stream -> grid map (the
//   inverse of the grid -> stream perm, built once on the host).
// Bound on the H100: bytes (8 bitmap bytes and the nonzero values in, the
// map, 128 bytes out a block; the rows written dominate).
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"
#include "timing.cuh"

namespace {

namespace lb = zpix_lookback;

constexpr int kMaxComps = 4;
constexpr int kTile = 256;  // stream blocks a CTA, a thread each (ops/sparse.py: K7_TILE_BLOCKS)

struct Comp {
  const uint64_t* bitmap;  // [B, nb] words, stream order
  const int16_t* vals;     // [B, cap]
  const int32_t* map;      // [nb] stream -> grid, or null (grid order)
  int16_t* out;            // [B, nb, 64], grid order
  int64_t cap;
  int nb, tpi;      // blocks and tiles an image
  int64_t ticket0;  // the component's first ticket and first look-back word
};

struct Args {
  Comp c[kMaxComps];
  int ncomp, batch;
};

// ``scratch``: word 0 the ticket counter, then one look-back word a tile.
__global__ void __launch_bounds__(kTile)
unpack_kernel(const __grid_constant__ Args A, uint64_t* scratch, int64_t tiles, uint32_t epoch) {
  extern __shared__ __align__(16) int16_t sv[];  // the tile's values: kTile * 64 + 8
  __shared__ uint64_t sbits[kTile];
  __shared__ uint32_t soff[kTile];
  __shared__ uint32_t wtot[kTile / 32];
  __shared__ int64_t s_ticket;
  __shared__ uint32_t s_base;
  constexpr int kWarps = kTile / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* const words = scratch + 1;
  if (tid == 0) s_ticket = lb::take_ticket(reinterpret_cast<uint32_t*>(scratch), tiles);
  __syncthreads();
  const int64_t tk = s_ticket;
  int c = 0;
  while (c + 1 < A.ncomp && tk >= A.c[c + 1].ticket0) ++c;
  const Comp& C = A.c[c];
  const int64_t k = tk - C.ticket0;
  const int t = static_cast<int>(k / A.batch);
  const int b = static_cast<int>(k - static_cast<int64_t>(t) * A.batch);
  const int s0 = t * kTile;             // the tile's first stream block
  const int nbt = min(kTile, C.nb - s0);  // its blocks
  const int64_t row0 = static_cast<int64_t>(b) * C.nb;

  // bitmaps, counts, and each block's offset in the tile
  const uint64_t w = tid < nbt ? __ldg(C.bitmap + row0 + s0 + tid) : 0ull;
  sbits[tid] = w;
  const uint32_t cnt = __popcll(w);
  uint32_t x = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(lb::kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wtot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t y = lane < kWarps ? wtot[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t z = __shfl_up_sync(lb::kFull, y, d);
      if (lane >= d) y += z;
    }
    if (lane < kWarps) wtot[lane] = y;
  }
  __syncthreads();
  soff[tid] = (warp ? wtot[warp - 1] : 0u) + x - cnt;
  const uint32_t total = wtot[kWarps - 1];

  // the image's count before the tile
  if (warp == 0) {
    uint64_t* img = words + C.ticket0 + static_cast<int64_t>(b) * C.tpi;
    if (lane == 0) lb::publish(img + t, t == 0 ? lb::kInclusive : lb::kAggregate, total, epoch);
    const uint32_t in = t == 0 ? 0u : lb::carry_in(img, t, 1, epoch);
    if (lane == 0) {
      if (t > 0) lb::publish(img + t, lb::kInclusive, in + total, epoch);
      s_base = in;
    }
  }
  __syncthreads();

  // the tile's values [base, base + total), clipped at cap, into shared
  // memory: value base + i at sv[sh + i], sh putting 16-byte aligned
  // addresses on 16-byte aligned slots
  const int64_t base = s_base;
  const int16_t* v = C.vals + static_cast<int64_t>(b) * C.cap;
  const int nv = static_cast<int>(max(static_cast<int64_t>(0), min(base + total, C.cap) - base));
  const uintptr_t at = reinterpret_cast<uintptr_t>(v + base);
  const int hf = static_cast<int>(((16u - (at & 15u)) & 15u) >> 1);  // values before a 16-byte line
  const int sh = (8 - hf) & 7, h = min(nv, hf);
  const int chunks = (nv - h) >> 3;
  for (int i = tid; i < chunks; i += kTile)
    lb::cp_async16(sv + sh + h + 8 * i, v + base + h + 8 * i);
  for (int i = tid; i < h; i += kTile) sv[sh + i] = v[base + i];
  for (int i = h + 8 * chunks + tid; i < nv; i += kTile) sv[sh + i] = v[base + i];
  const int16_t last = __ldg(v + C.cap - 1);
  lb::cp_async_wait_all();
  __syncthreads();

  // a thread a (block, bitmap byte): 8 coefficients, one 16-byte store
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = tid + j * kTile;
    const int i = p >> 3, byte = p & 7;
    if (i < nbt) {
      const uint64_t bw = sbits[i];
      uint32_t idx = soff[i] + __popcll(bw & ((1ull << (8 * byte)) - 1ull));
      const uint32_t m = static_cast<uint32_t>(bw >> (8 * byte)) & 0xffu;
      uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if ((m >> (7 - e)) & 1u) {
          const int16_t val = base + idx < C.cap ? sv[sh + idx] : last;
          q[e >> 1] |= static_cast<uint32_t>(static_cast<uint16_t>(val)) << (16 * (e & 1));
          ++idx;
        }
      }
      const int64_t g = C.map != nullptr ? __ldg(C.map + s0 + i) : s0 + i;
      reinterpret_cast<uint4*>(C.out + (row0 + g) * 64)[byte] = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

}  // namespace

// ``desc`` (host memory): ncomp rows of six int64 -- bitmap (8-byte
// aligned), values, stream -> grid map (0: grid order), output, cap
// (>= 1), blocks (< 2^26) -- for a batch of ``batch`` images each;
// ``scratch``: ``scratch_words`` uint64, at least one more than the tiles
// (batch * ceil(blocks / kTile) summed over the components), its word 0
// (the ticket counter) 0 and no word set at ``epoch`` (1 .. 2^30 - 1).
extern "C" int zpix_unpack_sparse(const void* desc, int ncomp, int batch, void* scratch,
                                  int64_t scratch_words, int epoch, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (ncomp < 1 || ncomp > kMaxComps || batch < 0 || epoch < 1 ||
      static_cast<uint32_t>(epoch) > lb::kEpochMask)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* d = static_cast<const int64_t*>(desc);
  Args A;
  A.ncomp = ncomp, A.batch = batch;
  int64_t tiles = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    Comp& C = A.c[c];
    if (c >= ncomp) {
      C = A.c[0];
      continue;
    }
    const int64_t* r = d + 6 * c;
    C.bitmap = reinterpret_cast<const uint64_t*>(r[0]);
    C.vals = reinterpret_cast<const int16_t*>(r[1]);
    C.map = reinterpret_cast<const int32_t*>(r[2]);
    C.out = reinterpret_cast<int16_t*>(r[3]);
    C.cap = r[4];
    if (C.cap < 1 || r[5] < 1 || r[5] >= (int64_t(1) << 26) || r[0] % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    C.nb = static_cast<int>(r[5]);
    C.tpi = (C.nb + kTile - 1) / kTile;
    C.ticket0 = tiles;
    tiles += static_cast<int64_t>(batch) * C.tpi;
  }
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  if (scratch == nullptr || scratch_words < tiles + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kTile) * 64 + 8) * sizeof(int16_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        unpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  unpack_kernel<<<static_cast<unsigned>(tiles), kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      A, static_cast<uint64_t*>(scratch), tiles, static_cast<uint32_t>(epoch));
  return static_cast<int>(cudaGetLastError());
}
