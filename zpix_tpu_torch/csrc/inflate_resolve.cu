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
// real length in 1..258, the lengths summing to per, 1 <= dist <= 32,768
// and <= the bytes before the token, lit 0 on copies.  Outside it the
// kernels stay inside their buffers and never wait on a tile that cannot
// finish (a byte's value is then unspecified).
//
// Bound on the H100: bytes -- the token rows (9 bytes a token; on the
// bench content ~2.1 M tokens for 3.1 MB an image, 312 MB a batch) and the
// output written once.  The old design (a pointer field src [B, per]
// int32 in device memory, 5-6 working doubling rounds of gather and write
// over it, 26 launches) took 2.78 ms a call against a 0.108 ms bound.
//
// This design keeps every pointer in shared memory.  DEFLATE's window is
// 32,768 bytes, so if each image's output is cut into tiles of T bytes that
// finish in order, every source outside a tile lies in a tile that is
// already final.  A call is one memset and two kernels on the caller's
// stream:
//  0. memset: the ticket and the tile flags;
//  1. sums: the length sum of every chunk of 4,096 tokens (the lens read
//     once);
//  2. resolve: blocks take (image, tile) tickets, interleaved over the
//     images, so that a tile's predecessors are always held by blocks
//     already running.  A block finds the token that covers its tile's
//     first byte (warp 0 walks the image's chunk sums, the block scans
//     that one chunk), then walks its tile's tokens 1,024 at a time (the
//     next round's tokens load during this one; a block scan of the lens
//     places them; a warp writes its 32 tokens' bytes together, each lane
//     finding its byte's token by a binary search over the warp's starts,
//     so that no warp waits on its longest copy).  Each byte gets an int16
//     tile-local source pointer in shared memory (itself for a literal,
//     pos - dist for a copy, negative when before the tile); pointer
//     doubling in shared memory resolves the in-tile chains (in place:
//     every value a pointer holds is an ancestor on its chain, so a round
//     reaches at least as far as a ping-pong round); literal-rooted bytes
//     are written at once; then, only when some chain left the tile, the
//     block waits (acquire) for the flags of the tiles that hold those
//     roots, reads them through L2 (never a stale L1 line), 16 at a time,
//     and writes them.  Last it sets its own flag (release).
// The tiles of an image form a chain of hand-offs (a tile's chains nearly
// always reach into the tile before), so a tile's cost after its wait is
// what the tile size trades against the number of tiles.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// A wait that outlasts this many polls (seconds; a valid input's waits end
// within microseconds) aborts the kernel with a launch failure rather than
// hang the card.
constexpr unsigned kSpinLimit = 1u << 24;

__device__ __forceinline__ void spin_guard(unsigned& polls) {
  if (++polls > kSpinLimit) __trap();
}

constexpr int kThreads = 1024;              // a resolve block
constexpr int kSumThreads = 256, kItems = 16;  // a sums block
constexpr int kChunk = kSumThreads * kItems;  // tokens a chunk: 4,096

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Block-wide exclusive scan of one value a thread (blockDim.x == 1024);
// every thread gets the block's total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  const int before = (warp ? warp_sum[warp - 1] : 0) + incl - v;
  *total = warp_sum[31];
  __syncthreads();
  return before;
}

struct Scratch {  // views of the one scratch buffer
  int* ticket;     // [1], zeroed: the resolve's tickets
  int* flag;       // [B, tiles], zeroed: 1 once the tile is written
  int* chunk_sum;  // [B, chunks]: the lengths of each chunk of 4,096 tokens
};

// grid (chunks, B): the sum of each chunk's lengths.
__global__ void __launch_bounds__(kSumThreads) sums_kernel(const int32_t* __restrict__ lens,
                                                           int64_t ts, int64_t nt, int chunks,
                                                           int* __restrict__ chunk_sum) {
  __shared__ int warp_sum[kSumThreads / 32];
  const int64_t b = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x * kItems;
  int v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int len = i0 + k < nt ? lens[b * ts + i0 + k] : 0;
    v += len > 0 ? len : 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) total += warp_sum[w];
    chunk_sum[b * chunks + blockIdx.x] = total;
  }
}

// A tile-local source pointer: -32,768 (a copy 32,768 back from the tile's
// first byte) to T - 1 fits int16 for T <= 32,768.
template <int T>
__global__ void __launch_bounds__(kThreads) resolve_kernel(
    const int32_t* __restrict__ lens, const int32_t* __restrict__ dists,
    const uint8_t* __restrict__ lits, int64_t ts, int64_t nt, uint8_t* out, int batch,
    int64_t per, int tiles, int chunks, Scratch s) {
  static_assert(T <= 32768 && T % kThreads == 0, "tile-local pointers are int16");
  extern __shared__ int16_t sp[];                                // [T] tile-local source
  uint8_t* val = reinterpret_cast<uint8_t*>(sp + T);             // [T] literal bytes
  __shared__ int warp_sum[32];
  __shared__ int ticket, lo_root, n_cross, first_tok;
  __shared__ int64_t chunk_off, first_start;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    ticket = atomicAdd(s.ticket, 1);
    lo_root = 0x7fffffff;
    n_cross = 0;
  }
  __syncthreads();
  const int b = ticket % batch, k = ticket / batch;
  const int64_t t0 = static_cast<int64_t>(k) * T;
  const int n = static_cast<int>(per - t0 < T ? per - t0 : T);
  const int32_t* L = lens + b * ts;
  const int32_t* D = dists + b * ts;
  const uint8_t* C = lits + b * ts;
  uint8_t* o = out + b * per;
  const int64_t slot = static_cast<int64_t>(b) * tiles + k;

  // 1. the tile's bytes -> local pointers and literal bytes
  for (int q = threadIdx.x; q < n; q += kThreads) {  // bytes no token reaches
    sp[q] = static_cast<int16_t>(q);
  }
  __syncthreads();
  // 0. the token that covers the tile's first byte: warp 0 finds its chunk
  // over the image's chunk sums, then the block scans that chunk
  if (threadIdx.x < 32) {
    const int* cs = s.chunk_sum + static_cast<int64_t>(b) * chunks;
    int64_t carry = 0;
    int found = chunks;  // t0 past the lengths' total: outside the domain
    for (int c0 = 0; c0 < chunks && found == chunks; c0 += 32) {
      const int v = c0 + lane < chunks ? cs[c0 + lane] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, v > 0 && carry + incl > t0);
      if (hit) {  // the first chunk whose end passes t0 holds it
        const int at = __ffs(hit) - 1;
        const int before = __shfl_sync(0xffffffffu, incl - v, at);
        found = c0 + at;
        if (lane == 0) chunk_off = carry + before;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      first_tok = found * kChunk;
      if (found == chunks) chunk_off = carry;
    }
  }
  __syncthreads();
  {
    const int64_t c0 = first_tok;
    const int64_t i0 = c0 + threadIdx.x * (kChunk / kThreads);
    int len[kChunk / kThreads], v = 0;
#pragma unroll
    for (int k = 0; k < kChunk / kThreads; ++k) {
      len[k] = i0 + k < nt && i0 + k < c0 + kChunk ? L[i0 + k] : 0;
      len[k] = len[k] > 0 ? len[k] : 0;
      v += len[k];
    }
    int total;
    int64_t st = chunk_off + block_exclusive_scan(v, warp_sum, &total);
#pragma unroll
    for (int k = 0; k < kChunk / kThreads; ++k) {
      if (len[k] > 0 && st <= t0 && t0 < st + len[k]) {
        first_tok = static_cast<int>(i0 + k);
        first_start = st;
      }
      st += len[k];
    }
    if (threadIdx.x == 0 && c0 >= static_cast<int64_t>(chunks) * kChunk) first_start = t0;
  }
  __syncthreads();
  int64_t tok = first_tok;
  int64_t base = first_start;
  // a round's tokens are loaded during the round before it
  int64_t i = tok + threadIdx.x;
  int next_len = i < nt ? L[i] : 0, next_dist = i < nt ? D[i] : 0, next_lit = i < nt ? C[i] : 0;
  while (base < t0 + n && tok < nt) {
    const int len = next_len > 0 ? next_len : 0;
    const int dist = len > 0 ? next_dist : 0;
    const int lit = len > 0 ? next_lit : 0;
    i += kThreads;
    next_len = i < nt ? L[i] : 0;
    next_dist = i < nt ? D[i] : 0;
    next_lit = i < nt ? C[i] : 0;
    int total;
    const int64_t start = base + block_exclusive_scan(len, warp_sum, &total);
    // the warp's 32 tokens cover [w_lo, w_hi): lanes take its bytes inside the tile
    const int64_t w_lo = __shfl_sync(0xffffffffu, start, 0);
    const int64_t w_hi = __shfl_sync(0xffffffffu, start + len, 31);
    const int64_t a = w_lo > t0 ? w_lo : t0;
    const int64_t e = w_hi < t0 + n ? w_hi : t0 + n;
    for (int64_t q0 = a; q0 < e; q0 += 32) {
      const int64_t q = q0 + lane;
      int owner = 0;  // the last lane whose token starts at or before q
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int cand = owner + step;
        const int64_t sc = __shfl_sync(0xffffffffu, start, cand & 31);
        if (cand < 32 && sc <= q) owner = cand;
      }
      const int d = __shfl_sync(0xffffffffu, dist, owner);
      const int v = __shfl_sync(0xffffffffu, lit, owner);
      if (q < e) {
        const int ql = static_cast<int>(q - t0);
        if (d > 0) {
          const int64_t src = q - d > 0 ? q - d : 0;
          const int64_t lp = src - t0;  // below -32,768 only outside the domain
          sp[ql] = static_cast<int16_t>(lp < -32768 ? -32768 : lp);
        } else {
          sp[ql] = static_cast<int16_t>(ql);
          val[ql] = static_cast<uint8_t>(v);
        }
      }
    }
    tok += kThreads;
    base += total;
  }
  __syncthreads();

  // 2. pointer doubling in shared memory; a negative pointer is a root
  // outside the tile, a self-pointer a literal
  for (;;) {
    bool moved = false;
    for (int q = threadIdx.x; q < n; q += kThreads) {
      const int p = sp[q];
      if (p >= 0 && p != q) {
        const int p2 = sp[p];
        if (p2 != p) {
          sp[q] = p2;
          moved = true;
        }
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  // 3. literal-rooted bytes now; note the roots outside the tile
  int lo = 0x7fffffff, cnt = 0;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int p = sp[q];
    if (p >= 0) {
      o[t0 + q] = val[p];
    } else {
      lo = min(lo, p);
      ++cnt;
    }
  }
  if (cnt) {
    atomicMin(&lo_root, lo);
    atomicAdd(&n_cross, cnt);
  }
  __syncthreads();

  // 4. roots before the tile: wait until the tiles holding them are
  // written, then read them through L2, kBatch loads in flight a thread
  // at a time, each landing in a register of its own (a load whose
  // register is copied or spilled before it lands holds the thread)
  if (n_cross) {
    if (threadIdx.x == 0) {
      const int64_t first = (t0 + lo_root) / T;
      for (int64_t j = first; j < k; ++j) {
        const int* f = &s.flag[static_cast<int64_t>(b) * tiles + j];
        for (unsigned polls = 0; ld_acquire(f) == 0; spin_guard(polls)) {
        }
      }
      __threadfence();
    }
    __syncthreads();
    constexpr int kBatch = T / kThreads < 16 ? T / kThreads : 16;
#pragma unroll 1
    for (int j0 = 0; j0 < T / kThreads; j0 += kBatch) {
      uint32_t got[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = threadIdx.x + (j0 + j) * kThreads;
        const int p = q < n ? sp[q] : 0;
        got[j] = p < 0 ? __ldcg(o + t0 + p) : 0;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = threadIdx.x + (j0 + j) * kThreads;
        if (q < n && sp[q] < 0) o[t0 + q] = static_cast<uint8_t>(got[j]);
      }
    }
  }
  __syncthreads();  // every thread's bytes, then (cumulative) thread 0's fence
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(&s.flag[slot], 1);
  }
}

}  // namespace

// lens, dists int32 and lits u8 [B, nt] with row stride ts (elements);
// scratch int32 [1 + B * (tiles + chunks)] (ops/inflate.py scratch_words):
// a ticket, a flag a tile, a sum a chunk; out u8 [B, per]; tile in {8192,
// 16384, 32768}.
extern "C" int zpix_inflate_resolve(const void* lens, const void* dists, const void* lits,
                                    int64_t ts, int64_t nt, void* scratch, void* out,
                                    int64_t batch, int64_t per, int tile, void* stream) {
  if (tile != 8192 && tile != 16384 && tile != 32768) return cudaErrorInvalidValue;
  if (batch <= 0 || per <= 0 || nt <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>((nt + kChunk - 1) / kChunk);
  const int tiles = static_cast<int>((per + tile - 1) / tile);
  int* w = static_cast<int*>(scratch);
  const Scratch s{w, w + 1, w + 1 + batch * tiles};
  cudaError_t err = cudaMemsetAsync(w, 0, 4 * (1 + batch * tiles), st);
  if (err != cudaSuccess) return err;
  const auto* l = static_cast<const int32_t*>(lens);
  sums_kernel<<<dim3(chunks, static_cast<unsigned>(batch)), kSumThreads, 0, st>>>(
      l, ts, nt, chunks, s.chunk_sum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto go = [&](auto tile_const) {
    constexpr int T = decltype(tile_const)::value;
    constexpr int smem = T * 2 + T;  // int16 pointers, literal bytes
    cudaError_t e = cudaFuncSetAttribute(resolve_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    resolve_kernel<T><<<static_cast<unsigned>(batch) * tiles, kThreads, smem, st>>>(
        l, static_cast<const int32_t*>(dists), static_cast<const uint8_t*>(lits), ts, nt,
        static_cast<uint8_t*>(out), static_cast<int>(batch), per, tiles, chunks, s);
    return cudaGetLastError();
  };
  if (tile == 8192) return go(std::integral_constant<int, 8192>{});
  if (tile == 16384) return go(std::integral_constant<int, 16384>{});
  return go(std::integral_constant<int, 32768>{});
}
