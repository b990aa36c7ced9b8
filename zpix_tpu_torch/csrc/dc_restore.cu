// K3: DC predictor restore.
//
// Replaces zpix_tpu/parallel/device_entropy.py::_restore_dc_T_split
// (:836-851).  A component's predictor chain visits its blocks in (MCU,
// slot) order and restarts at every restart segment (T.81 F.2.1.3.1,
// decoder.zig:1366-1376), so the restored DC is the inclusive prefix sum
// of the diffs along each (segment, component) chain: a segmented scan of
// up to four interleaved chains over MCUs of bpm slots, a segment every
// seg_mcus MCUs.  Adds are uint32: addition mod 2^32 is associative, so
// any order gives the int32-wrapping sums of numpy and XLA exactly.
//
// Design (Hopper).  One kernel for every chain length (the short chains
// of DRI 8 and the whole-image chains of restart-free streams).  A CTA of
// kTile threads takes a tile of kTile whole MCUs, a thread each:
// - the tile's diffs arrive in shared memory by 16-byte cp.async, every
//   copy started before any add;
// - a thread sums each chain over its MCU: each component's slots are a
//   contiguous run [s0[c], s0[c] + nb[c]) of the MCU (a small table, no
//   division an element), and the MCU starts a segment where its index
//   is a multiple of seg_mcus (one division a thread);
// - the threads' (reset flag, four sums) are scanned by warp shuffles and
//   across the warps in shared memory, a segmented scan;
// - a tile that does not start a segment takes each chain's carry by
//   decoupled look-back over the earlier tiles (lookback.cuh; warp c for
//   chain c, the chains in parallel); a tile holding a segment start
//   publishes its chains' inclusive sums at once, so no look-back passes
//   a restart.  The words and the ticket live in a scratch kept between
//   calls, each launch its own epoch (no memset).  When every tile starts
//   a segment (kTile a multiple of seg_mcus, as at DRI 8) there is no
//   look-back and no ticket;
// - the sums overwrite the staged diffs and leave as 16-byte stores.
// Bound on the H100: bytes, 4 read and 4 written a block.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace {

namespace lb = zpix_lookback;

constexpr int kTile = 128;  // MCUs a CTA, a thread each (ops/entropy.py: K3_TILE_MCUS)
constexpr int kWarps = kTile / 32;
constexpr int kMaxComps = 4;

struct Geo {
  int64_t n;      // diffs: MCUs * bpm
  int64_t n_mcu;  // MCUs, every segment's
  int seg_mcus, bpm, ncomp;
  int s0[kMaxComps], nb[kMaxComps];  // each component's first slot and slot count
};

__device__ __forceinline__ uint32_t pick(const uint32_t (&x)[kMaxComps], int c) {
  return c == 0 ? x[0] : c == 1 ? x[1] : c == 2 ? x[2] : x[3];
}

// ``scratch`` null: every tile starts a segment (tile = blockIdx.x); else
// tiles by ticket, scratch word 0 the ticket counter and word 1 + tile *
// kMaxComps + c chain c's look-back word at ``epoch``.
__global__ void __launch_bounds__(kTile)
dc_restore_kernel(const int32_t* __restrict__ dc, int32_t* __restrict__ out, Geo G,
                  uint64_t* scratch, int64_t tiles, uint32_t epoch, bool vec) {
  extern __shared__ __align__(16) uint32_t s[];
  __shared__ uint32_t wsum[kWarps][kMaxComps];
  __shared__ int wflag[kWarps];
  __shared__ uint32_t carry[kMaxComps];
  __shared__ int64_t ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t tile = blockIdx.x;
  if (scratch != nullptr) {
    if (tid == 0) ticket = lb::take_ticket(reinterpret_cast<uint32_t*>(scratch), tiles);
    __syncthreads();
    tile = ticket;
  }
  const int64_t m0 = tile * kTile, e0 = m0 * G.bpm;
  const int n = static_cast<int>(min(static_cast<int64_t>(kTile) * G.bpm, G.n - e0));

  // stage the tile's diffs: every copy started before any add
  int i0 = 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += kTile) lb::cp_async16(s + 4 * i, dc + e0 + 4 * i);
    i0 = 4 * n4;
  }
  for (int i = i0 + tid; i < n; i += kTile) s[i] = static_cast<uint32_t>(__ldg(dc + e0 + i));
  lb::cp_async_wait_all();
  __syncthreads();

  // the thread's MCU: each chain's sum, and whether it starts a segment
  const int64_t mi = m0 + tid;
  const bool live = mi < G.n_mcu;
  const int start = live && mi % G.seg_mcus == 0;
  uint32_t* const mcu = s + tid * G.bpm;
  uint32_t x[kMaxComps] = {0u, 0u, 0u, 0u};
  int f = start;
  if (live) {
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c)
      if (c < G.ncomp)
        for (int j = 0; j < G.nb[c]; ++j) x[c] += mcu[G.s0[c] + j];
  }

  // segmented scan over the warp's lanes: (reset flag, sums)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(lb::kFull, f, d);
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      const uint32_t y = __shfl_up_sync(lb::kFull, x[c], d);
      if (lane >= d && !f) x[c] += y;
    }
    if (lane >= d) f |= of;
  }
  int fe = __shfl_up_sync(lb::kFull, f, 1);  // the lanes before this one
  uint32_t xe[kMaxComps];
#pragma unroll
  for (int c = 0; c < kMaxComps; ++c) xe[c] = __shfl_up_sync(lb::kFull, x[c], 1);
  if (lane == 0) {
    fe = 0;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) xe[c] = 0u;
  }
  if (lane == 31) {
    wflag[warp] = f;
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) wsum[warp][c] = x[c];
  }
  __syncthreads();
  // the warps before this one, and the whole tile
  int fw = 0, ft = 0;
  uint32_t xw[kMaxComps] = {0u, 0u, 0u, 0u}, xt[kMaxComps] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      fw = ft;
#pragma unroll
      for (int c = 0; c < kMaxComps; ++c) xw[c] = xt[c];
    }
    const int g = wflag[w];
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) xt[c] = g ? wsum[w][c] : xt[c] + wsum[w][c];
    ft |= g;
  }

  // each chain's carry into the tile
  if (scratch == nullptr) {
    if (tid < kMaxComps) carry[tid] = 0u;
  } else if (warp < G.ncomp) {
    uint64_t* const words = scratch + 1;
    uint64_t* mine = words + tile * kMaxComps + warp;
    const uint32_t total = pick(xt, warp);
    if (lane == 0) lb::publish(mine, ft ? lb::kInclusive : lb::kAggregate, total, epoch);
    const uint32_t in =
        m0 % G.seg_mcus ? lb::carry_in(words + warp, tile, kMaxComps, epoch) : 0u;
    if (lane == 0) {
      if (!ft) lb::publish(mine, lb::kInclusive, in + total, epoch);
      carry[warp] = in;
    }
  }
  __syncthreads();

  // the restored values over the staged diffs, then out
  if (live) {
#pragma unroll
    for (int c = 0; c < kMaxComps; ++c) {
      if (c >= G.ncomp) continue;
      uint32_t acc = carry[c];
      acc = fw ? xw[c] : acc + xw[c];
      acc = fe ? xe[c] : acc + xe[c];
      if (start) acc = 0u;
      for (int j = 0; j < G.nb[c]; ++j) {
        acc += mcu[G.s0[c] + j];
        mcu[G.s0[c] + j] = acc;
      }
    }
  }
  __syncthreads();
  i0 = 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += kTile)
      reinterpret_cast<uint4*>(out + e0)[i] = reinterpret_cast<const uint4*>(s)[i];
    i0 = 4 * n4;
  }
  for (int i = i0 + tid; i < n; i += kTile) out[e0 + i] = static_cast<int32_t>(s[i]);
}

}  // namespace

// ``n`` diffs in segments of seg_mcus MCUs of bpm slots, component c the
// nb[c] slots after the earlier ones'.  Unless kTile is a multiple of
// seg_mcus, ``scratch`` holds ``scratch_words`` uint64, at least
// ceil(n / bpm / kTile) * 4 + 1 (the ticket counter and the tiles'
// words), its word 0 0 and no word set at ``epoch`` (1 .. 2^30 - 1);
// else it may be null.
extern "C" int zpix_dc_restore(const void* dc, void* out, void* scratch, int64_t scratch_words,
                               int epoch, int64_t n, int seg_mcus, int bpm, int ncomp, int nb0,
                               int nb1, int nb2, int nb3, void* stream) {
  const int nbs[kMaxComps] = {nb0, nb1, nb2, nb3};
  if (ncomp < 1 || ncomp > kMaxComps || bpm < 1 || seg_mcus < 1 || n % bpm ||
      (n / bpm) % seg_mcus)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo G;
  G.n = n, G.n_mcu = n / bpm, G.seg_mcus = seg_mcus, G.bpm = bpm, G.ncomp = ncomp;
  int s0 = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    G.s0[c] = s0;
    G.nb[c] = c < ncomp ? nbs[c] : 0;
    s0 += G.nb[c];
  }
  if (s0 != bpm) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles = (G.n_mcu + kTile - 1) / kTile;
  uint64_t* words = nullptr;
  if (kTile % seg_mcus) {
    if (scratch == nullptr || scratch_words < tiles * kMaxComps + 1 || epoch < 1 ||
        static_cast<uint32_t>(epoch) > lb::kEpochMask)
      return static_cast<int>(cudaErrorInvalidValue);
    words = static_cast<uint64_t*>(scratch);
  }
  const bool vec = reinterpret_cast<uintptr_t>(dc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t smem = static_cast<size_t>(kTile) * bpm * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dc_restore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dc_restore_kernel<<<static_cast<unsigned>(tiles), kTile, smem,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(dc),
                                                           static_cast<int32_t*>(out), G, words,
                                                           tiles, static_cast<uint32_t>(epoch),
                                                           vec);
  return static_cast<int>(cudaGetLastError());
}
