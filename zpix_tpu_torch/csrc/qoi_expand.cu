// K12 (QOI lane expansion) and K13 (QOI sorted expansion): a batch's host
// records -> RGBA8 pixels.
//
// K12 replaces zpix_tpu/parallel/qoi_batch.py::build_qoi_lane_expand_fn
// (:1174).  The raster of each image is cut into P-pixel lanes; row i of
// the lane-major entry arrays [Lt, R] is lane i % n_lanes of image
// i / n_lanes, so its P pixels land at i * P + p of the batch's pixels.
// The function is the masked sum
//     out[i, p] = sum_r col[i, r] * (s[i, r] <= p < e[i, r])   (uint32, wrapping)
// on ANY entry set: overlapping entries add, a gap gives 0.  Two formats:
//   wide: col u32, s and e int16, three arrays [Lt, R];
//   p4:   one [Lt, R * 4] u8 array of (r, g, b, start) granules: col is
//         r<<24 | g<<16 | b<<8 | 0xFF, e[r] = s[r + 1] and the last slot
//         ends at P (pad slots carry s = P, so they cover nothing).
// The sum is taken as a difference array: each entry slot adds its colour
// at lo = max(s, 0) and subtracts it at hi = min(e, P) when lo < hi, and
// an inclusive scan of the lane's P words gives out exactly -- the sum is
// mod 2^32, where addition commutes, so the order of the shared atomics
// does not matter (overlaps, s >= e, spans outside [0, P), non-monotone p4
// starts and all-pad lanes included).  O(P + R) a lane, not O(P * R).
// A CTA of 256 threads takes kWin / P consecutive lanes (P <= kWin), whose
// pixels are one contiguous span of the output, or one lane of P > kWin
// pixels walked in windows of kWin words with the scan's last value
// carried from one window to the next.  For each window: the difference
// words are zeroed in shared memory; a thread an entry slot reads its slot
// (coalesced: a p4 granule is one 4-byte load, its implicit end the start
// the next thread read, by __shfl_down_sync) and adds the ends that fall in
// the window with shared atomics -- a lane's subtract at hi = P lands on
// the next lane's pixel 0, so one scan over the CTA's whole span restarts
// at every lane; the CTA scans the window (16 words a thread, then the
// warps' sums), byte-swaps the packed 0xRRGGBBAA sums to the bytes R, G,
// B, A, and writes the span with 16-byte stores (P % 4 == 0 and an aligned
// output, picked at launch; word stores otherwise).  A slot's lane and
// place in it come from a multiply-high by 2^32 / R (one correction step),
// no division.  Bound on the H100: bytes (entries in, 4 bytes a pixel out).
//
// K13 replaces qoi_batch.py::build_qoi_expand_fn (:818): per-image run-
// length records, cols u32 [B, rcap] (0xRRGGBBAA) and cnts u8 [B, rcap]
// (zero past each image's records), and fill u32 [B].  Pixel p of image
// b takes cols[b, op] with op = the number of inclusive prefix sums of
// cnts that are <= p (searchsorted side "right"), clipped to rcap - 1;
// pixels at or past the image's total take fill[b].  Two kernels, no
// scratch but a tile sum a tile: the sums of tiles of records, then a CTA
// a tile that puts its counts and colours into shared memory (cp.async),
// adds the sums of the tiles before it for its pixel offset (no wait on
// another CTA: the decoupled look-back of a one-pass design cost more than
// the second read of the counts, PERF.md, K13), scans its counts and
// writes its pixels with 16-byte stores, each pixel's record found in the
// tile's prefix in shared memory; then fill tiles for the pixels past each
// image's total (sorted_expand_kernel below).  Bound on the H100: bytes
// (5 bytes a record in, 4 a pixel out; the counts are read twice, the
// second time mostly from L2: no prefix array in device memory, no search
// outside the tile).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "timing.cuh"

namespace {

constexpr int kExpandThreads = 256;
constexpr int kWin = 4096;                      // pixel words a CTA scans at a time
constexpr int kScanWords = kWin / kExpandThreads;  // words a thread scans
constexpr int kSlotUnroll = 4;                  // entry slots a thread loads before it adds
constexpr unsigned kFullMask = 0xffffffffu;

// The window in shared memory takes a pad of 4 words after every 32, so
// that a thread's 16 words (the scan) and a warp's 16-byte copies are free
// of bank conflicts.
constexpr int kWinSmem = kWin + kWin / 32 * 4;
__device__ __forceinline__ int win_at(int w) { return w + ((w >> 5) << 2); }

__device__ __forceinline__ uint32_t rgba_bytes(uint32_t packed) {
  return __byte_perm(packed, 0, 0x0123);  // 0xRRGGBBAA -> bytes R, G, B, A
}

struct LaneArgs {
  const uint32_t* cols;
  const int16_t* s;
  const int16_t* e;
  const uint32_t* p4;
  uint32_t* out;
  int64_t n_lanes;
  int R, P, lpc;    // entry slots a lane, pixels a lane, lanes a CTA
  uint32_t rmagic;  // floor(2^32 / R) (2^32 - 1 for R = 1)
};

template <bool kP4, bool kVecOut>
__global__ void __launch_bounds__(kExpandThreads)
lane_expand_kernel(const LaneArgs a) {
  __shared__ __align__(16) uint32_t s_d[kWinSmem];
  __shared__ uint32_t s_warp[kExpandThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, P = a.P;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * a.lpc;
  const int nl = a.n_lanes - lane0 < a.lpc ? static_cast<int>(a.n_lanes - lane0) : a.lpc;
  const int span = nl * P;                                 // the CTA's pixels
  const uint32_t n = static_cast<uint32_t>(nl) * R;        // and entry slots
  const int64_t slot0 = lane0 * R;
  uint32_t* const dst = a.out + lane0 * P;
  uint32_t carry = 0;
  for (int w0 = 0; w0 < span; w0 += kWin) {
    const int wlen = min(kWin, span - w0);
    for (int i = tid; i < kWinSmem / 4; i += kExpandThreads)
      reinterpret_cast<uint4*>(s_d)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();

    // every slot's ends that fall in [w0, w0 + wlen)
    for (uint32_t k0 = 0; k0 < n; k0 += kExpandThreads * kSlotUnroll) {
      uint32_t word[kSlotUnroll] = {}, col[kSlotUnroll] = {};
      int st[kSlotUnroll] = {}, en[kSlotUnroll] = {};
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) {
        const uint32_t k = k0 + u * kExpandThreads + tid;
        if (k < n) {
          if (kP4) {
            word[u] = __ldg(a.p4 + slot0 + k);  // bytes r, g, b, start
          } else {
            col[u] = __ldg(a.cols + slot0 + k);
            st[u] = __ldg(a.s + slot0 + k);
            en[u] = __ldg(a.e + slot0 + k);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u) {
        const uint32_t k = k0 + u * kExpandThreads + tid;
        uint32_t q = __umulhi(k, a.rmagic), r = k - q * R;  // k / R, k % R
        if (r >= static_cast<uint32_t>(R)) {
          ++q;
          r -= R;
        }
        if (kP4) {
          st[u] = static_cast<int>(word[u] >> 24);
          col[u] = (rgba_bytes(word[u]) & 0xFFFFFF00u) | 0xFFu;
          // the end: the next slot's start (the next thread's, or a load
          // at the warp's edge), P after a lane's last slot
          const int next = __shfl_down_sync(kFullMask, st[u], 1);
          en[u] = P;
          if (k < n && r + 1 < static_cast<uint32_t>(R))
            en[u] = lane < 31 ? next : static_cast<int>(__ldg(a.p4 + slot0 + k + 1) >> 24);
        }
        const int lo = max(st[u], 0), hi = min(en[u], P);
        if (k < n && lo < hi) {
          const int at = static_cast<int>(q) * P - w0;  // the lane's pixel 0, window-relative
          if (at + lo >= 0 && at + lo < wlen) atomicAdd(s_d + win_at(at + lo), col[u]);
          if (at + hi >= 0 && at + hi < wlen) atomicSub(s_d + win_at(at + hi), col[u]);
        }
      }
    }
    __syncthreads();

    // the inclusive scan of the window, 16 words a thread
    uint32_t x[kScanWords];
    uint4* mine = reinterpret_cast<uint4*>(s_d + win_at(tid * kScanWords));
#pragma unroll
    for (int i = 0; i < kScanWords / 4; ++i) {
      const uint4 v = mine[i];
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int i = 1; i < kScanWords; ++i) x[i] += x[i - 1];
    const uint32_t tot = x[kScanWords - 1];
    uint32_t inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t u = __shfl_up_sync(kFullMask, inc, d);
      if (lane >= d) inc += u;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    uint32_t before = carry + inc - tot;
#pragma unroll
    for (int w = 0; w < kExpandThreads / 32; ++w) {
      const uint32_t t = s_warp[w];
      before += w < warp ? t : 0;
      carry += t;
    }
#pragma unroll
    for (int i = 0; i < kScanWords / 4; ++i) {
      mine[i] = make_uint4(rgba_bytes(x[4 * i] + before), rgba_bytes(x[4 * i + 1] + before),
                           rgba_bytes(x[4 * i + 2] + before), rgba_bytes(x[4 * i + 3] + before));
    }
    __syncthreads();

    // the window's pixels out: 16-byte stores where kVecOut (wlen % 4 == 0
    // and dst + w0 16-byte aligned)
    if (kVecOut) {
      for (int i = tid; i < wlen / 4; i += kExpandThreads)
        reinterpret_cast<uint4*>(dst + w0)[i] = *reinterpret_cast<const uint4*>(s_d + win_at(4 * i));
    } else {
      for (int i = tid; i < wlen; i += kExpandThreads) dst[w0 + i] = s_d[win_at(i)];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- K13

// Records a tile: 1024, 2048 or 4096, chosen by the caller
// (ops/qoi.py::rec_tile, from the sweep in PERF.md): a tile's pixels are
// written by its own CTA, so run-heavy records take small tiles.
constexpr int kRecThreads = 256;
constexpr int kSumTiles = kRecThreads / 32;  // tiles a CTA of tile_sums_kernel, a warp each
constexpr int kFillPx = 65536;               // pixels a fill tile
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a tile: its colours, the inclusive prefix of
// its counts (tile-local, a pad word after every 32 so that a thread's
// run of stores is free of bank conflicts), its counts.
__host__ __device__ constexpr int inc_words(int tile) { return tile + tile / 32; }
__host__ __device__ constexpr int rec_smem(int tile) {
  return 4 * tile + 4 * inc_words(tile) + tile;
}

__device__ __forceinline__ int inc_at(int j) { return j + (j >> 5); }
__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>  // until at most kPending groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The sum over the CTA of one value a thread (s_warp: kRecThreads / 32
// words of shared memory); every thread gets it.
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* s_warp) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t t = 0;
#pragma unroll
  for (int w = 0; w < kRecThreads / 32; ++w) t += s_warp[w];
  return t;
}

// The sum of tile_sum[0, n) (one image's tiles), over the CTA.
__device__ __forceinline__ int64_t tiles_before(const int32_t* tile_sum, int n, int64_t* s_warp) {
  int64_t v = 0;
  for (int i = threadIdx.x; i < n; i += kRecThreads) v += __ldg(tile_sum + i);
  return block_sum(v, s_warp);
}

// Pixels [lo, hi) of one image's output row: each value from ``px(p)``,
// 16-byte stores where a 4-pixel group lies wholly inside (kVecOut: the
// row is 16-byte aligned and npx % 4 == 0), word stores at the ends.
template <bool kVecOut, typename Px>
__device__ __forceinline__ void write_span(uint32_t* row, int64_t lo, int64_t hi, Px px) {
  if (kVecOut) {
    for (int64_t g = (lo >> 2) + threadIdx.x; g < (hi + 3) >> 2; g += blockDim.x) {
      const int64_t p0 = g << 2;
      if (p0 >= lo && p0 + 4 <= hi) {
        uint4 v;
        v.x = px(p0);
        v.y = px(p0 + 1);
        v.z = px(p0 + 2);
        v.w = px(p0 + 3);
        *reinterpret_cast<uint4*>(row + p0) = v;
      } else {
        for (int64_t p = lmax(p0, lo); p < lmin(p0 + 4, hi); ++p) row[p] = px(p);
      }
    }
  } else {
    for (int64_t p = lo + threadIdx.x; p < hi; p += blockDim.x) row[p] = px(p);
  }
}

// K13, step 1: the sum of each tile's counts, a warp a tile (16-byte
// loads where kVecIn), into tile_sum [B, tpi].
template <int kRecTile, bool kVecIn>
__global__ void __launch_bounds__(kRecThreads)
tile_sums_kernel(const uint8_t* __restrict__ cnts, int32_t* __restrict__ tile_sum,
                 int64_t tiles, int tpi, int64_t rcap) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kSumTiles + (threadIdx.x >> 5);
  if (t >= tiles) return;
  const int64_t b = t / tpi, r0 = (t - b * tpi) * kRecTile;
  const int n = static_cast<int>(lmin(kRecTile, rcap - r0));
  const uint8_t* cg = cnts + b * rcap + r0;
  unsigned v = 0;
  if (kVecIn) {  // n is a multiple of 16
    for (int i = lane; i < n / 16; i += 32) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(cg) + i);
      v = __dp4a(x.x, 0x01010101u, v);
      v = __dp4a(x.y, 0x01010101u, v);
      v = __dp4a(x.z, 0x01010101u, v);
      v = __dp4a(x.w, 0x01010101u, v);
    }
  } else {
    for (int i = lane; i < n; i += 32) v += cg[i];
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  if (lane == 0) tile_sum[t] = static_cast<int32_t>(v);
}

// K13, step 2.  CTAs [0, B * tpi) are record tiles (CTA = image * tpi +
// tile), the rest fill tiles (CTA - B * tpi = image * F + f, the pixels
// [f * kFillPx, (f + 1) * kFillPx) of the image).  A record tile puts its
// counts and colours on their way (cp.async, two groups), sums the tile
// sums before it for its pixel offset (no wait on another CTA), scans its
// counts in shared memory, and writes its pixels [off, off + sum)
// clipped to npx: a thread a 4-pixel group, the record of a pixel by a
// search of the tile's prefix (the next record first, then a binary
// search: zero counts are skipped as searchsorted skips them).  A fill
// tile sums all of its image's tile sums (the total) and writes fill
// over its pixels at or past it.
template <int kRecTile, bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kRecThreads)
sorted_expand_kernel(const uint32_t* __restrict__ cols, const uint8_t* __restrict__ cnts,
                     const uint32_t* __restrict__ fill, const int32_t* __restrict__ tile_sum,
                     uint32_t* __restrict__ out, int B, int64_t rcap, int tpi, int64_t npx,
                     int fpi) {
  constexpr int kRecItems = kRecTile / kRecThreads;  // counts a thread scans
  static_assert(kRecItems % 4 == 0 && (kRecTile & (kRecTile - 1)) == 0, "tile");
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_inc = reinterpret_cast<int32_t*>(smem + 4 * kRecTile);
  uint8_t* s_cnt = smem + 4 * kRecTile + 4 * inc_words(kRecTile);
  __shared__ int64_t s_warp[kRecThreads / 32];
  __shared__ int32_t s_scan[kRecThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n_rec = static_cast<int64_t>(B) * tpi;

  if (blockIdx.x >= n_rec) {  // a fill tile
    const int64_t f = blockIdx.x - n_rec;
    const int64_t b = f / fpi;
    const int64_t lo = (f - b * fpi) * kFillPx, hi = lmin(lo + kFillPx, npx);
    const int64_t total = tiles_before(tile_sum + b * tpi, tpi, s_warp);
    const uint32_t v = rgba_bytes(fill[b]);
    write_span<kVecOut>(out + b * npx, lmax(lo, total), hi, [v](int64_t) { return v; });
    return;
  }

  const int64_t b = blockIdx.x / tpi;
  const int ti = static_cast<int>(blockIdx.x - b * tpi);
  const int64_t r0 = static_cast<int64_t>(ti) * kRecTile;
  const int n = static_cast<int>(lmin(kRecTile, rcap - r0));
  const uint8_t* cg = cnts + b * rcap + r0;
  const uint32_t* colg = cols + b * rcap + r0;

  // the counts (zero past the records) and the colours on their way, the
  // offset meanwhile
  if (kVecIn) {  // n is a multiple of 16
    for (int i = tid; i < kRecTile / 16; i += kRecThreads) {
      if (16 * i < n) cp_async16(s_cnt + 16 * i, cg + 16 * i);
      else reinterpret_cast<uint4*>(s_cnt)[i] = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    for (int i = tid; i < n / 4; i += kRecThreads) cp_async16(s_col + 4 * i, colg + 4 * i);
    cp_async_commit();
  } else {
    for (int i = tid; i < kRecTile; i += kRecThreads) s_cnt[i] = i < n ? cg[i] : 0;
    for (int i = tid; i < n; i += kRecThreads) s_col[i] = colg[i];
  }
  const int64_t off = tiles_before(tile_sum + b * tpi, ti, s_warp);
  if (kVecIn) cp_async_wait<1>();
  __syncthreads();

  // a thread's kRecItems counts (16-byte reads where they fit), scanned
  uint32_t words[kRecItems / 4];
  if (kRecItems % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kRecItems / 16; ++k) {
      const uint4 x = reinterpret_cast<const uint4*>(s_cnt + tid * kRecItems)[k];
      words[4 * k] = x.x;
      words[4 * k + 1] = x.y;
      words[4 * k + 2] = x.z;
      words[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRecItems / 4; ++k)
      words[k] = reinterpret_cast<const uint32_t*>(s_cnt + tid * kRecItems)[k];
  }
  int32_t c[kRecItems], v = 0;
#pragma unroll
  for (int k = 0; k < kRecItems / 4; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v += (words[k] >> (8 * q)) & 0xFF;
      c[4 * k + q] = v;
    }
  }
  int32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int32_t before = incl - v, sum = 0;
#pragma unroll
  for (int w = 0; w < kRecThreads / 32; ++w) {
    const int32_t x = s_scan[w];
    before += w < warp ? x : 0;
    sum += x;
  }
#pragma unroll
  for (int k = 0; k < kRecItems; ++k) s_inc[inc_at(tid * kRecItems + k)] = before + c[k];
  if (kVecIn) cp_async_wait<0>();
  __syncthreads();

  // the pixels [off, off + sum) that lie inside the image
  const int64_t hi = lmin(off + sum, npx);
  if (off >= hi) return;
  // A thread's pixels come in increasing order, so the record of the last
  // one is where the next one's search starts.
  int j = 0;
  write_span<kVecOut>(out + b * npx, off, hi, [&](int64_t p) {
    const int32_t q = static_cast<int32_t>(p - off);
    if (s_inc[inc_at(j)] <= q) {
      if (j + 1 < kRecTile && s_inc[inc_at(j + 1)] > q) {
        ++j;
      } else {  // the number of prefix sums <= q (< kRecTile: q < sum)
        j = 0;
#pragma unroll
        for (int step = kRecTile / 2; step; step >>= 1) {
          if (s_inc[inc_at(j + step - 1)] <= q) j += step;
        }
      }
    }
    return rgba_bytes(s_col[j]);
  });
}

struct SortedArgs {
  const uint32_t* cols;
  const uint8_t* cnts;
  const uint32_t* fill;
  int32_t* tile_sum;
  uint32_t* out;
  int B, tpi, fpi;
  int64_t rcap, npx;
};

template <int kRecTile, bool kVecIn, bool kVecOut>
void launch_sorted(const SortedArgs& a, cudaStream_t st) {
  const int64_t tiles = static_cast<int64_t>(a.B) * a.tpi;
  tile_sums_kernel<kRecTile, kVecIn>
      <<<static_cast<unsigned>((tiles + kSumTiles - 1) / kSumTiles), kRecThreads, 0, st>>>(
          a.cnts, a.tile_sum, tiles, a.tpi, a.rcap);
  constexpr int kSmem = rec_smem(kRecTile);
  static_assert(kSmem <= 48 * 1024, "a tile's shared memory");
  const unsigned grid = static_cast<unsigned>(tiles + static_cast<int64_t>(a.B) * a.fpi);
  sorted_expand_kernel<kRecTile, kVecIn, kVecOut><<<grid, kRecThreads, kSmem, st>>>(
      a.cols, a.cnts, a.fill, a.tile_sum, a.out, a.B, a.rcap, a.tpi, a.npx, a.fpi);
}

template <int kRecTile>
void launch_sorted(const SortedArgs& a, bool vin, bool vout, cudaStream_t st) {
  if (vin) {
    if (vout) launch_sorted<kRecTile, true, true>(a, st);
    else launch_sorted<kRecTile, true, false>(a, st);
  } else {
    if (vout) launch_sorted<kRecTile, false, true>(a, st);
    else launch_sorted<kRecTile, false, false>(a, st);
  }
}

}  // namespace

// fmt 0 (wide): cols u32, s, e i16 [Lt, R]; fmt 1 (p4): p4 u8 [Lt, R * 4]
// (4-byte aligned).  out u8 [Lt * P * 4] (4-byte aligned).
extern "C" int zpix_qoi_lane_expand(const void* cols, const void* s, const void* e,
                                    const void* p4, void* out, int64_t n_lanes, int R, int P,
                                    int fmt, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (n_lanes > 0 && R > 0 && P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    LaneArgs a;
    a.cols = static_cast<const uint32_t*>(cols);
    a.s = static_cast<const int16_t*>(s);
    a.e = static_cast<const int16_t*>(e);
    a.p4 = static_cast<const uint32_t*>(p4);
    a.out = static_cast<uint32_t*>(out);
    a.n_lanes = n_lanes;
    a.R = R;
    a.P = P;
    // lanes a CTA: a window's worth, and few enough that a CTA's slots
    // count in 31 bits
    a.lpc = P <= kWin ? kWin / P : 1;
    a.lpc = static_cast<int>(std::min<int64_t>(a.lpc, ((int64_t{1} << 31) - 1) / R));
    a.rmagic = R == 1 ? 0xFFFFFFFFu : static_cast<uint32_t>((uint64_t{1} << 32) / R);
    const unsigned grid = static_cast<unsigned>((n_lanes + a.lpc - 1) / a.lpc);
    const bool vout = P % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (fmt) {
      if (vout) lane_expand_kernel<true, true><<<grid, kExpandThreads, 0, st>>>(a);
      else lane_expand_kernel<true, false><<<grid, kExpandThreads, 0, st>>>(a);
    } else {
      if (vout) lane_expand_kernel<false, true><<<grid, kExpandThreads, 0, st>>>(a);
      else lane_expand_kernel<false, false><<<grid, kExpandThreads, 0, st>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// cols u32 [B, rcap], cnts u8 [B, rcap], fill u32 [B]; out u8 [B, npx * 4];
// tile: records a tile (1024, 2048 or 4096); tile_sum: scratch of
// B * ceil(rcap / tile) int32 (ops/qoi.py::sorted_expand allocates it).
// Two kernels.
extern "C" int zpix_qoi_sorted_expand(const void* cols, const void* cnts, const void* fill,
                                      void* tile_sum, void* out, int64_t batch, int64_t rcap,
                                      int64_t npx, int tile, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (tile != 1024 && tile != 2048 && tile != 4096) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && rcap > 0 && npx > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    SortedArgs a;
    a.cols = static_cast<const uint32_t*>(cols);
    a.cnts = static_cast<const uint8_t*>(cnts);
    a.fill = static_cast<const uint32_t*>(fill);
    a.tile_sum = static_cast<int32_t*>(tile_sum);
    a.out = static_cast<uint32_t*>(out);
    a.B = static_cast<int>(batch);
    a.tpi = static_cast<int>((rcap + tile - 1) / tile);
    a.fpi = static_cast<int>((npx + kFillPx - 1) / kFillPx);
    a.rcap = rcap;
    a.npx = npx;
    const bool vin = reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cnts) % 16 == 0 && rcap % 16 == 0;
    const bool vout = reinterpret_cast<uintptr_t>(out) % 16 == 0 && npx % 4 == 0;
    if (tile == 1024) launch_sorted<1024>(a, vin, vout, st);
    else if (tile == 2048) launch_sorted<2048>(a, vin, vout, st);
    else launch_sorted<4096>(a, vin, vout, st);
  }
  return static_cast<int>(cudaGetLastError());
}
