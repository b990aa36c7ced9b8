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
// A CUDA block takes 256 / P lanes (one lane when P > 256), stages their
// entries in shared memory (in chunks when they do not fit) and gives one
// thread each output pixel, which loops over its lane's R entries: no
// assumption that entries tile the lane.  The packed 0xRRGGBBAA sum is
// stored as the bytes R, G, B, A (a byte swap of the little-endian word).
// Bound on the H100: bytes (entries in, 4 bytes a pixel out) on dense-op
// content with small R; operations (R compares and adds a pixel) where R
// is large (run-heavy content at a large P).
//
// K13 replaces qoi_batch.py::build_qoi_expand_fn (:818): per-image run-
// length records, cols u32 [B, rcap] (0xRRGGBBAA) and cnts u8 [B, rcap]
// (zero past each image's records), and fill u32 [B].  Pixel p of image
// b takes cols[b, op] with op = the number of inclusive prefix sums of
// cnts that are <= p (searchsorted side "right"), clipped to rcap - 1;
// pixels at or past the image's total take fill[b].  Four kernels: the
// per-tile sums of the counts, a per-image scan of the tile sums, the
// per-tile scan that writes the inclusive prefix sums (int32 scratch the
// wrapper owns), and a thread per pixel that binary-searches them.  Zero
// counts give repeated prefix sums, which the search skips exactly as
// searchsorted does.  Bound on the H100: bytes (5 bytes a record in, 4 a
// pixel out); the search reads the prefix sums from L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kExpandThreads = 256;
constexpr int kStage = 2048;  // entries staged at a time per CUDA block

__device__ __forceinline__ uint32_t rgba_bytes(uint32_t packed) {
  return __byte_perm(packed, 0, 0x0123);  // 0xRRGGBBAA -> bytes R, G, B, A
}

template <bool kP4>
__global__ void lane_expand_kernel(const uint32_t* __restrict__ cols,
                                   const int16_t* __restrict__ s_arr,
                                   const int16_t* __restrict__ e_arr,
                                   const uint32_t* __restrict__ p4,
                                   uint32_t* __restrict__ out, int64_t n_lanes, int R,
                                   int P, int lpb) {
  __shared__ uint32_t s_col[kStage];
  __shared__ int32_t s_s[kStage], s_e[kStage];
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * lpb;
  const int nl = n_lanes - lane0 < lpb ? static_cast<int>(n_lanes - lane0) : lpb;
  const int chunk = kStage / lpb;  // entries a lane per stage
  const bool small = P <= static_cast<int>(blockDim.x);
  const int ll = small ? threadIdx.x / P : 0;
  const int step = small ? P : blockDim.x;
  for (int p0 = 0; p0 < P; p0 += step) {
    const int p = p0 + (small ? threadIdx.x % P : threadIdx.x);
    const bool active = ll < nl && p < P;
    uint32_t acc = 0;
    for (int r0 = 0; r0 < R; r0 += chunk) {
      const int rc = min(chunk, R - r0);
      __syncthreads();
      for (int k = threadIdx.x; k < nl * rc; k += blockDim.x) {
        const int l = k / rc, r = r0 + k % rc;
        const int64_t at = (lane0 + l) * R + r;
        const int slot = l * chunk + k % rc;
        if (kP4) {
          const uint32_t w = p4[at];  // bytes r, g, b, start
          s_col[slot] = (__byte_perm(w, 0, 0x0123) & 0xFFFFFF00u) | 0xFFu;
          s_s[slot] = static_cast<int32_t>(w >> 24);
          s_e[slot] = r + 1 < R ? static_cast<int32_t>(p4[at + 1] >> 24) : P;
        } else {
          s_col[slot] = cols[at];
          s_s[slot] = s_arr[at];
          s_e[slot] = e_arr[at];
        }
      }
      __syncthreads();
      if (active) {
        const int base = ll * chunk;
        for (int j = 0; j < rc; ++j) {
          if (s_s[base + j] <= p && p < s_e[base + j]) acc += s_col[base + j];
        }
      }
    }
    if (active) out[(lane0 + ll) * P + p] = rgba_bytes(acc);
  }
}

constexpr int kScanThreads = 1024;
constexpr int kItems = 4;
constexpr int kTile = kScanThreads * kItems;  // counts a tile

// Block-wide exclusive scan of one value a thread; *block_total gets the sum.
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
    int32_t t = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
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

// grid (tiles, B): the sum of each tile's counts.
__global__ void tile_sums_kernel(const uint8_t* __restrict__ cnts,
                                 int32_t* __restrict__ tile_sum, int64_t rcap, int tiles) {
  __shared__ int32_t warp_sum[32];
  const int64_t b = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int32_t v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < rcap) v += cnts[b * rcap + i0 + k];
  }
  int32_t total;
  block_exclusive_scan(v, warp_sum, &total);
  if (threadIdx.x == 0) tile_sum[b * tiles + blockIdx.x] = total;
}

// grid B: tile sums -> exclusive tile offsets in place; total[b] = the sum.
__global__ void tile_offsets_kernel(int32_t* __restrict__ tile_sum,
                                    int32_t* __restrict__ total, int tiles) {
  __shared__ int32_t warp_sum[32];
  int32_t* ts = tile_sum + static_cast<int64_t>(blockIdx.x) * tiles;
  int32_t carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t v = i < tiles ? ts[i] : 0;
    int32_t sum;
    const int32_t before = block_exclusive_scan(v, warp_sum, &sum);
    if (i < tiles) ts[i] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) total[blockIdx.x] = carry;
}

// grid (tiles, B): the inclusive prefix sums of the counts.
__global__ void tile_scan_kernel(const uint8_t* __restrict__ cnts,
                                 const int32_t* __restrict__ tile_off,
                                 int32_t* __restrict__ cum, int64_t rcap, int tiles) {
  __shared__ int32_t warp_sum[32];
  const int64_t b = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int32_t c[kItems], v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    c[k] = i0 + k < rcap ? cnts[b * rcap + i0 + k] : 0;
    v += c[k];
  }
  int32_t total;
  int32_t run = tile_off[b * tiles + blockIdx.x] + block_exclusive_scan(v, warp_sum, &total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += c[k];
    if (i0 + k < rcap) cum[b * rcap + i0 + k] = run;
  }
}

// a thread per pixel: searchsorted(cum[b], p, side="right"), gather, tail fill
__global__ void sorted_expand_kernel(const uint32_t* __restrict__ cols,
                                     const int32_t* __restrict__ cum,
                                     const int32_t* __restrict__ total,
                                     const uint32_t* __restrict__ fill,
                                     uint32_t* __restrict__ out, int64_t batch, int64_t npx,
                                     int64_t rcap) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= batch * npx) return;
  const int64_t b = t / npx;
  const int32_t p = static_cast<int32_t>(t - b * npx);
  const int32_t* c = cum + b * rcap;
  int64_t lo = 0, hi = rcap;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (c[mid] <= p) lo = mid + 1; else hi = mid;
  }
  const int64_t op = lo < rcap ? lo : rcap - 1;
  out[t] = rgba_bytes(p < total[b] ? cols[b * rcap + op] : fill[b]);
}

}  // namespace

// fmt 0 (wide): cols u32, s, e i16 [Lt, R]; fmt 1 (p4): p4 u8 [Lt, R * 4]
// (4-byte aligned).  out u8 [Lt * P * 4].
extern "C" int zpix_qoi_lane_expand(const void* cols, const void* s, const void* e,
                                    const void* p4, void* out, int64_t n_lanes, int R, int P,
                                    int fmt, void* stream) {
  if (n_lanes > 0 && R > 0 && P > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int lpb = P <= kExpandThreads ? kExpandThreads / P : 1;
    const int threads = P <= kExpandThreads ? lpb * P : kExpandThreads;
    const unsigned grid = static_cast<unsigned>((n_lanes + lpb - 1) / lpb);
    if (fmt) {
      lane_expand_kernel<true><<<grid, threads, 0, st>>>(
          nullptr, nullptr, nullptr, static_cast<const uint32_t*>(p4),
          static_cast<uint32_t*>(out), n_lanes, R, P, lpb);
    } else {
      lane_expand_kernel<false><<<grid, threads, 0, st>>>(
          static_cast<const uint32_t*>(cols), static_cast<const int16_t*>(s),
          static_cast<const int16_t*>(e), nullptr, static_cast<uint32_t*>(out), n_lanes, R,
          P, lpb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// cols u32 [B, rcap], cnts u8 [B, rcap], fill u32 [B]; scratch: cum i32
// [B, rcap], tile_sum i32 [B, ceil(rcap / 4096)], total i32 [B];
// out u8 [B, npx * 4].
extern "C" int zpix_qoi_sorted_expand(const void* cols, const void* cnts, const void* fill,
                                      void* cum, void* tile_sum, void* total, void* out,
                                      int64_t batch, int64_t rcap, int64_t npx, void* stream) {
  if (batch > 0 && rcap > 0 && npx > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = static_cast<int>((rcap + kTile - 1) / kTile);
    const dim3 grid(tiles, static_cast<unsigned>(batch));
    tile_sums_kernel<<<grid, kScanThreads, 0, st>>>(static_cast<const uint8_t*>(cnts),
                                                     static_cast<int32_t*>(tile_sum), rcap,
                                                     tiles);
    tile_offsets_kernel<<<static_cast<unsigned>(batch), kScanThreads, 0, st>>>(
        static_cast<int32_t*>(tile_sum), static_cast<int32_t*>(total), tiles);
    tile_scan_kernel<<<grid, kScanThreads, 0, st>>>(
        static_cast<const uint8_t*>(cnts), static_cast<const int32_t*>(tile_sum),
        static_cast<int32_t*>(cum), rcap, tiles);
    const int64_t n = batch * npx;
    sorted_expand_kernel<<<static_cast<unsigned>((n + kExpandThreads - 1) / kExpandThreads),
                           kExpandThreads, 0, st>>>(
        static_cast<const uint32_t*>(cols), static_cast<const int32_t*>(cum),
        static_cast<const int32_t*>(total), static_cast<const uint32_t*>(fill),
        static_cast<uint32_t*>(out), batch, npx, rcap);
  }
  return static_cast<int>(cudaGetLastError());
}
