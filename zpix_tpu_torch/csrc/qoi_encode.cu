// K14: the QOI encoder on the card, byte-identical to the serial encoder.
//
// Replaces zpix_tpu/parallel/qoi_batch.py::_encode_core (:1423), vmapped
// by _encode_fn (:1542).  Input: px u32 [B, n], each 0xRRGGBBAA.  Output:
// the op bytes of each image at out[b, 0:total[b]] (no header, no
// padding).  The derivation (zpix_tpu/codecs/qoi/encode_vec.py:1-21):
//  * prev[i] = px[i - 1], prev[0] = 0x000000FF; pixel i is a run member
//    iff px[i] == prev[i], else a literal;
//  * a literal is an INDEX hit iff it equals the previous literal in its
//    hash bucket (3r + 5g + 7b + 11a) & 63; the first literal of a bucket
//    compares against the zero table, i.e. against 0;
//  * a missed literal is DIFF, LUMA, RGB or RGBA by its differences to
//    prev (kind 2-5; kind 1 = INDEX, 0 = run member);
//  * a run member whose position in its run is a multiple of 62 flushes
//    RUN(62) (flush62); a literal after a run flushes the remainder
//    (prev run length % 62, run_before), and a run that reaches the last
//    pixel flushes its remainder after everything (tail_flush);
//  * bytes a pixel: [0, 1, 1, 2, 4, 5][kind] + flush62 + (run_before > 0);
//    each pixel's bytes start at the exclusive scan of the sizes.
// Parallel within an image, as the TPU program is: tiles of kTile pixels,
// one warp a tile walking it in steps of 32 pixels.  Inside a step
// __match_any_sync finds each literal's earlier same-bucket literals, and
// a 64-entry table in shared memory carries the last literal of every
// bucket from step to step.  Five kernels:
//  1. summary: each tile's last literal per bucket (values and a 64-bit
//     presence mask) and its trailing run length (-1: no literal);
//  2. carry: per image, a thread per bucket walks the tiles and replaces
//     each tile's table by the table at its start; thread 0 turns the
//     trailing runs into the run length entering each tile;
//  3. walk (sizes): each tile resolves hits, kinds and flushes from its
//     entering table and run, and sums its bytes; the image's last pixel
//     records tail_flush;
//  4. offsets: per image, an exclusive scan of the tile byte counts and
//     total = sum + (tail_flush > 0);
//  5. walk (write): the same walk again, with a warp scan of the sizes,
//     writes every byte at its offset, and the tail flush byte.
// Bound on the H100: bytes (4 a pixel in, the stream out); the walk runs
// twice, recomputing the plan (ALU work) instead of storing it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 1024;  // pixels a tile, one warp
constexpr int kWarps = 4;    // tiles a CUDA block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int hash_of(uint32_t v) {
  return static_cast<int>(((v >> 24) * 3 + ((v >> 16) & 0xFF) * 5 + ((v >> 8) & 0xFF) * 7 +
                           (v & 0xFF) * 11) & 63);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned lanemask_gt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_gt;" : "=r"(m));
  return m;
}

struct TileGeom {
  int64_t b;      // image
  int64_t t;      // tile index in the batch
  int32_t start;  // first pixel of the tile in its image
  int32_t len;    // pixels in the tile
};

__device__ __forceinline__ bool tile_of_warp(int64_t batch, int32_t n, int tpi, TileGeom* g) {
  g->t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (g->t >= batch * tpi) return false;
  g->b = g->t / tpi;
  g->start = static_cast<int32_t>(g->t - g->b * tpi) * kTile;
  g->len = min(kTile, n - g->start);
  return true;
}

// 1. per tile: last literal of each bucket, presence mask, trailing run
__global__ void summary_kernel(const uint32_t* __restrict__ px, uint32_t* __restrict__ tab,
                               uint64_t* __restrict__ mask, int32_t* __restrict__ trun,
                               int64_t batch, int32_t n, int tpi) {
  __shared__ uint32_t s_tab[kWarps][64];
  TileGeom g;
  if (!tile_of_warp(batch, n, tpi, &g)) return;
  const int lane = threadIdx.x & 31;
  uint32_t* stab = s_tab[threadIdx.x >> 5];
  const uint32_t* img = px + g.b * n;
  uint32_t mlo = 0, mhi = 0;
  int32_t last_lit = -1;  // in the tile
  for (int32_t s0 = 0; s0 < g.len; s0 += 32) {
    const int32_t k = s0 + lane;
    const bool valid = k < g.len;
    const int32_t i = g.start + k;
    const uint32_t v = valid ? img[i] : 0u;
    const uint32_t pv = valid ? (i ? img[i - 1] : 0xFFu) : 0u;
    const bool lit = valid && v != pv;
    const unsigned litmask = __ballot_sync(kFull, lit);
    const int h = hash_of(v);
    const unsigned m = __match_any_sync(kFull, lit ? h : 64 + lane);
    if (lit && !(m & litmask & lanemask_gt())) stab[h] = v;
    mlo |= __reduce_or_sync(kFull, lit && h < 32 ? 1u << h : 0u);
    mhi |= __reduce_or_sync(kFull, lit && h >= 32 ? 1u << (h - 32) : 0u);
    if (litmask) last_lit = s0 + 31 - __clz(litmask);
    __syncwarp();
  }
  tab[g.t * 64 + lane] = (mlo >> lane) & 1u ? stab[lane] : 0u;
  tab[g.t * 64 + 32 + lane] = (mhi >> lane) & 1u ? stab[32 + lane] : 0u;
  if (lane == 0) {
    mask[g.t] = (static_cast<uint64_t>(mhi) << 32) | mlo;
    trun[g.t] = last_lit < 0 ? -1 : g.len - 1 - last_lit;
  }
}

// 2. per image: the table and the run length entering each tile (separate
// arrays, so the loads of later tiles may run ahead of the stores)
__global__ void carry_kernel(const uint32_t* __restrict__ tab,
                             const uint64_t* __restrict__ mask,
                             const int32_t* __restrict__ trun, uint32_t* __restrict__ in_tab,
                             int32_t* __restrict__ run_in, int32_t n, int tpi) {
  const int k = threadIdx.x;  // bucket
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tpi;
  uint32_t carry = 0;
  int32_t run = 0;
#pragma unroll 8
  for (int ti = 0; ti < tpi; ++ti) {
    const int64_t t = t0 + ti;
    in_tab[t * 64 + k] = carry;
    if ((mask[t] >> k) & 1u) carry = tab[t * 64 + k];
    if (k == 0) {
      run_in[t] = run;
      const int32_t tr = trun[t];
      run = tr < 0 ? run + min(kTile, n - ti * kTile) : tr;
    }
  }
}

__device__ __forceinline__ int op_size(int kind) {
  return kind == 0 ? 0 : kind <= 2 ? 1 : kind == 3 ? 2 : kind == 4 ? 4 : 5;
}

// 3 and 5: the tile walk; kWrite = false sums the tile's bytes and records
// tail_flush, kWrite = true writes the bytes.
template <bool kWrite>
__global__ void walk_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ tab,
                            const int32_t* __restrict__ run_in,
                            int32_t* __restrict__ tile_bytes, int32_t* __restrict__ tail,
                            uint8_t* __restrict__ out, int64_t batch, int32_t n, int tpi,
                            int64_t out_stride) {
  __shared__ uint32_t s_tab[kWarps][64];
  TileGeom g;
  if (!tile_of_warp(batch, n, tpi, &g)) return;
  const int lane = threadIdx.x & 31;
  uint32_t* stab = s_tab[threadIdx.x >> 5];
  stab[lane] = tab[g.t * 64 + lane];
  stab[32 + lane] = tab[g.t * 64 + 32 + lane];
  __syncwarp();
  const uint32_t* img = px + g.b * n;
  uint8_t* dst = kWrite ? out + g.b * out_stride : nullptr;
  const int32_t rin = run_in[g.t];
  int32_t last_lit = g.start - 1 - rin;  // image index of the last literal before
  bool prev_run = rin > 0;               // is pixel start - 1 a run member
  int32_t written = kWrite ? tile_bytes[g.t] : 0;  // offset of the step in the image
  for (int32_t s0 = 0; s0 < g.len; s0 += 32) {
    const int32_t k = s0 + lane;
    const bool valid = k < g.len;
    const int32_t i = g.start + k;
    const uint32_t v = valid ? img[i] : 0u;
    const uint32_t pv = valid ? (i ? img[i - 1] : 0xFFu) : 0u;
    const bool run = valid && v == pv;
    const bool lit = valid && v != pv;
    const unsigned litmask = __ballot_sync(kFull, lit);
    const unsigned runmask = __ballot_sync(kFull, run);
    const int h = hash_of(v);
    // INDEX hit: the previous literal of the bucket, in this step or before
    const unsigned m = __match_any_sync(kFull, lit ? h : 64 + lane);
    const unsigned prior = m & litmask & lanemask_lt();
    const uint32_t from_step = __shfl_sync(kFull, v, prior ? 31 - __clz(prior) : lane);
    const bool hit = lit && (prior ? from_step : stab[h]) == v;
    __syncwarp();
    if (lit && !(m & litmask & lanemask_gt())) stab[h] = v;
    __syncwarp();
    // runs: the last literal at or before i, and whether i - 1 ran
    const unsigned lits_le = litmask & (lanemask_lt() | (1u << lane));
    const unsigned lits_lt = litmask & lanemask_lt();
    const int32_t lit_le = lits_le ? g.start + s0 + 31 - __clz(lits_le) : last_lit;
    const int32_t lit_lt = lits_lt ? g.start + s0 + 31 - __clz(lits_lt) : last_lit;
    const bool prev_is_run = lane ? (runmask >> (lane - 1)) & 1u : prev_run;
    const int32_t pos = run ? i - lit_le : 0;  // position in the run, from 1
    const bool flush62 = run && pos % 62 == 0;
    const int run_before = lit && prev_is_run ? (i - 1 - lit_lt) % 62 : 0;
    int kind = 0;
    const int r = v >> 24, gg = (v >> 16) & 0xFF, bb = (v >> 8) & 0xFF, a = v & 0xFF;
    const int vr = r - static_cast<int>(pv >> 24);
    const int vg = gg - static_cast<int>((pv >> 16) & 0xFF);
    const int vb = bb - static_cast<int>((pv >> 8) & 0xFF);
    const int vg_r = vr - vg, vg_b = vb - vg;
    if (lit) {
      const bool same_a = a == static_cast<int>(pv & 0xFF);
      if (hit) kind = 1;
      else if (same_a && vr > -3 && vr < 2 && vg > -3 && vg < 2 && vb > -3 && vb < 2) kind = 2;
      else if (same_a && vg_r > -9 && vg_r < 8 && vg > -33 && vg < 32 && vg_b > -9 && vg_b < 8)
        kind = 3;
      else kind = same_a ? 4 : 5;
    }
    const int size = op_size(kind) + flush62 + (run_before > 0);
    int incl = size;  // warp inclusive scan of the sizes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (kWrite && valid) {
      int64_t o = written + incl - size;
      if (flush62) dst[o++] = 0xC0 | 61;
      if (run_before > 0) dst[o++] = static_cast<uint8_t>(0xC0 | (run_before - 1));
      switch (kind) {
        case 1: dst[o] = static_cast<uint8_t>(h); break;
        case 2: dst[o] = static_cast<uint8_t>(0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2));
          break;
        case 3:
          dst[o] = static_cast<uint8_t>(0x80 | (vg + 32));
          dst[o + 1] = static_cast<uint8_t>(((vg_r + 8) << 4) | (vg_b + 8));
          break;
        case 4: case 5:
          dst[o] = kind == 4 ? 0xFE : 0xFF;
          dst[o + 1] = static_cast<uint8_t>(r);
          dst[o + 2] = static_cast<uint8_t>(gg);
          dst[o + 3] = static_cast<uint8_t>(bb);
          if (kind == 5) dst[o + 4] = static_cast<uint8_t>(a);
          break;
        default: break;
      }
    }
    if (valid && i == n - 1) {  // end of the image: the residual run
      const int tf = run ? pos % 62 : 0;
      if (!kWrite) tail[g.b] = tf;
      else if (tf > 0) dst[written + incl] = static_cast<uint8_t>(0xC0 | (tf - 1));
    }
    written += __shfl_sync(kFull, incl, 31);
    if (litmask) last_lit = g.start + s0 + 31 - __clz(litmask);
    prev_run = (runmask >> 31) & 1u;
  }
  if (!kWrite && lane == 0) tile_bytes[g.t] = written;
}

// 4. per image: tile byte counts -> exclusive offsets in place; the total
__global__ void offsets_kernel(int32_t* __restrict__ tile_bytes,
                               const int32_t* __restrict__ tail,
                               int32_t* __restrict__ total, int tpi) {
  __shared__ int32_t warp_sum[32];
  int32_t* tb = tile_bytes + static_cast<int64_t>(blockIdx.x) * tpi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t carry = 0;
  for (int base = 0; base < tpi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t v = i < tpi ? tb[i] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t t = lane < static_cast<int>(blockDim.x >> 5) ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t u = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += u;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    if (i < tpi) tb[i] = carry + (warp ? warp_sum[warp - 1] : 0) + incl - v;
    carry += warp_sum[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) total[blockIdx.x] = carry + (tail[blockIdx.x] > 0);
}

}  // namespace

// px u32 [B, n]; out u8 [B, out_stride] (out_stride >= 5n + n/62 + 8,
// written at [0, total) of each row); total i32 [B].  Scratch, 8-byte
// aligned, int32 words: mask u64 [T], tab and in_tab u32 [T, 64], trun,
// run_in and tile_bytes i32 [T], tail i32 [B], T = B * ceil(n / 1024):
// T * 133 + B words (ops/qoi.py::encode allocates it).
extern "C" int zpix_qoi_encode_batch(const void* px, void* out, void* total, void* scratch,
                                     int64_t batch, int64_t n, int64_t out_stride,
                                     void* stream) {
  if (batch > 0 && n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tpi = static_cast<int>((n + kTile - 1) / kTile);
    const int64_t tiles = batch * tpi;
    const int32_t n32 = static_cast<int32_t>(n);
    const unsigned grid = static_cast<unsigned>((tiles + kWarps - 1) / kWarps);
    const auto* p = static_cast<const uint32_t*>(px);
    auto* mask = static_cast<uint64_t*>(scratch);
    auto* tab = reinterpret_cast<uint32_t*>(mask + tiles);
    uint32_t* in_tab = tab + tiles * 64;
    auto* trun = reinterpret_cast<int32_t*>(in_tab + tiles * 64);
    int32_t* run_in = trun + tiles;
    int32_t* bytes = run_in + tiles;
    int32_t* tail = bytes + tiles;
    summary_kernel<<<grid, 32 * kWarps, 0, st>>>(p, tab, mask, trun, batch, n32, tpi);
    carry_kernel<<<static_cast<unsigned>(batch), 64, 0, st>>>(tab, mask, trun, in_tab, run_in,
                                                              n32, tpi);
    walk_kernel<false><<<grid, 32 * kWarps, 0, st>>>(p, in_tab, run_in, bytes, tail, nullptr,
                                                      batch, n32, tpi, out_stride);
    offsets_kernel<<<static_cast<unsigned>(batch), 1024, 0, st>>>(
        bytes, tail, static_cast<int32_t*>(total), tpi);
    walk_kernel<true><<<grid, 32 * kWarps, 0, st>>>(p, in_tab, run_in, bytes, tail,
                                                     static_cast<uint8_t*>(out), batch, n32,
                                                     tpi, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
