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
//
// One pass, one launch (and a memset of the flags): a block a tile of
// kTile pixels, tiles taken by ticket from an atomic counter, images
// interleaved (ticket = tile * B + image), so that every wait points at
// an earlier ticket and a grid larger than the card holds at once drains.
// The tile's pixels are read once into shared memory.  Two prefixes run
// as single-pass scans with decoupled look-back (Merrill & Garland):
//  1. the table and the last literal entering the tile.  A tile's
//     aggregate is its last literal per bucket (values, a 64-bit presence
//     mask) and its last literal's index; a later present literal replaces
//     an earlier one, and the last literal is the larger index.  Each tile
//     publishes its aggregate as soon as it has read its pixels, then
//     walks back over earlier tiles until every bucket and the last
//     literal are known or an inclusive prefix is found, and publishes its
//     own inclusive prefix.  The run entering a pixel is its distance to
//     the last literal before it.
//  2. the byte offset: after the walk each tile publishes its byte count
//     (flag and value in one 64-bit word), then a warp looks back over 32
//     earlier tiles at a time for its offset.
// Inside the tile each of kWarps warps walks kTile / kWarps pixels in
// steps of 32 from the table entering its segment (the tile's, updated by
// the earlier segments' last literals); __match_any_sync finds each
// literal's earlier same-bucket literals in a step.  The ops go into
// shared memory, are packed there at the tile's offset modulo 16, and are
// written with 16-byte stores (byte stores only at the two ragged ends).
// The image's last tile appends the tail flush and writes total.
// Forward progress: a wait is on a flag that an earlier ticket, already
// running, sets without waiting on a later one; 2^24 polls trap.
// Bound on the H100: bytes (4 a pixel in, the stream out).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 2048;            // pixels a tile, a block (PERF.md: the tile sweep)
constexpr int kWarps = 8;              // warps a block, a segment each
constexpr int kSeg = kTile / kWarps;   // pixels a segment
constexpr int kSegBytes = 6 * kSeg;    // a segment's ops: <= 6 bytes a pixel
constexpr int kOutBytes = 6 * kTile + 32;  // the tile's ops, the tail flush, alignment
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kAggregate = uint64_t(1) << 62, kInclusive = uint64_t(2) << 62;
constexpr uint64_t kValueMask = kAggregate - 1;
constexpr int64_t kMaxPolls = int64_t(1) << 24;

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

__device__ __forceinline__ int op_size(int kind) {
  return kind == 0 ? 0 : kind <= 2 ? 1 : kind == 3 ? 2 : kind == 4 ? 4 : 5;
}

// Per-tile state in global scratch (ops/qoi.py sizes it: T * 135 + 2
// int32 words for T tiles; bytes, status and the counter are zeroed a call).
struct Scratch {
  uint64_t* bytes;     // [T] the byte count (kAggregate) or inclusive end (kInclusive)
  uint32_t* status;    // [T] 1: aggregate published, 2: inclusive published
  uint32_t* counter;   // the ticket counter
  uint64_t* agg_mask;  // [T] buckets the tile holds a literal of
  int32_t* agg_last;   // [T] the tile's last literal (image index), -1 none
  int32_t* inc_last;   // [T] the last literal up to the tile's end, -1 none
  uint32_t* agg_tab;   // [T, 64] the tile's last literal of each bucket
  uint32_t* inc_tab;   // [T, 64] the table at the tile's end
};

__device__ __forceinline__ uint32_t poll32(const uint32_t* p) {
  int64_t n = 0;
  uint32_t v;
  while ((v = *reinterpret_cast<const volatile uint32_t*>(p)) == 0) {
    if (++n > kMaxPolls) __trap();
  }
  return v;
}

// Warp 0: the table and the last literal entering tile ti of image b, by
// look-back over the image's earlier tiles (t = b * tpi + ti).
__device__ void table_lookback(const Scratch& sc, int64_t t, int ti, uint32_t* ent,
                               int32_t* ent_last) {
  const int lane = threadIdx.x;
  uint32_t v0 = 0, v1 = 0;      // buckets lane and lane + 32
  bool h0 = false, h1 = false;  // found
  int32_t last = -1;
  bool have_last = false;
  for (int p = ti - 1; p >= 0; --p) {
    const int64_t q = t - (ti - p);
    uint32_t st = 0;
    if (lane == 0) st = poll32(sc.status + q);
    st = __shfl_sync(kFull, st, 0);
    __threadfence();
    if (st == 2) {  // inclusive: every bucket and the last literal
      if (!h0) v0 = __ldcg(sc.inc_tab + q * 64 + lane);
      if (!h1) v1 = __ldcg(sc.inc_tab + q * 64 + 32 + lane);
      h0 = h1 = true;
      if (!have_last) last = __ldcg(sc.inc_last + q);
      have_last = true;
      break;
    }
    const uint64_t m = __ldcg(reinterpret_cast<const unsigned long long*>(sc.agg_mask + q));
    if (!h0 && ((m >> lane) & 1u)) {
      v0 = __ldcg(sc.agg_tab + q * 64 + lane);
      h0 = true;
    }
    if (!h1 && ((m >> (32 + lane)) & 1u)) {
      v1 = __ldcg(sc.agg_tab + q * 64 + 32 + lane);
      h1 = true;
    }
    if (!have_last) {
      const int32_t a = __ldcg(sc.agg_last + q);
      if (a >= 0) {
        last = a;
        have_last = true;
      }
    }
    if (have_last && __all_sync(kFull, h0 && h1)) break;
  }
  ent[lane] = h0 ? v0 : 0u;  // a bucket no literal reached: the zero table
  ent[32 + lane] = h1 ? v1 : 0u;
  if (lane == 0) *ent_last = have_last ? last : -1;
}

// Warp 0: the byte offset of tile ti of image b (t = b * tpi + ti) by
// look-back, 32 earlier tiles a round.
__device__ int64_t offset_lookback(const Scratch& sc, int64_t t, int ti) {
  const int lane = threadIdx.x;
  int64_t off = 0;
  int p = ti - 1;  // the round's first (latest) tile
  while (p >= 0) {
    const int me = p - lane;
    uint64_t w = kInclusive;  // before the image: an inclusive 0
    if (me >= 0) {
      int64_t n = 0;
      const volatile uint64_t* src =
          reinterpret_cast<const volatile uint64_t*>(sc.bytes + t - (ti - me));
      while ((w = *src) == 0) {
        if (++n > kMaxPolls) __trap();
      }
    }
    const unsigned inc = __ballot_sync(kFull, (w >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 32;  // lanes 0..stop count
    int64_t v = lane <= stop ? static_cast<int64_t>(w & kValueMask) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    off += v;
    if (inc) break;
    p -= 32;
  }
  return off;
}

// Warp w's walk of its segment (pixels [k0, k0 + len) of the tile, image
// index g0 = tile start + k0): kinds, hits and flushes from the table
// entering the segment (stab, updated in place) and the last literal
// before it; the ops go to seg.  -> bytes written; *tail gets the tail
// flush where the segment holds the image's last pixel.
__device__ int walk(const uint32_t* s_px, uint32_t* stab, int k0, int len, int32_t g0,
                    int32_t last_lit, int32_t n, uint8_t* seg, int* tail) {
  const int lane = threadIdx.x & 31;
  bool prev_run = last_lit < g0 - 1;  // is pixel g0 - 1 a run member
  int written = 0;
  for (int s0 = 0; s0 < len; s0 += 32) {
    const int k = s0 + lane;
    const bool valid = k < len;
    const int32_t i = g0 + k;
    const uint32_t v = valid ? s_px[1 + k0 + k] : 0u;
    const uint32_t pv = valid ? s_px[k0 + k] : 0u;
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
    const int32_t lit_le = lits_le ? g0 + s0 + 31 - __clz(lits_le) : last_lit;
    const int32_t lit_lt = lits_lt ? g0 + s0 + 31 - __clz(lits_lt) : last_lit;
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
    if (valid) {
      int o = written + incl - size;
      if (flush62) seg[o++] = 0xC0 | 61;
      if (run_before > 0) seg[o++] = static_cast<uint8_t>(0xC0 | (run_before - 1));
      switch (kind) {
        case 1: seg[o] = static_cast<uint8_t>(h); break;
        case 2: seg[o] = static_cast<uint8_t>(0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2));
          break;
        case 3:
          seg[o] = static_cast<uint8_t>(0x80 | (vg + 32));
          seg[o + 1] = static_cast<uint8_t>(((vg_r + 8) << 4) | (vg_b + 8));
          break;
        case 4: case 5:
          seg[o] = kind == 4 ? 0xFE : 0xFF;
          seg[o + 1] = static_cast<uint8_t>(r);
          seg[o + 2] = static_cast<uint8_t>(gg);
          seg[o + 3] = static_cast<uint8_t>(bb);
          if (kind == 5) seg[o + 4] = static_cast<uint8_t>(a);
          break;
        default: break;
      }
      if (i == n - 1) *tail = run ? pos % 62 : 0;  // the residual run
    }
    written += __shfl_sync(kFull, incl, 31);
    if (litmask) last_lit = g0 + s0 + 31 - __clz(litmask);
    prev_run = (runmask >> 31) & 1u;
  }
  return written;
}

__global__ void __launch_bounds__(32 * kWarps)
encode_kernel(const uint32_t* __restrict__ px, uint8_t* __restrict__ out,
              int32_t* __restrict__ total, Scratch sc, int B, int32_t n, int tpi,
              int64_t out_stride) {
  __shared__ uint32_t s_px[kTile + 1];      // the pixel before the tile, then the tile's
  __shared__ int32_t s_last[kWarps][64];    // each segment's last literal a bucket (tile index)
  __shared__ uint32_t s_tab[kWarps][64];    // the table entering each segment
  __shared__ uint32_t s_ent[64];            // the table entering the tile
  __shared__ int32_t s_wlast[kWarps];       // the last literal entering each segment
  __shared__ int s_wbytes[kWarps + 1];
  __shared__ uint8_t s_seg[kWarps][kSegBytes];
  __shared__ __align__(16) uint8_t s_out[kOutBytes];
  __shared__ int64_t s_ticket, s_off;
  __shared__ int32_t s_ent_last;
  __shared__ int s_tail, s_count;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(sc.counter, 1u);
  for (int i = tid; i < kWarps * 64; i += blockDim.x) s_last[i / 64][i % 64] = -1;
  if (tid == 0) s_tail = 0;
  __syncthreads();
  const int64_t ticket = s_ticket;
  const int b = static_cast<int>(ticket % B), ti = static_cast<int>(ticket / B);
  const int64_t t = static_cast<int64_t>(b) * tpi + ti;
  const int32_t start = ti * kTile;
  const int len = min(kTile, n - start);
  const uint32_t* img = px + static_cast<int64_t>(b) * n;

  // the pixels, read once; each segment's last literal of each bucket
  for (int k = tid; k < len; k += blockDim.x) s_px[1 + k] = img[start + k];
  if (tid == 0) s_px[0] = start ? img[start - 1] : 0xFFu;
  __syncthreads();
  for (int k = tid; k < len; k += blockDim.x) {
    const uint32_t v = s_px[1 + k];
    if (v != s_px[k]) atomicMax(&s_last[k / kSeg][hash_of(v)], k);
  }
  __syncthreads();

  // 1. the aggregate, published at once (warp 0), then the look-back
  if (w == 0) {
    int32_t i0 = -1, i1 = -1;
    for (int s = 0; s < kWarps; ++s) {
      i0 = max(i0, s_last[s][lane]);
      i1 = max(i1, s_last[s][32 + lane]);
    }
    const unsigned m0 = __ballot_sync(kFull, i0 >= 0), m1 = __ballot_sync(kFull, i1 >= 0);
    int32_t tl = max(i0, i1);
#pragma unroll
    for (int d = 16; d; d >>= 1) tl = max(tl, __shfl_xor_sync(kFull, tl, d));
    const uint32_t v0 = i0 >= 0 ? s_px[1 + i0] : 0u, v1 = i1 >= 0 ? s_px[1 + i1] : 0u;
    const int32_t agg_last = tl >= 0 ? start + tl : -1;
    if (ti + 1 < tpi) {  // the image's last tile has no reader
      sc.agg_tab[t * 64 + lane] = v0;
      sc.agg_tab[t * 64 + 32 + lane] = v1;
      if (lane == 0) {
        sc.agg_mask[t] = (static_cast<uint64_t>(m1) << 32) | m0;
        sc.agg_last[t] = agg_last;
      }
      __threadfence();
      __syncwarp();
      if (lane == 0 && ti > 0) *reinterpret_cast<volatile uint32_t*>(sc.status + t) = 1u;
    }
    if (ti > 0) {
      table_lookback(sc, t, ti, s_ent, &s_ent_last);
    } else {
      s_ent[lane] = s_ent[32 + lane] = 0u;
      if (lane == 0) s_ent_last = -1;
    }
    __syncwarp();
    if (ti + 1 < tpi) {  // the inclusive prefix
      sc.inc_tab[t * 64 + lane] = i0 >= 0 ? v0 : s_ent[lane];
      sc.inc_tab[t * 64 + 32 + lane] = i1 >= 0 ? v1 : s_ent[32 + lane];
      if (lane == 0) sc.inc_last[t] = agg_last >= 0 ? agg_last : s_ent_last;
      __threadfence();
      __syncwarp();
      if (lane == 0) *reinterpret_cast<volatile uint32_t*>(sc.status + t) = 2u;
    }
  }
  __syncthreads();

  // the table and last literal entering each segment
  for (int k = lane; k < 64; k += 32) {
    uint32_t v = s_ent[k];
    for (int s = 0; s < w; ++s) {
      const int32_t i = s_last[s][k];
      if (i >= 0) v = s_px[1 + i];
    }
    s_tab[w][k] = v;
  }
  int32_t seg_last = -1;  // the segment's own last literal is found by its walk
  for (int s = 0; s < w; ++s) {
    int32_t i = max(s_last[s][lane], s_last[s][32 + lane]);
#pragma unroll
    for (int d = 16; d; d >>= 1) i = max(i, __shfl_xor_sync(kFull, i, d));
    if (i >= 0) seg_last = start + i;
  }
  if (lane == 0) s_wlast[w] = seg_last >= 0 ? seg_last : s_ent_last;
  __syncwarp();

  // the walk, a segment a warp
  const int k0 = w * kSeg;
  const int wlen = max(0, min(kSeg, len - k0));
  const int wb = walk(s_px, s_tab[w], k0, wlen, start + k0, s_wlast[w], n, s_seg[w], &s_tail);
  if (lane == 0) s_wbytes[w] = wb;
  __syncthreads();

  // 2. the byte count, then the offset (warp 0)
  const bool last_tile = ti + 1 == tpi;
  if (tid == 0) {
    int c = 0;
    for (int s = 0; s < kWarps; ++s) {
      const int x = s_wbytes[s];
      s_wbytes[s] = c;  // each segment's offset in the tile
      c += x;
    }
    s_wbytes[kWarps] = c;
    s_count = c + (last_tile && s_tail > 0);  // the image's last tile: the tail flush
    if (!last_tile) {
      *reinterpret_cast<volatile uint64_t*>(sc.bytes + t) =
          (ti == 0 ? kInclusive : kAggregate) | static_cast<uint64_t>(s_count);
    }
    if (ti == 0) s_off = 0;
  }
  __syncthreads();
  if (w == 0 && ti > 0) {
    const int64_t off = offset_lookback(sc, t, ti);
    if (lane == 0) {
      s_off = off;
      if (!last_tile) {
        *reinterpret_cast<volatile uint64_t*>(sc.bytes + t) =
            kInclusive | static_cast<uint64_t>(off + s_count);
      }
    }
  }
  __syncthreads();
  const int64_t off = s_off;
  const int count = s_count;
  uint8_t* dst = out + static_cast<int64_t>(b) * out_stride + off;
  const int a0 = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);

  // pack the segments' ops at the tile's offset modulo 16, then store
  uint8_t* o = s_out + a0 + s_wbytes[w];
  for (int k = lane; k < s_wbytes[w + 1] - s_wbytes[w]; k += 32) o[k] = s_seg[w][k];
  if (tid == 0 && count > s_wbytes[kWarps]) {
    s_out[a0 + count - 1] = static_cast<uint8_t>(0xC0 | (s_tail - 1));
  }
  __syncthreads();
  uint8_t* base = dst - a0;  // 16-byte aligned
  const int nq = (a0 + count + 15) / 16;
  for (int q = tid; q < nq; q += blockDim.x) {
    const int lo = q * 16, hi = lo + 16;
    if (lo >= a0 && hi <= a0 + count) {
      *reinterpret_cast<uint4*>(base + lo) = *reinterpret_cast<const uint4*>(s_out + lo);
    } else {
      for (int k = max(lo, a0); k < min(hi, a0 + count); ++k) base[k] = s_out[k];
    }
  }
  if (tid == 0 && last_tile) total[b] = static_cast<int32_t>(off + count);
}

}  // namespace

// px u32 [B, n]; out u8 [B, out_stride] (out_stride >= 5n + n/62 + 8,
// written at [0, total) of each row); total i32 [B].  Scratch, 8-byte
// aligned, int32 words, T = B * ceil(n / 2048) tiles: agg_mask and bytes
// u64 [T], status u32 [T], the counter (2 words), agg_last and inc_last
// i32 [T], agg_tab and inc_tab u32 [T, 64]: T * 135 + 2 words
// (ops/qoi.py::encode allocates it); bytes, status and the counter are
// zeroed here.
extern "C" int zpix_qoi_encode_batch(const void* px, void* out, void* total, void* scratch,
                                     int64_t batch, int64_t n, int64_t out_stride,
                                     void* stream) {
  if (batch > 0 && n > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tpi = static_cast<int>((n + kTile - 1) / kTile);
    const int64_t tiles = batch * tpi;
    Scratch sc;
    sc.agg_mask = static_cast<uint64_t*>(scratch);
    sc.bytes = sc.agg_mask + tiles;
    sc.status = reinterpret_cast<uint32_t*>(sc.bytes + tiles);
    sc.counter = sc.status + tiles;
    sc.agg_last = reinterpret_cast<int32_t*>(sc.counter + 2);
    sc.inc_last = sc.agg_last + tiles;
    sc.agg_tab = reinterpret_cast<uint32_t*>(sc.inc_last + tiles);
    sc.inc_tab = sc.agg_tab + tiles * 64;
    cudaError_t err = cudaMemsetAsync(sc.bytes, 0, (tiles * 3 + 2) * sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    encode_kernel<<<static_cast<unsigned>(tiles), 32 * kWarps, 0, st>>>(
        static_cast<const uint32_t*>(px), static_cast<uint8_t*>(out),
        static_cast<int32_t*>(total), sc, static_cast<int>(batch), static_cast<int32_t>(n),
        tpi, out_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
