// K1 (index pass) and K2 (value pass): the entropy decode of restart
// segments, and of whole-image chains (K2 alone, after the host index scan
// or K19).
//
// K1 replaces zpix_tpu/parallel/device_entropy.py::build_decode_fn's
// run_pass1 (:974-1058), a lax.while_loop over segment lanes.  A thread
// walks one restart segment symbol by symbol, decoding only code lengths
// and run/size and skipping the extend bits, and writes each block's end
// bit.  Bound on the H100: the serial symbol chain of the longest segment,
// not bytes (8,192 segments at the main configuration: one or two warps
// an SM, so every instruction on the chain costs its full latency).  The
// design keeps the chain short:
// - a lookahead table (kLookBits bits) a CTA, built in shared memory from
//   the packed tables for each (table, DC or AC) the MCU's slots use: one
//   load gives the whole advance (code and extend bits), the step of the
//   zigzag index k (run + 1, 16 for ZRL, 64 for EOB, so that a block ends
//   where k reaches 64) and, for K2, the code length and size; a longer
//   code reads a second-level block of the 64 lookaheads under its prefix
//   (kL2Blocks a CTA; decode_full past them);
// - the CTA's segments are staged in shared memory by cp.async while the
//   CTA builds the table; a symbol's bits are a funnel shift of the two
//   staged words at its position, so a step is two loads, a shift, the
//   table load and an add (a walk that leaves the staged span reads
//   device memory);
// - bit positions are int32 (the wrapper bounds the stream), each slot's
//   table bases are loaded a block ahead, and only the blocks a lane does
//   not reach (padding, or past an error) are written as 0;
// - a CTA of kIndexThreads threads walks kIndexLanes segments: every
//   thread builds the table and stages bytes, so the table costs little
//   even where a CTA walks only 64 segments and the walks spread over
//   every SM.
//
// K2 replaces _value_pass (:611-766) with the agree/ok check (:1143-1150).
// A persistent grid of 1,024 threads an SM (one CTA, so that the table is
// built once an SM): each warp takes groups of 32 consecutive
// blocks (lane = block), each lane starting at the previous block's end
// (K1's, or the host scan's, or K19's) and decoding its DC diff and AC
// coefficients with the same lookahead table; a group's block bounds are
// loaded while the warp decodes the group before.  The nonzeros are
// scattered into the warp's 32 rows in shared memory (zero, a row's
// 16-byte pieces swizzled by the row), then the warp writes the 4 KiB
// contiguous with 16-byte stores and zeroes the rows behind it; ok is
// cleared once a warp (a ballot, one atomicAnd).  Bound: bytes (the
// 128-byte coefficient rows).
//
// Both equal their plain versions (ops/entropy.py) bit for bit on any
// input: ends, ok, coefficients and DC diffs, including lanes that run
// past the buffer (a read of 8 bytes from a symbol's first byte past the
// stream stops the lane), hit a code no table holds, start below bit 0 (the
// plain window reads from byte 0 there) or end off ``ends``.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "huffman.cuh"
#include "mcu_pixels.cuh"  // cp.async
#include "timing.cuh"

namespace {

using zpix::Sym;

constexpr unsigned kFull = 0xffffffffu;
// Launch shapes (tools/torch_entropy_stages.py --sweep rebuilds this file
// with other values): K1's CTA, all of whose threads build the table and
// kIndexLanes of which walk a segment each; K2's persistent CTAs an SM,
// which share 1,024 threads.
constexpr int kIndexThreads = 512;
constexpr int kIndexLanes = 64;
constexpr int kValueCtasPerSm = 1;
constexpr int kValueThreads = 1024 / kValueCtasPerSm;
static_assert(kIndexLanes % 32 == 0 && kIndexLanes <= kIndexThreads, "whole warps walk");
constexpr int kLookBits = 10, kLookSize = 1 << kLookBits;
// (table, DC or AC) pairs with a lookahead table; a baseline stream uses
// at most 4 (two tables of each class).  Pairs past these, and region
// n_regions (all zeros), decode in full.
constexpr int kLookRegions = 4;
constexpr int kMaxSlots = 16;
constexpr int kStageWordsPerLane = 128;  // K1: 512 staged bytes a segment
constexpr uint32_t kEntryBad = 0x80000000u;  // every lookahead of the entry is invalid
// An entry whose lookaheads start codes longer than kLookBits bits points
// to a second-level block, kEntryL2 | block: the block's 64 entries are
// those of the 16-bit lookaheads under it (0 for an invalid code).  Such
// entries past kL2Blocks blocks stay 0 and decode in full.
constexpr uint32_t kEntryL2 = 0x40000000u;
constexpr int kL2Blocks = 32;
// Streams up to this many bytes: every bit position, and a symbol's
// advance past one, fits an int32.
constexpr int64_t kMaxStream = (int64_t(1) << 28) - 1024;

// A lookahead entry (ops/entropy.py::index_lut_plain): adv | step << 9 |
// len << 16 | size << 21, never 0.  adv = len + size bits; size = sym for
// DC, sym & 15 for AC; step = 1 for DC, else run + 1 (size > 0), 16 (ZRL)
// or 64 (EOB).
__device__ __forceinline__ uint32_t make_entry(int len, int sym, int ac) {
  const int size = ac ? (sym & 15) : sym;
  const int r = sym >> 4;
  const int step = !ac ? 1 : size ? r + 1 : r == 15 ? 16 : 64;
  return static_cast<uint32_t>(len + size) | static_cast<uint32_t>(step) << 9 |
         static_cast<uint32_t>(len) << 16 | static_cast<uint32_t>(size) << 21;
}

// Not a symbol's entry (0, kEntryBad or a second-level block): long_entry.
__device__ __forceinline__ bool entry_slow(uint32_t e) { return e - 1u >= 0x1FFFFFFFu; }

struct alignas(16) EntropySmem {
  int32_t tab[zpix::kTabEntropyWords];
  // per slot and role (2 s + ac): lookahead base | t << 16 | ac << 19
  uint32_t role[2 * kMaxSlots];
  uint32_t region_rt[kLookRegions];  // t | ac << 3 of each built region
  uint32_t n_regions, sorted;
  int32_t span_lo, span_hi;  // K1: the CTA's stream words
  uint8_t unzig[64];
  uint32_t n_l2;                   // second-level blocks claimed
  uint32_t l2_src[kL2Blocks];      // region << kLookBits | entry of each block
  uint32_t lut[(kLookRegions + 1) * kLookSize];
  uint32_t l2[kL2Blocks << (16 - kLookBits)];
};

// The tables into shared memory, each slot's roles mapped to lookahead
// regions (a lane of warp 1 a slot and role, regions in the order of each
// pair's first use).  The caller synchronises before the regions are
// built.
__device__ void stage_tables(EntropySmem& S, const int32_t* tables, int bpm) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x) S.tab[i] = tables[i];
  if (threadIdx.x < 64) S.unzig[threadIdx.x] = static_cast<uint8_t>(zpix::kUnzig[threadIdx.x]);
  if (threadIdx.x == 0) S.sorted = 0, S.n_l2 = 0;
  __syncthreads();
  if (threadIdx.x < 8) {
    if (zpix::lims_sorted(S.tab, threadIdx.x)) atomicOr(&S.sorted, 1u << threadIdx.x);
  } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
    const int i = threadIdx.x - 32, ac = i & 1, s = i >> 1;  // i = 2 s + ac
    const bool live = i < 2 * bpm;
    const uint32_t t = live ? S.tab[(ac ? zpix::kTabSlotAc : zpix::kTabSlotDc) + s] & 7 : 0;
    const uint32_t rt = live ? t | static_cast<uint32_t>(ac) << 3 : 16u;
    const int first = __ffs(__match_any_sync(kFull, rt)) - 1;  // the pair's first lane
    const unsigned firsts = __ballot_sync(kFull, live && first == i);
    const uint32_t j = __popc(firsts & ((1u << first) - 1u));  // regions of earlier pairs
    const uint32_t n = min(__popc(firsts), kLookRegions);
    if (live) {
      S.role[i] = (j < n ? j : n) * kLookSize | t << 16 | static_cast<uint32_t>(ac) << 19;
      if (first == i && j < n) S.region_rt[j] = rt;
    }
    if (i == 0) S.n_regions = n;
  }
}

// The lookahead regions, then the zero region after them: a thread a
// stride of entries, with the region's limits in registers.  Entry p
// covers lookaheads lo = p << kLow to hi = lo + 2^kLow - 1; lo >= lims[i]
// iff p >= a[i] = ceil(lims[i] / 2^kLow), hi >= lims[i] iff p >= b[i] =
// floor(lims[i] / 2^kLow).  Each compare is monotone in the lookahead, so
// every lookahead of p decodes alike iff as many limits lie at or below
// hi as at or below lo: a[i] and b[i] differ by at most 1, so the entries
// where they do not are the (at most 16) p = b[i] with a[i] = b[i] + 1,
// set to 0 after the fill.  The caller synchronises after.
__device__ void build_lut(EntropySmem& S) {
  constexpr int kLow = 16 - kLookBits;
  const int n = static_cast<int>(S.n_regions);
  for (int j = 0; j < n; ++j) {
    const uint32_t rt = S.region_rt[j];
    const int t = rt & 7, ac = rt >> 3;
    const int32_t* lims = S.tab + zpix::kTabLims + 16 * t;
    int32_t a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = (lims[i] >> kLow) + ((lims[i] & ((1 << kLow) - 1)) != 0);
    const bool sorted = (S.sorted >> t) & 1u;
    uint32_t* lut = S.lut + j * kLookSize;
    for (int p = threadIdx.x; p < kLookSize; p += blockDim.x) {
      int c = 0;  // #{i < 15 : lo >= lims[i]}
#pragma unroll
      for (int i = 0; i < 15; ++i) c += p >= a[i];
      uint32_t e = 0;
      if (p >= a[15]) {
        e = kEntryBad;  // every lookahead of p is invalid
      } else if (c >= kLookBits) {  // a longer code: a second-level block, while any is left
        const uint32_t blk = atomicAdd(&S.n_l2, 1u);
        if (blk < kL2Blocks) {
          S.l2_src[blk] = static_cast<uint32_t>(j) << kLookBits | p;
          e = kEntryL2 | blk;
        }
      } else {
        const int len = c + 1, lo = p << kLow;
        int sym;
        if (sorted) {  // the compares that hold are a prefix: the offset telescopes
          const int vidx = S.tab[zpix::kTabAoff + 16 * t + c] + (lo >> (16 - len));
          sym = (vidx >= 0 && vidx < S.tab[zpix::kTabNvals]) ? S.tab[zpix::kTabVals + vidx] : 0;
        } else {
          sym = zpix::decode_sym(S.tab, t, lo).sym;
        }
        e = make_entry(len, sym, ac);
      }
      lut[p] = e;
    }
  }
  for (int p = threadIdx.x; p < kLookSize; p += blockDim.x) S.lut[n * kLookSize + p] = 0;
  __syncthreads();
  if (threadIdx.x < 16 * n) {  // the entries whose two ends count different limits
    const int j = threadIdx.x >> 4, i = threadIdx.x & 15;
    const int32_t* lims = S.tab + zpix::kTabLims + 16 * (S.region_rt[j] & 7);
    const int32_t b = lims[i] >> kLow, a15 = (lims[15] >> kLow) + ((lims[15] & ((1 << kLow) - 1)) != 0);
    if ((lims[i] & ((1 << kLow) - 1)) != 0 && b >= 0 && b < kLookSize && b < a15)
      S.lut[j * kLookSize + b] = 0;
  }
  const int n2 = min(static_cast<int>(S.n_l2), kL2Blocks) << kLow;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {  // the second-level blocks, exact
    const uint32_t src = S.l2_src[i >> kLow], rt = S.region_rt[src >> kLookBits];
    const int t = rt & 7;
    const int32_t look = static_cast<int32_t>((src & (kLookSize - 1)) << kLow) | (i & ((1 << kLow) - 1));
    const Sym y = zpix::decode_full(S.tab, (S.sorted >> t) & 1u, t, look);
    S.l2[i] = y.bad ? 0u : make_entry(y.len, y.sym, rt >> 3);
  }
}

// A symbol in an unbuilt pair, or whose entry is 0: its entry from the
// 16-bit lookahead, 0 for an invalid code.
__device__ __noinline__ uint32_t slow_entry(const EntropySmem& S, uint32_t role, int32_t look) {
  const int t = (role >> 16) & 7, ac = (role >> 19) & 1;
  const Sym y = zpix::decode_full(S.tab, (S.sorted >> t) & 1u, t, look);
  return y.bad ? 0u : make_entry(y.len, y.sym, ac);
}

// The entry of a symbol whose first-level entry e is not one: its
// second-level entry, 0 where every lookahead of e is invalid, or the
// full decode.  0 for an invalid code.
__device__ __forceinline__ uint32_t long_entry(const EntropySmem& S, uint32_t e, uint32_t role,
                                               uint32_t win) {
  if (e == kEntryBad) return 0;
  if (e & kEntryL2)
    return S.l2[(e & 0xFFFF) << (16 - kLookBits) | ((win >> 16) & ((1u << (16 - kLookBits)) - 1))];
  return slow_entry(S, role, static_cast<int32_t>(win >> 16));
}

// The stream as big-endian 32-bit words from a 4-byte aligned base: words
// [lo, lo + n) staged in shared memory (K1), the rest up to ``last`` (the
// last word holding a stream byte) from device memory, words past it 0 (no
// symbol that passes the read-past-buffer test reaches them).  A symbol's
// step reads the 32 bits at its position (a code of <= 16 bits and <= 16
// extend bits) as a funnel shift of two words: no buffer state, so the
// step's chain is two loads, a shift, the table load and an add.
struct Words {
  const uint32_t* g;
  const uint32_t* sm;  // staged words, already big-endian
  int32_t lo, n, last;
  __device__ __forceinline__ uint32_t global(int32_t i) const {
    return i >= 0 && i <= last ? __byte_perm(__ldg(g + i), 0, 0x0123) : 0u;
  }
  // the 32 bits from base bit q (q >= 0)
  __device__ __forceinline__ uint32_t window(int32_t q) const {
    const int32_t i = q >> 5, j = i - lo;
    uint32_t a, b;
    if (static_cast<uint32_t>(j) + 1u < static_cast<uint32_t>(n)) {
      a = sm[j];
      b = sm[j + 1];
    } else {
      a = global(i);
      b = global(i + 1);
    }
    return __funnelshift_l(b, a, q & 31);
  }
};

// Where a symbol at base bit q is read: below stream bit 0 the plain
// version's window reads from byte 0, at bit pos & 7.
__device__ __forceinline__ int32_t read_at(int32_t q, int32_t sh8) {
  return q < sh8 ? ((q - sh8) & 7) + sh8 : q;
}

// ---------------------------------------------------------------- K1

__global__ void __launch_bounds__(kIndexThreads)
    index_pass_kernel(const uint32_t* __restrict__ g, int sh8, int64_t cap,
                      const int32_t* __restrict__ seg_pos, const int32_t* __restrict__ seg_nmcu,
                      const int32_t* __restrict__ tables, int32_t* __restrict__ ends,
                      int32_t* ok, int n_lanes, int bpm, int nblk) {
  extern __shared__ __align__(16) uint8_t smem[];
  EntropySmem& S = *reinterpret_cast<EntropySmem*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + sizeof(EntropySmem));
  const int tid = threadIdx.x;
  const int l = blockIdx.x * kIndexLanes + tid;
  const bool walks = tid < kIndexLanes && l < n_lanes;
  const int32_t last = static_cast<int32_t>((cap - 1 + (sh8 >> 3)) >> 2);
  // the lane's segment, loaded under the table copy
  const int32_t p0 = walks ? seg_pos[l] : 0;
  const int64_t p1 = !walks ? 0 : l + 1 < n_lanes ? seg_pos[l + 1] : 8 * cap;
  const int nm = walks ? seg_nmcu[l] : 0;
  if (tid == 0) S.span_lo = INT32_MAX, S.span_hi = INT32_MIN;
  stage_tables(S, tables, bpm);
  // the CTA's span of stream words: its segments' starts to the next
  // segment's start (the stream's end for the last), and the words a
  // window there reads
  if (tid < kIndexLanes) {
    const int32_t lo = walks ? max(p0 + sh8, 0) >> 5 : INT32_MAX;
    const int32_t hi = walks ? static_cast<int32_t>(min((p1 + sh8) >> 5, int64_t(last)) + 3)
                             : INT32_MIN;
    const int32_t wlo = __reduce_min_sync(kFull, lo), whi = __reduce_max_sync(kFull, hi);
    if ((tid & 31) == 0 && wlo <= whi) {
      atomicMin(&S.span_lo, wlo);
      atomicMax(&S.span_hi, whi);
    }
  }
  __syncthreads();
  const int32_t lo = S.span_lo;
  const int32_t n = max(0, lo > S.span_hi ? 0 : min(min(S.span_hi, last + 1) - lo,
                                                     kIndexLanes * kStageWordsPerLane));
  for (int i = tid; i < n; i += kIndexThreads) zpix::cp_async4(stage + i, g + lo + i);
  zpix::cp_async_commit();
  build_lut(S);
  zpix::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < n; i += kIndexThreads) stage[i] = __byte_perm(stage[i], 0, 0x0123);
  __syncthreads();
  if (!walks) return;

  const Words W{g, stage, lo, n, last};
  const int32_t lim = static_cast<int32_t>(8 * (cap - 7)) + sh8;  // q >= lim: a read past
  // a window at q < lim_s reads two staged words; q >= fast_lo: stream bit >= 0
  const int32_t lim_s = min(lim, (lo + n - 1) * 32), fast_lo = max(lo * 32, sh8);
  int32_t q = p0 >= lim - sh8 ? lim : p0 + sh8;
  int32_t* row = ends + static_cast<int64_t>(l) * nblk;
  int slot = 0, mcu = 0, idx = 0, k = 0;
  int ns = bpm > 1 ? 1 : 0;
  uint32_t cur = S.role[0], acr = S.role[1], ndc = S.role[2 * ns], nac = S.role[2 * ns + 1];
  // One loop, a symbol a pass: a loop nested in it would hold the lanes
  // that leave it at its end until every lane of the warp has.
  while (mcu < nm && q < lim) {
    uint32_t win;
    if (q >= fast_lo && q < lim_s) {  // two staged words
      const int32_t j = (q >> 5) - lo;
      win = __funnelshift_l(stage[j + 1], stage[j], q & 31);
    } else {  // past the staged span, or below bit 0
      win = W.window(read_at(q, sh8));
    }
    uint32_t e = S.lut[(cur & 0xFFFF) + (win >> (32 - kLookBits))];
    if (entry_slow(e)) {
      e = long_entry(S, e, cur, win);
      if (e == 0) break;  // an invalid code
    }
    q += e & 511;
    k += (e >> 9) & 127;
    const bool done = k >= 64;  // the block ends here
    if (done) row[min(idx, nblk - 1)] = q - sh8;
    idx += done;
    k = done ? 0 : k;
    slot = done ? ns : slot;
    mcu += done && slot == 0;
    cur = done ? ndc : acr;
    acr = done ? nac : acr;
    if (done) {
      ns = slot + 1 == bpm ? 0 : slot + 1;
      ndc = S.role[2 * ns], nac = S.role[2 * ns + 1];
    }
  }
  for (int i = idx; i < nblk; ++i) row[i] = 0;  // blocks this lane did not reach
  if (mcu < nm) atomicAnd(ok, 0);  // a read past the buffer or an invalid code
}

// ---------------------------------------------------------------- K2

// A lane's block: where its symbols start, where K1 (or the host scan, or
// K19) says it ends, its slot, and whether it is a block of the segment
// (padding blocks are done at once).
struct Block {
  int32_t start, want;
  int slot;
  bool valid;
};

__device__ __forceinline__ Block block_at(int l, int n_lanes, const int32_t* seg_pos,
                                          const int32_t* seg_nmcu, const int32_t* ends,
                                          int bpm, int nblk) {
  Block b{0, 0, 0, false};
  if (l < n_lanes) {
    const int seg = static_cast<int>(static_cast<uint32_t>(l) / static_cast<uint32_t>(nblk));
    const int blk = l - seg * nblk;
    const int mcu = static_cast<int>(static_cast<uint32_t>(blk) / static_cast<uint32_t>(bpm));
    b.slot = blk - mcu * bpm;
    b.valid = mcu < seg_nmcu[seg];
    b.start = blk == 0 ? seg_pos[seg] : ends[l - 1];
    b.want = ends[l];
  }
  return b;
}

__global__ void __launch_bounds__(kValueThreads)
    value_pass_kernel(const uint32_t* __restrict__ g, int sh8, int64_t cap,
                      const int32_t* __restrict__ seg_pos, const int32_t* __restrict__ seg_nmcu,
                      const int32_t* __restrict__ tables, const int32_t* __restrict__ ends,
                      int16_t* __restrict__ ac, int32_t* __restrict__ dc, int32_t* ok,
                      int n_lanes, int bpm, int nblk) {
  extern __shared__ __align__(16) uint8_t smem[];
  EntropySmem& S = *reinterpret_cast<EntropySmem*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = kValueThreads >> 5;
  const int n_groups = (n_lanes + 31) >> 5;
  // the first group's blocks, loaded under the table build
  int grp = blockIdx.x * warps + warp;
  Block cb = block_at(grp * 32 + lane, n_lanes, seg_pos, seg_nmcu, ends, bpm, nblk);
  // the warp's 32 rows of 64 coefficients; piece p of row r at p ^ (r & 7)
  uint4* rows = reinterpret_cast<uint4*>(smem + sizeof(EntropySmem)) + warp * 32 * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) rows[j * 32 + lane] = make_uint4(0, 0, 0, 0);
  stage_tables(S, tables, bpm);
  __syncthreads();
  build_lut(S);
  __syncthreads();

  const Words W{g, nullptr, 0, 0, static_cast<int32_t>((cap - 1 + (sh8 >> 3)) >> 2)};
  const int32_t lim = static_cast<int32_t>(8 * (cap - 7)) + sh8;
  int16_t* my_row = reinterpret_cast<int16_t*>(rows) + lane * 64;
  const int sw = (lane & 7) << 3;
  for (; grp < n_groups; grp += gridDim.x * warps) {
    const int l = grp * 32 + lane;
    // the next group's blocks, loaded under this group's decode
    const Block nb = block_at(l + gridDim.x * warps * 32, n_lanes, seg_pos, seg_nmcu, ends,
                              bpm, nblk);
    int32_t dcv = 0;
    bool fail = false;
    if (cb.valid) {
      int32_t q = cb.start >= lim - sh8 ? lim : cb.start + sh8;
      uint32_t cur = S.role[2 * cb.slot];
      const uint32_t acr = S.role[2 * cb.slot + 1];
      bool err = false;
      int k = 0;  // 0: the DC symbol
      while (true) {  // <= 64 symbols: each one advances k or ends the block
        if (q >= lim) {
          err = true;
          break;
        }
        const uint32_t win = W.window(read_at(q, sh8));
        uint32_t e = S.lut[(cur & 0xFFFF) + (win >> (32 - kLookBits))];
        if (entry_slow(e)) {
          e = long_entry(S, e, cur, win);
          if (e == 0) {
            err = true;
            break;
          }
        }
        const int len = (e >> 16) & 31, size = (e >> 21) & 255, step = (e >> 9) & 127;
        if (size > 0) {  // RECEIVE + EXTEND, at most 16 bits (huffman.cuh)
          const int sz = min(size, 16), top = min(size - 1, 15);
          const uint32_t raw = (win << len) >> (32 - sz);
          const int32_t v = raw < (1u << top) ? static_cast<int32_t>(raw) - ((1 << sz) - 1)
                                              : static_cast<int32_t>(raw);
          if (k == 0)
            dcv = v;
          else
            my_row[S.unzig[min(k + step - 1, 63)] ^ sw] = static_cast<int16_t>(v);
        }
        q += e & 511;
        k += step;
        if (k >= 64) break;
        cur = acr;
      }
      // integrity: the block must end exactly where the index pass said
      fail = err || q - sh8 != cb.want;
    }
    if (l < n_lanes) dc[l] = dcv;
    if (__ballot_sync(kFull, fail) && lane == 0) atomicAnd(ok, 0);
    __syncwarp();
    // the 32 rows out as 4 KiB of 16-byte stores, zeroed behind
    const int64_t l0 = static_cast<int64_t>(grp) * 32;
    uint4* dst = reinterpret_cast<uint4*>(ac + l0 * 64);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 32 + lane, r = c >> 3, s = r * 8 + ((c & 7) ^ (r & 7));
      if (l0 + r < n_lanes) {
        dst[c] = rows[s];
        rows[s] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncwarp();
    cb = nb;
  }
}

// Dynamic shared memory past 48 KiB is allowed per device, by the
// kernel's attribute: set once for each device (``sms`` keeps the
// device's SM count once it is set; 0: not yet), on every launch past
// kMaxDevices.  -> the first error, and the SM count in ``n_sms``.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<int> (&sms)[zpix::kMaxDevices],
                       int& n_sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>* slot = dev < zpix::kMaxDevices ? &sms[dev] : nullptr;
  n_sms = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (n_sms == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (slot) slot->store(n_sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int zpix_index_pass(const void* stream, int64_t cap, const void* seg_pos,
                               const void* seg_nmcu, const void* tables, void* ends, void* ok,
                               int n_lanes, int bpm, int nblk, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (bpm < 1 || bpm > kMaxSlots || nblk < 1 || cap > kMaxStream)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes > 0) {
    constexpr int smem =
        static_cast<int>(sizeof(EntropySmem)) + kIndexLanes * kStageWordsPerLane * 4;
    static std::atomic<int> sms[zpix::kMaxDevices];
    int n_sms = 0;
    const cudaError_t e = allow_smem(index_pass_kernel, smem, sms, n_sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const uintptr_t a = reinterpret_cast<uintptr_t>(stream);
    index_pass_kernel<<<(n_lanes + kIndexLanes - 1) / kIndexLanes, kIndexThreads, smem,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
        reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3)), static_cast<int>(a & 3) * 8, cap,
        static_cast<const int32_t*>(seg_pos), static_cast<const int32_t*>(seg_nmcu),
        static_cast<const int32_t*>(tables), static_cast<int32_t*>(ends),
        static_cast<int32_t*>(ok), n_lanes, bpm, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The persistent grid: kValueCtasPerSm CTAs an SM, fewer where the blocks
// need fewer.
extern "C" int zpix_value_pass(const void* stream, int64_t cap, const void* seg_pos,
                               const void* seg_nmcu, const void* tables, const void* ends,
                               void* ac, void* dc, void* ok, int64_t n_lanes, int bpm, int nblk,
                               void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (bpm < 1 || bpm > kMaxSlots || nblk < 1 || cap > kMaxStream ||
      n_lanes >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes > 0) {
    constexpr int smem = static_cast<int>(sizeof(EntropySmem)) + kValueThreads * 128;
    static std::atomic<int> sms[zpix::kMaxDevices];
    int n_sms = 0;
    const cudaError_t e = allow_smem(value_pass_kernel, smem, sms, n_sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t groups = (n_lanes + 31) / 32, per_cta = kValueThreads / 32;
    const int64_t want = (groups + per_cta - 1) / per_cta;
    const int64_t most = static_cast<int64_t>(n_sms) * kValueCtasPerSm;
    const uintptr_t a = reinterpret_cast<uintptr_t>(stream);
    value_pass_kernel<<<static_cast<unsigned>(want < most ? want : most), kValueThreads, smem,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
        reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3)), static_cast<int>(a & 3) * 8, cap,
        static_cast<const int32_t*>(seg_pos), static_cast<const int32_t*>(seg_nmcu),
        static_cast<const int32_t*>(tables), static_cast<const int32_t*>(ends),
        static_cast<int16_t*>(ac), static_cast<int32_t*>(dc), static_cast<int32_t*>(ok),
        static_cast<int>(n_lanes), bpm, nblk);
  }
  return static_cast<int>(cudaGetLastError());
}
