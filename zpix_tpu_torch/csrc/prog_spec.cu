// K20 and K21: progressive DC-first and AC-first scans decoded on the card
// with no host index walk (OnchipProgressiveDecoder(impl="spec")), and
// K22, the sparse delta add of the spec path's host tail and of
// DeviceProgressiveDecoder.
//
// K20 replaces zpix_tpu/parallel/progressive_onchip.py::build_dc_first_fn
// (:363-538) with _run_dc_first's store write (:1288-1348); K21 replaces
// build_ac_first_fn (:541-797) with _run_ac_first's (:1350-1389).  Each
// image's scan is cut into chunks of ``chunk_bytes``; a chunk's lane
// decodes from an entry state to the first symbol boundary at or past its
// chunk's end: (bit, MCU slot) for a DC-first scan, one DC symbol plus its
// extend bits a block, the slot cycling through the MCU; (bit, k) for an
// AC-first scan, whose EOB runs resolve inside the chunk that reads them.
// Chunk c's entry is chunk c - 1's exit and chunk 0 enters at the image's
// start, so the entries are the serial decode's states at the chunk
// starts: unique, however found.  Here they are found by rounds to the
// fixed point inside one launch: a CTA an image, the chunks cut into
// contiguous runs a thread, every chunk scanned from a guess (its first
// bit, slot 0 or k = Ss), then rounds separated by __syncthreads in which
// only chunks whose entry changed scan again (a round after which no entry
// changed ends it; after r rounds the first r chunks are exact, so at most
// F + 1 rounds; the empty chunks past a shorter image's end take the exit
// of its last chunk at once).  Then an exclusive prefix of the chunks' counts over the
// CTA gives each chunk its first symbol's (K20) or block's (K21) index,
// and a last scan of every chunk from its entry writes the values:
// K20 the diffs into a scratch row, whose prefix along each component's
// chain (a thread a run of MCUs, a CTA prefix of three sums) sets
// coefficient 0 of each block to dc << Al; K21 each coefficient's
// ``val << Al`` added into its block's row (natural order) where the block
// ends inside the image and lies in the valid grid (zpix_tpu's value pass
// re-decodes each finished block from the index scan's offsets; the values
// are the same).  ``ok`` is cleared as zpix_tpu clears it (:510-532,
// :780-793): a chunk holding more than 4 * chunk_bytes symbols (K20) or
// finished blocks (K21), fewer symbols than blocks (K20) or fewer blocks
// than the valid grid (K21), a bad code (or a DC size > 16) earlier than
// 16 bits before the image's end, or rounds that did not settle.  Where
// ``ok`` is cleared on a chunk's count the store may differ from
// zpix_tpu's, whose records then overflow; every other result is the same.
// Symbols are decoded by decode_sym (huffman.cuh) on the tables staged in
// shared memory; bits come from a 64-bit window (BitWindow).
//
// Bound on the H100: a chunk's symbol chain times the rounds.  Each
// symbol's position depends on the one before, so a scan of a chunk is a
// serial chain of its symbols; the rounds repeat it where the guesses
// were wrong.  The bytes (the scan's stream read once, the store's rows
// written once) are far below that chain.  A CTA an image leaves most SMs
// idle at 16 images (PERF.md, K20 and K21).
//
// K22 replaces progressive.py::DeviceProgressiveDecoder._apply (:85-98)
// and the write-back of the host tail (progressive_onchip.py:2286-2294):
// state[b, idx[b, j]] += val[b, j] on an int32 [B, N] store, a thread an
// element, an atomicAdd each (padding entries add 0 at index 0 and can
// meet a real entry there).  Bound: bytes (the index and value read once,
// a 32-byte sector of the store read and written an element).
//
// Adds and shifts are done in uint32, so values wrap as XLA's int32 does.
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"

namespace {

using zpix::BitWindow;
using zpix::Sym;

constexpr int kThreads = 1024;  // a CTA an image
constexpr int32_t kNoErr = 0x7fffffff;
constexpr int kMaxGrids = 3;

// Per-chunk state in global scratch, int32 words.
enum { kEntBit, kEntSt, kExtBit, kExtSt, kCount, kAdv, kErr, kNeed, kChunkWords };

// A scan's geometry and buffers (passed by value).
struct Spec {
  const uint8_t* s;
  int64_t cap;  // stream bytes
  const int32_t* starts;
  const int32_t* ends;
  const int32_t* tab;
  int32_t* ok;
  int32_t* rounds;  // [B]
  int32_t* chunks;  // [B * F * kChunkWords]
  int32_t* diffs;   // K20: [B * nblk]
  int64_t* stamps;  // K20: [4] or null: image 0's CTA's phase ends on the card's clock
  int32_t* grid[kMaxGrids];
  int bv[kMaxGrids], bh[kMaxGrids], h[kMaxGrids], v[kMaxGrids];
  int batch, ngrids, F, cbits, mbc;
  int nblk;     // K20: symbols an image must hold; K21: the valid blocks
  int bpm;      // K20: blocks an MCU (1 for a single-component scan)
  int per_row;  // K20: MCUs a row (interleaved) or the valid width; K21: the valid width
  int ss, se, al;
};

__device__ __forceinline__ int64_t chunk_start(int32_t start, int32_t end, int c, int cbits) {
  const int64_t s = start + static_cast<int64_t>(c) * cbits;
  return s < end ? s : end;
}

// The chunk whose exit is chunk c's entry: c - 1, except past the image's
// non-empty chunks (the first ``full``), where every entry is the exit of
// the last non-empty one (an empty chunk's exit is its entry), so the
// tail of a shorter image settles in one round.
__device__ __forceinline__ int entry_source(int c, int full) {
  return c - 1 < full ? c - 1 : (full > 0 ? full - 1 : 0);
}

// The end bit of chunk c: its start plus cbits, clipped to the image's end.
__device__ __forceinline__ int32_t chunk_end(int32_t start, int32_t end, int c, int cbits) {
  const int64_t e = chunk_start(start, end, c, cbits) + cbits;
  return static_cast<int32_t>(e < end ? e : end);
}

// Exclusive prefix over the CTA of n <= 3 uint32 sums a thread (sh: 3 *
// kThreads words of shared memory); tot gets the totals.
__device__ void block_exscan(uint32_t* sh, int n, uint32_t* v, uint32_t* tot) {
  const int t = threadIdx.x;
  for (int i = 0; i < n; ++i) sh[i * kThreads + t] = v[i];
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    uint32_t a[3] = {0, 0, 0};
    for (int i = 0; i < n; ++i) a[i] = t >= off ? sh[i * kThreads + t - off] : 0u;
    __syncthreads();
    for (int i = 0; i < n; ++i) sh[i * kThreads + t] += a[i];
    __syncthreads();
  }
  for (int i = 0; i < n; ++i) {
    tot[i] = sh[i * kThreads + kThreads - 1];
    v[i] = sh[i * kThreads + t] - v[i];
  }
  __syncthreads();
}

struct Scan {
  int32_t bit, st, count, adv, err;
};

// K20's tables in shared memory: the packed tables and, for each DC table
// an MCU slot uses, a 10-bit lookahead table: lut[t][look >> 6] = len << 8
// | sym where every lookahead with those 10 bits decodes to one code of at
// most 10 bits, else 0 (decode_sym in full).  An entry is decode_sym's
// result for every lookahead it covers: a code's length is monotone in
// the lookahead, so where it agrees at both ends of the 64 it agrees
// between them.
constexpr int kLutBits = 10;
struct DcTabs {
  int32_t tab[zpix::kTabEntropyWords];
  uint16_t lut[8 << kLutBits];
};

__device__ void stage_dc(DcTabs& T, const Spec& p) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x) T.tab[i] = p.tab[i];
  __syncthreads();
  unsigned used = 0;
  for (int sl = 0; sl < p.bpm; ++sl) used |= 1u << (T.tab[zpix::kTabSlotDc + sl] & 7);
  for (int i = threadIdx.x; i < (8 << kLutBits); i += blockDim.x) {
    const int t = i >> kLutBits, look = (i & ((1 << kLutBits) - 1)) << (16 - kLutBits);
    uint16_t e = 0;
    if ((used >> t) & 1u) {
      const Sym lo = zpix::decode_sym(T.tab, t, look);
      const Sym hi = zpix::decode_sym(T.tab, t, look | ((1 << (16 - kLutBits)) - 1));
      if (!lo.bad && !hi.bad && lo.len == hi.len && lo.len <= kLutBits && lo.sym < 256) {
        e = static_cast<uint16_t>(lo.len << 8 | lo.sym);
      }
    }
    T.lut[i] = e;
  }
  __syncthreads();
}

// K20's lane: from (bit, slot) to the first symbol boundary at or past
// ce.  With ``rec``, the diff of its j-th symbol goes to rec[j] while
// first + j < lim.
__device__ Scan dc_scan(const Spec& p, const DcTabs& T, int32_t bit, int slot, int32_t ce,
                        int32_t* rec, int32_t first, int32_t lim) {
  BitWindow w{p.s, -(int64_t{1} << 40), 0};
  Scan r{bit, slot, 0, 0, kNoErr};
  while (r.bit < ce) {
    if ((r.bit >> 3) + 8 > p.cap) {  // never on a stacked batch: it ends in 64 zero bytes
      r.err = r.bit;
      break;
    }
    w.at(r.bit);
    const int t = T.tab[zpix::kTabSlotDc + r.st];
    const int32_t look = static_cast<int32_t>(w.bits(r.bit, 16));
    const unsigned e = T.lut[((t & 7) << kLutBits) | (look >> (16 - kLutBits))];
    Sym y{static_cast<int>(e >> 8), static_cast<int>(e & 255), false};
    if (e == 0) y = zpix::decode_sym(T.tab, t, look);
    if (y.bad || y.sym > 16) {
      r.err = r.bit;
      break;
    }
    if (rec != nullptr && first + r.count < lim) {
      rec[r.count] = zpix::receive_extend(w, r.bit + y.len, y.sym);
    }
    ++r.count;
    r.st = r.st + 1 == p.bpm ? 0 : r.st + 1;
    r.bit += y.len + y.sym;
  }
  return r;
}

// K21's lane: from (bit, k) to the first symbol boundary at or past ce,
// with _make_ac_sym_step's rules (progressive_onchip.py:277-312).  With
// ``img_rows`` (image b's valid block g at img_rows + (g / nvx * bh + g %
// nvx) * 64), each coefficient's val << Al is added into its block's row
// while the block's index (first + blocks passed) is below lim.
__device__ Scan ac_scan(const Spec& p, const int32_t* tab, int t, int32_t bit, int k,
                        int32_t ce, int32_t* img_rows, int32_t first, int32_t lim) {
  BitWindow w{p.s, -(int64_t{1} << 40), 0};
  Scan r{bit, k, 0, 0, kNoErr};
  while (r.bit < ce) {
    if ((r.bit >> 3) + 8 > p.cap) {
      r.err = r.bit;
      break;
    }
    w.at(r.bit);
    const Sym y = zpix::decode_sym(tab, t, static_cast<int32_t>(w.bits(r.bit, 16)));
    if (y.bad) {
      r.err = r.bit;
      break;
    }
    const int run = y.sym >> 4, size = y.sym & 15;
    const int k2 = r.st + run;
    int consume, new_k, skips = 0;
    bool done;
    if (size == 0 && run < 15) {  // EOB: this block and (1 << run | bits) - 1 more
      const int extra = run > 0 ? static_cast<int>(w.bits(r.bit + y.len, run)) : 0;
      skips = ((1 << run) | extra) - 1;
      consume = y.len + run;
      new_k = r.st;
      done = true;
    } else if (size == 0) {  // ZRL
      consume = y.len;
      new_k = r.st + 16;
      done = new_k > p.se;
    } else if (k2 > p.se) {  // overflow: the block ends on the code bits
      consume = y.len;
      new_k = r.st;
      done = true;
    } else {
      consume = y.len + size;
      new_k = k2 + 1;
      done = new_k > p.se;
      const int32_t g = first + r.adv;
      if (img_rows != nullptr && g < lim) {
        const int32_t by = g / p.per_row;
        int32_t* row = img_rows + (static_cast<int64_t>(by) * p.bh[0] + (g - by * p.per_row)) * 64;
        const int32_t val = zpix::receive_extend(w, r.bit + y.len, size);
        const int nat = zpix::kUnzig[k2];
        row[nat] = static_cast<int32_t>(static_cast<uint32_t>(row[nat]) +
                                        (static_cast<uint32_t>(val) << p.al));
      }
    }
    r.bit += consume;
    if (done) {
      ++r.count;
      r.adv += 1 + skips;
      r.st = p.ss;
    } else {
      r.st = new_k;
    }
  }
  return r;
}

// K21: rounds to the fixed point of image b's chunk entries; every thread
// owns chunks [c0, c1).  Returns whether the entries settled; the chunks' words
// then hold the exits, counts and errors of a scan from their entries.
__device__ bool converge_ac(const Spec& p, const int32_t* tab, int b, int c0, int c1,
                            int32_t* rounds) {
  int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  const int full = static_cast<int>((static_cast<int64_t>(end) - start + p.cbits - 1) / p.cbits);
  const int t_ac = tab[zpix::kTabSlotAc];
  for (int c = c0; c < c1; ++c) {
    int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    q[kEntBit] = static_cast<int32_t>(chunk_start(start, end, c, p.cbits));
    q[kEntSt] = p.ss;
    q[kNeed] = 1;
  }
  __syncthreads();
  int r = 0;
  bool settled = false;
  while (true) {
    for (int c = c0; c < c1; ++c) {
      int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
      if (!q[kNeed]) continue;
      const int32_t ce = chunk_end(start, end, c, p.cbits);
      const Scan s = ac_scan(p, tab, t_ac, q[kEntBit], q[kEntSt], ce, nullptr, 0, 0);
      q[kExtBit] = s.bit;
      q[kExtSt] = s.st;
      q[kCount] = s.count;
      q[kAdv] = s.adv;
      q[kErr] = s.err;
      q[kNeed] = 0;
    }
    __syncthreads();
    int changed = 0;
    for (int c = c0 > 0 ? c0 : 1; c < c1; ++c) {
      const int32_t* prev = base + static_cast<int64_t>(entry_source(c, full)) * kChunkWords;
      int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
      if (prev[kExtBit] != q[kEntBit] || prev[kExtSt] != q[kEntSt]) {
        q[kEntBit] = prev[kExtBit];
        q[kEntSt] = prev[kExtSt];
        q[kNeed] = 1;
        changed = 1;
      }
    }
    ++r;
    if (!__syncthreads_or(changed)) {
      settled = true;
      break;
    }
    if (r > p.F + 2) break;
  }
  if (threadIdx.x == 0) rounds[b] = r;
  return settled;
}

// The chunk checks of ok and the prefix of the counts (and, K21, the
// block advances): -> (first index of each thread's first chunk) in
// first[0..1], the image's totals in tot[0..1]; bad is this thread's
// failure.
__device__ void chunk_totals(const Spec& p, const int32_t* base, int32_t end, int c0, int c1,
                             uint32_t* sh, uint32_t* first, uint32_t* tot, int* bad) {
  uint32_t v[3] = {0, 0, 0};
  for (int c = c0; c < c1; ++c) {
    const int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    v[0] += static_cast<uint32_t>(q[kCount]);
    v[1] += static_cast<uint32_t>(q[kAdv]);
    if (q[kCount] > p.mbc) *bad = 1;
    if (q[kErr] != kNoErr && q[kErr] < end - 16) *bad = 1;
  }
  block_exscan(sh, 2, v, tot);
  first[0] = v[0];
  first[1] = v[1];
}

// ---------------------------------------------- K20: guesses, links, resolve
//
// A DC-first state is (bit, slot), packed bit << 8 | slot.  L = B * F
// chunks, W = 2 bpm candidates a chunk.  Chunk c's candidates: v < bpm the
// guess exits of chunk c - 1 (X[v][c - 1]: chunk c - 1 scanned from its
// first bit at slot v); bpm + u a candidate put in (X[bpm + u][c - 1]);
// chunk 0's only candidate is the image's start at slot 0 (its guess 0's
// scan).  Y[v][c], n[v][c], e[v][c]: chunk c scanned from candidate v
// (exit, symbols, first bad bit); links[c][v]: the candidate of chunk
// c + 1 equal to Y[v][c], or kMiss.
struct DcLinks {
  uint64_t* X;    // [W, L]
  uint64_t* Y;    // [W, L]
  int32_t* n;     // [W, L]
  int32_t* e;     // [W, L]
  uint8_t* links;  // [L, W]
};

constexpr int kLinkThreads = 256;
constexpr int kMaxCols = 32;  // W for 16 blocks an MCU
constexpr uint8_t kMiss = 0xFF;

__device__ __forceinline__ uint64_t pack_st(int32_t bit, int st) {
  return static_cast<uint64_t>(static_cast<uint32_t>(bit)) << 8 | static_cast<uint32_t>(st);
}

__device__ __forceinline__ int image_full(const Spec& p, int32_t start, int32_t end) {
  return static_cast<int>((static_cast<int64_t>(end) - start + p.cbits - 1) / p.cbits);
}

// The first of xs[0 .. n) equal to z, or kMiss.
__device__ __forceinline__ uint8_t find_link(const uint64_t* xs, int n, uint64_t z) {
  for (int u = 0; u < n; ++u) {
    if (xs[u] == z) return static_cast<uint8_t>(u);
  }
  return kMiss;
}

// A block: chunks [l0, l0 + G) of the batch, with the guesses of the chunk
// before and the chunk after them; a thread a (chunk, slot guess), a
// chunk's bpm guesses in adjacent threads.  Each guess scans its chunk;
// each distinct candidate of an owned chunk (the guess exits of the chunk
// before) scans it and is linked to its guess exits; each distinct exit
// that matches none is put in as the next chunk's candidate bpm + u (u its
// first candidate), scanned and linked at once.
__global__ void __launch_bounds__(kLinkThreads) dc_guess_link_kernel(Spec p, DcLinks q) {
  __shared__ DcTabs T;
  __shared__ uint64_t sx[kLinkThreads], sy[kLinkThreads], yv[kLinkThreads];
  __shared__ int32_t sn[kLinkThreads], se[kLinkThreads], yn[kLinkThreads], ye[kLinkThreads];
  const int bpm = p.bpm, W = 2 * bpm, tid = threadIdx.x;
  const int G = kLinkThreads / bpm - 2;
  const int64_t L = static_cast<int64_t>(p.batch) * p.F;
  const int gi = tid / bpm, v = tid - gi * bpm;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * G - 1 + gi;
  const bool active = gi <= G + 1 && lane >= 0 && lane < L;
  const bool owner = active && gi >= 1 && gi <= G;
  stage_dc(T, p);
  int c = 0, full = 0;
  int32_t start = 0, end = 0;
  if (active) {
    const int img = static_cast<int>(lane / p.F);
    c = static_cast<int>(lane - static_cast<int64_t>(img) * p.F);
    start = p.starts[img];
    end = p.ends[img];
    full = image_full(p, start, end);
  }
  // the guesses
  if (active) {
    const Scan s = dc_scan(p, T, static_cast<int32_t>(chunk_start(start, end, c, p.cbits)), v,
                           chunk_end(start, end, c, p.cbits), nullptr, 0, 0);
    sx[tid] = pack_st(s.bit, s.st);
    sn[tid] = s.count;
    se[tid] = s.err;
    if (owner) q.X[v * L + lane] = sx[tid];
  }
  __syncthreads();
  // the first of each set of equal candidates scans the chunk from it
  const bool linked = owner && c >= 1 && c < full;
  int lead = v;
  if (linked) {
    const uint64_t x = sx[(gi - 1) * bpm + v];
    lead = find_link(sx + (gi - 1) * bpm, v, x);
    if (lead == kMiss) {
      lead = v;
      const Scan s = dc_scan(p, T, static_cast<int32_t>(x >> 8), static_cast<int>(x & 255),
                             chunk_end(start, end, c, p.cbits), nullptr, 0, 0);
      sy[tid] = pack_st(s.bit, s.st);
      yn[tid] = s.count;
      ye[tid] = s.err;
    }
  }
  __syncthreads();
  uint8_t r = kMiss;
  uint64_t y = 0;
  if (linked) {
    const int ls = gi * bpm + lead;
    y = sy[ls];
    if (c + 1 < full) r = find_link(sx + gi * bpm, bpm, y);
    q.Y[v * L + lane] = y;
    q.n[v * L + lane] = yn[ls];
    q.e[v * L + lane] = ye[ls];
  } else if (owner && c == 0 && v == 0) {  // the image's start: guess 0's scan
    q.Y[lane] = sx[tid];
    q.n[lane] = sn[tid];
    q.e[lane] = se[tid];
    r = 0;
  }
  yv[tid] = y;
  __syncthreads();
  // each distinct missed exit put in as the next chunk's candidate bpm + u
  const bool missed = linked && c + 1 < full && r == kMiss;
  int u = v;
  if (missed) {
    u = find_link(yv + gi * bpm, v, y);
    if (u == kMiss) {
      u = v;
      const Scan s = dc_scan(p, T, static_cast<int32_t>(y >> 8), static_cast<int>(y & 255),
                             chunk_end(start, end, c + 1, p.cbits), nullptr, 0, 0);
      const uint64_t z = pack_st(s.bit, s.st);
      const int64_t col = (bpm + v) * L;
      q.X[col + lane] = y;
      q.Y[col + lane + 1] = z;
      q.n[col + lane + 1] = s.count;
      q.e[col + lane + 1] = s.err;
      q.links[(lane + 1) * W + bpm + v] =
          c + 2 < full ? find_link(sx + (gi + 1) * bpm, bpm, z) : kMiss;
    }
  }
  if (!owner) return;
  q.links[lane * W + v] = missed ? static_cast<uint8_t>(bpm + u) : r;
  // put-in columns this thread did not fill: of the next chunk, and of
  // an image's first chunk
  if (c + 1 < p.F && !(missed && u == v)) q.links[(lane + 1) * W + bpm + v] = kMiss;
  if (c == 0) q.links[lane * W + bpm + v] = kMiss;
}

// Image b's resolve, by one warp: each chunk's candidate on the true path
// (t_1 = 0, t_{c+1} = links[c][t_c]) -> every chunk's entry, symbols and
// first bad bit in the chunk words; -> the misses (chunks entered by a
// candidate put in).  The links of chunks 1 .. J - 1 are composed in 32
// parts, a lane a part, and the parts walked in turn; where the path
// meets a miss, the warp puts its exit in as the next chunk's candidate
// bpm, scans that chunk and walks on (a part whose column bpm changed so
// is walked link by link).
__device__ int dc_resolve(const Spec& p, const DcTabs& T, const DcLinks& q, int b,
                          uint8_t (*comp)[kMaxCols + 1], uint8_t* part_in) {
  const int bpm = p.bpm, W = 2 * bpm, lane = threadIdx.x & 31;
  const int64_t L = static_cast<int64_t>(p.batch) * p.F, base = static_cast<int64_t>(b) * p.F;
  const int32_t start = p.starts[b], end = p.ends[b];
  const int J = image_full(p, start, end) - 1;  // the image's last non-empty chunk
  const uint8_t* lk = q.links + base * W;
  const int steps = J - 1;
  const int per = steps > 0 ? (steps + 31) / 32 : 0;
  const int js = 1 + lane * per, je = min(js + per, J);
  if (js < je) {
    int t[kMaxCols];
#pragma unroll
    for (int x = 0; x < kMaxCols; ++x) t[x] = x;
    for (int j = js; j < je; ++j) {
#pragma unroll
      for (int x = 0; x < kMaxCols; ++x) {
        if (x < W && t[x] != kMiss) t[x] = lk[j * W + t[x]];
      }
    }
#pragma unroll
    for (int x = 0; x < kMaxCols; ++x) {
      if (x < W) comp[lane][x] = static_cast<uint8_t>(t[x]);
    }
  }
  __syncwarp();
  int cur = 0, changed = -1;
  for (int pt = 0; pt < 32; ++pt) {
    const int ps = 1 + pt * per, pe = min(ps + per, J);
    if (ps >= pe) break;
    if (lane == 0) part_in[pt] = static_cast<uint8_t>(cur);
    if (changed < ps && comp[pt][cur] != kMiss) {
      cur = comp[pt][cur];
      continue;
    }
    for (int j = ps; j < pe; ++j) {
      int nx = lk[j * W + cur];
      if (nx == kMiss) {  // chunk j + 1 enters at Y[cur][j], no candidate: put it in
        const uint64_t e = q.Y[cur * L + base + j];
        const Scan s = dc_scan(p, T, static_cast<int32_t>(e >> 8), static_cast<int>(e & 255),
                               chunk_end(start, end, j + 1, p.cbits), nullptr, 0, 0);
        const uint64_t z = pack_st(s.bit, s.st);
        uint8_t r = kMiss;
        if (j + 2 <= J) {
          for (int u = 0; u < bpm && r == kMiss; ++u) {
            if (q.X[u * L + base + j + 1] == z) r = static_cast<uint8_t>(u);
          }
        }
        __syncwarp();
        if (lane == 0) {
          q.X[bpm * L + base + j] = e;
          q.links[(base + j) * W + cur] = static_cast<uint8_t>(bpm);
          q.Y[bpm * L + base + j + 1] = z;
          q.n[bpm * L + base + j + 1] = s.count;
          q.e[bpm * L + base + j + 1] = s.err;
          q.links[(base + j + 1) * W + bpm] = r;
        }
        __syncwarp();
        changed = j + 1;
        nx = bpm;
      }
      cur = nx;
    }
  }
  __syncwarp();
  // each chunk's entry from its candidate: a lane a part, then chunks 0, J
  // and those past J
  int32_t* words = p.chunks + base * kChunkWords;
  int misses = 0;
  auto put = [&](int j, int tj) {
    int32_t* w = words + static_cast<int64_t>(j) * kChunkWords;
    const uint64_t x = q.X[tj * L + base + j - 1];
    w[kEntBit] = static_cast<int32_t>(x >> 8);
    w[kEntSt] = static_cast<int>(x & 255);
    w[kCount] = q.n[tj * L + base + j];
    w[kErr] = q.e[tj * L + base + j];
    misses += tj >= bpm;
  };
  if (js < je) {
    int cc = part_in[lane];
    for (int j = js; j < je; ++j) {
      put(j, cc);
      cc = lk[j * W + cc];
    }
  }
  uint64_t last = pack_st(start, 0);  // the exit of chunk J (the start where J < 0)
  if (J >= 1) {
    if (lane == 0) put(J, cur);
    last = q.Y[cur * L + base + J];
  } else if (J == 0) {
    last = q.Y[base];
  }
  if (lane == 0) {
    words[kEntBit] = start;
    words[kEntSt] = 0;
    words[kCount] = J >= 0 ? q.n[base] : 0;
    words[kErr] = J >= 0 ? q.e[base] : kNoErr;
  }
  const int32_t lb = static_cast<int32_t>(last >> 8);
  for (int j = max(J + 1, 1) + lane; j < p.F; j += 32) {
    int32_t* w = words + static_cast<int64_t>(j) * kChunkWords;
    w[kEntBit] = lb;
    w[kEntSt] = static_cast<int>(last & 255);
    w[kCount] = 0;
    w[kErr] = lb < end ? lb : kNoErr;  // a scan stopped early stops there again
  }
  for (int off = 16; off; off >>= 1) misses += __shfl_xor_sync(0xffffffffu, misses, off);
  return misses;
}

// With p.stamps, image 0's CTA notes the card's clock (ns) at its start and
// after its resolve, record scan and chains' prefix.
__device__ __forceinline__ void dc_stamp(const Spec& p, int i) {
  if (p.stamps == nullptr) return;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    uint64_t ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    p.stamps[i] = static_cast<int64_t>(ns);
  }
}

__global__ void __launch_bounds__(kThreads) dc_first_spec_kernel(Spec p, DcLinks links) {
  __shared__ DcTabs T;
  __shared__ uint32_t sh[3 * kThreads];
  __shared__ uint8_t comp[32][kMaxCols + 1];
  __shared__ uint8_t part_in[32];
  const int b = blockIdx.x, t = threadIdx.x;
  dc_stamp(p, 0);
  stage_dc(T, p);
  int32_t* diffs = p.diffs + static_cast<int64_t>(b) * p.nblk;
  for (int i = t; i < p.nblk; i += kThreads) diffs[i] = 0;  // symbols past the image's total
  if (t < 32) {
    const int misses = dc_resolve(p, T, links, b, comp, part_in);
    if (t == 0) p.rounds[b] = misses;
  }
  __syncthreads();
  dc_stamp(p, 1);
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  const int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  uint32_t first[2], tot[2];
  int bad = 0;
  chunk_totals(p, base, end, c0, c1, sh, first, tot, &bad);
  if (static_cast<int64_t>(tot[0]) < p.nblk) bad = 1;
  // the record scan: every chunk again from its entry, diffs at their index
  uint32_t j = first[0];
  for (int c = c0; c < c1; ++c) {
    const int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    const int32_t ce = chunk_end(start, end, c, p.cbits);
    if (static_cast<int64_t>(j) < p.nblk) {
      dc_scan(p, T, q[kEntBit], q[kEntSt], ce, diffs + j, static_cast<int32_t>(j), p.nblk);
    }
    j += static_cast<uint32_t>(q[kCount]);
  }
  if (__syncthreads_or(bad) && t == 0) *p.ok = 0;
  dc_stamp(p, 2);
  // the prefix along each component's chain, coefficient 0 = dc << Al:
  // a thread a run of MCUs, the CTA's prefix of the three chains' sums
  const int n_mcu = p.nblk / p.bpm;
  const int per_m = (n_mcu + kThreads - 1) / kThreads;
  const int m0 = min(n_mcu, t * per_m), m1 = min(n_mcu, m0 + per_m);
  int comp_of_slot[16], slot0[kMaxGrids];
  int s = 0;
  for (int g = 0; g < p.ngrids; ++g) {
    slot0[g] = s;
    const int nb = p.ngrids > 1 ? p.h[g] * p.v[g] : 1;
    for (int i = 0; i < nb && s < 16; ++i) comp_of_slot[s++] = g;
  }
  uint32_t sums[3] = {0, 0, 0}, totc[3];
  for (int m = m0; m < m1; ++m) {
    for (int sl = 0; sl < p.bpm; ++sl) {
      sums[comp_of_slot[sl]] += static_cast<uint32_t>(diffs[static_cast<int64_t>(m) * p.bpm + sl]);
    }
  }
  block_exscan(sh, p.ngrids, sums, totc);
  for (int m = m0; m < m1; ++m) {
    const int my = m / p.per_row, mx = m - my * p.per_row;
    for (int sl = 0; sl < p.bpm; ++sl) {
      const int g = comp_of_slot[sl], jj = sl - slot0[g];
      const int hh = p.ngrids > 1 ? p.h[g] : 1, vv = p.ngrids > 1 ? p.v[g] : 1;
      sums[g] += static_cast<uint32_t>(diffs[static_cast<int64_t>(m) * p.bpm + sl]);
      const int by = my * vv + jj / hh, bx = mx * hh + jj % hh;
      int32_t* row = p.grid[g] + ((static_cast<int64_t>(b) * p.bv[g] + by) * p.bh[g] + bx) * 64;
      row[0] = static_cast<int32_t>(sums[g] << p.al);
    }
  }
  dc_stamp(p, 3);
}

__global__ void __launch_bounds__(kThreads) ac_first_spec_kernel(Spec p) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  __shared__ uint32_t sh[3 * kThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < zpix::kTabEntropyWords; i += kThreads) tab[i] = p.tab[i];
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  const bool settled = converge_ac(p, tab, b, c0, c1, p.rounds);
  const int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  uint32_t first[2], tot[2];
  int bad = settled ? 0 : 1;
  chunk_totals(p, base, end, c0, c1, sh, first, tot, &bad);
  if (static_cast<int64_t>(tot[1]) < p.nblk) bad = 1;
  // blocks below lim ended inside the image and lie in the valid grid
  const int32_t lim = static_cast<int64_t>(tot[1]) < p.nblk ? static_cast<int32_t>(tot[1])
                                                             : p.nblk;
  int32_t* img_rows = p.grid[0] + static_cast<int64_t>(b) * p.bv[0] * p.bh[0] * 64;
  const int t_ac = tab[zpix::kTabSlotAc];
  uint32_t g = first[1];
  for (int c = c0; c < c1; ++c) {
    const int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    const int32_t ce = chunk_end(start, end, c, p.cbits);
    if (static_cast<int64_t>(g) < lim) {
      ac_scan(p, tab, t_ac, q[kEntBit], q[kEntSt], ce, img_rows, static_cast<int32_t>(g), lim);
    }
    g += static_cast<uint32_t>(q[kAdv]);
  }
  if (__syncthreads_or(bad) && t == 0) *p.ok = 0;
}

__global__ void delta_add_kernel(int32_t* __restrict__ state, const int32_t* __restrict__ idx,
                                 const int32_t* __restrict__ val, int64_t n, int k, int64_t N) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t v = val[i];
    const int32_t j = idx[i];
    if (v != 0 && j >= 0 && j < N) {
      atomicAdd(reinterpret_cast<unsigned*>(state + (i / k) * N + j), static_cast<unsigned>(v));
    }
  }
}

}  // namespace

// ------------------------------------------------------------ C entry points

namespace {

int spec_launch(bool ac, const void* s, int64_t cap, const void* starts, const void* ends,
                const void* tab, void* ok, void* rounds, void* chunks, void* diffs, void* g0,
                void* g1, void* g2, const DcLinks* links, void* stamps, int batch, int F,
                int cbits, int mbc, int nblk, int bpm, int ngrids, int per_row, const int* hv,
                const int* bh, const int* bv, int ss, int se, int al, void* stream) {
  if (ngrids < 1 || ngrids > kMaxGrids || bpm < 1 || bpm > 16 || al < 0 || al > 31 ||
      F < 1 || cbits < 8 || per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spec p{};
  p.s = static_cast<const uint8_t*>(s);
  p.cap = cap;
  p.starts = static_cast<const int32_t*>(starts);
  p.ends = static_cast<const int32_t*>(ends);
  p.tab = static_cast<const int32_t*>(tab);
  p.ok = static_cast<int32_t*>(ok);
  p.rounds = static_cast<int32_t*>(rounds);
  p.chunks = static_cast<int32_t*>(chunks);
  p.diffs = static_cast<int32_t*>(diffs);
  p.stamps = static_cast<int64_t*>(stamps);
  void* grids[3] = {g0, g1, g2};
  for (int g = 0; g < ngrids; ++g) {
    p.grid[g] = static_cast<int32_t*>(grids[g]);
    p.h[g] = hv[g] & 15;
    p.v[g] = hv[g] >> 4;
    p.bh[g] = bh[g];
    p.bv[g] = bv[g];
  }
  p.batch = batch;
  p.ngrids = ngrids;
  p.F = F;
  p.cbits = cbits;
  p.mbc = mbc;
  p.nblk = nblk;
  p.bpm = bpm;
  p.per_row = per_row;
  p.ss = ss;
  p.se = se;
  p.al = al;
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch > 0) {
    if (ac) {
      ac_first_spec_kernel<<<batch, kThreads, 0, st>>>(p);
    } else {
      const int64_t L = static_cast<int64_t>(batch) * F;
      const int G = kLinkThreads / bpm - 2;
      dc_guess_link_kernel<<<static_cast<unsigned>((L + G - 1) / G), kLinkThreads, 0, st>>>(
          p, *links);
      if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
      dc_first_spec_kernel<<<batch, kThreads, 0, st>>>(p, *links);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K20's scratch besides ``chunks``: X and Y uint64 [W, B * F], n and e
// int32 [W, B * F], links u8 [B * F, W], W = 2 bpm (nothing to fill);
// stamps int64 [4] or null.  Two kernels: the guesses and links, then a CTA
// an image.
extern "C" int zpix_spec_dc_first(const void* s, int64_t cap, const void* starts,
                                  const void* ends, const void* tab, void* ok, void* rounds,
                                  void* chunks, void* X, void* Y, void* n, void* e, void* links,
                                  void* diffs, void* g0, void* g1, void* g2, void* stamps,
                                  int batch, int F, int cbits, int mbc, int nblk, int bpm,
                                  int ngrids, int per_row, int hv0, int hv1, int hv2, int bh0,
                                  int bh1, int bh2, int bv0, int bv1, int bv2, int al,
                                  void* stream) {
  const int hv[3] = {hv0, hv1, hv2}, bh[3] = {bh0, bh1, bh2}, bv[3] = {bv0, bv1, bv2};
  const DcLinks q{static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y), static_cast<int32_t*>(n),
                  static_cast<int32_t*>(e), static_cast<uint8_t*>(links)};
  return spec_launch(false, s, cap, starts, ends, tab, ok, rounds, chunks, diffs, g0, g1, g2, &q,
                     stamps, batch, F, cbits, mbc, nblk, bpm, ngrids, per_row, hv, bh, bv, 0, 0,
                     al, stream);
}

extern "C" int zpix_spec_ac_first(const void* s, int64_t cap, const void* starts,
                                  const void* ends, const void* tab, void* ok, void* rounds,
                                  void* chunks, void* grid, int batch, int F, int cbits, int mbc,
                                  int nvalid, int nvx, int bh, int bv, int ss, int se, int al,
                                  void* stream) {
  if (ss < 1 || ss > se || se > 63) return static_cast<int>(cudaErrorInvalidValue);
  const int hv[3] = {0x11, 0, 0}, bhs[3] = {bh, 0, 0}, bvs[3] = {bv, 0, 0};
  return spec_launch(true, s, cap, starts, ends, tab, ok, rounds, chunks, nullptr, grid,
                     nullptr, nullptr, nullptr, nullptr, batch, F, cbits, mbc, nvalid, 1, 1, nvx,
                     hv, bhs, bvs, ss, se, al, stream);
}

extern "C" int zpix_delta_add(void* state, const void* idx, const void* val, int64_t n, int k,
                              int64_t N, int grid, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    delta_add_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(state), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(val), n, k, N);
  }
  return static_cast<int>(cudaGetLastError());
}
