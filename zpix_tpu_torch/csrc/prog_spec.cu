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
// starts: unique, however found.  Both kernels find them by one scheme,
// written once over a lane's step (guess_link and resolve, a template
// over DcStep or AcStep): every chunk is scanned from its first bit at
// each guess (K20: every MCU slot; K21: k = Ss, which every EOB brings
// back), the guess exits of chunk c - 1 are chunk c's candidates, each
// scanned and linked to the equal guess exit of chunk c, each distinct
// exit that matches none put in as chunk c + 1's candidate and scanned
// (blocks over the batch); then a warp an image walks the links from
// chunk 0 (composed in 32 parts) and puts in, scanning, any exit the path
// meets that has no candidate (the misses).  Then each chunk's first
// symbol's (K20) or block's (K21) index is the exclusive prefix of the
// counts before it, and a last scan of every chunk from its entry writes
// the values: K20 (a CTA an image, after its resolve warp) the diffs into
// a scratch row, whose prefix along each component's chain (a thread a run
// of MCUs, a CTA prefix of three sums) sets coefficient 0 of each block to
// dc << Al; K21 each coefficient's ``val << Al`` added (a RED) into its
// block's row (natural order) where the block ends inside the image and
// lies in the valid grid (zpix_tpu's value pass re-decodes each finished
// block from the index scan's offsets; the values are the same).
//
// K21 decodes every AC-first scan of the spec prefix in one call: they
// write disjoint bands and never coefficient 0, so they commute with one
// another and with the DC scans (and with a RED, even overlapping bands
// add as the scans in turn would).  A table in device memory gives each
// scan its stream, starts, ends, tables, grid, geometry and band and its
// first lane and blocks; the lanes of all scans share one grid.  Three
// kernels: guesses and links (a block one scan's chunks, its AC table and
// a 10-bit lookahead table in shared memory; a chunk's candidate scan
// stops where it meets the chunk's guess path, Trace); resolve and prefix
// (a warp an (image, scan): the path, then each chunk's first block index
// and the checks); record (a thread a chunk over the whole batch).
//
// ``ok`` is cleared as zpix_tpu clears it (:510-532, :780-793): a chunk
// holding more than 4 * chunk_bytes symbols (K20) or finished blocks
// (K21), fewer symbols than blocks (K20) or fewer blocks than the valid
// grid (K21), or a bad code (or a DC size > 16) earlier than 16 bits
// before the image's end.  Where ``ok`` is cleared on a chunk's count the
// store may differ from zpix_tpu's, whose records then overflow; every
// other result is the same.  Symbols are decoded through the lookahead
// table, by decode_sym (huffman.cuh) on a miss; K20's bits come from a
// 64-bit window (BitWindow), K21's from two big-endian stream words in
// registers, a funnel shift a symbol (K9's step).
//
// Bound on the H100: a chunk's symbol chain.  Each symbol's position
// depends on the one before, so a scan of a chunk is a serial chain of its
// symbols; the guess and the record scan a chunk once each, a candidate
// (K20) or its prefix up to the guess's path (K21), and a put-in where the
// guess missed.  The bytes (the scan's stream read once, the store's rows
// written once) are far below that chain; the batch's chunks fill few of
// the card's SMs (7,040 chunks on the bench's AC-first scans), so a chunk's
// chain sets the time.
//
// K22 replaces progressive.py::DeviceProgressiveDecoder._apply (:85-98)
// and the write-back of the host tail (progressive_onchip.py:2286-2294):
// state[b, idx[b, j]] += val[b, j] on int32 [B, N] stores, for every
// update of a decode in one launch.  A segment table gives each update
// its store, indices, values, N, k and first tile; a CTA takes 4,096
// pairs of one row (one division a CTA, none an element), reads them in
// 16-byte loads where indices and values share an alignment, skips value
// 0 (the padding) and adds by a RED (two updates of one decode may hit one
// coefficient), a warp's lanes on neighbouring pairs (the 16-byte loads go
// through shared memory, so that each RED instruction covers 32 adjacent
// pairs: sorted indices, few sectors).  Bound: bytes (the index and value
// read once, a 32-byte sector of the store read and written an element).
//
// Adds and shifts are done in uint32, so values wrap as XLA's int32 does.
#include <cuda_runtime.h>

#include <cstdint>

#include "fast_div.cuh"
#include "huffman.cuh"
#include "timing.cuh"

namespace {

using zpix::BitWindow;
using zpix::Sym;

constexpr int kThreads = 1024;  // K20's record: a CTA an image
constexpr int32_t kNoErr = 0x7fffffff;
constexpr int kMaxGrids = 3;

// Per-chunk state in global scratch, int32 words: the entry, its scan's
// counts and first bad bit, and K21's first block index.
enum { kEntBit, kEntSt, kCount, kAdv, kErr, kFirst, kChunkWords };

// A scan's geometry and buffers (passed by value).
struct Spec {
  const uint8_t* s;
  int64_t cap;  // stream bytes
  const int32_t* starts;
  const int32_t* ends;
  const int32_t* tab;
  int32_t* ok;
  int32_t* rounds;  // [B] misses
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
  // K21: the stream as big-endian words from the 4-byte aligned address at
  // or below s (sh8: s's bit in word 0), the first bit whose symbol would
  // read past the buffer ((bit >> 3) + 8 > cap), the division by per_row
  const uint32_t* w32;
  int sh8;
  int32_t past;
  zpix::FastDiv row_div;
};

__device__ __forceinline__ int64_t chunk_start(int32_t start, int32_t end, int c, int cbits) {
  const int64_t s = start + static_cast<int64_t>(c) * cbits;
  return s < end ? s : end;
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

// Lookahead tables: lut[look >> 6] = len << 8 | sym where every 16-bit
// lookahead with those 10 bits decodes to one code of at most 10 bits,
// else 0 (decode_sym in full).  An entry is decode_sym's result for every
// lookahead it covers: a code's length is monotone in the lookahead, so
// where it agrees at both ends of the 64 it agrees between them.
constexpr int kLutBits = 10;

__device__ __forceinline__ uint16_t lut_entry(const int32_t* tab, int t, int i) {
  const int look = i << (16 - kLutBits);
  const Sym lo = zpix::decode_sym(tab, t, look);
  const Sym hi = zpix::decode_sym(tab, t, look | ((1 << (16 - kLutBits)) - 1));
  return !lo.bad && !hi.bad && lo.len == hi.len && lo.len <= kLutBits && lo.sym < 256
             ? static_cast<uint16_t>(lo.len << 8 | lo.sym)
             : 0;
}

// The symbol at ``look`` of table t: by the lookahead table where it has
// the code (lut may be null), else by decode_sym.
__device__ __forceinline__ Sym lookup(const int32_t* tab, const uint16_t* lut, int t,
                                      int32_t look) {
  const unsigned e = lut != nullptr ? lut[look >> (16 - kLutBits)] : 0u;
  if (e != 0) return Sym{static_cast<int>(e >> 8), static_cast<int>(e & 255), false};
  return zpix::decode_sym(tab, t, look);
}

// K20's tables in shared memory: the packed tables and a lookahead table
// for each DC table an MCU slot uses (lut + (t << kLutBits)).
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
    const int t = i >> kLutBits;
    T.lut[i] = (used >> t) & 1u ? lut_entry(T.tab, t, i & ((1 << kLutBits) - 1)) : 0;
  }
  __syncthreads();
}

// K21's tables in shared memory: the packed tables, the lookahead table of
// the scan's AC table, the natural index of each zigzag position.
struct AcTabs {
  int32_t tab[zpix::kTabEntropyWords];
  uint16_t lut[1 << kLutBits];
  uint8_t unzig[64];
};

__device__ void stage_ac(AcTabs& T, const int32_t* tab) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x) T.tab[i] = tab[i];
  if (threadIdx.x < 64) T.unzig[threadIdx.x] = static_cast<uint8_t>(zpix::kUnzig[threadIdx.x]);
  __syncthreads();
  const int t = T.tab[zpix::kTabSlotAc] & 7;
  for (int i = threadIdx.x; i < (1 << kLutBits); i += blockDim.x) T.lut[i] = lut_entry(T.tab, t, i);
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
    const int t = T.tab[zpix::kTabSlotDc + r.st] & 7;
    const Sym y =
        lookup(T.tab, T.lut + (t << kLutBits), t, static_cast<int32_t>(w.bits(r.bit, 16)));
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

// A guess's path through its chunk, noted in shared memory by the thread
// that scans it: its first kMarks block starts (bit and blocks passed;
// the first is its entry, k = Ss, and the i-th follows i finished blocks)
// and its result.  A scan of the same chunk that comes to one of those
// block starts follows the guess from there on, so it stops there with
// the guess's exit and counts less the guess's there.  A guess falls onto
// the true path at the first block end it decodes in step (an EOB resets
// k): on the bench's content within 8 block starts in 97% of chunks and
// 16 in all but 2 of 830, a few symbols.
constexpr int kMarks = 12;
struct Trace {
  int32_t* mk;  // block start i: bit at mk[i * stride], blocks passed at mk[(kMarks + i) * stride]
  int stride, n;
  Scan end;
};

__device__ __forceinline__ void put_mark(Trace& t, const Scan& r) {
  if (t.n < kMarks) {
    t.mk[t.n * t.stride] = r.bit;
    t.mk[(kMarks + t.n) * t.stride] = r.adv;
  }
  ++t.n;
}

// A scan at a block start r.bit against the guess's block starts from
// ``*j`` on (ascending): where it meets one, r becomes the scan's result.
__device__ __forceinline__ bool meet_mark(const Trace& t, Scan& r, int* j) {
  const int n = t.n < kMarks ? t.n : kMarks;
  while (*j < n && t.mk[*j * t.stride] < r.bit) ++*j;
  if (*j >= n || t.mk[*j * t.stride] != r.bit) return false;
  r.count += t.end.count - *j;
  r.adv += t.end.adv - t.mk[(kMarks + *j) * t.stride];
  r.bit = t.end.bit;
  r.st = t.end.st;
  r.err = t.end.err;
  return true;
}

// A scan's AC table: the packed tables, the lookahead table (or null), the
// natural index of each zigzag position (recording scans), the table.
struct AcCode {
  const int32_t* tab;
  const uint16_t* lut;
  const uint8_t* unzig;
  int t;
};

// Adds val << Al at zigzag position k of image block g: ``img_rows`` holds
// block g at (g / nvx * bh + g % nvx) * 64, ``row`` caches block ``row_g``.
__device__ __forceinline__ void add_coef(const Spec& p, const uint8_t* unzig, int32_t* img_rows,
                                         int32_t g, int k, int32_t val, int32_t& row_g,
                                         int32_t*& row) {
  if (g != row_g) {
    const int32_t by = static_cast<int32_t>(p.row_div.div(static_cast<uint32_t>(g)));
    row = img_rows + (static_cast<int64_t>(by) * p.bh[0] + (g - by * p.per_row)) * 64;
    row_g = g;
  }
  atomicAdd(reinterpret_cast<unsigned*>(row + unzig[k]), static_cast<unsigned>(val) << p.al);
}

__device__ __forceinline__ uint32_t word_be(const uint32_t* g, int32_t j) {
  return __byte_perm(__ldg(g + j), 0, 0x0123);
}

// RECEIVE + EXTEND (T.81 F.2.2.1) of ``size`` (1 .. 15) bits, right-aligned.
__device__ __forceinline__ int32_t extend(uint32_t raw, int size) {
  return raw < (1u << (size - 1)) ? static_cast<int32_t>(raw) - ((1 << size) - 1)
                                  : static_cast<int32_t>(raw);
}

// K21's lane: from (bit, k) to the first symbol boundary at or past ce,
// with _make_ac_sym_step's rules (progressive_onchip.py:277-312).  A step
// reads the 32 bits at its position (a code of <= 16 bits and <= 15 more)
// as a funnel shift of two stream words kept in registers (K9's step).
// With ``img_rows``, each coefficient's val << Al is added into its block
// (add_coef) while the block's index (first + blocks passed) is below lim.
// ``put``: note the path's block starts (Trace; its end is the caller's);
// ``meet``: stop where the path meets the noted one.
__device__ Scan ac_scan(const Spec& p, const AcCode& C, int32_t bit, int k, int32_t ce,
                        int32_t* img_rows = nullptr, int32_t first = 0, int32_t lim = 0,
                        Trace* put = nullptr, const Trace* meet = nullptr) {
  Scan r{bit, k, 0, 0, kNoErr};
  int32_t row_g = -1;
  int32_t* row = nullptr;
  int j = 0;  // meet's next block start
  int32_t wj = -2;  // the word in w0
  uint32_t w0 = 0, w1 = 0;
  if (put != nullptr) {
    put->n = 0;
    put_mark(*put, r);
  }
  if (meet != nullptr && k == p.ss && meet_mark(*meet, r, &j)) return r;
  while (r.bit < ce) {
    if (r.bit >= p.past) {
      r.err = r.bit;
      break;
    }
    const int32_t q = r.bit + p.sh8;
    if ((q >> 5) != wj) {  // a step moves at most 31 bits: mostly the next word
      w0 = (q >> 5) == wj + 1 ? w1 : word_be(p.w32, q >> 5);
      wj = q >> 5;
      w1 = word_be(p.w32, wj + 1);
    }
    const uint32_t win = __funnelshift_l(w1, w0, q & 31);
    const Sym y = lookup(C.tab, C.lut, C.t, static_cast<int32_t>(win >> 16));
    if (y.bad) {
      r.err = r.bit;
      break;
    }
    const int run = y.sym >> 4, size = y.sym & 15;
    const int k2 = r.st + run;
    int consume, new_k, skips = 0;
    bool done;
    if (size == 0 && run < 15) {  // EOB: this block and (1 << run | bits) - 1 more
      const int extra = run > 0 ? static_cast<int>((win << y.len) >> (32 - run)) : 0;
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
        add_coef(p, C.unzig, img_rows, g, k2, extend((win << y.len) >> (32 - size), size), row_g,
                 row);
      }
    }
    r.bit += consume;
    if (done) {
      ++r.count;
      r.adv += 1 + skips;
      r.st = p.ss;
      if (put != nullptr) put_mark(*put, r);
      if (meet != nullptr && meet_mark(*meet, r, &j)) break;
    } else {
      r.st = new_k;
    }
  }
  return r;
}

// K20's chunk checks of ok and the prefix of the counts: -> (first index
// of each thread's first chunk) in first[0], the image's total in tot[0];
// bad is this thread's failure.
__device__ void chunk_totals(const Spec& p, const int32_t* base, int32_t end, int c0, int c1,
                             uint32_t* sh, uint32_t* first, uint32_t* tot, int* bad) {
  uint32_t v[3] = {0, 0, 0};
  for (int c = c0; c < c1; ++c) {
    const int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    v[0] += static_cast<uint32_t>(q[kCount]);
    if (q[kCount] > p.mbc) *bad = 1;
    if (q[kErr] != kNoErr && q[kErr] < end - 16) *bad = 1;
  }
  block_exscan(sh, 1, v, tot);
  first[0] = v[0];
}

// ------------------------------------ guesses, links, resolve: K20 and K21
//
// A state is packed bit << 8 | st (st: K20's MCU slot, K21's k).  A Step
// is a lane's scan: ``guesses()`` states tried at each chunk's first bit,
// ``guess(v)`` the v-th (guess 0 is the image's start state), ``first(v,
// bit, ce)`` a chunk's scan from guess v, ``from(bit, st, ce)`` the same
// thread's scan of that chunk from a candidate (after ``first``),
// ``scan(bit, st, ce)`` any scan; ``kAdvances``: whether its scans pass
// blocks (K21's a and kAdv).  L lanes of a scan (B * F), ng guesses, W = 2 ng candidates a
// chunk.  Chunk c's candidates: v < ng the guess exits of chunk c - 1
// (X[v][c - 1]: chunk c - 1 scanned from its first bit at guess v); ng + u
// a candidate put in (X[ng + u][c - 1]); chunk 0's only candidate is the
// image's start (its guess 0's scan).  Y[v][c], n[v][c], a[v][c], e[v][c]:
// chunk c scanned from candidate v (exit, count, blocks passed, first bad
// bit); links[c][v]: the candidate of chunk c + 1 equal to Y[v][c], or
// kMiss.  The arrays start at the scan's first lane; L is their column
// stride (every lane of the call).
struct Links {
  uint64_t* X;     // [W, L]
  uint64_t* Y;     // [W, L]
  int32_t* n;      // [W, L]
  int32_t* a;      // [W, L]
  int32_t* e;      // [W, L]
  uint8_t* links;  // [L, W]
  int64_t L;
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

struct DcStep {
  static constexpr int kCols = kMaxCols;
  static constexpr bool kAdvances = false;
  const Spec& p;
  const DcTabs& T;
  __device__ int guesses() const { return p.bpm; }
  __device__ int guess(int v) const { return v; }
  __device__ Scan scan(int32_t bit, int st, int32_t ce) const {
    return dc_scan(p, T, bit, st, ce, nullptr, 0, 0);
  }
  __device__ Scan first(int v, int32_t bit, int32_t ce) { return scan(bit, v, ce); }
  __device__ Scan from(int32_t bit, int st, int32_t ce) const { return scan(bit, st, ce); }
};

// K21's step: its guess notes its block starts (Trace, in shared memory,
// a column a thread), and its candidate scan stops where it meets the
// guess's path.
struct AcStep {
  static constexpr int kCols = 2;
  static constexpr bool kAdvances = true;
  const Spec& p;
  AcCode C;
  Trace tr;
  __device__ int guesses() const { return 1; }
  __device__ int guess(int) const { return p.ss; }
  __device__ Scan scan(int32_t bit, int st, int32_t ce) const { return ac_scan(p, C, bit, st, ce); }
  __device__ Scan first(int, int32_t bit, int32_t ce) {
    tr.end = ac_scan(p, C, bit, p.ss, ce, nullptr, 0, 0, &tr);
    return tr.end;
  }
  __device__ Scan from(int32_t bit, int st, int32_t ce) const {
    return ac_scan(p, C, bit, st, ce, nullptr, 0, 0, nullptr, &tr);
  }
};

// Block blk of a scan: chunks [blk G, + G) of its lanes, G = kLinkThreads
// / ng - 2, with the guesses of the chunk before and the chunk after them;
// a thread a (chunk, guess), a chunk's ng guesses in adjacent threads.
// Each guess scans its chunk; each distinct candidate of an owned chunk
// (the guess exits of the chunk before) scans it and is linked to its
// guess exits; each distinct exit that matches none is put in as the next
// chunk's candidate ng + u (u its first candidate), scanned and linked at
// once.
template <class Step>
__device__ void guess_link(Step& S, const Spec& p, const Links& q, int64_t blk) {
  __shared__ uint64_t sx[kLinkThreads], sy[kLinkThreads], yv[kLinkThreads];
  __shared__ int32_t sn[kLinkThreads], sa[kLinkThreads], se[kLinkThreads];
  __shared__ int32_t yn[kLinkThreads], ya[kLinkThreads], ye[kLinkThreads];
  const int ng = S.guesses(), W = 2 * ng, tid = threadIdx.x;
  const int G = kLinkThreads / ng - 2;
  const int64_t Ls = static_cast<int64_t>(p.batch) * p.F, L = q.L;
  const int gi = tid / ng, v = tid - gi * ng;
  const int64_t lane = blk * G - 1 + gi;
  const bool active = gi <= G + 1 && lane >= 0 && lane < Ls;
  const bool owner = active && gi >= 1 && gi <= G;
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
    const Scan s = S.first(v, static_cast<int32_t>(chunk_start(start, end, c, p.cbits)),
                           chunk_end(start, end, c, p.cbits));
    sx[tid] = pack_st(s.bit, s.st);
    sn[tid] = s.count;
    sa[tid] = s.adv;
    se[tid] = s.err;
    if (owner) q.X[v * L + lane] = sx[tid];
  }
  __syncthreads();
  // the first of each set of equal candidates scans the chunk from it
  const bool linked = owner && c >= 1 && c < full;
  int lead = v;
  if (linked) {
    const uint64_t x = sx[(gi - 1) * ng + v];
    lead = find_link(sx + (gi - 1) * ng, v, x);
    if (lead == kMiss) {
      lead = v;
      const Scan s = S.from(static_cast<int32_t>(x >> 8), static_cast<int>(x & 255),
                            chunk_end(start, end, c, p.cbits));
      sy[tid] = pack_st(s.bit, s.st);
      yn[tid] = s.count;
      ya[tid] = s.adv;
      ye[tid] = s.err;
    }
  }
  __syncthreads();
  uint8_t r = kMiss;
  uint64_t y = 0;
  if (linked) {
    const int ls = gi * ng + lead;
    y = sy[ls];
    if (c + 1 < full) r = find_link(sx + gi * ng, ng, y);
    q.Y[v * L + lane] = y;
    q.n[v * L + lane] = yn[ls];
    if constexpr (Step::kAdvances) q.a[v * L + lane] = ya[ls];
    q.e[v * L + lane] = ye[ls];
  } else if (owner && c == 0 && v == 0) {  // the image's start: guess 0's scan
    q.Y[lane] = sx[tid];
    q.n[lane] = sn[tid];
    if constexpr (Step::kAdvances) q.a[lane] = sa[tid];
    q.e[lane] = se[tid];
    r = 0;
  }
  yv[tid] = y;
  __syncthreads();
  // each distinct missed exit put in as the next chunk's candidate ng + u
  const bool missed = linked && c + 1 < full && r == kMiss;
  int u = v;
  if (missed) {
    u = find_link(yv + gi * ng, v, y);
    if (u == kMiss) {
      u = v;
      const Scan s = S.scan(static_cast<int32_t>(y >> 8), static_cast<int>(y & 255),
                            chunk_end(start, end, c + 1, p.cbits));
      const uint64_t z = pack_st(s.bit, s.st);
      const int64_t col = (ng + v) * L;
      q.X[col + lane] = y;
      q.Y[col + lane + 1] = z;
      q.n[col + lane + 1] = s.count;
      if constexpr (Step::kAdvances) q.a[col + lane + 1] = s.adv;
      q.e[col + lane + 1] = s.err;
      q.links[(lane + 1) * W + ng + v] =
          c + 2 < full ? find_link(sx + (gi + 1) * ng, ng, z) : kMiss;
    }
  }
  if (!owner) return;
  q.links[lane * W + v] = missed ? static_cast<uint8_t>(ng + u) : r;
  // put-in columns this thread did not fill: of the next chunk, and of
  // an image's first chunk
  if (c + 1 < p.F && !(missed && u == v)) q.links[(lane + 1) * W + ng + v] = kMiss;
  if (c == 0) q.links[lane * W + ng + v] = kMiss;
}

// Image b's resolve, by one warp: each chunk's candidate on the true path
// (t_1 = 0, t_{c+1} = links[c][t_c]) -> every chunk's entry, count, blocks
// passed and first bad bit in the chunk words; -> the misses (chunks
// entered by a candidate put in).  The links of chunks 1 .. J - 1 are
// composed in 32 parts, a lane a part, and the parts walked in turn; where
// the path meets a miss, the warp puts its exit in as the next chunk's
// candidate ng, scans that chunk and walks on (a part whose column ng
// changed so is walked link by link).
template <class Step>
__device__ int resolve(const Step& S, const Spec& p, const Links& q, int b,
                       uint8_t (*comp)[Step::kCols + 1], uint8_t* part_in) {
  constexpr int kCols = Step::kCols;
  const int ng = S.guesses(), W = 2 * ng, lane = threadIdx.x & 31;
  const int64_t L = q.L, base = static_cast<int64_t>(b) * p.F;
  const int32_t start = p.starts[b], end = p.ends[b];
  const int J = image_full(p, start, end) - 1;  // the image's last non-empty chunk
  const uint8_t* lk = q.links + base * W;
  const int steps = J - 1;
  const int per = steps > 0 ? (steps + 31) / 32 : 0;
  const int js = 1 + lane * per, je = min(js + per, J);
  if (js < je) {
    int t[kCols];
#pragma unroll
    for (int x = 0; x < kCols; ++x) t[x] = x;
    for (int j = js; j < je; ++j) {
#pragma unroll
      for (int x = 0; x < kCols; ++x) {
        if (x < W && t[x] != kMiss) t[x] = lk[j * W + t[x]];
      }
    }
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
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
        const Scan s = S.scan(static_cast<int32_t>(e >> 8), static_cast<int>(e & 255),
                              chunk_end(start, end, j + 1, p.cbits));
        const uint64_t z = pack_st(s.bit, s.st);
        uint8_t r = kMiss;
        if (j + 2 <= J) {
          for (int u = 0; u < ng && r == kMiss; ++u) {
            if (q.X[u * L + base + j + 1] == z) r = static_cast<uint8_t>(u);
          }
        }
        __syncwarp();
        if (lane == 0) {
          q.X[ng * L + base + j] = e;
          q.links[(base + j) * W + cur] = static_cast<uint8_t>(ng);
          q.Y[ng * L + base + j + 1] = z;
          q.n[ng * L + base + j + 1] = s.count;
          if constexpr (Step::kAdvances) q.a[ng * L + base + j + 1] = s.adv;
          q.e[ng * L + base + j + 1] = s.err;
          q.links[(base + j + 1) * W + ng] = r;
        }
        __syncwarp();
        changed = j + 1;
        nx = ng;
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
    if constexpr (Step::kAdvances) w[kAdv] = q.a[tj * L + base + j];
    w[kErr] = q.e[tj * L + base + j];
    misses += tj >= ng;
  };
  if (js < je) {
    int cc = part_in[lane];
    for (int j = js; j < je; ++j) {
      put(j, cc);
      cc = lk[j * W + cc];
    }
  }
  uint64_t last = pack_st(start, S.guess(0));  // the exit of chunk J (the start where J < 0)
  if (J >= 1) {
    if (lane == 0) put(J, cur);
    last = q.Y[cur * L + base + J];
  } else if (J == 0) {
    last = q.Y[base];
  }
  if (lane == 0) {
    words[kEntBit] = start;
    words[kEntSt] = S.guess(0);
    words[kCount] = J >= 0 ? q.n[base] : 0;
    if constexpr (Step::kAdvances) words[kAdv] = J >= 0 ? q.a[base] : 0;
    words[kErr] = J >= 0 ? q.e[base] : kNoErr;
  }
  const int32_t lb = static_cast<int32_t>(last >> 8);
  for (int j = max(J + 1, 1) + lane; j < p.F; j += 32) {
    int32_t* w = words + static_cast<int64_t>(j) * kChunkWords;
    w[kEntBit] = lb;
    w[kEntSt] = static_cast<int>(last & 255);
    w[kCount] = 0;
    if constexpr (Step::kAdvances) w[kAdv] = 0;
    w[kErr] = lb < end ? lb : kNoErr;  // a scan stopped early stops there again
  }
  for (int off = 16; off; off >>= 1) misses += __shfl_xor_sync(0xffffffffu, misses, off);
  return misses;
}

// ---------------------------------------------------------------------- K20

__global__ void __launch_bounds__(kLinkThreads) dc_guess_link_kernel(Spec p, Links q) {
  __shared__ DcTabs T;
  stage_dc(T, p);
  DcStep S{p, T};
  guess_link(S, p, q, blockIdx.x);
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

__global__ void __launch_bounds__(kThreads) dc_first_spec_kernel(Spec p, Links links) {
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
    const int misses = resolve(DcStep{p, T}, p, links, b, comp, part_in);
    if (t == 0) p.rounds[b] = misses;
  }
  __syncthreads();
  dc_stamp(p, 1);
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  const int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  uint32_t first[1], tot[1];
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

// ---------------------------------------------------------------------- K21
//
// The call's scans: int64 words a scan in device memory (pointers as
// integers), written by ops/prog_spec.py::_ac_first_cuda.
enum {
  kSStream, kSCap, kSStarts, kSEnds, kSTab, kSGrid, kSF, kSNvalid, kSNvx, kSBh, kSBv, kSSs,
  kSSe, kSAl, kSLane0, kSLinkBlk0, kSRecBlk0, kSDivMagic, kSDivShift, kScanWords
};

struct Group {
  const int64_t* scans;  // [nscans, kScanWords]
  int32_t* ok;
  int32_t* misses;  // [nscans, batch]
  int32_t* lims;    // [nscans, batch]: blocks written (the valid blocks or fewer)
  int32_t* chunks;  // [lanes, kChunkWords]
  int nscans, batch, cbits, mbc;
};

__device__ Spec scan_spec(const Group& g, int s) {
  const int64_t* w = g.scans + static_cast<int64_t>(s) * kScanWords;
  Spec p{};
  p.s = reinterpret_cast<const uint8_t*>(w[kSStream]);
  p.cap = w[kSCap];
  p.starts = reinterpret_cast<const int32_t*>(w[kSStarts]);
  p.ends = reinterpret_cast<const int32_t*>(w[kSEnds]);
  p.tab = reinterpret_cast<const int32_t*>(w[kSTab]);
  p.ok = g.ok;
  p.rounds = g.misses + static_cast<int64_t>(s) * g.batch;
  p.chunks = g.chunks + w[kSLane0] * kChunkWords;
  p.grid[0] = reinterpret_cast<int32_t*>(w[kSGrid]);
  p.bh[0] = static_cast<int>(w[kSBh]);
  p.bv[0] = static_cast<int>(w[kSBv]);
  p.h[0] = p.v[0] = 1;
  p.batch = g.batch;
  p.ngrids = 1;
  p.F = static_cast<int>(w[kSF]);
  p.cbits = g.cbits;
  p.mbc = g.mbc;
  p.nblk = static_cast<int>(w[kSNvalid]);
  p.bpm = 1;
  p.per_row = static_cast<int>(w[kSNvx]);
  p.ss = static_cast<int>(w[kSSs]);
  p.se = static_cast<int>(w[kSSe]);
  p.al = static_cast<int>(w[kSAl]);
  const uintptr_t at = reinterpret_cast<uintptr_t>(p.s);
  p.w32 = reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
  p.sh8 = static_cast<int>(at & 3) * 8;
  p.past = p.cap >= 8 ? static_cast<int32_t>((p.cap - 7) * 8) : 0;
  p.row_div = zpix::FastDiv{static_cast<uint32_t>(w[kSDivMagic]), static_cast<int>(w[kSDivShift])};
  return p;
}

// The scan whose blocks (first block in word ``word``) hold this block.
__device__ __forceinline__ int block_scan(const Group& g, int word) {
  int s = 0;
  while (s + 1 < g.nscans && g.scans[(s + 1) * kScanWords + word] <= blockIdx.x) ++s;
  return s;
}

__device__ __forceinline__ Links links_at(Links q, int64_t lane0) {
  q.X += lane0;
  q.Y += lane0;
  q.n += lane0;
  q.a += lane0;
  q.e += lane0;
  q.links += lane0 * 2;  // W = 2: one guess a chunk
  return q;
}

__global__ void __launch_bounds__(kLinkThreads) ac_guess_link_kernel(Group g, Links q) {
  __shared__ AcTabs T;
  const int s = block_scan(g, kSLinkBlk0);
  const int64_t* w = g.scans + static_cast<int64_t>(s) * kScanWords;
  const Spec p = scan_spec(g, s);
  stage_ac(T, p.tab);
  __shared__ int32_t marks[2 * kMarks * kLinkThreads];
  AcStep S{p, AcCode{T.tab, T.lut, nullptr, T.tab[zpix::kTabSlotAc] & 7},
           Trace{marks + threadIdx.x, kLinkThreads, 0, Scan{}}};
  guess_link(S, p, links_at(q, w[kSLane0]), blockIdx.x - w[kSLinkBlk0]);
}

// A warp an (image, scan): the resolve (its put-ins decode by decode_sym on
// the tables in device memory), then each chunk's first block index (a
// lane a run of chunks, a warp prefix in 64 bits), the checks of ok, the
// image's block limit and misses.
__global__ void __launch_bounds__(32) ac_resolve_kernel(Group g, Links q) {
  __shared__ uint8_t comp[32][AcStep::kCols + 1];
  __shared__ uint8_t part_in[32];
  const int s = blockIdx.x / g.batch, b = blockIdx.x - s * g.batch, lane = threadIdx.x;
  const int64_t* w = g.scans + static_cast<int64_t>(s) * kScanWords;
  const Spec p = scan_spec(g, s);
  const AcStep S{p, AcCode{p.tab, nullptr, nullptr, p.tab[zpix::kTabSlotAc] & 7}, {}};
  const int misses = resolve(S, p, links_at(q, w[kSLane0]), b, comp, part_in);
  __syncwarp();
  int32_t* words = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t end = p.ends[b];
  const int per = (p.F + 31) / 32;
  const int c0 = min(p.F, lane * per), c1 = min(p.F, c0 + per);
  uint64_t sum = 0;
  bool bad = false;
  for (int c = c0; c < c1; ++c) {
    const int32_t* x = words + static_cast<int64_t>(c) * kChunkWords;
    sum += static_cast<uint64_t>(static_cast<uint32_t>(x[kAdv]));
    bad |= x[kCount] > p.mbc || (x[kErr] != kNoErr && x[kErr] < end - 16);
  }
  uint64_t incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const uint64_t total = __shfl_sync(0xffffffffu, incl, 31);
  uint64_t run = incl - sum;
  for (int c = c0; c < c1; ++c) {
    int32_t* x = words + static_cast<int64_t>(c) * kChunkWords;
    x[kFirst] = static_cast<int32_t>(run < 0x7fffffffu ? run : 0x7fffffffu);
    run += static_cast<uint32_t>(x[kAdv]);
  }
  bad |= total < static_cast<uint64_t>(p.nblk);
  if (lane == 0) {
    p.rounds[b] = misses;
    g.lims[static_cast<int64_t>(s) * g.batch + b] =
        static_cast<int32_t>(total < static_cast<uint64_t>(p.nblk) ? total : p.nblk);
  }
  if (__any_sync(0xffffffffu, bad) && lane == 0) *g.ok = 0;
}

// A thread a chunk, over every scan's lanes (a block one scan's): the
// chunk scanned from its entry, its coefficients added into the blocks
// below the image's limit.
constexpr int kRecThreads = 128;

__global__ void __launch_bounds__(kRecThreads) ac_record_kernel(Group g) {
  __shared__ AcTabs T;
  const int s = block_scan(g, kSRecBlk0);
  const int64_t* w = g.scans + static_cast<int64_t>(s) * kScanWords;
  const Spec p = scan_spec(g, s);
  stage_ac(T, p.tab);
  const int64_t lane = (blockIdx.x - w[kSRecBlk0]) * kRecThreads + threadIdx.x;
  if (lane >= static_cast<int64_t>(p.batch) * p.F) return;
  const int b = static_cast<int>(lane / p.F), c = static_cast<int>(lane - int64_t{b} * p.F);
  const int32_t* x = p.chunks + lane * kChunkWords;
  const int32_t lim = g.lims[static_cast<int64_t>(s) * g.batch + b], first = x[kFirst];
  if (first >= lim) return;
  int32_t* img_rows = p.grid[0] + static_cast<int64_t>(b) * p.bv[0] * p.bh[0] * 64;
  ac_scan(p, AcCode{T.tab, T.lut, T.unzig, T.tab[zpix::kTabSlotAc] & 7}, x[kEntBit], x[kEntSt],
          chunk_end(p.starts[b], p.ends[b], c, p.cbits), img_rows, first, lim);
}

// ---------------------------------------------------------------------- K22
//
// Int64 words a segment (an update: int32 state [B, N], idx and val [B, k]),
// written by ops/prog_spec.py::delta_add_segments; the segments' tiles in
// order, kDeltaTile pairs of one row a tile.
enum { kDState, kDIdx, kDVal, kDN, kDK, kDTilesRow, kDTile0, kDeltaWords };
constexpr int kDeltaThreads = 256, kDeltaTile = 4096;

__device__ __forceinline__ void delta_one(uint32_t* st, int64_t N, int32_t j, int32_t v) {
  if (v != 0 && j >= 0 && j < N) atomicAdd(st + j, static_cast<uint32_t>(v));
}

__global__ void __launch_bounds__(kDeltaThreads) delta_add_kernel(const int64_t* __restrict__ segs,
                                                                 int nseg) {
  __shared__ int4 si[kDeltaTile / 4], sv[kDeltaTile / 4];
  int s = 0;
  while (s + 1 < nseg && segs[(s + 1) * kDeltaWords + kDTile0] <= blockIdx.x) ++s;
  const int64_t* w = segs + static_cast<int64_t>(s) * kDeltaWords;
  const int64_t N = w[kDN], k = w[kDK], tpr = w[kDTilesRow];
  const int64_t local = blockIdx.x - w[kDTile0], row = local / tpr;
  const int64_t j0 = (local - row * tpr) * kDeltaTile, j1 = min(j0 + kDeltaTile, k);
  const int32_t* ip = reinterpret_cast<const int32_t*>(w[kDIdx]) + row * k;
  const int32_t* vp = reinterpret_cast<const int32_t*>(w[kDVal]) + row * k;
  uint32_t* st = reinterpret_cast<uint32_t*>(w[kDState]) + row * N;
  // where indices and values share an alignment: a head up to it, the
  // body by 16-byte loads into shared memory, a tail; else pair by pair
  int64_t a = j1, nvec = 0;
  if (((reinterpret_cast<uintptr_t>(ip) ^ reinterpret_cast<uintptr_t>(vp)) & 15) == 0) {
    const int64_t head = ((16 - (reinterpret_cast<uintptr_t>(ip + j0) & 15)) & 15) / 4;
    a = min(j0 + head, j1);
    nvec = (j1 - a) / 4;
  }
  const int4* iv = reinterpret_cast<const int4*>(ip + a);
  const int4* vv = reinterpret_cast<const int4*>(vp + a);
  for (int64_t u = threadIdx.x; u < nvec; u += kDeltaThreads) {
    si[u] = __ldg(iv + u);
    sv[u] = __ldg(vv + u);
  }
  for (int64_t j = j0 + threadIdx.x; j < a; j += kDeltaThreads) delta_one(st, N, ip[j], vp[j]);
  for (int64_t j = a + 4 * nvec + threadIdx.x; j < j1; j += kDeltaThreads) {
    delta_one(st, N, ip[j], vp[j]);
  }
  __syncthreads();
  // a RED a pair, a warp's lanes on neighbouring pairs (sorted indices:
  // neighbouring sectors)
  const int32_t* sI = reinterpret_cast<const int32_t*>(si);
  const int32_t* sV = reinterpret_cast<const int32_t*>(sv);
#pragma unroll 4
  for (int e = threadIdx.x; e < 4 * nvec; e += kDeltaThreads) delta_one(st, N, sI[e], sV[e]);
}

}  // namespace

// ------------------------------------------------------------ C entry points

// K20's scratch besides ``chunks``: X and Y uint64 [W, B * F], n and e
// int32 [W, B * F], links u8 [B * F, W], W = 2 bpm (nothing to fill; ``a``
// is null: a DC-first scan passes no blocks but those it decodes);
// stamps int64 [4] or null.  Two kernels: the guesses and links, then a CTA
// an image.
extern "C" int zpix_spec_dc_first(const void* s, int64_t cap, const void* starts,
                                  const void* ends, const void* tab, void* ok, void* rounds,
                                  void* chunks, void* X, void* Y, void* n, void* a, void* e,
                                  void* links, void* diffs, void* g0, void* g1, void* g2,
                                  void* stamps, int batch, int F, int cbits, int mbc, int nblk,
                                  int bpm, int ngrids, int per_row, int hv0, int hv1, int hv2,
                                  int bh0, int bh1, int bh2, int bv0, int bv1, int bv2, int al,
                                  void* stream) {
  const zpix::TimedEntry timed(stream);
  if (ngrids < 1 || ngrids > kMaxGrids || bpm < 1 || bpm > 16 || al < 0 || al > 31 ||
      F < 1 || cbits < 8 || per_row < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hv[3] = {hv0, hv1, hv2}, bh[3] = {bh0, bh1, bh2}, bv[3] = {bv0, bv1, bv2};
  void* grids[3] = {g0, g1, g2};
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
  p.al = al;
  const int64_t L = static_cast<int64_t>(batch) * F;
  const Links q{static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y), static_cast<int32_t*>(n),
                static_cast<int32_t*>(a),  static_cast<int32_t*>(e),  static_cast<uint8_t*>(links),
                L};
  const auto st = static_cast<cudaStream_t>(stream);
  if (batch > 0) {
    const int G = kLinkThreads / bpm - 2;
    dc_guess_link_kernel<<<static_cast<unsigned>((L + G - 1) / G), kLinkThreads, 0, st>>>(p, q);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    dc_first_spec_kernel<<<batch, kThreads, 0, st>>>(p, q);
  }
  return static_cast<int>(cudaGetLastError());
}

// K21 over ``nscans`` AC-first scans of one batch: ``scans`` int64
// [nscans, kScanWords] on the card; scratch, nothing to fill: misses and
// lims int32 [nscans, batch], chunks int32 [lanes, kChunkWords], X and Y
// uint64 [2, lanes], n, a and e int32 [2, lanes], links u8 [lanes, 2].
// Three kernels: guesses and links (link_blocks), a warp an (image, scan),
// the record (rec_blocks).
extern "C" int zpix_spec_ac_first_group(const void* scans, int nscans, int batch, int cbits,
                                        int mbc, void* ok, void* misses, void* lims,
                                        void* chunks, void* X, void* Y, void* n, void* a,
                                        void* e, void* links, int64_t lanes, int link_blocks,
                                        int rec_blocks, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (nscans < 1 || batch < 1 || cbits < 8 || lanes < 1 || link_blocks < 1 || rec_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Group g{static_cast<const int64_t*>(scans), static_cast<int32_t*>(ok),
                static_cast<int32_t*>(misses),      static_cast<int32_t*>(lims),
                static_cast<int32_t*>(chunks),      nscans, batch, cbits, mbc};
  const Links q{static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y), static_cast<int32_t*>(n),
                static_cast<int32_t*>(a),  static_cast<int32_t*>(e),  static_cast<uint8_t*>(links),
                lanes};
  const auto st = static_cast<cudaStream_t>(stream);
  ac_guess_link_kernel<<<link_blocks, kLinkThreads, 0, st>>>(g, q);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ac_resolve_kernel<<<nscans * batch, 32, 0, st>>>(g, q);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  ac_record_kernel<<<rec_blocks, kRecThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// K22 over ``nseg`` segments (int64 [nseg, kDeltaWords] on the card, none
// empty) in ``tiles`` CTAs.
extern "C" int zpix_delta_add_segments(const void* segs, int nseg, int tiles, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (nseg < 1 || tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  delta_add_kernel<<<tiles, kDeltaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(segs), nseg);
  return static_cast<int>(cudaGetLastError());
}
