// K19: the speculative chunk sync of a restart-free baseline scan -> every
// block's end bit, with no host index pass (after arXiv:2111.09219).
//
// Replaces zpix_tpu/parallel/device_entropy_sync.py::build_sync_decode_fn
// through its assembly (:176-466), a lax.while_loop over chunk lanes with
// a searchsorted gather.  A lane decodes code lengths and run/size only
// (the extend bits are skipped) from an entry state (bit, MCU slot, k,
// DC/AC phase) to the first symbol boundary at or past its chunk's end
// (:236-339).  Entry states are packed in one 64-bit word, bit << 32 |
// slot << 16 | k << 8 | phase.  Each chunk's entry is the serial decode's
// state at its start (chunk 0 enters at the image's start, chunk i at
// chunk i - 1's exit), so the entries, ends and ok equal the JAX
// package's however they are found.  zpix_tpu finds them by a modal seed
// and Jacobi rounds; on the bench's content that runs about one round a
// chunk.  Here, on sync chunks of m chunks (ops/sync.py SYNC_BYTES), in
// four launches on the caller's stream and no host sync:
//
//  1. guesses and links (K19b): a block takes G sync chunks and the two
//     after them, a thread a (sync chunk j, slot guess v), the bpm guesses
//     of a chunk in adjacent threads.  Each scans chunk j from its start
//     with slot v (chunk 0 from the image's start) -> X[v][j], a candidate
//     entry of chunk j + 1.  A wrong guess merges with the serial decode
//     within a few symbols, so a chunk's candidates are mostly equal (1.43
//     distinct of 6 on the bench's content): one thread of each set of
//     equal candidates, the threads packed together, scans chunk j + 1
//     from it -> Y[.][j + 1], taking the states at the starts of its m
//     chunks on the way (S), and the link, the candidate of chunk j + 2
//     equal to Y (or kMiss), is found among the next group's guesses in
//     shared memory.  Where a link misses, the missed exit is put in at
//     once as chunk j + 2's extra candidate (column bpm): chunk j + 2 is
//     scanned from it and linked, so that a miss on the true path rarely
//     costs the resolve a scan.
//  2. resolve: a block an image stages its links (u8 [J + 1][bpm + 1]) in
//     shared memory (in global memory when they do not fit) and one warp
//     walks them: each lane composes the links of a 32nd of the chunks
//     from every candidate, a walk over the 32 compositions gives each
//     part's entering candidate, and each lane walks its part again for
//     each chunk's candidate index.  A miss that step 1 did not put in (a
//     second distinct missed exit of a chunk, or two misses in a row) is
//     put in here: the warp scans the chunk from the true entry (its bytes
//     staged in shared memory) and walks on.  Then the block writes every
//     chunk's entry from its candidate (X, or S inside a sync chunk) and
//     counts the misses (the chunks entered by column bpm).
//  3. record (K19d, :427-442): a thread a chunk scans from its entry,
//     counts the blocks that end in it and writes the first mb end bits
//     into its row of rec [L, mb] (only the ends it has: ~4 bytes a block);
//     a block past mb or a code no table holds sets its error bit.
//  4. assemble (:444-466): blocks of (part of an image) take the exclusive
//     prefix of the image's counts and move their chunks' ends to their
//     raster indices, a warp a chunk, writing every index once (0 where no
//     end was recorded); ok is cleared unless sum cnt >= nblk, the last
//     end lies in [img_end - 7, img_end] and every error bit lies at or
//     past that end.  A lane whose 8-byte read would pass the buffer stops
//     and clears ok (record), where the JAX package clips the read.
//
// Bound on the H100: the serial symbol chain of a sync chunk times the
// passes over it (a guess, a link for each distinct candidate, the
// record), not bytes.  A symbol step is kept short and free of
// divergence: the tables sit in shared memory with a 10-bit lookahead
// table beside them (codes of up to 10 bits in one lookup; longer ones by
// a binary search of the code limits, or huffman.cuh's compares where a
// table's limits are not sorted), built by each block of step 1 and by
// block 0 into global memory for the later steps; each block stages its
// chunks' stream words in shared memory, so a window refill is a
// shared-memory read.  ok and misses are set by the first launch, so the
// wrapper fills nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "huffman.cuh"
#include "timing.cuh"

namespace {

using zpix::Sym;

constexpr int32_t kErrNone = 0x7fffffff;  // ops/sync.py ERR_NONE
constexpr uint8_t kMiss = 0xFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTables = 8;
constexpr int kLutBits = 10, kLut = 1 << kLutBits;
constexpr int kLutWords = kTables * kLut / 2;  // the lookahead table in 32-bit words
constexpr int kGuessThreads = 256;  // guesses and links: (G + 2) * bpm of them work
constexpr int kRecordThreads = 128;  // record: a chunk a thread
constexpr int kResolveThreads = 256;
constexpr int kAsmThreads = 1024;
constexpr int kStageWords = 4224;  // a block's staged stream words (16.5 KiB)
constexpr int kMissWords = 1056;   // a missed sync chunk's staged words

struct State {
  int64_t bit;
  int slot, k, phase;
};

__device__ __forceinline__ uint64_t pack(const State& s) {
  return (static_cast<uint64_t>(s.bit) << 32) | (static_cast<uint64_t>(s.slot) << 16) |
         (static_cast<uint64_t>(s.k) << 8) | static_cast<uint64_t>(s.phase);
}

__device__ __forceinline__ State unpack(uint64_t v) {
  return State{static_cast<int64_t>(v >> 32), static_cast<int>((v >> 16) & 0xFFFF),
               static_cast<int>((v >> 8) & 0xFF), static_cast<int>(v & 0xFF)};
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The decode tables in shared memory: the packed tables, whether each
// table's limits lims[0..14] are sorted, and for each table a slot uses
// lut[t][look >> 6]: 1 << 12 (every lookahead with these 10 bits is
// invalid), len << 8 | sym (all decode to one code of at most 10 bits),
// or 0 (decode in full).  An entry is exactly decode_full's result for
// every lookahead it covers: each limit compare is monotone in the
// lookahead, so where the count agrees at both ends of the 64 it agrees
// between them.
struct Tabs {
  int32_t tab[zpix::kTabEntropyWords];
  uint16_t lut[kTables * kLut];
  unsigned used, sorted;
  uint64_t dc_of, ac_of;  // each slot's DC and AC table, 4 bits a slot
};

__device__ __forceinline__ Sym decode_full(const Tabs& T, int t, int32_t look) {
  return zpix::decode_full(T.tab, (T.sorted >> t) & 1u, t, look);
}

// The packed tables into shared memory, with which tables the bpm slots
// use and which have sorted limits (a thread a table).
__device__ void stage_tabs(Tabs& T, const int32_t* tables, int bpm) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x) T.tab[i] = tables[i];
  if (threadIdx.x == 0) T.used = T.sorted = 0;
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kTables) {
    if (zpix::lims_sorted(T.tab, t)) atomicOr(&T.sorted, 1u << t);
  } else if (t == kTables) {
    uint64_t dc = 0, ac = 0;
    unsigned u = 0;
    for (int s = 0; s < bpm; ++s) {
      const int d = T.tab[zpix::kTabSlotDc + s] & 15, a = T.tab[zpix::kTabSlotAc + s] & 15;
      dc |= static_cast<uint64_t>(d) << (4 * s);
      ac |= static_cast<uint64_t>(a) << (4 * s);
      u |= (1u << (d & 7)) | (1u << (a & 7));
    }
    atomicOr(&T.used, u);
    T.dc_of = dc;
    T.ac_of = ac;
  }
  __syncthreads();
}

// stage_tabs, then the lookahead table: built here, or copied from lut_g.
__device__ void stage_tables(Tabs& T, const int32_t* tables, int bpm, const uint32_t* lut_g) {
  stage_tabs(T, tables, bpm);
  auto* lut = reinterpret_cast<uint32_t*>(T.lut);
  if (lut_g != nullptr) {
    for (int i = threadIdx.x; i < kLutWords; i += blockDim.x) lut[i] = lut_g[i];
  } else {
    for (int i = threadIdx.x; i < kTables * kLut; i += blockDim.x) {
      const int t = i / kLut, p = i % kLut;
      uint16_t e = 0;
      if ((T.used >> t) & 1u) {
        const Sym lo = decode_full(T, t, p << (16 - kLutBits));
        const Sym hi = decode_full(T, t, (p << (16 - kLutBits)) | ((1 << (16 - kLutBits)) - 1));
        if (lo.bad && hi.bad) {
          e = 1 << 12;
        } else if (!lo.bad && !hi.bad && lo.len == hi.len && lo.len <= kLutBits) {
          e = static_cast<uint16_t>(lo.len << 8 | lo.sym);
        }
      }
      T.lut[i] = e;
    }
  }
  __syncthreads();
}

// The stream as big-endian 32-bit words, words [lo, hi) staged in shared
// memory.  The stream is 4-byte aligned (ops/sync.py checks).
struct Reader {
  const uint32_t* g;
  const uint32_t* sm;
  int64_t lo, hi;
  __device__ __forceinline__ uint32_t word(int64_t i) const {
    const uint32_t x = (i >= lo && i < hi) ? sm[i - lo] : __ldg(g + i);
    return __byte_perm(x, 0, 0x0123);
  }
};

// The words holding bits [lo_bit, hi_bit) and a margin (a scan ends at
// most one symbol, 32 bits, past its end; a window reads 64 bits), clipped
// to the buffer's whole words and to cap_words, into sm; reads outside go
// to global memory.
__device__ Reader stage_stream(uint32_t* sm, int cap_words, const uint8_t* stream, int64_t cap,
                               int64_t lo_bit, int64_t hi_bit) {
  const auto* g = reinterpret_cast<const uint32_t*>(stream);
  const int64_t lo = lo_bit >> 5;
  const int64_t hi = lmax(lo, lmin(lmin((hi_bit + 128) >> 5, cap >> 2), lo + cap_words));
  for (int64_t i = threadIdx.x; i < hi - lo; i += blockDim.x) sm[i] = g[lo + i];
  __syncthreads();
  return Reader{g, sm, lo, hi};
}

// Decodes from s to the first symbol boundary at or past ce; s becomes the
// exit state.  A bad code stops the lane at that symbol (its start lowers
// *err).  With kRecord, each block end is counted in *cnt and the first mb
// written to rec; a block past mb lowers *err.  Returns false where a read
// would pass the buffer, 8 bytes from a symbol's first byte (the lane
// stops there).  The stream's bits go through a left-aligned 64-bit
// buffer holding at least 32 of them at each symbol (a symbol takes at
// most 31, code and extra bits; a longer skip, from a corrupt DC size,
// reloads it), so a step's chain is a lookup, a shift and an add; bit
// positions are int32 (ops/sync.py bounds the stream).
template <bool kRecord>
__device__ bool scan(const Tabs& T, const Reader& rd, int64_t cap, State& s, int64_t ce64, int bpm,
                     int32_t* err, int* cnt, int32_t* rec, int mb) {
  int32_t b = static_cast<int32_t>(s.bit);
  const int32_t ce = static_cast<int32_t>(ce64);
  const int32_t lim = static_cast<int32_t>(lmin(8 * (cap - 7), INT32_MAX));  // b >= lim: past
  const int32_t stop = min(ce, lim);
  int slot = s.slot, k = s.k, phase = s.phase;
  const uint64_t dc_of = T.dc_of, ac_of = T.ac_of;
  uint64_t buf = 0;
  int nb = 0;      // valid bits at the top of buf
  int64_t wn = 0;  // the next word to load
  bool bad = false;
  while (b < stop) {
    if (nb < 32) {
      if (nb <= 0) {
        const int64_t i = b >> 5;
        buf = ((static_cast<uint64_t>(rd.word(i)) << 32) | rd.word(i + 1)) << (b & 31);
        nb = 64 - (b & 31);
        wn = i + 2;
      } else {
        buf |= static_cast<uint64_t>(rd.word(wn++)) << (32 - nb);
        nb += 32;
      }
    }
    const bool dc = phase == 0;
    const int t = static_cast<int>(((dc ? dc_of : ac_of) >> (4 * slot)) & 15);
    const int32_t look = static_cast<int32_t>(buf >> 48);
    const unsigned e = T.lut[t * kLut + (look >> (16 - kLutBits))];
    int len = e >> 8, sym = e & 255;
    if (e - 1u >= 4095u) {  // not in the table (0) or invalid (1 << 12)
      const Sym y = decode_full(T, t, look);
      if (y.bad) {
        if (kRecord && b < *err) *err = b;
        bad = true;
        break;
      }
      len = y.len;
      sym = y.sym;
    }
    const int r = dc ? 0 : sym >> 4;
    const int size = dc ? sym : sym & 15;
    const int n = len + size;
    const int32_t end = b + n;
    // the next k; the block ends at EOB, or where k passes 63
    const int nk = dc ? 1 : size > 0 ? min(max(k + r, 0), 63) + 1 : r == 15 ? k + 16 : 64;
    const bool blk_done = !dc && nk > 63;
    if (kRecord && blk_done) {
      if (*cnt < mb) {
        rec[*cnt] = end;
      } else if (b < *err) {
        *err = b;
      }
      ++*cnt;
    }
    const int next_slot = slot + 1 >= bpm ? 0 : slot + 1;
    slot = blk_done ? next_slot : slot;
    k = blk_done ? 0 : nk;
    phase = blk_done ? 0 : (dc ? 1 : phase);
    buf = n < nb ? buf << (n & 63) : 0;
    nb = n < nb ? nb - n : 0;  // 0: reload at the new position
    b = end;
  }
  s = State{b, slot, k, phase};
  return bad || b >= ce;
}

// The geometry of one image's chunks: sync chunk j of m chunks of cb bits
// each, clipped to [s0, e).
struct Geom {
  int64_t s0, e;
  int cb, m;
  __device__ __forceinline__ int64_t at(int64_t chunk) const {  // chunk's start, clipped
    return lmin(s0 + chunk * cb, e);
  }
};

__device__ __forceinline__ Geom geom_of(int img, const int32_t* starts, const int32_t* ends,
                                        int cb, int m) {
  return Geom{starts[img], ends[img], cb, m};
}

// Scans sync chunk j from s to its end, and puts the state at the start of
// its chunks 1 .. m - 1 at sub[0], sub[stride], ... (where sub is given).
__device__ __forceinline__ void scan_sync(const Tabs& T, const Reader& rd, int64_t cap, State& s,
                                          const Geom& g, int64_t j, int bpm, uint64_t* sub,
                                          int64_t stride) {
  for (int k = 1; k < g.m; ++k) {
    scan<false>(T, rd, cap, s, g.at(j * g.m + k), bpm, nullptr, nullptr, nullptr, 0);
    if (sub != nullptr) sub[(k - 1) * stride] = pack(s);
  }
  scan<false>(T, rd, cap, s, g.at((j + 1) * g.m), bpm, nullptr, nullptr, nullptr, 0);
}

// Compacts the block's threads with flag set into list (any order) ->
// their count.  Every thread of the block calls it.
__device__ int compact(bool flag, int* list, int* n) {
  if (threadIdx.x == 0) *n = 0;
  __syncthreads();
  const unsigned bal = __ballot_sync(kFull, flag);
  int at = 0;
  if ((threadIdx.x & 31) == 0 && bal) at = atomicAdd(n, __popc(bal));
  at = __shfl_sync(kFull, at, 0);
  if (flag) list[at + __popc(bal & lanemask_lt())] = threadIdx.x;
  __syncthreads();
  return *n;
}

// The state at the first symbol boundary at or past a sync chunk's
// checkpoint, kCheck bits after its start, where that lies before the
// chunk's first inner start (else all ones: no checkpoint).  A scan that
// reaches a guess's checkpoint state has joined that guess's path: its
// inner states and exit are the guess's.
constexpr int kCheck = 128;

__device__ __forceinline__ int64_t checkpoint(const Geom& g, int64_t j) {
  const int64_t cp = g.s0 + j * g.m * g.cb + kCheck;
  return cp < g.at(j * g.m + 1) ? cp : -1;
}

// Scans sync chunk j of g from s.  At its checkpoint and at each inner
// chunk start it compares the state with the bpm guesses' there (cps[u *
// us], inner states sg[(k - 1) * sg_stride + u * sg_us]): where one is
// equal, the scan has joined that guess's path, and the rest of the inner
// states and the exit (xs[u * us]) are the guess's.  -> the exit; the
// inner states go to sub[(k - 1) * stride] (where sub is given).
__device__ uint64_t link_scan(const Tabs& T, const Reader& rd, int64_t cap, State s, const Geom& g,
                              int64_t j, int bpm, const uint64_t* cps, const uint64_t* xs,
                              int64_t us, const uint64_t* sg, int64_t sg_stride, int64_t sg_us,
                              uint64_t* sub, int64_t stride) {
  int joined = -1;
  const int64_t cp = checkpoint(g, j);
  if (cp >= 0) {
    scan<false>(T, rd, cap, s, cp, bpm, nullptr, nullptr, nullptr, 0);
    const uint64_t z = pack(s);
    for (int u = 0; u < bpm && joined < 0; ++u) joined = cps[u * us] == z ? u : -1;
  }
  for (int k = 1; k < g.m; ++k) {
    uint64_t z;
    if (joined < 0) {
      scan<false>(T, rd, cap, s, g.at(j * g.m + k), bpm, nullptr, nullptr, nullptr, 0);
      z = pack(s);
      for (int u = 0; u < bpm && joined < 0; ++u) {
        joined = sg[(k - 1) * sg_stride + u * sg_us] == z ? u : -1;
      }
    } else {
      z = sg[(k - 1) * sg_stride + joined * sg_us];
    }
    if (sub != nullptr) sub[(k - 1) * stride] = z;
  }
  if (joined >= 0) return xs[joined * us];
  scan<false>(T, rd, cap, s, g.at((j + 1) * g.m), bpm, nullptr, nullptr, nullptr, 0);
  return pack(s);
}

// 1. A block: sync chunks [lane0, lane0 + G) and the two after them
// (guessed only), a thread a (chunk, guess).  L = B * F sync chunks, W =
// bpm + 1 candidates a chunk (column bpm: an exit put in after a miss).
// Writes X [W, L] (X[v][j]: chunk j's exit from guess v), Y [W, L] (Y[v][j]:
// chunk j's exit from X[v][j - 1]), S [m - 1, W, L] (the states at chunk
// j's inner chunk starts on the same scan; for chunk 0 from the image's
// start), links u8 [L, W] (row j: the candidate of chunk j + 1 equal to
// Y[v][j], or kMiss); X, Y, S and the links of column bpm where a miss is
// put in.  SG [m - 1, bpm, L] and CP [bpm, L]: the guesses' inner and
// checkpoint states.  Block 0 sets flags (ok 1, misses 0) and writes the
// lookahead table to lut_g.
__global__ void __launch_bounds__(kGuessThreads)
guess_link_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                  const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                  const int32_t* __restrict__ tables, uint32_t* __restrict__ lut_g,
                  uint64_t* __restrict__ X, uint64_t* __restrict__ Y, uint64_t* S, uint64_t* SG,
                  uint64_t* __restrict__ CP, uint8_t* __restrict__ links, int* __restrict__ flags,
                  int B, int F, int cb, int m, int bpm) {
  __shared__ Tabs T;
  __shared__ uint64_t sx[kGuessThreads], scp[kGuessThreads], sy[kGuessThreads];
  __shared__ uint8_t slink[kGuessThreads];
  __shared__ int items[kGuessThreads];
  __shared__ int n_items;
  __shared__ uint64_t pre_y[kGuessThreads];  // a group's exit put in, or all ones
  __shared__ uint8_t pre_link[kGuessThreads];
  extern __shared__ uint32_t stage[];
  const int64_t L = static_cast<int64_t>(B) * F;
  const int G = kGuessThreads / bpm - 2, W = bpm + 1;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * G;
  const int tid = threadIdx.x, gi = tid / bpm, v = tid - gi * bpm;
  const int64_t lane = lane0 + gi;
  const bool active = gi <= G + 1 && lane < L;
  const bool owner = active && gi < G;  // the block writes this chunk's results
  const int img = static_cast<int>(lane / F);
  const int c = static_cast<int>(lane - static_cast<int64_t>(img) * F);
  const int64_t stride = static_cast<int64_t>(W) * L, sg_stride = static_cast<int64_t>(bpm) * L;
  if (blockIdx.x == 0 && tid == 0) {
    flags[0] = 1;
    flags[1] = 0;
  }
  pre_y[tid] = ~uint64_t(0);
  stage_tables(T, tables, bpm, nullptr);
  if (blockIdx.x == 0) {
    const auto* lut = reinterpret_cast<const uint32_t*>(T.lut);
    for (int i = tid; i < kLutWords; i += blockDim.x) lut_g[i] = lut[i];
  }
  const int64_t first = lane0, last = lmin(lane0 + G + 1, L - 1);
  const Geom g0 = geom_of(static_cast<int>(first / F), starts, ends, cb, m);
  const Geom g1 = geom_of(static_cast<int>(last / F), starts, ends, cb, m);
  const Reader rd = stage_stream(stage, kStageWords, stream, cap, g0.at((first % F) * m),
                                 g1.at((last % F + 1) * m));
  // the guesses: the checkpoint state, the inner states, the exit
  uint64_t x = 0;
  if (active) {
    const Geom g = geom_of(img, starts, ends, cb, m);
    State s{g.at(static_cast<int64_t>(c) * m), c == 0 ? 0 : v, 0, 0};  // chunk 0: the start
    const int64_t cp = checkpoint(g, c);
    uint64_t z = ~uint64_t(0);
    if (cp >= 0) {
      scan<false>(T, rd, cap, s, cp, bpm, nullptr, nullptr, nullptr, 0);
      z = pack(s);
    }
    // chunk 0 is on the true path: its inner states go to S (candidate 0)
    uint64_t* sub = c == 0 ? (owner && v == 0 ? S + lane : nullptr) : SG + v * L + lane;
    scan_sync(T, rd, cap, s, g, c, bpm, sub, c == 0 ? stride : sg_stride);
    x = pack(s);
    sx[tid] = x;
    scp[tid] = z;
    if (owner) {
      X[v * L + lane] = x;
      CP[v * L + lane] = z;
    }
  }
  __syncthreads();
  // the first of each set of equal candidates scans the next chunk from it
  int lead = v;
  if (active) {
    for (int u = 0; u < v; ++u) {
      if (sx[gi * bpm + u] == x) {
        lead = u;
        break;
      }
    }
  }
  const int n1 = compact(owner && lead == v && c + 1 < F, items, &n_items);
  for (int i = tid; i < n1; i += blockDim.x) {
    const int u = items[i], ug = u / bpm, uv = u - ug * bpm;
    const int64_t ul = lane0 + ug + 1;  // the next chunk
    const Geom gu = geom_of(static_cast<int>(ul / F), starts, ends, cb, m);
    const int nx = (ug + 1) * bpm;
    sy[u] = link_scan(T, rd, cap, unpack(sx[u]), gu, ul % F, bpm, scp + nx, sx + nx, 1, SG + ul,
                      sg_stride, L, S + uv * L + ul, stride);
  }
  __syncthreads();
  // links; the inner states of the next chunk copied from the leader
  uint64_t y = 0;
  uint8_t r = kMiss;
  if (owner && c + 1 < F) {
    y = sy[gi * bpm + lead];
    if (lead != v) {
      for (int k = 0; k + 1 < m; ++k) {
        S[k * stride + v * L + lane + 1] = S[k * stride + lead * L + lane + 1];
      }
    }
    if (c + 2 < F) {  // chunk c + 1's exit among chunk c + 2's candidates
      for (int u = 0; u < bpm; ++u) {
        if (sx[(gi + 1) * bpm + u] == y) {
          r = static_cast<uint8_t>(u);
          break;
        }
      }
    }
    sy[tid] = y;
  }
  slink[tid] = r;
  __syncthreads();
  // a missed exit, the group's first, put in as chunk c + 2's candidate bpm
  bool put_in = owner && c + 2 < F && r == kMiss;
  for (int u = 0; put_in && u < v; ++u) put_in = slink[gi * bpm + u] != kMiss;
  const int n2 = compact(put_in, items, &n_items);
  for (int i = tid; i < n2; i += blockDim.x) {
    const int u = items[i], ug = u / bpm;
    const int64_t ul = lane0 + ug + 2;
    const int uc = static_cast<int>(ul % F);
    const Geom gu = geom_of(static_cast<int>(ul / F), starts, ends, cb, m);
    const int nx = (ug + 2) * bpm;
    const uint64_t z = link_scan(T, rd, cap, unpack(sy[u]), gu, uc, bpm, scp + nx, sx + nx, 1,
                                 SG + ul, sg_stride, L, S + bpm * L + ul, stride);
    Y[bpm * L + ul] = z;
    uint8_t r2 = kMiss;
    if (uc + 1 < F) {
      for (int w = 0; w < bpm; ++w) {
        if (sx[nx + w] == z) {
          r2 = static_cast<uint8_t>(w);
          break;
        }
      }
    }
    pre_y[ug] = sy[u];
    pre_link[ug] = r2;
  }
  __syncthreads();
  if (!owner) return;
  uint8_t* row = links + lane * W;  // row c: the links of chunk c's entries
  if (c == 0) {
    row[v] = kMiss;
    if (v == 0) {
      row[bpm] = kMiss;
      X[bpm * L + lane] = ~uint64_t(0);
      if (c + 1 < F) row[W + bpm] = kMiss;
    }
  }
  if (c + 1 < F) {
    Y[v * L + lane + 1] = y;
    const bool in = r == kMiss && y == pre_y[gi];
    row[W + v] = in ? static_cast<uint8_t>(bpm) : r;
    if (v == 0) {
      X[bpm * L + lane + 1] = pre_y[gi];
      if (c + 2 < F) row[2 * W + bpm] = pre_y[gi] != ~uint64_t(0) ? pre_link[gi] : kMiss;
    }
  }
}

// Scans sync chunk j of the image from e (all lanes of the warp alike, its
// words staged in mst; the guesses' checkpoint states as in step 1), its
// inner states to sub -> the exit.
__device__ uint64_t warp_scan_sync(const Tabs& T, uint32_t* mst, const uint8_t* stream,
                                   int64_t cap, uint64_t e, const Geom& g, int64_t j, int bpm,
                                   const uint64_t* cps, const uint64_t* xs, const uint64_t* sg,
                                   int64_t L, uint64_t* sub, int64_t stride) {
  const auto* gw = reinterpret_cast<const uint32_t*>(stream);
  const int64_t lo = g.at(j * g.m) >> 5;
  const int64_t hi =
      lmax(lo, lmin(lmin((g.at((j + 1) * g.m) + 128) >> 5, cap >> 2), lo + kMissWords));
  __syncwarp();
  for (int64_t i = threadIdx.x & 31; i < hi - lo; i += 32) mst[i] = gw[lo + i];
  __syncwarp();
  return link_scan(T, Reader{gw, mst, lo, hi}, cap, unpack(e), g, j, bpm, cps, xs, L, sg,
                   bpm * L, L, sub, stride);
}

// 2. A block an image: each sync chunk's candidate index, then the
// entries of its Ff chunks into fine.  links_smem: the links and indices
// fit the dynamic shared memory (else they live in global memory: the
// image's rows of links and of tj).
__global__ void __launch_bounds__(kResolveThreads)
resolve_kernel(const uint8_t* __restrict__ stream, int64_t cap,
               const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
               const int32_t* __restrict__ tables, const uint32_t* __restrict__ lut_g,
               uint64_t* X, uint64_t* Y, uint64_t* S, const uint64_t* __restrict__ SG,
               const uint64_t* __restrict__ CP, uint8_t* links, uint8_t* tj_g,
               uint64_t* __restrict__ fine, int* flags, int B, int F, int Ff, int cb, int m,
               int bpm, int links_smem) {
  __shared__ Tabs T;
  __shared__ uint8_t comp[32][17];  // each part's composition from each candidate
  __shared__ uint8_t part_in[32];   // each part's entering candidate
  __shared__ uint32_t mst[kMissWords];
  __shared__ int s_tJ, s_misses;
  extern __shared__ uint8_t dyn[];
  const int64_t L = static_cast<int64_t>(B) * F;
  const int64_t stride = static_cast<int64_t>(bpm + 1) * L;
  const int img = blockIdx.x, W = bpm + 1, tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(img) * F;
  const Geom g = geom_of(img, starts, ends, cb, m);
  const int64_t sync_bits = static_cast<int64_t>(cb) * m;
  // J: the image's last sync chunk that holds bits (chunks past it are empty)
  const int J = g.e > g.s0 ? static_cast<int>((g.e - g.s0 + sync_bits - 1) / sync_bits) - 1 : 0;
  stage_tables(T, tables, bpm, lut_g);
  uint8_t* lk = links + base * W;
  uint8_t* tj = tj_g + base;
  if (links_smem) {
    for (int i = tid; i < (J + 1) * W; i += blockDim.x) dyn[i] = lk[i];
    lk = dyn;
    tj = dyn + F * W;
  }
  if (tid == 0) s_misses = 0;
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    // steps j = 1 .. J - 1 (t_{j+1} = lk[j][t_j], t_1 = 0) in 32 parts
    const int steps = J - 1;
    const int per = steps > 0 ? (steps + 31) / 32 : 0;
    const int js = 1 + lane * per, je = min(js + per, J);
    if (js < je) {
      int t[17];
#pragma unroll
      for (int x = 0; x < 17; ++x) t[x] = x;
      for (int j = js; j < je; ++j) {
#pragma unroll
        for (int x = 0; x < 17; ++x) {
          if (x < W && t[x] != kMiss) t[x] = lk[j * W + t[x]];
        }
      }
#pragma unroll
      for (int x = 0; x < 17; ++x) {
        if (x < W) comp[lane][x] = static_cast<uint8_t>(t[x]);
      }
    }
    __syncwarp();
    // the true path, part by part, every lane alike; a part whose rows a
    // put-in changed (column bpm of the row after it) is walked anew
    int cur = 0, changed = -1;
    for (int p = 0; p < 32; ++p) {
      const int ps = 1 + p * per, pe = min(ps + per, J);
      if (ps >= pe) break;
      if (lane == 0) part_in[p] = static_cast<uint8_t>(cur);
      if (changed < ps && comp[p][cur] != kMiss) {
        cur = comp[p][cur];
        continue;
      }
      for (int j = ps; j < pe; ++j) {
        int nx = lk[j * W + cur];
        if (nx == kMiss) {  // chunk j + 1 enters at Y[cur][j], no candidate: put it in
          const uint64_t e = Y[cur * L + base + j];
          const int64_t at = base + j + 1;
          const uint64_t ex = warp_scan_sync(T, mst, stream, cap, e, g, j + 1, bpm, CP + at,
                                             X + at, SG + at, L, S + bpm * L + at, stride);
          uint8_t r = kMiss;
          if (j + 2 < F) {
            for (int u = 0; u < bpm; ++u) {
              if (X[u * L + base + j + 1] == ex) {
                r = static_cast<uint8_t>(u);
                break;
              }
            }
          }
          if (lane == 0) {
            X[bpm * L + base + j] = e;
            lk[j * W + cur] = static_cast<uint8_t>(bpm);
            Y[bpm * L + base + j + 1] = ex;
            lk[(j + 1) * W + bpm] = r;
          }
          __syncwarp();
          changed = j + 1;
          nx = bpm;
        }
        cur = nx;
      }
    }
    if (lane == 0) s_tJ = cur;
    __syncwarp();
    // each part again from its entering candidate: every index
    if (js < je) {
      int cc = part_in[lane];
      for (int j = js; j < je; ++j) {
        tj[j] = static_cast<uint8_t>(cc);
        cc = lk[j * W + cc];
      }
    }
    if (lane == 0) {
      tj[0] = 0;
      tj[J] = static_cast<uint8_t>(cur);
    }
  }
  __syncthreads();
  const int tJ = s_tJ;
  const uint64_t first = pack(State{g.s0, 0, 0, 0});
  // past J every chunk enters at chunk J's exit
  const uint64_t after = J == 0 ? X[base] : Y[tJ * L + base + J];
  int misses = 0;
  for (int f = tid; f < Ff; f += blockDim.x) {
    const int j = f / m, k = f - j * m;
    uint64_t e = after;
    if (j <= J) {
      const int t = j == 0 ? 0 : tj[j];
      if (k > 0) {
        e = S[(k - 1) * stride + t * L + base + j];
      } else {
        e = j == 0 ? first : X[t * L + base + j - 1];
        misses += j >= 2 && t == bpm;
      }
    }
    fine[static_cast<int64_t>(img) * Ff + f] = e;
  }
  if (misses) atomicAdd(&s_misses, misses);
  __syncthreads();
  if (tid == 0 && s_misses) atomicAdd(flags + 1, s_misses);
}

// 3. A thread a chunk: from its entry to its end, its block ends recorded.
__global__ void __launch_bounds__(kRecordThreads)
record_kernel(const uint8_t* __restrict__ stream, int64_t cap,
              const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
              const int32_t* __restrict__ tables, const uint32_t* __restrict__ lut_g,
              const uint64_t* __restrict__ fine, int32_t* __restrict__ rec,
              int32_t* __restrict__ cnt, int32_t* __restrict__ err, int* flags, int B, int F,
              int cb, int bpm, int mb) {
  __shared__ Tabs T;
  extern __shared__ uint32_t stage[];
  const int64_t Lf = static_cast<int64_t>(B) * F;
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t lane = l0 + threadIdx.x;
  stage_tables(T, tables, bpm, lut_g);
  const int64_t l1 = lmin(l0 + blockDim.x, Lf) - 1;
  const Geom g0 = geom_of(static_cast<int>(l0 / F), starts, ends, cb, 1);
  const Geom g1 = geom_of(static_cast<int>(l1 / F), starts, ends, cb, 1);
  const Reader rd = stage_stream(stage, kStageWords, stream, cap, g0.at(l0 % F),
                                 g1.at(l1 % F + 1));
  if (lane >= Lf) return;
  const int img = static_cast<int>(lane / F);
  const Geom g = geom_of(img, starts, ends, cb, 1);
  State s = unpack(fine[lane]);
  int n = 0;
  int32_t e = kErrNone;
  if (!scan<true>(T, rd, cap, s, g.at(lane - static_cast<int64_t>(img) * F + 1), bpm, &e, &n,
                  rec + lane * mb, mb)) {
    atomicAnd(flags, 0);
  }
  cnt[lane] = n;
  err[lane] = e;
}

// Block-wide exclusive scan of one value a thread (blockDim.x == 1024);
// *total gets the block's sum.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sum,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t t = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += u;
    }
    warp_sum[lane] = t;
  }
  __syncthreads();
  const int32_t before = (warp ? warp_sum[warp - 1] : 0) + incl - v;
  *total = warp_sum[31];
  __syncthreads();
  return before;
}

// 4. Block (x, image): the image's chunks [x * per, (x + 1) * per).
__global__ void __launch_bounds__(kAsmThreads)
assemble_kernel(const int32_t* __restrict__ ends, const int32_t* __restrict__ rec,
                const int32_t* __restrict__ cnt, const int32_t* __restrict__ err,
                int32_t* __restrict__ out, int* flags, int F, int mb, int nblk, int per) {
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t s_base[kAsmThreads];
  __shared__ int32_t s_last;
  const int img = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * per, c1 = min(c0 + per, F);
  const int64_t l0 = static_cast<int64_t>(img) * F;
  if (tid == 0) s_last = 0;  // out[nblk - 1] where no end is recorded there
  int32_t carry = 0;
  for (int t0 = 0; t0 < F; t0 += blockDim.x) {
    const int i = t0 + tid;
    const int32_t c = i < F ? cnt[l0 + i] : 0;
    int32_t sum;
    const int32_t b0 = carry + block_exclusive_scan(c, warp_sum, &sum);
    if (i >= c0 && i < c1) s_base[i - c0] = b0;
    if (i < F && b0 <= nblk - 1 && nblk - 1 < b0 + c) {
      const int k = nblk - 1 - b0;
      s_last = k < mb ? rec[(l0 + i) * mb + k] : 0;
    }
    carry += sum;
  }
  __syncthreads();
  const int32_t last = s_last;
  int32_t* o = out + static_cast<int64_t>(img) * nblk;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  for (int i = c0 + warp; i < c1; i += warps) {
    const int n = cnt[l0 + i];
    const int32_t b0 = s_base[i - c0];
    const int32_t* r = rec + (l0 + i) * mb;
    for (int j = lane; j < n && b0 + j < nblk; j += 32) o[b0 + j] = j < mb ? r[j] : 0;
  }
  if (blockIdx.x + 1 == gridDim.x) {
    for (int p = carry + tid; p < nblk; p += blockDim.x) o[p] = 0;
  }
  bool bad = false;
  if (blockIdx.x == 0 && tid == 0) {
    bad = carry < nblk || last > ends[img] || last < ends[img] - 7;
  }
  for (int i = c0 + tid; i < c1; i += blockDim.x) bad |= err[l0 + i] < last;
  if (__syncthreads_or(bad) && tid == 0) atomicAnd(flags, 0);
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// stream u8 [cap], 4-byte aligned; starts, ends int32 [B] (bits); tables
// the packed int32 tables; F sync chunks of m chunks of cb bits an image,
// L = B * F, W = bpm + 1.  lut u32 [4,096] (ops/sync.py LUT_WORDS); X, Y
// uint64 [W, L], S uint64 [m - 1, W, L], SG uint64 [m - 1, bpm, L] and CP
// uint64 [bpm, L] scratch, links u8 [L, W]; flags int32 [2] (ok, misses)
// set here.
extern "C" int zpix_sync_guess_link(const void* stream, int64_t cap, const void* starts,
                                    const void* ends, const void* tables, void* lut, void* X,
                                    void* Y, void* S, void* SG, void* CP, void* links,
                                    void* flags, int B, int F, int cb, int m, int bpm,
                                    void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (B > 0 && F > 0) {
    const int bytes = kStageWords * 4;
    if (int e = set_smem(reinterpret_cast<const void*>(guess_link_kernel), bytes)) return e;
    const int64_t L = static_cast<int64_t>(B) * F;
    const int G = kGuessThreads / bpm - 2;
    guess_link_kernel<<<static_cast<unsigned>((L + G - 1) / G), kGuessThreads, bytes,
                        static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<uint32_t*>(lut), static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y),
        static_cast<uint64_t*>(S), static_cast<uint64_t*>(SG), static_cast<uint64_t*>(CP),
        static_cast<uint8_t*>(links), static_cast<int*>(flags), B, F, cb, m, bpm);
  }
  return static_cast<int>(cudaGetLastError());
}

// tj u8 [L] scratch; fine uint64 [B, Ff] out, the entries of the Ff
// chunks of cb bits an image; links_smem_bytes: the most dynamic shared
// memory an image's links and indices may take (F * (bpm + 2) bytes);
// above it they stay in global memory.  Adds the misses to flags[1].
extern "C" int zpix_sync_resolve(const void* stream, int64_t cap, const void* starts,
                                 const void* ends, const void* tables, const void* lut, void* X,
                                 void* Y, void* S, const void* SG, const void* CP, void* links,
                                 void* tj, void* fine,
                                 void* flags, int B, int F, int Ff, int cb, int m, int bpm,
                                 int links_smem_bytes, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (B > 0 && F > 0) {
    const int need = F * (bpm + 2);
    const int smem = need <= links_smem_bytes ? need : 0;
    if (int e = set_smem(reinterpret_cast<const void*>(resolve_kernel), smem)) return e;
    resolve_kernel<<<static_cast<unsigned>(B), kResolveThreads, smem,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<const uint32_t*>(lut), static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y),
        static_cast<uint64_t*>(S), static_cast<const uint64_t*>(SG),
        static_cast<const uint64_t*>(CP), static_cast<uint8_t*>(links), static_cast<uint8_t*>(tj),
        static_cast<uint64_t*>(fine), static_cast<int*>(flags), B, F, Ff, cb, m, bpm, smem > 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// fine uint64 [B * F] (F chunks of cb bits an image) -> rec int32
// [B * F, mb], cnt and err int32 [B * F].
extern "C" int zpix_sync_record(const void* stream, int64_t cap, const void* starts,
                                const void* ends, const void* tables, const void* lut,
                                const void* fine, void* rec, void* cnt, void* err, void* flags,
                                int B, int F, int cb, int bpm, int mb, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (B > 0 && F > 0) {
    const int bytes = kStageWords * 4;
    if (int e = set_smem(reinterpret_cast<const void*>(record_kernel), bytes)) return e;
    const int64_t Lf = static_cast<int64_t>(B) * F;
    record_kernel<<<static_cast<unsigned>((Lf + kRecordThreads - 1) / kRecordThreads),
                    kRecordThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<const uint32_t*>(lut), static_cast<const uint64_t*>(fine),
        static_cast<int32_t*>(rec), static_cast<int32_t*>(cnt), static_cast<int32_t*>(err),
        static_cast<int*>(flags), B, F, cb, bpm, mb);
  }
  return static_cast<int>(cudaGetLastError());
}

// rec, cnt, err as above -> out int32 [B, nblk] (every index written) and
// ok (flags[0]) cleared where the checks fail.
extern "C" int zpix_sync_assemble(const void* ends, const void* rec, const void* cnt,
                                  const void* err, void* out, void* flags, int B, int F, int mb,
                                  int nblk, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (B > 0 && F > 0) {
    // about two blocks an SM over the batch, at most 1,024 chunks a block
    const int want = (264 + B - 1) / B, most = (F + 31) / 32;
    const int least = (F + kAsmThreads - 1) / kAsmThreads;
    const int parts = std::max(least, std::min(want, most));
    const int per = (F + parts - 1) / parts;
    assemble_kernel<<<dim3(static_cast<unsigned>((F + per - 1) / per), static_cast<unsigned>(B)),
                      kAsmThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(rec),
        static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(err),
        static_cast<int32_t*>(out), static_cast<int*>(flags), F, mb, nblk, per);
  }
  return static_cast<int>(cudaGetLastError());
}
