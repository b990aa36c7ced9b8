// K8, K9 and K10: the value passes of progressive JPEG in host-index mode.
//
// The host walks every scan of every image first (csrc/host/entropy.cpp,
// zpix_prog_*_index) and gives each block its exact start bit, so each
// block decodes on its own lane with no speculation.  Every lane checks
// that it ends where the host said (``agree``) and clears ``ok``
// otherwise.  A lane that would read past the stream buffer sets its error
// (the JAX passes clip such reads; on valid streams the two never differ).
// All three read a symbol through a 9-bit lookahead table that each CTA
// builds once in shared memory from the table's limits, offsets and
// symbol bytes staged there (lut_entry; ops/progressive.py::lut_plain is
// its copy), and decode longer codes in full.
//
// K8 replaces zpix_tpu/parallel/progressive_onchip.py::
// build_dc_first_value_fn (:799) and the "dc" arm of _make_update
// (:1611-1652) in one launch and a memset: one DC symbol plus
// RECEIVE/EXTEND a block (``sym > 16`` is an error, :854-858; a read past
// the buffer stores diff 0), the inclusive prefix of the diffs along each
// component's chain (uint32), and row[0] = dc << Al.  An interleaved scan
// visits every block, padding included, in (MCU, slot) order, one chain
// per component an image; a single-component scan visits the valid blocks
// in raster order, one chain.  A CTA takes tiles of whole MCUs of one
// image by ticket from an atomic counter (images interleaved, so every
// wait points at an earlier ticket and a grid of any size drains; a
// ticket is taken only when its tile can start, since a tile held back
// delays every later tile of its image), a thread a block: it decodes
// from two stream words, the CTA scans the diffs of each component (a
// vector of three sums), and warp c publishes chain c's sum over the tile
// and finds its carry by decoupled look-back over the image's earlier
// tiles (csrc/lookback.cuh, shared with K3 and K7; 2^24 polls trap),
// the chains in parallel.  Row addresses are a multiply-high division
// (FastDiv) a block.  Bound on the H100: bytes, one 32-byte sector of
// the store written a block (the rows are 256 bytes apart), the stream,
// and 8 bytes of offsets a block; the scattered 4-byte writes into a
// store larger than L2 cost more than their sectors (PERF.md, K8).
//
// K9 replaces build_ac_first_value_fn (:866) with _make_ac_sym_step's
// rules (:277-312): ZRL, EOB with run bits (consumed, not counted: the
// host counted the run), and the overflow rule (a size > 0 symbol with
// k + r > se ends the block on its code bits).  A block makes at most 64
// symbols (each advances k or ends the block); a lane still running after
// 64 clears ``ok``.  ``val << Al`` is added into the block's row in
// natural order (the JAX store adds, :1674).  A persistent grid; each warp
// walks chunks of 32 lanes (the next chunk's flags and offsets loaded
// while it decodes) and queues the blocks with data (a ballot over
// hasdata: blocks an EOB run covers take no thread), 32 at a time a lane
// each; a lane keeps its bits in two registers (a funnel shift a symbol,
// one word loaded when the position crosses a word) and adds each value
// into the store with a reduction (RED), which no thread waits on.
// (Collecting a warp's rows in shared memory and adding their written
// 32-byte pieces with 16-byte loads and stores was slower: its rows cap a
// CTA's warps and its write-back waits on the loads; PERF.md, K9.)
// Bound: bytes, the sectors of the store it touches (read and written),
// the stream, the offsets and flags.
//
// K10 replaces build_ac_refine_fn (:937-1101) with the reference's gating
// (:997-1070): an existing nonzero of the band reads one correction bit;
// a zero counts down the current symbol's run and then takes the pending
// +-1 << Al; EOB switches the block to corrections only; a block entered
// inside an EOB run starts there.  Most band positions are zeros crossed
// inside a run or an EOB (on the bench's content ~1-3 symbols and ~1-2
// correction bits a block for 63 positions), so the kernel walks a block
// a symbol at a time, not a position at a time: the warp's 32 rows come
// in coalesced through shared memory (zigzag order), each lane keeps a
// 64-bit mask of its band's nonzeros, a run ends at the (r + 1)-th zero of
// the mask, the nonzeros it crosses (and all after an EOB) read their
// correction bits as one field, and symbols come from the lookahead table
// (decode_sym for longer codes).  The warp stores back the 16-byte pieces
// of its rows that changed.  A read past the buffer stops a block at the
// same position as a per-position walk, with the same writes before it.
// Bound: bytes (the stream, the band of every row read once, the changed
// pieces written).
//
// Shifts and adds are done in uint32, so values wrap as XLA's int32 does
// (a left shift of a negative int is undefined in C++).
#include <cuda_runtime.h>

#include <cstdint>

#include "fast_div.cuh"
#include "huffman.cuh"
#include "lookback.cuh"
#include "timing.cuh"

namespace {

namespace lb = zpix_lookback;
using zpix::BitWindow;
using zpix::FastDiv;
using zpix::Sym;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLutBits = 9, kLut = 1 << kLutBits;
constexpr unsigned kLutBad = 0x8000;

__device__ __forceinline__ int32_t add_u32(int32_t x, uint32_t d) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + d);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The stream as big-endian 32-bit words from a 4-byte aligned base; bit q
// of them is bit q - sh8 of the stream (sh8 = 8 * the base's offset).
__device__ __forceinline__ uint32_t word_be(const uint32_t* g, int32_t j) {
  return __byte_perm(__ldg(g + j), 0, 0x0123);
}

// The store row of valid block l of the scan: valid blocks are the
// top-left nvy x nvx corner of the component's [bv, bh] grid, in raster
// order, image after image.
__device__ __forceinline__ int64_t valid_row(int32_t l, FastDiv per_image, int nvalid,
                                             FastDiv per_row, int nvx, int bh, int64_t nblk_c) {
  const int32_t b = static_cast<int32_t>(per_image.div(static_cast<uint32_t>(l)));
  const int32_t i = l - b * nvalid;
  const int32_t by = static_cast<int32_t>(per_row.div(static_cast<uint32_t>(i)));
  return b * nblk_c + static_cast<int64_t>(by) * bh + (i - by * nvx);
}

// ------------------------------------------------------- lookahead tables

constexpr int kStagedSyms = 256;  // symbol bytes a CTA copies into shared memory

// decode_sym's arithmetic (huffman.cuh) on a table in shared memory: its
// limits, offsets and first kStagedSyms symbol bytes (``sym``); a symbol
// past those reads device memory (``vals``).
__device__ __forceinline__ Sym decode_staged(const int32_t* lims, const int32_t* aoff,
                                             const int32_t* sym, const int32_t* vals,
                                             int32_t nvals, int32_t look) {
  int len = 1, a = aoff[0];
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    if (look >= lims[i]) {
      ++len;
      a += aoff[i + 1] - aoff[i];
    }
  }
  Sym r;
  r.len = len;
  r.bad = look >= lims[15];
  const int vidx = a + (look >> (16 - len));
  r.sym = vidx >= 0 && vidx < nvals ? (vidx < kStagedSyms ? sym[vidx] : __ldg(vals + vidx)) : 0;
  return r;
}

// Entry p of a table's lookahead table: kLutBad where every lookahead
// whose top kLutBits bits are p is invalid, len << 8 | sym where all
// decode to one code of at most kLutBits bits, 0 otherwise (decoded in
// full).  Each of decode_sym's compares is monotone in the lookahead, so
// where the two ends of p's range agree, every lookahead between agrees.
__device__ __forceinline__ uint16_t lut_entry(const int32_t* lims, const int32_t* aoff,
                                              const int32_t* sym, const int32_t* vals,
                                              int32_t nvals, int p) {
  constexpr int kLow = 16 - kLutBits;
  const Sym lo = decode_staged(lims, aoff, sym, vals, nvals, p << kLow);
  const Sym hi = decode_staged(lims, aoff, sym, vals, nvals, (p << kLow) | ((1 << kLow) - 1));
  if (lo.bad && hi.bad) return kLutBad;
  if (!lo.bad && !hi.bad && lo.len == hi.len && lo.len <= kLutBits)
    return static_cast<uint16_t>(lo.len << 8 | lo.sym);
  return 0;
}

// An AC scan's one table (slot 0's) in shared memory: its limits, value
// offsets and first symbol bytes, its lookahead table, and the natural
// index of each zigzag position.  K9 and K10 (CTAs of kStagedSyms threads).
struct AcCode {
  int32_t lims[16], aoff[16];
  int32_t nvals;
  int32_t sym[kStagedSyms];
  uint16_t lut[kLut];
  uint8_t unzig[64];
};

// Thread i's words of the AC table: limit i, offset i - 16 or nvals (i <
// 33), and symbol byte i; issued early, so that the loads overlap the
// caller's other loads.
struct AcWords {
  int32_t code, sym;
};

__device__ __forceinline__ AcWords ac_words(const int32_t* tables) {
  const int t = __ldg(tables + zpix::kTabSlotAc), i = threadIdx.x;
  AcWords w{0, __ldg(tables + zpix::kTabVals + i)};
  if (i < 33)
    w.code = __ldg(tables + (i < 16 ? zpix::kTabLims + 16 * t + i
                             : i < 32 ? zpix::kTabAoff + 16 * t + i - 16 : zpix::kTabNvals));
  return w;
}

__device__ __forceinline__ void put_ac_words(AcCode& C, AcWords w) {
  if (threadIdx.x < 16) C.lims[threadIdx.x] = w.code;
  else if (threadIdx.x < 32) C.aoff[threadIdx.x - 16] = w.code;
  else if (threadIdx.x == 32) C.nvals = w.code;
  C.sym[threadIdx.x] = w.sym;
  if (threadIdx.x < 64) C.unzig[threadIdx.x] = static_cast<uint8_t>(zpix::kUnzig[threadIdx.x]);
}

// The lookahead table, after put_ac_words and a barrier; the caller
// synchronises before reading it.
template <int kThreads>
__device__ __forceinline__ void fill_ac_lut(AcCode& C, const int32_t* vals) {
  static_assert(kThreads == kStagedSyms, "a thread a staged symbol byte");
#pragma unroll
  for (int k = 0; k < kLut / kThreads; ++k) {
    const int i = threadIdx.x + kThreads * k;
    C.lut[i] = lut_entry(C.lims, C.aoff, C.sym, vals, C.nvals, i);
  }
}

__device__ __forceinline__ Sym decode_full(const AcCode& C, const int32_t* vals, int32_t look) {
  return decode_staged(C.lims, C.aoff, C.sym, vals, C.nvals, look);
}

// ------------------------------------------------------------------ K8

constexpr int kDcTables = 4;  // tables 0..3 get a lookahead table; others decode in full
constexpr int kDcComps = 3;

struct DcCodes {
  int32_t lims[kDcTables][16], aoff[kDcTables][16];
  int32_t nvals;
  uint32_t used;  // tables named by a slot
  int32_t sym[kStagedSyms];
  uint16_t lut[kDcTables][kLut];
};

// A DC-first scan's geometry.  Interleaved: an image's blocks are n_mcu
// MCUs of bpm slots, slot s of component comp(s) at (dy, dx) inside the
// MCU; an MCU's row and column are mcu / per_row and its remainder (per_row
// = mxx).  Single component: a block an MCU (bpm 1, h = v = 1), per_row =
// nvx.  Block (by, bx) of component c of image b is row (b * bv[c] + by) *
// bh[c] + bx of grid[c].
struct DcGeo {
  int32_t* grid[kDcComps];
  int hv[kDcComps];  // h | v << 4
  int bh[kDcComps], bv[kDcComps];
  int ncomp, bpm, n_mcu, per_row_n;
  FastDiv per_row;
  int batch, tile_mcus, tpi;
};

// Slot s's component and its block's place in the MCU -> c | dy << 8 | dx << 16.
__device__ __forceinline__ int slot_place(const DcGeo& G, int s) {
  int c = 0, j = s;
  while (c + 1 < G.ncomp && j >= (G.hv[c] & 15) * (G.hv[c] >> 4)) {
    j -= (G.hv[c] & 15) * (G.hv[c] >> 4);
    ++c;
  }
  const int h = G.hv[c] & 15;
  return c | (j / h) << 8 | (j % h) << 16;
}

__global__ void __launch_bounds__(1024)
dc_first_kernel(const uint32_t* __restrict__ g, int sh8, int64_t cap,
                const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                const int32_t* __restrict__ tables, int32_t* ok, uint64_t* flags,
                uint32_t* counter, DcGeo G, int al) {
  __shared__ DcCodes D;
  __shared__ uint32_t wsum[32][kDcComps];
  __shared__ uint32_t carry[kDcComps];
  __shared__ int tile_at[2];  // the ticket's tile in its image, and the image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int tile_lanes = G.tile_mcus * G.bpm;
  // the thread's block in every tile: its MCU in the tile and its slot
  const int moff = tid / G.bpm, slot = tid - moff * G.bpm;
  const int place = slot_place(G, slot);
  const int comp = place & 255, dy = (place >> 8) & 255, dx = place >> 16;
  const int h = G.hv[comp] & 15, v = G.hv[comp] >> 4;
  int32_t* const grid = comp == 0 ? G.grid[0] : comp == 1 ? G.grid[1] : G.grid[2];
  const int bh = comp == 0 ? G.bh[0] : comp == 1 ? G.bh[1] : G.bh[2];
  const int bv = comp == 0 ? G.bv[0] : comp == 1 ? G.bv[1] : G.bv[2];
  const int t = __ldg(tables + zpix::kTabSlotDc + slot) & 7;

  // the slots' tables: limits and offsets of tables 0..3, then their
  // lookahead tables
  for (int j = tid; j < 2 * 16 * kDcTables; j += blockDim.x) {
    const int k = j >> 4, i = j & 15;
    const int32_t w = __ldg(tables + (k < kDcTables ? zpix::kTabLims + 16 * k + i
                                                    : zpix::kTabAoff + 16 * (k - kDcTables) + i));
    if (k < kDcTables) D.lims[k][i] = w;
    else D.aoff[k - kDcTables][i] = w;
  }
  for (int j = tid; j < kStagedSyms; j += blockDim.x) D.sym[j] = __ldg(tables + zpix::kTabVals + j);
  if (tid == 0) {
    D.nvals = __ldg(tables + zpix::kTabNvals);
    D.used = 0;
  }
  __syncthreads();
  if (tid < tile_lanes && t < kDcTables) atomicOr(&D.used, 1u << t);
  __syncthreads();
  const int32_t* vals = tables + zpix::kTabVals;
  for (int i = tid; i < kDcTables * kLut; i += blockDim.x) {
    const int k = i >> kLutBits;
    if ((D.used >> k) & 1)
      D.lut[k][i & (kLut - 1)] =
          lut_entry(D.lims[k], D.aoff[k], D.sym, vals, D.nvals, i & (kLut - 1));
  }

  const int32_t lim = static_cast<int32_t>(8 * (cap - 7));  // a read at bit p needs p < lim
  const int nblk = G.n_mcu * G.bpm;
  while (true) {
    __syncthreads();  // the tables, or the last tile's shared words
    if (tid == 0) {  // a ticket is taken only when its tile can start
      const int tk = static_cast<int>(atomicAdd(counter, 1u));
      tile_at[0] = tk / G.batch;  // a division a tile
      tile_at[1] = tk - tile_at[0] * G.batch;
    }
    __syncthreads();
    const int ti = tile_at[0], b = tile_at[1];
    if (ti >= G.tpi) break;
    const int mcu = ti * G.tile_mcus + moff;
    const bool live = tid < tile_lanes && mcu < G.n_mcu;
    const int32_t l = b * nblk + mcu * G.bpm + slot;

    // the block's diff
    uint32_t diff = 0;
    bool err = false;
    if (live) {
      const int32_t pos = starts[l], end = ends[l];
      err = true;
      if (pos < lim) {
        const int32_t q = pos + sh8;
        const uint32_t win = __funnelshift_l(word_be(g, (q >> 5) + 1), word_be(g, q >> 5), q & 31);
        const int32_t look = static_cast<int32_t>(win >> 16);
        Sym s;
        const unsigned e = t < kDcTables ? D.lut[t][win >> (32 - kLutBits)] : 0u;
        if (e != 0 && !(e & kLutBad)) {
          s.len = e >> 8 & 15;
          s.sym = e & 255;
          s.bad = false;
        } else if (t < kDcTables) {
          s = decode_staged(D.lims[t], D.aoff[t], D.sym, vals, D.nvals, look);
        } else {
          s = zpix::decode_sym(tables, t, look);
        }
        if (s.sym > 0) {  // RECEIVE + EXTEND, at most 16 bits (huffman.cuh)
          const int sz = min(s.sym, 16), top = min(s.sym - 1, 15);
          const uint32_t raw = (win << s.len) >> (32 - sz);
          diff = raw < (1u << top) ? raw - ((1u << sz) - 1u) : raw;
        }
        err = s.bad || s.sym > 16 || pos + s.len + s.sym != end;
      }
    }
    if (__ballot_sync(kFull, err) && lane == 0) atomicAnd(ok, 0);

    // the inclusive prefix of each chain inside the tile
    uint32_t x[kDcComps];
#pragma unroll
    for (int c = 0; c < kDcComps; ++c) x[c] = live && comp == c ? diff : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < kDcComps; ++c) {
        const uint32_t y = __shfl_up_sync(kFull, x[c], d);
        if (lane >= d) x[c] += y;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < kDcComps; ++c) wsum[warp][c] = x[c];
    }
    __syncthreads();
    // warp c: chain c's sum over the tile's warps, published, then its
    // carry by look-back (the chains in parallel)
    for (int c = warp; c < G.ncomp; c += nw) {
      const int64_t t0 = static_cast<int64_t>(b) * G.tpi;  // the image's first tile
      uint64_t* mine = flags + (t0 + ti) * kDcComps + c;
      uint32_t s = lane < nw ? wsum[lane][c] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      if (lane < nw) wsum[lane][c] = s;
      const uint32_t total = __shfl_sync(kFull, s, 31);
      if (lane == 0) lb::publish(mine, ti == 0 ? lb::kInclusive : lb::kAggregate, total);
      const uint32_t in = ti == 0 ? 0u : lb::carry_in(flags + t0 * kDcComps + c, ti, kDcComps);
      if (lane == 0) {
        if (ti > 0) lb::publish(mine, lb::kInclusive, in + total);
        carry[c] = in;
      }
    }
    __syncthreads();

    // row 0 of the block
    if (live) {
      uint32_t dc = carry[comp] + (warp ? wsum[warp - 1][comp] : 0u);
#pragma unroll
      for (int c = 0; c < kDcComps; ++c)
        if (c == comp) dc += x[c];
      const int32_t row = static_cast<int32_t>(G.per_row.div(static_cast<uint32_t>(mcu)));
      const int32_t col = mcu - row * G.per_row_n;
      grid[((static_cast<int64_t>(b) * bv + row * v + dy) * bh + col * h + dx) * 64] =
          static_cast<int32_t>(dc << al);
    }
  }
}

// ------------------------------------------------------------------ K9

constexpr int kAcWarps = 8;  // warps a CTA (PERF.md, K9)

// Block ``start``..``end`` of a K9 scan into its store row (natural order):
// each value added with a reduction (RED: no thread waits on it) -> whether
// the block fails.
__device__ __forceinline__ bool ac_first_block(const uint32_t* g, int sh8, int32_t lim,
                                               int32_t start, int32_t end, const AcCode& C,
                                               const int32_t* vals, int32_t* row, int ss,
                                               int se, int al) {
  int32_t pos = start;
  int32_t j = (pos + sh8) >> 5;  // the word in w0
  uint32_t w0 = 0, w1 = 0;
  if (pos < lim) {
    w0 = word_be(g, j);
    w1 = word_be(g, j + 1);
  }
  int k = ss;
  bool done = false;
  for (int it = 0; it < 64 && !done; ++it) {
    if (pos >= lim) return true;
    const int32_t q = pos + sh8;
    if ((q >> 5) != j) {  // a symbol advances at most 31 bits: the next word
      j = q >> 5;
      w0 = w1;
      w1 = word_be(g, j + 1);
    }
    const uint32_t win = __funnelshift_l(w1, w0, q & 31);
    const unsigned e = C.lut[win >> (32 - kLutBits)];
    if (e & kLutBad) return true;
    int len = e >> 8 & 15, sym = e & 255;
    if (e == 0) {  // a code longer than kLutBits bits
      const Sym y = decode_full(C, vals, static_cast<int32_t>(win >> 16));
      if (y.bad) return true;
      len = y.len;
      sym = y.sym;
    }
    const int r = sym >> 4, size = sym & 15;
    if (size == 0) {
      if (r < 15) {  // EOB: the run's bits are skipped (the host counted them)
        pos += len + r;
        done = true;
      } else {  // ZRL
        pos += len;
        k += 16;
        done = k > se;
      }
    } else if (k + r > se) {  // the overflow rule: code bits only
      pos += len;
      done = true;
    } else {
      const uint32_t raw = (win << len) >> (32 - size);
      const uint32_t val = raw < (1u << (size - 1)) ? raw - ((1u << size) - 1u) : raw;
      atomicAdd(reinterpret_cast<unsigned*>(row + C.unzig[k + r]), val << al);
      k += r + 1;
      pos += len + size;
      done = k > se;
    }
  }
  return !done || pos != end;
}

// A warp's queue of blocks with data: lane, start and end bits.
struct AcQueue {
  int32_t l[64], start[64], end[64];
};

__global__ void __launch_bounds__(32 * kAcWarps)
ac_first_kernel(const uint32_t* __restrict__ g, int sh8, int64_t cap,
                const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                const int32_t* __restrict__ hasdata, const int32_t* __restrict__ tables,
                int32_t* __restrict__ store, int32_t* ok, int n_lanes, FastDiv per_image,
                int nvalid, FastDiv per_row, int nvx, int bh, int64_t nblk_c, int ss, int se,
                int al) {
  __shared__ AcCode C;
  __shared__ AcQueue s_queue[kAcWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  AcQueue& q = s_queue[warp];
  const int n_chunks = (n_lanes + 31) >> 5, stride = gridDim.x * kAcWarps;
  // the warp's first chunk of 32 lanes: flags and offsets, loaded under
  // the table build
  int ch = blockIdx.x * kAcWarps + warp;
  int32_t nl = ch * 32 + lane;
  bool nhas = false;
  int32_t nst = 0, nen = 0;
  if (ch < n_chunks && nl < n_lanes) {
    nhas = hasdata[nl] != 0;
    nst = starts[nl];
    nen = ends[nl];
  }
  put_ac_words(C, ac_words(tables));
  __syncthreads();
  const int32_t* vals = tables + zpix::kTabVals;
  fill_ac_lut<32 * kAcWarps>(C, vals);
  __syncthreads();

  const int32_t lim = static_cast<int32_t>(8 * (cap - 7));  // a read at bit p needs p < lim
  int queued = 0;
  bool fail = false;
  for (;; ch += stride) {
    const bool more = ch < n_chunks;
    if (more) {  // the chunk's blocks with data onto the queue; the next chunk's loads out
      const bool has = nhas;
      const int32_t l = nl, st = nst, en = nen;
      nl += stride * 32;
      nhas = false;
      if (ch + stride < n_chunks && nl < n_lanes) {
        nhas = hasdata[nl] != 0;
        nst = starts[nl];
        nen = ends[nl];
      }
      const unsigned m = __ballot_sync(kFull, has);
      if (has) {
        const int at = queued + __popc(m & lanemask_lt());
        q.l[at] = l;
        q.start[at] = st;
        q.end[at] = en;
      }
      queued += __popc(m);
      __syncwarp();
    }
    if (queued >= 32 || (!more && queued > 0)) {  // 32 blocks, a lane each
      if (lane < queued) {
        int32_t* row = store + valid_row(q.l[lane], per_image, nvalid, per_row, nvx, bh,
                                         nblk_c) * 64;
        fail |= ac_first_block(g, sh8, lim, q.start[lane], q.end[lane], C, vals, row, ss, se,
                               al);
      }
      __syncwarp();
      if (queued > 32 && lane < queued - 32) {
        q.l[lane] = q.l[32 + lane];
        q.start[lane] = q.start[32 + lane];
        q.end[lane] = q.end[32 + lane];
      }
      queued = queued > 32 ? queued - 32 : 0;
      __syncwarp();
    }
    if (!more) break;
  }
  if (__ballot_sync(kFull, fail) && lane == 0) atomicAnd(ok, 0);
}

// ------------------------------------------------------------- K10

constexpr int kRefineWarps = 8;  // warps a CTA, 32 lanes (blocks) each (PERF.md, K10)
// Words a row in shared memory (natural order, 16-byte aligned): lane
// i's 16-byte piece g sits in bank group (i + g) % 8, so a quarter warp's
// 16-byte reads of one piece each are free of conflicts.
constexpr int kRowWords = 68;
constexpr int kRowsSmem = kRefineWarps * 32 * kRowWords * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The zigzag index of natural index j (the inverse of kUnzig): diagonal
// d = row + column, walked up (odd d) or down (even d).  Folds to a
// constant where j is one.
__device__ __forceinline__ constexpr int zig_of(int j) {
  const int r = j >> 3, c = j & 7, d = r + c;
  if (d < 8) return d * (d + 1) / 2 + ((d & 1) ? r : c);
  return 64 - (15 - d) * (16 - d) / 2 + ((d & 1) ? r : c) - (d - 7);
}

// The correction bits of the nonzeros ``corr`` (zigzag bits, read in
// order from pos): where a bit is 1, the coefficient moves by delta away
// from zero (row in natural order; dirty gets its natural bit).  Read as
// fields of up to 32 bits.  Positions only grow, so the last read tells
// whether any fails (a read at bit p needs p < lim); where one does, the
// reads before it are made and applied and false is returned, as the
// per-position walk stops at that read.
__device__ __forceinline__ bool correct(BitWindow& w, int64_t& pos, int64_t lim, uint64_t corr,
                                        int32_t* row, const uint8_t* unzig, uint32_t delta,
                                        uint64_t& dirty) {
  const int c = __popcll(corr);
  const int64_t room = lim - pos;
  const bool fits = c == 0 || room >= c;
  int left = fits ? c : static_cast<int>(room > 0 ? room : 0);
  while (left > 0) {
    const int n = left < 32 ? left : 32;
    w.at(pos);
    uint32_t f = w.bits(pos, n) << (32 - n);
    pos += n;
    left -= n;
    for (int i = 0; i < n; ++i) {
      const int kz = __ffsll(static_cast<long long>(corr)) - 1;
      corr &= corr - 1;
      if (f & 0x80000000u) {
        const int j = unzig[kz];
        const int32_t v = row[j];
        row[j] = add_u32(v, v > 0 ? delta : 0u - delta);
        dirty |= uint64_t(1) << j;
      }
      f <<= 1;
    }
  }
  return fits;
}

// The store row of valid block i of image b, for K10's int64 lanes.
__device__ __forceinline__ int64_t valid_row64(int64_t lane, int nvalid, int nvx, int bh,
                                               int64_t nblk_c) {
  const int64_t b = lane / nvalid;
  const int i = static_cast<int>(lane - b * nvalid);
  return b * nblk_c + static_cast<int64_t>(i / nvx) * bh + i % nvx;
}

// A warp takes 32 consecutive lanes (valid blocks, mostly side by side in
// one block row) and copies their rows into shared memory with 16-byte
// cp.async while the CTA builds its lookahead table; each lane walks its
// block a symbol at a time on a 64-bit mask of its band's nonzeros
// (zigzag bits); the warp then stores the 16-byte pieces of its rows that
// changed.
__global__ void __launch_bounds__(32 * kRefineWarps)
ac_refine_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                 const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                 const int32_t* __restrict__ eob_entry, const int32_t* __restrict__ tables,
                 int32_t* __restrict__ store, int32_t* ok, int64_t n_lanes, int nvalid,
                 int nvx, int bh, int64_t nblk_c, int ss, int se, int al, bool vec) {
  extern __shared__ __align__(16) int32_t s_rows[];  // kRowsSmem: a warp's rows each
  __shared__ AcCode C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile0 = (static_cast<int64_t>(blockIdx.x) * kRefineWarps + warp) * 32;
  const int64_t L = tile0 + lane;
  const bool live = L < n_lanes;
  int32_t* rows = s_rows + warp * 32 * kRowWords;
  int32_t* my = rows + lane * kRowWords;
  const int64_t rb = live ? valid_row64(L, nvalid, nvx, bh, nblk_c) * 64 : 0;

  // the scan's AC table, the rows (two a step, lane l taking words
  // 4c..4c+3, c = l % 16) and the lane's offsets on their way, while the
  // CTA builds the lookahead table
  const int32_t* vals = tables + zpix::kTabVals;
  const AcWords words = ac_words(tables);
  const int c = lane & 15;
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int r = 2 * it + (lane >> 4);
    const int64_t base = __shfl_sync(kFull, rb, r);
    if (tile0 + r < n_lanes) {
      const int32_t* g = store + base + 4 * c;
      int32_t* d = rows + r * kRowWords + 4 * c;
      if (vec) {
        cp_async16(d, g);
      } else {
        d[0] = g[0];
        d[1] = g[1];
        d[2] = g[2];
        d[3] = g[3];
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  int64_t pos = 0, end = 0;
  bool in_eob = true;
  if (live) {
    pos = starts[L];
    end = ends[L];
    in_eob = eob_entry[L] != 0;
  }
  put_ac_words(C, words);
  __syncthreads();
  fill_ac_lut<32 * kRefineWarps>(C, vals);
  // the lane's first 8 stream bytes
  const int64_t lim = 8 * (cap - 7);  // a read at bit p needs the 8 bytes from p >> 3
  const int64_t b0 = live && pos < lim ? pos >> 3 : -1;
  uint32_t first[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) first[i] = b0 >= 0 ? __ldg(stream + b0 + i) : 0u;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();  // the rows, and the lookahead table

  uint64_t dirty = 0;  // natural positions written
  if (live) {
    const uint64_t band = (~uint64_t(0) >> (63 - se)) & (~uint64_t(0) << ss);
    uint64_t nzm = 0;  // the nonzeros, zigzag bits
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(my + 4 * q);
      nzm |= (static_cast<uint64_t>(v.x != 0) << zig_of(4 * q)) |
             (static_cast<uint64_t>(v.y != 0) << zig_of(4 * q + 1)) |
             (static_cast<uint64_t>(v.z != 0) << zig_of(4 * q + 2)) |
             (static_cast<uint64_t>(v.w != 0) << zig_of(4 * q + 3));
    }
    nzm &= band;
    const uint32_t delta = 1u << al;
    BitWindow w{stream, -(int64_t(1) << 40), 0};
    if (b0 >= 0) {
      uint64_t v = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) v = (v << 8) | first[i];
      w.win = v;
      w.wbyte = b0;
    }
    bool err = false;
    int kz = ss;
    while (!in_eob && kz <= se) {  // a symbol at kz, then its run
      if (pos >= lim) {
        err = true;
        break;
      }
      w.at(pos);
      const int32_t look = static_cast<int32_t>(w.bits(pos, 16));
      const unsigned e = C.lut[look >> (16 - kLutBits)];
      bool bad = e & kLutBad;
      int len = e >> 8 & 15, sym = e & 255;
      if (e == 0) {  // a code longer than kLutBits bits
        const Sym y = decode_full(C, vals, look);
        bad = y.bad;
        len = y.len;
        sym = y.sym;
      }
      const int r = sym >> 4, sz = sym & 15;
      if (bad || sz > 1) {  // a refinement's size is 0 or 1
        err = true;
        break;
      }
      if (sz == 0 && r < 15) {  // EOB: its run bits are a length only
        pos += len + r;
        in_eob = true;
        break;
      }
      uint32_t pending = 0;
      int nz = 15;  // ZRL: 16 zeros crossed, the 16th "placed" as 0
      if (sz == 1) {
        pending = w.bits(pos + len, 1) ? delta : 0u - delta;
        nz = r;
        pos += len + 1;
      } else {
        pos += len;
      }
      // the run ends at the (nz + 1)-th zero from kz; the nonzeros before
      // it read their correction bits
      const uint64_t from = ~uint64_t(0) << kz;
      uint64_t zeros = band & from & ~nzm;
      for (int i = 0; i < nz && zeros; ++i) zeros &= zeros - 1;
      const int at = zeros ? __ffsll(static_cast<long long>(zeros)) - 1 : 64;
      const uint64_t before = at < 64 ? (uint64_t(1) << at) - 1 : ~uint64_t(0);
      if (!correct(w, pos, lim, nzm & from & before, my, C.unzig, delta, dirty)) {
        err = true;
        break;
      }
      if (at == 64) {  // the run passes se
        kz = 64;
        break;
      }
      if (pending) {
        const int j = C.unzig[at];
        my[j] = static_cast<int32_t>(pending);
        dirty |= uint64_t(1) << j;
      }
      kz = at + 1;
    }
    if (in_eob && !err &&
        !correct(w, pos, lim, nzm & (~uint64_t(0) << kz), my, C.unzig, delta, dirty))
      err = true;
    if (err || pos != end) atomicAnd(ok, 0);
  }
  __syncwarp();

  // the 16-byte pieces that changed, out
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int r = 2 * it + (lane >> 4);
    const int64_t base = __shfl_sync(kFull, rb, r);
    const uint64_t d = __shfl_sync(kFull, dirty, r);
    if ((d >> (4 * c)) & 15u) {
      const int4 v = *reinterpret_cast<const int4*>(rows + r * kRowWords + 4 * c);
      int32_t* g = store + base + 4 * c;
      if (vec) {
        *reinterpret_cast<int4*>(g) = v;
      } else {
        g[0] = v.x;
        g[1] = v.y;
        g[2] = v.z;
        g[3] = v.w;
      }
    }
  }
}

// The stream's 4-byte aligned base and its bit shift.
struct Aligned {
  const uint32_t* g;
  int sh8;
};

Aligned aligned(const void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(stream);
  return {reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3)), static_cast<int>(a & 3) * 8};
}

}  // namespace

// K8: ``tile_mcus`` MCUs a tile and ``grid`` CTAs (ops/progressive.py
// picks both; the CTA has a thread a block of the tile, rounded up to a
// warp); ``scratch`` holds batch * tpi * 3 uint64 flags and the ticket
// counter, zeroed here.  A per_row divisor is a (magic, shift) pair.
extern "C" int zpix_prog_dc_first(const void* stream, int64_t cap, const void* starts,
                                  const void* ends, const void* tables, void* ok, void* g0,
                                  void* g1, void* g2, void* scratch, int batch, int n_mcu,
                                  int bpm, int ncomp, int per_row_n, int per_row_magic,
                                  int per_row_shift, int hv0, int hv1, int hv2, int bh0, int bh1,
                                  int bh2, int bv0, int bv1, int bv2, int al, int tile_mcus,
                                  int grid, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (ncomp < 1 || ncomp > kDcComps || bpm < 1 || bpm > 16 || tile_mcus < 1 ||
      tile_mcus * bpm > 1024 || grid < 1 || cap >= (int64_t(1) << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && n_mcu > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    DcGeo G;
    G.grid[0] = static_cast<int32_t*>(g0);
    G.grid[1] = static_cast<int32_t*>(g1);
    G.grid[2] = static_cast<int32_t*>(g2);
    G.hv[0] = hv0, G.hv[1] = hv1, G.hv[2] = hv2;
    G.bh[0] = bh0, G.bh[1] = bh1, G.bh[2] = bh2;
    G.bv[0] = bv0, G.bv[1] = bv1, G.bv[2] = bv2;
    G.ncomp = ncomp, G.bpm = bpm, G.n_mcu = n_mcu, G.per_row_n = per_row_n;
    G.per_row = FastDiv{static_cast<uint32_t>(per_row_magic), per_row_shift};
    G.batch = batch, G.tile_mcus = tile_mcus;
    G.tpi = (n_mcu + tile_mcus - 1) / tile_mcus;
    const int64_t tiles = static_cast<int64_t>(batch) * G.tpi;
    uint64_t* flags = static_cast<uint64_t*>(scratch);
    uint32_t* counter = reinterpret_cast<uint32_t*>(flags + tiles * kDcComps);
    cudaError_t err =
        cudaMemsetAsync(flags, 0, tiles * kDcComps * sizeof(uint64_t) + sizeof(uint64_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Aligned a = aligned(stream);
    const int threads = (tile_mcus * bpm + 31) / 32 * 32;
    dc_first_kernel<<<static_cast<unsigned>(grid < tiles ? grid : tiles), threads, 0, st>>>(
        a.g, a.sh8, cap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        static_cast<const int32_t*>(tables), static_cast<int32_t*>(ok), flags, counter, G, al);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9: ``grid`` CTAs of kAcWarps warps (ops/progressive.py::ac_first_grid);
// the divisors of nvalid and nvx as (magic, shift) pairs.
extern "C" int zpix_prog_ac_first(const void* stream, int64_t cap, const void* starts,
                                  const void* ends, const void* hasdata, const void* tables,
                                  void* store, void* ok, int n_lanes, int nvalid,
                                  int nvalid_magic, int nvalid_shift, int nvx, int nvx_magic,
                                  int nvx_shift, int bh, int64_t nblk_c, int ss, int se, int al,
                                  int grid, void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (grid < 1 || n_lanes < 0 || cap >= (int64_t(1) << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes > 0) {
    const Aligned a = aligned(stream);
    ac_first_kernel<<<static_cast<unsigned>(grid), 32 * kAcWarps, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        a.g, a.sh8, cap, static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
        static_cast<const int32_t*>(hasdata), static_cast<const int32_t*>(tables),
        static_cast<int32_t*>(store), static_cast<int32_t*>(ok), n_lanes,
        FastDiv{static_cast<uint32_t>(nvalid_magic), nvalid_shift}, nvalid,
        FastDiv{static_cast<uint32_t>(nvx_magic), nvx_shift}, nvx, bh, nblk_c, ss, se, al);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zpix_prog_ac_refine(const void* stream, int64_t cap, const void* starts,
                                   const void* ends, const void* eob_entry,
                                   const void* tables, void* store, void* ok,
                                   int64_t n_lanes, int nvalid, int nvx, int bh,
                                   int64_t nblk_c, int ss, int se, int al,
                                   void* cuda_stream) {
  const zpix::TimedEntry timed(cuda_stream);
  if (n_lanes > 0) {
    constexpr int kLanes = 32 * kRefineWarps;
    if (kRowsSmem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          ac_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    ac_refine_kernel<<<static_cast<unsigned>((n_lanes + kLanes - 1) / kLanes), kLanes,
                       kRowsSmem, static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(eob_entry),
        static_cast<const int32_t*>(tables), static_cast<int32_t*>(store),
        static_cast<int32_t*>(ok), n_lanes, nvalid, nvx, bh, nblk_c, ss, se, al,
        reinterpret_cast<uintptr_t>(store) % 16 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}
