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
  int32_t* grid[kMaxGrids];
  int bv[kMaxGrids], bh[kMaxGrids], h[kMaxGrids], v[kMaxGrids];
  int ngrids, F, cbits, mbc;
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

// K20's lane: from (bit, slot) to the first symbol boundary at or past
// ce.  With ``rec``, the diff of its j-th symbol goes to rec[j] while
// first + j < lim.
__device__ Scan dc_scan(const Spec& p, const int32_t* tab, int32_t bit, int slot, int32_t ce,
                        int32_t* rec, int32_t first, int32_t lim) {
  BitWindow w{p.s, -(int64_t{1} << 40), 0};
  Scan r{bit, slot, 0, 0, kNoErr};
  while (r.bit < ce) {
    if ((r.bit >> 3) + 8 > p.cap) {  // never on a stacked batch: it ends in 64 zero bytes
      r.err = r.bit;
      break;
    }
    w.at(r.bit);
    const Sym y = zpix::decode_sym(tab, tab[zpix::kTabSlotDc + r.st],
                                   static_cast<int32_t>(w.bits(r.bit, 16)));
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

// Rounds to the fixed point of image b's chunk entries; every thread owns
// chunks [c0, c1).  Returns whether the entries settled; the chunks' words
// then hold the exits, counts and errors of a scan from their entries.
template <bool kAc>
__device__ bool converge(const Spec& p, const int32_t* tab, int b, int c0, int c1,
                         int32_t* rounds) {
  int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  const int full = static_cast<int>((static_cast<int64_t>(end) - start + p.cbits - 1) / p.cbits);
  const int t_ac = tab[zpix::kTabSlotAc];
  for (int c = c0; c < c1; ++c) {
    int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    q[kEntBit] = static_cast<int32_t>(chunk_start(start, end, c, p.cbits));
    q[kEntSt] = kAc ? p.ss : 0;
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
      const Scan s = kAc ? ac_scan(p, tab, t_ac, q[kEntBit], q[kEntSt], ce, nullptr, 0, 0)
                         : dc_scan(p, tab, q[kEntBit], q[kEntSt], ce, nullptr, 0, 0);
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

__global__ void __launch_bounds__(kThreads) dc_first_spec_kernel(Spec p) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  __shared__ uint32_t sh[3 * kThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < zpix::kTabEntropyWords; i += kThreads) tab[i] = p.tab[i];
  int32_t* diffs = p.diffs + static_cast<int64_t>(b) * p.nblk;
  for (int i = t; i < p.nblk; i += kThreads) diffs[i] = 0;  // symbols past the image's total
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  const bool settled = converge<false>(p, tab, b, c0, c1, p.rounds);
  const int32_t* base = p.chunks + static_cast<int64_t>(b) * p.F * kChunkWords;
  const int32_t start = p.starts[b], end = p.ends[b];
  uint32_t first[2], tot[2];
  int bad = settled ? 0 : 1;
  chunk_totals(p, base, end, c0, c1, sh, first, tot, &bad);
  if (static_cast<int64_t>(tot[0]) < p.nblk) bad = 1;
  // the record scan: every chunk again from its entry, diffs at their index
  uint32_t j = first[0];
  for (int c = c0; c < c1; ++c) {
    const int32_t* q = base + static_cast<int64_t>(c) * kChunkWords;
    const int32_t ce = chunk_end(start, end, c, p.cbits);
    if (static_cast<int64_t>(j) < p.nblk) {
      dc_scan(p, tab, q[kEntBit], q[kEntSt], ce, diffs + j, static_cast<int32_t>(j), p.nblk);
    }
    j += static_cast<uint32_t>(q[kCount]);
  }
  if (__syncthreads_or(bad) && t == 0) *p.ok = 0;
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
}

__global__ void __launch_bounds__(kThreads) ac_first_spec_kernel(Spec p) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  __shared__ uint32_t sh[3 * kThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  for (int i = t; i < zpix::kTabEntropyWords; i += kThreads) tab[i] = p.tab[i];
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  const bool settled = converge<true>(p, tab, b, c0, c1, p.rounds);
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
                void* g1, void* g2, int batch, int F, int cbits, int mbc, int nblk, int bpm,
                int ngrids, int per_row, const int* hv, const int* bh, const int* bv, int ss,
                int se, int al, void* stream) {
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
  void* grids[3] = {g0, g1, g2};
  for (int g = 0; g < ngrids; ++g) {
    p.grid[g] = static_cast<int32_t*>(grids[g]);
    p.h[g] = hv[g] & 15;
    p.v[g] = hv[g] >> 4;
    p.bh[g] = bh[g];
    p.bv[g] = bv[g];
  }
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
  if (batch > 0) {
    if (ac) {
      ac_first_spec_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    } else {
      dc_first_spec_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zpix_spec_dc_first(const void* s, int64_t cap, const void* starts,
                                  const void* ends, const void* tab, void* ok, void* rounds,
                                  void* chunks, void* diffs, void* g0, void* g1, void* g2,
                                  int batch, int F, int cbits, int mbc, int nblk, int bpm,
                                  int ngrids, int per_row, int hv0, int hv1, int hv2, int bh0,
                                  int bh1, int bh2, int bv0, int bv1, int bv2, int al,
                                  void* stream) {
  const int hv[3] = {hv0, hv1, hv2}, bh[3] = {bh0, bh1, bh2}, bv[3] = {bv0, bv1, bv2};
  return spec_launch(false, s, cap, starts, ends, tab, ok, rounds, chunks, diffs, g0, g1, g2,
                     batch, F, cbits, mbc, nblk, bpm, ngrids, per_row, hv, bh, bv, 0, 0, al,
                     stream);
}

extern "C" int zpix_spec_ac_first(const void* s, int64_t cap, const void* starts,
                                  const void* ends, const void* tab, void* ok, void* rounds,
                                  void* chunks, void* grid, int batch, int F, int cbits, int mbc,
                                  int nvalid, int nvx, int bh, int bv, int ss, int se, int al,
                                  void* stream) {
  if (ss < 1 || ss > se || se > 63) return static_cast<int>(cudaErrorInvalidValue);
  const int hv[3] = {0x11, 0, 0}, bhs[3] = {bh, 0, 0}, bvs[3] = {bv, 0, 0};
  return spec_launch(true, s, cap, starts, ends, tab, ok, rounds, chunks, nullptr, grid,
                     nullptr, nullptr, batch, F, cbits, mbc, nvalid, 1, 1, nvx, hv, bhs, bvs, ss,
                     se, al, stream);
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
