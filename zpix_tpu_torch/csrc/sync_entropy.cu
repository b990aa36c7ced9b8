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
// chunk.  Here, on sync chunks of m chunks (ops/sync.py SYNC_BYTES), all
// on the caller's stream:
//
//  1. guess (K19b): a thread a (sync chunk j, slot guess v) scans chunk j
//     from its start with slot v (chunk 0 from the image's start) -> X[v][j],
//     a candidate entry of chunk j + 1.  A wrong guess merges with the
//     serial decode within a few symbols more often than not.
//  2. link: a thread a (j, v) scans chunk j from X[v][j - 1] -> Y[v][j] and
//     finds it among chunk j + 1's candidates: links[j][v] = u with
//     X[u][j] == Y[v][j], or kMiss.
//  3. resolve: a block an image composes the links by pointer jumping
//     (log2 steps over [chunk][candidate] u8 maps), giving each chunk's
//     candidate index t_j from t_1 = 0 (chunk 0's exit is exact).  At the
//     first miss j (the true entry, Y[t_{j-1}][j - 1], is no candidate) one
//     thread puts it in as candidate bpm of chunk j, scans chunk j from it
//     and links the exit; then the composition runs again.  A miss costs a
//     scan and never a wrong entry.
//  4. refine (m > 1): a thread a sync chunk walks on from its entry and
//     takes the state at each of its m chunks' starts.
//  5. record (K19d, :427-442): a thread a chunk scans from its entry,
//     counts the blocks that end in it and writes the first mb end bits
//     into its row of rec [L, mb] (only the ends it has: ~4 bytes a block);
//     a block past mb or a code no table holds sets its error bit.
//  6. assemble (:444-466): a block an image takes the exclusive prefix of
//     its chunks' counts and moves each chunk's ends to their raster
//     indices, a warp a chunk; then clears ok unless sum cnt >= nblk, the
//     last end lies in [img_end - 7, img_end] and every error bit lies at
//     or past that end.  A lane whose 8-byte read would pass the buffer
//     stops and clears ok (record), where the JAX package clips the read.
//
// Bound on the H100: the serial symbol chain of a sync chunk times the
// passes over it (guess, link, refine; a miss adds one on one thread) and
// of a chunk once (record), not bytes.  The tables sit in shared memory and
// the stream is read through a 64-bit window (csrc/huffman.cuh, as K1);
// there is no host sync and no launch a round.
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"

namespace {

using zpix::BitWindow;
using zpix::Sym;

constexpr int kThreads = 128;
constexpr int32_t kErrNone = 0x7fffffff;  // ops/sync.py ERR_NONE

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

__device__ __forceinline__ void stage_tables(int32_t* tab, const int32_t* tables) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
}

struct Chunk {
  int img, c;
  int64_t start, end;  // the chunk's first bit and end bit, clipped to the image
};

__device__ __forceinline__ Chunk chunk_of(int64_t lane, int F, int chunk_bits,
                                          const int32_t* starts, const int32_t* ends) {
  Chunk ch;
  ch.img = static_cast<int>(lane / F);
  ch.c = static_cast<int>(lane - static_cast<int64_t>(ch.img) * F);
  const int64_t raw = starts[ch.img] + static_cast<int64_t>(ch.c) * chunk_bits;
  const int64_t e = ends[ch.img];
  ch.start = raw < e ? raw : e;
  ch.end = raw + chunk_bits < e ? raw + chunk_bits : e;
  return ch;
}

// Decodes from s to the first symbol boundary at or past ce; s becomes the
// exit state.  A bad code stops the lane at that symbol (its start lowers
// *err).  With kRecord, each block end is counted in *cnt and the first mb
// written to rec; a block past mb lowers *err.  Returns false where a read
// would pass the buffer (the lane stops there).
template <bool kRecord>
__device__ bool scan(const int32_t* tab, const uint8_t* stream, int64_t cap, State& s,
                     int64_t ce, int bpm, int32_t* err, int* cnt, int32_t* rec, int mb) {
  BitWindow w{stream, -(int64_t(1) << 40), 0};
  while (s.bit < ce) {
    if ((s.bit >> 3) + 8 > cap) return false;
    w.at(s.bit);
    const bool dc = s.phase == 0;
    const int t = dc ? tab[zpix::kTabSlotDc + s.slot] : tab[zpix::kTabSlotAc + s.slot];
    const Sym y = zpix::decode_sym(tab, t, static_cast<int32_t>(w.bits(s.bit, 16)));
    if (y.bad) {
      if (kRecord && s.bit < *err) *err = static_cast<int32_t>(s.bit);
      return true;
    }
    const int r = dc ? 0 : y.sym >> 4;
    const int size = dc ? y.sym : y.sym & 15;
    const int64_t end = s.bit + y.len + size;
    int new_k = s.k;
    bool blk_done = false;
    if (dc) {
      new_k = 1;
    } else if (size > 0) {
      new_k = min(max(s.k + r, 0), 63) + 1;
      blk_done = new_k > 63;
    } else if (r != 15) {
      blk_done = true;  // EOB
    } else {
      new_k = s.k + 16;  // ZRL
      blk_done = new_k > 63;
    }
    if (blk_done) {
      if (kRecord) {
        if (*cnt < mb) {
          rec[*cnt] = static_cast<int32_t>(end);
        } else if (s.bit < *err) {
          *err = static_cast<int32_t>(s.bit);
        }
        ++*cnt;
      }
      s.slot = s.slot + 1 >= bpm ? 0 : s.slot + 1;
      s.k = 0;
      s.phase = 0;
    } else {
      s.k = new_k;
      if (dc) s.phase = 1;
    }
    s.bit = end;
  }
  return true;
}

// A thread a (sync chunk, slot guess): the chunk scanned from its start
// with the guess's slot -> ex[v * L + lane], a candidate entry of the next.
__global__ void guess_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                             const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                             const int32_t* __restrict__ tables, uint64_t* __restrict__ ex,
                             int B, int F, int chunk_bits, int bpm) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t L = static_cast<int64_t>(B) * F;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= L * bpm) return;
  const int v = static_cast<int>(t / L);
  const int64_t lane = t - v * L;
  const Chunk ch = chunk_of(lane, F, chunk_bits, starts, ends);
  State s{ch.start, ch.c == 0 ? 0 : v, 0, 0};  // chunk 0: the image's start
  scan<false>(tab, stream, cap, s, ch.end, bpm, nullptr, nullptr, nullptr, 0);
  ex[t] = pack(s);
}

constexpr uint8_t kMiss = 0xFF;

// The candidate u of X[.][lane] (rows 0..bpm; row bpm is all ones, never a
// packed state, until a miss puts one there) equal to e, or kMiss.
__device__ __forceinline__ uint8_t find(const uint64_t* X, int64_t L, int64_t lane, int bpm,
                                        uint64_t e) {
  for (int u = 0; u <= bpm; ++u) {
    if (X[u * L + lane] == e) return static_cast<uint8_t>(u);
  }
  return kMiss;
}

// A thread a (sync chunk j >= 1, candidate v): chunk j scanned from X[v][j - 1]
// -> Y[v][j] and its link among chunk j + 1's candidates.
__global__ void link_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                            const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                            const int32_t* __restrict__ tables, const uint64_t* __restrict__ X,
                            uint64_t* __restrict__ Y, uint8_t* __restrict__ links, int B, int F,
                            int chunk_bits, int bpm) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t L = static_cast<int64_t>(B) * F;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= L * bpm) return;
  const int v = static_cast<int>(t / L);
  const int64_t lane = t - v * L;
  const Chunk ch = chunk_of(lane, F, chunk_bits, starts, ends);
  if (v == 0) links[lane * (bpm + 1) + bpm] = kMiss;
  if (ch.c == 0) return;
  State s = unpack(X[v * L + lane - 1]);
  scan<false>(tab, stream, cap, s, ch.end, bpm, nullptr, nullptr, nullptr, 0);
  const uint64_t e = pack(s);
  Y[v * L + lane] = e;
  links[lane * (bpm + 1) + v] = ch.c + 1 < F ? find(X, L, lane, bpm, e) : kMiss;
}

// A block an image: the links composed by pointer jumping -> each sync
// chunk's candidate index, misses put in and linked by one thread, then
// the entries.  maps: 2 x [L, bpm + 1] u8 scratch.
__global__ void resolve_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                               const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ ends,
                               const int32_t* __restrict__ tables, uint64_t* X, uint64_t* Y,
                               uint8_t* links, uint8_t* maps, uint64_t* __restrict__ entries,
                               int* misses, int B, int F, int chunk_bits, int bpm) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  __shared__ int first_miss;
  stage_tables(tab, tables);
  const int64_t L = static_cast<int64_t>(B) * F;
  const int img = blockIdx.x, W = bpm + 1;
  const int64_t base = static_cast<int64_t>(img) * F;
  const int64_t start = starts[img], end = ends[img];
  // J: the image's last sync chunk that holds bits (chunks past it are empty)
  const int J = end > start ? static_cast<int>((end - start + chunk_bits - 1) / chunk_bits) - 1
                            : 0;
  uint8_t* buf[2] = {maps, maps + L * W};
  int cur = 0;
  for (;;) {
    // G_j maps t_{j-1} to t_j (G_1 the identity); after the jumps, t_1 to t_j
    for (int i = threadIdx.x; i < J * W; i += blockDim.x) {
      const int j = 1 + i / W, x = i % W;
      buf[0][(base + j) * W + x] = j == 1 ? x : links[(base + j - 1) * W + x];
    }
    __syncthreads();
    cur = 0;
    for (int d = 1; d < J; d <<= 1) {
      for (int i = threadIdx.x; i < J * W; i += blockDim.x) {
        const int j = 1 + i / W, x = i % W;
        const uint8_t* g = buf[cur];
        uint8_t r = g[(base + j) * W + x];
        if (j - d >= 1) {
          const uint8_t u = g[(base + j - d) * W + x];
          r = u == kMiss ? kMiss : g[(base + j) * W + u];
        }
        buf[cur ^ 1][(base + j) * W + x] = r;
      }
      __syncthreads();
      cur ^= 1;
    }
    if (threadIdx.x == 0) first_miss = J + 1;
    __syncthreads();
    for (int j = 2 + threadIdx.x; j <= J; j += blockDim.x) {
      if (buf[cur][(base + j) * W] == kMiss) atomicMin(&first_miss, j);
    }
    __syncthreads();
    const int jm = first_miss;
    if (jm > J) break;
    if (threadIdx.x == 0) {  // chunk jm enters at Y[t][jm - 1], no candidate: put it in
      const int p = jm - 1;
      const int tp = buf[cur][(base + p) * W];
      const uint64_t e = Y[tp * L + base + p];
      X[bpm * L + base + p] = e;
      links[(base + p) * W + tp] = static_cast<uint8_t>(bpm);
      State s = unpack(e);
      const int64_t raw = start + static_cast<int64_t>(jm) * chunk_bits;
      scan<false>(tab, stream, cap, s, raw + chunk_bits < end ? raw + chunk_bits : end, bpm,
                  nullptr, nullptr, nullptr, 0);
      const uint64_t ex = pack(s);
      Y[bpm * L + base + jm] = ex;
      links[(base + jm) * W + bpm] = jm + 1 < F ? find(X, L, base + jm, bpm, ex) : kMiss;
      atomicAdd(misses, 1);
    }
    __syncthreads();
  }
  const uint64_t first = pack(State{start, 0, 0, 0});
  // past J every chunk enters at chunk J's exit
  const uint64_t after =
      J == 0 ? X[base] : Y[static_cast<int64_t>(buf[cur][(base + J) * W]) * L + base + J];
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    uint64_t e = first;
    if (j > J) {
      e = after;
    } else if (j >= 1) {
      e = X[static_cast<int64_t>(buf[cur][(base + j) * W]) * L + base + j - 1];
    }
    entries[base + j] = e;
  }
}

// A thread a sync chunk of m chunks: from its converged entry it walks on
// and takes the state at each of its chunks' starts (fine[j] for chunk j of
// chunk_bits), which is chunk j - 1's exit from its own entry.
__global__ void refine_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                              const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                              const int32_t* __restrict__ tables,
                              const uint64_t* __restrict__ entries, uint64_t* __restrict__ fine,
                              int B, int F, int chunk_bits, int bpm, int m) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int Fc = (F + m - 1) / m;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * Fc) return;
  const int img = static_cast<int>(lane / Fc);
  const int c0 = static_cast<int>(lane - static_cast<int64_t>(img) * Fc) * m;
  uint64_t* out = fine + static_cast<int64_t>(img) * F;
  State s = unpack(entries[lane]);
  out[c0] = pack(s);
  const int64_t e = ends[img];
  for (int j = c0 + 1; j < c0 + m && j < F; ++j) {
    const int64_t raw = starts[img] + static_cast<int64_t>(j) * chunk_bits;
    scan<false>(tab, stream, cap, s, raw < e ? raw : e, bpm, nullptr, nullptr, nullptr, 0);
    out[j] = pack(s);
  }
}

__global__ void record_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                              const int32_t* __restrict__ starts, const int32_t* __restrict__ ends,
                              const int32_t* __restrict__ tables,
                              const uint64_t* __restrict__ entries, int32_t* __restrict__ rec,
                              int32_t* __restrict__ cnt, int32_t* __restrict__ err, int* ok,
                              int B, int F, int chunk_bits, int bpm, int mb) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * F) return;
  const Chunk ch = chunk_of(lane, F, chunk_bits, starts, ends);
  State s = unpack(entries[lane]);
  int n = 0;
  int32_t e = kErrNone;
  if (!scan<true>(tab, stream, cap, s, ch.end, bpm, &e, &n, rec + lane * mb, mb)) {
    atomicAnd(ok, 0);
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
    const int32_t u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t t = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, t, d);
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

constexpr int kAsmThreads = 1024;

__global__ void assemble_kernel(const int32_t* __restrict__ ends, const int32_t* __restrict__ rec,
                                const int32_t* __restrict__ cnt, const int32_t* __restrict__ err,
                                int32_t* base, int32_t* out, int* ok, int F, int mb, int nblk) {
  __shared__ int32_t warp_sum[32];
  const int img = blockIdx.x;
  const int64_t l0 = static_cast<int64_t>(img) * F;
  int32_t carry = 0;
  for (int t0 = 0; t0 < F; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    int32_t sum;
    const int32_t before = block_exclusive_scan(i < F ? cnt[l0 + i] : 0, warp_sum, &sum);
    if (i < F) base[l0 + i] = carry + before;
    carry += sum;
  }
  __syncthreads();
  int32_t* o = out + static_cast<int64_t>(img) * nblk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < F; i += warps) {
    const int n = min(cnt[l0 + i], mb);
    const int32_t b0 = base[l0 + i];
    const int32_t* r = rec + (l0 + i) * mb;
    for (int j = lane; j < n; j += 32) {
      if (b0 + j < nblk) o[b0 + j] = r[j];
    }
  }
  __syncthreads();
  const int32_t last = o[nblk - 1];
  bool bad = false;
  if (threadIdx.x == 0) {
    bad = carry < nblk || last > ends[img] || last < ends[img] - 7;
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) bad |= err[l0 + i] < last;
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicAnd(ok, 0);
}

unsigned lane_blocks(int B, int F) {
  return static_cast<unsigned>((static_cast<int64_t>(B) * F + kThreads - 1) / kThreads);
}

}  // namespace

// stream u8 [cap]; starts, ends int32 [B] (bits); tables the packed int32
// tables; X uint64 [bpm + 1, B * F] (row bpm all ones) gets rows 0..bpm-1:
// each sync chunk's exits from its slot guesses.  F sync chunks of
// chunk_bits an image.
extern "C" int zpix_sync_guess(const void* stream, int64_t cap, const void* starts,
                               const void* ends, const void* tables, void* X, int B, int F,
                               int chunk_bits, int bpm, void* cuda_stream) {
  if (B > 0 && F > 0) {
    const int64_t n = static_cast<int64_t>(B) * F * bpm;
    guess_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<uint64_t*>(X), B, F, chunk_bits, bpm);
  }
  return static_cast<int>(cudaGetLastError());
}

// Y uint64 [bpm + 1, B * F] and links u8 [B * F, bpm + 1] out.
extern "C" int zpix_sync_link(const void* stream, int64_t cap, const void* starts,
                              const void* ends, const void* tables, const void* X, void* Y,
                              void* links, int B, int F, int chunk_bits, int bpm,
                              void* cuda_stream) {
  if (B > 0 && F > 0) {
    const int64_t n = static_cast<int64_t>(B) * F * bpm;
    link_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<const uint64_t*>(X), static_cast<uint64_t*>(Y),
        static_cast<uint8_t*>(links), B, F, chunk_bits, bpm);
  }
  return static_cast<int>(cudaGetLastError());
}

// maps u8 [2, B * F, bpm + 1] scratch; entries uint64 [B * F] out; misses
// int32 [1], zeroed, counts the candidates put in.
extern "C" int zpix_sync_resolve(const void* stream, int64_t cap, const void* starts,
                                 const void* ends, const void* tables, void* X, void* Y,
                                 void* links, void* maps, void* entries, void* misses, int B,
                                 int F, int chunk_bits, int bpm, void* cuda_stream) {
  if (B > 0 && F > 0) {
    resolve_kernel<<<static_cast<unsigned>(B), kAsmThreads, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<uint64_t*>(X), static_cast<uint64_t*>(Y), static_cast<uint8_t*>(links),
        static_cast<uint8_t*>(maps), static_cast<uint64_t*>(entries),
        static_cast<int*>(misses), B, F, chunk_bits, bpm);
  }
  return static_cast<int>(cudaGetLastError());
}

// The converged entries of F / m sync chunks an image -> fine uint64
// [B * F], the entries of the F chunks of chunk_bits.
extern "C" int zpix_sync_refine(const void* stream, int64_t cap, const void* starts,
                                const void* ends, const void* tables, const void* entries,
                                void* fine, int B, int F, int chunk_bits, int bpm, int m,
                                void* cuda_stream) {
  if (B > 0 && F > 0) {
    refine_kernel<<<lane_blocks(B, (F + m - 1) / m), kThreads, 0,
                    static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<const uint64_t*>(entries), static_cast<uint64_t*>(fine), B, F, chunk_bits,
        bpm, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// The record scan and the assembly: rec int32 [B * F, mb], cnt, err and
// base int32 [B * F] scratch; out int32 [B, nblk] zeroed; ok int32 [1].
extern "C" int zpix_sync_record(const void* stream, int64_t cap, const void* starts,
                                const void* ends, const void* tables, const void* entries,
                                void* rec, void* cnt, void* err, void* base, void* out, void* ok,
                                int B, int F, int chunk_bits, int bpm, int mb, int nblk,
                                void* cuda_stream) {
  if (B > 0 && F > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
    record_kernel<<<lane_blocks(B, F), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<const uint64_t*>(entries), static_cast<int32_t*>(rec),
        static_cast<int32_t*>(cnt), static_cast<int32_t*>(err), static_cast<int*>(ok), B, F,
        chunk_bits, bpm, mb);
    assemble_kernel<<<static_cast<unsigned>(B), kAsmThreads, 0, st>>>(
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(rec),
        static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(err),
        static_cast<int32_t*>(base), static_cast<int32_t*>(out), static_cast<int*>(ok), F, mb,
        nblk);
  }
  return static_cast<int>(cudaGetLastError());
}
