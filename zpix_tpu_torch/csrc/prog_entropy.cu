// K8, K9 and K10: the value passes of progressive JPEG in host-index mode.
//
// The host walks every scan of every image first (csrc/host/entropy.cpp,
// zpix_prog_*_index) and gives each block its exact start bit, so each
// block decodes on its own thread with no speculation.  Every thread
// checks that it ends where the host said (``agree``) and clears ``ok``
// with one atomicAnd otherwise.  A thread that would read past the stream
// buffer sets its error (the JAX passes clip such reads; on valid streams
// the two never differ).
//
// K8 replaces zpix_tpu/parallel/progressive_onchip.py::
// build_dc_first_value_fn (:799): one DC symbol plus RECEIVE/EXTEND per
// block, ``sym > 16`` is an error (:854-858).  The raw diffs go to K3's
// block-per-chain prefix (dc_restore.cu) and the store kernel
// (prog_store.cu).  Bound: bytes (the stream once, 12 bytes a block).
//
// K9 replaces build_ac_first_value_fn (:866) with _make_ac_sym_step's
// rules (:277-312): ZRL, EOB with run bits (consumed, not counted: the
// host counted the run), and the overflow rule (a size > 0 symbol with
// k + r > se ends the block on its code bits).  One thread per valid
// block with data adds ``val << Al`` into its store row in natural order
// (the JAX store adds, :1674).  A block makes at most 64 symbols (each
// advances k or ends the block); a thread still running after 64 clears
// ``ok``.
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
// correction bits as one field, and symbols come from a 9-bit lookahead
// table in shared memory (decode_sym for longer codes).  The warp stores
// back the 16-byte pieces of its rows that changed.  A read past the
// buffer stops a block at the same position as a per-position walk, with
// the same writes before it.
//
// Bound on the H100 for K9: bytes once enough blocks are in flight (the
// stream once, the rows it touches); its threads touch 256-byte rows of
// different blocks, so a row access costs a 32-byte sector, not 4 bytes.
// K10: bytes (the stream, the band of every row read once, the changed
// pieces written).  Shifts and adds are done in uint32, so values wrap as
// XLA's int32 does (a left shift of a negative int is undefined in C++).
#include <cuda_runtime.h>

#include <cstdint>

#include "huffman.cuh"

namespace {

using zpix::BitWindow;
using zpix::Sym;

constexpr int kThreads = 128;

__device__ __forceinline__ void stage_tables(int32_t* tab,
                                             const int32_t* tables) {
  for (int i = threadIdx.x; i < zpix::kTabEntropyWords; i += blockDim.x)
    tab[i] = tables[i];
  __syncthreads();
}

__device__ __forceinline__ int32_t add_u32(int32_t x, uint32_t d) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + d);
}

// The store row of valid block i of image b: valid blocks are the top-left
// nvy x nvx corner of the component's [bv, bh] grid, in raster order.
__device__ __forceinline__ int64_t valid_row(int64_t lane, int nvalid, int nvx,
                                             int bh, int64_t nblk_c) {
  const int64_t b = lane / nvalid;
  const int i = static_cast<int>(lane - b * nvalid);
  return b * nblk_c + static_cast<int64_t>(i / nvx) * bh + i % nvx;
}

__global__ void dc_first_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                                const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ ends,
                                const int32_t* __restrict__ tables,
                                int32_t* __restrict__ diffs, int32_t* ok,
                                int64_t n_lanes, int bpm) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int64_t pos = starts[lane];
  int32_t diff = 0;
  bool err = true;
  if ((pos >> 3) + 8 <= cap) {
    BitWindow w{stream, -(int64_t(1) << 40), 0};
    w.at(pos);
    const int slot = static_cast<int>(lane % bpm);
    const Sym s = zpix::decode_sym(tab, tab[zpix::kTabSlotDc + slot],
                                   static_cast<int32_t>(w.bits(pos, 16)));
    diff = zpix::receive_extend(w, pos + s.len, s.sym);
    err = s.bad || s.sym > 16 || pos + s.len + s.sym != ends[lane];
  }
  diffs[lane] = diff;
  if (err) atomicAnd(ok, 0);
}

__global__ void ac_first_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                                const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ ends,
                                const int32_t* __restrict__ hasdata,
                                const int32_t* __restrict__ tables,
                                int32_t* __restrict__ store, int32_t* ok,
                                int64_t n_lanes, int nvalid, int nvx, int bh,
                                int64_t nblk_c, int ss, int se, int al) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n_lanes || !hasdata[lane]) return;  // EOB-covered: no bits
  int32_t* row = store + valid_row(lane, nvalid, nvx, bh, nblk_c) * 64;
  const int t = tab[zpix::kTabSlotAc];
  BitWindow w{stream, -(int64_t(1) << 40), 0};
  int64_t pos = starts[lane];
  int k = ss;
  bool done = false, err = false;
  for (int it = 0; it < 64 && !done; ++it) {
    if ((pos >> 3) + 8 > cap) {
      err = true;
      break;
    }
    w.at(pos);
    const Sym s = zpix::decode_sym(tab, t, static_cast<int32_t>(w.bits(pos, 16)));
    if (s.bad) {
      err = true;
      break;
    }
    const int r = s.sym >> 4, size = s.sym & 15;
    if (size == 0) {
      if (r < 15) {  // EOB: the run's bits are skipped (the host counted them)
        pos += s.len + r;
        done = true;
      } else {  // ZRL
        pos += s.len;
        k += 16;
        done = k > se;
      }
    } else if (k + r > se) {  // the overflow rule: code bits only
      pos += s.len;
      done = true;
    } else {
      const int32_t v = zpix::receive_extend(w, pos + s.len, size);
      int32_t* p = row + zpix::kUnzig[k + r];
      *p = add_u32(*p, static_cast<uint32_t>(v) << al);
      k += r + 1;
      pos += s.len + size;
      done = k > se;
    }
  }
  if (err || !done || pos != ends[lane]) atomicAnd(ok, 0);
}

// ------------------------------------------------------------- K10

constexpr int kRefineWarps = 8;  // warps a CTA, 32 lanes (blocks) each (PERF.md, K10)
// Words a row in shared memory (natural order, 16-byte aligned): lane
// i's 16-byte piece g sits in bank group (i + g) % 8, so a quarter warp's
// 16-byte reads of one piece each are free of conflicts.
constexpr int kRowWords = 68;
constexpr int kRowsSmem = kRefineWarps * 32 * kRowWords * 4;
constexpr int kLutBits = 9, kLut = 1 << kLutBits;
constexpr unsigned kLutBad = 0x8000;
constexpr unsigned kFull = 0xffffffffu;

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

// One AC table in shared memory: its limits and value offsets (the symbol
// bytes stay in device memory), and its lookahead table; the natural
// index of each zigzag position.
struct RefineCode {
  int32_t lims[16], aoff[16];
  int32_t nvals;
  uint16_t lut[kLut];
  uint8_t unzig[64];
};

__device__ __forceinline__ Sym decode_full(const RefineCode& C, const int32_t* vals,
                                           int32_t look) {
  return zpix::decode_sym_split(C.lims, C.aoff, vals, C.nvals, look);
}

// Entry p of the lookahead table (ops/progressive.py::refine_lut_plain is
// its copy): kLutBad where every lookahead whose top kLutBits bits are p
// is invalid, len << 8 | sym where all decode to one code of at most
// kLutBits bits, 0 otherwise (decoded in full).  Each of decode_sym's
// compares is monotone in the lookahead, so where the two ends of p's
// range agree, every lookahead between agrees.
__device__ __forceinline__ uint16_t lut_entry(const RefineCode& C, const int32_t* vals, int p) {
  constexpr int kLow = 16 - kLutBits;
  const Sym lo = decode_full(C, vals, p << kLow);
  const Sym hi = decode_full(C, vals, (p << kLow) | ((1 << kLow) - 1));
  if (lo.bad && hi.bad) return kLutBad;
  if (!lo.bad && !hi.bad && lo.len == hi.len && lo.len <= kLutBits)
    return static_cast<uint16_t>(lo.len << 8 | lo.sym);
  return 0;
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
  __shared__ RefineCode C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile0 = (static_cast<int64_t>(blockIdx.x) * kRefineWarps + warp) * 32;
  const int64_t L = tile0 + lane;
  const bool live = L < n_lanes;
  int32_t* rows = s_rows + warp * 32 * kRowWords;
  int32_t* my = rows + lane * kRowWords;
  const int64_t rb = live ? valid_row(L, nvalid, nvx, bh, nblk_c) * 64 : 0;

  // the scan's AC table (slot 0's; a word a thread), the rows (two a
  // step, lane l taking words 4c..4c+3, c = l % 16) and the lane's offsets
  // on their way, while the CTA builds the lookahead table
  const int32_t* vals = tables + zpix::kTabVals;
  int32_t code = 0;
  if (threadIdx.x < 33) {
    const int t = __ldg(tables + zpix::kTabSlotAc), i = threadIdx.x;
    code = __ldg(tables + (i < 16 ? zpix::kTabLims + 16 * t + i
                           : i < 32 ? zpix::kTabAoff + 16 * t + i - 16 : zpix::kTabNvals));
  }
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
  if (threadIdx.x < 16) C.lims[threadIdx.x] = code;
  else if (threadIdx.x < 32) C.aoff[threadIdx.x - 16] = code;
  else if (threadIdx.x == 32) C.nvals = code;
  if (threadIdx.x < 64) C.unzig[threadIdx.x] = static_cast<uint8_t>(zpix::kUnzig[threadIdx.x]);
  __syncthreads();
#pragma unroll  // the entries' symbol loads in flight together
  for (int k = 0; k < kLut / (32 * kRefineWarps); ++k) {
    const int i = threadIdx.x + 32 * kRefineWarps * k;
    C.lut[i] = lut_entry(C, vals, i);
  }
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

unsigned grid_of(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int zpix_prog_dc_first(const void* stream, int64_t cap, const void* starts,
                                  const void* ends, const void* tables, void* diffs,
                                  void* ok, int64_t n_lanes, int bpm, void* cuda_stream) {
  if (n_lanes > 0) {
    dc_first_kernel<<<grid_of(n_lanes), kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(tables),
        static_cast<int32_t*>(diffs), static_cast<int32_t*>(ok), n_lanes, bpm);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zpix_prog_ac_first(const void* stream, int64_t cap, const void* starts,
                                  const void* ends, const void* hasdata,
                                  const void* tables, void* store, void* ok,
                                  int64_t n_lanes, int nvalid, int nvx, int bh,
                                  int64_t nblk_c, int ss, int se, int al,
                                  void* cuda_stream) {
  if (n_lanes > 0) {
    ac_first_kernel<<<grid_of(n_lanes), kThreads, 0,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(hasdata),
        static_cast<const int32_t*>(tables), static_cast<int32_t*>(store),
        static_cast<int32_t*>(ok), n_lanes, nvalid, nvx, bh, nblk_c, ss, se, al);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int zpix_prog_ac_refine(const void* stream, int64_t cap, const void* starts,
                                   const void* ends, const void* eob_entry,
                                   const void* tables, void* store, void* ok,
                                   int64_t n_lanes, int nvalid, int nvx, int bh,
                                   int64_t nblk_c, int ss, int se, int al,
                                   void* cuda_stream) {
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
