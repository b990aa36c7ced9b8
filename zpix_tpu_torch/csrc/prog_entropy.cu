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
// K10 replaces build_ac_refine_fn (:937-1101): one thread per valid block
// walks zigzag positions ss..se with the reference's gating (:997-1070):
// an existing nonzero reads one correction bit; a zero counts down the
// current symbol's run and then takes the pending +-1 << Al; EOB switches
// the thread to corrections only; a block entered inside an EOB run
// starts there.  The thread owns its row and updates it in place, reading
// each position's old value before it writes that position's delta (each
// position is visited once).  The position loop is the bound: at most 64
// steps, one symbol at most per step.
//
// Bound on the H100 for K9 and K10: bytes once enough blocks are in
// flight (the stream once, the rows they touch); the threads of a warp
// touch 256-byte rows of different blocks, so a row access costs a
// 32-byte sector, not 4 bytes.  Shifts and adds are done in uint32, so
// values wrap as XLA's int32 does (a left shift of a negative int is
// undefined in C++).
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

__global__ void ac_refine_kernel(const uint8_t* __restrict__ stream, int64_t cap,
                                 const int32_t* __restrict__ starts,
                                 const int32_t* __restrict__ ends,
                                 const int32_t* __restrict__ eob_entry,
                                 const int32_t* __restrict__ tables,
                                 int32_t* __restrict__ store, int32_t* ok,
                                 int64_t n_lanes, int nvalid, int nvx, int bh,
                                 int64_t nblk_c, int ss, int se, int al) {
  __shared__ int32_t tab[zpix::kTabEntropyWords];
  stage_tables(tab, tables);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  int32_t* row = store + valid_row(lane, nvalid, nvx, bh, nblk_c) * 64;
  const int t = tab[zpix::kTabSlotAc];
  const uint32_t delta = 1u << al;
  BitWindow w{stream, -(int64_t(1) << 40), 0};
  int64_t pos = starts[lane];
  bool in_eob = eob_entry[lane] != 0;
  bool need_sym = !in_eob, err = false;
  int nz = 0;
  uint32_t pending = 0;
  for (int kz = ss; kz <= se; ++kz) {
    if (need_sym) {  // the next (run, size) symbol
      if ((pos >> 3) + 8 > cap) {
        err = true;
        break;
      }
      w.at(pos);
      const Sym s = zpix::decode_sym(tab, t, static_cast<int32_t>(w.bits(pos, 16)));
      const int r = s.sym >> 4, sz = s.sym & 15;
      if (s.bad || sz > 1) {  // a refinement's size is 0 or 1
        err = true;
        break;
      }
      const bool is_eob = sz == 0 && r < 15;
      if (sz == 1) {
        pending = w.bits(pos + s.len, 1) ? delta : 0u - delta;
        nz = r;
        pos += s.len + 1;
      } else {
        pending = 0;
        nz = is_eob ? 0 : 15;
        pos += s.len + (is_eob ? r : 0);  // EOB run bits: length only
      }
      in_eob = is_eob;
      need_sym = false;
    }
    int32_t* p = row + zpix::kUnzig[kz];
    const int32_t coef = *p;
    if (coef != 0) {  // an existing nonzero: one correction bit
      if ((pos >> 3) + 8 > cap) {
        err = true;
        break;
      }
      w.at(pos);
      if (w.bits(pos, 1)) *p = add_u32(coef, coef > 0 ? delta : 0u - delta);
      ++pos;
    } else if (!in_eob) {
      if (nz > 0) {
        --nz;
      } else {  // the run is crossed: place the pending coefficient here
        *p = static_cast<int32_t>(pending);
        pending = 0;
        need_sym = true;
      }
    }
  }
  if (err || pos != ends[lane]) atomicAnd(ok, 0);
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
    ac_refine_kernel<<<grid_of(n_lanes), kThreads, 0,
                       static_cast<cudaStream_t>(cuda_stream)>>>(
        static_cast<const uint8_t*>(stream), cap, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), static_cast<const int32_t*>(eob_entry),
        static_cast<const int32_t*>(tables), static_cast<int32_t*>(store),
        static_cast<int32_t*>(ok), n_lanes, nvalid, nvx, bh, nblk_c, ss, se, al);
  }
  return static_cast<int>(cudaGetLastError());
}
