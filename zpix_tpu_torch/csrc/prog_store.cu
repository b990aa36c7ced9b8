// K11: the DC refinement scan of progressive JPEG.
//
// Replaces the "dcr" arm of zpix_tpu/parallel/progressive_onchip.py::
// _make_update (:1713-1745): one raw bit a block, MSB first in the scan's
// bytes (rows [B, rowlen]); a set bit ORs 1 << Al into coefficient 0 of
// the block's row of its component's int32 grid [B, bv, bh, 64].  An
// interleaved scan visits every block in (MCU, slot) order, padding blocks
// included; a single-component scan its valid blocks in raster order (the
// top-left nvy x nvx corner of its grid; decoder.py:525-529).
//
// Bound on the H100: the store's sectors.  Each block whose bit is set
// reads and writes one 32-byte sector of a store (101 MB at the main
// shapes) larger than the 50 MB L2; the bits are 1/8 byte a block.
//
// Design: the grid's y is the image, so no 64-bit division is left.  A
// thread takes kRun scan positions (kRun / 8 bytes of bits, assembled into
// a word: the rows need not be 4-byte aligned) and stops at once where
// none is set; else it walks its set bits MSB first (__clz).  A position
// maps to (component, by, bx) by multiply-high divisions (fast_div.cuh): by the
// MCU's blocks and the MCUs a row through a slot table of the MCU
// (component, dy, dx) in an interleaved scan, by the valid width in a
// single-component one.  The write is an atomicOr whose result is unused,
// so it compiles to a reduction: no load comes back to the SM and a
// thread's writes are all in flight at once.  Each set bit lands in its
// own row and OR commutes, so the order of the writes does not matter.
#include <cuda_runtime.h>

#include <cstdint>

#include "fast_div.cuh"

namespace {

using zpix::FastDiv;

constexpr int kThreads = 256;
// Scan positions a thread: one byte of bits (8 and 32, a word, timed on
// the bench batch by tools/torch_dc_refine_stages.py --sweep: 8 the faster).
constexpr int kRun = 8;
constexpr int kSlots = 16;  // blocks an MCU at most (ops/entropy.py MAX_SLOTS, as K8)

struct Refine {
  int32_t* grid[3];      // per scan component: [B, bv, bh, 64]
  int64_t image_rows[3];  // per scan component: bv * bh
  int bh[3];
  int h[3], v[3];
  uint32_t slot[kSlots];  // interleaved: comp | dy << 8 | dx << 16 of each slot of an MCU
};

__global__ void __launch_bounds__(kThreads)
dc_refine_kernel(const uint8_t* __restrict__ bits, int rowlen, int nblk, Refine g,
                 int interleaved, int bpm, FastDiv per_mcu, int per_row, FastDiv row_div,
                 uint32_t bit) {
  const int b = blockIdx.y;
  const int first = (blockIdx.x * kThreads + threadIdx.x) * kRun;
  if (first >= nblk) return;
  const uint8_t* row = bits + static_cast<int64_t>(b) * rowlen + first / 8;
  const int n = min(kRun, nblk - first);  // this thread's positions
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < kRun / 8; ++k) {
    if (8 * k < n) w |= static_cast<uint32_t>(__ldg(row + k)) << (24 - 8 * k);
  }
  if (n < 32) w &= ~(0xffffffffu >> n);  // the row's padding bits
  while (w) {
    const int k = __clz(w);
    w ^= 0x80000000u >> k;
    const int i = first + k;
    int c = 0, by, bx;
    if (interleaved) {
      const int mcu = static_cast<int>(per_mcu.div(static_cast<uint32_t>(i)));
      const uint32_t s = g.slot[i - mcu * bpm];
      const int my = static_cast<int>(row_div.div(static_cast<uint32_t>(mcu)));
      c = s & 0xff;
      by = my * g.v[c] + static_cast<int>((s >> 8) & 0xff);
      bx = (mcu - my * per_row) * g.h[c] + static_cast<int>(s >> 16);
    } else {
      by = static_cast<int>(row_div.div(static_cast<uint32_t>(i)));
      bx = i - by * per_row;
    }
    atomicOr(g.grid[c] + (b * g.image_rows[c] + static_cast<int64_t>(by) * g.bh[c] + bx) * 64,
             static_cast<int>(bit));
  }
}

}  // namespace

// ncs scan components with grids g0..g2 of hv_c = h | v << 4 blocks an MCU
// over an mxx x myy MCU grid; a single-component scan visits the valid
// corner of width nvx.  per_row is mxx (interleaved) or nvx; the magic and
// shift pairs divide by bpm and per_row.
extern "C" int zpix_prog_dc_refine(const void* bits, int rowlen, int nblk, int batch,
                                   void* g0, void* g1, void* g2, int ncs, int hv0, int hv1,
                                   int hv2, int mxx, int myy, int bpm, int mcu_magic,
                                   int mcu_shift, int per_row, int row_magic, int row_shift,
                                   int al, void* stream) {
  if (ncs < 1 || ncs > 3 || bpm > kSlots || al < 0 || al > 31 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Refine g{};
  void* grids[3] = {g0, g1, g2};
  const int hvs[3] = {hv0, hv1, hv2};
  int slots = 0;
  for (int c = 0; c < ncs; ++c) {
    g.grid[c] = static_cast<int32_t*>(grids[c]);
    g.h[c] = hvs[c] & 15;
    g.v[c] = hvs[c] >> 4;
    g.bh[c] = mxx * g.h[c];
    g.image_rows[c] = static_cast<int64_t>(myy) * g.v[c] * g.bh[c];
    for (int dy = 0; ncs > 1 && dy < g.v[c]; ++dy) {
      for (int dx = 0; dx < g.h[c]; ++dx) {
        if (slots == kSlots) return static_cast<int>(cudaErrorInvalidValue);
        g.slot[slots++] = static_cast<uint32_t>(c | dy << 8 | dx << 16);
      }
    }
  }
  if (ncs > 1 && slots != bpm) return static_cast<int>(cudaErrorInvalidValue);
  const int threads_per_image = (nblk + kRun - 1) / kRun;
  if (nblk > 0 && batch > 0) {
    const dim3 grid((threads_per_image + kThreads - 1) / kThreads, batch);
    dc_refine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bits), rowlen, nblk, g, ncs > 1, bpm,
        FastDiv{static_cast<uint32_t>(mcu_magic), mcu_shift}, per_row,
        FastDiv{static_cast<uint32_t>(row_magic), row_shift}, static_cast<uint32_t>(1u) << al);
  }
  return static_cast<int>(cudaGetLastError());
}
