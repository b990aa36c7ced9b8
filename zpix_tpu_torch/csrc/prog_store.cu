// The store kernel of progressive JPEG's DC scans: K11, and a set mode
// (ops/progressive.py::store_blocks; K8 writes its own values since it
// became one kernel, csrc/prog_entropy.cu).
//
// A DC scan visits its blocks either interleaved, in (MCU, slot) order
// over every block of the scan's components (padding blocks included), or
// for a single component in raster order over its valid blocks only (the
// top-left nvy x nvx corner of its grid; decoder.py:525-529).  One thread
// per block maps its scan position to its row of the component's int32
// coefficient grid [B, bv, bh, 64] and writes coefficient 0:
//  - set mode (the ``.at[].set`` of
//    zpix_tpu/parallel/progressive_onchip.py::_make_update's "dc" arm,
//    :1611-1652): row[0] = value << Al, the shift in uint32;
//  - or mode, K11 (replaces the "dcr" arm, :1713-1745): one raw bit per
//    block, MSB first in the scan's bytes; a set bit ORs 1 << Al into
//    row[0].
// Bound on the H100: bytes (4 or 1/8 bytes in a block, one 32-byte sector
// of the store written).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Dst {
  int32_t* grid[3];  // per scan component: [B, myy * v, mxx * h, 64]
  int hv[3];         // per scan component: h | v << 4
};

__global__ void store_kernel(const int32_t* __restrict__ vals,
                             const uint8_t* __restrict__ bits, int rowlen, Dst d,
                             int64_t n_lanes, int nblk, int ncs, int mxx, int myy,
                             int nvx, int al, int mode) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int64_t b = lane / nblk;
  const int i = static_cast<int>(lane - b * nblk);
  int c = 0, by, bx;
  if (ncs == 1) {  // valid blocks, raster order
    by = i / nvx;
    bx = i % nvx;
  } else {  // every block, (MCU, slot) order
    int bpm = 0;
    for (int s = 0; s < ncs; ++s) bpm += (d.hv[s] & 15) * (d.hv[s] >> 4);
    const int mcu = i / bpm;
    int j = i - mcu * bpm;
    while (j >= (d.hv[c] & 15) * (d.hv[c] >> 4)) {
      j -= (d.hv[c] & 15) * (d.hv[c] >> 4);
      ++c;
    }
    const int h = d.hv[c] & 15, v = d.hv[c] >> 4;
    by = (mcu / mxx) * v + j / h;
    bx = (mcu % mxx) * h + j % h;
  }
  const int h = d.hv[c] & 15, v = d.hv[c] >> 4;
  const int64_t bh = static_cast<int64_t>(mxx) * h;
  int32_t* p = d.grid[c] + ((b * myy * v + by) * bh + bx) * 64;
  if (mode == 0) {
    *p = static_cast<int32_t>(static_cast<uint32_t>(vals[lane]) << al);
  } else if ((bits[b * rowlen + (i >> 3)] >> (7 - (i & 7))) & 1) {
    *p = static_cast<int32_t>(static_cast<uint32_t>(*p) | (1u << al));
  }
}

}  // namespace

extern "C" int zpix_prog_store(const void* vals, const void* bits, int rowlen, void* g0,
                               void* g1, void* g2, int64_t n_lanes, int nblk, int ncs,
                               int c0, int c1, int c2, int mxx, int myy, int nvx,
                               int al, int mode, void* stream) {
  if (ncs < 1 || ncs > 3) return static_cast<int>(cudaErrorInvalidValue);
  Dst d{{static_cast<int32_t*>(g0), static_cast<int32_t*>(g1), static_cast<int32_t*>(g2)},
        {c0, c1, c2}};
  if (n_lanes > 0) {
    store_kernel<<<static_cast<unsigned>((n_lanes + kThreads - 1) / kThreads), kThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(vals), static_cast<const uint8_t*>(bits), rowlen, d,
        n_lanes, nblk, ncs, mxx, myy, nvx, al, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
