// The strip pixel stage shared by the back-end (K4, backend.cu) and the
// component-plane kernel (K6, planes.cu): dequantised blocks through the
// exact Wang IDCT, +128 and a clamp to u8, and each output pixel written
// once, cropped, from its MCU's own blocks (chroma replication never
// crosses an MCU), through the gray, ycbcr, rgb, cmyk or ycck colour arm.
//
// Design (Hopper).  A CTA of 256 threads takes a strip: ``strip`` MCUs
// along one MCU row, the largest power of two with at most kStripBlocks
// blocks that the row needs (16 at 4:2:0).  The grid is persistent (as many
// CTAs as fit on the card, at most one a strip) and each CTA walks the
// strips s = blockIdx.x, + gridDim.x, ...; while it computes one strip,
// the next strip's coefficients (and K6's quant rows) arrive by cp.async
// into the other of two buffers.  A strip then takes three phases and
// three barriers:
// - rows: a thread an 8-coefficient row, held in registers (one 16-byte
//   load of int16s), dequantised by a quant row staged in shared memory,
//   the row butterfly, and two 16-byte stores into a block of 72 words
//   whose row r keeps its halves swapped when r >= 4: neither these
//   stores nor the column reads have a bank conflict;
// - columns: a thread a column in registers, the column butterfly, +128
//   and clamp, eight bytes into a pixel block of 72 bytes (conflict-free
//   byte stores);
// - pixels: a thread a tile of 4 x 2 pixels (four consecutive pixels of
//   two rows).  Every divisor is a shift: the MCU's blocks (hmax, vmax)
//   and every replication factor are 1, 2 or 4, so a tile reads one
//   32-bit word of each component a row (one for both rows where it is
//   replicated vertically) and spreads it with one byte permute; the
//   chroma terms of YCbCr->RGB are computed once per distinct sample; the
//   colour arm is a uniform branch, and a tile row leaves as one 32-bit
//   store a channel (planar, gray), three (interleaved RGB) or one 16-byte
//   store (four channels).  Bytes are stored only where W % 4 != 0 (a
//   row's start is not word aligned) and at the right edge.
// Factors of 3: the baseline preps admit every component sampled 3 x 1
// (or 1 x 3), where hmax (vmax) is 3 and every replication factor is 1.
// vmax 3 needs no division (tile rows are counted by shifts); hmax 3
// takes a second instantiation of the pixel stage (kThirds, picked at
// launch from the geometry) whose tile index divides by 3 with a
// multiply-high, so the power-of-two path is unchanged (K4 only: K6's
// layout gives such images one block an MCU).  The C entries
// refuse any other factor, and a replication factor of 3 (no plan
// carries one; the plain versions take any sampling on the CPU).
//
// The colour arithmetic is the reference's (util.zig:40-86), as
// zpix_tpu/ops/ycbcr.py computes it; the arms follow
// zpix_tpu/parallel/device_entropy.py::_soa_backend and
// zpix_tpu/parallel/batch.py's _ycbcr/_gray/_rgb/_ycck/_cmyk graphs.
#pragma once
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "wang_idct.cuh"

namespace zpix {

constexpr int kMaxBpm = 10;
constexpr int kStripThreads = 256;
// Blocks a strip at most (tools/torch_backend_stages.py --sweep rebuilds
// with other values).
constexpr int kStripBlocks = 128;
static_assert(kStripBlocks >= kMaxBpm, "a strip holds at least one MCU");
constexpr int kRowWords = 72;         // a dequantised block: 8 rows of 8 words, 8 spare
constexpr int kPixStride = 72;        // a pixel block: 8 rows of 8 bytes, 8 spare

enum Mode { kGray = 0, kYcbcr = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };

// One launch's geometry, a kernel parameter.  Component c has h x v
// blocks an MCU from slot ``first``; output pixel (y, x) of the MCU reads
// its sample (y / fv, x / fh), and h * fh == hmax, v * fv == vmax.
struct StripGeo {
  int64_t n_strips;
  int mxx, myy, bpm, ncomp;
  int strip, lstrip, spr;  // MCUs a strip, its log2, strips an MCU row
  int hmax, vmax, lqpm;    // lqpm = log2(2 hmax); 0 when hmax is 3
  int h[4], v[4], first[4], fh[4], fv[4], lfh[4], lfv[4];
  uint32_t sel[4];  // byte-permute selector of a quad's samples
  int height, width, mode, nchan, planar, words;  // words: W % 4 == 0
};

inline int exact_log2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// log2 of a factor of 1, 2 or 4, else -1.
inline int factor_log2(int x) { return x == 1 ? 0 : (x == 2 ? 1 : (x == 4 ? 2 : -1)); }

// Component c packed by the host as h | v << 4 | fh << 8 | fv << 12.
// Refused: an MCU of other than 1, 2, 3 or 4 blocks across or down, a
// replication factor other than 1, 2 or 4, and chroma planes of YCbCr
// (YCCK) replicated unlike each other.
inline cudaError_t make_strip_geo(StripGeo& g, int batch, int mxx, int myy, int bpm,
                                  int ncomp, const int* packed, int height, int width,
                                  int mode, int nchan, int planar) {
  g = StripGeo{};
  const bool ycc = mode == kYcbcr || mode == kYcck;
  if (bpm < 1 || bpm > kMaxBpm || ncomp < 1 || ncomp > 4 || (ycc && ncomp < 3))
    return cudaErrorInvalidValue;
  int strip = 1;
  while (2 * strip * bpm <= kStripBlocks && strip < mxx) strip *= 2;
  g.mxx = mxx, g.myy = myy, g.bpm = bpm, g.ncomp = ncomp;
  g.strip = strip, g.lstrip = exact_log2(strip), g.spr = (mxx + strip - 1) / strip;
  g.hmax = packed[0] & 15, g.vmax = (packed[0] >> 4) & 15;
  const int lh = factor_log2(g.hmax);
  if ((lh < 0 && g.hmax != 3) || (factor_log2(g.vmax) < 0 && g.vmax != 3))
    return cudaErrorInvalidValue;
  int s0 = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int h = packed[c] & 15, v = (packed[c] >> 4) & 15;
    const int fh = (packed[c] >> 8) & 15, fv = (packed[c] >> 12) & 15;
    if (h < 1 || v < 1 || h * fh != g.hmax || v * fv != g.vmax) return cudaErrorInvalidValue;
    g.h[c] = h, g.v[c] = v, g.fh[c] = fh, g.fv[c] = fv, g.first[c] = s0;
    g.lfh[c] = factor_log2(fh), g.lfv[c] = factor_log2(fv);
    if (g.lfh[c] < 0 || g.lfv[c] < 0) return cudaErrorInvalidValue;
    g.sel[c] = fh == 1 ? 0x3210u : (fh == 2 ? 0x1100u : 0u);
    s0 += h * v;
  }
  // the pixel stage shares Cr's chroma terms by Cb's replication
  if (s0 != bpm || (ycc && (g.fh[2] != g.fh[1] || g.fv[2] != g.fv[1])))
    return cudaErrorInvalidValue;
  g.lqpm = lh + 1;  // 0 for hmax 3: the kThirds pixel stage divides instead
  g.height = height, g.width = width, g.mode = mode, g.nchan = nchan, g.planar = planar;
  g.words = width % 4 == 0;
  g.n_strips = static_cast<int64_t>(batch) * myy * g.spr;
  return cudaSuccess;
}

// Shared memory of a CTA (byte offsets): two coefficient buffers and two
// side buffers (K4: the strip's DC; K6: its image's quant rows), the row
// pass's words, and the per-block table (with K4's quant rows after it).
// A strip's pixel blocks take the place of its coefficients once the row
// pass has read them.
struct StripSmem {
  int coef_bytes, aux_bytes, coef, aux, words, tab, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// ``nb``: blocks a strip; ``elem``: bytes a coefficient.
__host__ __device__ inline StripSmem strip_smem(int nb, int elem, int aux_bytes) {
  StripSmem s;
  s.coef_bytes = align16(nb * 64 * elem);
  s.aux_bytes = align16(aux_bytes);
  s.coef = 0;
  s.aux = 2 * s.coef_bytes;
  s.words = s.aux + 2 * s.aux_bytes;
  s.tab = s.words + nb * kRowWords * 4;
  s.total = s.tab + align16(nb * 4) + 4 * 64 * 4;
  return s;
}

// The persistent grid: as many CTAs as fit on the card (fewer were never
// faster, tools/torch_backend_stages.py), at most one a strip.  A kernel's
// launcher keeps a static GridCache: the count is found once for each
// device and strip size (and the kernel allowed ``max_smem``, its largest
// strip's), after which a launch asks the runtime only for the device.
constexpr int kMaxDevices = 16;
struct GridCache {
  std::atomic<int> ctas[kMaxDevices][kStripBlocks + 1];  // 0: not found yet
};

template <typename Kernel>
inline int strip_grid(GridCache& cache, Kernel kernel, int nb, int smem, int max_smem,
                      int64_t n_strips) {
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>* slot = dev < kMaxDevices ? &cache.ctas[dev][nb] : nullptr;
  int cap = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (cap == 0) {
    int sms = 1, occ = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (max_smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kStripThreads, smem);
    cap = sms * (occ < 1 ? 1 : occ);
    if (slot) slot->store(cap, std::memory_order_relaxed);
  }
  return static_cast<int>(n_strips < cap ? n_strips : cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Strip {
  int64_t b;
  int my, mx0, nm;  // MCU row, first MCU, MCUs in this strip
};

__device__ __forceinline__ Strip strip_at(const StripGeo& g, int64_t s) {
  Strip t;
  const int64_t per_image = static_cast<int64_t>(g.myy) * g.spr;
  t.b = s / per_image;
  const int r = static_cast<int>(s - t.b * per_image);
  t.my = r / g.spr;
  t.mx0 = (r - t.my * g.spr) << g.lstrip;
  t.nm = min(g.strip, g.mxx - t.mx0);
  return t;
}

// tab[k] for the strip's block k (MCU m = k / bpm, slot k % bpm):
// component | block row j in the MCU << 4 | block column in the strip
// (m * h + i) << 8.  Once a CTA; the caller synchronises.
__device__ __forceinline__ void build_block_table(const StripGeo& g, int32_t* tab) {
  for (int k = threadIdx.x; k < g.strip * g.bpm; k += kStripThreads) {
    const int m = k / g.bpm, slot = k - m * g.bpm;
    int c = 0;
    while (c + 1 < g.ncomp && g.first[c + 1] <= slot) ++c;
    const int local = slot - g.first[c], j = local / g.h[c], i = local - j * g.h[c];
    tab[k] = c | j << 4 | (m * g.h[c] + i) << 8;
  }
}

template <typename T>
__device__ __forceinline__ void load_row(const T* p, int32_t (&v)[8]);

template <>
__device__ __forceinline__ void load_row<int16_t>(const int16_t* p, int32_t (&v)[8]) {
  const int4 r = *reinterpret_cast<const int4*>(p);
  const int32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = static_cast<int16_t>(w[i] & 0xFFFF);
    v[2 * i + 1] = w[i] >> 16;
  }
}

template <>
__device__ __forceinline__ void load_row<int32_t>(const int32_t* p, int32_t (&v)[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0], b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
  v[7] = b.w;
}

// Rows: coefficients (natural order; with kDc, position 0 from dc[k]) ->
// dequantised (int32 wraps), row butterfly -> words.
template <typename T, bool kDc>
__device__ __forceinline__ void row_pass(const T* coef, const int32_t* dc,
                                         const int32_t* quant, const int32_t* tab,
                                         int32_t* words, int nrows) {
  for (int t = threadIdx.x; t < nrows; t += kStripThreads) {
    const int k = t >> 3, r = t & 7;
    int32_t v[8];
    load_row<T>(coef + k * 64 + r * 8, v);
    if (kDc && r == 0) v[0] = dc[k];
    const int4* q = reinterpret_cast<const int4*>(quant + (tab[k] & 15) * 64 + r * 8);
    const int4 qa = q[0], qb = q[1];
    const int32_t qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = static_cast<int32_t>(static_cast<uint32_t>(v[i]) * static_cast<uint32_t>(qs[i]));
    wang_row_regs(v);
    int32_t* d = words + k * kRowWords + r * 8;
    const int sw = r & 4;
    *reinterpret_cast<int4*>(d + sw) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(d + (sw ^ 4)) = make_int4(v[4], v[5], v[6], v[7]);
  }
}

// Columns: words -> column butterfly, +128, clamp -> pixel blocks.
__device__ __forceinline__ void col_pass(const int32_t* words, uint8_t* pix, int ncols) {
  for (int t = threadIdx.x; t < ncols; t += kStripThreads) {
    const int k = t >> 3, c = t & 7;
    const int32_t* s = words + k * kRowWords;
    int32_t v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = s[r * 8 + (c ^ (r & 4))];
    wang_col_regs(v);
    uint8_t* d = pix + k * kPixStride + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int32_t x = static_cast<int32_t>(static_cast<uint32_t>(v[r]) + 128u);
      d[r * 8] = static_cast<uint8_t>(__vimin_s32_relu(x, 255));
    }
  }
}

// Samples of component c for the tile at rows ly, ly + 1 (ly even) and
// columns lx0..lx0+3 (a multiple of 4) of the strip's MCU m: byte i of
// top / bot is output pixel lx0 + i of row ly / ly + 1.
// A word a row, spread by one byte permute.
__device__ __forceinline__ void samples(const uint8_t* pix, const StripGeo& g, int c, int m,
                                        int ly, int lx0, uint32_t& top, uint32_t& bot) {
  const uint8_t* blk = pix + (m * g.bpm + g.first[c]) * kPixStride;
  const int py = ly >> g.lfv[c], s0 = lx0 >> g.lfh[c];
  const uint8_t* row =
      blk + ((py >> 3) * g.h[c] + (s0 >> 3)) * kPixStride + (py & 7) * 8 + (s0 & 4);
  const uint32_t sel = g.sel[c] + (s0 & 3) * 0x1111u;
  top = __byte_perm(*reinterpret_cast<const uint32_t*>(row), 0, sel);
  // py is even, so row ly + 1 is the next row of the same block, or
  // row ly's own when the component is replicated vertically
  bot = g.lfv[c] ? top : __byte_perm(*reinterpret_cast<const uint32_t*>(row + 8), 0, sel);
}

__device__ __forceinline__ uint32_t clamp_shift16(int32_t v) {
  // the reference's branchless clamp (util.zig:58-77): v >> 16 into 0..255
  // (__vimin_s32_relu: max(min(a, b), 0), one DPX instruction on Hopper)
  return static_cast<uint32_t>(__vimin_s32_relu(v >> 16, 255));
}

// The chroma terms of exact YCbCr->RGB (util.zig:40-86) for a row's four
// pixels, computed once per distinct sample: ``lf`` is log2 of the
// horizontal replication (0, 1 or 2).
struct ChromaTerms {
  int32_t r[4], g[4], b[4];
};

__device__ __forceinline__ void chroma_terms(uint32_t cb, uint32_t cr, int lf, ChromaTerms& t) {
  const int step = lf == 2 ? 4 : (lf == 1 ? 2 : 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i % step) {  // the same sample as pixel i - 1
      t.r[i] = t.r[i - 1], t.g[i] = t.g[i - 1], t.b[i] = t.b[i - 1];
      continue;
    }
    const int32_t vb = static_cast<int32_t>((cb >> (8 * i)) & 255) - 128;
    const int32_t vr = static_cast<int32_t>((cr >> (8 * i)) & 255) - 128;
    t.r[i] = 91881 * vr, t.g[i] = -22554 * vb - 46802 * vr, t.b[i] = 116130 * vb;
  }
}

__device__ __forceinline__ void ycc_row(uint32_t y, const ChromaTerms& t, uint32_t (&o)[4]) {
  uint32_t r = 0, gg = 0, b = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t yy = static_cast<int32_t>((y >> (8 * i)) & 255) * 0x10101;
    r |= clamp_shift16(yy + t.r[i]) << (8 * i);
    gg |= clamp_shift16(yy + t.g[i]) << (8 * i);
    b |= clamp_shift16(yy + t.b[i]) << (8 * i);
  }
  o[0] = r, o[1] = gg, o[2] = b;
}

// A row's samples a[c] -> its channels o[ch] (byte i pixel i), for the
// gray, rgb and cmyk arms.
__device__ __forceinline__ void direct_row(int mode, const uint32_t (&a)[4], uint32_t (&o)[4]) {
  if (mode == kCmyk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = ~a[c];  // 255 - v in every byte
  } else {  // gray, rgb: the samples themselves
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = a[c];
  }
}

// Four pixels of row y of image b from x: [B, C, H, W] when planar, else
// [B, H, W, C] ([B, H, W] for gray).
__device__ __forceinline__ void store4(const StripGeo& g, uint8_t* out, int64_t b, int y,
                                       int x, const uint32_t (&o)[4]) {
  const int64_t plane = static_cast<int64_t>(g.height) * g.width;
  const int64_t p = static_cast<int64_t>(y) * g.width + x;
  const int nchan = g.nchan;
  if (g.words) {
    if (g.planar || nchan == 1) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        if (ch < nchan)
          *reinterpret_cast<uint32_t*>(out + (b * nchan + ch) * plane + p) = o[ch];
    } else if (nchan == 3) {  // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
      uint32_t* d = reinterpret_cast<uint32_t*>(out + (b * plane + p) * 3);
      d[0] = __byte_perm(__byte_perm(o[0], o[1], 0x5140), o[2], 0x2410);
      d[1] = __byte_perm(__byte_perm(o[1], o[2], 0x2651), o[0], 0x3610);
      d[2] = __byte_perm(__byte_perm(o[2], o[0], 0x3072), o[1], 0x3710);
    } else {  // four channels: a 4 x 4 byte transpose
      const uint32_t lo01 = __byte_perm(o[0], o[1], 0x5140), hi01 = __byte_perm(o[0], o[1], 0x7362);
      const uint32_t lo23 = __byte_perm(o[2], o[3], 0x5140), hi23 = __byte_perm(o[2], o[3], 0x7362);
      *reinterpret_cast<uint4*>(out + (b * plane + p) * 4) =
          make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
    return;
  }
  const int n = min(4, g.width - x);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch < nchan)
        out[g.planar ? (b * nchan + ch) * plane + p + i : (b * plane + p + i) * nchan + ch] =
            static_cast<uint8_t>(o[ch] >> (8 * i));
    }
  }
}

// x / 3 for any 32-bit x, by a multiply-high.
__device__ __forceinline__ uint32_t div3(uint32_t x) { return __umulhi(x, 0xAAAAAAABu) >> 1; }

// Pixels: every 4 x 2 tile of the strip's region, cropped to H x W.  The
// chroma terms of a tile are computed once per distinct sample (once for
// both rows where the chroma is replicated vertically).  kThirds: hmax is
// 3, so a tile row of the strip holds strip * 6 tiles, not a power of two.
template <bool kThirds>
__device__ __forceinline__ void pixel_stage(const uint8_t* pix, const StripGeo& g,
                                            const Strip& t, uint8_t* out) {
  const int rw = 8 * g.hmax, rh = 8 * g.vmax, qpm = 2 * g.hmax, qrow = g.strip * qpm;
  const bool ycc = g.mode == kYcbcr || g.mode == kYcck;
  const int lf = g.lfh[1];
  for (int i = threadIdx.x; i < (rh >> 1) * qrow; i += kStripThreads) {
    int ly, m, lx0;
    if (kThirds) {  // i / (strip * 6), then the tile's MCU and column
      const int row = static_cast<int>(div3(static_cast<uint32_t>(i) >> (g.lstrip + 1)));
      const int qx = i - row * qrow;
      m = static_cast<int>(div3(static_cast<uint32_t>(qx) >> 1));
      ly = row * 2, lx0 = (qx - m * 6) * 4;
    } else {
      const int qx = i & (qrow - 1);
      ly = (i >> (g.lstrip + g.lqpm)) * 2, m = qx >> g.lqpm, lx0 = (qx & (qpm - 1)) * 4;
    }
    const int y = t.my * rh + ly, x = (t.mx0 + m) * rw + lx0;
    if (m >= t.nm || y >= g.height || x >= g.width) continue;
    uint32_t a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < g.ncomp) samples(pix, g, c, m, ly, lx0, a0[c], a1[c]);
    uint32_t o0[4], o1[4];
    if (ycc) {
      ChromaTerms ct;
      chroma_terms(a0[1], a0[2], lf, ct);
      ycc_row(a0[0], ct, o0);
      if (g.lfv[1] == 0) chroma_terms(a1[1], a1[2], lf, ct);
      ycc_row(a1[0], ct, o1);
      o0[3] = ~a0[3], o1[3] = ~a1[3];  // ycck: 255 - K
    } else {
      direct_row(g.mode, a0, o0);
      direct_row(g.mode, a1, o1);
    }
    store4(g, out, t.b, y, x, o0);
    if (y + 1 < g.height) store4(g, out, t.b, y + 1, x, o1);
  }
}

// A CTA's walk over its strips.  ``issue(s, buf)`` starts strip s's loads
// into buffer ``buf`` (cp.async; it may also store directly) while the
// CTA computes the strip in the other buffer; with kDc, the side buffer
// holds the strip's DC and ``quant`` the fixed quant rows, else the side
// buffer holds the strip's quant rows.
template <typename T, bool kDc, bool kThirds, typename Issue>
__device__ __forceinline__ void run_strips(const StripGeo& g, const StripSmem& L,
                                           uint8_t* smem, const int32_t* quant, Issue issue,
                                           uint8_t* out) {
  const int32_t* tab = reinterpret_cast<const int32_t*>(smem + L.tab);
  int32_t* words = reinterpret_cast<int32_t*>(smem + L.words);
  int64_t s = blockIdx.x;
  int buf = 0;
  if (s < g.n_strips) issue(s, 0);
  cp_async_commit();
  for (; s < g.n_strips; s += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this strip landed; the last strip's pixels are out
    if (s + gridDim.x < g.n_strips) issue(s + gridDim.x, buf ^ 1);
    cp_async_commit();
    const Strip t = strip_at(g, s);
    const int nrows = t.nm * g.bpm * 8;
    uint8_t* coef = smem + L.coef + buf * L.coef_bytes;
    const int32_t* aux = reinterpret_cast<const int32_t*>(smem + L.aux + buf * L.aux_bytes);
    row_pass<T, kDc>(reinterpret_cast<const T*>(coef), aux, kDc ? quant : aux, tab, words,
                     nrows);
    __syncthreads();
    col_pass(words, coef, nrows);  // the pixel blocks overwrite the read coefficients
    __syncthreads();
    pixel_stage<kThirds>(coef, g, t, out);
  }
}

}  // namespace zpix
