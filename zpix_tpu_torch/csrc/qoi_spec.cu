// K23: QOI decoded on the card with no host pass (BatchQoiDecoder).
//
// Replaces zpix_tpu/parallel/qoi_batch.py::build_qoi_decode_fn (:158-565).
// Each image's op stream is cut into chunks of ``chunk_bytes``; a chunk's
// lane decodes ops from an entry state (byte position, previous pixel,
// the 64-entry index) to the first op boundary at or past its chunk's end.
// Chunk c's entry is chunk c - 1's exit and chunk 0 enters at the image's
// first op with pixel (0, 0, 0, 255) and a zero index, so the entries are
// the serial decode's states at the chunk starts.  A CTA an image finds
// them by rounds to the fixed point: every chunk scanned from a guess (its
// first byte, the initial pixel and index), then rounds separated by
// __syncthreads.  zpix_tpu's rounds converge slowly where an index slot
// written early is read much later (qoi_batch.py:664-669): the slot moves
// one chunk a round.  So a chunk whose entry changed only in slots it
// never reads before writing them (its read mask) is not scanned again:
// its decode is the same, and its exit takes the new values in the slots
// it does not write.  Only a change of position, pixel or a read slot
// scans the chunk again.  After r rounds the first r chunks are exact, so
// at most F + 1 rounds (the empty chunks past a shorter image's end take
// the exit of its last chunk at once); each image's count is written to
// ``rounds``.  Then
// an exclusive prefix of the chunks' pixel counts over the CTA, and a last
// scan of every chunk writes its ops' pixels in place; pixels past the
// image's emitted total repeat its final pixel (the stream-exhausted fill,
// :495-511).  ``ok`` is cleared as zpix_tpu clears it: an op that reads
// past the image's padded end, a chunk with more than ``ops_cap`` ops, or
// rounds that did not settle.  Where ``ok`` is cleared on ``ops_cap`` the
// pixels may differ from zpix_tpu's, whose records then overflow; every
// other result is the same.
//
// Bound on the H100: a chunk's op chain times the scans.  Each op's
// position and pixel depend on the op before, so a scan of a chunk is a
// serial chain of its ops; the bytes (the stream read once, the pixels
// written once) take far less.  A CTA an image leaves most SMs idle at 16
// images (PERF.md, K23).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;  // a CTA an image
constexpr uint32_t kPx0 = 0x000000ffu;  // r = g = b = 0, a = 255 (packed r << 24 | ... | a)

struct Chunk {  // one chunk's state in global scratch
  int32_t ent_pos;
  uint32_t ent_px;
  int32_t ext_pos;
  uint32_t ext_px;
  int32_t nops, npix, bad, need;
  unsigned long long rmask, wmask, pend;
  uint32_t ent_idx[64];
  uint32_t ext_idx[64];
};

struct Qoi {
  const uint8_t* s;
  const int32_t* starts;    // [B] first op byte
  const int32_t* ends;      // [B] end of the op bytes
  const int32_t* raw_ends;  // [B] end with the 8-byte padding
  uint32_t* out;            // [B, npx] RGBA bytes
  int32_t* ok;
  int32_t* rounds;  // [B]
  Chunk* chunks;    // [B * F]
  int F, cb, ops_cap;
  int64_t npx;
};

__device__ __forceinline__ int32_t chunk_start(const Qoi& p, int b, int c) {
  const int64_t s = p.starts[b] + static_cast<int64_t>(c) * p.cb;
  return static_cast<int32_t>(s < p.ends[b] ? s : p.ends[b]);
}

// The chunk whose exit is chunk c's entry: c - 1, except past the image's
// non-empty chunks (the first ``full``), where every entry is the exit of
// the last non-empty one (an empty chunk's exit is its entry).
__device__ __forceinline__ int entry_source(int c, int full) {
  return c - 1 < full ? c - 1 : (full > 0 ? full - 1 : 0);
}

__device__ __forceinline__ int32_t chunk_end(const Qoi& p, int b, int c) {
  const int64_t e = static_cast<int64_t>(chunk_start(p, b, c)) + p.cb;
  return static_cast<int32_t>(e < p.ends[b] ? e : p.ends[b]);
}

// The pixel as the output's four bytes r, g, b, a (a little-endian word).
__device__ __forceinline__ uint32_t rgba_word(uint32_t px) { return __byte_perm(px, 0, 0x0123); }

// Chunk q's ops from its entry to the first op boundary at or past ce.
// Without ``out`` it records the exit, masks and counts in q; with it,
// it writes each op's pixels at out[first + its pixel offset] below npx.
__device__ void qoi_scan(const Qoi& p, Chunk& q, int32_t ce, int32_t raw_end, uint32_t* out,
                         int64_t first) {
  uint32_t idx[64];
#pragma unroll 8
  for (int i = 0; i < 64; ++i) idx[i] = q.ent_idx[i];
  int32_t pos = q.ent_pos;
  uint32_t px = q.ent_px;
  unsigned long long rm = 0, wm = 0;
  int32_t nops = 0, npix = 0, bad = 0;
  while (pos < ce) {
    const int b1 = p.s[pos];
    const int size = b1 == 0xfe ? 4 : b1 == 0xff ? 5 : (b1 >> 6) == 2 ? 2 : 1;
    if (pos + size > raw_end) {
      bad = 1;
      break;
    }
    int r = px >> 24, g = (px >> 16) & 255, bl = (px >> 8) & 255, a = px & 255;
    int n = 1;
    if (b1 == 0xfe || b1 == 0xff) {
      r = p.s[pos + 1];
      g = p.s[pos + 2];
      bl = p.s[pos + 3];
      if (b1 == 0xff) a = p.s[pos + 4];
    } else if ((b1 >> 6) == 0) {  // OP_INDEX
      const int j = b1 & 63;
      if (!((wm >> j) & 1)) rm |= 1ull << j;
      const uint32_t v = idx[j];
      r = v >> 24;
      g = (v >> 16) & 255;
      bl = (v >> 8) & 255;
      a = v & 255;
    } else if ((b1 >> 6) == 1) {  // OP_DIFF
      r = (r + ((b1 >> 4) & 3) - 2) & 255;
      g = (g + ((b1 >> 2) & 3) - 2) & 255;
      bl = (bl + (b1 & 3) - 2) & 255;
    } else if ((b1 >> 6) == 2) {  // OP_LUMA
      const int b2 = p.s[pos + 1];
      const int dg = (b1 & 63) - 32;
      r = (r + dg + ((b2 >> 4) & 15) - 8) & 255;
      g = (g + dg) & 255;
      bl = (bl + dg + (b2 & 15) - 8) & 255;
    } else {  // OP_RUN
      n = (b1 & 63) + 1;
    }
    px = static_cast<uint32_t>(r) << 24 | static_cast<uint32_t>(g) << 16 |
         static_cast<uint32_t>(bl) << 8 | static_cast<uint32_t>(a);
    const int h = (r * 3 + g * 5 + bl * 7 + a * 11) & 63;
    idx[h] = px;
    wm |= 1ull << h;
    if (out != nullptr) {
      const uint32_t word = rgba_word(px);
      for (int64_t o = first + npix, e = first + npix + n; o < e && o < p.npx; ++o) out[o] = word;
    }
    ++nops;
    npix += n;
    pos += size;
  }
  if (out != nullptr) return;
  q.ext_pos = pos;
  q.ext_px = px;
#pragma unroll 8
  for (int i = 0; i < 64; ++i) q.ext_idx[i] = idx[i];
  q.rmask = rm;
  q.wmask = wm;
  q.nops = nops;
  q.npix = npix;
  q.bad = bad;
}

__global__ void __launch_bounds__(kThreads) qoi_spec_kernel(Qoi p) {
  __shared__ long long sh[kThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  const int per = (p.F + kThreads - 1) / kThreads;
  const int c0 = min(p.F, t * per), c1 = min(p.F, c0 + per);
  Chunk* base = p.chunks + static_cast<int64_t>(b) * p.F;
  const int32_t raw_end = p.raw_ends[b];
  const int full = (p.ends[b] - p.starts[b] + p.cb - 1) / p.cb;
  for (int c = c0; c < c1; ++c) {
    Chunk& q = base[c];
    q.ent_pos = chunk_start(p, b, c);
    q.ent_px = kPx0;
    for (int i = 0; i < 64; ++i) q.ent_idx[i] = 0;
    q.need = 1;
    q.pend = 0;
  }
  __syncthreads();
  int rounds = 0;
  bool settled = false;
  while (true) {
    for (int c = c0; c < c1; ++c) {
      if (base[c].need) {
        qoi_scan(p, base[c], chunk_end(p, b, c), raw_end, nullptr, 0);
        base[c].need = 0;
      }
    }
    __syncthreads();
    int changed = 0;
    for (int c = c0 > 0 ? c0 : 1; c < c1; ++c) {
      const Chunk& prev = base[entry_source(c, full)];
      Chunk& q = base[c];
      if (prev.ext_pos != q.ent_pos || prev.ext_px != q.ent_px) {
        q.ent_pos = prev.ext_pos;
        q.ent_px = prev.ext_px;
        for (int i = 0; i < 64; ++i) q.ent_idx[i] = prev.ext_idx[i];
        q.need = 1;
        changed = 1;
        continue;
      }
      unsigned long long d = 0;
      for (int i = 0; i < 64; ++i) {
        const uint32_t v = prev.ext_idx[i];
        if (v != q.ent_idx[i]) {
          q.ent_idx[i] = v;
          d |= 1ull << i;
        }
      }
      if (d) {
        changed = 1;
        if (d & q.rmask) {
          q.need = 1;
        } else {
          q.pend = d;
        }
      }
    }
    __syncthreads();
    // chunks whose entry changed only in slots they do not read: their
    // exit takes the new values in the slots they do not write
    for (int c = c0; c < c1; ++c) {
      Chunk& q = base[c];
      unsigned long long m = q.pend & ~q.wmask;
      while (m) {
        const int i = __ffsll(static_cast<long long>(m)) - 1;
        q.ext_idx[i] = q.ent_idx[i];
        m &= m - 1;
      }
      q.pend = 0;
    }
    ++rounds;
    if (!__syncthreads_or(changed)) {
      settled = true;
      break;
    }
    if (rounds > p.F + 2) break;
  }
  int bad = settled ? 0 : 1;
  long long mine = 0;
  for (int c = c0; c < c1; ++c) {
    mine += base[c].npix;
    if (base[c].bad || base[c].nops > p.ops_cap) bad = 1;
  }
  // exclusive prefix of the pixel counts over the CTA
  sh[t] = mine;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const long long a = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += a;
    __syncthreads();
  }
  const long long total = sh[kThreads - 1];
  long long first = sh[t] - mine;
  uint32_t* out = p.out + static_cast<int64_t>(b) * p.npx;
  for (int c = c0; c < c1; ++c) {
    if (first < p.npx) qoi_scan(p, base[c], chunk_end(p, b, c), raw_end, out, first);
    first += base[c].npix;
  }
  const uint32_t fill = rgba_word(base[p.F - 1].ext_px);
  for (int64_t o = total + t; o < p.npx; o += kThreads) out[o] = fill;
  if (t == 0) p.rounds[b] = rounds;
  if (__syncthreads_or(bad) && t == 0) *p.ok = 0;
}

}  // namespace

// ------------------------------------------------------------ C entry points

extern "C" int zpix_qoi_spec(const void* s, const void* starts, const void* ends,
                             const void* raw_ends, void* out, void* ok, void* rounds,
                             void* chunks, int batch, int F, int cb, int ops_cap, int64_t npx,
                             void* stream) {
  if (F < 1 || cb < 1 || ops_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  Qoi p{};
  p.s = static_cast<const uint8_t*>(s);
  p.starts = static_cast<const int32_t*>(starts);
  p.ends = static_cast<const int32_t*>(ends);
  p.raw_ends = static_cast<const int32_t*>(raw_ends);
  p.out = static_cast<uint32_t*>(out);
  p.ok = static_cast<int32_t*>(ok);
  p.rounds = static_cast<int32_t*>(rounds);
  p.chunks = static_cast<Chunk*>(chunks);
  p.F = F;
  p.cb = cb;
  p.ops_cap = ops_cap;
  p.npx = npx;
  if (batch > 0) {
    qoi_spec_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch a chunk takes (the wrapper allocates B * F of them).
extern "C" int zpix_qoi_spec_chunk_bytes() { return static_cast<int>(sizeof(Chunk)); }
