// K23: QOI decoded on the card with no host pass (BatchQoiDecoder).
//
// Replaces zpix_tpu/parallel/qoi_batch.py::build_qoi_decode_fn (:158-565).
// Each image's op stream is cut into chunks of ``chunk_bytes``; chunk c
// holds the ops that start in its bytes.  The serial decode carries a
// position, the previous pixel and a 64-entry index from op to op; here
// the three are found apart, with no round a chunk, in one cooperative
// launch over the whole batch (a persistent grid, phases between grid
// barriers):
//
//  1. op boundaries, with no pixel state (an op's length is its first
//     byte's, so a walk from any byte joins the true op chain within a
//     few ops).  A: every chunk walked from its first byte (the guess),
//     keeping its first kNG op positions.  B: every chunk walked from the
//     guess exit of the chunk before (its candidate entry) until it lands
//     on a position of its own guess walk (then its exit and count are the
//     guess's); where that exit is not the next chunk's guess exit, it is
//     put in as the next chunk's second candidate and that chunk walked
//     from it.  C: a warp an image follows the true path through the two
//     candidates, 32 chunks a step by ballots, walking a chunk itself
//     where both miss; the exclusive prefix of the chunks' op counts gives
//     every op its index, and ``ok`` is cleared on a chunk of more than
//     ``ops_cap`` ops or an op that reads past the image's padded end.
//  2. records.  An op maps the (pixel) state by one of: a delta on r, g,
//     b (DIFF, LUMA, RUN), r, g, b set (RGB), all set (RGBA), or all set to
//     an index value (INDEX).  Composed, a run of ops is one such map, so
//     D walks each chunk into its map, E (a warp an image) scans the maps
//     over the chunks, and F walks each chunk from the state before it and
//     writes one record an op: its pixel as ``sel(K, value of INDEX op
//     r + w, w)`` (K: no byte, alpha, all), its index slot or run, its
//     first pixel.
//  3. passes.  INDEX op k's value is the pixel of its source, the last op
//     before it whose pixel hashed to its slot (0 if none).  Given the
//     sources, the values follow by pointer jumping over the INDEX ops
//     (Wyllie, in place: an op's node is its source's record, composed
//     with the nodes it points to until it points nowhere; a node follows
//     up to kChase pointers a round, so a chain of n takes about
//     log n / log (kChase + 1) rounds); given the pixels, the sources
//     follow from per-tile last-writer tables (P1, a block a tile: pixels,
//     hashes, the tile's last op a slot; P2: a thread an (image, slot)
//     takes the exclusive max over its tiles; P3, a warp a tile: the
//     lanes of each slot in a 32-op group as a mask in shared memory, the
//     last op a slot before the group kept in two registers a lane from
//     the tile's carry on, so each INDEX op's source is the last lane of
//     its slot before it in the group, or that; the next 128 ops' loads in
//     flight; then a thread an INDEX op compares its source with the last
//     pass's and sets its node).  Passes alternate until
//     no source changes (each fixes at least the earliest wrong one; the
//     fixed point is the serial decode); a flag on the card ends the loop,
//     a pass takes an image's tiles only from its first tile whose sources
//     changed in the pass before (the ops before it are final), and an
//     image whose sources settled takes no further pass.  ``rounds`` gets
//     each image's passes.  Passes are capped at the most ops an image
//     holds + 2, which only a fault could reach; a cap that is hit clears
//     ``ok`` (zpix_tpu's rounds_cap guard, qoi_batch.py:555-562).
//  4. expansion: each op's pixel at its first pixel and the run after it,
//     below H * W; pixels past the image's total repeat its final pixel
//     (the stream-exhausted fill, :495-511).
//
// Where ``ok`` is cleared on ``ops_cap`` the pixels may differ from
// zpix_tpu's, whose records then overflow; every other result is the same.
//
// Bound on the H100: bytes, the stream read and the pixels written once
// (``utils/roofline.py``), beside the dependent chain of one chunk's ops
// (about 1,266 ops of the bench's noise at 2 KiB chunks, assumed 30 cycles
// an op): the walks A, D and F each take that chain once; they decode an
// op with no branch (a warp's lanes walk ops of every kind).  The passes move about
// 30 bytes an op each and are bound by memory bandwidth and, where they
// are short, by their grid barriers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "timing.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 2048;            // ops a tile of the passes
constexpr int kNG = 8;                 // guess positions kept a chunk
constexpr int32_t kBad = 1 << 30;      // an op count's flag: the walk stopped on a bad op
constexpr int32_t kCountMask = kBad - 1;
constexpr uint32_t kPx0 = 0x000000ffu;  // r = g = b = 0, a = 255 (r << 24 | g << 16 | b << 8 | a)
constexpr uint32_t kNoRoot = 0xffffffffu;  // a root word: the pixel is w
constexpr uint32_t kAlphaOnly = 0x80000000u;  // a root word's flag: only alpha comes from the root
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kSettled = 0x7fffffff;  // an image's sources did not change

// The chunk words (int32 [kChunkWords, L]), the elements (int32 [6, L]),
// the image words (int32 [kImageWords, B]) and the op words (int32
// [kOpWords, cap]).
enum {
  kGx, kGn, kY0, kN0, kXb, kY1, kN1, kEnt, kNops, kOpBase, kNpix, kPixBase, kNidx, kIdxBase,
  kChunkWords
};
enum { kImgOps, kImgPix, kImgIdx, kIdxOff, kFrom0, kFrom1, kImageWords };
enum { kRoot, kW, kPixOff, kPx, kSrc, kSrcNew, kList, kOpWords };

struct Qoi {
  const uint8_t* s;
  const int32_t* starts;    // [B] first op byte
  const int32_t* ends;      // [B] end of the op bytes
  const int32_t* raw_ends;  // [B] end with the 8-byte padding
  uint32_t* out;            // [B, npx] RGBA bytes
  int32_t* ok;
  int32_t* rounds;   // [B] passes
  int32_t* cw;       // chunk words
  int32_t* gpos;     // [L, kNG]
  int32_t* el;       // chunk maps: agg (mode, w0, w), carry (mode, w0, w)
  int32_t* iw;       // image words
  int32_t* flags;    // [3] Wyllie rounds' "a node still points somewhere"
  int32_t* ow;       // op words, an op at slot starts[b] + its index
  uint8_t* meta;     // [cap] 0x80 | slot (INDEX), else run length - 1
  unsigned long long* node;  // [cap] INDEX ops: root word << 32 | w
  int32_t* tbl;      // [B * tpi, 64] each tile's last op a slot
  int32_t* carry;    // [B * tpi, 64] the last op a slot before each tile
  int64_t* stamps;   // [n_stamps, 2] (phase, %globaltimer ns) after each barrier, or null
  int n_stamps;
  int B, F, cb, ops_cap, tpi;
  int64_t L, cap, npx;
};

__device__ __forceinline__ int32_t* cwp(const Qoi& p, int w) { return p.cw + w * p.L; }
__device__ __forceinline__ int32_t* iwp(const Qoi& p, int w) { return p.iw + w * p.B; }
__device__ __forceinline__ int32_t* owp(const Qoi& p, int w) { return p.ow + w * p.cap; }

__device__ __forceinline__ int32_t chunk_start(const Qoi& p, int b, int c) {
  const int64_t s = p.starts[b] + static_cast<int64_t>(c) * p.cb;
  return static_cast<int32_t>(s < p.ends[b] ? s : p.ends[b]);
}

__device__ __forceinline__ int32_t chunk_end(const Qoi& p, int b, int c) {
  const int64_t e = static_cast<int64_t>(chunk_start(p, b, c)) + p.cb;
  return static_cast<int32_t>(e < p.ends[b] ? e : p.ends[b]);
}

// The image's last non-empty chunk (-1 for an empty stream).
__device__ __forceinline__ int last_chunk(const Qoi& p, int b) {
  return (p.ends[b] - p.starts[b] + p.cb - 1) / p.cb - 1;
}

// The 5 bytes from pos, the first in bits 39..32: five independent loads
// (bytes past the buffer read as 0).
__device__ __forceinline__ uint64_t bytes5(const Qoi& p, int32_t pos) {
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) v = v << 8 | (pos + i < p.cap ? __ldg(p.s + pos + i) : 0u);
  return v;
}

__device__ __forceinline__ int op_size(uint32_t b1) {
  return b1 == 0xfe ? 4 : b1 == 0xff ? 5 : (b1 >> 6) == 2 ? 2 : 1;
}

// Ops from byte pos to the first op boundary at or past ce; an op that
// reads past raw_end stops the walk there (kBad).  -> (exit, ops | kBad).
// With ``rec``, the first kNG op positions go there.  With ``gp`` (the
// chunk's guess walk: its first ng positions, exit gx, ops gn), a walk
// that lands on one of those positions takes the rest of the guess's.
__device__ int2 walk(const Qoi& p, int32_t pos, int32_t ce, int32_t raw_end, int32_t* rec,
                     const int32_t* gp, int ng, int32_t gx, int32_t gn) {
  int32_t n = 0;
  int i = 0;
  while (pos < ce) {
    if (gp != nullptr) {
      while (i < ng && gp[i] < pos) ++i;
      if (i < ng && gp[i] == pos) return make_int2(gx, (n + (gn & kCountMask) - i) | (gn & kBad));
    }
    const int size = op_size(pos < p.cap ? __ldg(p.s + pos) : 0u);
    if (pos + size > raw_end) return make_int2(pos, n | kBad);
    if (rec != nullptr && n < kNG) rec[n] = pos;
    ++n;
    pos += size;
  }
  return make_int2(pos, n);
}

// Chunk lane l's walk from pos, joining its guess walk.
__device__ __forceinline__ int2 join_walk(const Qoi& p, int64_t l, int b, int c, int32_t pos) {
  const int32_t gn = cwp(p, kGn)[l];
  const int ng = min(gn & kCountMask, kNG);
  return walk(p, pos, chunk_end(p, b, c), p.raw_ends[b], nullptr, p.gpos + l * kNG, ng,
              cwp(p, kGx)[l], gn);
}

// ------------------------------------------------------------- pixel maps

// A run of ops as a map of the state (r, w, K): the pixel is w where K is
// kNoRoot, else sel(K, value of INDEX op r + w, w) per byte (K: alpha
// alone or all four bytes).  mode 0: bytewise delta w (alpha 0); 1: r, g,
// b set to w's, alpha kept; 2: the state set to (w0, w).
struct Map {
  int32_t mode;
  uint32_t w0, w;
};

__device__ __forceinline__ Map then(const Map& a, const Map& b) {  // a, then b (no branch)
  const Map pass{a.mode, a.w0, __vadd4(a.w, b.w)};
  const Map set_rgb{2, a.w0 == kNoRoot ? kNoRoot : a.w0 | kAlphaOnly,
                    (b.w & 0xffffff00u) | (a.w & 0xffu)};
  return b.mode == 2 ? b : b.mode == 1 ? (a.mode == 2 ? set_rgb : b) : pass;
}

// The op whose 5 bytes from its first are x (bytes5), at global op
// slot ``slot`` -> its map; *n its pixels, *meta its record byte; returns
// its size.  With no branch: the lanes of a warp walk ops of every kind.
__device__ __forceinline__ int op_map(uint64_t x, uint32_t slot, Map* m, int* n, uint8_t* meta) {
  const uint32_t b1 = static_cast<uint32_t>(x >> 32), lo = static_cast<uint32_t>(x);
  const uint32_t op = b1 >> 6;
  const bool rgb = b1 == 0xfe, rgba = b1 == 0xff, lit = b1 < 0xfe;
  const bool idx = lit && op == 0, diff = lit && op == 1, luma = lit && op == 2;
  const bool run = lit && op == 3;
  const uint32_t dd = (((b1 >> 4) & 3) - 2) << 24 | ((((b1 >> 2) & 3) - 2) & 255) << 16 |
                      (((b1 & 3) - 2) & 255) << 8;
  const uint32_t b2 = lo >> 24, dg = (b1 & 63) - 32;
  const uint32_t dl = ((dg + ((b2 >> 4) & 15) - 8) & 255) << 24 | (dg & 255) << 16 |
                      ((dg + (b2 & 15) - 8) & 255) << 8;
  m->mode = rgba || idx ? 2 : rgb ? 1 : 0;
  m->w0 = idx ? slot : kNoRoot;
  m->w = rgba ? lo : rgb ? (lo & 0xffffff00u) : diff ? dd : luma ? dl : 0u;
  *n = run ? static_cast<int>(b1 & 63) + 1 : 1;
  *meta = static_cast<uint8_t>(idx ? 0x80 | (b1 & 63) : run ? (b1 & 63) : 0);
  return rgb ? 4 : rgba ? 5 : luma ? 2 : 1;
}

__device__ __forceinline__ uint32_t sel(uint32_t k, uint32_t a, uint32_t b) {
  return (a & k) | (b & ~k);
}

__device__ __forceinline__ uint32_t root_mask(uint32_t w0) {
  return (w0 & kAlphaOnly) ? 0xffu : kFull;
}

// The pixel of a record (root word w0, w) given the INDEX values in node.
__device__ __forceinline__ uint32_t pixel_of(const Qoi& p, uint32_t w0, uint32_t w) {
  if (w0 == kNoRoot) return w;
  const uint32_t v = static_cast<uint32_t>(p.node[w0 & ~kAlphaOnly]);
  return sel(root_mask(w0), __vadd4(v, w), w);
}

__device__ __forceinline__ int hash_of(uint32_t px) {
  return static_cast<int>(((px >> 24) * 3 + ((px >> 16) & 255) * 5 + ((px >> 8) & 255) * 7 +
                           (px & 255) * 11) & 63);
}

// The pixel as the output's four bytes r, g, b, a (a little-endian word).
__device__ __forceinline__ uint32_t rgba_word(uint32_t px) { return __byte_perm(px, 0, 0x0123); }

__device__ __forceinline__ Map shfl_up_map(const Map& m, int up) {
  return Map{__shfl_up_sync(kFull, m.mode, up), __shfl_up_sync(kFull, m.w0, up),
             __shfl_up_sync(kFull, m.w, up)};
}

// ------------------------------------------------------------------ phases

struct Grid {
  int64_t tid, threads;  // this thread's rank and the grid's, chunk lanes spread over blocks
  int64_t warp, warps;
};

// A: every chunk walked from its first byte.
__device__ void guesses(const Qoi& p, const Grid& g) {
  for (int64_t l = g.tid; l < p.L; l += g.threads) {
    const int b = static_cast<int>(l / p.F);
    const int c = static_cast<int>(l - static_cast<int64_t>(b) * p.F);
    const int2 r = walk(p, chunk_start(p, b, c), chunk_end(p, b, c), p.raw_ends[b],
                        p.gpos + l * kNG, nullptr, 0, 0, 0);
    cwp(p, kGx)[l] = r.x;
    cwp(p, kGn)[l] = r.y;
  }
}

// B: chunk c walked from the guess exit of chunk c - 1; a miss of the next
// chunk's guess exit put in as its second candidate.
__device__ void links(const Qoi& p, const Grid& g) {
  for (int64_t l = g.tid; l < p.L; l += g.threads) {
    const int b = static_cast<int>(l / p.F);
    const int c = static_cast<int>(l - static_cast<int64_t>(b) * p.F);
    const int J = last_chunk(p, b);
    if (c < 1 || c > J) continue;
    const int2 y = join_walk(p, l, b, c, cwp(p, kGx)[l - 1]);
    cwp(p, kY0)[l] = y.x;
    cwp(p, kN0)[l] = y.y;
    if (c + 1 <= J && y.x != cwp(p, kGx)[l]) {
      const int2 z = join_walk(p, l + 1, b, c + 1, y.x);
      cwp(p, kXb)[l] = y.x;
      cwp(p, kY1)[l + 1] = z.x;
      cwp(p, kN1)[l + 1] = z.y;
    }
  }
}

// C, a warp an image: the true path's candidate for every chunk, the
// entries and op counts, the ops' indices, ok.  Chunk 1 takes chunk 0's
// guess exit (candidate 0); after a chunk on candidate 0 whose exit missed
// the next chunk's guess exit, that chunk takes candidate 1 (put in by B);
// after one on candidate 1 that missed too, the warp walks the next chunk
// from the exit and puts it in as that chunk's candidate 1.
__device__ void resolve(const Qoi& p, int b, int lane) {
  const int64_t base = static_cast<int64_t>(b) * p.F;
  const int J = last_chunk(p, b);
  const int32_t* gx = cwp(p, kGx);
  int col = 0;  // the candidate of the next chunk to place
  int32_t ops = 0;
  int bad = 0;
  for (int w0 = 0; w0 < p.F; w0 += 32) {
    const int c = w0 + lane;
    const int64_t l = base + c;
    const unsigned m0 = __ballot_sync(kFull, c >= 1 && c + 1 <= J && cwp(p, kY0)[l] != gx[l]);
    unsigned colmask = 0;  // the window's chunks on candidate 1
    int i = w0 == 0 ? 1 : 0;
    while (i < 32 && w0 + i <= J) {
      if (col == 0) {
        const unsigned rest = m0 >> i;
        if (rest == 0) break;
        i += __ffs(static_cast<int>(rest));  // the chunk after the first miss
        col = 1;
        continue;
      }
      const int ci = w0 + i;
      const int64_t li = base + ci;
      colmask |= 1u << i;
      col = 0;
      if (ci + 1 <= J) {
        const int32_t y = cwp(p, kY1)[li];
        if (y != gx[li]) {  // both candidates missed: walk the next chunk from y
          const int2 z = join_walk(p, li + 1, b, ci + 1, y);
          if (lane == 0) {
            cwp(p, kXb)[li] = y;
            cwp(p, kY1)[li + 1] = z.x;
            cwp(p, kN1)[li + 1] = z.y;
          }
          __syncwarp();
          col = 1;
        }
      }
      ++i;
    }
    __syncwarp();
    // this lane's chunk: its entry and ops from its candidate
    int32_t n = 0, ent = p.ends[b];
    if (c == 0) {
      ent = p.starts[b];
      n = J >= 0 ? cwp(p, kGn)[l] : 0;
    } else if (c <= J) {
      const bool second = (colmask >> lane) & 1u;
      ent = second ? cwp(p, kXb)[l - 1] : gx[l - 1];
      n = second ? cwp(p, kN1)[l] : cwp(p, kN0)[l];
    }
    bad |= (n & kBad) != 0 || (n & kCountMask) > p.ops_cap;
    n &= kCountMask;
    int32_t incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (c < p.F) {
      cwp(p, kEnt)[l] = ent;
      cwp(p, kNops)[l] = n;
      cwp(p, kOpBase)[l] = ops + incl - n;
    }
    ops += __shfl_sync(kFull, incl, 31);
  }
  if (__any_sync(kFull, bad) && lane == 0) *p.ok = 0;
  if (lane == 0) iwp(p, kImgOps)[b] = ops;
}

// D: each chunk's ops composed into one map, its pixels and INDEX ops.
__device__ void chunk_maps(const Qoi& p, const Grid& g) {
  for (int64_t l = g.tid; l < p.L; l += g.threads) {
    const int b = static_cast<int>(l / p.F);
    const int32_t n = cwp(p, kNops)[l];
    int32_t pos = cwp(p, kEnt)[l];
    const uint32_t slot0 = static_cast<uint32_t>(p.starts[b] + cwp(p, kOpBase)[l]);
    Map acc{0, 0, 0};
    int32_t px = 0, nidx = 0;
    for (int32_t i = 0; i < n; ++i) {
      Map m;
      int k;
      uint8_t meta;
      pos += op_map(bytes5(p, pos), slot0 + i, &m, &k, &meta);
      acc = then(acc, m);
      px += k;
      nidx += meta >> 7;
    }
    p.el[l] = acc.mode;
    p.el[p.L + l] = static_cast<int32_t>(acc.w0);
    p.el[2 * p.L + l] = static_cast<int32_t>(acc.w);
    cwp(p, kNpix)[l] = px;
    cwp(p, kNidx)[l] = nidx;
  }
}

// E, a warp an image: the state before each chunk, its first pixel and its
// first INDEX op's place in the image's list.
__device__ void chunk_carries(const Qoi& p, int b, int lane) {
  const int64_t base = static_cast<int64_t>(b) * p.F;
  const int per = (p.F + 31) / 32;
  const int c0 = min(p.F, lane * per), c1 = min(p.F, c0 + per);
  auto agg = [&](int c) {
    const int64_t l = base + c;
    return Map{p.el[l], static_cast<uint32_t>(p.el[p.L + l]),
               static_cast<uint32_t>(p.el[2 * p.L + l])};
  };
  Map acc{0, 0, 0};
  int32_t px = 0, ix = 0;
  for (int c = c0; c < c1; ++c) {
    acc = then(acc, agg(c));
    px += cwp(p, kNpix)[base + c];
    ix += cwp(p, kNidx)[base + c];
  }
  // exclusive scan of the lanes' maps (in lane order) and counts
  Map incl = acc;
  int32_t pincl = px, iincl = ix;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map u = shfl_up_map(incl, d);
    const int32_t pu = __shfl_up_sync(kFull, pincl, d), iu = __shfl_up_sync(kFull, iincl, d);
    if (lane >= d) {
      incl = then(u, incl);
      pincl += pu;
      iincl += iu;
    }
  }
  Map st = shfl_up_map(incl, 1);
  int32_t pix = __shfl_up_sync(kFull, pincl, 1), idx = __shfl_up_sync(kFull, iincl, 1);
  const Map start{2, kNoRoot, kPx0};
  st = lane == 0 ? start : then(start, st);
  pix = lane == 0 ? 0 : pix;
  idx = lane == 0 ? 0 : idx;
  for (int c = c0; c < c1; ++c) {
    const int64_t l = base + c;
    p.el[3 * p.L + l] = st.mode;
    p.el[4 * p.L + l] = static_cast<int32_t>(st.w0);
    p.el[5 * p.L + l] = static_cast<int32_t>(st.w);
    cwp(p, kPixBase)[l] = pix;
    cwp(p, kIdxBase)[l] = idx;
    st = then(st, agg(c));
    pix += cwp(p, kNpix)[l];
    idx += cwp(p, kNidx)[l];
  }
  if (lane == 31) {
    iwp(p, kImgPix)[b] = pix;
    iwp(p, kImgIdx)[b] = idx;
  }
}

// F: each chunk walked from the state before it, a record an op.
__device__ void records(const Qoi& p, const Grid& g) {
  for (int64_t l = g.tid; l < p.L; l += g.threads) {
    const int b = static_cast<int>(l / p.F);
    const int32_t n = cwp(p, kNops)[l];
    int32_t pos = cwp(p, kEnt)[l];
    const int64_t slot0 = p.starts[b] + cwp(p, kOpBase)[l];
    Map st{p.el[3 * p.L + l], static_cast<uint32_t>(p.el[4 * p.L + l]),
           static_cast<uint32_t>(p.el[5 * p.L + l])};
    int32_t pix = cwp(p, kPixBase)[l];
    int32_t* list = owp(p, kList) + p.starts[b] + cwp(p, kIdxBase)[l];  // the image's INDEX ops
    for (int32_t i = 0; i < n; ++i) {
      const int64_t slot = slot0 + i;
      Map m;
      int k;
      uint8_t meta;
      pos += op_map(bytes5(p, pos), static_cast<uint32_t>(slot), &m, &k, &meta);
      st = then(st, m);
      owp(p, kRoot)[slot] = static_cast<int32_t>(st.w0);
      owp(p, kW)[slot] = static_cast<int32_t>(st.w);
      owp(p, kPixOff)[slot] = pix;
      p.meta[slot] = meta;
      if (meta & 0x80) {  // no source yet: the value 0
        *list++ = static_cast<int32_t>(slot);
        owp(p, kSrc)[slot] = -1;
        p.node[slot] = static_cast<unsigned long long>(kNoRoot) << 32;
      }
      pix += k;
    }
  }
}

// The tiles of every image from tile from[b] on (every tile where from is
// null, none where it is kSettled), a block a tile: calls fn(b, t, k0, k1)
// for tile t of image b (ops [k0, k1)).
template <typename Fn>
__device__ void for_tiles(const Qoi& p, const int32_t* from, Fn fn) {
  for (int64_t it = blockIdx.x; it < static_cast<int64_t>(p.B) * p.tpi; it += gridDim.x) {
    const int b = static_cast<int>(it / p.tpi), t = static_cast<int>(it % p.tpi);
    const int32_t nops = iwp(p, kImgOps)[b];
    const int32_t k0 = t * kTile;
    if (k0 < nops && (from == nullptr || t >= from[b])) fn(b, t, k0, min(k0 + kTile, nops));
  }
}

// The same, a warp a tile: calls fn(b, t, k0, k1) in every warp.
template <typename Fn>
__device__ void for_warp_tiles(const Qoi& p, const int32_t* from, const Grid& g, Fn fn) {
  for (int64_t it = g.warp; it < static_cast<int64_t>(p.B) * p.tpi; it += g.warps) {
    const int b = static_cast<int>(it / p.tpi), t = static_cast<int>(it % p.tpi);
    const int32_t nops = iwp(p, kImgOps)[b];
    const int32_t k0 = t * kTile;
    if (k0 < nops && t >= from[b]) fn(b, t, k0, min(k0 + kTile, nops));
  }
}

// A warp's 32 ops (hash h, -1 for none) -> each lane's mask of the lanes
// whose hash is its lane (lo) and its lane + 32 (hi), and of those whose
// hash is j (mj; 0 where j < 0), through the warp's table sm (a shared
// atomicOr a lane).
__device__ __forceinline__ void slot_masks(uint32_t* sm, int lane, int h, int j, unsigned* lo,
                                           unsigned* hi, unsigned* mj) {
  sm[lane] = sm[lane + 32] = 0;
  __syncwarp();
  if (h >= 0) atomicOr(sm + h, 1u << lane);
  __syncwarp();
  *lo = sm[lane];
  *hi = sm[lane + 32];
  *mj = j >= 0 ? sm[j] : 0u;
  __syncwarp();
}

// The last lane of mask m as an op index after gbase, or keep.
__device__ __forceinline__ int32_t last_of(unsigned m, int32_t gbase, int32_t keep) {
  return m ? gbase + 31 - __clz(static_cast<int>(m)) : keep;
}

constexpr int kChase = 8;  // Wyllie: pointers a node follows a round

// The image of entry i of the INDEX lists as one: the last whose list
// starts at or before i.
__device__ __forceinline__ int list_image(const Qoi& p, int64_t i) {
  int lo = 0, hi = p.B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (iwp(p, kIdxOff)[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Phases as the stamps name them.
enum { kStart, kGuesses, kLinks, kResolve, kMaps, kCarries, kRecords, kPixels = 11, kCarry,
       kSources, kWyllie, kNodes, kExpand = 20 };

__global__ void __launch_bounds__(kThreads, 2) qoi_spec_kernel(Qoi p) {
  cg::grid_group grid = cg::this_grid();
  int n_stamp = 0;
  // after a barrier: block 0's thread 0 notes the phase that ended and the time
  auto sync = [&](int phase) {
    grid.sync();
    if (p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && n_stamp < p.n_stamps) {
      uint64_t ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      p.stamps[2 * n_stamp] = phase;
      p.stamps[2 * n_stamp + 1] = static_cast<int64_t>(ns);
      ++n_stamp;
    }
  };
  if (p.stamps != nullptr) sync(kStart);
  __shared__ uint32_t smask[kThreads / 32][64];  // P3: a warp's lanes a slot
  __shared__ int32_t stbl[64];                   // P1: the tile's last op a slot
  const int tid = threadIdx.x, lane = tid & 31, wib = tid >> 5;
  Grid g;
  g.tid = blockIdx.x + static_cast<int64_t>(gridDim.x) * tid;  // chunk lanes across the SMs
  g.threads = static_cast<int64_t>(gridDim.x) * kThreads;
  g.warp = blockIdx.x + static_cast<int64_t>(gridDim.x) * wib;
  g.warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  if (blockIdx.x == 0) {
    for (int b = tid; b < p.B; b += kThreads) {
      iwp(p, kFrom0)[b] = 0;  // the first pass takes every tile
    }
    if (tid < 3) p.flags[tid] = 0;
  }
  guesses(p, g);
  sync(kGuesses);
  links(p, g);
  sync(kLinks);
  for (int64_t b = g.warp; b < p.B; b += g.warps) resolve(p, static_cast<int>(b), lane);
  sync(kResolve);
  chunk_maps(p, g);
  sync(kMaps);
  for (int64_t b = g.warp; b < p.B; b += g.warps) chunk_carries(p, static_cast<int>(b), lane);
  sync(kCarries);
  if (blockIdx.x == 0 && tid == 0) {  // where each image's INDEX list starts, the lists as one
    int32_t off = 0;
    for (int b = 0; b < p.B; ++b) {
      iwp(p, kIdxOff)[b] = off;
      off += iwp(p, kImgIdx)[b];
    }
  }
  records(p, g);
  sync(kRecords);

  int32_t max_passes = 2;
  for (int b = 0; b < p.B; ++b) max_passes = max(max_passes, iwp(p, kImgOps)[b] + 2);
  for (int pass = 1;; ++pass) {
    // from[b]: the first tile of image b whose sources changed in the pass
    // before (every op before it is final: its pixel depends only on the
    // sources before it); this pass's go to next[b]
    const int32_t* from = iwp(p, (pass & 1) ? kFrom0 : kFrom1);
    int32_t* next = iwp(p, (pass & 1) ? kFrom1 : kFrom0);
    if (blockIdx.x == 0) {
      for (int b = tid; b < p.B; b += kThreads) {
        next[b] = kSettled;
        if (from[b] != kSettled) p.rounds[b] = pass;
      }
    }
    // P1, a block a tile: every op's pixel from the INDEX values; the
    // tile's last op a slot
    for_tiles(p, from, [&](int b, int t, int32_t k0, int32_t k1) {
      if (tid < 64) stbl[tid] = -1;
      __syncthreads();
      const int64_t s0 = p.starts[b];
      uint32_t px[kTile / kThreads];
#pragma unroll
      for (int q = 0; q < kTile / kThreads; ++q) {
        const int32_t k = k0 + q * kThreads + tid;
        px[q] = k < k1 ? pixel_of(p, static_cast<uint32_t>(owp(p, kRoot)[s0 + k]),
                                  static_cast<uint32_t>(owp(p, kW)[s0 + k]))
                       : 0u;
      }
#pragma unroll
      for (int q = 0; q < kTile / kThreads; ++q) {
        const int32_t k = k0 + q * kThreads + tid;
        if (k < k1) {
          owp(p, kPx)[s0 + k] = static_cast<int32_t>(px[q]);
          atomicMax(&stbl[hash_of(px[q])], k);
        }
      }
      __syncthreads();
      if (tid < 64) p.tbl[(static_cast<int64_t>(b) * p.tpi + t) * 64 + tid] = stbl[tid];
      __syncthreads();
    });
    sync(kPixels);
    // P2: a thread an (image, slot): the last op a slot before each tile
    for (int64_t it = blockIdx.x * static_cast<int64_t>(kThreads) + tid;
         it < static_cast<int64_t>(p.B) * 64; it += g.threads) {
      const int b = static_cast<int>(it >> 6), sl = static_cast<int>(it & 63);
      if (from[b] == kSettled) continue;
      const int nt = (iwp(p, kImgOps)[b] + kTile - 1) / kTile;
      const int64_t row = static_cast<int64_t>(b) * p.tpi;
      int32_t run = -1;
      for (int t0 = 0; t0 < nt; t0 += 16) {  // 16 loads in flight
        int32_t v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = t0 + u < nt ? p.tbl[(row + t0 + u) * 64 + sl] : -1;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (t0 + u < nt) p.carry[(row + t0 + u) * 64 + sl] = run;
          run = max(run, v[u]);
        }
      }
    }
    sync(kCarry);
    // P3, a warp a tile: each INDEX op's source (the last op of its slot
    // before its group, kept by the lanes from the tile's carry on, or
    // before it in its group), stored aside
    for_warp_tiles(p, from, g, [&](int b, int t, int32_t k0, int32_t k1) {
      const int64_t s0 = p.starts[b];
      const int64_t row = (static_cast<int64_t>(b) * p.tpi + t) * 64;
      int32_t run_lo = p.carry[row + lane], run_hi = p.carry[row + lane + 32];
      // 4 groups of 32 ops a step, the next step's loads in flight
      uint32_t npx[4];
      uint8_t nmt[4];
      auto load = [&](int32_t g0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int32_t k = g0 + q * 32 + lane;
          npx[q] = k < k1 ? static_cast<uint32_t>(owp(p, kPx)[s0 + k]) : 0u;
          nmt[q] = k < k1 ? p.meta[s0 + k] : 0;
        }
      };
      load(k0);
      for (int32_t g0 = k0; g0 < k1; g0 += 128) {
        uint32_t px[4];
        uint8_t mt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          px[q] = npx[q];
          mt[q] = nmt[q];
        }
        if (g0 + 128 < k1) load(g0 + 128);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int32_t k = g0 + q * 32 + lane, gbase = g0 + q * 32;
          const int j = (mt[q] & 0x80) ? (mt[q] & 63) : -1;
          unsigned lo, hi, mj;
          slot_masks(smask[wib], lane, k < k1 ? hash_of(px[q]) : -1, j, &lo, &hi, &mj);
          const int32_t rl = __shfl_sync(kFull, run_lo, j & 31);
          const int32_t rh = __shfl_sync(kFull, run_hi, j & 31);
          if (j >= 0) {
            owp(p, kSrcNew)[s0 + k] =
                last_of(mj & ((1u << lane) - 1u), gbase, j >= 32 ? rh : rl);
          }
          run_lo = last_of(lo, gbase, run_lo);
          run_hi = last_of(hi, gbase, run_hi);
        }
      }
    });
    sync(kSources);
    // P3b, a thread an INDEX op (the images' lists as one): a source that
    // changed lowers next[b] to its tile; every node from its source's
    // record
    if (blockIdx.x == 0 && tid == 0) p.flags[0] = 0;  // Wyllie's first round's flag
    const int32_t total = iwp(p, kIdxOff)[p.B - 1] + iwp(p, kImgIdx)[p.B - 1];
    for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + tid; i < total;
         i += g.threads) {
      const int b = list_image(p, i);
      if (from[b] == kSettled) continue;
      const int64_t s0 = p.starts[b];
      const int64_t slot = owp(p, kList)[s0 + (i - iwp(p, kIdxOff)[b])];
      const int32_t t = static_cast<int32_t>((slot - s0) / kTile);
      if (t < from[b]) continue;
      const int32_t src = owp(p, kSrcNew)[slot];
      if (owp(p, kSrc)[slot] != src) {
        owp(p, kSrc)[slot] = src;
        if (t < *reinterpret_cast<volatile int32_t*>(next + b)) atomicMin(next + b, t);
      }
      unsigned long long nd = static_cast<unsigned long long>(kNoRoot) << 32;
      if (src >= 0) {
        nd = static_cast<unsigned long long>(static_cast<uint32_t>(owp(p, kRoot)[s0 + src]))
                 << 32 |
             static_cast<uint32_t>(owp(p, kW)[s0 + src]);
      }
      p.node[slot] = nd;
    }
    sync(kNodes);
    bool any = false;
    for (int b = 0; b < p.B; ++b) any |= next[b] != kSettled;
    if (!any) break;
    if (pass >= max_passes) {  // unsettled: the pixels stand, ok does not
      if (blockIdx.x == 0 && tid == 0) *p.ok = 0;
      break;
    }
    // Wyllie rounds over the INDEX ops (the images' lists as one, from
    // each image's first tile this pass took), in place, until none points
    // anywhere: a node follows up to kChase pointers a round, composing
    // with the nodes it meets; round r's flag is flags[r % 3], cleared a
    // round ahead
    for (int r = 0;; ++r) {
      if (blockIdx.x == 0 && tid == 0) p.flags[(r + 1) % 3] = 0;
      int act = 0;
      for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + tid; i < total;
           i += g.threads) {
        const int lo = list_image(p, i);
        if (from[lo] == kSettled) continue;
        const int64_t slot = owp(p, kList)[p.starts[lo] + (i - iwp(p, kIdxOff)[lo])];
        if (slot < p.starts[lo] + static_cast<int64_t>(from[lo]) * kTile) continue;
        const unsigned long long nd = p.node[slot];
        const uint32_t w0 = static_cast<uint32_t>(nd >> 32);
        if (w0 == kNoRoot) continue;
        uint32_t w = static_cast<uint32_t>(nd), k_mask = root_mask(w0), par = w0 & ~kAlphaOnly;
        bool done = false;
        for (int hop = 0; hop < kChase; ++hop) {
          const unsigned long long pn =
              *reinterpret_cast<volatile unsigned long long*>(p.node + par);
          const uint32_t pw0 = static_cast<uint32_t>(pn >> 32);
          w = sel(k_mask, __vadd4(w, static_cast<uint32_t>(pn)), w);
          if (pw0 == kNoRoot) {
            done = true;
            break;
          }
          k_mask &= root_mask(pw0);
          par = pw0 & ~kAlphaOnly;
        }
        const uint32_t nw0 = done ? kNoRoot : par | (k_mask == kFull ? 0u : kAlphaOnly);
        p.node[slot] = static_cast<unsigned long long>(nw0) << 32 | w;
        act |= !done;
      }
      if (__syncthreads_or(act) && tid == 0) p.flags[r % 3] = 1;
      sync(kWyllie);
      if (!*reinterpret_cast<volatile int32_t*>(p.flags + r % 3)) break;
    }
  }

  // expansion: each op's pixel over its run, then the fill
  for_tiles(p, nullptr, [&](int b, int t, int32_t k0, int32_t k1) {
    const int64_t s0 = p.starts[b];
    uint32_t* out = p.out + static_cast<int64_t>(b) * p.npx;
    for (int32_t k = k0 + tid; k < k1; k += kThreads) {
      const int64_t slot = s0 + k;
      const uint8_t m = p.meta[slot];
      const int n = (m & 0x80) ? 1 : (m & 63) + 1;
      const int64_t o0 = owp(p, kPixOff)[slot];
      const uint32_t word = rgba_word(static_cast<uint32_t>(owp(p, kPx)[slot]));
      for (int64_t o = o0; o < o0 + n && o < p.npx; ++o) out[o] = word;
    }
  });
  for (int b = 0; b < p.B; ++b) {
    const int32_t nops = iwp(p, kImgOps)[b];
    const uint32_t fill =
        rgba_word(nops > 0 ? static_cast<uint32_t>(owp(p, kPx)[p.starts[b] + nops - 1]) : kPx0);
    uint32_t* out = p.out + static_cast<int64_t>(b) * p.npx;
    for (int64_t o = iwp(p, kImgPix)[b] + blockIdx.x * static_cast<int64_t>(kThreads) + tid;
         o < p.npx; o += g.threads) {
      out[o] = fill;
    }
  }
  if (p.stamps != nullptr) sync(kExpand);
}

}  // namespace

// ------------------------------------------------------------ C entry points

// stream u8 [cap] (the op streams, each with its padding, and 16 zero
// bytes); starts, ends, raw_ends int32 [B]; out u32 [B, npx]; ok int32 [1]
// (1 on entry); rounds int32 [B].  Scratch, nothing to fill: chunk words
// int32 [14, B * F], gpos int32 [B * F, 8], maps int32 [6, B * F], image
// words int32 [6, B], flags int32 [3], op words int32 [7, cap], meta u8
// [cap], node u64 [cap], tbl and carry int32 [B * tpi, 64] each, tpi =
// ceil(F * chunk_bytes / 2048).  stamps int64 [n_stamps, 2] or null: the
// phases' ends on the card's clock (for tools/torch_spec_stages.py).  One
// cooperative launch.
extern "C" int zpix_qoi_spec(const void* s, const void* starts, const void* ends,
                             const void* raw_ends, void* out, void* ok, void* rounds, void* cw,
                             void* gpos, void* el, void* iw, void* flags, void* ow, void* meta,
                             void* node, void* tbl, void* carry, void* stamps, int n_stamps,
                             int batch, int F, int cb, int ops_cap, int tpi, int64_t cap,
                             int64_t npx, void* stream) {
  const zpix::TimedEntry timed(stream);
  if (F < 1 || cb < 1 || ops_cap < 1 || tpi < 1 || cap >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  Qoi p{};
  p.s = static_cast<const uint8_t*>(s);
  p.starts = static_cast<const int32_t*>(starts);
  p.ends = static_cast<const int32_t*>(ends);
  p.raw_ends = static_cast<const int32_t*>(raw_ends);
  p.out = static_cast<uint32_t*>(out);
  p.ok = static_cast<int32_t*>(ok);
  p.rounds = static_cast<int32_t*>(rounds);
  p.cw = static_cast<int32_t*>(cw);
  p.gpos = static_cast<int32_t*>(gpos);
  p.el = static_cast<int32_t*>(el);
  p.iw = static_cast<int32_t*>(iw);
  p.flags = static_cast<int32_t*>(flags);
  p.ow = static_cast<int32_t*>(ow);
  p.meta = static_cast<uint8_t*>(meta);
  p.node = static_cast<unsigned long long*>(node);
  p.tbl = static_cast<int32_t*>(tbl);
  p.carry = static_cast<int32_t*>(carry);
  p.stamps = static_cast<int64_t*>(stamps);
  p.n_stamps = n_stamps;
  p.B = batch;
  p.F = F;
  p.cb = cb;
  p.ops_cap = ops_cap;
  p.tpi = tpi;
  p.L = static_cast<int64_t>(batch) * F;
  p.cap = cap;
  p.npx = npx;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) {
    return static_cast<int>(e);
  }
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qoi_spec_kernel,
                                                                    kThreads, 0)) {
    return static_cast<int>(e);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  void* args[] = {&p};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(qoi_spec_kernel),
                                  dim3(sms * per_sm), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream)));
}
