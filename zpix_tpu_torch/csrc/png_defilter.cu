// K15: PNG defilter -- filtered rows and their filter bytes -> the decoded
// scanline bytes.
//
// Replaces zpix_tpu/ops/defilter.py::defilter_jnp (:35), on any input of
// its shapes: raw [B, H, Wb] u8 (the row bytes, filter byte stripped),
// ftypes [B, H] u8, bpp in {1, 2, 3, 4, 6, 8} (the bytes a pixel, 1 for
// sub-byte depths) -> out [B, H, Wb] u8.  Per row, mod 256, with
// out-of-image neighbours 0, on decoded bytes:
//     0 None     x = raw
//     1 Sub      x = raw + left
//     2 Up       x = raw + up
//     3 Average  x = raw + ((left + up) >> 1)            (no wrap in the sum)
//     4 Paeth    x = raw + paeth(left, up, up-left)      (pa <= pb && pa <= pc
//                                                         -> left, pb <= pc -> up,
//                                                         else up-left)
// "left" is the byte bpp back.  A type above 4 predicts 0, as the JAX
// graph's where chain does; the decoder raises on such a type itself, and
// ``bad`` (when not null) is set to 1 where a row carries one, so that a
// decoder whose filter bytes exist only on the card reads one flag.
//
// Bound on the H100: the dependence.  Pixel (r, p) needs (r, p - 1),
// (r - 1, p) and (r - 1, p - 1), so an image is a wavefront of H + W - 1
// dependent steps; the bytes (rows in and out once) take a few hundredths
// of a millisecond.  The old design (a block an image, a thread a
// row, a __syncthreads() and 4 x bpp scattered byte accesses a step) took
// 7.53 ms a call on the bench batch, 3.7 us a wavefront step.
//
// This design carries the wavefront in registers.  A warp holds a band of
// 32 rows, lane r row 32 * band + r; at step s lane r decodes pixel s - r.
// The pixel above is the one lane r - 1 decoded at step s - 1 (one
// __shfl_up_sync a word), the up-left pixel the one above a step earlier,
// the left pixel the lane's own last output; the bpp bytes of a pixel are
// independent chains side by side.  A step is one pixel, so a band runs
// 32 pixels behind the band above (an earlier form of this kernel stepped
// 4 pixels at a time to keep its loads word-aligned, and its bands ran 128
// pixels apart).  Lane 0 takes the row above from the band above through
// a ring of pixels, each word tagged with its pixel's number in one 64-bit
// store, so that no fence is taken: in shared memory between the warps of
// a block (kWarps warps, one band each), in global memory between the
// blocks of an image, which take (image, part) tickets so that the part
// above is always held by a block already running.  No barrier is taken
// per step.  Each lane's raw row streams through a queue in shared memory
// filled by cp.async, a word at a time, a dozen or more steps ahead of its
// use (the rows are strided views of the stream and start at any byte; a
// pixel's bytes are picked from two or three words with byte_perm); its
// outputs gather in a register and leave as aligned words, bytes only at a
// row's head and tail.
//
// No block waits on a block with a later ticket: the ring between blocks
// holds a whole row, so the band above never waits for room in it, and a
// grid larger than the card holds at once drains in ticket order.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// A wait that outlasts this many polls (seconds; a valid input's waits end
// within microseconds) aborts the kernel with a launch failure rather than
// hang the card.
constexpr unsigned kSpinLimit = 1u << 24;

__device__ __forceinline__ void spin_guard(unsigned& polls) {
  if (++polls > kSpinLimit) __trap();
}

constexpr int kWarps = 4;   // bands a block
constexpr int kRing = 32;   // pixels a ring in shared memory holds
constexpr int kSlots = 4;     // ring slots loaded ahead, raw words fetched a batch (steps)

// A ring slot holds a word of a pixel and its sequence number (pixel + 1)
// in one 64-bit word, written and read whole (no fence): a reader that
// sees the number sees the word.  The reader loads each slot kSlots steps
// ahead of its use and polls again only when a number it got was not yet
// the one it needs, so that a ring in global memory costs no L2 round trip
// a step.  Between the warps of a block the ring (kRing pixels, in shared
// memory) has a read count, which the reader publishes only after its
// branch on the numbers it read (which waits for the loads), so the writer
// never overwrites a slot still unread.  Between blocks the ring is a whole
// row in global memory (mask all ones): written once, it needs no count.
struct Port {
  unsigned long long* slots;  // slot j of pixel g at slots + (g & mask) * 2 + j
  unsigned* count;            // pixels of a shared ring read so far
  int mask;                   // kRing - 1, or all ones for a whole row

  // generic addresses at GPU scope, so that one code path (no branch on
  // the space) serves the rings in shared and in global memory
  __device__ __forceinline__ unsigned long long load(int g, int j) const {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(slots + (g & mask) * 2 + j));
    return v;
  }
  __device__ __forceinline__ void store(int g, int j, unsigned long long v) const {
    asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(slots + (g & mask) * 2 + j), "l"(v));
  }
  __device__ __forceinline__ unsigned read_count() const {
    unsigned v;
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(count));
    return v;
  }
  __device__ __forceinline__ void set_count(unsigned v) const {
    asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(count), "r"(v));
  }
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

template <int NW>
__device__ __forceinline__ int byte_of(const uint32_t (&w)[NW], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xff;
}

// The filter type is a row's, so it differs from lane to lane: the
// predictor is computed without a branch, the type picking by masks.
struct TypeMasks {
  int sub, up, avg, paeth;
};

__device__ __forceinline__ TypeMasks type_masks(int ftype) {
  return {-(ftype == 1), -(ftype == 2), -(ftype == 3), -(ftype == 4)};
}

__device__ __forceinline__ int predict(const TypeMasks& m, int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  const int paeth = pa <= min(pb, pc) ? a : (pb <= pc ? b : c);
  return (a & m.sub) | (b & m.up) | (((a + b) >> 1) & m.avg) | (paeth & m.paeth);
}

// rows: [B, parts, W, 2], part p's last row by pixel, for the part below
template <int BPP>
__global__ void __launch_bounds__(kWarps * 32) defilter_kernel(
    const uint8_t* __restrict__ raw, int64_t raw_img, int64_t raw_row,
    const uint8_t* __restrict__ ft, int64_t ft_img, int64_t ft_row, uint8_t* out, int batch,
    int H, int Wb, int parts, int* bad, unsigned* tickets, unsigned long long* rows) {
  constexpr int NW = (BPP + 3) / 4;         // words a pixel
  constexpr int kRaw = BPP <= 2 ? 2 : 3;    // aligned raw words a pixel can touch
  constexpr int kQ = BPP <= 4 ? 16 : 32;    // raw words a lane's queue holds: two batches
  constexpr int kFetch = (kSlots * BPP + 3) / 4 + 1;  // raw words a batch, at most
  __shared__ unsigned long long ring[kWarps][kRing][2];  // warp w's last row, by pixel
  __shared__ uint32_t queue[kWarps][kQ][32];            // raw words, [warp][slot][lane]
  __shared__ unsigned cons[kWarps], ticket;             // pixels of ring w read by w + 1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kRing * 2; i += blockDim.x) {
    (&ring[0][0][0])[i] = 0;
  }
  if (threadIdx.x < kWarps) cons[threadIdx.x] = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(tickets, 1u);
  __syncthreads();
  const int64_t b = ticket % batch;
  const int part = ticket / batch;
  const int band = part * nw + warp;
  const int nbands = (H + 31) >> 5;
  if (band >= nbands) return;  // only in an image's last part; no warp waits on it
  const int W = Wb / BPP;
  const bool above = band > 0, below = band + 1 < nbands;
  const bool above_global = warp == 0, below_global = warp == nw - 1;
  const int64_t gi_above = b * parts + (part > 0 ? part - 1 : 0), gi_me = b * parts + part;

  const int R = band * 32 + lane;
  const bool row_ok = R < H;
  int ftype = 0;
  if (row_ok) {
    ftype = ft[b * ft_img + R * ft_row];
    if (ftype > 4 && bad != nullptr) *bad = 1;
  }
  const TypeMasks masks = type_masks(ftype);
  const uint8_t* rrow = raw + b * raw_img + R * raw_row;
  const int ai = static_cast<int>(reinterpret_cast<uintptr_t>(rrow) & 3);
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(rrow - ai);  // aligned
  const int nq = row_ok ? (Wb + ai + 3) >> 2 : 0;  // aligned words holding row bytes
  uint8_t* orow = out + (b * H + R) * static_cast<int64_t>(Wb);
  const int h = static_cast<int>((4 - (reinterpret_cast<uintptr_t>(orow) & 3)) & 3);

  // The raw queue: word q of the row in queue[warp][q % kQ][lane].  Every
  // kSlots steps each lane fetches (cp.async, one commit) the words of its
  // pixels kSlots to 2 kSlots - 1 steps ahead, and waits for the batch
  // fetched kSlots steps before, which holds this batch's pixels.
  uint32_t* myq = &queue[warp][0][lane];
  int fetched = 0;  // words fetched so far
  const auto fetch = [&](int s_end) {  // the words of this lane's pixels before step s_end
    const int p_end = s_end - lane < W ? s_end - lane : W;
    int need = p_end > 0 ? (ai + p_end * BPP + 3) >> 2 : 0;
    need = need < nq ? need : nq;
#pragma unroll
    for (int k = 0; k < kFetch; ++k) {
      if (fetched < need) {
        cp_async4(myq + (fetched % kQ) * 32, rw + fetched);
        ++fetched;
      }
    }
    cp_async_commit();
  };
  fetch(kSlots);

  uint32_t outp[NW], upprev[NW];  // this lane's last pixel; the pixel above it
#pragma unroll
  for (int k = 0; k < NW; ++k) outp[k] = upprev[k] = 0;
  int left[BPP];
#pragma unroll
  for (int c = 0; c < BPP; ++c) left[c] = 0;
  unsigned long long oacc = 0;  // output bytes from stream position obase not yet stored
  int nb = 0;
  int64_t obase = h;

  const int wa = warp > 0 ? warp - 1 : 0;
  const Port from = above_global ? Port{rows + gi_above * W * 2, nullptr, -1}
                                 : Port{&ring[wa][0][0], &cons[wa], kRing - 1};
  const Port to = below_global ? Port{rows + gi_me * W * 2, nullptr, -1}
                               : Port{&ring[warp][0][0], &cons[warp], kRing - 1};
  unsigned cons_seen = 0;
  unsigned long long pre[kSlots][NW];  // ring slots of pixel s in pre[s % kSlots], loaded ahead
#pragma unroll
  for (int u = 0; u < kSlots; ++u) {
#pragma unroll
    for (int k = 0; k < NW; ++k) pre[u][k] = above && u < W ? from.load(u, k) : 0;
  }

  // appends the output bytes of ``v`` (n of them, in order) at obase + nb,
  // storing the aligned word that fills up
  const auto append = [&](uint32_t v, int n) {
    oacc |= static_cast<unsigned long long>(v) << (8 * nb);
    nb += n;
    const bool full = nb >= 4;  // lanes differ: predicated, not branched
    if (full) *reinterpret_cast<uint32_t*>(orow + obase) = static_cast<uint32_t>(oacc);
    oacc = full ? oacc >> 32 : oacc;
    nb -= full ? 4 : 0;
    obase += full ? 4 : 0;
  };

  // One step.  ``interior``: every lane's pixel lies in kHead .. W - 2 and
  // its row in the image (no head, tail or edge check; most steps).
  constexpr int kHead = (3 + BPP - 1) / BPP;  // pixels that may hold head bytes
  const auto step = [&](const int s, const int u, auto interior) {
    constexpr bool kInterior = decltype(interior)::value;
    const int p = s - lane;
    const bool active = kInterior || (row_ok && p >= 0 && p < W);
    if (u == 0) {  // the next batch out, this one in
      fetch(s + 2 * kSlots);
      cp_async_wait<1>();
    }
    uint32_t up[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) up[k] = __shfl_up_sync(0xffffffffu, outp[k], 1);
    const bool taking = above && (kInterior || s < W);
    if (taking) {  // lane 0: pixel s of the band above's last row (the warp waits)
      bool ready = true;  // the slots loaded kSlots steps ago already hold pixel s
#pragma unroll
      for (int k = 0; k < NW; ++k) ready &= static_cast<unsigned>(pre[u][k] >> 32) == s + 1;
      for (unsigned polls = 0; !ready; spin_guard(polls)) {
        ready = true;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          pre[u][k] = from.load(s, k);
          ready &= static_cast<unsigned>(pre[u][k] >> 32) == s + 1;
        }
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) up[k] = lane == 0 ? static_cast<uint32_t>(pre[u][k]) : up[k];
      if (s + kSlots < W) {  // pixel s + kSlots into the slots just used
#pragma unroll
        for (int k = 0; k < NW; ++k) pre[u][k] = from.load(s + kSlots, k);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) up[k] = lane == 0 ? 0 : up[k];
    }

    const int bp = ai + (p > 0 ? p : 0) * BPP;  // the pixel's first byte in the aligned words
    const int wi = bp >> 2;
    if (active) {
      uint32_t q[kRaw], rp[NW], px[NW];
#pragma unroll
      for (int k = 0; k < kRaw; ++k) q[k] = myq[((wi + k) % kQ) * 32];
      const unsigned sel = 0x3210u + 0x1111u * (bp & 3);
      rp[0] = __byte_perm(q[0], q[1], sel);
      if (NW > 1) rp[NW - 1] = __byte_perm(q[1], q[kRaw - 1], sel);
#pragma unroll
      for (int k = 0; k < NW; ++k) px[k] = 0;
#pragma unroll
      for (int c = 0; c < BPP; ++c) {
        const int y =
            (byte_of(rp, c) + predict(masks, left[c], byte_of(up, c), byte_of(upprev, c))) & 0xff;
        left[c] = y;
        px[c >> 2] |= static_cast<uint32_t>(y) << (8 * (c & 3));
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) outp[k] = px[k];

      // the pixel's bytes to the output row
      if (kInterior) {
        append(px[0], BPP < 4 ? BPP : 4);
        if (BPP > 4) append(px[NW - 1], BPP - 4);
      } else {
        const int64_t op = static_cast<int64_t>(p) * BPP;
#pragma unroll
        for (int c = 0; c < BPP; ++c) {
          const uint32_t v = (px[c >> 2] >> (8 * (c & 3))) & 0xff;
          if (op + c < h) {
            orow[op + c] = static_cast<uint8_t>(v);  // the head: before the first word
          } else {
            append(v, 1);
          }
        }
        if (p == W - 1) {  // the tail: the bytes after the last word
          for (int c = 0; c < nb; ++c) orow[obase + c] = static_cast<uint8_t>(oacc >> (8 * c));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) upprev[k] = up[k];

    // lane 0 has used pixel s (its branch on the numbers waited for the
    // loads): the slots of a shared ring may be written again (told every
    // kSlots pixels)
    if (taking && !above_global && lane == 0 && (u == kSlots - 1 || s == W - 1)) {
      from.set_count(s + 1);
    }

    const int pg = s - 31;  // lane 31's pixel: publish it to the band below
    if (below && (kInterior || (pg >= 0 && pg < W))) {
      const unsigned seq = pg + 1;
      // room in a shared ring for this step's pixel and the rest of the
      // batch's, checked once a batch (a whole row always has room)
      if (!below_global && (u == 0 || !kInterior)) {
        for (unsigned polls = 0; seq + kSlots - 1 > cons_seen + kRing; spin_guard(polls)) {
          cons_seen = to.read_count();
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          to.store(pg, k, static_cast<unsigned long long>(seq) << 32 | outp[k]);
        }
      }
    }
  };
  const bool full_band = band * 32 + 31 < H;
  const int last = W + 30;  // the step of lane 31's last pixel
  for (int s0 = 0; s0 <= last; s0 += kSlots) {
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int s = s0 + u;
      if (s > last) break;
      if (full_band && s >= 31 + kHead && s + 2 <= W) {
        step(s, u, std::true_type{});
      } else {
        step(s, u, std::false_type{});
      }
    }
  }
  cp_async_wait<0>();
}

// Scratch words (32-bit) of a call: a ticket (and a word of padding), and
// for each (image, part) its last row, two 64-bit slots a pixel;
// ops/defilter.py's scratch_words is the same count.
int64_t scratch_words(int batch, int H, int W) {
  const int nbands = (H + 31) / 32;
  const int wpb = nbands < kWarps ? nbands : kWarps;
  const int64_t parts = (nbands + wpb - 1) / wpb;
  return 2 + static_cast<int64_t>(batch) * parts * W * 4;
}

}  // namespace

// raw: row r of image b at raw + b * raw_img + r * raw_row (Wb bytes);
// ft: filter byte of (b, r) at ft + b * ft_img + r * ft_row; out u8
// [B, H, Wb] contiguous; bad int32 [1] or null; scratch 32-bit words
// [scratch_words(batch, H, Wb / bpp)], 8-byte aligned.
extern "C" int zpix_png_defilter(const void* raw, int64_t raw_img, int64_t raw_row,
                                 const void* ft, int64_t ft_img, int64_t ft_row, void* out,
                                 int batch, int H, int Wb, int bpp, void* bad, void* scratch,
                                 void* stream) {
  if (batch <= 0 || H <= 0 || Wb <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbands = (H + 31) / 32;
  const int wpb = nbands < kWarps ? nbands : kWarps;
  const int parts = (nbands + wpb - 1) / wpb;
  const int64_t words = scratch_words(batch, H, bpp > 0 ? Wb / bpp : 0);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 4 * words, st);
  if (err != cudaSuccess) return err;
  auto* w = static_cast<unsigned*>(scratch);
  auto* rows = reinterpret_cast<unsigned long long*>(w + 2);
  const auto* r = static_cast<const uint8_t*>(raw);
  const auto* f = static_cast<const uint8_t*>(ft);
  auto* o = static_cast<uint8_t*>(out);
  auto* bd = static_cast<int*>(bad);
  const auto go = [&](auto bpp_const) {
    defilter_kernel<decltype(bpp_const)::value>
        <<<static_cast<unsigned>(batch) * parts, wpb * 32, 0, st>>>(
            r, raw_img, raw_row, f, ft_img, ft_row, o, batch, H, Wb, parts, bd, w, rows);
    return cudaGetLastError();
  };
  switch (bpp) {
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    case 3: return go(std::integral_constant<int, 3>{});
    case 4: return go(std::integral_constant<int, 4>{});
    case 6: return go(std::integral_constant<int, 6>{});
    case 8: return go(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}
