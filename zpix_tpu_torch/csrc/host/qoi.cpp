// Host C++ for the port's QOI slice: the serial decode and encode, the
// record scan behind the sorted expansion (K13) and the lane scans and
// fills behind the lane expansion (K12).
//
// A whole copy, with the same C ABI, of zpix_tpu/runtime/qoi.cpp (the port
// builds its own copy and loads nothing of zpix_tpu):
//   zpix_qoi_decode        (:31)     zpix_qoi_lane_scan   (:207)
//   zpix_qoi_record_scan   (:114)    zpix_qoi_lane_fill   (:312)
//   zpix_qoi_encode        (:558)    zpix_qoi_lane_fill4  (:439)
// Op-stream semantics mirror the reference's src/qoi/decoder.zig:20-147 and
// encoder.zig:29-151: the rolling 64-entry index keyed (3r+5g+7b+11a)&63,
// run/index/diff/luma ops, 62-run cap, 8-byte 0...01 padding.  The op
// stream is serial by construction; this scan runs at memory speed on the
// host while batches parallelize across images.  The comments below keep
// the reference's measurements, which were taken on its TPU host.
//
// Built by zpix_tpu_torch/runtime/host.py with
//   g++ -O3 -std=c++17 -fPIC -shared -lpthread

#include <cstdint>
#include <cstring>

namespace {

struct Px {
  uint8_t r, g, b, a;
};

inline int index_pos(Px p) {
  return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) & 63;
}

}  // namespace

extern "C" {

// Decode the op stream after the 14-byte header into out[pixel_count*4].
// Returns 0 on success.
int zpix_qoi_decode(const uint8_t* data, int64_t len, int64_t pixel_count,
                    uint8_t* out) {
  constexpr int64_t kHeader = 14, kPadding = 8;
  if (len < kHeader + kPadding) return 1;
  int64_t p = kHeader;
  int64_t chunks_len = len - kPadding;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px{0, 0, 0, 255};
  int64_t run = 0;

  for (int64_t i = 0; i < pixel_count; i++) {
    if (run > 0) {
      run--;
    } else if (p < chunks_len) {
      uint8_t b1 = data[p++];
      if (b1 == 0xFE) {  // OP_RGB
        if (p + 3 > len) return 2;
        px.r = data[p];
        px.g = data[p + 1];
        px.b = data[p + 2];
        p += 3;
      } else if (b1 == 0xFF) {  // OP_RGBA
        if (p + 4 > len) return 2;
        px.r = data[p];
        px.g = data[p + 1];
        px.b = data[p + 2];
        px.a = data[p + 3];
        p += 4;
      } else {
        switch (b1 & 0xC0) {
          case 0x00:  // OP_INDEX
            px = index[b1 & 0x3F];
            break;
          case 0x40:  // OP_DIFF
            px.r = uint8_t(px.r + ((b1 >> 4) & 3) - 2);
            px.g = uint8_t(px.g + ((b1 >> 2) & 3) - 2);
            px.b = uint8_t(px.b + (b1 & 3) - 2);
            break;
          case 0x80: {  // OP_LUMA
            if (p >= len) return 2;
            uint8_t b2 = data[p++];
            int dg = int(b1 & 0x3F) - 32;
            px.r = uint8_t(px.r + dg + ((b2 >> 4) & 0xF) - 8);
            px.g = uint8_t(px.g + dg);
            px.b = uint8_t(px.b + dg + (b2 & 0xF) - 8);
            break;
          }
          default:  // OP_RUN
            run = b1 & 0x3F;
        }
      }
      index[index_pos(px)] = px;
    }
    out[i * 4 + 0] = px.r;
    out[i * 4 + 1] = px.g;
    out[i * 4 + 2] = px.b;
    out[i * 4 + 3] = px.a;
  }
  return 0;
}

// Host INDEX pass for the QOI host-index/device-expansion split (round 4).
//
// The speculative on-chip fixed point provably converges too slowly at
// production scale: a rolling-index slot written once early in the stream
// must propagate through every downstream chunk lane one round at a time
// (measured 2026-08-21: 16x1024^2 at chunk=512 is still changing after 64
// rounds of ~0.8 s each).  Like the restart-free JPEG split
// (zpix_baseline_index_scan), the serial byte walk belongs on the host
// scalar core: one pass over the op stream emits per-op (packed RGBA,
// emitted-pixel-count) records — O(ops) work and O(ops) bytes shipped,
// where ops <= pixels (QOI's run/index/diff ops cover up to 62 px in 1
// byte) — and the device expands records into the O(pixels) raster.
// Semantics per the reference's src/qoi/decoder.zig:20-130: run counts are
// (b1&63)+1, the index updates after EVERY op, and a stream that exhausts
// before pixel_count leaves the tail replicating the final px
// (decoder.zig:67-69), which the device applies as a fill color.
//
// cols_out[i] = R<<24|G<<16|B<<8|A (the device assembly's packed layout),
// cnts_out[i] in [1,62].  Records past pixel_count are clipped.  Returns
// 0 ok / 1 short stream / 2 truncated op / 3 rcap overflow; *n_out =
// records written, *fill_out = final decoder px.
int zpix_qoi_record_scan(const uint8_t* __restrict data, int64_t len,
                         int64_t pixel_count, uint32_t* __restrict cols_out,
                         uint8_t* __restrict cnts_out, int64_t rcap,
                         int64_t* n_out, uint32_t* fill_out) {
  constexpr int64_t kHeader = 14, kPadding = 8;
  if (len < kHeader + kPadding) return 1;
  int64_t p = kHeader;
  const int64_t chunks_len = len - kPadding;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px{0, 0, 0, 255};
  int64_t n = 0;
  int64_t total = 0;

  // The op stream carries >= kPadding (8) readable bytes past chunks_len,
  // so inside the stream body (p <= chunks_len - 5, the longest op) all
  // per-op bounds checks hoist to one predictable branch; the tail ops
  // keep the exact checks.
  const int64_t fast_end = chunks_len - 5;
  while (total < pixel_count && p < chunks_len) {
    uint8_t b1 = data[p++];
    int64_t cnt = 1;
    if (__builtin_expect(b1 == 0xFE, 0)) {  // OP_RGB
      if (p > fast_end && p + 3 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      p += 3;
    } else if (__builtin_expect(b1 == 0xFF, 0)) {  // OP_RGBA
      if (p > fast_end && p + 4 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      px.a = data[p + 3];
      p += 4;
    } else {
      switch (b1 & 0xC0) {
        case 0x00:  // OP_INDEX
          px = index[b1 & 0x3F];
          break;
        case 0x40:  // OP_DIFF
          px.r = uint8_t(px.r + ((b1 >> 4) & 3) - 2);
          px.g = uint8_t(px.g + ((b1 >> 2) & 3) - 2);
          px.b = uint8_t(px.b + (b1 & 3) - 2);
          break;
        case 0x80: {  // OP_LUMA
          if (p > fast_end && p >= len) return 2;
          uint8_t b2 = data[p++];
          int dg = int(b1 & 0x3F) - 32;
          px.r = uint8_t(px.r + dg + ((b2 >> 4) & 0xF) - 8);
          px.g = uint8_t(px.g + dg);
          px.b = uint8_t(px.b + dg + (b2 & 0xF) - 8);
          break;
        }
        default:  // OP_RUN
          cnt = (b1 & 0x3F) + 1;
      }
    }
    index[index_pos(px)] = px;
    if (__builtin_expect(total + cnt > pixel_count, 0))
      cnt = pixel_count - total;
    if (__builtin_expect(n >= rcap, 0)) return 3;
    cols_out[n] = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                  (uint32_t(px.b) << 8) | uint32_t(px.a);
    cnts_out[n] = uint8_t(cnt);
    n++;
    total += cnt;
  }
  *n_out = n;
  *fill_out = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
              (uint32_t(px.b) << 8) | uint32_t(px.a);
  return 0;
}

// Lane-aligned variant of the record scan for the TPU expansion graph.
//
// jnp.searchsorted run-expansion is gather-bound on TPU (measured
// 8.2 s/batch at 16x1024² — XLA lowers the vmapped binary search to 20
// full-raster gathers).  The gather-free form mirrors the on-chip
// Huffman compare-sum: cut the raster into P-pixel lanes and emit each
// record as per-lane entries (color, local start, local end), splitting
// records at lane boundaries; the device then computes every lane's P
// pixels as sum_r color[r] * (start[r] <= p < end[r]) — pure VPU
// compare/select over an [R, lanes] layout (lanes minor), no gather, no
// scatter.  The decode walk is sequential, so entries are emitted in
// lane order and the per-lane arrays assemble without sorting.
//
// Entry count m <= ops + lanes (each lane boundary splits at most one
// record) and the stream-exhausted tail is emitted as ordinary fill
// entries, so the device graph needs no special fill handling.
// lane_cnt must be zero-initialized by the caller ([n_lanes] int32).
// Returns 0 ok / 1 short / 2 truncated / 3 ecap overflow / 4 P or
// n_lanes mismatch.
//
// In the port no decoder calls this scan: zpix_qoi_lane_fill and
// zpix_qoi_lane_fill4 write the same entries straight into the padded
// lane arrays.  It stays as their unfused form, which the tests check the
// fills against.
int zpix_qoi_lane_scan(const uint8_t* __restrict data, int64_t len,
                       int64_t pixel_count, int32_t P,
                       uint32_t* __restrict cols_out,
                       int16_t* __restrict s_out, int16_t* __restrict e_out,
                       int64_t ecap, int32_t* __restrict lane_cnt,
                       int64_t n_lanes, int64_t* m_out,
                       uint32_t* fill_out) {
  constexpr int64_t kHeader = 14, kPadding = 8;
  if (len < kHeader + kPadding) return 1;
  if (P <= 0 || P > 32767 || n_lanes * int64_t(P) < pixel_count) return 4;
  int64_t p = kHeader;
  const int64_t chunks_len = len - kPadding;
  const int64_t fast_end = chunks_len - 5;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px{0, 0, 0, 255};
  int64_t m = 0;
  int64_t total = 0;

  auto emit_span = [&](uint32_t col, int64_t start, int64_t end) -> bool {
    for (int64_t lane = start / P; lane * P < end; lane++) {
      if (m >= ecap) return false;
      int64_t ls = start - lane * P;
      if (ls < 0) ls = 0;
      int64_t le = end - lane * P;
      if (le > P) le = P;
      cols_out[m] = col;
      s_out[m] = int16_t(ls);
      e_out[m] = int16_t(le);
      lane_cnt[lane]++;
      m++;
    }
    return true;
  };

  while (total < pixel_count && p < chunks_len) {
    uint8_t b1 = data[p++];
    int64_t cnt = 1;
    if (__builtin_expect(b1 == 0xFE, 0)) {  // OP_RGB
      if (p > fast_end && p + 3 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      p += 3;
    } else if (__builtin_expect(b1 == 0xFF, 0)) {  // OP_RGBA
      if (p > fast_end && p + 4 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      px.a = data[p + 3];
      p += 4;
    } else {
      switch (b1 & 0xC0) {
        case 0x00:  // OP_INDEX
          px = index[b1 & 0x3F];
          break;
        case 0x40:  // OP_DIFF
          px.r = uint8_t(px.r + ((b1 >> 4) & 3) - 2);
          px.g = uint8_t(px.g + ((b1 >> 2) & 3) - 2);
          px.b = uint8_t(px.b + (b1 & 3) - 2);
          break;
        case 0x80: {  // OP_LUMA
          if (p > fast_end && p >= len) return 2;
          uint8_t b2 = data[p++];
          int dg = int(b1 & 0x3F) - 32;
          px.r = uint8_t(px.r + dg + ((b2 >> 4) & 0xF) - 8);
          px.g = uint8_t(px.g + dg);
          px.b = uint8_t(px.b + dg + (b2 & 0xF) - 8);
          break;
        }
        default:  // OP_RUN
          cnt = (b1 & 0x3F) + 1;
      }
    }
    index[index_pos(px)] = px;
    if (__builtin_expect(total + cnt > pixel_count, 0))
      cnt = pixel_count - total;
    uint32_t col = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                   (uint32_t(px.b) << 8) | uint32_t(px.a);
    if (!emit_span(col, total, total + cnt)) return 3;
    total += cnt;
  }
  uint32_t fill = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                  (uint32_t(px.b) << 8) | uint32_t(px.a);
  if (total < pixel_count) {  // stream-exhausted tail (decoder.zig:67-69)
    if (!emit_span(fill, total, pixel_count)) return 3;
    total = pixel_count;
  }
  *m_out = m;
  *fill_out = fill;
  return 0;
}

// One-pass variant of the lane scan that fills the padded per-lane
// arrays DIRECTLY (the numpy assembly of zpix_qoi_lane_scan's entry
// list cost ~900 ms/batch at 16x1024²: fancy-index scatters + 200 MB
// of zero-init).  Layout here is lane-major [n_lanes, R] — each lane's
// R slots are contiguous, so both entry writes and the empty-slot
// padding (s=1, e=0, cols untouched) stream sequentially; the device
// graph transposes once on-chip to its lanes-minor [R, Lt] form.
// Decode order visits lanes monotonically, so padding happens exactly
// when a lane is left behind.  If any lane needs more than R slots the
// scan keeps counting without writing and returns 3 with *need_r_out =
// the true max, so the caller can re-run with a bucketed R; rc=0 also
// sets *need_r_out (for layout reuse hints).
int zpix_qoi_lane_fill(const uint8_t* __restrict data, int64_t len,
                       int64_t pixel_count, int32_t P, int32_t R,
                       uint32_t* __restrict cols_out,
                       int16_t* __restrict s_out, int16_t* __restrict e_out,
                       int32_t* need_r_out, uint32_t* fill_out) {
  constexpr int64_t kHeader = 14, kPadding = 8;
  if (len < kHeader + kPadding) return 1;
  if (P <= 0 || P > 32767 || R <= 0) return 4;
  const int64_t n_lanes = (pixel_count + P - 1) / P;
  int64_t p = kHeader;
  const int64_t chunks_len = len - kPadding;
  const int64_t fast_end = chunks_len - 5;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px{0, 0, 0, 255};
  int64_t total = 0;
  int64_t cur_lane = 0;
  int32_t cur_cnt = 0;
  int32_t need_r = 0;
  bool overflow = false;

  auto pad_lane = [&](int64_t lane, int32_t from) {
    if (overflow) return;
    int16_t* sp = s_out + lane * R;
    int16_t* ep = e_out + lane * R;
    for (int32_t k = from; k < R; k++) {
      sp[k] = 1;
      ep[k] = 0;
    }
  };

  auto emit_span = [&](uint32_t col, int64_t start, int64_t end) {
    for (int64_t lane = start / P; lane * P < end; lane++) {
      if (lane != cur_lane) {
        pad_lane(cur_lane, cur_cnt);
        cur_lane = lane;
        cur_cnt = 0;
      }
      if (cur_cnt < R && !overflow) {
        int64_t base = lane * R + cur_cnt;
        int64_t ls = start - lane * P;
        if (ls < 0) ls = 0;
        int64_t le = end - lane * P;
        if (le > P) le = P;
        cols_out[base] = col;
        s_out[base] = int16_t(ls);
        e_out[base] = int16_t(le);
      } else {
        overflow = true;
      }
      cur_cnt++;
      if (cur_cnt > need_r) need_r = cur_cnt;
    }
  };

  while (total < pixel_count && p < chunks_len) {
    uint8_t b1 = data[p++];
    int64_t cnt = 1;
    if (__builtin_expect(b1 == 0xFE, 0)) {  // OP_RGB
      if (p > fast_end && p + 3 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      p += 3;
    } else if (__builtin_expect(b1 == 0xFF, 0)) {  // OP_RGBA
      if (p > fast_end && p + 4 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      px.a = data[p + 3];
      p += 4;
    } else {
      switch (b1 & 0xC0) {
        case 0x00:  // OP_INDEX
          px = index[b1 & 0x3F];
          break;
        case 0x40:  // OP_DIFF
          px.r = uint8_t(px.r + ((b1 >> 4) & 3) - 2);
          px.g = uint8_t(px.g + ((b1 >> 2) & 3) - 2);
          px.b = uint8_t(px.b + (b1 & 3) - 2);
          break;
        case 0x80: {  // OP_LUMA
          if (p > fast_end && p >= len) return 2;
          uint8_t b2 = data[p++];
          int dg = int(b1 & 0x3F) - 32;
          px.r = uint8_t(px.r + dg + ((b2 >> 4) & 0xF) - 8);
          px.g = uint8_t(px.g + dg);
          px.b = uint8_t(px.b + dg + (b2 & 0xF) - 8);
          break;
        }
        default:  // OP_RUN
          cnt = (b1 & 0x3F) + 1;
      }
    }
    index[index_pos(px)] = px;
    if (__builtin_expect(total + cnt > pixel_count, 0))
      cnt = pixel_count - total;
    uint32_t col = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                   (uint32_t(px.b) << 8) | uint32_t(px.a);
    emit_span(col, total, total + cnt);
    total += cnt;
  }
  uint32_t fill = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                  (uint32_t(px.b) << 8) | uint32_t(px.a);
  if (total < pixel_count) {  // stream-exhausted tail (decoder.zig:67-69)
    emit_span(fill, total, pixel_count);
    total = pixel_count;
  }
  pad_lane(cur_lane, cur_cnt);
  for (int64_t l = cur_lane + 1; l < n_lanes; l++) pad_lane(l, 0);
  *need_r_out = need_r;
  *fill_out = fill;
  return overflow ? 3 : 0;
}

// Packed-4-byte lane fill (round-5 upload trim): same walk as
// zpix_qoi_lane_fill, but each entry is (r, g, b, start) in ONE uint8
// granule — half the staged bytes of the wide (u32 col + i16 s + i16 e)
// form on QOI's worst-case ~1-entry-per-pixel content.  The end offsets
// are IMPLICIT: records tile every lane contiguously, so
// e[r] = s[r+1] and the lane's last real entry always ends at P; pad
// slots carry the sentinel s = P (p < P never reaches it).  Applies
// only when P <= 255 (start fits uint8) and every emitted color is
// OPAQUE (alpha folds into a device constant): a stream that touches
// alpha returns rc=5 and the caller falls back to the wide form.
// Returns 0 ok / 1 short / 2 truncated / 3 R overflow (need_r_out
// still reports the true max) / 4 bad P or R / 5 non-opaque.
int zpix_qoi_lane_fill4(const uint8_t* __restrict data, int64_t len,
                        int64_t pixel_count, int32_t P, int32_t R,
                        uint8_t* __restrict p4_out,
                        int32_t* need_r_out, uint32_t* fill_out) {
  constexpr int64_t kHeader = 14, kPadding = 8;
  if (len < kHeader + kPadding) return 1;
  if (P <= 0 || P > 255 || R <= 0) return 4;
  const int64_t n_lanes = (pixel_count + P - 1) / P;
  int64_t p = kHeader;
  const int64_t chunks_len = len - kPadding;
  const int64_t fast_end = chunks_len - 5;
  Px index[64];
  memset(index, 0, sizeof(index));
  Px px{0, 0, 0, 255};
  int64_t total = 0;
  int64_t cur_lane = 0;
  int32_t cur_cnt = 0;
  int32_t need_r = 0;
  bool overflow = false;
  bool alpha_seen = false;

  auto pad_lane = [&](int64_t lane, int32_t from) {
    if (overflow) return;
    uint8_t* lp = p4_out + lane * R * 4;
    for (int32_t k = from; k < R; k++) {
      lp[k * 4 + 0] = 0;
      lp[k * 4 + 1] = 0;
      lp[k * 4 + 2] = 0;
      lp[k * 4 + 3] = uint8_t(P);  // sentinel: mask never fires
    }
  };

  auto emit_span = [&](const Px& c, int64_t start, int64_t end) {
    if (c.a != 255) alpha_seen = true;
    for (int64_t lane = start / P; lane * P < end; lane++) {
      if (lane != cur_lane) {
        pad_lane(cur_lane, cur_cnt);
        cur_lane = lane;
        cur_cnt = 0;
      }
      if (cur_cnt < R && !overflow) {
        uint8_t* ep = p4_out + (lane * R + cur_cnt) * 4;
        int64_t ls = start - lane * P;
        if (ls < 0) ls = 0;
        ep[0] = c.r;
        ep[1] = c.g;
        ep[2] = c.b;
        ep[3] = uint8_t(ls);
      } else {
        overflow = true;
      }
      cur_cnt++;
      if (cur_cnt > need_r) need_r = cur_cnt;
    }
  };

  while (total < pixel_count && p < chunks_len) {
    uint8_t b1 = data[p++];
    int64_t cnt = 1;
    if (__builtin_expect(b1 == 0xFE, 0)) {  // OP_RGB
      if (p > fast_end && p + 3 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      p += 3;
    } else if (__builtin_expect(b1 == 0xFF, 0)) {  // OP_RGBA
      if (p > fast_end && p + 4 > len) return 2;
      px.r = data[p];
      px.g = data[p + 1];
      px.b = data[p + 2];
      px.a = data[p + 3];
      p += 4;
    } else {
      switch (b1 & 0xC0) {
        case 0x00:  // OP_INDEX
          px = index[b1 & 0x3F];
          break;
        case 0x40:  // OP_DIFF
          px.r = uint8_t(px.r + ((b1 >> 4) & 3) - 2);
          px.g = uint8_t(px.g + ((b1 >> 2) & 3) - 2);
          px.b = uint8_t(px.b + (b1 & 3) - 2);
          break;
        case 0x80: {  // OP_LUMA
          if (p > fast_end && p >= len) return 2;
          uint8_t b2 = data[p++];
          int dg = int(b1 & 0x3F) - 32;
          px.r = uint8_t(px.r + dg + ((b2 >> 4) & 0xF) - 8);
          px.g = uint8_t(px.g + dg);
          px.b = uint8_t(px.b + dg + (b2 & 0xF) - 8);
          break;
        }
        default:  // OP_RUN
          cnt = (b1 & 0x3F) + 1;
      }
    }
    index[index_pos(px)] = px;
    if (__builtin_expect(total + cnt > pixel_count, 0))
      cnt = pixel_count - total;
    emit_span(px, total, total + cnt);
    if (alpha_seen) return 5;
    total += cnt;
  }
  uint32_t fill = (uint32_t(px.r) << 24) | (uint32_t(px.g) << 16) |
                  (uint32_t(px.b) << 8) | uint32_t(px.a);
  if (total < pixel_count) {  // stream-exhausted tail (decoder.zig:67-69)
    emit_span(px, total, pixel_count);
    if (alpha_seen) return 5;
    total = pixel_count;
  }
  pad_lane(cur_lane, cur_cnt);
  for (int64_t l = cur_lane + 1; l < n_lanes; l++) pad_lane(l, 0);
  *need_r_out = need_r;
  *fill_out = fill;
  return overflow ? 3 : 0;
}

// Encode pixel_count pixels (channels 3 or 4) into out (caller-sized to
// pixel_count * (channels + 1) + 22).  Writes ops only (no header/padding);
// returns bytes written, or -1 on overflow.
int64_t zpix_qoi_encode(const uint8_t* pixels, int64_t pixel_count,
                        int32_t channels, uint8_t* out, int64_t cap) {
  Px index[64];
  memset(index, 0, sizeof(index));
  Px prev{0, 0, 0, 255};
  Px px = prev;
  int64_t run = 0;
  int64_t o = 0;
  const bool has_alpha = channels == 4;

  for (int64_t i = 0; i < pixel_count; i++) {
    const uint8_t* s = pixels + i * channels;
    px.r = s[0];
    px.g = s[1];
    px.b = s[2];
    if (has_alpha) px.a = s[3];

    if (px.r == prev.r && px.g == prev.g && px.b == prev.b && px.a == prev.a) {
      run++;
      if (run == 62 || i == pixel_count - 1) {
        if (o >= cap) return -1;
        out[o++] = uint8_t(0xC0 | (run - 1));
        run = 0;
      }
    } else {
      if (run > 0) {
        if (o >= cap) return -1;
        out[o++] = uint8_t(0xC0 | (run - 1));
        run = 0;
      }
      int idx = index_pos(px);
      Px e = index[idx];
      if (e.r == px.r && e.g == px.g && e.b == px.b && e.a == px.a) {
        if (o >= cap) return -1;
        out[o++] = uint8_t(idx);
      } else {
        index[idx] = px;
        if (px.a == prev.a) {
          int vr = int(px.r) - prev.r;
          int vg = int(px.g) - prev.g;
          int vb = int(px.b) - prev.b;
          int vg_r = vr - vg;
          int vg_b = vb - vg;
          if (vr > -3 && vr < 2 && vg > -3 && vg < 2 && vb > -3 && vb < 2) {
            if (o >= cap) return -1;
            out[o++] = uint8_t(0x40 | ((vr + 2) << 4) | ((vg + 2) << 2) | (vb + 2));
          } else if (vg_r > -9 && vg_r < 8 && vg > -33 && vg < 32 && vg_b > -9 &&
                     vg_b < 8) {
            if (o + 2 > cap) return -1;
            out[o++] = uint8_t(0x80 | (vg + 32));
            out[o++] = uint8_t(((vg_r + 8) << 4) | (vg_b + 8));
          } else {
            if (o + 4 > cap) return -1;
            out[o++] = 0xFE;
            out[o++] = px.r;
            out[o++] = px.g;
            out[o++] = px.b;
          }
        } else {
          if (o + 5 > cap) return -1;
          out[o++] = 0xFF;
          out[o++] = px.r;
          out[o++] = px.g;
          out[o++] = px.b;
          out[o++] = px.a;
        }
      }
    }
    prev = px;
  }
  return o;
}

}  // extern "C"
