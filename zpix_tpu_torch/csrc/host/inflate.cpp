// DEFLATE symbol-resolve pass (RFC 1951/1950): bitstream -> LZ77 token
// arrays, the host half of the two-pass inflate of the port's PNG
// device_inflate route.  The second half -- resolving back-reference
// copies into bytes -- is K16 on the card (zpix_tpu_torch/ops/inflate.py,
// csrc/inflate_resolve.cu); this pass never materializes the output
// window, so the host does only the bit-serial Huffman work.
//
// A whole copy, with the same C ABI, of zpix_tpu/runtime/inflate.cpp
// (zpix_inflate_tokens :208; return codes -101 and -102), plus one entry
// of its own, zpix_inflate_tokens_trailer, which also gives where the
// adler32 trailer starts, so that the port can check it.  Reference
// semantics: the zlib stream zpix inflates with std.compress.flate (the
// reference's src/png/decoder.zig:513-518).  Token validity rules
// (dist <= bytes produced, lengths 3..258, dist 1..32768) follow RFC 1951
// section 3.2.  The comments below keep the JAX package's measurements,
// taken on its host.
//
// Built by zpix_tpu_torch/runtime/host.py with
//   g++ -O3 -std=c++17 -fPIC -shared -lpthread

#include <cstdint>
#include <cstring>

namespace {

constexpr int kErrFormat = 101;  // mirrors runtime.host.ERR_FORMAT

struct BitIn {
  const uint8_t* p;
  int64_t n;
  int64_t pos = 0;   // next byte to BUFFER (may run ahead of consumption)
  uint64_t acc = 0;  // LSB-first accumulator
  int bits = 0;      // valid low bits of acc
  bool fail = false;

  // Bulk refill: one 8-byte load tops the accumulator to >= 56 bits
  // (the classic inflate_fast trick); byte loop near stream end.
  inline void refill() {
    if (pos + 8 <= n) {
      uint64_t w;
      memcpy(&w, p + pos, 8);
      acc |= w << bits;
      int take = (63 - bits) >> 3;
      pos += take;
      bits += take * 8;
    } else {
      while (bits < 56 && pos < n) {
        acc |= uint64_t(p[pos++]) << bits;
        bits += 8;
      }
    }
  }

  inline uint32_t get(int k) {  // k <= 16
    if (bits < k) {
      refill();
      if (bits < k) {
        fail = true;
        return 0;
      }
    }
    uint32_t v = uint32_t(acc) & ((1u << k) - 1);
    acc >>= k;
    bits -= k;
    return v;
  }
  // Top up the accumulator to >= k bits WITHOUT consuming (LUT peek).
  // Returns false near stream end when fewer than k bits remain.
  inline bool fill(int k) {
    if (bits < k) refill();
    return bits >= k;
  }
  inline void drop(int k) {
    acc >>= k;
    bits -= k;
  }
  inline void align() {
    // Discard the partial byte and rewind `pos` over the buffered
    // whole bytes (refill runs ahead of consumption).
    pos -= bits >> 3;
    acc = 0;
    bits = 0;
  }
};

// Canonical Huffman decode tables: per-length first code + symbol offset
// (same scheme as the JPEG slow path in entropy.cpp, but DEFLATE codes are
// emitted MSB-of-code-first even though bytes fill LSB-first).
struct Huff {
  int32_t count[16] = {0};
  int32_t first_code[16] = {0};
  int32_t first_sym[16] = {0};
  uint16_t syms[320] = {0};
  int max_len = 0;

  bool build(const uint8_t* lens, int n) {
    for (int i = 0; i < 16; i++) count[i] = 0;
    for (int i = 0; i < n; i++) {
      if (lens[i] > 15) return false;
      count[lens[i]]++;
    }
    count[0] = 0;
    int32_t code = 0, sym = 0;
    max_len = 0;
    for (int l = 1; l <= 15; l++) {
      code <<= 1;
      first_code[l] = code;
      first_sym[l] = sym;
      code += count[l];
      sym += count[l];
      if (code > (1 << l)) return false;  // oversubscribed
      if (count[l]) max_len = l;
    }
    sym = 0;
    for (int l = 1; l <= 15; l++) {
      int32_t c = first_sym[l];
      for (int i = 0; i < n; i++)
        if (lens[i] == l) syms[c++] = uint16_t(i);
    }
    return true;
  }

  inline int decode(BitIn& in) const {
    int32_t code = 0;
    for (int l = 1; l <= max_len; l++) {
      code = (code << 1) | int32_t(in.get(1));
      if (in.fail) return -1;
      if (count[l] && code < first_code[l] + count[l])
        return syms[first_sym[l] + (code - first_code[l])];
    }
    return -1;
  }
};

// One-level LUT on top of Huff: index by the next kRoot accumulator bits
// (LSB-first, so codes are bit-reversed into the table); codes longer
// than kRoot (rare in real streams) fall back to Huff's bit loop.  This
// is what makes the symbol-resolve pass libdeflate-class instead of
// ~5x slower (measured on the JAX package's host).
struct LutHuff {
  static constexpr int kRoot = 10;
  Huff slow;
  uint16_t lut[1 << kRoot];  // (len << 9) | sym;  0 = overlong/invalid

  bool build(const uint8_t* lens, int n) {
    if (!slow.build(lens, n)) return false;
    memset(lut, 0, sizeof(lut));
    // Recover each symbol's canonical code from the per-length tables.
    int32_t next_code[16];
    for (int l = 1; l <= 15; l++) next_code[l] = slow.first_code[l];
    for (int l = 1; l <= kRoot; l++) {
      for (int i = 0; i < slow.count[l]; i++) {
        int sym = slow.syms[slow.first_sym[l] + i];
        uint32_t code = uint32_t(next_code[l]++);
        // reverse the l code bits (codes are MSB-first on the wire,
        // the accumulator is LSB-first)
        uint32_t rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1u) << (l - 1 - b);
        uint16_t e = uint16_t((l << 9) | sym);
        for (uint32_t j = rev; j < (1u << kRoot); j += (1u << l)) lut[j] = e;
      }
    }
    return true;
  }

  inline int decode(BitIn& in) const {
    if (in.fill(kRoot)) {
      uint16_t e = lut[uint32_t(in.acc) & ((1u << kRoot) - 1)];
      if (e) {
        in.drop(e >> 9);
        return e & 0x1FF;
      }
    }
    return slow.decode(in);  // overlong code or near stream end
  }
};

// RFC 1951 3.2.5 length/distance tables.
constexpr int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                              15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                              67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,    13,
                               17,   25,   33,   49,   65,   97,    129,  193,
                               257,  385,  513,  769,  1025, 1537,  2049, 3073,
                               4097, 6145, 8193, 12289, 16385, 24577};
constexpr int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12,
                                13, 13};
constexpr int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

void fixed_lit_lens(uint8_t* l) {
  for (int i = 0; i <= 143; i++) l[i] = 8;
  for (int i = 144; i <= 255; i++) l[i] = 9;
  for (int i = 256; i <= 279; i++) l[i] = 7;
  for (int i = 280; i <= 287; i++) l[i] = 8;
}

// The tokenizer behind both entry points below; trailer_off, when not
// null, gets the byte offset just past the final block (byte-aligned):
// where a zlib stream's adler32 trailer starts.
int64_t inflate_tokens(const uint8_t* src, int64_t n, int zlib_wrap, int32_t* lens,
                       int32_t* dists, uint8_t* lits, int64_t max_tokens, int64_t max_out,
                       int64_t* out_bytes, int64_t* trailer_off) {
  BitIn in{src, n};
  if (zlib_wrap) {
    if (n < 2) return -kErrFormat;
    uint8_t cmf = src[0], flg = src[1];
    if ((cmf & 0x0F) != 8 || ((cmf << 8 | flg) % 31) != 0 || (flg & 0x20))
      return -kErrFormat;  // not deflate / bad check / FDICT unsupported
    in.pos = 2;
  }

  int64_t nt = 0, produced = 0;
  LutHuff lit, dist;
  uint8_t lit_lens[288], dist_lens[32], cl_lens[19], all_lens[320];

  for (;;) {
    uint32_t bfinal = in.get(1), btype = in.get(2);
    if (in.fail) return -kErrFormat;
    if (btype == 3) return -kErrFormat;
    if (btype == 0) {  // stored
      in.align();
      if (in.pos + 4 > n) return -kErrFormat;
      uint32_t len = uint32_t(src[in.pos]) | uint32_t(src[in.pos + 1]) << 8;
      uint32_t nlen =
          uint32_t(src[in.pos + 2]) | uint32_t(src[in.pos + 3]) << 8;
      in.pos += 4;
      if ((len ^ nlen) != 0xFFFF || in.pos + len > n) return -kErrFormat;
      if (nt + len > max_tokens || produced + len > max_out) return -102;
      for (uint32_t i = 0; i < len; i++) {
        lens[nt] = 1;
        dists[nt] = 0;
        lits[nt] = src[in.pos + i];
        nt++;
      }
      in.pos += len;
      produced += len;
    } else {
      if (btype == 1) {  // fixed codes
        fixed_lit_lens(lit_lens);
        for (int i = 0; i < 30; i++) dist_lens[i] = 5;
        if (!lit.build(lit_lens, 288) || !dist.build(dist_lens, 30))
          return -kErrFormat;
      } else {  // dynamic codes
        int hlit = int(in.get(5)) + 257;
        int hdist = int(in.get(5)) + 1;
        int hclen = int(in.get(4)) + 4;
        if (in.fail || hlit > 286 || hdist > 30) return -kErrFormat;
        memset(cl_lens, 0, sizeof(cl_lens));
        for (int i = 0; i < hclen; i++) cl_lens[kClOrder[i]] = uint8_t(in.get(3));
        if (in.fail) return -kErrFormat;
        Huff cl;
        if (!cl.build(cl_lens, 19)) return -kErrFormat;
        int total = hlit + hdist, got = 0;
        while (got < total) {
          int s = cl.decode(in);
          if (s < 0) return -kErrFormat;
          if (s < 16) {
            all_lens[got++] = uint8_t(s);
          } else if (s == 16) {
            if (got == 0) return -kErrFormat;
            int rep = 3 + int(in.get(2));
            if (in.fail || got + rep > total) return -kErrFormat;
            uint8_t v = all_lens[got - 1];
            while (rep--) all_lens[got++] = v;
          } else {
            int rep = (s == 17) ? 3 + int(in.get(3)) : 11 + int(in.get(7));
            if (in.fail || got + rep > total) return -kErrFormat;
            while (rep--) all_lens[got++] = 0;
          }
        }
        memcpy(lit_lens, all_lens, hlit);
        memset(lit_lens + hlit, 0, sizeof(lit_lens) - hlit);
        memcpy(dist_lens, all_lens + hlit, hdist);
        memset(dist_lens + hdist, 0, sizeof(dist_lens) - hdist);
        if (lit_lens[256] == 0) return -kErrFormat;  // no EOB code
        if (!lit.build(lit_lens, hlit) || !dist.build(dist_lens, hdist))
          return -kErrFormat;
      }
      for (;;) {  // symbol loop
        // Fast path: one refill covers a whole token — litlen code
        // (<=15) + length extra (<=5) + dist code (<=15) + dist extra
        // (<=13) = 48 bits — so decode fields straight off the
        // accumulator.  Falls to the checked path near stream end or
        // on root-table misses (codes longer than kRoot).
        int s;
        if (in.fill(48) && nt < max_tokens) {
          uint16_t e = lit.lut[uint32_t(in.acc) & ((1u << LutHuff::kRoot) - 1)];
          if (e) {
            in.drop(e >> 9);
            s = e & 0x1FF;
            if (s < 256) {
              if (produced >= max_out) return -102;
              lens[nt] = 1;
              dists[nt] = 0;
              lits[nt] = uint8_t(s);
              nt++;
              produced++;
              continue;
            }
            if (s == 256) break;
            if (s > 285) return -kErrFormat;
            int li = s - 257;
            int length =
                kLenBase[li] +
                (uint32_t(in.acc) & ((1u << kLenExtra[li]) - 1));
            in.drop(kLenExtra[li]);
            uint16_t de =
                dist.lut[uint32_t(in.acc) & ((1u << LutHuff::kRoot) - 1)];
            int ds, distance;
            if (de) {
              in.drop(de >> 9);
              ds = de & 0x1FF;
              if (ds > 29) return -kErrFormat;
              distance = kDistBase[ds] +
                         (uint32_t(in.acc) & ((1u << kDistExtra[ds]) - 1));
              in.drop(kDistExtra[ds]);
            } else {
              // overlong dist code: bit loop may drain the accumulator,
              // so the extra bits go through the checked reader
              ds = dist.slow.decode(in);
              if (ds < 0 || ds > 29) return -kErrFormat;
              distance = kDistBase[ds] + int(in.get(kDistExtra[ds]));
              if (in.fail) return -kErrFormat;
            }
            if (distance > produced) return -kErrFormat;
            if (produced + length > max_out) return -102;
            lens[nt] = length;
            dists[nt] = distance;
            lits[nt] = 0;
            nt++;
            produced += length;
            continue;
          }
        }
        s = lit.decode(in);
        if (s < 0) return -kErrFormat;
        if (s < 256) {
          if (nt >= max_tokens || produced >= max_out) return -102;
          lens[nt] = 1;
          dists[nt] = 0;
          lits[nt] = uint8_t(s);
          nt++;
          produced++;
        } else if (s == 256) {
          break;
        } else {
          if (s > 285) return -kErrFormat;
          int li = s - 257;
          int length = kLenBase[li] + int(in.get(kLenExtra[li]));
          int ds = dist.decode(in);
          if (ds < 0 || ds > 29) return -kErrFormat;
          int distance = kDistBase[ds] + int(in.get(kDistExtra[ds]));
          if (in.fail) return -kErrFormat;
          if (distance > produced) return -kErrFormat;  // before stream start
          if (nt >= max_tokens || produced + length > max_out) return -102;
          lens[nt] = length;
          dists[nt] = distance;
          lits[nt] = 0;
          nt++;
          produced += length;
        }
      }
    }
    if (bfinal) break;
  }
  *out_bytes = produced;
  if (trailer_off != nullptr) {
    in.align();
    *trailer_off = in.pos;
  }
  return nt;
}

}  // namespace

extern "C" {

// Tokenize one DEFLATE (zlib_wrap=1: zlib-wrapped) stream.
//   lens[t]  — bytes this token produces (1 for a literal, 3..258 copy)
//   dists[t] — 0 for a literal, else back-reference distance
//   lits[t]  — the literal byte (0 for copies)
// Returns n_tokens >= 0, or -error (-101 bad stream, -102 token/output
// overflow against the caller's caps).  *out_bytes gets the total
// inflated size.  The adler32 trailer is NOT verified (the output is
// never materialized here; PNG chunk CRCs already cover transport).
int64_t zpix_inflate_tokens(const uint8_t* src, int64_t n, int zlib_wrap,
                            int32_t* lens, int32_t* dists, uint8_t* lits,
                            int64_t max_tokens, int64_t max_out,
                            int64_t* out_bytes) {
  return inflate_tokens(src, n, zlib_wrap, lens, dists, lits, max_tokens, max_out, out_bytes,
                        nullptr);
}

// zpix_inflate_tokens that also gives *trailer_off, the byte offset just
// past the final block, where a zlib stream's adler32 trailer starts (the
// port's device_inflate route checks it against K16's output on the card).
int64_t zpix_inflate_tokens_trailer(const uint8_t* src, int64_t n, int zlib_wrap,
                                    int32_t* lens, int32_t* dists, uint8_t* lits,
                                    int64_t max_tokens, int64_t max_out, int64_t* out_bytes,
                                    int64_t* trailer_off) {
  return inflate_tokens(src, n, zlib_wrap, lens, dists, lits, max_tokens, max_out, out_bytes,
                        trailer_off);
}

}  // extern "C"
