// The benchmark's frozen QOI encoder: a copy of zpix_qoi_encode
// (zpix_tpu_torch/csrc/host/qoi.cpp as of this benchmark), kept here so
// that a change to the program cannot change the streams the benchmark
// feeds it.  Built with g++ into benchmark/.cache/ by native/__init__.py.
//
// Encode pixel_count pixels (channels 3 or 4) into out (caller-sized to
// pixel_count * (channels + 1) + 22).  Writes ops only (no header or
// padding); returns the bytes written, or -1 on overflow.
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

int64_t bench_qoi_encode(const uint8_t* pixels, int64_t pixel_count,
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
