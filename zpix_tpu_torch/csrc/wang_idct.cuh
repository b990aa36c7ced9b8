// Exact Wang (1984) fixed-point 8x8 IDCT butterflies, shared by the
// strip pixel stage of K4 and K6 (mcu_pixels.cuh) and the standalone IDCT
// kernel (idct.cu).
//
// The device form of zpix_tpu/ops/idct.py::_butterfly_row_list and
// _butterfly_col_list (the reference's idct.zig:77-201).  numpy and XLA
// int32 arithmetic wraps; signed overflow in C++ is undefined, so every
// multiply-add runs in uint32_t and each right shift is an arithmetic
// shift of the wrapped value reinterpreted as int32_t.
#pragma once
#include <cstdint>

namespace zpix {

constexpr uint32_t kW1 = 2841, kW2 = 2676, kW3 = 2408, kW5 = 1609, kW6 = 1108,
                   kW7 = 565, kR2 = 181;

__device__ __forceinline__ int32_t asr(uint32_t x, int n) {
  return static_cast<int32_t>(x) >> n;
}

// One row in registers: v[0..7] in place (idct.zig:79-145).
__device__ __forceinline__ void wang_row_regs(int32_t (&v)[8]) {
  uint32_t x0 = (static_cast<uint32_t>(v[0]) << 11) + 128u;
  uint32_t x1 = static_cast<uint32_t>(v[4]) << 11;
  uint32_t x2 = v[6], x3 = v[2], x4 = v[1], x5 = v[7], x6 = v[5], x7 = v[3];
  uint32_t x8 = kW7 * (x4 + x5);
  x4 = x8 + (kW1 - kW7) * x4;
  x5 = x8 - (kW1 + kW7) * x5;
  x8 = kW3 * (x6 + x7);
  x6 = x8 - (kW3 - kW5) * x6;
  x7 = x8 - (kW3 + kW5) * x7;
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = kW6 * (x3 + x2);
  x2 = x1 - (kW2 + kW6) * x2;
  x3 = x1 + (kW2 - kW6) * x3;
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = static_cast<uint32_t>(asr(kR2 * (x4 + x5) + 128u, 8));
  x4 = static_cast<uint32_t>(asr(kR2 * (x4 - x5) + 128u, 8));
  v[0] = asr(x7 + x1, 8);
  v[1] = asr(x3 + x2, 8);
  v[2] = asr(x0 + x4, 8);
  v[3] = asr(x8 + x6, 8);
  v[4] = asr(x8 - x6, 8);
  v[5] = asr(x0 - x4, 8);
  v[6] = asr(x3 - x2, 8);
  v[7] = asr(x7 - x1, 8);
}

// One column in registers: v[0..7] (rows 0..7) in place (idct.zig:148-200).
__device__ __forceinline__ void wang_col_regs(int32_t (&v)[8]) {
  uint32_t y0 = (static_cast<uint32_t>(v[0]) << 8) + 8192u;
  uint32_t y1 = static_cast<uint32_t>(v[4]) << 8;
  uint32_t y2 = v[6], y3 = v[2], y4 = v[1], y5 = v[7], y6 = v[5], y7 = v[3];
  uint32_t y8 = kW7 * (y4 + y5) + 4u;
  y4 = static_cast<uint32_t>(asr(y8 + (kW1 - kW7) * y4, 3));
  y5 = static_cast<uint32_t>(asr(y8 - (kW1 + kW7) * y5, 3));
  y8 = kW3 * (y6 + y7) + 4u;
  y6 = static_cast<uint32_t>(asr(y8 - (kW3 - kW5) * y6, 3));
  y7 = static_cast<uint32_t>(asr(y8 - (kW3 + kW5) * y7, 3));
  y8 = y0 + y1;
  y0 = y0 - y1;
  y1 = kW6 * (y3 + y2) + 4u;
  y2 = static_cast<uint32_t>(asr(y1 - (kW2 + kW6) * y2, 3));
  y3 = static_cast<uint32_t>(asr(y1 + (kW2 - kW6) * y3, 3));
  y1 = y4 + y6;
  y4 = y4 - y6;
  y6 = y5 + y7;
  y5 = y5 - y7;
  y7 = y8 + y3;
  y8 = y8 - y3;
  y3 = y0 + y2;
  y0 = y0 - y2;
  y2 = static_cast<uint32_t>(asr(kR2 * (y4 + y5) + 128u, 8));
  y4 = static_cast<uint32_t>(asr(kR2 * (y4 - y5) + 128u, 8));
  v[0] = asr(y7 + y1, 14);
  v[1] = asr(y3 + y2, 14);
  v[2] = asr(y0 + y4, 14);
  v[3] = asr(y8 + y6, 14);
  v[4] = asr(y8 - y6, 14);
  v[5] = asr(y0 - y4, 14);
  v[6] = asr(y3 - y2, 14);
  v[7] = asr(y7 - y1, 14);
}

// The same butterflies on memory: a row v[0..7], a column v[0], v[stride],
// ..., v[7 * stride], each in place (idct.cu's form).
__device__ __forceinline__ void wang_row(int32_t* v) {
  int32_t r[8];
  for (int i = 0; i < 8; ++i) r[i] = v[i];
  wang_row_regs(r);
  for (int i = 0; i < 8; ++i) v[i] = r[i];
}

__device__ __forceinline__ void wang_col(int32_t* v, int stride) {
  int32_t c[8];
  for (int i = 0; i < 8; ++i) c[i] = v[i * stride];
  wang_col_regs(c);
  for (int i = 0; i < 8; ++i) v[i * stride] = c[i];
}

}  // namespace zpix
