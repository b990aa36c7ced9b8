// n / d for 0 <= n < 2^31 by a multiply-high (Granlund and Montgomery),
// shared by K8-K10 (prog_entropy.cu) and K11 (prog_store.cu): magic =
// floor(2^32 (2^l - d) / d) + 1 with 2^l >= d, n / d = (umulhi(n, magic)
// + n) >> l.  A power of two has magic 1 and the product vanishes.
// ops/progressive.py::fast_div makes the pair; its test holds it to //.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zpix {

struct FastDiv {
  uint32_t magic;
  int shift;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

}  // namespace zpix
