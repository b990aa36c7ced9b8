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
// Schedule: the anti-diagonal wavefront.  Pixel (r, p) needs (r, p - 1),
// (r - 1, p) and (r - 1, p - 1), so at step c row r decodes pixel c - r:
// its reads were written at steps c - 1 and c - 2, and one barrier a step
// suffices.  One CUDA block an image, a thread a row (striding over the
// rows when H exceeds the block), H + W - 1 steps.  The raw rows and
// filter bytes are read through strides, so the kernel reads the inflated
// stream [B, H, 1 + Wb] (host upload or K16's output) in place.  The
// JAX graph's shear, pad and transpose exist for the TPU's lane layout and
// are not carried over.  Bound on the H100: a chain of H + W - 1
// dependent steps (each an L1 round trip and a barrier); the bytes (the
// rows in and out once) take a few hundredths of a millisecond.  Only 16
// of the 132 SMs work on a batch of 16; rows of type 0/2 need no wavefront
// and a Sub row is a prefix sum -- the levers for a faster design.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

__global__ void defilter_kernel(const uint8_t* __restrict__ raw, int64_t raw_img,
                                int64_t raw_row, const uint8_t* __restrict__ ft,
                                int64_t ft_img, int64_t ft_row, uint8_t* out, int H, int Wb,
                                int bpp, int* bad) {
  const int64_t b = blockIdx.x;
  const uint8_t* src = raw + b * raw_img;
  const uint8_t* f = ft + b * ft_img;
  uint8_t* o = out + b * H * static_cast<int64_t>(Wb);
  const int W = Wb / bpp;
  if (bad != nullptr) {
    for (int r = threadIdx.x; r < H; r += blockDim.x) {
      if (f[r * ft_row] > 4) *bad = 1;
    }
  }
  for (int c = 0; c < H + W - 1; ++c) {
    const int r_lo = c - W + 1 > 0 ? c - W + 1 : 0;
    const int r_hi = c < H - 1 ? c : H - 1;  // rows r_lo..r_hi hold a pixel at step c
    for (int r = threadIdx.x; r <= r_hi; r += blockDim.x) {
      if (r < r_lo) continue;
      const int p = c - r;
      const int ftype = f[r * ft_row];
      const uint8_t* in = src + r * raw_row + static_cast<int64_t>(p) * bpp;
      uint8_t* cur = o + static_cast<int64_t>(r) * Wb + static_cast<int64_t>(p) * bpp;
      const uint8_t* up = cur - Wb;
      for (int k = 0; k < bpp; ++k) {
        const int left = p > 0 ? cur[k - bpp] : 0;
        const int upv = r > 0 ? up[k] : 0;
        const int ul = p > 0 && r > 0 ? up[k - bpp] : 0;
        int pred = 0;
        if (ftype == 1) {
          pred = left;
        } else if (ftype == 2) {
          pred = upv;
        } else if (ftype == 3) {
          pred = (left + upv) >> 1;
        } else if (ftype == 4) {
          pred = paeth(left, upv, ul);
        }
        cur[k] = static_cast<uint8_t>(in[k] + pred);
      }
    }
    __syncthreads();  // step c's pixels are read at steps c + 1 and c + 2
  }
}

}  // namespace

// raw: row r of image b at raw + b * raw_img + r * raw_row (Wb bytes);
// ft: filter byte of (b, r) at ft + b * ft_img + r * ft_row; out u8
// [B, H, Wb] contiguous; bad int32 [1] or null.
extern "C" int zpix_png_defilter(const void* raw, int64_t raw_img, int64_t raw_row,
                                 const void* ft, int64_t ft_img, int64_t ft_row, void* out,
                                 int batch, int H, int Wb, int bpp, void* bad, void* stream) {
  if (batch > 0 && H > 0 && Wb > 0) {
    const int threads = H >= 1024 ? 1024 : (H + 31) / 32 * 32;
    defilter_kernel<<<static_cast<unsigned>(batch), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(raw), raw_img, raw_row, static_cast<const uint8_t*>(ft),
        ft_img, ft_row, static_cast<uint8_t*>(out), H, Wb, bpp, static_cast<int*>(bad));
  }
  return static_cast<int>(cudaGetLastError());
}
