// Decoupled look-back between tiles, shared by K3 (dc_restore.cu), K7
// (unpack_sparse.cu) and K8 (prog_entropy.cu), and a 16-byte cp.async.
//
// A tile publishes one 64-bit word a chain: the status in the top two
// bits (kAggregate: the tile's own sum; kInclusive: the chain's sum up to
// and including the tile), the launch's epoch in the next 30 and the sum
// in the low 32, written in one store, so no reader sees a status without
// its sum.  A word is set for a launch when its status is not 0 and its
// epoch is the launch's.  A tile finds its carry with a warp: 32 earlier
// tiles a round, each lane polling one word until it is set, summing
// back to the nearest inclusive word.  Tiles are taken by ticket, so
// every word a tile waits on belongs to a tile already running: a grid
// larger than the card holds at once drains.  A poll traps (a launch
// failure, not a hang) after 2^24 reads.
//
// K8 zeroes its words with a memset and runs at epoch 0.  K3 and K7 take
// a scratch kept between calls (zpix_tpu_torch/runtime.py::
// lookback_scratch) and a new epoch each launch, so the words an earlier
// launch left read as unset and need no memset; word 0 is the ticket
// counter, which the CTA taking the launch's last ticket sets back to 0.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace zpix_lookback {

constexpr uint64_t kAggregate = uint64_t(1) << 62, kInclusive = uint64_t(2) << 62;
constexpr uint32_t kEpochMask = (1u << 30) - 1;  // epochs 0 .. 2^30 - 1
constexpr int64_t kMaxPolls = int64_t(1) << 24;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void publish(uint64_t* word, uint64_t status, uint32_t sum,
                                        uint32_t epoch = 0) {
  *reinterpret_cast<volatile uint64_t*>(word) = status | uint64_t(epoch) << 32 | sum;
}

__device__ __forceinline__ uint64_t poll(const uint64_t* word, uint32_t epoch) {
  int64_t n = 0;
  uint64_t v;
  while (((v = *reinterpret_cast<const volatile uint64_t*>(word)) >> 62) == 0 ||
         (static_cast<uint32_t>(v >> 32) & kEpochMask) != epoch) {
    if (++n > kMaxPolls) __trap();
  }
  return v;
}

// A whole warp: the carry entering tile ``tile`` of a chain whose tile p
// has its word at words[p * stride].  Tile 0, or some tile before
// ``tile``, must publish kInclusive without waiting.
__device__ __forceinline__ uint32_t carry_in(const uint64_t* words, int64_t tile, int stride,
                                             uint32_t epoch = 0) {
  const int lane = threadIdx.x & 31;
  uint32_t carry = 0;
  for (int64_t p = tile - 1; p >= 0; p -= 32) {
    const int64_t me = p - lane;
    const uint64_t w = me >= 0 ? poll(words + me * stride, epoch) : kInclusive;
    const unsigned inc = __ballot_sync(kFull, (w >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 32;  // lanes 0..stop count
    uint32_t v = lane <= stop ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    carry += v;
    if (inc) break;
  }
  return carry;
}

// One thread of each CTA: its tile, the next ticket of ``counter`` (0 at
// the launch's start).  The launch's ``tiles`` CTAs take one each, so the
// CTA taking the last one leaves the counter at 0 for the next launch.
__device__ __forceinline__ uint32_t take_ticket(uint32_t* counter, int64_t tiles) {
  const uint32_t t = atomicAdd(counter, 1u);
  if (t == tiles - 1) atomicExch(counter, 0u);
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

}  // namespace zpix_lookback
