// Philox4x32-10 and the attention-dropout mask, shared by the forward
// and both backward flash-attention kernels.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_drop_mask`, which draws
// the TPU's own random bits per (seed, q-block, k-block) and so depends
// on the TPU block sizes. Here the mask is a pure function of
// (seed, b*n + head, row, col), identical whatever tiles a kernel uses
// and identical to paddle_tpu_torch/ops/philox.py:
//   counter = (col >> 1, row >> 1, bh, 0), key = (seed_lo, seed_hi);
//   the element's word is (row & 1) * 2 + (col & 1);
//   keep when word >= threshold = min(floor(p * 2^32), 2^32 - 1).
// One call covers a 2x2 block of links. A thread of the mma.sync kernels
// holds two columns (2t, 2t+1) of two rows (g, g+8); the lanes g and g^1
// need the same two 2x2 blocks, so each computes one and they swap it
// (philox_pair below): one call per 8-column chunk per thread.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct DropParams {
  uint32_t threshold;  // keep when bits >= threshold
  uint32_t seed_lo, seed_hi;
  float rinv;          // 1 / (1 - p)
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the four words of the 2x2 block holding (row, col)
__device__ __forceinline__ uint4 drop_block(const DropParams& dp, int bh,
                                            int row, int col) {
  return philox4x32_10(make_uint4((uint32_t)col >> 1, (uint32_t)row >> 1,
                                  (uint32_t)bh, 0u),
                       dp.seed_lo, dp.seed_hi);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// keep bit of one link, from the words of its 2x2 block
__device__ __forceinline__ bool drop_keep(const DropParams& dp,
                                          const uint4& w, int row, int col) {
  return word_of(w, (row & 1) * 2 + (col & 1)) >= dp.threshold;
}

// Two 2x2 blocks shared by the lanes `lane` and `lane ^ xor_lanes`: this
// lane computes block `mine` (0 or 1), the partner the other, and they
// swap. Returns the block-0 and block-1 words in b0, b1.
__device__ __forceinline__ void philox_pair(const DropParams& dp, int bh,
                                            int mine, int row0, int col0,
                                            int row1, int col1,
                                            int xor_lanes, uint4& b0,
                                            uint4& b1) {
  const uint4 w = mine ? drop_block(dp, bh, row1, col1)
                       : drop_block(dp, bh, row0, col0);
  uint4 o;
  o.x = __shfl_xor_sync(0xffffffffu, w.x, xor_lanes);
  o.y = __shfl_xor_sync(0xffffffffu, w.y, xor_lanes);
  o.z = __shfl_xor_sync(0xffffffffu, w.z, xor_lanes);
  o.w = __shfl_xor_sync(0xffffffffu, w.w, xor_lanes);
  b0 = mine ? o : w;
  b1 = mine ? w : o;
}
