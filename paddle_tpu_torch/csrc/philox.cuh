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
// One call covers a 2x2 block of links. In the wgmma kernels' score
// layout a lane holds two columns (2t, 2t+1) of two rows (g, g+8), and
// the lanes g and g^1 need the same two 2x2 blocks: flash_wgmma.cuh's
// keep_words computes each block once for both, on the producer
// warpgroup.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The key lives in device memory: `seed` points at the two 32-bit words
// (lo, hi) of the 64-bit seed, as a little-endian int64 tensor holds it.
// Each kernel reads them once at its start (drop_params), so a captured
// CUDA graph draws whatever seed the step wrote there before the replay,
// as the Pallas kernels read their seed from SMEM
// (pallas_kernels.py:248-258) rather than from the compiled program.
struct DropParams {
  uint32_t threshold;        // keep when bits >= threshold
  const uint32_t* seed;      // device memory: seed_lo, seed_hi
  uint32_t seed_lo, seed_hi; // the key, filled in by drop_params
  float rinv;                // 1 / (1 - p)
};

// dp with its key read from device memory (DROP), or as given
template <bool DROP>
__device__ __forceinline__ DropParams drop_params(const DropParams& dp) {
  DropParams r = dp;
  if (DROP) {
    r.seed_lo = dp.seed[0];
    r.seed_hi = dp.seed[1];
  }
  return r;
}

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
