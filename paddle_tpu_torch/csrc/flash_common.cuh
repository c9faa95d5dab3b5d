// Pieces shared by the flash-attention kernels: tile sizes, strides and
// bf16 packing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, n;  // element strides of batch, seq, head (head_dim: 1)
};

// k-tiles of kBN keys whose first key can be seen by a q-tile's last row
__device__ __forceinline__ int causal_tiles(int nk, int q0) {
  int last = (q0 + kBM - 1) / kBN + 1;
  return nk < last ? nk : last;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace flash
