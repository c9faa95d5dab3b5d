// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): tile sizes, strides, bf16 packing and the f32
// tile loaders of the FFMA kernels.

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

// ROWS x D f32 tile, transposed into dst[d * ld + row] (scaled by mul);
// rows at or past `limit` read as zeros
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_t(float* dst, int ld,
                                            const float* src,
                                            long long row_stride, int row0,
                                            int limit, float mul, int tid) {
  for (int e = tid; e < ROWS * D; e += NT) {
    const int row = e / D, d = e % D;
    float x = 0.f;
    if (row0 + row < limit) x = src[(long long)(row0 + row) * row_stride + d] * mul;
    dst[d * ld + row] = x;
  }
}

// ROWS x D f32 tile, row-major into dst[row * D + d]
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int limit, int tid) {
  for (int e = tid; e < ROWS * D; e += NT) {
    const int row = e / D, d = e % D;
    dst[row * D + d] = row0 + row < limit
                           ? src[(long long)(row0 + row) * row_stride + d]
                           : 0.f;
  }
}

}  // namespace flash
