// Pieces shared by the flash-attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu): tile sizes, strides, the mma.sync / ldmatrix /
// cp.async wrappers and the strided tile loader.

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

// row stride in shared memory of a bf16 tile with D columns (16-byte
// rows, shifted by 16 bytes per row so ldmatrix meets no bank conflict)
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8, and gets (row g, cols 2t, 2t+1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, transposed: each lane gets (rows 2t, 2t+1, col g)
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte global -> shared copy that does not wait; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ROWS x D tile of a [.., s, .., D] tensor into shared memory as 16-byte
// cp.async copies by NT threads; rows at or past `limit` read as zeros
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int limit,
                                                int tid) {
  constexpr int CHUNKS = D / 8;
  for (int e = tid; e < ROWS * CHUNKS; e += NT) {
    const int row = e / CHUNKS, ch = e % CHUNKS;
    const bool in = row0 + row < limit;
    // an out-of-range row copies 0 bytes, from a valid address
    const __nv_bfloat16* from =
        src + (in ? (long long)(row0 + row) * row_stride : 0) + ch * 8;
    cp_async16(dst + row * mma_ld<D>() + ch * 8, from, in);
  }
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
