// The FFMA tiles of the f32 flash-attention backward at head_dim 256
// (flash_attn_d256.cu): [32 x 256] f32 tiles in shared memory with a row
// stride of 260 floats, a CTA of 256 threads in which thread (r, c) =
// (tid / 16, tid % 16) owns a 2x2 block of the 32x32 scores and two rows
// x 16 columns (4c + 64g + e) of a [32 x 256] product. See
// flash_attn_d256.cu for the design and what bounds it. The cluster
// kernels of flash_attn_wide.cu (the f32 forward from 256, the backward
// above it) take its chunk width, float4 loads and mask rules.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {


using flash::kNeg;
using flash::Strides;

constexpr int kD = 256;         // head_dim
constexpr int kT = 32;          // rows (queries or keys) of a tile
constexpr int kLd = kD + 4;     // row stride of a [kT x kD] tile (floats)
constexpr int kPLd = kT + 1;    // row stride of a [kT x kT] score tile
constexpr int kThreads = 256;   // 16 row pairs x 16 column pairs
constexpr int kTile = kT * kLd;
constexpr int kScores = kT * kPLd;

constexpr size_t kDqSmem = (4 * kTile + kScores) * sizeof(float);
constexpr size_t kDkvSmem =
    (4 * kTile + 2 * kScores + 2 * kT) * sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// kT rows of a [s, D] head (row stride row_stride elements) from row0,
// widened to f32 and multiplied by mul, into dst[row * kLd + d]; rows at
// or past `limit` read as zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int limit, float mul, int tid) {
  for (int e = tid; e < kT * kD; e += kThreads) {
    const int row = e / kD, d = e % kD;
    float x = 0.f;
    if (row0 + row < limit)
      x = to_f(src[(long long)(row0 + row) * row_stride + d]) * mul;
    dst[row * kLd + d] = x;
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s[i][j] = A[2a + i] . B[2b + j] over D, rows of [kT][kLd] tiles
__device__ __forceinline__ void scores(float s[2][2], const float* A, int a,
                                       const float* B, int b) {
  const float* a0 = A + (2 * a) * kLd;
  const float* b0 = B + (2 * b) * kLd;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    const float4 x0 = ld4(a0 + d), x1 = ld4(a0 + kLd + d);
    const float4 y0 = ld4(b0 + d), y1 = ld4(b0 + kLd + d);
    s[0][0] = dot4(x0, y0, s[0][0]);
    s[0][1] = dot4(x0, y1, s[0][1]);
    s[1][0] = dot4(x1, y0, s[1][0]);
    s[1][1] = dot4(x1, y1, s[1][1]);
  }
}

// acc[i][4g + e] += P[2r + i][kk] * B[kk][64g + 4c + e] over the kT
// columns kk of a [kT][kPLd] score tile P and the rows of a tile B
__device__ __forceinline__ void accumulate(float acc[2][16], const float* P,
                                           int r, const float* B, int c) {
#pragma unroll 4
  for (int kk = 0; kk < kT; ++kk) {
    const float p0 = P[(2 * r) * kPLd + kk], p1 = P[(2 * r + 1) * kPLd + kk];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float4 x = ld4(B + kk * kLd + g * 64 + c * 4);
      acc[0][g * 4 + 0] = fmaf(p0, x.x, acc[0][g * 4 + 0]);
      acc[0][g * 4 + 1] = fmaf(p0, x.y, acc[0][g * 4 + 1]);
      acc[0][g * 4 + 2] = fmaf(p0, x.z, acc[0][g * 4 + 2]);
      acc[0][g * 4 + 3] = fmaf(p0, x.w, acc[0][g * 4 + 3]);
      acc[1][g * 4 + 0] = fmaf(p1, x.x, acc[1][g * 4 + 0]);
      acc[1][g * 4 + 1] = fmaf(p1, x.y, acc[1][g * 4 + 1]);
      acc[1][g * 4 + 2] = fmaf(p1, x.z, acc[1][g * 4 + 2]);
      acc[1][g * 4 + 3] = fmaf(p1, x.w, acc[1][g * 4 + 3]);
    }
  }
}

// row `i` of acc (columns 64g + 4c + e) times mul, into out_row
template <typename T>
__device__ __forceinline__ void store_row(T* out_row, const float* acc,
                                          int c, float mul) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      put(&out_row[g * 64 + c * 4 + e], acc[g * 4 + e] * mul);
}

__device__ __forceinline__ bool link_ok(bool causal, int row, int col,
                                        int sq, int sk) {
  return row < sq && col < sk && (!causal || row >= col);
}

// tiles of kT keys a causal kT-row query tile from q0 can see
__device__ __forceinline__ int key_tiles(bool causal, int sk, int q0) {
  const int nk = (sk + kT - 1) / kT;
  const int last = q0 / kT + 1;  // q0 is a multiple of kT
  return causal && last < nk ? last : nk;
}

template <typename Kern, typename A>
cudaError_t go(Kern kern, dim3 grid, size_t smem, cudaStream_t stream,
               const A& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
