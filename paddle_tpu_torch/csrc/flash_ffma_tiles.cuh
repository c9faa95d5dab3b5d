// The tiles and products of the f32 FFMA flash-attention kernels at
// head_dim 64 and 128: the forward fwd_ffma (flash_attn_fwd.cu) and the
// backward dq_ffma and dkv_ffma (flash_attn_bwd.cu). A CTA of 384
// threads owns R rows (Ffma::kR) and walks the other side in kFR-row
// tiles. Warps 0-7 consume; the producer warpgroup copies every operand
// tile once, row-major at a stride of D + 4 floats (the backward by
// flash_bulk.cuh's bulk copies a row, the forward by TMA boxes), the
// resident tiles on `misc` and two walked tiles in flight, each
// released by its own `empty` barrier, and with dropout computes the
// keep bits; setmaxnreg moves its registers to the consumers. Every
// product reads both operands along head_dim as float4 rows, exact f32
// FFMA, no TF32. Each kernel lays out its own score loop (a thread's
// block of S); the accumulating product O += P V (dQ += dS K, ...) is
// ffma_accumulate.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bulk.cuh"
#include "flash_common.cuh"

namespace flash_ffma {

constexpr int kFR = 64;  // walked rows of a tile
constexpr int kFThreads = 384, kFConsumers = 256;
// the register split (producer, consumer), within the pool
// __launch_bounds__(384, 1) gives the CTA (168 a thread): asking for
// more spins forever in the allocation. 72 / 208: at 56 and 64 the
// backward's keep warps spilled, at 216 its dK/dV consumers; dQ took
// 4.6% longer at 64 / 216.
constexpr int kFProdRegs = 72, kFConsRegs = 208;
static_assert((kFThreads - kFConsumers) * kFProdRegs +
                      kFConsumers * kFConsRegs <=
                  168 * kFThreads,
              "the warpgroups' registers exceed the CTA's pool");
// the producer warpgroup's other warps compute each tile's keep bits and
// hand them over as a word a consumer thread in shared memory with the
// tile's full barrier
constexpr int kFKeepWarps = 3;

template <int D>
struct Ffma {
  static_assert(D == 64 || D == 128, "the FFMA kernels take 64 and 128");
  // resident rows: 128 where they fit beside the walked tiles (64), so
  // each walked tile serves twice the rows; 64 at 128
  static constexpr int kR = D == 64 ? 128 : 64;
  static constexpr int kLd = D + 4;    // an operand tile's row stride
  static constexpr int kRTile = kR * kLd;
  static constexpr int kTile = kFR * kLd;
  static constexpr int kStages = 2;    // walked tiles in flight
  static constexpr int kKeepWords = kStages * kFConsumers;
  // with dropout the full barriers count the keep warps' arrivals too
  template <bool DROP>
  using Bars = flash_bulk::Bars<D, kLd, kStages, kFConsumers / 32,
                                1 + (DROP ? kFKeepWarps : 0)>;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 x, const float4 y,
                                      float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc[i][4 g + e] += X[kk][4 ua + i] * B[kk][D / 2 g + 4 ub + e] over the
// kFR walked rows kk of a score tile X (row stride SLD) and a walked
// tile B: 3 float4 loads for 32 FMAs
template <int D, int SLD, typename Ro>
__device__ __forceinline__ void ffma_accumulate(float acc[4][8],
                                                const float* X,
                                                const float* B,
                                                const Ro& ro) {
  constexpr int LD = Ffma<D>::kLd;
#pragma unroll 4
  for (int kk = 0; kk < kFR; ++kk) {
    const float4 p = ld4(X + kk * SLD + 4 * ro.ua);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float4 y = ld4(B + kk * LD + (D / 2) * g + 4 * ro.ub);
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * g + e] = fmaf(pv[i], yv[e], acc[i][4 * g + e]);
    }
  }
}

__device__ __forceinline__ void zero8(float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
}

// the copies and float4 loads and stores need every row of a tensor
// 16-byte aligned (ops/flash_attention.py's _kernel_input copies
// a tensor whose rows are not)
inline bool rows16(const void* p, const flash::Strides& s) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && s.b % 4 == 0 &&
         s.s % 4 == 0 && s.n % 4 == 0;
}

}  // namespace flash_ffma
