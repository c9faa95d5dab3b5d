// The feeding of the f32 FFMA flash-attention kernels (flash_attn_wide.cu
// from head_dim 256, flash_attn_bwd.cu's dq_ffma and dkv_ffma at 64 and
// 128): one producer warp copies each operand row by row with the bulk
// copy engine, the copies counted in bytes on mbarriers, into row-major
// tiles whose rows are padded by 4 floats; the mbarriers live in that
// padding of a resident tile. The consumer warps sync among themselves
// on a named barrier the producer never joins. flash_attn_fwd.cu's
// fwd_ffma copies its tiles by TMA instead and takes the barriers alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_bulk {

// one row of W floats (16-byte aligned) into shared memory by the bulk
// copy engine, its bytes counted on the mbarrier `bar`
template <int W>
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(W * (int)sizeof(float)), "r"(bar)
      : "memory");
}

// The CTA's mbarriers, each in the padding of a row of a resident tile
// of W-float rows at a stride of LD floats (its columns W to LD - 1,
// which no copy, product or store touches), or at W 0 and LD 2 in an
// array of their own, 8 bytes each: full[t] (walked tile t has
// landed: the producer warp's copies), misc (the resident tiles, or the
// consumers' own copies), empty[t] (every one of the CW consumer warps
// is done with walked tile t); NT walked tiles, FC arrivals on each
// full barrier (the copying warp's and any other producer warp's).
template <int W, int LD, int NT = 2, int CW = 8, int FC = 1>
struct Bars {
  static_assert(LD - W >= 2, "an mbarrier needs 8 bytes of row padding");
  uint32_t base;
  __device__ __forceinline__ explicit Bars(float* tile)
      : base(hopper::smem_u32(tile + W)) {}
  __device__ __forceinline__ uint32_t at(int i) const {
    return base + i * LD * (uint32_t)sizeof(float);
  }
  __device__ __forceinline__ uint32_t full(int t) const { return at(t); }
  __device__ __forceinline__ uint32_t misc() const { return at(NT); }
  __device__ __forceinline__ uint32_t empty(int t) const {
    return at(NT + 1 + t);
  }
  // thread 0, before any use: full counts FC arrivals and misc one (with
  // the bytes of their copies), empty one a consumer warp
  __device__ __forceinline__ void init() const {
    for (int t = 0; t < NT; ++t) hopper::mbar_init(full(t), FC);
    hopper::mbar_init(misc(), 1);
    for (int t = 0; t < NT; ++t) hopper::mbar_init(empty(t), CW);
    hopper::mbar_fence_init();
  }
};

// Copies issued by one warp: `tiles` ROWS-row tiles of W-float rows from
// row0 (row stride rs elements, every row 16-byte aligned) into dst,
// dst + ROWS * LD, ... (dst[row * LD + d]), a bulk copy a row counted in
// bytes on `bar`; rows at or past `limit` are zero-filled by stores.
// `bytes` sums what the copies will count.
template <int W, int LD, int ROWS>
__device__ __forceinline__ void warp_load(uint32_t bar, uint32_t& bytes,
                                          float* dst, const float* src,
                                          long long rs, int row0, int limit,
                                          int lane, int tiles = 1) {
  const int rows = tiles * ROWS;
  const int in = max(0, min(rows, limit - row0));
  bytes += in * W * (uint32_t)sizeof(float);
  for (int r = lane; r < rows; r += 32) {
    float* d = dst + (r / ROWS) * ROWS * LD + (r % ROWS) * LD;
    if (r < in) {
      bulk_row<W>(d, src + (long long)(row0 + r) * rs, bar);
    } else {
      for (int e = 0; e < W; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the warp's copies on `bar` are all issued: lane 0 arrives with their
// bytes (the count may go below zero while copies land before it); the
// lanes' stores before any later bulk copy into the same bytes, and
// before the arrival that releases them
__device__ __forceinline__ void warp_commit(uint32_t bar, uint32_t& bytes,
                                            int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
  bytes = 0u;
}

// the next phase of barrier i (bit i of `phase`) has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t& phase,
                                         int i) {
  hopper::mbar_wait(bar, (phase >> i) & 1u);
  phase ^= 1u << i;
}

// the consumers' own barrier (named barrier 1, 256 threads): the
// producer warpgroup never joins it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The consumers hand a tile back to the producer warp: named barrier 2,
// the 256 consumers arriving, the producer warp's 32 threads waiting
__device__ __forceinline__ void handoff_arrive() {
  asm volatile("bar.arrive 2, 288;\n" ::: "memory");
}

__device__ __forceinline__ void handoff_wait() {
  asm volatile("bar.sync 2, 288;\n" ::: "memory");
}

// one arrival of the warp on `bar`, after every lane's accesses before
// it (a consumer warp done with a walked tile, a producer warp's stores)
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

}  // namespace flash_bulk
