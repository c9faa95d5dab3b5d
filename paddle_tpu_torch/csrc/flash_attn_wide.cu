// Flash attention above head_dim 256 for Hopper (sm_90a) in float32: the
// forward, dQ and dK/dV kernels at any head_dim D that is a multiple of
// 256 above it (ops/flash_attention.py's kernel_head_dim pads 257 and up
// to the next one). The bf16 forward, dQ and dK/dV run on the tensor
// cores in flash_attn_wgwide.cu (ops/flash_attention.py's _kernel_entry
// sends them there), so this file builds f32 only: tensor cores would
// change the f32 kernels' rounding.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (:175),
// `_dq_kernel` (:283) and `_dkv_kernel` (:319) at the head_dims the
// Pallas wrapper pads above 256 (pallas_kernels.py:486-493 pads any
// head_dim to a multiple of 128 and runs it). The same function as the
// kernels at 64, 128 and 256: the key bound `col < sk`, the query bound
// `row < sq`, the causal rule `row >= col` (top-left), masking with
// -1e30, l_safe = max(l, 1e-30), lse = m + log(l_safe), dropout from the
// shared Philox keep bits of philox.cuh (seed, b*n + head, row, col),
// which do not depend on D, l summing the un-dropped probabilities.
//
// Why a design of its own. flash_attn_d256.cu holds [32 x 256] f32 tiles
// in shared memory (three or four of them, 104 to 142 KB a CTA); the same
// tiles at 512 or 1024 columns no longer fit the 227 KB an SM gives a
// CTA. Here shared memory does not grow with D: the output's head_dim is
// split in 256-wide chunks, a CTA per (row block, chunk).
//  * The forward (fwd_wide): a CTA owns 32 query rows and one chunk of
//    O; the scores Q K^T, a product over the whole head_dim, are summed
//    chunk by chunk through the same [32 x 256] tiles (the chunk loop ends
//    on the CTA's own chunk), so every chunk's CTA computes them again;
//    each keeps the online softmax of its own chunk (the same m and l in
//    every CTA), and chunk 0 writes the lse. Tiles, threads and the FFMA
//    products are flash_ffma.cuh's, as in flash_attn_d256.cu.
//  * The backward (dq_wide, dkv_wide): the D / 256 chunk CTAs of a
//    32-row block (query rows for dQ, keys for dK/dV) run as one
//    thread-block cluster. Each CTA keeps its own chunk of the block's
//    operands in shared memory for the whole walk (Q and dO, or K and V)
//    and reads only its own chunk of the walked ones (K and V, or Q and
//    dO), in steps of two 32-row tiles. It computes S and dP over its
//    chunk only; the cluster sums the CTAs' partial tiles in distributed
//    shared memory, in rank order, so every CTA applies a bit-identical
//    softmax, dropout and dS, then accumulates its chunk of dQ (or dK
//    and dV). So the grid does the 3 (dQ) and 4 (dK/dV) products of the
//    bound, not the 2 nc + 1 and 2 nc + 2 of a CTA that sums the scores
//    itself. delta = rowsum(dO * O) is summed the same way, and the dQ
//    cluster's rank 0 writes it. Above 8 chunks (the portable cluster
//    size) a CTA owns ceil(nc / 8) of them and walks once per owned
//    chunk, copying its tiles as it goes.
//  * Its CTA: two consumer warpgroups and a producer warp, whose bulk
//    copies (a row each, counted on mbarriers) bring a walked tile as
//    soon as the consumers are done with the tile's last one. The
//    cluster barrier on one tile's partials waits behind the other
//    tile's products, and releases only the CTA's shared memory (a full
//    release is a GPU-wide fence at every barrier).
//  * The products are FFMA, exact to the rounding of FP32 FMAs (no
//    tensor cores: TF32 would change the f32 kernels' rounding): a
//    thread's 4x4 block of S or dP (8 float4 shared loads for 64 FMAs,
//    over half the chunk's columns), its 4x8 block of dQ (3 for 32) or
//    8x8 block of dK or dV (4 for 64).
// No atomics, so the gradients are the same from run to run. What
// bounds the backward on the card: one CTA an SM (its tiles take 219 and
// 227 KB), its 8 consumer warps through the same phases, so the
// products run at about half the FP32 rate and the cluster's sums and
// barriers show in its time beside them (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ffma.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

struct WideArgs {
  const void *q, *k, *v, *o, *dout;
  void* out;     // the forward's O, [b, sq, n, D] contiguous
  float* lse;
  float* delta;  // written by dq_wide's chunk 0, read by dkv_wide
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int n_heads, sq, sk, nc;  // nc = D / 256 chunks
  float scale;
  DropParams dp;
};

// the chunk of the i-th pass of a chunk loop that ends on chunk z
__device__ __forceinline__ int chunk_of(int i, int z, int nc) {
  return (z + 1 + i) % nc;
}

// ---------------------------------------------------------------- forward

template <typename T, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads) fwd_wide(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* Qs = reinterpret_cast<float*>(smem_f);  // q * scale, one chunk
  float* Ks = Qs + kTile;
  float* Vs = Ks + kTile;  // the CTA's own chunk of V
  float* Ps = Vs + kTile;  // [kT][kPLd] dropout(p)

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = blockIdx.y * kT;
  const int z = blockIdx.z, nc = a.nc;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int sq = a.sq, sk = a.sk;
  const DropParams dp = drop_params<DROP>(a.dp);
  const T* qb = static_cast<const T*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const T* vb = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.n;

  float acc[2][16], m[2], lpart[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNeg;
    lpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(CAUSAL, sk, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int i = 0; i < nc; ++i) {
      const int cc = chunk_of(i, z, nc);
      __syncthreads();  // the last pass's (or tile's) reads are done
      load_rows(Qs, qb + cc * kD, a.qs.s, q0, sq, a.scale, tid);
      load_rows(Ks, kb + cc * kD, a.ks.s, k0, sk, 1.f, tid);
      if (i == 0) load_rows(Vs, vb + z * kD, a.vs.s, k0, sk, 1.f, tid);
      __syncthreads();
      scores_add(s, Qs, r, Ks, c);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + 2 * r + i;
      bool ok[2];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + 2 * c + j;
        ok[j] = col < sk && (!CAUSAL || row >= col);
        s[i][j] = ok[j] ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      lpart[i] = lpart[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] *= corr;
    }
    if (DROP) {
      const int row = q0 + 2 * r, col = k0 + 2 * c;
      const uint4 w = drop_block(dp, bh, row, col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[i][j] = drop_keep(dp, w, row + i, col + j) ? s[i][j] * dp.rinv
                                                       : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) Ps[(2 * r + i) * kPLd + 2 * c + j] = s[i][j];
    __syncthreads();
    accumulate(acc, Ps, r, Vs, c);
  }

  const long long d_all = (long long)nc * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lpart[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float l_safe = fmaxf(l, 1e-30f);
    const int row = q0 + 2 * r + i;
    if (row < sq) {
      T* orow = static_cast<T*>(a.out) +
                ((long long)(bi * sq + row) * a.n_heads + hi) * d_all +
                z * kD;
      store_row(orow, acc[i], c, 1.f / l_safe);
      if (z == 0 && c == 0)
        a.lse[(long long)bh * sq + row] = m[i] + logf(l_safe);
    }
  }
}

// ------------------------------------------------- the backward's cluster

// The chunk CTAs of one row block run as a thread-block cluster of
// cl.size CTAs, each owning cl.chunks consecutive 256-wide chunks
// (cluster_of).
struct Cluster {
  int size, chunks;
};

constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kCT = 32;          // rows of a resident tile, of a walked one
constexpr int kWT = 2 * kCT;     // walked rows of a step: two tiles
constexpr int kCLd = kD + 4;     // row stride of a [kCT x kD] tile
constexpr int kCTile = kCT * kCLd;
constexpr int kSLd = kCT;        // row stride of a step's score tiles
constexpr int kSStep = kWT * kSLd;
// the backward's CTA: two consumer warpgroups (the products, the
// cluster's sums, dS) and a producer warpgroup, whose first warp issues
// the walked tiles' copies; setmaxnreg moves the producers' registers to
// the consumers, within the pool __launch_bounds__(384, 1) gives every
// thread at launch (168): asking for more would spin in the allocation
constexpr int kWThreads = 384, kConsumers = 256;
constexpr int kProdRegs = 40, kConsRegs = 232;
static_assert((kWThreads - kConsumers) * kProdRegs + kConsumers * kConsRegs <=
                  168 * kWThreads,
              "the warpgroups' registers exceed the CTA's pool");
// two resident tiles, four walked ones (two of each walked operand), a
// step's partial S and dP, its dS (and in dK/dV its dropout(P)), and in
// dQ each row's partial delta
constexpr size_t kDqCSmem = (6 * kCTile + 3 * kSStep + kCT) * sizeof(float);
constexpr size_t kDkvCSmem = (6 * kCTile + 4 * kSStep) * sizeof(float);
static_assert(kDqCSmem <= 232448 && kDkvCSmem <= 232448,
              "a CTA takes at most 227 KB of shared memory");

Cluster cluster_of(int nc) {
  const int per = (nc + kMaxCluster - 1) / kMaxCluster;
  return Cluster{(nc + per - 1) / per, per};
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the cluster barrier in two halves: writes to shared memory before a
// thread's arrive are seen by the cluster's reads after its wait
__device__ __forceinline__ void cluster_arrive() {
  // the release restricted to this CTA's shared memory (what the cluster
  // reads): a release of the whole memory, barrier.cluster.arrive.release,
  // waits for a GPU-wide fence at every barrier
  asm volatile(
      "fence.release.sync_restrict::shared::cta.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the generic address of *p in the shared memory of the cluster's CTA
// `rank` (distributed shared memory)
__device__ __forceinline__ const float* at_rank(const float* p, int rank) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// one row of a chunk (kD floats, 16-byte aligned) into shared memory by
// the bulk copy engine, its bytes counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(kD * (int)sizeof(float)), "r"(bar)
      : "memory");
}

// The CTA's mbarriers, each in the padding of a row of a resident tile
// (its columns kD to kD + 3, which no copy, product or store touches):
// full[t] (the walked tile t of the step has landed: the producer warp's
// copies), misc (the consumers' own copies), empty[t] (every consumer
// warp is done with walked tile t).
struct Bars {
  uint32_t base;
  __device__ __forceinline__ explicit Bars(float* tile)
      : base(hopper::smem_u32(tile + kD)) {}
  __device__ __forceinline__ uint32_t at(int i) const {
    return base + i * kCLd * (uint32_t)sizeof(float);
  }
  __device__ __forceinline__ uint32_t full(int t) const { return at(t); }
  __device__ __forceinline__ uint32_t misc() const { return at(2); }
  __device__ __forceinline__ uint32_t empty(int t) const { return at(3 + t); }
  // thread 0, before any use: full and misc count one arrival (with the
  // bytes of their copies), empty one a consumer warp
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(at(i), 1);
    for (int t = 0; t < 2; ++t) hopper::mbar_init(empty(t), kConsumers / 32);
    hopper::mbar_fence_init();
  }
};

// Copies issued by one warp: `tiles` kCT-row tiles of a 256-wide chunk
// from row0 (row stride rs elements, every row 16-byte aligned: vec_ok)
// into dst, dst + kCTile, ... (dst[row * kCLd + d]), a bulk copy a row
// counted in bytes on `bar`; rows at or past `limit` are zero-filled by
// stores. `bytes` sums what the copies will count.
__device__ __forceinline__ void warp_load(uint32_t bar, uint32_t& bytes,
                                          float* dst, const float* src,
                                          long long rs, int row0, int limit,
                                          int lane, int tiles = 1) {
  const int rows = tiles * kCT;
  const int in = max(0, min(rows, limit - row0));
  bytes += in * kD * (uint32_t)sizeof(float);
  for (int r = lane; r < rows; r += 32) {
    float* d = dst + (r / kCT) * kCTile + (r % kCT) * kCLd;
    if (r < in) {
      bulk_row(d, src + (long long)(row0 + r) * rs, bar);
    } else {
      for (int e = 0; e < kD; e += 4)
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

// s[i][j] = A[4a + i] . B[b + 8j] over the columns 8t + 4h + e of a
// chunk (h: which half of them), rows of [kCT][kCLd] tiles: 8 float4
// loads for 64 FMAs, each conflict-free (A broadcast over b) or in the
// two wavefronts its 16 addresses need (B)
__device__ __forceinline__ void score_half(float s[4][4], const float* A,
                                           const float* B, int a, int b,
                                           int h) {
  const float* pa = A + 4 * a * kCLd + 4 * h;
  const float* pb = B + b * kCLd + 4 * h;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int t = 0; t < kD; t += 8) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(pa + i * kCLd + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(pb + 8 * j * kCLd + t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
}

// acc[i][e] += X[kk][4a + i] * B[kk][4b + e] and acc[i][4 + e] +=
// X[kk][4a + i] * B[kk][128 + 4b + e] over the kCT rows kk of a
// [kCT][kSLd] score tile X and of a [kCT][kCLd] tile B: 3 float4 loads
// for 32 FMAs
__device__ __forceinline__ void accumulate_c(float acc[4][8], const float* X,
                                             const float* B, int a, int b) {
#pragma unroll 8
  for (int kk = 0; kk < kCT; ++kk) {
    const float4 p = ld4(X + kk * kSLd + 4 * a);
    const float4 y0 = ld4(B + kk * kCLd + 4 * b);
    const float4 y1 = ld4(B + kk * kCLd + 128 + 4 * b);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pv[i], yv[e], acc[i][e]);
  }
}

// acc[i][e] += X[kk][8a + i] * B[kk][4b + e] and acc[i][4 + e] +=
// X[kk][8a + i] * B[kk][128 + 4b + e] over the kCT rows kk: 4 float4
// loads for 64 FMAs
__device__ __forceinline__ void accumulate_8(float acc[8][8], const float* X,
                                             const float* B, int a, int b) {
#pragma unroll 4
  for (int kk = 0; kk < kCT; ++kk) {
    const float4 p0 = ld4(X + kk * kSLd + 8 * a);
    const float4 p1 = ld4(X + kk * kSLd + 8 * a + 4);
    const float4 y0 = ld4(B + kk * kCLd + 4 * b);
    const float4 y1 = ld4(B + kk * kCLd + 128 + 4 * b);
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pv[i], yv[e], acc[i][e]);
  }
}

// row i of acc times mul into out_row's columns 4b + e and 128 + 4b + e
__device__ __forceinline__ void store_c(float* out_row, const float* acc,
                                        int b, float mul) {
  *reinterpret_cast<float4*>(out_row + 4 * b) =
      make_float4(acc[0] * mul, acc[1] * mul, acc[2] * mul, acc[3] * mul);
  *reinterpret_cast<float4*>(out_row + 128 + 4 * b) =
      make_float4(acc[4] * mul, acc[5] * mul, acc[6] * mul, acc[7] * mul);
}

__device__ __forceinline__ void zero_acc(float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
}

// The consumers' parts in a walked tile (256 threads, 8 warps):
//  * scores: warps 0-3 S, warps 4-7 dP (`prod`); each thread rows
//    4 sa + i of the resident tile against rows sb + 8 j of the walked
//    one over half of the chunk's columns (sh), the halves summed by a
//    shuffle (lanes 16 apart);
//  * the cluster sum and dS: rows 2 ea, 2 ea + 1 of the resident tile
//    against rows 2 eb, 2 eb + 1 of the walked one (a Philox block);
//  * dQ's accumulation: rows 4 ua + i of the resident tile, columns
//    4 ub + e and 128 + 4 ub + e of the chunk (dK/dV's: accumulate_8's
//    8x8 blocks, warps 0-3 dV and 4-7 dK).
struct Roles {
  int prod, sa, sb, sh, ea, eb, ua, ub;
  __device__ __forceinline__ explicit Roles(int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    prod = warp >> 2;
    sh = lane >> 4;
    sa = 2 * (warp & 3) + ((lane >> 3) & 1);
    sb = lane & 7;
    ea = tid & 15;
    eb = tid >> 4;
    ua = 4 * (warp & 1) + (lane >> 3);
    ub = 8 * (warp >> 1) + (lane & 7);
  }
};

// the chunk's product of the score thread's block, its halves summed,
// added to the CTA's partial sp (the first chunk, first == true, sets it)
__device__ __forceinline__ void score_chunk(float sp[4][4], const float* A,
                                            const float* B, const Roles& ro,
                                            bool first) {
  float s[4][4];
  score_half(s, A, B, ro.sa, ro.sb, ro.sh);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = s[i][j] + __shfl_xor_sync(0xffffffffu, s[i][j], 16);
      sp[i][j] = first ? x : sp[i][j] + x;
    }
}

// the partial into part[walked row][resident row] (a walked tile's kCT
// rows): the thread's half of its four walked rows (j = 2 sh, 2 sh + 1)
__device__ __forceinline__ void put_partial(float* part, const float sp[4][4],
                                            const Roles& ro) {
  float* p = part + ro.sb * kSLd + 4 * ro.sa;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((j >> 1) == ro.sh)
      *reinterpret_cast<float4*>(p + 8 * j * kSLd) =
          make_float4(sp[0][j], sp[1][j], sp[2][j], sp[3][j]);
}

// S and dP of a 2x2 block (s[jj]: walked row jj of the block, x and y its
// resident rows) summed over the cluster's CS CTAs in rank order, the
// same order in every CTA, so each of them holds the same bits; every
// load is issued before the first sum
template <int CS>
__device__ __forceinline__ void cluster_sum(float2 s[2], float2 dp[2],
                                            const float* ps, const float* pd,
                                            int off) {
  float2 x[CS][2], y[CS][2];
#pragma unroll
  for (int r = 0; r < CS; ++r) {
    const float* rs = at_rank(ps, r);
    const float* rd = at_rank(pd, r);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      x[r][jj] = ld2(rs + off + jj * kSLd);
      y[r][jj] = ld2(rd + off + jj * kSLd);
    }
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    s[jj] = x[0][jj];
    dp[jj] = y[0][jj];
#pragma unroll
    for (int r = 1; r < CS; ++r) {
      s[jj].x += x[r][jj].x;
      s[jj].y += x[r][jj].y;
      dp[jj].x += y[r][jj].x;
      dp[jj].y += y[r][jj].y;
    }
  }
}

// the block of walked tile t of the step (resident rows 2 ea, 2 ea + 1,
// walked rows 2 eb, 2 eb + 1 of the tile)
__device__ __forceinline__ void cluster_scores(float2 s[2], float2 dp[2],
                                               const float* ps,
                                               const float* pd, int cs,
                                               int t, const Roles& ro) {
  const int off = (kCT * t + 2 * ro.eb) * kSLd + 2 * ro.ea;
  switch (cs) {
    case 2: cluster_sum<2>(s, dp, ps, pd, off); break;
    case 3: cluster_sum<3>(s, dp, ps, pd, off); break;
    case 4: cluster_sum<4>(s, dp, ps, pd, off); break;
    case 5: cluster_sum<5>(s, dp, ps, pd, off); break;
    case 6: cluster_sum<6>(s, dp, ps, pd, off); break;
    case 7: cluster_sum<7>(s, dp, ps, pd, off); break;
    default: cluster_sum<8>(s, dp, ps, pd, off);
  }
}

// -------------------------------------------------------------------- dQ

// A cluster per 32-row query block (blockIdx.y), a CTA per chunk (or
// cl.chunks of them above 8 chunks). Q and dO of the CTA's chunk stay
// in shared memory for the whole walk. The keys go by steps of two
// 32-key tiles; the producer warp copies each tile's K and V as soon as
// the consumers are done with the tile's last ones. Each CTA sums S and
// dP over its own chunk, the cluster adds the CTAs' partials (in
// distributed shared memory, rank order), and each CTA applies the same
// softmax and dS, then dQ_z += dS K_z. The cluster barrier on a tile's
// partials waits behind the products of the other tile. delta =
// rowsum(dO * O) is summed the same way before the walk, and rank 0
// writes it for dK/dV.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWThreads, 1) dq_wide(WideArgs a,
                                                        Cluster cl) {
  extern __shared__ __align__(16) unsigned char smem_q[];
  float* Qs = reinterpret_cast<float*>(smem_q);  // resident
  float* dOs = Qs + kCTile;                      // resident
  float* Kw = dOs + kCTile;                      // the step's two K tiles
  float* Vw = Kw + 2 * kCTile;                   // and V tiles
  float* pS = Vw + 2 * kCTile;  // the CTA's partial S as [key][query]
  float* pP = pS + kSStep;      // and dP
  float* dSs = pP + kSStep;     // dS as [key][query]
  float* dpart = dSs + kSStep;  // the CTA's part of each row's delta

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  // causal: the longest walks first
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kCT;
  const int rank = (int)cluster_rank(), cs = cl.size, per = cl.chunks;
  const int c0 = rank * per, owned = min(per, a.nc - c0);
  const bool multi = per > 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = a.sq, sk = a.sk;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const Bars bars(Qs);
  if (tid == 0) bars.init();
  __syncthreads();
  const int ns = (key_tiles(CAUSAL, sk, q0) + 1) / 2;  // steps of kWT keys
  uint32_t phase = 0u, bytes = 0u;

  if (warp >= kConsumers / 32) {
    // the producer warpgroup: its first warp copies the walked tiles
    // (above 8 chunks the consumers copy their own); all of it takes its
    // part in the cluster's barriers, in the consumers' order
    hopper::regs_dec<kProdRegs>();
    const bool issuer = warp == kConsumers / 32 && !multi;
    cluster_arrive();  // delta
    cluster_wait();
    if (issuer) {
      // Q (dO is in place), then the first step's two key tiles
      warp_load(bars.full(0), bytes, Qs, qb + c0 * kD, a.qs.s, q0, sq,
                lane);
      for (int t = 0; t < 2; ++t) {
        warp_load(bars.full(t), bytes, Kw + t * kCTile, kb + c0 * kD, a.ks.s,
                  kCT * t, sk, lane);
        warp_load(bars.full(t), bytes, Vw + t * kCTile, vb + c0 * kD, a.vs.s,
                  kCT * t, sk, lane);
        warp_commit(bars.full(t), bytes, lane);
      }
    }
    for (int g = 0; g < per * ns; ++g) {
      const int k1 = (g + 1) * kWT;  // the next step's first key
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      for (int t = 0; t < 2; ++t) {
        if (issuer && g + 1 < ns) {
          bar_wait(bars.empty(t), phase, t);
          warp_load(bars.full(t), bytes, Kw + t * kCTile, kb + c0 * kD,
                    a.ks.s, k1 + kCT * t, sk, lane);
          warp_load(bars.full(t), bytes, Vw + t * kCTile, vb + c0 * kD,
                    a.vs.s, k1 + kCT * t, sk, lane);
          warp_commit(bars.full(t), bytes, lane);
        }
        if (t == 0) {
          cluster_wait();
          cluster_arrive();
        }
      }
      cluster_wait();
    }
    return;
  }

  hopper::regs_inc<kConsRegs>();
  const Roles ro(tid);
  const DropParams dp = drop_params<DROP>(a.dp);
  const float* ob = static_cast<const float*>(a.o) + bi * a.os.b + hi * a.os.n;
  const float* db =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  // delta: the CTA's chunks (O through a K tile; consumer warp 0 copies),
  // then the cluster's sum; 8 threads a row
  {
    const int row = tid >> 3, part8 = tid & 7;
    float sum = 0.f;
    for (int v = 0; v < owned; ++v) {
      const int c = c0 + v;
      if (v) consumers_sync();
      if (warp == 0) {
        warp_load(bars.misc(), bytes, dOs, db + c * kD, a.dos.s, q0, sq,
                  lane);
        warp_load(bars.misc(), bytes, Kw, ob + c * kD, a.os.s, q0, sq,
                  lane);
        warp_commit(bars.misc(), bytes, lane);
      }
      bar_wait(bars.misc(), phase, 2);
      float x = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int at = row * kCLd + g * 32 + part8 * 4;
        x = dot4(ld4(dOs + at), ld4(Kw + at), x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      sum = v ? sum + x : x;
    }
    if (part8 == 0) dpart[row] = sum;
  }
  cluster_arrive();
  cluster_wait();
  float dl[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * ro.ea + i;
    float d = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) d = r ? d + at_rank(dpart, r)[row] : at_rank(dpart, r)[row];
    dl[i] = d;
    const bool in = q0 + row < sq;
    lse_r[i] = in ? a.lse[(long long)bh * sq + q0 + row] : 0.f;
    if (rank == 0 && ro.eb == 0 && in)
      a.delta[(long long)bh * sq + q0 + row] = d;
  }

  float acc[4][8];
  for (int u = 0; u < per; ++u) {
    const int cu = c0 + u;  // the chunk this pass accumulates
    zero_acc(acc);
    for (int j = 0; j < ns; ++j) {
      const int k0 = j * kWT;
      // the partial S and dP of the step's two key tiles: the cluster's
      // barrier on the first's waits behind the second's products
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* Kt = Kw + t * kCTile;
        float* Vt = Vw + t * kCTile;
        float sp[4][4];
        if (multi) {
          for (int v = 0; v < owned; ++v) {
            const int c = c0 + v;
            consumers_sync();  // the last reads of the tiles are done
            if (warp == 0) {
              warp_load(bars.misc(), bytes, Qs, qb + c * kD, a.qs.s, q0, sq, lane);
              warp_load(bars.misc(), bytes, dOs, db + c * kD, a.dos.s, q0,
                        sq, lane);
              warp_load(bars.misc(), bytes, Kt, kb + c * kD, a.ks.s,
                        k0 + kCT * t, sk, lane);
              warp_load(bars.misc(), bytes, Vt, vb + c * kD, a.vs.s,
                        k0 + kCT * t, sk, lane);
              warp_commit(bars.misc(), bytes, lane);
            }
            bar_wait(bars.misc(), phase, 2);
            score_chunk(sp, ro.prod ? dOs : Qs, ro.prod ? Vt : Kt, ro,
                        v == 0);
          }
        } else {
          bar_wait(bars.full(t), phase, t);
          score_chunk(sp, ro.prod ? dOs : Qs, ro.prod ? Vt : Kt, ro, true);
        }
        put_partial((ro.prod ? pP : pS) + kCT * t * kSLd, sp, ro);
        if (t == 0) cluster_arrive();
      }
      // each tile: the cluster's sums and dS, then dQ_z += dS K_z, which
      // the barrier on the next tile's partials (or on every CTA having
      // read these) waits behind
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        cluster_wait();
        float2 s2[2], d2[2];
        cluster_scores(s2, d2, pS, pP, cs, t, ro);
        const int row0 = q0 + 2 * ro.ea, col0 = k0 + kCT * t + 2 * ro.eb;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (DROP) w = drop_block(dp, bh, row0, col0);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float ds[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + i, col = col0 + jj;
            const float s = i ? s2[jj].y : s2[jj].x;
            float g = i ? d2[jj].y : d2[jj].x;
            if (DROP) g = drop_keep(dp, w, row, col) ? g * dp.rinv : 0.f;
            const bool ok = link_ok(CAUSAL, row, col, sq, sk);
            const float p = ok ? expf(s * a.scale - lse_r[i]) : 0.f;
            ds[i] = p * (g - dl[i]);
          }
          st2(dSs + (kCT * t + 2 * ro.eb + jj) * kSLd + 2 * ro.ea, ds[0],
              ds[1]);
        }
        consumers_sync();
        cluster_arrive();  // this CTA has read tile t's partials
        float* Kt = Kw + t * kCTile;
        if (u < owned) {
          // the tile holds K of the CTA's last chunk
          if (multi && cu != c0 + owned - 1) {
            if (warp == 0) {
              warp_load(bars.misc(), bytes, Kt, kb + cu * kD, a.ks.s,
                        k0 + kCT * t, sk, lane);
              warp_commit(bars.misc(), bytes, lane);
            }
            bar_wait(bars.misc(), phase, 2);
          }
          accumulate_c(acc, dSs + kCT * t * kSLd, Kt, ro.ua, ro.ub);
        }
        if (!multi) {
          // this warp is done with the tile's K and V
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bars.empty(t));
        }
      }
      cluster_wait();  // every CTA has read this CTA's partials
    }
    if (u < owned) {
      float* out = static_cast<float*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n +
                   cu * kD;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ro.ua + i;
        if (row < sq)
          store_c(out + (long long)row * a.dqs.s, acc[i], ro.ub, a.scale);
      }
    }
  }
}

// ----------------------------------------------------------------- dK, dV

// A cluster per 32-key block, a CTA per chunk, as dq_wide: K and V of
// the chunk resident; the queries go by steps of two 32-row tiles, the
// producer warp copying each tile's Q and dO as soon as the consumers
// are done with the tile's last ones. The cluster sums S^T and dP^T,
// each CTA applies the same dropout and dS, then dK_z += dS^T Q_z and
// dV_z += dropout(P)^T dO_z; the cluster barrier on a tile's partials
// waits behind the other tile's products.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWThreads, 1) dkv_wide(WideArgs a,
                                                         Cluster cl) {
  extern __shared__ __align__(16) unsigned char smem_kv[];
  float* Ks = reinterpret_cast<float*>(smem_kv);  // resident
  float* Vs = Ks + kCTile;                        // resident
  float* Qw = Vs + kCTile;                        // the step's Q tiles
  float* dOw = Qw + 2 * kCTile;                   // and dO tiles
  float* pS = dOw + 2 * kCTile;  // the CTA's partial S^T as [query][key]
  float* pP = pS + kSStep;       // and dP^T
  float* Pds = pP + kSStep;      // dropout(P) as [query][key]
  float* dSs = Pds + kSStep;     // dS as [query][key]

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * kCT;
  const int rank = (int)cluster_rank(), cs = cl.size, per = cl.chunks;
  const int c0 = rank * per, owned = min(per, a.nc - c0);
  const bool multi = per > 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = a.sq, sk = a.sk;
  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const float* db =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;
  const Bars bars(Ks);
  if (tid == 0) bars.init();
  __syncthreads();
  // the first query a causal key block sees is its own first row
  const int i00 = CAUSAL ? k0 : 0;
  const int ns = sq > i00 ? (sq - i00 + kWT - 1) / kWT : 0;
  uint32_t phase = 0u, bytes = 0u;

  if (warp >= kConsumers / 32) {
    // the producer warpgroup, as in dq_wide
    hopper::regs_dec<kProdRegs>();
    const bool issuer = warp == kConsumers / 32 && !multi;
    if (issuer && ns > 0) {
      // K and V, then the first step's two query tiles
      warp_load(bars.full(0), bytes, Ks,
                static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n +
                    c0 * kD,
                a.ks.s, k0, sk, lane);
      warp_load(bars.full(0), bytes, Vs,
                static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n +
                    c0 * kD,
                a.vs.s, k0, sk, lane);
      for (int t = 0; t < 2; ++t) {
        warp_load(bars.full(t), bytes, Qw + t * kCTile, qb + c0 * kD, a.qs.s,
                  i00 + kCT * t, sq, lane);
        warp_load(bars.full(t), bytes, dOw + t * kCTile, db + c0 * kD,
                  a.dos.s, i00 + kCT * t, sq, lane);
        warp_commit(bars.full(t), bytes, lane);
      }
    }
    for (int g = 0; g < per * ns; ++g) {
      const int i1 = i00 + (g + 1) * kWT;  // the next step's first query
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      for (int t = 0; t < 2; ++t) {
        if (issuer && g + 1 < ns) {
          bar_wait(bars.empty(t), phase, t);
          warp_load(bars.full(t), bytes, Qw + t * kCTile, qb + c0 * kD,
                    a.qs.s, i1 + kCT * t, sq, lane);
          warp_load(bars.full(t), bytes, dOw + t * kCTile, db + c0 * kD,
                    a.dos.s, i1 + kCT * t, sq, lane);
          warp_commit(bars.full(t), bytes, lane);
        }
        if (t == 0) {
          cluster_wait();
          cluster_arrive();
        }
      }
      cluster_wait();
    }
    return;
  }

  hopper::regs_inc<kConsRegs>();
  const Roles ro(tid);
  const DropParams dp = drop_params<DROP>(a.dp);
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n;

  // warps 0-3 accumulate dV, warps 4-7 dK: rows 8 ra + i, columns
  // 4 cb + e and 128 + 4 cb + e
  const int out = warp >> 2, ra = lane >> 3, cb = 8 * (warp & 3) + (lane & 7);
  float acc[8][8];
  for (int u = 0; u < per; ++u) {
    const int cu = c0 + u;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int j = 0; j < ns; ++j) {
      const int i0 = i00 + j * kWT;
      // lse and delta of the thread's queries, in flight during the
      // products
      float lq[2][2], dlq[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int qi = i0 + kCT * t + 2 * ro.eb + jj;
          const bool in = qi < sq;
          lq[t][jj] = in ? a.lse[(long long)bh * sq + qi] : 0.f;
          dlq[t][jj] = in ? a.delta[(long long)bh * sq + qi] : 0.f;
        }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* Qt = Qw + t * kCTile;
        float* dOt = dOw + t * kCTile;
        float sp[4][4];
        if (multi) {
          for (int v = 0; v < owned; ++v) {
            const int c = c0 + v;
            consumers_sync();
            if (warp == 0) {
              warp_load(bars.misc(), bytes, Ks, kb + c * kD, a.ks.s, k0, sk, lane);
              warp_load(bars.misc(), bytes, Vs, vb + c * kD, a.vs.s, k0, sk, lane);
              warp_load(bars.misc(), bytes, Qt, qb + c * kD, a.qs.s,
                        i0 + kCT * t, sq, lane);
              warp_load(bars.misc(), bytes, dOt, db + c * kD, a.dos.s,
                        i0 + kCT * t, sq, lane);
              warp_commit(bars.misc(), bytes, lane);
            }
            bar_wait(bars.misc(), phase, 2);
            score_chunk(sp, ro.prod ? Vs : Ks, ro.prod ? dOt : Qt, ro,
                        v == 0);
          }
        } else {
          bar_wait(bars.full(t), phase, t);
          score_chunk(sp, ro.prod ? Vs : Ks, ro.prod ? dOt : Qt, ro, true);
        }
        put_partial((ro.prod ? pP : pS) + kCT * t * kSLd, sp, ro);
        if (t == 0) cluster_arrive();
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        cluster_wait();
        float2 s2[2], d2[2];
        cluster_scores(s2, d2, pS, pP, cs, t, ro);
        const int key0 = k0 + 2 * ro.ea, qrow0 = i0 + kCT * t + 2 * ro.eb;
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (DROP) w = drop_block(dp, bh, qrow0, key0);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float pd[2], ds[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int qi = qrow0 + jj, key = key0 + i;
            const float s = i ? s2[jj].y : s2[jj].x;
            float g = i ? d2[jj].y : d2[jj].x;
            const bool ok = link_ok(CAUSAL, qi, key, sq, sk);
            const float p = ok ? expf(s * a.scale - lq[t][jj]) : 0.f;
            pd[i] = p;
            if (DROP) {
              const bool keep = drop_keep(dp, w, qi, key);
              pd[i] = keep ? p * dp.rinv : 0.f;
              g = keep ? g * dp.rinv : 0.f;
            }
            ds[i] = p * (g - dlq[t][jj]);
          }
          const int off = (kCT * t + 2 * ro.eb + jj) * kSLd + 2 * ro.ea;
          st2(Pds + off, pd[0], pd[1]);
          st2(dSs + off, ds[0], ds[1]);
        }
        consumers_sync();
        cluster_arrive();  // this CTA has read tile t's partials
        float* Qt = Qw + t * kCTile;
        float* dOt = dOw + t * kCTile;
        if (u < owned) {
          if (multi && cu != c0 + owned - 1) {
            if (warp == 0) {
              warp_load(bars.misc(), bytes, Qt, qb + cu * kD, a.qs.s,
                        i0 + kCT * t, sq, lane);
              warp_load(bars.misc(), bytes, dOt, db + cu * kD, a.dos.s,
                        i0 + kCT * t, sq, lane);
              warp_commit(bars.misc(), bytes, lane);
            }
            bar_wait(bars.misc(), phase, 2);
          }
          accumulate_8(acc, (out ? dSs : Pds) + kCT * t * kSLd,
                       out ? Qt : dOt, ra, cb);
        }
        if (!multi) {
          // this warp is done with the tile's Q and dO
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bars.empty(t));
        }
      }
      cluster_wait();  // every CTA has read this CTA's partials
    }
    if (u < owned) {
      const Strides& os = out ? a.dks : a.dvs;
      float* ob = static_cast<float*>(out ? a.dk : a.dv) + bi * os.b +
                  hi * os.n + cu * kD;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = k0 + 8 * ra + i;
        if (key < sk)
          store_c(ob + (long long)key * os.s, acc[i], cb,
                  out ? a.scale : 1.f);
      }
    }
  }
}

// ------------------------------------------------------------- launching

enum Which { kFwd, kDq, kDkv };

template <typename Kern>
cudaError_t go_cluster(Kern kern, dim3 grid, size_t smem, cudaStream_t st,
                       const WideArgs& a, const Cluster& cl) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cl.size;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, cl);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool C, bool P>
cudaError_t launch(Which which, int bn, const WideArgs& a, const Cluster& cl,
                   cudaStream_t st) {
  if (which == kFwd)
    return go(fwd_wide<float, C, P>, dim3(bn, (a.sq + kT - 1) / kT, a.nc),
              kFwdSmem, st, a);
  if (which == kDq)
    return go_cluster(dq_wide<C, P>, dim3(bn, (a.sq + kCT - 1) / kCT, cl.size),
                      kDqCSmem, st, a, cl);
  return go_cluster(dkv_wide<C, P>, dim3(bn, (a.sk + kCT - 1) / kCT, cl.size),
                    kDkvCSmem, st, a, cl);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool rows16(const Strides& s) {
  return s.b % 4 == 0 && s.s % 4 == 0 && s.n % 4 == 0;
}

// every pointer and row of the backward's tensors 16-byte aligned, as its
// bulk copies and float4 stores need (ops/flash_attention.py's
// _kernel_input copies a tensor that is not)
bool vec_ok(const WideArgs& a) {
  const void* ps[] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  const Strides ss[] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (const Strides& s : ss)
    if (!rows16(s)) return false;
  return true;
}

// dtype 0 (float32) only
int dispatch(Which which, int dtype, int b, int d, int causal, int dropout,
             WideArgs& a, void* stream_ptr) {
  if (dtype != 0 || d <= kD || d % kD) return -1;
  if (which != kFwd && !vec_ok(a)) return (int)cudaErrorInvalidValue;
  a.nc = d / kD;
  const Cluster cl = cluster_of(a.nc);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int bn = b * a.n_heads;
#define PT_GO(C, P) launch<C, P>(which, bn, a, cl, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}

DropParams drop_args(unsigned int threshold, const void* seed, float rinv) {
  return DropParams{threshold, static_cast<const uint32_t*>(seed), 0u, 0u,
                    rinv};
}

}  // namespace

// The three entries take the arguments of pt_flash_attn_fwd,
// pt_flash_attn_bwd_dq and pt_flash_attn_bwd_dkv (flash_attn_fwd.cu,
// flash_attn_bwd.cu), for d a multiple of 256 above 256 and dtype 0
// (float32; bfloat16 is flash_attn_wgwide.cu's). Strides are element
// strides (batch, seq, head) of [b, s, n, h] tensors whose head_dim
// stride is 1; O is written contiguous [b, sq, n, d], lse f32 [b, n,
// sq]. The dQ entry computes delta = rowsum(dO * O) from o and writes it
// (as the bf16 dQ kernels do) for the dK/dV entry to read. Returns 0 on
// success, a cudaError_t code if a launch was refused, or -1 for a dtype
// / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd_wide(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  WideArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse = lse;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = drop_args(threshold, seed, rinv);
  return dispatch(kFwd, dtype, b, d, causal, dropout, a, stream_ptr);
}

extern "C" int pt_flash_attn_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int dtype,
    int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dq_sb, long long dq_ss, long long dq_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  WideArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = delta; a.dq = dq;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.os = {o_sb, o_ss, o_sn};
  a.dos = {do_sb, do_ss, do_sn}; a.dqs = {dq_sb, dq_ss, dq_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = drop_args(threshold, seed, rinv);
  return dispatch(kDq, dtype, b, d, causal, dropout, a, stream_ptr);
}

extern "C" int pt_flash_attn_bwd_dkv_wide(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long do_sb, long long do_ss, long long do_sn,
    long long dk_sb, long long dk_ss, long long dk_sn,
    long long dv_sb, long long dv_ss, long long dv_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  WideArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = drop_args(threshold, seed, rinv);
  return dispatch(kDkv, dtype, b, d, causal, dropout, a, stream_ptr);
}

