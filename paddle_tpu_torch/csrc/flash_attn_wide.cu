// Flash attention in float32 for Hopper (sm_90a) at any head_dim D that
// is a multiple of 256: the forward, dQ and dK/dV kernels
// (ops/flash_attention.py's kernel_head_dim pads 129 to 255 up to 256,
// and 257 and up to the next multiple). The bf16 kernels run on the
// tensor cores in flash_attn_wg256.cu and flash_attn_wgwide.cu
// (ops/flash_attention.py's _kernel_entry sends them there), so this
// file builds f32 only: tensor cores would change the f32 kernels'
// rounding.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (:175),
// `_dq_kernel` (:283) and `_dkv_kernel` (:319) at the head_dims the
// Pallas wrapper pads to 256 and above (pallas_kernels.py:486-493 pads
// any head_dim to a multiple of 128 and runs it). The same function
// as the kernels at 64 and 128: the key bound `col < sk`, the query
// bound `row < sq`, the causal rule `row >= col` (top-left), masking
// with -1e30, l_safe = max(l, 1e-30), lse = m + log(l_safe), dropout
// from the shared Philox keep bits of philox.cuh (seed, b*n + head, row,
// col), which do not depend on D, l summing the un-dropped
// probabilities.
//
// Why a design of its own. [32 x 256] f32 tiles of every operand of a
// row block no longer fit the 227 KB an SM gives a CTA at 512 or 1024
// columns. Here shared memory does not grow with D: the head_dim is split
// in 256-wide chunks, and the D / 256 chunk CTAs of a 32-row block run
// as one thread-block cluster (a cluster of one at D 256). Each CTA
// keeps its own chunk of the block's operands in shared memory for the
// whole walk and reads only its own chunk of the walked ones, in steps
// of two 32-row tiles. It computes its partial scores over its chunk
// only; the cluster sums the CTAs' partials in distributed shared
// memory, in rank order, so every CTA applies a bit-identical mask,
// softmax, dropout (and in the backward dS), then accumulates its own
// chunk of the output. So the grid does the bound's products (2 in the
// forward, 3 in dQ, 4 in dK/dV), not a CTA's own sum of the scores over
// every chunk (nc + 1, 2 nc + 1 and 2 nc + 2). Above 8 chunks (the
// portable cluster size) a CTA owns ceil(nc / 8) of them and walks once
// per owned chunk, copying its tiles as it goes.
//  * The forward (fwd_wide): a cluster per 32 query rows, Q of the chunk
//    resident, the keys walked. Each step: the partial S (warps 0-3 the
//    step's first key tile, 4-7 its second); the cluster barrier on it
//    waits behind the last step's P V_z; the summed S, the online
//    softmax (the same m and l in every CTA) and the keep bits; P into
//    shared memory, O_z rescaled. Rank 0 writes the lse. One producer
//    warp beside the 8 consumer warps, so each thread may hold 224
//    registers: its tiles take 201 KB.
//  * The backward (dq_wide, dkv_wide): a cluster per 32 query rows (dQ:
//    Q and dO resident, K and V walked) or per 32 keys (dK/dV: K and V
//    resident, Q and dO walked). The cluster sums S and dP (S^T and
//    dP^T); delta = rowsum(dO * O) is summed the same way, and the dQ
//    cluster's rank 0 writes it for dK/dV. Each CTA has two consumer
//    warpgroups and a producer warpgroup; the cluster barrier on one
//    tile's partials waits behind the other tile's products. At D 256
//    (one chunk, the ONE instantiations) there is no cluster barrier:
//    the consumers' named barrier orders a step's partials, and the
//    producer warp waits on nothing but the tiles' mbarriers.
//  * In both, the producer warp's bulk copies (a row each, counted on
//    mbarriers) bring a walked tile as soon as the consumers are done
//    with the tile's last one, and the cluster barrier releases only the
//    CTA's shared memory (a full release is a GPU-wide fence at every
//    barrier).
//  * The products are FFMA, exact to the rounding of FP32 FMAs (no
//    tensor cores: TF32 would change the f32 kernels' rounding): a
//    thread's 4x4 block of S or dP (8 float4 shared loads for 64 FMAs,
//    over half the chunk's columns), its 4x8 block of O (12 for 128) or
//    dQ (3 for 32), its 8x8 block of dK or dV (4 for 64).
// No atomics, so the outputs and gradients are the same from run to run.
// What bounds them on the card: one CTA an SM (its tiles take 201 to 227
// KB), its 8 consumer warps through the same phases, so the products run
// at about a third to a half of the FP32 rate and, above one chunk, the
// cluster's sums and barriers show in its time beside them (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bulk.cuh"
#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using flash::kNeg;
using flash::Strides;

constexpr int kD = 256;  // the chunk width

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

// ------------------------------------------------------------ the cluster

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ bool link_ok(bool causal, int row, int col,
                                        int sq, int sk) {
  return row < sq && col < sk && (!causal || row >= col);
}

// tiles of kCT keys a causal kCT-row query tile from q0 can see
__device__ __forceinline__ int key_tiles(bool causal, int sk, int q0) {
  const int nk = (sk + kCT - 1) / kCT;
  const int last = q0 / kCT + 1;  // q0 is a multiple of kCT
  return causal && last < nk ? last : nk;
}

// the producer warp's bulk copies and the barriers (flash_bulk.cuh), at
// the chunk's row width and a resident tile's row stride: the mbarriers
// in the padding of a resident tile's rows, a warp's copies in kCT-row
// tiles; handoff_arrive / handoff_wait (named barrier 2) give the tile
// through which the one-chunk dQ kernel's delta read O back to the
// producer warp
using flash_bulk::bar_wait;
using flash_bulk::consumers_sync;
using flash_bulk::handoff_arrive;
using flash_bulk::handoff_wait;
using flash_bulk::warp_commit;
using Bars = flash_bulk::Bars<kD, kCLd>;

__device__ __forceinline__ void warp_load(uint32_t bar, uint32_t& bytes,
                                          float* dst, const float* src,
                                          long long rs, int row0, int limit,
                                          int lane, int tiles = 1) {
  flash_bulk::warp_load<kD, kCLd, kCT>(bar, bytes, dst, src, rs, row0, limit,
                                       lane, tiles);
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
// load is issued before the first sum; a cluster of one reads its own
// shared memory
template <int CS>
__device__ __forceinline__ void cluster_sum(float2 s[2], float2 dp[2],
                                            const float* ps, const float* pd,
                                            int off) {
  float2 x[CS][2], y[CS][2];
#pragma unroll
  for (int r = 0; r < CS; ++r) {
    const float* rs = CS == 1 ? ps : at_rank(ps, r);
    const float* rd = CS == 1 ? pd : at_rank(pd, r);
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
    case 1: cluster_sum<1>(s, dp, ps, pd, off); break;
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
// writes it for dK/dV. ONE (D 256, one chunk): no cluster barrier; the
// consumers' named barrier after a step's partials stands for it, and
// the producer warp never waits on the consumers but through the tiles'
// mbarriers (and once, handoff_wait, for the tile delta read O from).
template <bool CAUSAL, bool DROP, bool ONE>
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
  const int rank = ONE ? 0 : (int)cluster_rank();
  const int cs = ONE ? 1 : cl.size, per = ONE ? 1 : cl.chunks;
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
    // part in the cluster's barriers, in the consumers' order (at one
    // chunk the other three warps leave)
    hopper::regs_dec<kProdRegs>();
    const bool issuer = warp == kConsumers / 32 && !multi;
    if (ONE) {
      if (!issuer) return;
      handoff_wait();  // delta has read O
    } else {
      cluster_arrive();  // delta
      cluster_wait();
    }
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
      if (!ONE) {
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
      }
      for (int t = 0; t < 2; ++t) {
        if (issuer && g + 1 < ns) {
          bar_wait(bars.empty(t), phase, t);
          warp_load(bars.full(t), bytes, Kw + t * kCTile, kb + c0 * kD,
                    a.ks.s, k1 + kCT * t, sk, lane);
          warp_load(bars.full(t), bytes, Vw + t * kCTile, vb + c0 * kD,
                    a.vs.s, k1 + kCT * t, sk, lane);
          warp_commit(bars.full(t), bytes, lane);
        }
        if (!ONE && t == 0) {
          cluster_wait();
          cluster_arrive();
        }
      }
      if (!ONE) cluster_wait();
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
  if (ONE) {
    handoff_arrive();
    consumers_sync();
  } else {
    cluster_arrive();
    cluster_wait();
  }
  float dl[2], lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * ro.ea + i;
    float d = 0.f;
    if (ONE) {
      d = dpart[row];
    } else {
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < cs)
          d = r ? d + at_rank(dpart, r)[row] : at_rank(dpart, r)[row];
    }
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
        if (!ONE && t == 0) cluster_arrive();
      }
      // (one chunk: every partial is read after this barrier, and written
      // again after the consumers' barrier behind the last dS)
      if (ONE) consumers_sync();
      // each tile: the cluster's sums and dS, then dQ_z += dS K_z, which
      // the barrier on the next tile's partials (or on every CTA having
      // read these) waits behind
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (!ONE) cluster_wait();
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
        if (!ONE) cluster_arrive();  // this CTA has read tile t's partials
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
      if (!ONE) cluster_wait();  // every CTA has read this CTA's partials
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
// waits behind the other tile's products. ONE (D 256) as in dq_wide.
template <bool CAUSAL, bool DROP, bool ONE>
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
  const int rank = ONE ? 0 : (int)cluster_rank();
  const int cs = ONE ? 1 : cl.size, per = ONE ? 1 : cl.chunks;
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
    if (ONE && !issuer) return;
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
      if (!ONE) {
        cluster_arrive();
        cluster_wait();
        cluster_arrive();
      }
      for (int t = 0; t < 2; ++t) {
        if (issuer && g + 1 < ns) {
          bar_wait(bars.empty(t), phase, t);
          warp_load(bars.full(t), bytes, Qw + t * kCTile, qb + c0 * kD,
                    a.qs.s, i1 + kCT * t, sq, lane);
          warp_load(bars.full(t), bytes, dOw + t * kCTile, db + c0 * kD,
                    a.dos.s, i1 + kCT * t, sq, lane);
          warp_commit(bars.full(t), bytes, lane);
        }
        if (!ONE && t == 0) {
          cluster_wait();
          cluster_arrive();
        }
      }
      if (!ONE) cluster_wait();
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
        if (!ONE && t == 0) cluster_arrive();
      }
      if (ONE) consumers_sync();  // as in dq_wide
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (!ONE) cluster_wait();
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
        if (!ONE) cluster_arrive();  // this CTA has read tile t's partials
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
      if (!ONE) cluster_wait();  // every CTA has read this CTA's partials
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

// --------------------------------------------------------------- forward

// a step's partial scores [query][key] (66: a thread's float2 of two keys
// reads two rows at once, and put_scores' scalar stores meet no bank
// twice) and its dropout(P) [query][key] (68: float4 rows for
// accumulate_pv, whose four rows a warp reads lie 4 banks apart)
constexpr int kFSLd = kWT + 2;
constexpr int kFPLd = kWT + 4;
constexpr int kFPart = kCT * kFSLd;
constexpr int kFP = kCT * kFPLd;
// the resident Q, the step's two K and two V tiles, two steps' partial
// scores and P, each row's rescale and 1 / l
constexpr size_t kFwdCSmem =
    (5 * kCTile + 2 * kFPart + 2 * kFP + 2 * kCT) * sizeof(float);
static_assert(kFwdCSmem <= 232448, "a CTA takes at most 227 KB");
// the forward's CTA: the consumers and one producer warp, so that every
// thread may hold 224 registers (65,536 over 288, in steps of 8) with no
// setmaxnreg; under the backward's 384 threads (168 each) it spilled
constexpr int kFThreads = kConsumers + 32;

// the thread's block of the partial scores into part[query][key]: query
// rows 4 sa + i, keys sb + 8 j of the step's tile `prod` (its half of
// them: j = 2 sh, 2 sh + 1)
__device__ __forceinline__ void put_scores(float* part, const float sp[4][4],
                                           const Roles& ro) {
  float* p = part + 4 * ro.sa * kFSLd + kCT * ro.prod + ro.sb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((j >> 1) == ro.sh) p[i * kFSLd + 8 * j] = sp[i][j];
}

// s[i]: rows 2 r + i, keys kCT t + 2 c and + 1 of the step's tile t,
// summed over the cluster's CS CTAs in rank order (the same order in
// every CTA, so each holds the same bits; every load issued before the
// first sum); a cluster of one reads its own shared memory
template <int CS>
__device__ __forceinline__ void fwd_sum(float2 s[2], const float* part,
                                        int off) {
  float2 x[CS][2];
#pragma unroll
  for (int k = 0; k < CS; ++k) {
    const float* src = CS == 1 ? part : at_rank(part, k);
#pragma unroll
    for (int i = 0; i < 2; ++i) x[k][i] = ld2(src + off + i * kFSLd);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s[i] = x[0][i];
#pragma unroll
    for (int k = 1; k < CS; ++k) {
      s[i].x += x[k][i].x;
      s[i].y += x[k][i].y;
    }
  }
}

// the thread's scores of the step, tile by tile: s[t][i]
__device__ __forceinline__ void fwd_scores(float2 s[2][2], const float* part,
                                           int cs, int r, int c) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int off = 2 * r * kFSLd + kCT * t + 2 * c;
    switch (cs) {
      case 1: fwd_sum<1>(s[t], part, off); break;
      case 2: fwd_sum<2>(s[t], part, off); break;
      case 3: fwd_sum<3>(s[t], part, off); break;
      case 4: fwd_sum<4>(s[t], part, off); break;
      case 5: fwd_sum<5>(s[t], part, off); break;
      case 6: fwd_sum<6>(s[t], part, off); break;
      case 7: fwd_sum<7>(s[t], part, off); break;
      default: fwd_sum<8>(s[t], part, off);
    }
  }
}

// acc[i][e] += P[a + 8i][kk] * V[kk][4b + e] and acc[i][4 + e] +=
// P[a + 8i][kk] * V[kk][128 + 4b + e] over the kCT keys kk of a tile:
// P from its tile's first column, V a [kCT][kCLd] tile; 12 float4 loads
// for 128 FMAs
__device__ __forceinline__ void accumulate_pv(float acc[4][8], const float* P,
                                              const float* V, int a, int b) {
#pragma unroll 2
  for (int kk = 0; kk < kCT; kk += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p = ld4(P + (a + 8 * i) * kFPLd + kk);
      pv[i][0] = p.x;
      pv[i][1] = p.y;
      pv[i][2] = p.z;
      pv[i][3] = p.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 y0 = ld4(V + (kk + k) * kCLd + 4 * b);
      const float4 y1 = ld4(V + (kk + k) * kCLd + 128 + 4 * b);
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[i][e] = fmaf(pv[i][k], yv[e], acc[i][e]);
    }
  }
}

// A cluster per 32-row query block (blockIdx.y), a CTA per 256-wide
// chunk (cl.chunks of them above 8 chunks; a cluster of one at D 256).
// The CTA's chunk of Q stays in shared memory; the keys go by steps of
// two 32-key tiles, the producer warp copying the step's K tiles as soon
// as the consumers are done with the last step's and its V tiles as soon
// as they have accumulated the last step's. Each step: the CTA's partial
// scores over its chunk (warps 0-3 the step's first tile, 4-7 its
// second); the cluster barrier on them waits behind the products of the
// last step's P V_z; the cluster's sum in rank order, so every CTA
// applies the same mask, online softmax (m, l) and keep bits; P into
// shared memory, and O_z rescaled. Two buffers of partials and of P let
// one cluster barrier a step do: a buffer is written again two steps
// later, after every CTA's next arrival. Rank 0 writes the lse.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kFThreads, 1) fwd_wide(WideArgs a,
                                                         Cluster cl) {
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* Qs = reinterpret_cast<float*>(smem_f);  // resident
  float* Kw = Qs + kCTile;                       // the step's two K tiles
  float* Vw = Kw + 2 * kCTile;                   // and V tiles
  float* part = Vw + 2 * kCTile;  // two steps' partial scores
  float* Ps = part + 2 * kFPart;  // two steps' dropout(P)
  float* rowc = Ps + 2 * kFP;     // each row's rescale, then 1 / l

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
  // full(0): the step's K tiles (and Q) have landed, full(1) its V
  // tiles; empty(0), empty(1): every consumer warp is done with them
  const Bars bars(Qs);
  if (tid == 0) bars.init();
  __syncthreads();
  const int ns = (key_tiles(CAUSAL, sk, q0) + 1) / 2;  // steps of kWT keys
  uint32_t phase = 0u, bytes = 0u;

  if (warp >= kConsumers / 32) {
    // the producer warp copies the tiles (above 8 chunks the consumers
    // copy their own) and takes its part in the cluster's barriers, one a
    // step and one at the end
    if (!multi) {
      warp_load(bars.full(0), bytes, Qs, qb + c0 * kD, a.qs.s, q0, sq, lane);
      warp_load(bars.full(0), bytes, Kw, kb + c0 * kD, a.ks.s, 0, sk, lane,
                2);
      warp_commit(bars.full(0), bytes, lane);
      warp_load(bars.full(1), bytes, Vw, vb + c0 * kD, a.vs.s, 0, sk, lane,
                2);
      warp_commit(bars.full(1), bytes, lane);
    }
    for (int g = 0; g < per * ns; ++g) {
      if (!multi && g + 1 < ns) {
        bar_wait(bars.empty(0), phase, 0);
        warp_load(bars.full(0), bytes, Kw, kb + c0 * kD, a.ks.s,
                  (g + 1) * kWT, sk, lane, 2);
        warp_commit(bars.full(0), bytes, lane);
      }
      cluster_arrive();
      if (!multi && g > 0) {
        bar_wait(bars.empty(1), phase, 1);
        warp_load(bars.full(1), bytes, Vw, vb + c0 * kD, a.vs.s, g * kWT,
                  sk, lane, 2);
        warp_commit(bars.full(1), bytes, lane);
      }
      cluster_wait();
    }
    cluster_arrive();
    cluster_wait();
    return;
  }

  const Roles ro(tid);
  const DropParams dp = drop_params<DROP>(a.dp);
  // the softmax's thread: rows 2 r, 2 r + 1, keys 2 c, 2 c + 1 of each
  // of the step's tiles (a Philox block); the 16 lanes of a half-warp
  // share its rows
  const int r = tid >> 4, c = tid & 15;
  float acc[4][8], m[2], lpart[2];
  int g = 0;  // the step, over every pass
  for (int u = 0; u < per; ++u) {
    const int cu = c0 + u;  // the chunk this pass accumulates
    const bool mine = u < owned;
    zero_acc(acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNeg;
      lpart[i] = 0.f;
    }
    for (int j = 0; j < ns; ++j, ++g) {
      const int k0 = j * kWT;
      float* pw = part + (g & 1) * kFPart;
      // the CTA's partial scores of the step
      float* Kt = Kw + ro.prod * kCTile;
      float sp[4][4];
      if (multi) {
        for (int v = 0; v < owned; ++v) {
          const int cc = c0 + v;
          consumers_sync();  // the last reads of Q and K are done
          if (warp == 0) {
            warp_load(bars.misc(), bytes, Qs, qb + cc * kD, a.qs.s, q0, sq,
                      lane);
            warp_load(bars.misc(), bytes, Kw, kb + cc * kD, a.ks.s, k0, sk,
                      lane, 2);
            warp_commit(bars.misc(), bytes, lane);
          }
          bar_wait(bars.misc(), phase, 2);
          score_chunk(sp, Qs, Kt, ro, v == 0);
        }
      } else {
        bar_wait(bars.full(0), phase, 0);
        score_chunk(sp, Qs, Kt, ro, true);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bars.empty(0));
      }
      put_scores(pw, sp, ro);
      cluster_arrive();
      // the last step's P V_z, behind which the barrier waits
      if (j > 0 && mine) {
        if (!multi) bar_wait(bars.full(1), phase, 1);
        const float* P = Ps + ((g - 1) & 1) * kFP;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          accumulate_pv(acc, P + kCT * t, Vw + t * kCTile, ro.ua, ro.ub);
        if (!multi) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(bars.empty(1));
        }
      }
      cluster_wait();
      // the cluster's scores, the mask, the online softmax and dropout
      float2 s2[2][2];
      fwd_scores(s2, pw, cs, r, c);
      float* P = Ps + (g & 1) * kFP;
      // the keep bits of the thread's links: bit 4 t + 2 i + jj for row
      // 2 r + i, key kCT t + 2 c + jj
      uint32_t keep = 0u;
      if (DROP) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int row0 = q0 + 2 * r, col0 = k0 + kCT * t + 2 * c;
          const uint4 w = drop_block(dp, bh, row0, col0);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              if (drop_keep(dp, w, row0 + i, col0 + jj))
                keep |= 1u << (4 * t + 2 * i + jj);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + 2 * r + i;
        float x[4];
        bool ok[4];
        float mx = kNeg;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + kCT * (e >> 1) + 2 * c + (e & 1);
          ok[e] = col < sk && (!CAUSAL || row >= col);
          const float2 v2 = s2[e >> 1][i];
          x[e] = ok[e] ? ((e & 1) ? v2.y : v2.x) * a.scale : kNeg;
          mx = fmaxf(mx, x[e]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = ok[e] ? expf(x[e] - m_new) : 0.f;
          ps += x[e];
          if (DROP)
            x[e] = (keep >> (4 * (e >> 1) + 2 * i + (e & 1))) & 1u
                       ? x[e] * dp.rinv
                       : 0.f;
        }
        lpart[i] = lpart[i] * corr + ps;
        m[i] = m_new;
#pragma unroll
        for (int t = 0; t < 2; ++t)
          st2(P + (2 * r + i) * kFPLd + kCT * t + 2 * c, x[2 * t],
              x[2 * t + 1]);
        if (c == 0) rowc[2 * r + i] = corr;
      }
      consumers_sync();
      // O_z rescaled to the step's m
      if (mine) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float corr = rowc[ro.ua + 8 * i];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
        }
        if (multi) {
          // the step's V tiles of the chunk this pass accumulates (the
          // last step's are read: the consumers' barrier above)
          if (warp == 0) {
            warp_load(bars.misc(), bytes, Vw, vb + cu * kD, a.vs.s, k0, sk,
                      lane, 2);
            warp_commit(bars.misc(), bytes, lane);
          }
          bar_wait(bars.misc(), phase, 2);
        }
      }
    }
    // the last step's P V_z, then O_z / l
    if (mine) {
      if (!multi) bar_wait(bars.full(1), phase, 1);
      const float* P = Ps + ((g - 1) & 1) * kFP;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        accumulate_pv(acc, P + kCT * t, Vw + t * kCTile, ro.ua, ro.ub);
    }
    float linv[2], lse_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = lpart[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      const float l_safe = fmaxf(l, 1e-30f);
      linv[i] = 1.f / l_safe;
      lse_r[i] = m[i] + logf(l_safe);
    }
    consumers_sync();  // every thread has read the last rescales
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + 2 * r + i;
        rowc[2 * r + i] = linv[i];
        if (rank == 0 && u == 0 && row < sq)
          a.lse[(long long)bh * sq + row] = lse_r[i];
      }
    }
    consumers_sync();
    if (mine) {
      float* out = static_cast<float*>(a.out) + cu * kD;
      const long long d_all = (long long)a.nc * kD;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ro.ua + 8 * i;
        if (row < sq)
          store_c(out + ((long long)(bi * sq + row) * a.n_heads + hi) * d_all,
                  acc[i], ro.ub, rowc[ro.ua + 8 * i]);
      }
    }
    // (the next pass writes the rows' values after its first cluster
    // barrier, which every thread reaches after these reads)
  }
  // no CTA leaves while the cluster may read its partials
  cluster_arrive();
  cluster_wait();
}

// ------------------------------------------------------------- launching

enum Which { kFwd, kDq, kDkv };

template <typename Kern>
cudaError_t go_cluster(Kern kern, dim3 grid, int threads, size_t smem,
                       cudaStream_t st, const WideArgs& a, const Cluster& cl) {
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
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, cl);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ONE: the backward at one chunk (D 256), with no cluster barrier
template <bool C, bool P, bool ONE>
cudaError_t launch(Which which, int bn, const WideArgs& a, const Cluster& cl,
                   cudaStream_t st) {
  if (which == kFwd)
    return go_cluster(fwd_wide<C, P>,
                      dim3(bn, (a.sq + kCT - 1) / kCT, cl.size), kFThreads,
                      kFwdCSmem, st, a, cl);
  if (which == kDq)
    return go_cluster(dq_wide<C, P, ONE>,
                      dim3(bn, (a.sq + kCT - 1) / kCT, cl.size), kWThreads,
                      kDqCSmem, st, a, cl);
  return go_cluster(dkv_wide<C, P, ONE>,
                    dim3(bn, (a.sk + kCT - 1) / kCT, cl.size), kWThreads,
                    kDkvCSmem, st, a, cl);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool rows16(const Strides& s) {
  return s.b % 4 == 0 && s.s % 4 == 0 && s.n % 4 == 0;
}

// every pointer and row of the tensors 16-byte aligned, as the bulk
// copies and float4 stores need (ops/flash_attention.py's _kernel_input
// copies a tensor that is not)
bool vec_ok(const WideArgs& a) {
  const void* ps[] = {a.q, a.k, a.v, a.o, a.dout, a.out, a.dq, a.dk, a.dv};
  for (const void* p : ps)
    if (!aligned16(p)) return false;
  const Strides ss[] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (const Strides& s : ss)
    if (!rows16(s)) return false;
  return true;
}

// dtype 0 (float32) only, every multiple of 256 (a cluster of one at
// 256)
int dispatch(Which which, int dtype, int b, int d, int causal, int dropout,
             WideArgs& a, void* stream_ptr) {
  if (dtype != 0 || d < kD || d % kD) return -1;
  if (!vec_ok(a)) return (int)cudaErrorInvalidValue;
  a.nc = d / kD;
  const Cluster cl = cluster_of(a.nc);
  const bool one = a.nc == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int bn = b * a.n_heads;
#define PT_GO(C, P) (one ? launch<C, P, true>(which, bn, a, cl, st) \
                         : launch<C, P, false>(which, bn, a, cl, st))
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
// flash_attn_bwd.cu), for d a multiple of 256 and dtype 0 (float32;
// bfloat16 is flash_attn_wg256.cu's and flash_attn_wgwide.cu's). Strides are element
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

