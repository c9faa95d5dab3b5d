// Flash attention at head_dim 256 in bf16 on Hopper's tensor cores
// (sm_90a): the forward (O and lse), the dQ kernel (dQ and delta) and
// the dK/dV kernel, on the warp-specialised wgmma pipeline of
// flash_wgmma.cuh.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (:175),
// `_dq_kernel` (:283) and `_dkv_kernel` (:319) at the head_dims the
// Pallas wrapper pads to 256 (:486-493; ops/flash_attention.py's
// kernel_head_dim pads 129-255 to 256), in bf16. The same function as
// fwd_wgmma, dq_wgmma and dkv_wgmma at 64 and 128 (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the key bound `col < sk`,
// the query bound `row < sq`, the top-left causal rule `row >= col`
// (k-tiles above a warpgroup's rows skipped), masking with -1e30,
// `l_safe = max(l, 1e-30)`, lse = m + log(l_safe); dropout from
// philox.cuh's keep bits of (seed, b*n + head, row, col) with the seed
// read from device memory, l summing the un-dropped probabilities and
// the kept ones scaled by 1/(1-p); dQ = sum_j dS K * scale with dS =
// P * (keep * dP / (1-p) - delta) and P recomputed from lse; dV = sum_i
// dropout(P)^T dO and dK = sum_i dS^T Q * scale, with the delta the dQ
// kernel wrote. q, k, v and dO are read as strided [b, s, n, h] views
// through TMA tensor maps, with no copy. The f32 kernels at 256 are
// flash_attn_wide.cu's.
//
// What bounds it on an H100. At b 8, s 1024, n 8, h 256 the forward does
// 4 b n s^2 h = 68.7 GFLOP against 4 b s n h x 2 bytes (134 MB): 0.0695
// ms at 989 TFLOP/s, 0.040 ms at 3.35 TB/s, so it is bound by
// operations; dQ does 3 such products (0.104 ms) and dK/dV 4 (0.139 ms)
// against about 1.5 times the bytes, bound by operations too.
//
// Where the 64/128 design breaks at 256, and what this one does.
//  * Shared memory. A 128-row tile over head_dim 256 is 64 KB (4
//    swizzled 64-column TMA boxes, as 128 takes 2), so the two owned Q
//    buffers and the 2-stage ring of 64-row K and V tiles of fwd_wgmma
//    (265 KB) do not fit the 227 KB a CTA may use. Here a CTA has one
//    owned buffer: the next work item's tiles load once both consumer
//    warpgroups have finished their last product that reads them, under
//    the item's last products and its epilogue.
//    Forward: Q 65,536 bytes, a ring of 2 stages of 64-row K and V tiles
//    131,072, keep words 2,048, barriers 64 and 1,024 of alignment:
//    199,744 of 232,448. dQ: Q and dO 131,072, a ring of 2 stages of
//    32-row K and V tiles 65,536 (64-row tiles fit one stage only; 3
//    stages of 32 rows come to 234,576), keep words 2,048, lse and delta
//    of the 128 rows 1,024, barriers 64 and alignment 1,024: 200,768.
//  * Registers. O (and dQ), [64 x 256] f32 in each consumer warpgroup,
//    is 128 registers a thread, so Q cannot also stay in registers as
//    wgmma A fragments (64 more, as fwd_wgmma keeps them at 64 and 128):
//    S = Q K^T runs with both operands in shared memory (wgmma_ss), as
//    the backward's S does. Forward: S [64 x 64] is 32 registers and P
//    16, packed to bf16 A fragments as it is computed, with no f32 copy;
//    a tile's S waits for the last tile's O += P V (fwd_wgmma's overlap
//    of the two would hold a second S and P, 48 more), and the two
//    consumer warpgroups' products interleave on the tensor cores
//    instead. O += P V is 4 m64n64k16 (one a 64-column half of V) per
//    16 keys, A = P from registers, V read MN-major. dQ: S and dP
//    [64 x 32] as m64n32k16 over the 16 k-steps of head_dim (16
//    registers each), dS packed to 8, dQ += dS K as 4 m64n64k16 per 16
//    keys with K read MN-major.
//  * The register split: the producer warpgroup keeps 56 registers a
//    thread and the two consumer warpgroups take 224 (setmaxnreg): 56 x
//    128 + 224 x 256 = 64,512, the pool __launch_bounds__(384, 1) gives
//    the CTA (168 a thread). The producer's 128 threads still compute
//    each stage's Philox keep bits (keep_words, 16 Philox calls a
//    thread pair and 64-key stage in the forward, 8 a 32-key stage in
//    dQ) and, in dQ, lse * log2(e) and delta = rowsum(dO * O) in f32 of
//    the item's 128 rows, which dQ uses and writes to [b, n, sq] for
//    dkv_wg256 to read.
//  * dK/dV. dkv_wgmma keeps dK and dV of 64 keys in one consumer
//    warpgroup: at 256 that is two [64 x 256] f32 accumulators, 256
//    registers a thread. Here both consumer warpgroups own the same 64
//    keys (a CTA's K and V, 65,536 bytes, one buffer): warpgroup 0
//    accumulates dV += dropout(P)^T dO, warpgroup 1 dK += dS^T Q, 128
//    registers each. Per 32-query tile each computes S^T = K Q^T
//    itself (m64n32k16 over the 16 k-steps of head_dim), warpgroup 1
//    also dP^T = V dO^T; P^T, or dS^T, is packed to bf16 A fragments
//    and the product into the accumulator is 4 m64n64k16 per 16
//    queries with dO or Q read MN-major. That is 5 products a tile
//    against the 4 the function needs (S^T twice). Handing P^T from
//    warpgroup 0 to 1 through shared memory instead (4 products, a
//    barrier a tile, 3 ring stages to make room) measured 5-7% slower
//    on an H100 at b 8, s 1024, n 8 and 16 (PERF.md): warpgroup
//    1 then waits for warpgroup 0's S^T and exponentials on every tile,
//    where it ran its own S^T beside them. A 4-stage
//    ring of 32-row Q and dO tiles (131,072 bytes), the stage's keep
//    words (one warpgroup's: both read the same bits), lse and delta
//    of its 32 queries: 202,848 bytes. The producer's 128 threads
//    compute the keep bits, 4 Philox calls each a stage (with 64
//    threads at 8 calls, the keep bits set the pace at p 0.1).
// No atomics: dQ, dK and dV are the same from run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace flash;
using namespace hopper;
using namespace flash_wg;

constexpr int kD = 256, kH = kD / 64;  // head_dim, its 64-column halves
constexpr int kS = 2;                   // stages of the streamed-tile ring
constexpr int kDqStrm = 32;             // rows of dQ's streamed K, V tiles
constexpr int kProdRegs = 56, kConsRegs = 224;
// as flash_wgmma.cuh's split: asking for more than the pool holds would
// spin in the allocation forever
static_assert(kProducers * kProdRegs + kConsumers * kConsRegs <=
                  168 * kWgThreads,
              "the warpgroups' registers exceed the CTA's pool");

struct Args {
  void* o;            // forward: O written, contiguous; dQ: O read (os)
  const void* dout;   // dQ: read through dos
  float* lse;         // forward: written; dQ, dK/dV: read
  float* delta;       // dQ: written; dK/dV: read
  void* dq;           // dQ: written through dqs
  void *dk, *dv;      // dK/dV: written through dks, dvs
  Strides os, dos, dqs, dks, dvs;
  int batch, n_heads, sq, sk;
  float scale;
  DropParams dp;
};

// Shared memory, byte offsets from a 1024-aligned base, of a kernel with
// OWNED owned tiles (Q; Q and dO) and R-row streamed tiles (K and V). A
// tile of X rows is [kH halves][X lines][128 bytes]. Owned tile i at i *
// kOwnTile; streamed tile i (K, V) of stage st at kStrmAt + (i * kS +
// st) * kStrmTile; each stage's 32 keep bits of every consumer thread
// (u32 [256]) at kKeep; dQ's lse * log2(e) and delta of the owned rows
// (f32 [2][128]) at kStat.
template <int R, int OWNED>
struct Layout {
  static constexpr int kOwnTile = kH * kOwn * kLine;
  static constexpr int kStrmTile = kH * R * kLine;
  static constexpr int kStrmAt = OWNED * kOwnTile;
  static constexpr int kKeep = kStrmAt + 2 * kS * kStrmTile;
  static constexpr int kStat = kKeep + kS * kConsumers * 4;
  static constexpr int kBar = kStat + (OWNED - 1) * 2 * kOwn * 4;
  static constexpr int kBytes = kBar + (4 + 2 * kS) * 8 + 1024;
};
using FwdLayout = Layout<kStrm, 1>;
using DqLayout = Layout<kDqStrm, 2>;

constexpr int kKeys = 64;     // keys a dK/dV CTA owns (both consumers)
constexpr int kDkvStrm = 32;  // rows of dK/dV's streamed Q, dO tiles
constexpr int kDkvS = 4;      // stages of its ring
// a dK/dV stage's keep words: one warpgroup's 128 (both consumer
// warpgroups read the same bits), each in two halves of 8 bits
constexpr int kKeepWords = 128;

// dK/dV's shared memory: the owned K and V tiles [kH][kKeys lines][128
// bytes] at 0 and kOwnTile; the Q and dO tiles of stage st at kStrmAt +
// (i * kDkvS + st) * kStrmTile; the stage's keep words (u32 [128]) at
// kKeep (u32 [2][128]: the bits of query chunks 0 and 1, and of 2 and
// 3); its lse * log2(e) and delta (f32 [2][32]) at kStat.
struct DkvLayout {
  static constexpr int kOwnTile = kH * kKeys * kLine;
  static constexpr int kStrmTile = kH * kDkvStrm * kLine;
  static constexpr int kStrmAt = 2 * kOwnTile;
  static constexpr int kKeep = kStrmAt + 2 * kDkvS * kStrmTile;
  static constexpr int kStat = kKeep + kDkvS * 2 * kKeepWords * 4;
  static constexpr int kBar = kStat + kDkvS * 2 * kDkvStrm * 4;
  static constexpr int kBytes = kBar + (4 + 2 * kDkvS) * 8 + 1024;
};
static_assert(FwdLayout::kBytes <= 232448 && DqLayout::kBytes <= 232448 &&
                  DkvLayout::kBytes <= 232448,
              "more shared memory than a CTA may use");

// Warpgroup 2 of both kernels: for each work item one thread loads the
// owned tiles (Q; Q and dO for DQ) into the one owned buffer once the
// consumers have released it, and the R-row K and V tiles into the ring;
// all 128 threads compute each stage's keep bits and, for DQ, lse *
// log2(e) and delta = rowsum(dO * O) of row own0 + p in f32 (delta also
// to a.delta).
template <bool DQ, bool CAUSAL, bool DROP>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Args& a, unsigned char* sm) {
  constexpr int R = DQ ? kDqStrm : kStrm, OWNED = DQ ? 2 : 1;
  using L = Layout<R, OWNED>;
  const uint32_t base = smem_u32(sm);
  const Bars<kS> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  [[maybe_unused]] float* stat_s = reinterpret_cast<float*>(sm + L::kStat);
  const DropParams dp = drop_params<DROP>(a.dp);
  const int p = threadIdx.x - kConsumers;
  const int sq = a.sq;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk;
  int tile = 0, n = 0;  // streamed tiles and items of this CTA so far
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Item it = work_item<false, CAUSAL, R>(a, item, nblk);
    mbar_wait(bars.own_empty(0), (n & 1) ^ 1);
    if (p == 0) {
      mbar_expect_tx(bars.own_full(0), OWNED * L::kOwnTile);
#pragma unroll
      for (int i = 0; i < OWNED; ++i)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          tma_load_4d(base + i * L::kOwnTile + h * kOwn * kLine,
                      i ? tdo : tq, bars.own_full(0), h * 64, it.hi,
                      it.own0, it.bi);
    }
    if constexpr (DQ) {
      const int row = it.own0 + p;
      float l = 0.f, dsum = 0.f;
      if (row < sq) {
        const uint4* op = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.o) + it.bi * a.os.b +
            row * a.os.s + it.hi * a.os.n);
        const uint4* gp = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.dout) + it.bi * a.dos.b +
            row * a.dos.s + it.hi * a.dos.n);
#pragma unroll 2
        for (int c = 0; c < kD / 8; ++c) dsum += dot8(op[c], gp[c]);
        l = a.lse[(long long)it.bh * sq + row] * kLog2e;
        a.delta[(long long)it.bh * sq + row] = dsum;
      }
      stat_s[p] = l;
      stat_s[kOwn + p] = dsum;
    }
    mbar_arrive(bars.own_full(0));
    for (int j = it.first; j < it.last; ++j, ++tile) {
      const int st = tile % kS, s0 = j * R;
      mbar_wait(bars.empty(st), ((tile / kS) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.full(st), 2 * L::kStrmTile);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < kH; ++h)
            tma_load_4d(base + L::kStrmAt + (i * kS + st) * L::kStrmTile +
                            h * R * kLine,
                        i ? tv : tk, bars.full(st), h * 64, it.hi, s0,
                        it.bi);
      }
      if (DROP)
        keep_words<false, R / 8>(dp, it.bh, it.own0, s0, p,
                                 keep_s + st * kConsumers);
      mbar_arrive(bars.full(st));
    }
  }
}

// Warpgroup 2 produces (produce). Warpgroups 0 and 1 consume 64 query
// rows each: per 64-key tile, S = Q K^T by wgmma_ss, the online softmax
// with P packed as it is computed, O *= corr, O += P V by wgmma.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wg256(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = FwdLayout;
  extern __shared__ __align__(1024) unsigned char smem_wg256[];
  unsigned char* sm = align1024(smem_wg256);
  const uint32_t base = smem_u32(sm);
  const Bars<kS> bars{base + L::kBar};
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProdRegs>();
    produce<false, CAUSAL, DROP>(&tq, nullptr, &tk, &tv, a, sm);
    return;
  }
  regs_inc<kConsRegs>();
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const int sq = a.sq, sk = a.sk;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
  const float scale2 = a.scale * kLog2e;  // softmax in base 2
  const long long o_row = (long long)a.n_heads * kD;  // O's row stride
  const uint32_t own_q = base + wg * 64 * kLine;  // the warpgroup's Q rows
  int tile = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Item it = work_item<false, CAUSAL>(a, item, nblk);
    const int wrow = it.own0 + lrow;  // the warp's first query row
    const int rows[2] = {wrow + g, wrow + g + 8};
    // the keys below klim[r] that row r may see (rows past sq are never
    // written, so they need no mask of their own)
    int klim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      klim[r] = CAUSAL ? min(sk, rows[r] + 1) : sk;
    float acc[kH][32];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    // m in base-2 units of the scaled logits; l a per-lane partial sum
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    // under a causal mask the k-tiles from wlast on lie wholly above this
    // warpgroup's rows (wlast > it.first: tile 0 meets every row)
    const int wlast =
        CAUSAL ? min(it.last, (it.own0 + wg * 64 + 63) / kStrm + 1)
               : it.last;
    mbar_wait(bars.own_full(0), n & 1);
    for (int j = it.first; j < wlast; ++j, ++tile) {
      const int st = tile % kS, s0 = j * kStrm;
      const uint32_t strm_k = base + L::kStrmAt + st * L::kStrmTile;
      const uint32_t strm_v = strm_k + kS * L::kStrmTile;
      mbar_wait(bars.full(st), (tile / kS) & 1);
      float s[32];
      wgmma_fence();
      scores<kD>(s, own_q, strm_k);
      wgmma_commit();
      const uint32_t keep = DROP ? keep_s[st * kConsumers + tid] : 0u;
      wgmma_wait<0>();
      fence_acc(s);
      // the warpgroup's last read of Q: the buffer may take the next
      // item's
      if (j == wlast - 1) release(bars.own_empty(0), lane);
      const bool edge = s0 + kStrm > sk || (CAUSAL && s0 + kStrm - 1 > wrow);
      const int hi[2] = {klim[0] - s0 - 2 * t, klim[1] - s0 - 2 * t};
      float corr[2], ps[2];
      online_max(s, scale2, edge, hi, m, corr);
      uint32_t f[4][4];  // P as bf16 A fragments
      if (edge)
        probs_a<DROP, true>(s, scale2, m, hi, keep, a.dp.rinv, ps, f);
      else
        probs_a<DROP, false>(s, scale2, m, hi, keep, a.dp.rinv, ps, f);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
      // O *= corr while no product is in flight
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i >> 1) & 1];
      pin_frags(f);
      fence_accs<kD>(acc);
      wgmma_fence();
      accumulate<kD>(acc, f, strm_v);
      wgmma_commit();
      wgmma_wait<0>();
      fence_accs<kD>(acc);
      release(bars.empty(st), lane);
    }
    // the tiles above this warpgroup's rows: only their stages
    for (int j = wlast; j < it.last; ++j, ++tile) {
      const int st = tile % kS;
      mbar_wait(bars.full(st), (tile / kS) & 1);
      release(bars.empty(st), lane);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float l_safe = fmaxf(lr, 1e-30f);
      inv[r] = 1.f / l_safe;
      if (t == 0 && rows[r] < sq)
        a.lse[(long long)it.bh * sq + rows[r]] =
            (m[r] + log2f(l_safe)) * kLn2;
    }
    store_acc_rows<kD>(static_cast<__nv_bfloat16*>(a.o) +
                           (long long)it.bi * sq * o_row + it.hi * kD,
                       o_row, acc, rows, sq, inv, t);
  }
}

// Warpgroup 2 produces (produce). Warpgroups 0 and 1 consume 64 query
// rows each: per 32-key tile, S = Q K^T and dP = dO V^T by wgmma_ss at N
// 32, dS in registers, dQ += dS K by wgmma.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wg256(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = DqLayout;
  constexpr int R = kDqStrm;
  extern __shared__ __align__(1024) unsigned char smem_wg256[];
  unsigned char* sm = align1024(smem_wg256);
  const uint32_t base = smem_u32(sm);
  const Bars<kS> bars{base + L::kBar};
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProdRegs>();
    produce<true, CAUSAL, DROP>(&tq, &tdo, &tk, &tv, a, sm);
    return;
  }
  regs_inc<kConsRegs>();
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const float* stat_s = reinterpret_cast<const float*>(sm + L::kStat);
  const int sq = a.sq, sk = a.sk;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
  const float scale2 = a.scale * kLog2e;
  // the warpgroup's rows of the owned Q and dO tiles
  const uint32_t own_q = base + wg * 64 * kLine;
  const uint32_t own_do = own_q + L::kOwnTile;
  int tile = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Item it = work_item<false, CAUSAL, R>(a, item, nblk);
    const int wrow = it.own0 + lrow;  // the warp's first query row
    const int rows[2] = {wrow + g, wrow + g + 8};
    float acc[kH][32];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    mbar_wait(bars.own_full(0), n & 1);
    // lse * log2(e) and delta of the thread's two rows, and the keys
    // below klim[r] that row r may see
    float lse2[2], dl[2];
    int klim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = stat_s[lrow + g + 8 * r];
      dl[r] = stat_s[kOwn + lrow + g + 8 * r];
      klim[r] = rows[r] < sq ? (CAUSAL ? min(sk, rows[r] + 1) : sk) : 0;
    }
    const int wlast =
        CAUSAL ? min(it.last, (it.own0 + wg * 64 + 63) / R + 1) : it.last;
    for (int j = it.first; j < wlast; ++j, ++tile) {
      const int st = tile % kS, s0 = j * R;
      const uint32_t strm_k = base + L::kStrmAt + st * L::kStrmTile;
      const uint32_t strm_v = strm_k + kS * L::kStrmTile;
      mbar_wait(bars.full(st), (tile / kS) & 1);
      // S = Q K^T and dP = dO V^T
      float s[16], dp[16];
      wgmma_fence();
      scores<kD, R>(s, own_q, strm_k);
      scores<kD, R>(dp, own_do, strm_v);
      wgmma_commit();
      const uint32_t keep = DROP ? keep_s[st * kConsumers + tid] : 0u;
      wgmma_wait<0>();
      fence_acc<16>(s);
      fence_acc<16>(dp);
      // the warpgroup's last read of Q and dO
      if (j == wlast - 1) release(bars.own_empty(0), lane);
      // the scores are only read from here on (flash_attn_bwd.cu)
      const bool edge = s0 + R > sk || it.own0 + kOwn > sq ||
                        (CAUSAL && s0 + R - 1 > wrow);
      const int lo[2] = {0, 0};
      const int hi[2] = {klim[0] - s0 - 2 * t, klim[1] - s0 - 2 * t};
      float ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        float pr = ex2(fmaf(s[i], scale2, -lse2[r]));
        if (edge && !slot_ok(i, lo, hi)) pr = 0.f;
        float d = dp[i];
        if (DROP) d = ((keep >> i) & 1) ? d * a.dp.rinv : 0.f;
        ds[i] = pr * (d - dl[r]);
      }
      // dQ += dS K
      uint32_t f[R / 16][4];
      pack_a<R / 16>(f, ds);
      pin_frags<R / 16>(f);
      wgmma_fence();
      accumulate<kD, R>(acc, f, strm_k);
      wgmma_commit();
      wgmma_wait<0>();
      release(bars.empty(st), lane);
    }
    // the tiles above this warpgroup's rows: only their stages
    for (int j = wlast; j < it.last; ++j, ++tile) {
      const int st = tile % kS;
      mbar_wait(bars.full(st), (tile / kS) & 1);
      release(bars.empty(st), lane);
    }
    fence_accs<kD>(acc);
    store_acc<kD>(static_cast<__nv_bfloat16*>(a.dq) + it.bi * a.dqs.b +
                      it.hi * a.dqs.n,
                  a.dqs.s, acc, rows, sq, a.scale, t);
  }
}

// Warpgroup 2 of dkv_wg256: for each work item one thread loads the
// owned K and V tiles of its 64 keys once the consumers have released
// the buffer, and the 32-row Q and dO tiles into the ring; threads 0..31
// stage the tile's lse * log2(e), 32..63 its delta, and all 128 compute
// its keep bits: thread p those of keep_words' pair p % 64 (of one
// warpgroup: both consumer warpgroups read the same words) over query
// chunks 2 (p / 64) and 2 (p / 64) + 1 of the tile's 4.
template <bool CAUSAL, bool DROP>
__device__ __forceinline__ void produce_dkv(const CUtensorMap* tq,
                                            const CUtensorMap* tdo,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            const Args& a,
                                            unsigned char* sm) {
  using L = DkvLayout;
  constexpr int R = kDkvStrm;
  const uint32_t base = smem_u32(sm);
  const Bars<kDkvS> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  float* stat_s = reinterpret_cast<float*>(sm + L::kStat);
  const DropParams dp = drop_params<DROP>(a.dp);
  const int p = threadIdx.x - kConsumers;
  const int sq = a.sq;
  const int nblk = (a.sk + kKeys - 1) / kKeys;
  const int items = a.batch * a.n_heads * nblk;
  int tile = 0, n = 0;  // streamed tiles and items of this CTA so far
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Item it = work_item<true, CAUSAL, R, kKeys>(a, item, nblk);
    mbar_wait(bars.own_empty(0), (n & 1) ^ 1);
    if (p == 0) {
      mbar_expect_tx(bars.own_full(0), 2 * L::kOwnTile);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          tma_load_4d(base + i * L::kOwnTile + h * kKeys * kLine,
                      i ? tv : tk, bars.own_full(0), h * 64, it.hi,
                      it.own0, it.bi);
    }
    mbar_arrive(bars.own_full(0));
    for (int j = it.first; j < it.last; ++j, ++tile) {
      const int st = tile % kDkvS, s0 = j * R;
      mbar_wait(bars.empty(st), ((tile / kDkvS) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.full(st), 2 * L::kStrmTile);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < kH; ++h)
            tma_load_4d(base + L::kStrmAt + (i * kDkvS + st) * L::kStrmTile +
                            h * R * kLine,
                        i ? tdo : tq, bars.full(st), h * 64, it.hi, s0,
                        it.bi);
      }
      if (p < 2 * R) {
        const int i = s0 + (p & (R - 1));
        float x = 0.f;
        if (i < sq)
          x = p < R ? a.lse[(long long)it.bh * sq + i] * kLog2e
                    : a.delta[(long long)it.bh * sq + i];
        stat_s[st * 2 * R + p] = x;
      }
      if (DROP) {
        const int half = p >> 6;
        keep_words<true, R / 16>(
            dp, it.bh, it.own0, s0 + half * R / 2, p & 63,
            keep_s + (2 * st + half) * kKeepWords);
      }
      mbar_arrive(bars.full(st));
    }
  }
}

// A consumer warpgroup of dkv_wg256 over the CTA's 64 keys: DK
// (warpgroup 1) accumulates dK += dS^T Q from S^T = K Q^T and dP^T =
// V dO^T, else (warpgroup 0) dV += dropout(P)^T dO from S^T alone, per
// 32-query tile; then writes its accumulator (dK times scale).
template <bool DK, bool CAUSAL, bool DROP>
__device__ __forceinline__ void consume_dkv(const Args& a,
                                            unsigned char* sm) {
  using L = DkvLayout;
  constexpr int R = kDkvStrm;
  const uint32_t base = smem_u32(sm);
  const Bars<kDkvS> bars{base + L::kBar};
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const float* stat_s = reinterpret_cast<const float*>(sm + L::kStat);
  const int sq = a.sq, sk = a.sk;
  const int nblk = (sk + kKeys - 1) / kKeys;
  const int items = a.batch * a.n_heads * nblk;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = a.scale * kLog2e;
  const uint32_t own_k = base, own_v = base + L::kOwnTile;
  int tile = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const Item it = work_item<true, CAUSAL, R, kKeys>(a, item, nblk);
    const int wrow = it.own0 + warp * 16;  // the warp's first key
    const int rows[2] = {wrow + g, wrow + g + 8};
    float acc[kH][32];
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    mbar_wait(bars.own_full(0), n & 1);
    for (int j = it.first; j < it.last; ++j, ++tile) {
      const int st = tile % kDkvS, s0 = j * R;
      const uint32_t strm_q = base + L::kStrmAt + st * L::kStrmTile;
      const uint32_t strm_do = strm_q + kDkvS * L::kStrmTile;
      mbar_wait(bars.full(st), (tile / kDkvS) & 1);
      // S^T = K Q^T (and dP^T = V dO^T)
      float s[16];
      [[maybe_unused]] float dp[16];
      wgmma_fence();
      scores<kD, R, kKeys>(s, own_k, strm_q);
      if constexpr (DK) scores<kD, R, kKeys>(dp, own_v, strm_do);
      wgmma_commit();
      uint32_t keep = 0u;
      if (DROP) {
        const uint32_t* w = keep_s + 2 * st * kKeepWords + (tid & 127);
        keep = w[0] | (w[kKeepWords] << 8);
      }
      wgmma_wait<0>();
      fence_acc<16>(s);
      if constexpr (DK) fence_acc<16>(dp);
      // the warpgroup's last read of K and V
      if (j == it.last - 1) release(bars.own_empty(0), lane);
      // the scores are only read from here on (flash_attn_bwd.cu)
      const bool edge = s0 + R > sq || it.own0 + kKeys > sk ||
                        (CAUSAL && s0 < wrow + 15);
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lo[r] = CAUSAL ? rows[r] - s0 - 2 * t : -R;
        hi[r] = rows[r] < sk ? sq - s0 - 2 * t : -R;
      }
      const float* lsec = stat_s + st * 2 * R;
      const float* dlc = lsec + R;
      float x[16];  // dS^T, or dropout(P)^T
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qi = (i >> 2) * 8 + 2 * t + (i & 1);
        float pr = ex2(fmaf(s[i], scale2, -lsec[qi]));
        if (edge && !slot_ok(i, lo, hi)) pr = 0.f;
        const bool kept = !DROP || ((keep >> i) & 1);
        if constexpr (DK) {
          float d = dp[i];
          if (DROP) d = kept ? d * a.dp.rinv : 0.f;
          x[i] = pr * (d - dlc[qi]);
        } else {
          x[i] = DROP ? (kept ? pr * a.dp.rinv : 0.f) : pr;
        }
      }
      // dK += dS^T Q, or dV += dropout(P)^T dO
      uint32_t f[R / 16][4];
      pack_a<R / 16>(f, x);
      pin_frags<R / 16>(f);
      wgmma_fence();
      accumulate<kD, R>(acc, f, DK ? strm_q : strm_do);
      wgmma_commit();
      wgmma_wait<0>();
      release(bars.empty(st), lane);
    }
    // keys that no query sees (causal, sq < sk) release the buffer here
    if (it.first >= it.last) release(bars.own_empty(0), lane);
    fence_accs<kD>(acc);
    if constexpr (DK)
      store_acc<kD>(static_cast<__nv_bfloat16*>(a.dk) + it.bi * a.dks.b +
                        it.hi * a.dks.n,
                    a.dks.s, acc, rows, sk, a.scale, t);
    else
      store_acc<kD>(static_cast<__nv_bfloat16*>(a.dv) + it.bi * a.dvs.b +
                        it.hi * a.dvs.n,
                    a.dvs.s, acc, rows, sk, 1.f, t);
  }
}

// Warpgroup 2 produces (produce_dkv). Warpgroups 0 and 1 consume the
// same 64 keys: 0 accumulates dV, 1 dK (consume_dkv).
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wg256(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_wg256[];
  unsigned char* sm = align1024(smem_wg256);
  const Bars<kDkvS> bars{smem_u32(sm) + DkvLayout::kBar};
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProdRegs>();
    produce_dkv<CAUSAL, DROP>(&tq, &tdo, &tk, &tv, a, sm);
    return;
  }
  regs_inc<kConsRegs>();
  if (wg == 0)
    consume_dkv<false, CAUSAL, DROP>(a, sm);
  else
    consume_dkv<true, CAUSAL, DROP>(a, sm);
}

// ------------------------------------------------------------ launching

// one CTA per SM, or one per work item (rows blocks of `rows` over s
// rows of each (batch, head)) when there are fewer
cudaError_t grid_of(const Args& a, int s, int rows, dim3* grid) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  const long long items = (long long)a.batch * a.n_heads *
                          ((s + rows - 1) / rows);
  *grid = dim3((unsigned)(items < sms ? items : sms));
  return e;
}

template <bool C, bool P>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const Strides& qs, const Strides& ks,
                       const Strides& vs, const Args& a,
                       cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, kD, qs.b, qs.s, qs.n, kOwn) ||
      bf16_rows_map(&tk, k, b, a.sk, n, kD, ks.b, ks.s, ks.n, kStrm) ||
      bf16_rows_map(&tv, v, b, a.sk, n, kD, vs.b, vs.s, vs.n, kStrm))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sq, kOwn, &grid);
  if (e != cudaSuccess) return e;
  return go(fwd_wg256<C, P>, grid, kWgThreads, FwdLayout::kBytes, stream,
            tq, tk, tv, a);
}

template <bool C, bool P>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const Strides& qs, const Strides& ks,
                      const Strides& vs, const Args& a,
                      cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tdo, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, kD, qs.b, qs.s, qs.n, kOwn) ||
      bf16_rows_map(&tdo, a.dout, b, a.sq, n, kD, a.dos.b, a.dos.s, a.dos.n,
                    kOwn) ||
      bf16_rows_map(&tk, k, b, a.sk, n, kD, ks.b, ks.s, ks.n, kDqStrm) ||
      bf16_rows_map(&tv, v, b, a.sk, n, kD, vs.b, vs.s, vs.n, kDqStrm))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sq, kOwn, &grid);
  if (e != cudaSuccess) return e;
  return go(dq_wg256<C, P>, grid, kWgThreads, DqLayout::kBytes, stream, tq,
            tdo, tk, tv, a);
}

template <bool C, bool P>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const Strides& qs, const Strides& ks,
                       const Strides& vs, const Args& a,
                       cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tdo, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, kD, qs.b, qs.s, qs.n, kDkvStrm) ||
      bf16_rows_map(&tdo, a.dout, b, a.sq, n, kD, a.dos.b, a.dos.s, a.dos.n,
                    kDkvStrm) ||
      bf16_rows_map(&tk, k, b, a.sk, n, kD, ks.b, ks.s, ks.n, kKeys) ||
      bf16_rows_map(&tv, v, b, a.sk, n, kD, vs.b, vs.s, vs.n, kKeys))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sk, kKeys, &grid);
  if (e != cudaSuccess) return e;
  return go(dkv_wg256<C, P>, grid, kWgThreads, DkvLayout::kBytes, stream,
            tq, tdo, tk, tv, a);
}

}  // namespace

// The three entries take the arguments of pt_flash_attn_fwd,
// pt_flash_attn_bwd_dq and pt_flash_attn_bwd_dkv (flash_attn_fwd.cu,
// flash_attn_bwd.cu) and run only dtype 1 (bfloat16) at d = 256;
// ops/flash_attention.py's _kernel_entry sends those here. Strides are
// element strides (batch, seq, head) of [b, s, n, h] tensors whose
// head_dim stride is 1, in the layout the tensor maps describe:
// multiples of 8 elements, and a dimension of size 1 given the stride a
// packed tensor would have. The forward writes O contiguous [b, sq, n,
// h] and lse f32 [b, n, sq]; the dQ entry reads o for delta = rowsum(dO
// * O) and writes delta f32 [b, n, sq], which the dK/dV entry, launched
// after it on the same stream, then reads. dropout != 0 draws the keep
// bits from the threshold and the 64-bit seed at `seed` in device memory
// (lo, hi; read by the kernel); rinv = 1 / (1 - p). Returns 0 on
// success, a cudaError_t code if a launch or a tensor map was refused,
// or -1 for a dtype / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd_wg256(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  if (dtype != 1 || d != kD) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.o = o; a.lse = lse;
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_fwd<C, P>(q, k, v, qs, ks, vs, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}

extern "C" int pt_flash_attn_bwd_dq_wg256(
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
  if (dtype != 1 || d != kD) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.o = const_cast<void*>(o); a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = delta; a.dq = dq;
  a.os = {o_sb, o_ss, o_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dqs = {dq_sb, dq_ss, dq_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_dq<C, P>(q, k, v, qs, ks, vs, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}

extern "C" int pt_flash_attn_bwd_dkv_wg256(
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
  if (dtype != 1 || d != kD) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_dkv<C, P>(q, k, v, qs, ks, vs, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}
