// Flash attention above head_dim 256 in bf16 on Hopper's tensor cores
// (sm_90a): the forward (O and lse), the dQ kernel (dQ and delta) and
// the dK/dV kernel at any head_dim D that is a multiple of 256 above it,
// on the warp-specialised wgmma pipeline of flash_wgmma.cuh.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (:175),
// `_dq_kernel` (:283) and `_dkv_kernel` (:319) at the head_dims the
// Pallas wrapper pads above 256 (:486-493; ops/flash_attention.py's
// kernel_head_dim pads 257 and up to the next multiple of 256), in
// bf16. The same function as the f32 kernels of flash_attn_wide.cu and
// the bf16 ones at 256 (flash_attn_wg256.cu): the key bound `col < sk`,
// the query bound `row < sq`, the top-left causal rule `row >= col`
// (tiles a warpgroup's rows cannot see skipped), masking with -1e30,
// `l_safe = max(l, 1e-30)`, lse = m + log(l_safe) in f32 [b, n, sq];
// dropout from philox.cuh's keep bits of (seed, b*n + head, row, col),
// which do not depend on D, with the seed read from device memory, l
// summing the un-dropped probabilities and the kept ones scaled by
// 1/(1-p); dQ = sum_j dS K * scale with dS = P * (keep * dP / (1-p) -
// delta) and P recomputed from the forward's lse; dV = sum_i dropout(P)^T
// dO and dK = sum_i dS^T Q * scale, with delta = rowsum(dO * O) over the
// whole head_dim in f32, which the dQ kernel computes and writes. q, k,
// v and dO are read as strided [b, s, n, D] views through TMA tensor
// maps, with no copy; O is written contiguous. No atomics: dQ, dK and
// dV are the same from run to run.
//
// The chunk form, shared by the three kernels. No tile of the whole
// head_dim fits a CTA (a 128-row Q tile is 256 KB at D 1024), and an f32
// accumulator [64 x D] of a consumer warpgroup does not fit its
// registers above 256. So the output's head_dim is split into 256-wide
// chunks z: a work item is (batch, head, row block, z), each consumer
// warpgroup holds its output chunk [64 x 256] in f32 (128 registers a
// thread, as the kernels at 256), and the products that run over the
// whole head_dim (S = Q K^T, and dP = dO V^T in the backward) are summed
// over its 64-column sub-tiles c, streamed in (owned rows, streamed
// rows) pairs through a ring. Every chunk's CTA of a row block computes
// the same S (and dP), D / 256 times the products of the scores; the
// chunks of a row block are neighbouring work items, so the CTAs on the
// card at once read the same sub-tiles from L2. The cluster form, which
// would sum the partial scores of the D / 256 chunk CTAs through
// distributed shared memory and read Q and K once, is not built.
//
// fwd_wgwide. What bounds it on an H100: at b 2, s 512, n 4, D 1024 it
// does 4 b n s^2 D = 8.6 GFLOP (0.0087 ms at 989 TFLOP/s) against 4 b s n
// D x 2 bytes (33.6 MB, 0.0100 ms at 3.35 TB/s): bound by bytes, nearly
// balanced. The design: a work item owns 128 query rows.
//  * The scores of a 64-key tile run as wgmma_ss over the sub-tiles: the
//    producer streams (Q_c [128 x 64], K_c [64 x 64]) pairs, 24 KB,
//    through a ring of 6 stages, and a consumer warpgroup keeps one
//    sub-tile's 4 products in flight while it releases the stage before.
//  * V: only the CTA's own chunk V_z [64 x 256] of each key tile is
//    loaded, through a ring of 2 stages (32 KB each) that also carries
//    the tile's keep bits; O_z += P V_z runs as in fwd_wg256, 4
//    m64n64k16 per 16 keys from P packed to bf16 A fragments in
//    registers, V read MN-major. The online softmax is fwd_wg256's.
//  * Shared memory: 147,456 bytes of ring, 65,536 of V, 2,048 of keep
//    words, the barriers and 1,024 of alignment: 216,192 of 232,448.
//  * The register split: 72 a producer thread, 216 a consumer thread.
//    One producer thread issues the loads; all 128 compute the keep bits
//    of each key tile (keep_words, as the forward at 256). Only chunk
//    0's CTA writes the lse.
//
// dq_wgwide and dkv_wgwide. What bounds them on an H100: dQ does 3
// products of 2 D flops a link (S, dP, dS K) and dK/dV 4 (S, dP, P^T dO,
// dS^T Q). At encoder_wide's attention (b 8, s 1024, n 8, D 512) a
// product is 68.7 GFLOP: dQ 206 GFLOP, 0.208 ms at 989 TFLOP/s, against
// about 403 MB of q, k, v, O, dO in and dq out (0.120 ms at 3.35 TB/s);
// dK/dV 275 GFLOP, 0.278 ms: both bound by operations. At b 2, s 512, n
// 4, D 1024 a product is 4.3 GFLOP: dQ 0.0130 ms of operations against
// 50.3 MB (0.0150 ms), bound by bytes; dK/dV 0.0174 ms, bound by
// operations. The chunk form adds work: per chunk CTA, S and dP over the
// whole head_dim (and in dK/dV S^T twice, once in each consumer
// warpgroup, as dkv_wg256 does), so at D = 256 nc the kernels run nc (2
// nc + 1) and nc (3 nc + 2) products of 256 columns against the 3 nc and
// 4 nc the function needs: 10 and 16 against 6 and 8 at D 512, about
// 0.35 and 0.56 ms at the peak rate. The sub-tiles are read again for
// every streamed tile, from L2: that traffic, not device memory, is
// what the design has to keep fed.
//  * dq_wgwide: a work item owns 128 query rows (64 a consumer
//    warpgroup) and walks 32-key tiles (dq_wg256's: at 64 keys, S and dP
//    [64 x 64] would take 64 registers beside dQ_z's 128). Per key tile
//    S and dP [64 x 32] (16 registers each) are summed over the
//    sub-tiles by m64n32k16 wgmma_ss from a 4-stage ring of (Q_c, dO_c
//    [128 x 64], K_c, V_c [32 x 64]), 40 KB a stage; dQ_z += dS K_z then
//    runs as in dq_wg256, 4 m64n64k16 per 16 keys with K_z read
//    MN-major from a ring of 2 stages that also carries the tile's keep
//    bits. K_z's four sub-tiles are the ring's K_c for c in chunk z, so
//    those stages load no K_c and the scores read it from K_z. The
//    producer's 128 threads also compute, for each item, lse * log2(e)
//    and delta of the 128 rows (one row a thread, over the whole head
//    dim); chunk 0's CTA writes delta to [b, n, sq] for dkv_wgwide.
//    Shared memory 200,800 bytes.
//  * dkv_wgwide: a work item owns 64 keys, and both consumer warpgroups
//    own the same keys as in dkv_wg256: warpgroup 0 accumulates dV_z +=
//    dropout(P)^T dO_z from S^T alone, warpgroup 1 dK_z += dS^T Q_z from
//    S^T and dP^T, 128 registers each, per 32-query tile. S^T and dP^T
//    [64 x 32] are summed over the sub-tiles from a 6-stage ring of (K_c,
//    V_c [64 x 64], Q_c, dO_c [32 x 64]), 24 KB a stage; Q_z and dO_z
//    [32 x 256] come through a ring of 2 stages with the tile's keep
//    bits, lse and delta, and the stages of chunk z load no Q_c or dO_c.
//    Handing P^T from warpgroup 0 to 1 measured slower at 256 (PERF.md),
//    so each computes its own S^T. Shared memory 216,720 bytes.
//  * dkv_wgwide keeps fwd_wgwide's register split, 72 / 216 (its
//    producer walks the same nested loops and computes the same keep
//    bits); dq_wgwide's producer takes 80 for the row statistics beside
//    them, its consumers 208.

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

constexpr int kZ = 256, kZH = kZ / 64;  // an output chunk, its halves
constexpr int kQkS = 6, kVS = 2;        // stages of the forward's rings
// the producer's loop state and a Philox round do not fit the 56
// registers flash_attn_wg256.cu leaves it (ptxas spilled the dropout
// variants); O_z, S and P take about 180 of a consumer's 216. The dQ
// producer also holds the row statistics' pointers and state: at 72 its
// dropout variants spilled 20-24 bytes, at 80 none (its consumers then
// have 208: dQ_z, S and dP take about 160)
constexpr int kProdRegs = 72, kConsRegs = 216;
constexpr int kDqProdRegs = 80, kDqConsRegs = 208;
// as flash_wgmma.cuh's split: asking for more than the pool holds would
// spin in the allocation forever
static_assert(kProducers * kProdRegs + kConsumers * kConsRegs <=
                  168 * kWgThreads &&
                  kProducers * kDqProdRegs + kConsumers * kDqConsRegs <=
                  168 * kWgThreads,
              "the warpgroups' registers exceed the CTA's pool");

struct Args {
  void* o;            // forward: O written, contiguous; dQ: O read (os)
  const void* dout;   // dQ, dK/dV: read through dos
  float* lse;         // [b, n, sq]: forward: written by chunk 0; read
  float* delta;       // [b, n, sq]: dQ: written by chunk 0; dK/dV: read
  void* dq;           // dQ: written through dqs
  void *dk, *dv;      // dK/dV: written through dks, dvs
  Strides os, dos, dqs, dks, dvs;
  int batch, n_heads, sq, sk, nc;  // nc = D / 256 chunks
  float scale;
  DropParams dp;
};

// fwd_wgwide's shared memory, byte offsets from a 1024-aligned base: ring
// stage st's Q sub-tile [128 lines][128 bytes] at st * kQkStage and its K
// sub-tile [64 lines][128 bytes] after it; V stage vs [kZH halves][64
// lines][128 bytes] at kVAt + vs * kVTile; its keep words (u32 [256]) at
// kKeep.
struct Layout {
  static constexpr int kQSub = kOwn * kLine;
  static constexpr int kKSub = kStrm * kLine;
  static constexpr int kQkStage = kQSub + kKSub;
  static constexpr int kVTile = kZH * kStrm * kLine;
  static constexpr int kVAt = kQkS * kQkStage;
  static constexpr int kKeep = kVAt + kVS * kVTile;
  static constexpr int kBar = kKeep + kVS * kConsumers * 4;
  static constexpr int kBytes = kBar + 2 * (kQkS + kVS) * 8 + 1024;
};
static_assert(Layout::kBytes <= 232448, "more shared memory than a CTA "
                                        "may use");

// The mbarriers: ring stage s full (its TMA bytes have landed; one
// arrival) and empty (every consumer warp is done with it), V stage s
// full (its bytes, and with dropout every producer thread's keep words)
// and empty.
struct WideBars {
  uint32_t at;
  __device__ uint32_t qk_full(int s) const { return at + 8 * s; }
  __device__ uint32_t qk_empty(int s) const { return at + 8 * (kQkS + s); }
  __device__ uint32_t v_full(int s) const { return at + 8 * (2 * kQkS + s); }
  __device__ uint32_t v_empty(int s) const {
    return at + 8 * (2 * kQkS + kVS + s);
  }
  __device__ void init(bool drop) const {
    for (int s = 0; s < kQkS; ++s) {
      mbar_init(qk_full(s), 1);
      mbar_init(qk_empty(s), kConsumers / 32);
    }
    for (int s = 0; s < kVS; ++s) {
      mbar_init(v_full(s), drop ? kProducers : 1);
      mbar_init(v_empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
};

// work item i: chunk i % nc of row block item_block(i / nc) (the chunks
// of a row block are neighbours, so the CTAs on the card at once share
// its sub-tiles in L2); DKV, R and O as work_item takes them
template <bool DKV, bool CAUSAL, int R = kStrm, int O = kOwn>
__device__ __forceinline__ Item chunk_item(const Args& a, int item,
                                           int nblk, int* z) {
  *z = item % a.nc;
  return work_item<DKV, CAUSAL, R, O>(a, item / a.nc, nblk);
}

// Warpgroup 2: per 64-key tile of each work item, one thread loads the
// tile's V_z and then its (Q_c, K_c) sub-tile pairs; with dropout all
// 128 threads compute the tile's keep bits into the V stage. Every
// producer thread walks the ring's stages, so the warpgroup's control
// flow stays uniform.
template <bool CAUSAL, bool DROP>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Args& a, unsigned char* sm) {
  using L = Layout;
  const uint32_t base = smem_u32(sm);
  const WideBars bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  const DropParams dp = drop_params<DROP>(a.dp);
  const int p = threadIdx.x - kConsumers;
  const int nblk = (a.sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk * a.nc;
  const int nsub = a.nc * kZH;  // 64-column sub-tiles of the head_dim
  int vt = 0, qs = 0;  // V tiles and ring stages of this CTA so far
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int z;
    const Item it = chunk_item<false, CAUSAL>(a, item, nblk, &z);
    for (int j = it.first; j < it.last; ++j, ++vt) {
      const int vs = vt % kVS, s0 = j * kStrm;
      mbar_wait(bars.v_empty(vs), ((vt / kVS) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.v_full(vs), L::kVTile);
#pragma unroll
        for (int h = 0; h < kZH; ++h)
          tma_load_4d(base + L::kVAt + vs * L::kVTile + h * kStrm * kLine,
                      tv, bars.v_full(vs), z * kZ + h * 64, it.hi, s0,
                      it.bi);
      }
      if (DROP) {
        keep_words<false>(dp, it.bh, it.own0, s0, p,
                          keep_s + vs * kConsumers);
        mbar_arrive(bars.v_full(vs));
      } else if (p == 0) {
        mbar_arrive(bars.v_full(vs));
      }
      for (int c = 0; c < nsub; ++c, ++qs) {
        const int st = qs % kQkS;
        mbar_wait(bars.qk_empty(st), ((qs / kQkS) & 1) ^ 1);
        if (p == 0) {
          const uint32_t at = base + st * L::kQkStage;
          mbar_expect_tx(bars.qk_full(st), L::kQkStage);
          tma_load_4d(at, tq, bars.qk_full(st), c * 64, it.hi, it.own0,
                      it.bi);
          tma_load_4d(at + L::kQSub, tk, bars.qk_full(st), c * 64, it.hi,
                      s0, it.bi);
          mbar_arrive(bars.qk_full(st));
        }
      }
    }
  }
}

// S (+)= Q_c K_c^T of a warpgroup's 64 rows over one 64-column sub-tile:
// 4 k-steps, both operands K-major in shared memory
template <bool ACC>
__device__ __forceinline__ void sub_scores(float* s, uint32_t q,
                                           uint32_t k) {
  wgmma_ss<ACC>(s, sw128_desc(q), sw128_desc(k));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_ss<true>(s, sw128_desc(q + kk * 32), sw128_desc(k + kk * 32));
}

// Warpgroup 2 produces (produce). Warpgroups 0 and 1 consume 64 query
// rows each: per 64-key tile, S summed over the head_dim's sub-tiles by
// wgmma_ss, the online softmax with P packed as it is computed, O_z *=
// corr, O_z += P V_z by wgmma.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgwide(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Layout;
  extern __shared__ __align__(1024) unsigned char smem_wgwide[];
  unsigned char* sm = align1024(smem_wgwide);
  const uint32_t base = smem_u32(sm);
  const WideBars bars{base + L::kBar};
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init(DROP);
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProdRegs>();
    produce<CAUSAL, DROP>(&tq, &tk, &tv, a, sm);
    return;
  }
  regs_inc<kConsRegs>();
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const int sq = a.sq, sk = a.sk, nc = a.nc;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk * nc;
  const int nsub = nc * kZH;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
  const float scale2 = a.scale * kLog2e;  // softmax in base 2
  const long long o_row = (long long)a.n_heads * nc * kZ;  // O's row stride
  int vt = 0, qs = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int z;
    const Item it = chunk_item<false, CAUSAL>(a, item, nblk, &z);
    const int wrow = it.own0 + lrow;  // the warp's first query row
    const int rows[2] = {wrow + g, wrow + g + 8};
    int klim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      klim[r] = CAUSAL ? min(sk, rows[r] + 1) : sk;
    float acc[kZH][32];
#pragma unroll
    for (int h = 0; h < kZH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    // under a causal mask the k-tiles from wlast on lie wholly above this
    // warpgroup's rows (wlast > it.first: tile 0 meets every row)
    const int wlast =
        CAUSAL ? min(it.last, (it.own0 + wg * 64 + 63) / kStrm + 1)
               : it.last;
    for (int j = it.first; j < wlast; ++j, ++vt) {
      const int vs = vt % kVS, s0 = j * kStrm;
      // S = sum_c Q_c K_c^T, one sub-tile's products in flight while the
      // stage before is released
      float s[32];
      {
        const int st = qs % kQkS;
        const uint32_t at = base + st * L::kQkStage;
        mbar_wait(bars.qk_full(st), (qs / kQkS) & 1);
        wgmma_fence();
        sub_scores<false>(s, at + wg * 64 * kLine, at + L::kQSub);
        wgmma_commit();
        ++qs;
      }
      for (int c = 1; c < nsub; ++c, ++qs) {
        const int st = qs % kQkS;
        const uint32_t at = base + st * L::kQkStage;
        mbar_wait(bars.qk_full(st), (qs / kQkS) & 1);
        wgmma_fence();
        sub_scores<true>(s, at + wg * 64 * kLine, at + L::kQSub);
        wgmma_commit();
        wgmma_wait<1>();
        release(bars.qk_empty((qs - 1) % kQkS), lane);
      }
      wgmma_wait<0>();
      fence_acc(s);
      release(bars.qk_empty((qs - 1) % kQkS), lane);
      mbar_wait(bars.v_full(vs), (vt / kVS) & 1);
      const uint32_t keep = DROP ? keep_s[vs * kConsumers + tid] : 0u;
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
      for (int h = 0; h < kZH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i >> 1) & 1];
      pin_frags(f);
      fence_accs<kZ>(acc);
      wgmma_fence();
      accumulate<kZ>(acc, f, base + L::kVAt + vs * L::kVTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_accs<kZ>(acc);
      release(bars.v_empty(vs), lane);
    }
    // the tiles above this warpgroup's rows: only their stages
    for (int j = wlast; j < it.last; ++j, ++vt) {
      for (int c = 0; c < nsub; ++c, ++qs) {
        const int st = qs % kQkS;
        mbar_wait(bars.qk_full(st), (qs / kQkS) & 1);
        release(bars.qk_empty(st), lane);
      }
      const int vs = vt % kVS;
      mbar_wait(bars.v_full(vs), (vt / kVS) & 1);
      release(bars.v_empty(vs), lane);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float l_safe = fmaxf(lr, 1e-30f);
      inv[r] = 1.f / l_safe;
      if (z == 0 && t == 0 && rows[r] < sq)
        a.lse[(long long)it.bh * sq + rows[r]] =
            (m[r] + log2f(l_safe)) * kLn2;
    }
    store_acc_rows<kZ>(static_cast<__nv_bfloat16*>(a.o) +
                           (long long)it.bi * sq * o_row +
                           (long long)it.hi * nc * kZ + z * kZ,
                       o_row, acc, rows, sq, inv, t);
  }
}

// ------------------------------------------------------------- backward

constexpr int kBwdR = 32;   // rows of the backward's streamed tiles
constexpr int kKeys = 64;   // keys a dK/dV CTA owns (both consumers)
constexpr int kDqS = 4, kDkvS = 6;  // stages of the sub-tile rings
constexpr int kZS = 2;      // stages of the chunk-z rings
// a dK/dV stage's keep words: one warpgroup's 128 (both consumer
// warpgroups read the same bits), each in two halves of 8 bits
constexpr int kKeepWords = 128;

// dq_wgwide's shared memory, byte offsets from a 1024-aligned base:
// sub-tile stage st at st * kStage, [128 lines][128 bytes] of Q_c, then
// of dO_c, [32 lines][128 bytes] of K_c, then of V_c; K_z stage ks
// [kZH halves][32 lines][128 bytes] at kZAt + ks * kZTile; its keep
// words (u32 [256]) at kKeep; lse * log2(e) and delta of the item's 128
// rows (f32 [2][128]) at kStat.
struct DqLayout {
  static constexpr int kQSub = kOwn * kLine;
  static constexpr int kKSub = kBwdR * kLine;
  static constexpr int kStage = 2 * kQSub + 2 * kKSub;
  static constexpr int kZTile = kZH * kKSub;
  static constexpr int kZAt = kDqS * kStage;
  static constexpr int kKeep = kZAt + kZS * kZTile;
  static constexpr int kStat = kKeep + kZS * kConsumers * 4;
  static constexpr int kBar = kStat + 2 * kOwn * 4;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kDqS + 2 * kZS) + 1024;
};

// dkv_wgwide's: sub-tile stage st at st * kStage, [64 lines][128 bytes]
// of K_c, then of V_c, [32 lines][128 bytes] of Q_c, then of dO_c;
// chunk-z stage zs at kZAt + zs * 2 kZTile, [kZH halves][32 lines][128
// bytes] of Q_z, then of dO_z; its keep words (u32 [2][128]: the bits of
// query chunks 0 and 1, and of 2 and 3) at kKeep; its lse * log2(e) and
// delta (f32 [2][32]) at kStat.
struct DkvLayout {
  static constexpr int kKSub = kKeys * kLine;
  static constexpr int kQSub = kBwdR * kLine;
  static constexpr int kStage = 2 * kKSub + 2 * kQSub;
  static constexpr int kZTile = kZH * kQSub;
  static constexpr int kZAt = kDkvS * kStage;
  static constexpr int kKeep = kZAt + kZS * 2 * kZTile;
  static constexpr int kStat = kKeep + kZS * 2 * kKeepWords * 4;
  static constexpr int kBar = kStat + kZS * 2 * kBwdR * 4;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kDkvS + 2 * kZS) + 1024;
};
static_assert(DqLayout::kBytes <= 232448 && DkvLayout::kBytes <= 232448,
              "more shared memory than a CTA may use");

// The backward's mbarriers: the item's row statistics full (every
// producer thread has stored its row's) and empty (every consumer warp
// has read them; dQ only), sub-tile stage s full (its TMA bytes have
// landed; one arrival) and empty (every consumer warp is done with it),
// chunk-z stage s full (its bytes, and every producer thread's keep bits
// and statistics) and empty.
template <int S>
struct BwdBars {
  uint32_t at;
  __device__ uint32_t own_full() const { return at; }
  __device__ uint32_t own_empty() const { return at + 8; }
  __device__ uint32_t qk_full(int s) const { return at + 16 + 8 * s; }
  __device__ uint32_t qk_empty(int s) const {
    return at + 16 + 8 * (S + s);
  }
  __device__ uint32_t z_full(int s) const { return at + 16 + 8 * (2 * S + s); }
  __device__ uint32_t z_empty(int s) const {
    return at + 16 + 8 * (2 * S + kZS + s);
  }
  __device__ void init() const {
    mbar_init(own_full(), kProducers);
    mbar_init(own_empty(), kConsumers / 32);
    for (int s = 0; s < S; ++s) {
      mbar_init(qk_full(s), 1);
      mbar_init(qk_empty(s), kConsumers / 32);
    }
    for (int s = 0; s < kZS; ++s) {
      mbar_init(z_full(s), kProducers);
      mbar_init(z_empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
};

// S (+)= A B^T of a warpgroup's 64 rows against 32 streamed rows over one
// 64-column sub-tile: 4 k-steps of m64n32k16, both operands K-major in
// shared memory
template <bool ACC>
__device__ __forceinline__ void sub_scores_n32(float* s, uint32_t a,
                                               uint32_t b) {
  wgmma_ss_n32<ACC>(s, sw128_desc(a), sw128_desc(b));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk)
    wgmma_ss_n32<true>(s, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
}

// Warpgroup 2 of dq_wgwide: for each work item all 128 threads compute
// lse * log2(e) and delta = rowsum(dO * O) over the whole head_dim of row
// own0 + p in f32 (chunk 0's CTA also writes delta to a.delta); then per
// 32-key tile one thread loads K_z and all 128 compute the tile's keep
// bits, and one thread loads the tile's (Q_c, dO_c, K_c, V_c) sub-tiles
// (no K_c in chunk z's: the consumers read it from K_z).
template <bool CAUSAL, bool DROP>
__device__ __forceinline__ void produce_dq(const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const Args& a, unsigned char* sm) {
  using L = DqLayout;
  constexpr int R = kBwdR;
  const uint32_t base = smem_u32(sm);
  const BwdBars<kDqS> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  float* stat_s = reinterpret_cast<float*>(sm + L::kStat);
  const DropParams dp = drop_params<DROP>(a.dp);
  const int p = threadIdx.x - kConsumers;
  const int sq = a.sq, nc = a.nc;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk * nc;
  const int nsub = nc * kZH;
  int kt = 0, qs = 0, n = 0;  // key tiles, stages and items so far
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int z;
    const Item it = chunk_item<false, CAUSAL, R>(a, item, nblk, &z);
    mbar_wait(bars.own_empty(), (n & 1) ^ 1);
    {
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
        for (int c = 0; c < nc * kZ / 8; ++c) dsum += dot8(op[c], gp[c]);
        l = a.lse[(long long)it.bh * sq + row] * kLog2e;
        if (z == 0) a.delta[(long long)it.bh * sq + row] = dsum;
      }
      stat_s[p] = l;
      stat_s[kOwn + p] = dsum;
    }
    mbar_arrive(bars.own_full());
    for (int j = it.first; j < it.last; ++j, ++kt) {
      const int ks = kt % kZS, s0 = j * R;
      mbar_wait(bars.z_empty(ks), ((kt / kZS) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.z_full(ks), L::kZTile);
#pragma unroll
        for (int h = 0; h < kZH; ++h)
          tma_load_4d(base + L::kZAt + ks * L::kZTile + h * L::kKSub, tk,
                      bars.z_full(ks), z * kZ + h * 64, it.hi, s0, it.bi);
      }
      if (DROP)
        keep_words<false, R / 8>(dp, it.bh, it.own0, s0, p,
                                 keep_s + ks * kConsumers);
      mbar_arrive(bars.z_full(ks));
      for (int c = 0; c < nsub; ++c, ++qs) {
        const int st = qs % kDqS;
        mbar_wait(bars.qk_empty(st), ((qs / kDqS) & 1) ^ 1);
        if (p == 0) {
          const bool in_z = (c >> 2) == z;  // K_c is K_z's sub-tile c % 4
          const uint32_t at = base + st * L::kStage;
          mbar_expect_tx(bars.qk_full(st),
                         in_z ? L::kStage - L::kKSub : L::kStage);
          tma_load_4d(at, tq, bars.qk_full(st), c * 64, it.hi, it.own0,
                      it.bi);
          tma_load_4d(at + L::kQSub, tdo, bars.qk_full(st), c * 64, it.hi,
                      it.own0, it.bi);
          if (!in_z)
            tma_load_4d(at + 2 * L::kQSub, tk, bars.qk_full(st), c * 64,
                        it.hi, s0, it.bi);
          tma_load_4d(at + 2 * L::kQSub + L::kKSub, tv, bars.qk_full(st),
                      c * 64, it.hi, s0, it.bi);
          mbar_arrive(bars.qk_full(st));
        }
      }
    }
  }
}

// Warpgroup 2 produces (produce_dq). Warpgroups 0 and 1 consume 64 query
// rows each: per 32-key tile, S and dP summed over the head_dim's
// sub-tiles by wgmma_ss at N 32, one sub-tile's products in flight while
// the stage before is released; dS in registers; dQ_z += dS K_z by
// wgmma.
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgwide(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = DqLayout;
  constexpr int R = kBwdR;
  extern __shared__ __align__(1024) unsigned char smem_wgwide[];
  unsigned char* sm = align1024(smem_wgwide);
  const uint32_t base = smem_u32(sm);
  const BwdBars<kDqS> bars{base + L::kBar};
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kDqProdRegs>();
    produce_dq<CAUSAL, DROP>(&tq, &tdo, &tk, &tv, a, sm);
    return;
  }
  regs_inc<kDqConsRegs>();
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const float* stat_s = reinterpret_cast<const float*>(sm + L::kStat);
  const int sq = a.sq, sk = a.sk, nc = a.nc;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk * nc;
  const int nsub = nc * kZH;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
  const float scale2 = a.scale * kLog2e;
  // the warpgroup's rows of a stage's Q_c and dO_c
  const uint32_t own_q = wg * 64 * kLine, own_do = L::kQSub + own_q;
  int kt = 0, qs = 0, n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int z;
    const Item it = chunk_item<false, CAUSAL, R>(a, item, nblk, &z);
    const int wrow = it.own0 + lrow;  // the warp's first query row
    const int rows[2] = {wrow + g, wrow + g + 8};
    float acc[kZH][32];
#pragma unroll
    for (int h = 0; h < kZH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    // lse * log2(e) and delta of the thread's two rows, and the keys
    // below klim[r] that row r may see
    mbar_wait(bars.own_full(), n & 1);
    float lse2[2], dl[2];
    int klim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = stat_s[lrow + g + 8 * r];
      dl[r] = stat_s[kOwn + lrow + g + 8 * r];
      klim[r] = rows[r] < sq ? (CAUSAL ? min(sk, rows[r] + 1) : sk) : 0;
    }
    release(bars.own_empty(), lane);
    // under a causal mask the k-tiles from wlast on lie wholly above this
    // warpgroup's rows (wlast > it.first: tile 0 meets every row)
    const int wlast =
        CAUSAL ? min(it.last, (it.own0 + wg * 64 + 63) / R + 1) : it.last;
    for (int j = it.first; j < wlast; ++j, ++kt) {
      const int ks = kt % kZS, s0 = j * R;
      const uint32_t kz = base + L::kZAt + ks * L::kZTile;
      mbar_wait(bars.z_full(ks), (kt / kZS) & 1);
      // S = sum_c Q_c K_c^T and dP = sum_c dO_c V_c^T
      float s[16], dp[16];
      {
        const int st = qs % kDqS;
        const uint32_t at = base + st * L::kStage;
        mbar_wait(bars.qk_full(st), (qs / kDqS) & 1);
        const uint32_t kc = z == 0 ? kz : at + 2 * L::kQSub;
        wgmma_fence();
        sub_scores_n32<false>(s, at + own_q, kc);
        sub_scores_n32<false>(dp, at + own_do,
                              at + 2 * L::kQSub + L::kKSub);
        wgmma_commit();
        ++qs;
      }
      for (int c = 1; c < nsub; ++c, ++qs) {
        const int st = qs % kDqS;
        const uint32_t at = base + st * L::kStage;
        mbar_wait(bars.qk_full(st), (qs / kDqS) & 1);
        const uint32_t kc =
            (c >> 2) == z ? kz + (c & 3) * L::kKSub : at + 2 * L::kQSub;
        wgmma_fence();
        sub_scores_n32<true>(s, at + own_q, kc);
        sub_scores_n32<true>(dp, at + own_do, at + 2 * L::kQSub + L::kKSub);
        wgmma_commit();
        wgmma_wait<1>();
        release(bars.qk_empty((qs - 1) % kDqS), lane);
      }
      wgmma_wait<0>();
      fence_acc<16>(s);
      fence_acc<16>(dp);
      release(bars.qk_empty((qs - 1) % kDqS), lane);
      const uint32_t keep = DROP ? keep_s[ks * kConsumers + tid] : 0u;
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
      // dQ_z += dS K_z
      uint32_t f[R / 16][4];
      pack_a<R / 16>(f, ds);
      pin_frags<R / 16>(f);
      wgmma_fence();
      accumulate<kZ, R>(acc, f, kz);
      wgmma_commit();
      wgmma_wait<0>();
      release(bars.z_empty(ks), lane);
    }
    // the tiles above this warpgroup's rows: only their stages
    for (int j = wlast; j < it.last; ++j, ++kt) {
      for (int c = 0; c < nsub; ++c, ++qs) {
        const int st = qs % kDqS;
        mbar_wait(bars.qk_full(st), (qs / kDqS) & 1);
        release(bars.qk_empty(st), lane);
      }
      const int ks = kt % kZS;
      mbar_wait(bars.z_full(ks), (kt / kZS) & 1);
      release(bars.z_empty(ks), lane);
    }
    fence_accs<kZ>(acc);
    store_acc<kZ>(static_cast<__nv_bfloat16*>(a.dq) + it.bi * a.dqs.b +
                      it.hi * a.dqs.n + z * kZ,
                  a.dqs.s, acc, rows, sq, a.scale, t);
  }
}

// Warpgroup 2 of dkv_wgwide: per 32-query tile of each work item one
// thread loads Q_z and dO_z, threads 0..31 stage the tile's lse *
// log2(e), 32..63 its delta, and all 128 compute its keep bits (thread p
// those of keep_words' pair p % 64 over query chunks 2 (p / 64) and 2 (p
// / 64) + 1 of the tile's 4, as in dkv_wg256); then one thread loads the
// tile's (K_c, V_c, Q_c, dO_c) sub-tiles (no Q_c or dO_c in chunk z's:
// the consumers read them from Q_z and dO_z).
template <bool CAUSAL, bool DROP>
__device__ __forceinline__ void produce_dkv(const CUtensorMap* tq,
                                            const CUtensorMap* tdo,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            const Args& a,
                                            unsigned char* sm) {
  using L = DkvLayout;
  constexpr int R = kBwdR;
  const uint32_t base = smem_u32(sm);
  const BwdBars<kDkvS> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  float* stat_s = reinterpret_cast<float*>(sm + L::kStat);
  const DropParams dp = drop_params<DROP>(a.dp);
  const int p = threadIdx.x - kConsumers;
  const int sq = a.sq, nc = a.nc;
  const int nblk = (a.sk + kKeys - 1) / kKeys;
  const int items = a.batch * a.n_heads * nblk * nc;
  const int nsub = nc * kZH;
  int qt = 0, qs = 0;  // query tiles and stages of this CTA so far
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int z;
    const Item it = chunk_item<true, CAUSAL, R, kKeys>(a, item, nblk, &z);
    for (int j = it.first; j < it.last; ++j, ++qt) {
      const int zs = qt % kZS, s0 = j * R;
      mbar_wait(bars.z_empty(zs), ((qt / kZS) & 1) ^ 1);
      if (p == 0) {
        const uint32_t at = base + L::kZAt + zs * 2 * L::kZTile;
        mbar_expect_tx(bars.z_full(zs), 2 * L::kZTile);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < kZH; ++h)
            tma_load_4d(at + i * L::kZTile + h * L::kQSub, i ? tdo : tq,
                        bars.z_full(zs), z * kZ + h * 64, it.hi, s0, it.bi);
      }
      if (p < 2 * R) {
        const int i = s0 + (p & (R - 1));
        float x = 0.f;
        if (i < sq)
          x = p < R ? a.lse[(long long)it.bh * sq + i] * kLog2e
                    : a.delta[(long long)it.bh * sq + i];
        stat_s[zs * 2 * R + p] = x;
      }
      if (DROP) {
        const int half = p >> 6;
        keep_words<true, R / 16>(dp, it.bh, it.own0, s0 + half * R / 2,
                                 p & 63,
                                 keep_s + (2 * zs + half) * kKeepWords);
      }
      mbar_arrive(bars.z_full(zs));
      for (int c = 0; c < nsub; ++c, ++qs) {
        const int st = qs % kDkvS;
        mbar_wait(bars.qk_empty(st), ((qs / kDkvS) & 1) ^ 1);
        if (p == 0) {
          const bool in_z = (c >> 2) == z;  // Q_c, dO_c are Q_z's, dO_z's
          const uint32_t at = base + st * L::kStage;
          mbar_expect_tx(bars.qk_full(st),
                         in_z ? 2 * L::kKSub : L::kStage);
          tma_load_4d(at, tk, bars.qk_full(st), c * 64, it.hi, it.own0,
                      it.bi);
          tma_load_4d(at + L::kKSub, tv, bars.qk_full(st), c * 64, it.hi,
                      it.own0, it.bi);
          if (!in_z) {
            tma_load_4d(at + 2 * L::kKSub, tq, bars.qk_full(st), c * 64,
                        it.hi, s0, it.bi);
            tma_load_4d(at + 2 * L::kKSub + L::kQSub, tdo, bars.qk_full(st),
                        c * 64, it.hi, s0, it.bi);
          }
          mbar_arrive(bars.qk_full(st));
        }
      }
    }
  }
}

// A consumer warpgroup of dkv_wgwide over the CTA's 64 keys: DK
// (warpgroup 1) accumulates dK_z += dS^T Q_z from S^T = sum_c K_c Q_c^T
// and dP^T = sum_c V_c dO_c^T, else (warpgroup 0) dV_z += dropout(P)^T
// dO_z from S^T alone, per 32-query tile; then writes its accumulator
// (dK times scale).
template <bool DK, bool CAUSAL, bool DROP>
__device__ __forceinline__ void consume_dkv(const Args& a,
                                            unsigned char* sm) {
  using L = DkvLayout;
  constexpr int R = kBwdR;
  const uint32_t base = smem_u32(sm);
  const BwdBars<kDkvS> bars{base + L::kBar};
  const uint32_t* keep_s = reinterpret_cast<const uint32_t*>(sm + L::kKeep);
  const float* stat_s = reinterpret_cast<const float*>(sm + L::kStat);
  const int sq = a.sq, sk = a.sk, nc = a.nc;
  const int nblk = (sk + kKeys - 1) / kKeys;
  const int items = a.batch * a.n_heads * nblk * nc;
  const int nsub = nc * kZH;
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale2 = a.scale * kLog2e;
  int qt = 0, qs = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int z;
    const Item it = chunk_item<true, CAUSAL, R, kKeys>(a, item, nblk, &z);
    const int wrow = it.own0 + warp * 16;  // the warp's first key
    const int rows[2] = {wrow + g, wrow + g + 8};
    float acc[kZH][32];
#pragma unroll
    for (int h = 0; h < kZH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    for (int j = it.first; j < it.last; ++j, ++qt) {
      const int zs = qt % kZS, s0 = j * R;
      const uint32_t zq = base + L::kZAt + zs * 2 * L::kZTile;
      const uint32_t zdo = zq + L::kZTile;
      mbar_wait(bars.z_full(zs), (qt / kZS) & 1);
      // S^T = sum_c K_c Q_c^T (and dP^T = sum_c V_c dO_c^T)
      float s[16];
      [[maybe_unused]] float dp[16];
      {
        const int st = qs % kDkvS;
        const uint32_t at = base + st * L::kStage;
        mbar_wait(bars.qk_full(st), (qs / kDkvS) & 1);
        const uint32_t qc = z == 0 ? zq : at + 2 * L::kKSub;
        wgmma_fence();
        sub_scores_n32<false>(s, at, qc);
        if constexpr (DK)
          sub_scores_n32<false>(dp, at + L::kKSub,
                                z == 0 ? zdo : qc + L::kQSub);
        wgmma_commit();
        ++qs;
      }
      for (int c = 1; c < nsub; ++c, ++qs) {
        const int st = qs % kDkvS;
        const uint32_t at = base + st * L::kStage;
        mbar_wait(bars.qk_full(st), (qs / kDkvS) & 1);
        const bool in_z = (c >> 2) == z;
        const uint32_t qc = in_z ? zq + (c & 3) * L::kQSub : at + 2 * L::kKSub;
        wgmma_fence();
        sub_scores_n32<true>(s, at, qc);
        if constexpr (DK)
          sub_scores_n32<true>(dp, at + L::kKSub,
                               in_z ? zdo + (c & 3) * L::kQSub
                                    : qc + L::kQSub);
        wgmma_commit();
        wgmma_wait<1>();
        release(bars.qk_empty((qs - 1) % kDkvS), lane);
      }
      wgmma_wait<0>();
      fence_acc<16>(s);
      if constexpr (DK) fence_acc<16>(dp);
      release(bars.qk_empty((qs - 1) % kDkvS), lane);
      uint32_t keep = 0u;
      if (DROP) {
        const uint32_t* w = keep_s + 2 * zs * kKeepWords + (tid & 127);
        keep = w[0] | (w[kKeepWords] << 8);
      }
      // the scores are only read from here on (flash_attn_bwd.cu)
      const bool edge = s0 + R > sq || it.own0 + kKeys > sk ||
                        (CAUSAL && s0 < wrow + 15);
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lo[r] = CAUSAL ? rows[r] - s0 - 2 * t : -R;
        hi[r] = rows[r] < sk ? sq - s0 - 2 * t : -R;
      }
      const float* lsec = stat_s + zs * 2 * R;
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
      // dK_z += dS^T Q_z, or dV_z += dropout(P)^T dO_z
      uint32_t f[R / 16][4];
      pack_a<R / 16>(f, x);
      pin_frags<R / 16>(f);
      wgmma_fence();
      accumulate<kZ, R>(acc, f, DK ? zq : zdo);
      wgmma_commit();
      wgmma_wait<0>();
      release(bars.z_empty(zs), lane);
    }
    fence_accs<kZ>(acc);
    if constexpr (DK)
      store_acc<kZ>(static_cast<__nv_bfloat16*>(a.dk) + it.bi * a.dks.b +
                        it.hi * a.dks.n + z * kZ,
                    a.dks.s, acc, rows, sk, a.scale, t);
    else
      store_acc<kZ>(static_cast<__nv_bfloat16*>(a.dv) + it.bi * a.dvs.b +
                        it.hi * a.dvs.n + z * kZ,
                    a.dvs.s, acc, rows, sk, 1.f, t);
  }
}

// Warpgroup 2 produces (produce_dkv). Warpgroups 0 and 1 consume the
// same 64 keys: 0 accumulates dV_z, 1 dK_z (consume_dkv).
template <bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wgwide(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_wgwide[];
  unsigned char* sm = align1024(smem_wgwide);
  const BwdBars<kDkvS> bars{smem_u32(sm) + DkvLayout::kBar};
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

// one CTA per SM, or one per work item (row blocks of `rows` over s rows
// of each (batch, head), times the nc chunks) when there are fewer
cudaError_t grid_of(const Args& a, int s, int rows, dim3* grid) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  const long long items =
      (long long)a.batch * a.n_heads * ((s + rows - 1) / rows) * a.nc;
  *grid = dim3((unsigned)(items < sms ? items : sms));
  return e;
}

template <bool C, bool P>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const Strides& qs, const Strides& ks,
                       const Strides& vs, int d, const Args& a,
                       cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, d, qs.b, qs.s, qs.n, kOwn) ||
      bf16_rows_map(&tk, k, b, a.sk, n, d, ks.b, ks.s, ks.n, kStrm) ||
      bf16_rows_map(&tv, v, b, a.sk, n, d, vs.b, vs.s, vs.n, kStrm))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sq, kOwn, &grid);
  if (e != cudaSuccess) return e;
  return go(fwd_wgwide<C, P>, grid, kWgThreads, Layout::kBytes, stream, tq,
            tk, tv, a);
}

template <bool C, bool P>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const Strides& qs, const Strides& ks,
                      const Strides& vs, int d, const Args& a,
                      cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tdo, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, d, qs.b, qs.s, qs.n, kOwn) ||
      bf16_rows_map(&tdo, a.dout, b, a.sq, n, d, a.dos.b, a.dos.s, a.dos.n,
                    kOwn) ||
      bf16_rows_map(&tk, k, b, a.sk, n, d, ks.b, ks.s, ks.n, kBwdR) ||
      bf16_rows_map(&tv, v, b, a.sk, n, d, vs.b, vs.s, vs.n, kBwdR))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sq, kOwn, &grid);
  if (e != cudaSuccess) return e;
  return go(dq_wgwide<C, P>, grid, kWgThreads, DqLayout::kBytes, stream, tq,
            tdo, tk, tv, a);
}

template <bool C, bool P>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const Strides& qs, const Strides& ks,
                       const Strides& vs, int d, const Args& a,
                       cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tdo, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, d, qs.b, qs.s, qs.n, kBwdR) ||
      bf16_rows_map(&tdo, a.dout, b, a.sq, n, d, a.dos.b, a.dos.s, a.dos.n,
                    kBwdR) ||
      bf16_rows_map(&tk, k, b, a.sk, n, d, ks.b, ks.s, ks.n, kKeys) ||
      bf16_rows_map(&tv, v, b, a.sk, n, d, vs.b, vs.s, vs.n, kKeys))
    return cudaErrorInvalidValue;
  dim3 grid;
  const cudaError_t e = grid_of(a, a.sk, kKeys, &grid);
  if (e != cudaSuccess) return e;
  return go(dkv_wgwide<C, P>, grid, kWgThreads, DkvLayout::kBytes, stream,
            tq, tdo, tk, tv, a);
}

}  // namespace

// The three entries take the arguments of pt_flash_attn_fwd,
// pt_flash_attn_bwd_dq and pt_flash_attn_bwd_dkv (flash_attn_fwd.cu,
// flash_attn_bwd.cu) and run only dtype 1 (bfloat16) at d a multiple of
// 256 above 256; ops/flash_attention.py's _kernel_entry sends those
// here (f32 goes to flash_attn_wide.cu). Strides are element strides
// (batch, seq, head) of [b, s, n, d] tensors whose head_dim stride is 1,
// in the layout the tensor maps describe: multiples of 8 elements, and
// a dimension of size 1 given the stride a packed tensor would have.
// The forward writes O contiguous [b, sq, n, d] and lse f32 [b, n, sq];
// the dQ entry reads o for delta = rowsum(dO * O) and writes delta f32
// [b, n, sq], which the dK/dV entry, launched after it on the same
// stream, then reads. dropout != 0 draws the keep bits from the
// threshold and the 64-bit seed at `seed` in device memory (lo, hi;
// read by the kernel); rinv = 1 / (1 - p). Returns 0 on success, a
// cudaError_t code if a launch or a tensor map was refused, or -1 for a
// dtype / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd_wgwide(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  if (dtype != 1 || d <= kZ || d % kZ) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.o = o; a.lse = lse;
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.nc = d / kZ;
  a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_fwd<C, P>(q, k, v, qs, ks, vs, d, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}

extern "C" int pt_flash_attn_bwd_dq_wgwide(
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
  if (dtype != 1 || d <= kZ || d % kZ) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.o = const_cast<void*>(o); a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = delta; a.dq = dq;
  a.os = {o_sb, o_ss, o_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dqs = {dq_sb, dq_ss, dq_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.nc = d / kZ;
  a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_dq<C, P>(q, k, v, qs, ks, vs, d, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}

extern "C" int pt_flash_attn_bwd_dkv_wgwide(
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
  if (dtype != 1 || d <= kZ || d % kZ) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  Args a{};
  a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.nc = d / kZ;
  a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
#define PT_GO(C, P) launch_dkv<C, P>(q, k, v, qs, ks, vs, d, a, st)
  const cudaError_t e =
      causal ? (dropout ? PT_GO(true, true) : PT_GO(true, false))
             : (dropout ? PT_GO(false, true) : PT_GO(false, false));
#undef PT_GO
  return (int)e;
}
