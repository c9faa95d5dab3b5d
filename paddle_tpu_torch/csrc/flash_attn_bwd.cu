// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = dropout(softmax(Q K^T * scale)) V, from O's gradient dO and the
// forward's per-row log-sum-exp, without materialising the [sq, sk]
// probabilities.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_dq_kernel` (:283) and
// `_dkv_kernel` (:319), launched by `_flash_bwd_pallas` through two
// pl.pallas_call. The same two-kernel split, and no atomics, so the
// gradients are the same from run to run:
//  * pt_flash_attn_bwd_dq: each CTA owns a block of query rows of one
//    (batch, head) and loops over the k-tiles; dQ = sum_j dS K * scale.
//    In bf16 it also computes delta = rowsum(dO * O) of its rows in f32,
//    uses it and writes it to a [b, n, sq] buffer for the next kernel.
//  * pt_flash_attn_bwd_dkv: each CTA owns a block of keys and loops over
//    the q-tiles; dV = sum_i dropout(P)^T dO, dK = sum_i dS^T Q * scale.
//    It launches after dQ on the same stream and reads that delta.
// Both recompute P = exp(Q K^T * scale - lse) as `_masked_probs` does,
// with the key bound `col < sk`, the query bound `row < sq` and the
// causal rule `row >= col` (top-left), so a masked link and a row with
// no valid key give exactly 0. With dropout they regenerate the
// forward's keep bits from philox.cuh (a pure function of seed, b*n +
// head, row, col) and mask and scale dP as pallas_kernels.py:306-308
// and :355-356 do: dS = P * (keep * dP / (1 - p) - delta).
//
// Layout. q, k, v, dO (and O for delta) are read as [b, s, n, h] through
// element strides (the head_dim stride is 1), so `qkv[:, :, i]` views go
// in without a copy; dq, dk, dv are written through strides too. lse and
// delta are f32 [b, n, sq].
//
// What bounds it on an H100. At b 48, s 512, n 12, h 64 one product
// 2*b*n*s^2*h is 19.33 GFLOP. dQ does 3 products (S, dP, dS K): 0.059 ms
// at 989 TFLOP/s of bf16; its bytes (q, k, v, dO read, dq written, lse
// and delta) are about 191 MB, 0.057 ms at 3.35 TB/s, so the two bounds
// nearly balance. dK/dV does 4 products (S, dP, P^T dO, dS^T Q): 0.078
// ms, bound by operations. In f32 the products run on the FP32 pipes
// (67 TFLOP/s), 14.8x slower, so f32 is bound by operations.
//
// What the design does about that (and about what held the mma.sync
// kernels back: 16-row warps reloading every B fragment, 2 CTAs of 4
// warps per SM with synchronous double buffering, Philox rounds on the
// critical path, delta in eager torch ops).
//  * bf16 (dq_wgmma, dkv_wgmma), warp-specialised: a CTA of 384 threads
//    owns 128 rows (query rows for dQ, keys for dK/dV). Warpgroups 0 and
//    1 are consumers of 64 rows each; warpgroup 2 is the producer and
//    gives up registers (setmaxnreg 64 against the consumers' 216). One
//    producer thread loads the owned tiles (Q and dO, or K and V) once
//    and streams the 64-row tiles of the other side (K and V, or Q and
//    dO) by TMA into an mbarrier ring of 4 stages (2 at h 128), 128-byte
//    swizzled. The tensor maps describe the strided [b, s, n, h] views
//    as they are, and TMA's out-of-bounds zero fill gives the ragged
//    edge. No consumer thread spends an instruction on a copy. The grid
//    is one such CTA per SM, each walking over (batch, head, row block)
//    work items, so the owned tiles of its next item load while it
//    finishes the current one. Both kernels are one pipeline
//    (bwd_wgmma); they differ in the side they own and in the
//    consumers' math.
//  * Every product is one warpgroup's wgmma.mma_async m64n64k16 (bf16
//    in, f32 accumulate): S and dP (S^T and dP^T in dK/dV) with both
//    operands in shared memory, K-major; dQ += dS K, dV += dropout(P)^T
//    dO and dK += dS^T Q with A from registers (the score accumulators
//    re-packed to bf16, as the Pallas kernels cast P and dS) and B from
//    shared memory, MN-major. B is read from shared memory once per 64
//    rows of A, not once per 16 rows as mma.sync did. The products of
//    the two consumer warpgroups interleave on the tensor
//    cores. The grid walks the row blocks of one (batch, head) first,
//    so the CTAs on the card at once read each streamed tile from L2.
//  * Dropout: the 128 producer threads compute the stage's keep bits
//    (Philox4x32-10 from philox.cuh, the same pure function of seed,
//    b*n + head, row, col) while the consumers run the previous stages'
//    products, and hand each consumer thread its 32 bits as one word in
//    shared memory. So the integer rounds overlap the tensor cores and
//    run on warps of their own, not on the consumers' critical path.
//    The wgmma accumulator layout is mma.sync's m16n8 layout, so each
//    lane pair (g, g^1) still shares two 2x2 Philox blocks per chunk.
//  * delta is folded into the dQ kernel: one f32 pass over its own rows
//    of O and dO while the first tiles load, where torch ops made f32
//    copies of both. The producer of dK/dV stages lse and delta with
//    each Q/dO tile.
//  * exp is one ex2.approx per probability, with the scale folded in;
//    masking runs only on tiles that cross a bound or the diagonal and
//    sets a masked probability to exactly 0.
//  * f32 (dq_simt, dkv_simt): exact FFMA, no TF32, so the gradients
//    agree with a float32 reference to ~1e-6; delta comes from torch
//    ops. Every thread owns a 4x4 block of the scores; operands sit
//    transposed in shared memory so an inner step is 16-byte shared
//    loads feeding 16 FMAs. dK/dV takes 32-key tiles so that h = 128
//    fits the 227 KB of shared memory.

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

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // bf16 dQ: written; otherwise read
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int batch, n_heads, sq, sk;
  float scale;
  DropParams dp;
};

__device__ __forceinline__ bool link_ok(bool causal, int row, int col,
                                        int sq, int sk) {
  return row < sq && col < sk && (!causal || row >= col);
}

// ------------------------------------------------------------ f32, FFMA

constexpr int kLd = kBM + 4;        // transposed 64-row tile stride (floats)
constexpr int kDqThreads = 256;     // 16 row groups x 16 column groups
constexpr int kKB = 32;             // keys per dK/dV CTA in f32
constexpr int kKLd = kKB + 4;       // transposed 32-key tile stride
constexpr int kKvThreads = 128;     // 8 key groups x 16 query groups

template <int D>
constexpr size_t dq_simt_smem() {
  return (4 * D * kLd + kBN * D + kBN * kLd) * sizeof(float);
}

template <int D>
constexpr size_t dkv_simt_smem() {
  return (2 * D * kKLd + 2 * D * kLd + 2 * kBM * D + 2 * kBM * kKLd +
          2 * kBM) * sizeof(float);
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kDqThreads) dq_simt(BwdArgs a) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int G = D / 64;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  float* Qt = reinterpret_cast<float*>(smem_dq);  // [D][kLd]
  float* dOt = Qt + D * kLd;                      // [D][kLd]
  float* Kt = dOt + D * kLd;                      // [D][kLd]
  float* Vt = Kt + D * kLd;                       // [D][kLd]
  float* Ks = Vt + D * kLd;                       // [kBN][D]
  float* dSt = Ks + kBN * D;                      // [kBN][kLd] dS, transposed

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int r = tid >> 4;  // rows r*4 .. r*4+3
  const int c = tid & 15;  // score columns c*4 ..; dQ columns c*4+64g ..
  const int sq = a.sq, sk = a.sk;

  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const float* db =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  load_tile_t<D, kBM, kDqThreads>(Qt, kLd, qb, a.qs.s, q0, sq, 1.f, tid);
  load_tile_t<D, kBM, kDqThreads>(dOt, kLd, db, a.dos.s, q0, sq, 1.f, tid);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    lse_r[i] = row < sq ? a.lse[(long long)bh * sq + row] : 0.f;
    dl_r[i] = row < sq ? a.delta[(long long)bh * sq + row] : 0.f;
  }
  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;

  int nk = (sk + kBN - 1) / kBN;
  if (CAUSAL) nk = causal_tiles(nk, q0);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the last tile's reads are done
    load_tile_t<D, kBN, kDqThreads>(Kt, kLd, kb, a.ks.s, k0, sk, 1.f, tid);
    load_tile_t<D, kBN, kDqThreads>(Vt, kLd, vb, a.vs.s, k0, sk, 1.f, tid);
    load_tile<D, kBN, kDqThreads>(Ks, kb, a.ks.s, k0, sk, tid);
    __syncthreads();

    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLd + r * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * kLd + c * 4]);
      const float4 oa = *reinterpret_cast<const float4*>(&dOt[d * kLd + r * 4]);
      const float4 va = *reinterpret_cast<const float4*>(&Vt[d * kLd + c * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dpv[i][j] = fmaf(ov[i], vv[j], dpv[i][j]);
        }
    }
    if (DROP) {
#pragma unroll
      for (int ip = 0; ip < 2; ++ip)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = q0 + r * 4 + ip * 2, col = k0 + c * 4 + jp * 2;
          const uint4 w = drop_block(a.dp, bh, row, col);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              float& e = dpv[ip * 2 + x][jp * 2 + y];
              e = drop_keep(a.dp, w, row + x, col + y) ? e * a.dp.rinv : 0.f;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = link_ok(CAUSAL, q0 + r * 4 + i, k0 + c * 4 + j, sq, sk);
        const float p = ok ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dpv[i][j] - dl_r[i]);  // dS
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSt[(c * 4 + j) * kLd + r * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&dSt[kk * kLd + r * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(&Ks[kk * D + g * 64 + c * 4]);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], xv[j], acc[i][g * 4 + j]);
      }
    }
  }

  float* out = static_cast<float*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float4*>(&out[(long long)row * a.dqs.s + g * 64 + c * 4]) =
          make_float4(acc[i][g * 4] * a.scale, acc[i][g * 4 + 1] * a.scale,
                      acc[i][g * 4 + 2] * a.scale, acc[i][g * 4 + 3] * a.scale);
  }
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kKvThreads) dkv_simt(BwdArgs a) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int G = D / 64;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  float* Kt = reinterpret_cast<float*>(smem_dkv);  // [D][kKLd]
  float* Vt = Kt + D * kKLd;                       // [D][kKLd]
  float* Qt = Vt + D * kKLd;                       // [D][kLd]
  float* dOt = Qt + D * kLd;                       // [D][kLd]
  float* Qs = dOt + D * kLd;                       // [kBM][D]
  float* dOs = Qs + kBM * D;                       // [kBM][D]
  float* Ps = dOs + kBM * D;                       // [kBM][kKLd] dropout(P)
  float* dSs = Ps + kBM * kKLd;                    // [kBM][kKLd] dS
  float* lse_s = dSs + kBM * kKLd;                 // [kBM]
  float* dl_s = lse_s + kBM;                       // [kBM]

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * kKB;
  const int tid = threadIdx.x;
  const int r = tid >> 4;  // keys r*4 .. r*4+3
  const int c = tid & 15;  // score queries c*4 ..; dK/dV columns c*4+64g ..
  const int sq = a.sq, sk = a.sk;

  const float* qb = static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const float* kb = static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const float* vb = static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const float* db =
      static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  load_tile_t<D, kKB, kKvThreads>(Kt, kKLd, kb, a.ks.s, k0, sk, 1.f, tid);
  load_tile_t<D, kKB, kKvThreads>(Vt, kKLd, vb, a.vs.s, k0, sk, 1.f, tid);
  float dk[4][4 * G], dv[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (sq + kBM - 1) / kBM;
  // causal: q-tiles whose last row reaches this tile's first key
  const int first = CAUSAL ? k0 / kBM : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int i0 = qt * kBM;
    __syncthreads();  // the last tile's reads are done
    load_tile_t<D, kBM, kKvThreads>(Qt, kLd, qb, a.qs.s, i0, sq, 1.f, tid);
    load_tile_t<D, kBM, kKvThreads>(dOt, kLd, db, a.dos.s, i0, sq, 1.f, tid);
    load_tile<D, kBM, kKvThreads>(Qs, qb, a.qs.s, i0, sq, tid);
    load_tile<D, kBM, kKvThreads>(dOs, db, a.dos.s, i0, sq, tid);
    for (int e = tid; e < kBM; e += kKvThreads) {
      const bool in = i0 + e < sq;
      lse_s[e] = in ? a.lse[(long long)bh * sq + i0 + e] : 0.f;
      dl_s[e] = in ? a.delta[(long long)bh * sq + i0 + e] : 0.f;
    }
    __syncthreads();

    // s[jj][ii]: key r*4+jj against query c*4+ii
    float s[4][4], dpv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * kKLd + r * 4]);
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kLd + c * 4]);
      const float4 va = *reinterpret_cast<const float4*>(&Vt[d * kKLd + r * 4]);
      const float4 oa = *reinterpret_cast<const float4*>(&dOt[d * kLd + c * 4]);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
      const float ov[4] = {oa.x, oa.y, oa.z, oa.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
          dpv[j][i] = fmaf(vv[j], ov[i], dpv[j][i]);
        }
    }
    float pd[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qrow = i0 + c * 4 + i, key = k0 + r * 4 + j;
        const bool ok = link_ok(CAUSAL, qrow, key, sq, sk);
        s[j][i] = ok ? expf(s[j][i] * a.scale - lse_s[c * 4 + i]) : 0.f;
        pd[j][i] = s[j][i];
      }
    if (DROP) {
#pragma unroll
      for (int ip = 0; ip < 2; ++ip)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int qrow = i0 + c * 4 + ip * 2, key = k0 + r * 4 + jp * 2;
          const uint4 w = drop_block(a.dp, bh, qrow, key);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              const bool keep = drop_keep(a.dp, w, qrow + x, key + y);
              float& p = pd[jp * 2 + y][ip * 2 + x];
              float& g = dpv[jp * 2 + y][ip * 2 + x];
              p = keep ? p * a.dp.rinv : 0.f;
              g = keep ? g * a.dp.rinv : 0.f;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = dl_s[c * 4 + i];
      *reinterpret_cast<float4*>(&Ps[(c * 4 + i) * kKLd + r * 4]) =
          make_float4(pd[0][i], pd[1][i], pd[2][i], pd[3][i]);
      *reinterpret_cast<float4*>(&dSs[(c * 4 + i) * kKLd + r * 4]) =
          make_float4(s[0][i] * (dpv[0][i] - dl), s[1][i] * (dpv[1][i] - dl),
                      s[2][i] * (dpv[2][i] - dl), s[3][i] * (dpv[3][i] - dl));
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < kBM; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[i * kKLd + r * 4]);
      const float4 ds = *reinterpret_cast<const float4*>(&dSs[i * kKLd + r * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float dsv[4] = {ds.x, ds.y, ds.z, ds.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 o =
            *reinterpret_cast<const float4*>(&dOs[i * D + g * 64 + c * 4]);
        const float4 qq =
            *reinterpret_cast<const float4*>(&Qs[i * D + g * 64 + c * 4]);
        const float ov[4] = {o.x, o.y, o.z, o.w};
        const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            dv[j][g * 4 + x] = fmaf(pv[j], ov[x], dv[j][g * 4 + x]);
            dk[j][g * 4 + x] = fmaf(dsv[j], qv[x], dk[j][g * 4 + x]);
          }
      }
    }
  }

  float* ok_ = static_cast<float*>(a.dk) + bi * a.dks.b + hi * a.dks.n;
  float* ov_ = static_cast<float*>(a.dv) + bi * a.dvs.b + hi * a.dvs.n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + r * 4 + j;
    if (key >= sk) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      *reinterpret_cast<float4*>(&ok_[(long long)key * a.dks.s + g * 64 + c * 4]) =
          make_float4(dk[j][g * 4] * a.scale, dk[j][g * 4 + 1] * a.scale,
                      dk[j][g * 4 + 2] * a.scale, dk[j][g * 4 + 3] * a.scale);
      *reinterpret_cast<float4*>(&ov_[(long long)key * a.dvs.s + g * 64 + c * 4]) =
          make_float4(dv[j][g * 4], dv[j][g * 4 + 1], dv[j][g * 4 + 2],
                      dv[j][g * 4 + 3]);
    }
  }
}

// ------------------------------------------ bf16, wgmma + TMA + mbarriers

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows
// is [D / 64 halves][R lines][128 bytes]. The two owned tiles of a work
// item (Q and dO for dQ; K and V for dK/dV) have two buffers, so that the
// next item's load overlaps this one's products; the two streamed tiles
// (K and V; Q and dO) have a ring of S stages. Each stage also holds the
// 32 keep bits of every consumer thread (u32 [256]). lse * log2(e) and
// delta go with their rows: in dQ with the owned buffer (f32 [2][2][128]),
// in dK/dV with the stage (f32 [S][2][64]).
template <int D, bool DKV>
struct Layout {
  static constexpr int H = D / 64, S = ring<D>();
  static constexpr int kOwnTile = H * kOwn * kLine;
  static constexpr int kStrmTile = H * kStrm * kLine;
  static constexpr int kOwnBytes = 2 * kOwnTile;  // a buffer of both tiles
  // owned tile i of buffer b at b * kOwnBytes + i * kOwnTile; streamed
  // tile i of stage st at kStrmAt + (i * S + st) * kStrmTile
  static constexpr int kStrmAt = 2 * kOwnBytes;
  static constexpr int kKeep = kStrmAt + 2 * S * kStrmTile;
  static constexpr int kStat = kKeep + S * kConsumers * 4;
  static constexpr int kBar =
      kStat + (DKV ? S * 2 * kStrm : 2 * 2 * kOwn) * 4;
  static constexpr int kBytes = kBar + (4 + 2 * S) * 8 + 1024;
};

// sum of the products of 8 bf16 pairs, in f32
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// The tensor maps of the owned tiles (Q, dO for dQ; K, V for dK/dV) and
// of the streamed ones (the other two)
struct Maps {
  const CUtensorMap* own[2];
  const CUtensorMap* strm[2];
};

// The pipeline of both bf16 kernels; DKV picks dK/dV's side and math,
// else dQ's. Warpgroup 2 produces: TMA from one thread, lse, delta and
// the keep bits from all 128. Warpgroups 0 and 1 consume 64 owned rows
// each: per streamed tile, S and dP by wgmma, then dS (and dropout(P)),
// then the accumulating products.
template <int D, bool DKV, bool CAUSAL, bool DROP>
__device__ __forceinline__ void bwd_wgmma(const Maps& m, const BwdArgs& a) {
  using L = Layout<D, DKV>;
  constexpr int H = L::H, S = L::S;
  extern __shared__ __align__(1024) unsigned char smem_bwd[];
  unsigned char* sm = align1024(smem_bwd);
  const uint32_t base = smem_u32(sm);
  const Bars<S> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  float* stat_s = reinterpret_cast<float*>(sm + L::kStat);
  const int sq = a.sq, sk = a.sk;
  const int nblk = ((DKV ? sk : sq) + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProducerRegs>();
    const int p = tid - kConsumers;
    int tile = 0, n = 0;  // streamed tiles and items of this CTA so far
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Item it = work_item<DKV, CAUSAL>(a, item, nblk);
      const int ob = n & 1;
      mbar_wait(bars.own_empty(ob), ((n >> 1) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.own_full(ob), L::kOwnBytes);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < H; ++h)
            tma_load_4d(base + ob * L::kOwnBytes + i * L::kOwnTile +
                            h * kOwn * kLine,
                        m.own[i], bars.own_full(ob), h * 64, it.hi, it.own0,
                        it.bi);
      }
      if constexpr (!DKV) {
        // lse * log2(e) and delta = rowsum(dO * O) of row own0 + p, in f32
        const int row = it.own0 + p;
        float l = 0.f, dsum = 0.f;
        if (row < sq) {
          const uint4* op = reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.o) + it.bi * a.os.b +
              row * a.os.s + it.hi * a.os.n);
          const uint4* gp = reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(a.dout) + it.bi * a.dos.b +
              row * a.dos.s + it.hi * a.dos.n);
#pragma unroll 4
          for (int c = 0; c < D / 8; ++c) dsum += dot8(op[c], gp[c]);
          l = a.lse[(long long)it.bh * sq + row] * kLog2e;
          a.delta[(long long)it.bh * sq + row] = dsum;
        }
        stat_s[ob * 2 * kOwn + p] = l;
        stat_s[ob * 2 * kOwn + kOwn + p] = dsum;
      }
      mbar_arrive(bars.own_full(ob));
      for (int j = it.first; j < it.last; ++j, ++tile) {
        const int st = tile % S, s0 = j * kStrm;
        mbar_wait(bars.empty(st), ((tile / S) & 1) ^ 1);
        if (p == 0) {
          mbar_expect_tx(bars.full(st), 2 * L::kStrmTile);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < H; ++h)
              tma_load_4d(base + L::kStrmAt + (i * S + st) * L::kStrmTile +
                              h * kStrm * kLine,
                          m.strm[i], bars.full(st), h * 64, it.hi, s0, it.bi);
        }
        if constexpr (DKV) {
          // threads 0..63 stage lse * log2(e) of the tile's rows, 64..127
          // their delta
          const int i = s0 + (p & (kStrm - 1));
          float x = 0.f;
          if (i < sq)
            x = p < kStrm ? a.lse[(long long)it.bh * sq + i] * kLog2e
                          : a.delta[(long long)it.bh * sq + i];
          stat_s[st * 2 * kStrm + p] = x;
        }
        if (DROP)
          keep_words<DKV>(a.dp, it.bh, it.own0, s0, p,
                          keep_s + st * kConsumers);
        mbar_arrive(bars.full(st));
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
    const float scale2 = a.scale * kLog2e;
    int tile = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Item it = work_item<DKV, CAUSAL>(a, item, nblk);
      const int ob = n & 1;
      const int wrow = it.own0 + lrow;  // the warp's first query row, or key
      const int rows[2] = {wrow + g, wrow + g + 8};
      // acc[0] sums the dS products (dQ, or dK); acc[1] is dK/dV's dV
      float acc[DKV ? 2 : 1][H][32];
#pragma unroll
      for (int x = 0; x < (DKV ? 2 : 1); ++x)
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[x][h][i] = 0.f;
      // the warpgroup's 64 rows of the owned tiles: Q and dO, or K and V
      const uint32_t own_a = base + ob * L::kOwnBytes + wg * 64 * kLine;
      const uint32_t own_b = own_a + L::kOwnTile;
      mbar_wait(bars.own_full(ob), (n >> 1) & 1);
      // dQ: lse * log2(e) and delta of the thread's two rows, and the keys
      // below klim[r] that row r may see
      [[maybe_unused]] float lse2[2], dl[2];
      [[maybe_unused]] int klim[2];
      if constexpr (!DKV) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse2[r] = stat_s[ob * 2 * kOwn + lrow + g + 8 * r];
          dl[r] = stat_s[ob * 2 * kOwn + kOwn + lrow + g + 8 * r];
          klim[r] = rows[r] < sq ? (CAUSAL ? min(sk, rows[r] + 1) : sk) : 0;
        }
      }

      for (int j = it.first; j < it.last; ++j, ++tile) {
        const int st = tile % S, s0 = j * kStrm;
        mbar_wait(bars.full(st), (tile / S) & 1);
        // the streamed tiles: K and V, or Q and dO
        const uint32_t strm_a = base + L::kStrmAt + st * L::kStrmTile;
        const uint32_t strm_b = strm_a + S * L::kStrmTile;

        // S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T, dP^T = V dO^T)
        float s[32], dp[32];
        wgmma_fence();
        scores<D>(s, own_a, strm_a);
        scores<D>(dp, own_b, strm_b);
        wgmma_commit();
        const uint32_t keep = DROP ? keep_s[st * kConsumers + tid] : 0u;
        wgmma_wait<0>();
        fence_acc(s);
        fence_acc(dp);

        // The scores are only read from here on: writing them in place
        // (a masked -inf, dS) makes ptxas serialise every wgmma
        if constexpr (DKV) {
          const bool edge = s0 + kStrm > sq || it.own0 + kOwn > sk ||
                            (CAUSAL && s0 < wrow + 15);
          int lo[2], hi2[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lo[r] = CAUSAL ? rows[r] - s0 - 2 * t : -kStrm;
            hi2[r] = rows[r] < sk ? sq - s0 - 2 * t : -kStrm;
          }
          const float* lsec = stat_s + st * 2 * kStrm;
          const float* dlc = lsec + kStrm;
          float pd[32], ds[32];  // dropout(P)^T and dS^T
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int qi = (i >> 2) * 8 + 2 * t + (i & 1);
            float pr = ex2(fmaf(s[i], scale2, -lsec[qi]));
            if (edge && !slot_ok(i, lo, hi2)) pr = 0.f;
            float d = dp[i];
            pd[i] = pr;
            if (DROP) {
              const bool kept = (keep >> i) & 1;
              d = kept ? d * a.dp.rinv : 0.f;
              pd[i] = kept ? pr * a.dp.rinv : 0.f;
            }
            ds[i] = pr * (d - dlc[qi]);
          }
          // dV += dropout(P)^T dO and dK += dS^T Q
          uint32_t pf[4][4], sf[4][4];
          pack_a(pf, pd);
          pack_a(sf, ds);
          pin_frags(pf);
          pin_frags(sf);
          wgmma_fence();
          accumulate<D>(acc[1], pf, strm_b);
          accumulate<D>(acc[0], sf, strm_a);
        } else {
          const bool edge = s0 + kStrm > sk || it.own0 + kOwn > sq ||
                            (CAUSAL && s0 + kStrm - 1 > wrow);
          const int lo[2] = {0, 0};
          const int hi2[2] = {klim[0] - s0 - 2 * t, klim[1] - s0 - 2 * t};
          float ds[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            float pr = ex2(fmaf(s[i], scale2, -lse2[r]));
            if (edge && !slot_ok(i, lo, hi2)) pr = 0.f;
            float d = dp[i];
            if (DROP) d = ((keep >> i) & 1) ? d * a.dp.rinv : 0.f;
            ds[i] = pr * (d - dl[r]);
          }
          // dQ += dS K
          uint32_t f[4][4];
          pack_a(f, ds);
          pin_frags(f);
          wgmma_fence();
          accumulate<D>(acc[0], f, strm_a);
        }
        wgmma_commit();
        wgmma_wait<0>();
        release(bars.empty(st), lane);
      }
      release(bars.own_empty(ob), lane);
#pragma unroll
      for (int x = 0; x < (DKV ? 2 : 1); ++x) fence_accs<D>(acc[x]);
      if constexpr (DKV) {
        store_acc<D>(static_cast<__nv_bfloat16*>(a.dk) + it.bi * a.dks.b +
                         it.hi * a.dks.n,
                     a.dks.s, acc[0], rows, sk, a.scale, t);
        store_acc<D>(static_cast<__nv_bfloat16*>(a.dv) + it.bi * a.dvs.b +
                         it.hi * a.dvs.n,
                     a.dvs.s, acc[1], rows, sk, 1.f, t);
      } else {
        store_acc<D>(static_cast<__nv_bfloat16*>(a.dq) + it.bi * a.dqs.b +
                         it.hi * a.dqs.n,
                     a.dqs.s, acc[0], rows, sq, a.scale, t);
      }
    }
  }
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const BwdArgs a) {
  bwd_wgmma<D, false, CAUSAL, DROP>(Maps{{&tq, &tdo}, {&tk, &tv}}, a);
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const BwdArgs a) {
  bwd_wgmma<D, true, CAUSAL, DROP>(Maps{{&tk, &tv}, {&tq, &tdo}}, a);
}

// ------------------------------------------------------------ launching

// The wgmma kernels: tensor maps of the four [b, s, n, h] inputs, whose
// boxes are kOwn rows for the CTA's own side (Q, dO for dQ; K, V for
// dK/dV) and kStrm rows for the streamed side; one CTA per SM, or one
// per work item when there are fewer
template <int D, bool C, bool P, bool DKV>
cudaError_t go_wgmma(const BwdArgs& a, cudaStream_t stream) {
  const int rq = DKV ? kStrm : kOwn, rk = DKV ? kOwn : kStrm;
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tdo, tk, tv;
  if (bf16_rows_map(&tq, a.q, b, a.sq, n, D, a.qs.b, a.qs.s, a.qs.n, rq) ||
      bf16_rows_map(&tdo, a.dout, b, a.sq, n, D, a.dos.b, a.dos.s, a.dos.n,
                    rq) ||
      bf16_rows_map(&tk, a.k, b, a.sk, n, D, a.ks.b, a.ks.s, a.ks.n, rk) ||
      bf16_rows_map(&tv, a.v, b, a.sk, n, D, a.vs.b, a.vs.s, a.vs.n, rk))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long items =
      (long long)b * n * (((DKV ? a.sk : a.sq) + kOwn - 1) / kOwn);
  const dim3 grid((unsigned)(items < sms ? items : sms));
  if constexpr (DKV)
    return go(dkv_wgmma<D, C, P>, grid, kWgThreads, Layout<D, true>::kBytes,
              stream, tq, tdo, tk, tv, a);
  else
    return go(dq_wgmma<D, C, P>, grid, kWgThreads, Layout<D, false>::kBytes,
              stream, tq, tdo, tk, tv, a);
}

// The dQ kernel of each dtype, and with it the role of BwdArgs.delta:
// bf16 runs dq_wgmma, which computes delta = rowsum(dO * O) and writes
// it (an output); f32 runs dq_simt, which reads the caller's delta (an
// input). ops/flash_attention.py's _delta_in_kernel states the same rule.
template <int D, bool C, bool P>
cudaError_t launch_dq(int dtype, const BwdArgs& a, cudaStream_t st) {
  const int b = a.batch;
  if (dtype == 1) return go_wgmma<D, C, P, false>(a, st);
  return go(dq_simt<D, C, P>, dim3(b * a.n_heads, (a.sq + kBM - 1) / kBM),
            kDqThreads, dq_simt_smem<D>(), st, a);
}

template <int D, bool C, bool P>
cudaError_t launch_dkv(int dtype, const BwdArgs& a, cudaStream_t st) {
  const int b = a.batch;
  if (dtype == 1) return go_wgmma<D, C, P, true>(a, st);
  return go(dkv_simt<D, C, P>, dim3(b * a.n_heads, (a.sk + kKB - 1) / kKB),
            kKvThreads, dkv_simt_smem<D>(), st, a);
}

template <bool DKV>
int dispatch(int dtype, int d, int causal, int dropout, const BwdArgs& a,
             cudaStream_t st) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return -1;
#define PT_GO(D, C, P)                                                \
  (DKV ? launch_dkv<D, C, P>(dtype, a, st)                            \
       : launch_dq<D, C, P>(dtype, a, st))
#define PT_DROP(D, C) (dropout ? PT_GO(D, C, true) : PT_GO(D, C, false))
  cudaError_t e;
  if (d == 64)
    e = causal ? PT_DROP(64, true) : PT_DROP(64, false);
  else
    e = causal ? PT_DROP(128, true) : PT_DROP(128, false);
#undef PT_DROP
#undef PT_GO
  return (int)e;
}

}  // namespace

// dtype: 0 = float32 (FFMA kernels), 1 = bfloat16 (wgmma kernels).
// Strides are element strides (batch, seq, head) of [b, s, n, h] tensors
// whose head_dim stride is 1; in bf16 they are the layout the tensor
// maps describe: multiples of 8 elements, and a dimension of size 1
// given the stride a packed tensor would have. dropout != 0 regenerates
// the forward's keep bits from (threshold, seed_lo, seed_hi); rinv =
// 1 / (1 - p). delta: in bf16 the dQ kernel writes rowsum(dO * O) there
// (o is read for it); in f32 it is read (see launch_dq). Returns 0 on
// success, a cudaError_t code if a launch or a tensor map was refused,
// or -1 for a dtype / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_bwd_dq(
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
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq = dq;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.os = {o_sb, o_ss, o_sn};
  a.dos = {do_sb, do_ss, do_sn}; a.dqs = {dq_sb, dq_ss, dq_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, seed_lo, seed_hi, rinv};
  return dispatch<false>(dtype, d, causal, dropout, a,
                         static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int pt_flash_attn_bwd_dkv(
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
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, seed_lo, seed_hi, rinv};
  return dispatch<true>(dtype, d, causal, dropout, a,
                        static_cast<cudaStream_t>(stream_ptr));
}
