// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// O = dropout(softmax(Q K^T * scale)) V, from O's gradient dO, the
// forward's per-row log-sum-exp and delta = rowsum(dO * O), without
// materialising the [sq, sk] probabilities.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_dq_kernel` and
// `_dkv_kernel` (launched by `_flash_bwd_pallas` through two
// pl.pallas_call). The same two-kernel split, and no atomics, so the
// gradients are the same from run to run:
//  * pt_flash_attn_bwd_dq: each CTA owns a 64-row q-tile of one
//    (batch, head) and loops over the k-tiles; dQ = sum_j dS K * scale.
//  * pt_flash_attn_bwd_dkv: each CTA owns a k-tile and loops over the
//    q-tiles; dV = sum_i dropout(P)^T dO, dK = sum_i dS^T Q * scale.
// Both recompute P = exp(Q K^T * scale - lse) as `_masked_probs` does,
// with the key bound `col < sk`, the query bound `row < sq` and the
// causal rule `row >= col` (top-left), so a masked link and a row with
// no valid key give exactly 0. With dropout they regenerate the
// forward's keep bits from philox.cuh (a pure function of seed, b*n +
// head, row, col) and mask and scale dP as pallas_kernels.py:306-308
// and :355-356 do: dS = P * (keep * dP / (1 - p) - delta).
//
// Layout. q, k, v, dO are read as [b, s, n, h] through element strides
// (the head_dim stride is 1), so `qkv[:, :, i]` views go in without a
// copy; dq, dk, dv are written through strides too. lse and delta are
// f32 [b, n, sq].
//
// What bounds it on an H100. At b 48, s 512, n 12, h 64 one product
// 2*b*n*s^2*h is 19.33 GFLOP. dQ does 3 products (S, dP, dS K): 0.059 ms
// at 989 TFLOP/s of bf16; its bytes (q, k, v, dO read, dq written, lse
// and delta) are about 191 MB, 0.057 ms at 3.35 TB/s, so the two bounds
// nearly balance. dK/dV does 4 products (S, dP, P^T dO, dS^T Q): 0.078
// ms, bound by operations. In f32 the products run on the FP32 pipes
// (67 TFLOP/s), 14.8x slower, so f32 is bound by operations.
//
// What the design does about that.
//  * bf16 (dq_mma, dkv_mma): every product on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16 rows.
//    The score and dP accumulators stay in registers and are re-packed
//    as A fragments for the next product (P and dS are cast to bf16
//    before their products, as the Pallas kernels cast them); the
//    streamed tiles (K/V for dQ, Q/dO for dK/dV) are double-buffered by
//    cp.async and read by ldmatrix (.trans where the product needs the
//    other operand order). exp runs in base 2 with the scale folded in.
//    Masking is evaluated only on tiles that cross a bound or the
//    diagonal.
//  * f32 (dq_simt, dkv_simt): exact FFMA, no TF32, so the gradients
//    agree with a float32 reference to ~1e-6. Every thread owns a 4x4
//    block of the scores; operands sit transposed in shared memory so an
//    inner step is 16-byte shared loads feeding 16 FMAs. dK/dV takes
//    32-key tiles so that h = 128 fits the 227 KB of shared memory.
// Simple first: no TMA, no wgmma, no warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int n_heads, sq, sk;
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

// ------------------------------------------------- bf16, tensor cores

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

// two resident 64-row tiles + two buffers of two streamed tiles
template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(2 * kBM + 4 * kBN) * mma_ld<D>() * sizeof(__nv_bfloat16);
}

template <int D>
constexpr size_t dkv_mma_smem() {
  return mma_smem_bytes<D>() + 4 * kBM * sizeof(float);
}

// A fragment of one warp's 16 rows x k16 step kc of a [.., LD] tile
template <int D>
__device__ __forceinline__ void ld_a(uint32_t* f, const __nv_bfloat16* tile,
                                     int row0, int kc, int lane) {
  const int lr = lane & 7, lm = lane >> 3;
  ldsm_x4(f, tile + (row0 + lr + (lm & 1) * 8) * mma_ld<D>() + kc * 16 +
                 (lm >> 1) * 8);
}

// acc[nc] += A (KC fragments) x B^T over the 64 rows of `tile` (B's n)
template <int D>
__device__ __forceinline__ void mma_abt(float (*acc)[4], uint32_t (*fa)[4],
                                        const __nv_bfloat16* tile, int lane) {
  constexpr int KC = D / 16, NC = 64 / 8;
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int nc = 0; nc < NC; ++nc)
#pragma unroll
    for (int kc = 0; kc < KC; kc += 2) {
      uint32_t bf[4];  // b0, b1 of k-steps kc and kc + 1
      ldsm_x4(bf, tile + (nc * 8 + lr) * mma_ld<D>() + kc * 16 + lm * 8);
      mma_16816(acc[nc], fa[kc], bf[0], bf[1]);
      mma_16816(acc[nc], fa[kc + 1], bf[2], bf[3]);
    }
}

// acc[dn] += X (64 columns in the score layout, cast to bf16) x tile,
// where tile is [64 rows = X's columns][D]: X's chunks 2j, 2j+1 re-pack
// as the m16k16 A fragment of rows 16j .. 16j+15, and the tile's B
// fragments come transposed by ldmatrix
template <int D>
__device__ __forceinline__ void mma_xb(float (*acc)[4], float (*x)[4],
                                       const __nv_bfloat16* tile, int lane) {
  constexpr int DN = D / 8;
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int j = 0; j < 64 / 16; ++j) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    pa[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    pa[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    pa[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      uint32_t bf[4];  // b0, b1 of column chunks dn and dn + 1
      ldsm_x4_t(bf, tile + (j * 16 + lr + (lm & 1) * 8) * mma_ld<D>() +
                        (dn + (lm >> 1)) * 8);
      mma_16816(acc[dn], pa, bf[0], bf[1]);
      mma_16816(acc[dn + 1], pa, bf[2], bf[3]);
    }
  }
}

// write a warp's 16 x D f32 accumulator as bf16 rows (times mul)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride,
                                           float (*acc)[4],
                                           const int* rows, int limit,
                                           float mul, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= limit) continue;
    __nv_bfloat16* out = base + (long long)rows[h] * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(&out[dn * 8 + 2 * t]) =
          pack_bf16(acc[dn][2 * h] * mul, acc[dn][2 * h + 1] * mul);
  }
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kMmaThreads) dq_mma(BwdArgs a) {
  constexpr int LD = mma_ld<D>();
  constexpr int KC = D / 16, NC = kBN / 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_dqm[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_dqm);  // [kBM][LD]
  __nv_bfloat16* dOs = Qs + kBM * LD;     // [kBM][LD]
  __nv_bfloat16* Ks = dOs + kBM * LD;     // [2][kBN][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBN * LD;  // [2][kBN][LD]

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sq = a.sq, sk = a.sk;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const __nv_bfloat16* db =
      static_cast<const __nv_bfloat16*>(a.dout) + bi * a.dos.b + hi * a.dos.n;
  const float scale2 = a.scale * kLog2e;

  int nk = (sk + kBN - 1) / kBN;
  if (CAUSAL) nk = causal_tiles(nk, q0);

  load_tile_async<D, kBM, kMmaThreads>(Qs, qb, a.qs.s, q0, sq, tid);
  load_tile_async<D, kBM, kMmaThreads>(dOs, db, a.dos.s, q0, sq, tid);
  load_tile_async<D, kBN, kMmaThreads>(Ks, kb, a.ks.s, 0, sk, tid);
  load_tile_async<D, kBN, kMmaThreads>(Vs, vb, a.vs.s, 0, sk, tid);
  cp_async_commit();

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < sq;
    lse2[h] = in ? a.lse[(long long)bh * sq + rows[h]] * kLog2e : 0.f;
    dl[h] = in ? a.delta[(long long)bh * sq + rows[h]] : 0.f;
  }
  uint32_t qa[KC][4], da[KC][4];
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBN;
    const __nv_bfloat16* Kc = Ks + (kt & 1) * kBN * LD;
    const __nv_bfloat16* Vc = Vs + (kt & 1) * kBN * LD;
    if (kt + 1 < nk) {
      load_tile_async<D, kBN, kMmaThreads>(Ks + ((kt + 1) & 1) * kBN * LD, kb,
                                           a.ks.s, k0 + kBN, sk, tid);
      load_tile_async<D, kBN, kMmaThreads>(Vs + ((kt + 1) & 1) * kBN * LD, vb,
                                           a.vs.s, k0 + kBN, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ld_a<D>(qa[kc], Qs, warp * 16, kc, lane);
        ld_a<D>(da[kc], dOs, warp * 16, kc, lane);
      }
    }

    // S = Q K^T and dP = dO V^T: slot e of chunk nc is
    // (rows[e >> 1], k0 + nc*8 + 2t + (e & 1))
    float s[NC][4], dpv[NC][4];
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nc][e] = dpv[nc][e] = 0.f;
    mma_abt<D>(s, qa, Kc, lane);
    mma_abt<D>(dpv, da, Vc, lane);

    if (DROP) {
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int col = k0 + nc * 8 + 2 * t;
        uint4 wlo, whi;
        philox_pair(a.dp, bh, g & 1, rows[0], col, rows[1], col, 4, wlo, whi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = drop_keep(a.dp, (e >> 1) ? whi : wlo,
                                      rows[e >> 1], col + (e & 1));
          dpv[nc][e] = keep ? dpv[nc][e] * a.dp.rinv : 0.f;
        }
      }
    }
    const bool edge = k0 + kBN > sk || q0 + kBM > sq ||
                      (CAUSAL && k0 + kBN - 1 > q0 + warp * 16);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nc][e] * scale2 - lse2[e >> 1]);
        if (edge && !link_ok(CAUSAL, rows[e >> 1], k0 + nc * 8 + 2 * t + (e & 1),
                             sq, sk))
          p = 0.f;
        s[nc][e] = p * (dpv[nc][e] - dl[e >> 1]);  // dS
      }
    // dQ += dS K
    mma_xb<D>(acc, s, Kc, lane);
    __syncthreads();  // all reads of this buffer are done before its refill
  }

  store_rows<D>(static_cast<__nv_bfloat16*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n,
                a.dqs.s, acc, rows, sq, a.scale, t);
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kMmaThreads) dkv_mma(BwdArgs a) {
  constexpr int LD = mma_ld<D>();
  constexpr int KC = D / 16, NC = kBM / 8, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_dkvm[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_dkvm);  // [kBN][LD]
  __nv_bfloat16* Vs = Ks + kBN * LD;      // [kBN][LD]
  __nv_bfloat16* Qs = Vs + kBN * LD;      // [2][kBM][LD]
  __nv_bfloat16* dOs = Qs + 2 * kBM * LD; // [2][kBM][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kBM * LD);  // [2][kBM]
  float* dl_s = lse_s + 2 * kBM;                                // [2][kBM]

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int sq = a.sq, sk = a.sk;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const __nv_bfloat16* db =
      static_cast<const __nv_bfloat16*>(a.dout) + bi * a.dos.b + hi * a.dos.n;
  const float scale2 = a.scale * kLog2e;
  const float* lse_row = a.lse + (long long)bh * sq;
  const float* dl_row = a.delta + (long long)bh * sq;

  const int nq = (sq + kBM - 1) / kBM;
  // causal: q-tiles whose last row reaches this tile's first key
  const int first = CAUSAL ? k0 / kBM : 0;

  load_tile_async<D, kBN, kMmaThreads>(Ks, kb, a.ks.s, k0, sk, tid);
  load_tile_async<D, kBN, kMmaThreads>(Vs, vb, a.vs.s, k0, sk, tid);
  if (first < nq) {
    load_tile_async<D, kBM, kMmaThreads>(Qs, qb, a.qs.s, first * kBM, sq, tid);
    load_tile_async<D, kBM, kMmaThreads>(dOs, db, a.dos.s, first * kBM, sq, tid);
    for (int e = tid; e < kBM; e += kMmaThreads) {
      const int i = first * kBM + e;
      lse_s[e] = i < sq ? lse_row[i] * kLog2e : 0.f;
      dl_s[e] = i < sq ? dl_row[i] : 0.f;
    }
  }
  cp_async_commit();

  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int qt = first; qt < nq; ++qt) {
    const int it = qt - first;
    const int i0 = qt * kBM;
    const int buf = it & 1;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      load_tile_async<D, kBM, kMmaThreads>(Qs + nb * kBM * LD, qb, a.qs.s,
                                           i0 + kBM, sq, tid);
      load_tile_async<D, kBM, kMmaThreads>(dOs + nb * kBM * LD, db, a.dos.s,
                                           i0 + kBM, sq, tid);
      for (int e = tid; e < kBM; e += kMmaThreads) {
        const int i = i0 + kBM + e;
        lse_s[nb * kBM + e] = i < sq ? lse_row[i] * kLog2e : 0.f;
        dl_s[nb * kBM + e] = i < sq ? dl_row[i] : 0.f;
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qc = Qs + buf * kBM * LD;
    const __nv_bfloat16* dOc = dOs + buf * kBM * LD;
    const float* lsec = lse_s + buf * kBM;
    const float* dlc = dl_s + buf * kBM;

    // S^T = K Q^T and dP^T = V dO^T: slot e of chunk nc is
    // (key keys[e >> 1], query i0 + nc*8 + 2t + (e & 1))
    float s[NC][4], dpv[NC][4];
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nc][e] = dpv[nc][e] = 0.f;
    {
      uint32_t fa[KC][4];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ld_a<D>(fa[kc], Ks, warp * 16, kc, lane);
      mma_abt<D>(s, fa, Qc, lane);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) ld_a<D>(fa[kc], Vs, warp * 16, kc, lane);
      mma_abt<D>(dpv, fa, dOc, lane);
    }

    const bool edge = i0 + kBM > sq || k0 + kBN > sk ||
                      (CAUSAL && i0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nc * 8 + 2 * t + (e & 1);
        float p = exp2f(s[nc][e] * scale2 - lsec[qi]);
        if (edge && !link_ok(CAUSAL, i0 + qi, keys[e >> 1], sq, sk)) p = 0.f;
        s[nc][e] = p;
      }
    if (DROP) {
      // lanes g and g^1 hold the same two 2x2 blocks of each chunk:
      // queries (2t, 2t+1) x keys (keys[0], keys[1])
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int qrow = i0 + nc * 8 + 2 * t;
        uint4 w0, w1;
        philox_pair(a.dp, bh, g & 1, qrow, keys[0], qrow, keys[1], 4, w0, w1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = drop_keep(a.dp, (e >> 1) ? w1 : w0,
                                      qrow + (e & 1), keys[e >> 1]);
          const float p = s[nc][e];
          const float d = keep ? dpv[nc][e] * a.dp.rinv : 0.f;
          dpv[nc][e] = p * (d - dlc[nc * 8 + 2 * t + (e & 1)]);  // dS
          s[nc][e] = keep ? p * a.dp.rinv : 0.f;                  // dropout(P)
        }
      }
    } else {
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpv[nc][e] = s[nc][e] * (dpv[nc][e] - dlc[nc * 8 + 2 * t + (e & 1)]);
    }
    // dV += dropout(P)^T dO and dK += dS^T Q
    mma_xb<D>(dv, s, dOc, lane);
    mma_xb<D>(dk, dpv, Qc, lane);
    __syncthreads();  // all reads of this buffer are done before its refill
  }
  cp_async_wait<0>();  // a CTA that saw no q-tile still has K/V in flight

  store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + bi * a.dks.b + hi * a.dks.n,
                a.dks.s, dk, keys, sk, a.scale, t);
  store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + bi * a.dvs.b + hi * a.dvs.n,
                a.dvs.s, dv, keys, sk, 1.f, t);
}

// ------------------------------------------------------------ launching

template <typename Kern>
cudaError_t go(Kern kern, dim3 grid, int threads, size_t smem,
               cudaStream_t stream, const BwdArgs& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool C, bool P>
cudaError_t launch_dq(int dtype, int bn, const BwdArgs& a, cudaStream_t st) {
  const dim3 grid(bn, (a.sq + kBM - 1) / kBM);
  if (dtype == 0)
    return go(dq_simt<D, C, P>, grid, kDqThreads, dq_simt_smem<D>(), st, a);
  return go(dq_mma<D, C, P>, grid, kMmaThreads, mma_smem_bytes<D>(), st, a);
}

template <int D, bool C, bool P>
cudaError_t launch_dkv(int dtype, int bn, const BwdArgs& a, cudaStream_t st) {
  if (dtype == 0)
    return go(dkv_simt<D, C, P>, dim3(bn, (a.sk + kKB - 1) / kKB), kKvThreads,
              dkv_simt_smem<D>(), st, a);
  return go(dkv_mma<D, C, P>, dim3(bn, (a.sk + kBN - 1) / kBN), kMmaThreads,
            dkv_mma_smem<D>(), st, a);
}

template <bool DKV>
int dispatch(int dtype, int bn, int d, int causal, int dropout,
             const BwdArgs& a, cudaStream_t st) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return -1;
#define PT_GO(D, C, P)                                                \
  (DKV ? launch_dkv<D, C, P>(dtype, bn, a, st)                        \
       : launch_dq<D, C, P>(dtype, bn, a, st))
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

// dtype: 0 = float32 (FFMA kernels), 1 = bfloat16 (tensor-core kernels).
// Strides are element strides (batch, seq, head) of [b, s, n, h] tensors
// whose head_dim stride is 1. dropout != 0 regenerates the forward's
// keep bits from (threshold, seed_lo, seed_hi); rinv = 1 / (1 - p).
// Returns 0 on success, a cudaError_t code if a launch was refused, or
// -1 for a dtype / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int dtype, int b, int n,
    int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    long long dq_sb, long long dq_ss, long long dq_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {o_sb, o_ss, o_sn};
  a.dqs = {dq_sb, dq_ss, dq_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, seed_lo, seed_hi, rinv};
  return dispatch<false>(dtype, b * n, d, causal, dropout, a,
                         static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int pt_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    long long o_sb, long long o_ss, long long o_sn,
    long long dk_sb, long long dk_ss, long long dk_sn,
    long long dv_sb, long long dv_ss, long long dv_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {o_sb, o_ss, o_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, seed_lo, seed_hi, rinv};
  return dispatch<true>(dtype, b * n, d, causal, dropout, a,
                        static_cast<cudaStream_t>(stream_ptr));
}
