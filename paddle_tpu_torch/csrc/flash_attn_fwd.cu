// Flash-attention forward for Hopper (sm_90a): O and the per-row
// log-sum-exp of softmax(Q K^T * scale) V, without materialising the
// [sq, sk] probabilities.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (launched by
// `_flash_fwd_pallas` through pl.pallas_call). Same function: the same
// scale, the key bound `col < sk`, the causal rule `row >= col`
// (top-left aligned) with k-tiles above the diagonal skipped, masking
// with -1e30, `l_safe = max(l, 1e-30)`, O = acc / l_safe and
// lse = m + log(l_safe). With dropout (DROP), as in the Pallas kernel:
// l sums the un-dropped probabilities, and the kept ones are scaled by
// 1/(1-p) before P V; the keep bits come from philox.cuh, a pure
// function of (seed, b*n + head, row, col) that the backward kernels
// (flash_attn_bwd.cu) regenerate. DROP = false compiles to the path
// without any Philox call.
//
// Layout. q, k, v are read as [b, s, n, h] through element strides
// (batch, seq, head; the head_dim stride is 1), so the strided views
// `qkv[:, :, 0]` of a fused qkv projection are read in place: no
// transpose and no copy. O is written contiguous [b, sq, n, h] and lse
// f32 [b, n, sq]. No TPU tiling is carried over: head_dim is not padded
// to 128 lanes, the sequence is not padded to 128-row blocks (the ragged
// edge is masked here), lse is not replicated over 8 sublanes. One CTA
// per (b*n, 64-row q-tile); a loop over 64-key tiles takes the place of
// the sequential k-block grid axis, with the running (m, l, acc) in
// registers.
//
// What bounds it on an H100. Per call the work is 4*b*n*sq*sk*h flops
// (half that, causal) against (3*b*s*n*h + b*sq*n*h) elements moved.
// At the ERNIE-base shape (b 32, s 512, n 12, h 64) that is 25.8 GFLOP
// against 100.7 MB in bf16: about 26 us at 989 TFLOP/s of bf16 tensor
// core time and 30 us at 3.35 TB/s, so bf16 is bound by bytes, barely.
// In f32 the bytes double (60 us) and the arithmetic runs on the FP32
// pipes (67 TFLOP/s, 385 us), so f32 is bound by operations.
//
// What the design does about that.
//  * bf16 (flash_fwd_mma): the two products run on the tensor cores
//    with mma.sync m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2
//    style: 4 warps, each owning 16 query rows, Q fragments held in
//    registers for the whole k loop, S and P never leave registers
//    (the S accumulator fragment is re-packed as the A fragment of
//    P V). P is rounded to bf16 before P V, as the Pallas kernel casts
//    p to v's dtype. K/V tiles stream into two shared-memory buffers by
//    cp.async, the next tile in flight while this one is computed;
//    fragments come out of shared memory by ldmatrix (.trans for V);
//    the softmax runs in base 2 with the scale folded in (one ex2 per
//    probability) and masks only the tiles that cross the key bound or
//    the diagonal.
//  * f32 (flash_fwd_simt): exact f32 FFMA, no TF32, so results agree
//    with a float32 reference to ~1e-6. 256 threads each own a 4x4
//    block of S and a 4x(h/16) block of O; tiles sit transposed in
//    shared memory so every inner step is two 16-byte shared loads for
//    16 FMAs.
//  * Dropout costs one Philox4x32-10 call per 2x2 block of links (ten
//    rounds of two 32-bit multiplies): in the mma kernel each pair of
//    lanes that shares two blocks computes one each and swaps them.
// Simple first: no TMA, no wgmma and no warp specialisation; those are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "philox.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ f32, FFMA

constexpr int kSimtThreads = 256;  // 16 row groups x 16 column groups
constexpr int kLd = kBM + 4;       // transposed-tile row stride (floats)

template <int D>
constexpr size_t simt_smem_bytes() {
  return (2 * D * kLd + kBN * D + kBN * kLd) * sizeof(float);
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int n_heads, int sq, int sk,
               Strides qs, Strides ks, Strides vs, float scale,
               DropParams dp) {
  static_assert(D % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int G = D / 64;  // 4-column groups of O per thread
  extern __shared__ __align__(16) unsigned char smem_simt[];
  float* Qt = reinterpret_cast<float*>(smem_simt);  // [D][kLd] q*scale, transposed
  float* Kt = Qt + D * kLd;    // [D][kLd]  k, transposed
  float* Vs = Kt + D * kLd;    // [kBN][D]
  float* Pt = Vs + kBN * D;    // [kBN][kLd] p, transposed

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  const int q0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int r = tid >> 4;  // rows r*4 .. r*4+3 of the tile
  const int c = tid & 15;  // S columns c*4 .. c*4+3; O columns c*4+64g ..

  const float* qb = q + bi * qs.b + hi * qs.n;
  const float* kb = k + bi * ks.b + hi * ks.n;
  const float* vb = v + bi * vs.b + hi * vs.n;

  for (int e = tid; e < kBM * D; e += kSimtThreads) {
    const int row = e / D, d = e % D;
    float x = 0.f;
    if (q0 + row < sq) x = qb[(long long)(q0 + row) * qs.s + d] * scale;
    Qt[d * kLd + row] = x;
  }

  float acc[4][4 * G];
  float m[4], lpart[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    lpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
  }

  int nk = (sk + kBN - 1) / kBN;
  if (CAUSAL) nk = causal_tiles(nk, q0);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the last tile's Kt/Vs/Pt reads are done
    for (int e = tid; e < kBN * D; e += kSimtThreads) {
      const int key = e / D, d = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + key < sk) {
        kx = kb[(long long)(k0 + key) * ks.s + d];
        vx = vb[(long long)(k0 + key) * vs.s + d];
      }
      Kt[d * kLd + key] = kx;
      Vs[key * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + r * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * kLd + c * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * 4 + i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + c * 4 + j;
        ok[j] = col < sk && (!CAUSAL || row >= col);
        s[i][j] = ok[j] ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group share rows: reduce the max over them
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      // l stays a per-lane partial sum; corr is uniform over the row
      lpart[i] = lpart[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * G; ++j) acc[i][j] *= corr;
    }
    if (DROP) {
      // rows r*4 .. r*4+3 and columns c*4 .. c*4+3: four 2x2 blocks
#pragma unroll
      for (int ip = 0; ip < 2; ++ip)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = q0 + r * 4 + ip * 2, col = k0 + c * 4 + jp * 2;
          const uint4 w = drop_block(dp, bh, row, col);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b2 = 0; b2 < 2; ++b2) {
              float& x = s[ip * 2 + a][jp * 2 + b2];
              x = drop_keep(dp, w, row + a, col + b2) ? x * dp.rinv : 0.f;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(c * 4 + j) * kLd + r * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * kLd + r * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(&Vs[kk * D + g * 64 + c * 4]);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], xv[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lpart[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = q0 + r * 4 + i;
    if (row < sq) {
      float* orow = o + ((long long)(bi * sq + row) * n_heads + hi) * D;
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float4*>(&orow[g * 64 + c * 4]) =
            make_float4(acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
                        acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      if (c == 0) lse[(long long)bh * sq + row] = m[i] + logf(l_safe);
    }
  }
}

// ------------------------------------------------- bf16, tensor cores

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

// Q tile + two buffers of K and V tiles
template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kBM + 4 * kBN) * mma_ld<D>() * sizeof(__nv_bfloat16);
}

template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
              int n_heads, int sq, int sk, Strides qs, Strides ks,
              Strides vs, float scale, DropParams dp) {
  static_assert(kBM == kBN, "load_tile_async assumes square tiles");
  constexpr int LD = mma_ld<D>();
  constexpr int KC = D / 16;   // k16 steps of Q K^T
  constexpr int NC = kBN / 8;  // n8 column chunks of S
  constexpr int DN = D / 8;    // n8 column chunks of O
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kBM][LD]
  __nv_bfloat16* Ks = Qs + kBM * LD;      // [2][kBN][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBN * LD;  // [2][kBN][LD]

  const int bh = blockIdx.x;
  const int bi = bh / n_heads, hi = bh % n_heads;
  const int q0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int lr = lane & 7;  // ldmatrix: row within the lane's matrix
  const int lm = lane >> 3; // ldmatrix: which of the four matrices

  const __nv_bfloat16* qb = q + bi * qs.b + hi * qs.n;
  const __nv_bfloat16* kb = k + bi * ks.b + hi * ks.n;
  const __nv_bfloat16* vb = v + bi * vs.b + hi * vs.n;
  const float scale2 = scale * kLog2e;  // softmax in base 2

  int nk = (sk + kBN - 1) / kBN;
  if (CAUSAL) nk = causal_tiles(nk, q0);

  // group 0: the Q tile and the first K/V tiles
  load_tile_async<D, kBN, kMmaThreads>(Qs, qb, qs.s, q0, sq, tid);
  load_tile_async<D, kBN, kMmaThreads>(Ks, kb, ks.s, 0, sk, tid);
  load_tile_async<D, kBN, kMmaThreads>(Vs, vb, vs.s, 0, sk, tid);
  cp_async_commit();

  uint32_t qa[KC][4];
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {kNeg, kNeg}, lpart[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;  // rows of fragment slots 0,1
  const int rows[2] = {row_lo, row_lo + 8};  // and 2,3

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBN;
    const __nv_bfloat16* Kc = Ks + (kt & 1) * kBN * LD;
    const __nv_bfloat16* Vc = Vs + (kt & 1) * kBN * LD;
    if (kt + 1 < nk) {
      // the next tile streams in while this one is computed
      load_tile_async<D, kBN, kMmaThreads>(Ks + ((kt + 1) & 1) * kBN * LD, kb, ks.s,
                         k0 + kBN, sk, tid);
      load_tile_async<D, kBN, kMmaThreads>(Vs + ((kt + 1) & 1) * kBN * LD, vb, vs.s,
                         k0 + kBN, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == 0) {
      // this warp's 16 Q rows as m16k16 A fragments, for the whole loop
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(qa[kc], Qs + (warp * 16 + lr + (lm & 1) * 8) * LD +
                            kc * 16 + (lm >> 1) * 8);
    }

    // S = Q K^T: slot e of chunk nc is (rows[e >> 1], k0 + nc*8 + 2t + (e & 1))
    float s[NC][4];
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nc][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
        uint32_t kf[4];  // b0, b1 of k-steps kc and kc + 1
        ldsm_x4(kf, Kc + (nc * 8 + lr) * LD + kc * 16 + lm * 8);
        mma_16816(s[nc], qa[kc], kf[0], kf[1]);
        mma_16816(s[nc], qa[kc + 1], kf[2], kf[3]);
      }
    }

    // masking only where the tile crosses the key bound or the diagonal
    const bool edge = k0 + kBN > sk ||
                      (CAUSAL && k0 + kBN - 1 > q0 + warp * 16);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nc][e] * scale2;
        if (edge) {
          const int col = k0 + nc * 8 + 2 * t + (e & 1);
          if (!(col < sk && (!CAUSAL || rows[e >> 1] >= col))) x = kNeg;
        }
        s[nc][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the 4 lanes of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new[h]);
      m[h] = m_new[h];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked entry is kNeg: exp2 underflows to 0 unless the whole
        // row is still masked (m_new == kNeg), which the test catches
        float p = exp2f(s[nc][e] - m_new[e >> 1]);
        if (edge && s[nc][e] == kNeg) p = 0.f;
        s[nc][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) lpart[h] = lpart[h] * corr[h] + ps[h];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    if (DROP) {
      // lanes g and g^1 (lane ^ 4) hold the same two 2x2 blocks of each
      // 8-column chunk: rows (row_lo, row_lo + 8) x columns (2t, 2t+1)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const int col = k0 + nc * 8 + 2 * t;
        uint4 wlo, whi;
        philox_pair(dp, bh, g & 1, rows[0], col, rows[1], col, 4, wlo, whi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = drop_keep(dp, (e >> 1) ? whi : wlo,
                                      rows[e >> 1], col + (e & 1));
          s[nc][e] = keep ? s[nc][e] * dp.rinv : 0.f;
        }
      }
    }

    // O += P V: S chunks 2j, 2j+1 re-pack as the m16k16 A fragment of
    // keys 16j .. 16j+15; V's B fragments come transposed by ldmatrix
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t vf[4];  // b0, b1 of column chunks dn and dn + 1
        ldsm_x4_t(vf, Vc + (j * 16 + lr + (lm & 1) * 8) * LD +
                          (dn + (lm >> 1)) * 8);
        mma_16816(acc[dn], pa, vf[0], vf[1]);
        mma_16816(acc[dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // all reads of this buffer are done before its refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lpart[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = rows[h];
    if (row < sq) {
      __nv_bfloat16* orow = o + ((long long)(bi * sq + row) * n_heads + hi) * D;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(&orow[dn * 8 + 2 * t]) =
            pack_bf16(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
      // m is in base-2 units of the scaled logits
      if (t == 0)
        lse[(long long)bh * sq + row] = (m[h] + log2f(l_safe)) * kLn2;
    }
  }
}

// one launch of the kernel for (dtype, D, causal, dropout)
template <int D, bool C, bool DROP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, dim3 grid, int n, int sq, int sk,
                   Strides qs, Strides ks, Strides vs, float scale,
                   DropParams dp, cudaStream_t stream) {
  cudaError_t e;
  if (dtype == 0) {
    auto kern = flash_fwd_simt<D, C, DROP>;
    const size_t smem = simt_smem_bytes<D>();
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, n, sq, sk,
        qs, ks, vs, scale, dp);
  } else {
    auto kern = flash_fwd_mma<D, C, DROP>;
    const size_t smem = mma_smem_bytes<D>();
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, n, sq, sk, qs, ks, vs, scale, dp);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FFMA kernel), 1 = bfloat16 (tensor-core kernel).
// dropout != 0 applies attention dropout with the keep threshold, the
// 64-bit Philox seed (seed_lo, seed_hi) and rinv = 1 / (1 - p).
// Returns 0 on success, a cudaError_t code if the launch was refused,
// or -1 for a dtype / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  const DropParams dp{threshold, seed_lo, seed_hi, rinv};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(b * n, (sq + kBM - 1) / kBM);
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return -1;

#define PT_GO(D, C, P)                                                      \
  launch<D, C, P>(dtype, q, k, v, o, lse, grid, n, sq, sk, qs, ks, vs,     \
                  scale, dp, stream)
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
