// Flash attention at head_dim 256 for Hopper (sm_90a): the f32 dQ and
// dK/dV kernels of flash_attn_bwd.cu for a head_dim their designs do not
// fit, on the FFMA pipes. The bf16 kernels at 256 run on the tensor
// cores in flash_attn_wg256.cu, and the f32 forward at 256 is
// flash_attn_wide.cu's fwd_wide as a cluster of one CTA
// (ops/flash_attention.py's _kernel_entry sends them there), so this file
// builds the f32 backward only.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_dq_kernel` (:283) and
// `_dkv_kernel` (:319) at the head_dims the Pallas wrapper pads to 256
// (pallas_kernels.py:486 pads any head_dim to a multiple of 128;
// ops/flash_attention.py's kernel_head_dim pads a head_dim of 129 to 255
// up to 256). The same function as the kernels at 64 and 128: the key
// bound `col < sk`, the query bound `row < sq`, the causal rule `row >=
// col` (top-left), dropout from the shared Philox keep bits of
// philox.cuh (seed, b*n + head, row, col), the kept probabilities scaled
// by 1/(1-p); the backward recomputes P = exp(Q K^T * scale - lse) and
// dS = P * (keep * dP / (1-p) - delta), with delta = rowsum(dO * O)
// given by the caller (from torch ops).
//
// Why a kernel of its own. At D = 256 the designs at 64 and 128 do not
// fit: the f32 dQ and dK/dV kernels of flash_attn_bwd.cu would need
// 361,472 and 363,008 bytes of shared memory a CTA (the H100 gives
// 232,448).
//
// What bounds it on an H100. The backward does 3 (dQ) and 4 (dK/dV)
// products of 2*b*n*sq*sk*256 flops (half that, causal), so at b 8, s
// 1024, n 8 it is bound by operations: 0.51 ms a product at f32's 67
// TFLOP/s. What sets this design's pace is shared memory, not the FP32
// pipes: a score is 4 float4 loads for 16 FMAs, a product column 6 loads
// for 32, so the SM's 128 bytes of shared memory a clock feed about a
// quarter of its FMA rate.
//
// The design: simple and exact, not fast. Every kernel is FFMA in f32,
// templated on the element type T as flash_ffma.cuh's tiles are (built
// for float only here). A CTA of 256 threads holds tiles of
// 32 rows x 256 in shared memory, row-major with a stride of 260 floats
// (16-byte rows for float4 reads, rows 4 banks apart). Thread (r, c) =
// (tid / 16, tid % 16) owns a 2x2 block of the 32x32 scores, rows 2r and
// 2r+1, columns 2c and 2c+1: one Philox 2x2 block, and a score is a
// float4 walk along D of two rows against two rows (4 loads for 16
// FMAs). Products into a [32 x 256] result (dQ, dK, dV) give each thread
// two rows and the 16 columns 4c + 64g + (0..3), g < 4, so a warp's
// float4 reads of a row are contiguous.
//  * dq_d256: a CTA owns 32 query rows and walks the key tiles: S and dP
//    from Q, dO, K and V, dS through shared memory, dQ += dS K (137,344
//    bytes).
//  * dkv_d256: a CTA owns 32 keys and walks the query tiles: S^T and dP^T,
//    dropout(P)^T and dS^T through shared memory, dV += dropout(P)^T dO
//    and dK += dS^T Q (141,824 bytes).
// No atomics, so the gradients are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


#include "flash_ffma.cuh"
#include "philox.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *dout;
  void* o;
  float* lse;
  const float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  int n_heads, sq, sk;
  float scale;
  DropParams dp;
};

// -------------------------------------------------------------------- dQ

template <typename T, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads) dq_d256(Args a) {
  extern __shared__ __align__(16) unsigned char smem_q[];
  float* Qs = reinterpret_cast<float*>(smem_q);
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;
  float* Vs = Ks + kTile;
  float* dSs = Vs + kTile;  // [kT][kPLd], query-major

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = blockIdx.y * kT;
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int sq = a.sq, sk = a.sk;
  const DropParams dp = drop_params<DROP>(a.dp);
  const T* qb = static_cast<const T*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const T* vb = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const T* db = static_cast<const T*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  load_rows(Qs, qb, a.qs.s, q0, sq, 1.f, tid);
  load_rows(dOs, db, a.dos.s, q0, sq, 1.f, tid);
  float lse_r[2], dl_r[2], acc[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * r + i;
    lse_r[i] = row < sq ? a.lse[(long long)bh * sq + row] : 0.f;
    dl_r[i] = row < sq ? a.delta[(long long)bh * sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(CAUSAL, sk, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_rows(Ks, kb, a.ks.s, k0, sk, 1.f, tid);
    load_rows(Vs, vb, a.vs.s, k0, sk, 1.f, tid);
    __syncthreads();

    float s[2][2], dpv[2][2];
    scores(s, Qs, r, Ks, c);
    scores(dpv, dOs, r, Vs, c);
    const int row0 = q0 + 2 * r, col0 = k0 + 2 * c;
    if (DROP) {
      const uint4 w = drop_block(dp, bh, row0, col0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          dpv[i][j] = drop_keep(dp, w, row0 + i, col0 + j)
                          ? dpv[i][j] * dp.rinv : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = link_ok(CAUSAL, row0 + i, col0 + j, sq, sk);
        const float p = ok ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dSs[(2 * r + i) * kPLd + 2 * c + j] = p * (dpv[i][j] - dl_r[i]);
      }
    __syncthreads();
    accumulate(acc, dSs, r, Ks, c);
  }

  T* out = static_cast<T*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * r + i;
    if (row < sq) store_row(out + (long long)row * a.dqs.s, acc[i], c, a.scale);
  }
}

// ----------------------------------------------------------------- dK, dV

template <typename T, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads) dkv_d256(Args a) {
  extern __shared__ __align__(16) unsigned char smem_kv[];
  float* Ks = reinterpret_cast<float*>(smem_kv);
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;   // [kT][kPLd] dropout(P)^T, key-major
  float* dSs = Ps + kScores;  // [kT][kPLd] dS^T, key-major
  float* lse_s = dSs + kScores;
  float* dl_s = lse_s + kT;

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * kT;
  // keys 2r, 2r+1 of the CTA's tile; queries 2c, 2c+1 of the walked one
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int sq = a.sq, sk = a.sk;
  const DropParams dp = drop_params<DROP>(a.dp);
  const T* qb = static_cast<const T*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const T* vb = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const T* db = static_cast<const T*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  load_rows(Ks, kb, a.ks.s, k0, sk, 1.f, tid);
  load_rows(Vs, vb, a.vs.s, k0, sk, 1.f, tid);
  float dk[2][16], dv[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (sq + kT - 1) / kT;
  // causal: the query tiles whose last row reaches this tile's first key
  for (int qt = CAUSAL ? k0 / kT : 0; qt < nq; ++qt) {
    const int i0 = qt * kT;
    __syncthreads();
    load_rows(Qs, qb, a.qs.s, i0, sq, 1.f, tid);
    load_rows(dOs, db, a.dos.s, i0, sq, 1.f, tid);
    if (tid < kT) {
      const bool in = i0 + tid < sq;
      lse_s[tid] = in ? a.lse[(long long)bh * sq + i0 + tid] : 0.f;
      dl_s[tid] = in ? a.delta[(long long)bh * sq + i0 + tid] : 0.f;
    }
    __syncthreads();

    // s[j][i]: key 2r + j against query 2c + i
    float s[2][2], dpv[2][2];
    scores(s, Ks, r, Qs, c);
    scores(dpv, Vs, r, dOs, c);
    const int key0 = k0 + 2 * r, qrow0 = i0 + 2 * c;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (DROP) w = drop_block(dp, bh, qrow0, key0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool ok = link_ok(CAUSAL, qrow0 + i, key0 + j, sq, sk);
        const float p =
            ok ? expf(s[j][i] * a.scale - lse_s[2 * c + i]) : 0.f;
        float pd = p, g = dpv[j][i];
        if (DROP) {
          const bool keep = drop_keep(dp, w, qrow0 + i, key0 + j);
          pd = keep ? p * dp.rinv : 0.f;
          g = keep ? g * dp.rinv : 0.f;
        }
        Ps[(2 * r + j) * kPLd + 2 * c + i] = pd;
        dSs[(2 * r + j) * kPLd + 2 * c + i] = p * (g - dl_s[2 * c + i]);
      }
    __syncthreads();
    accumulate(dv, Ps, r, dOs, c);
    accumulate(dk, dSs, r, Qs, c);
  }

  T* dkb = static_cast<T*>(a.dk) + bi * a.dks.b + hi * a.dks.n;
  T* dvb = static_cast<T*>(a.dv) + bi * a.dvs.b + hi * a.dvs.n;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + 2 * r + j;
    if (key >= sk) continue;
    store_row(dkb + (long long)key * a.dks.s, dk[j], c, a.scale);
    store_row(dvb + (long long)key * a.dvs.s, dv[j], c, 1.f);
  }
}

// ------------------------------------------------------------- launching

enum Which { kDq, kDkv };

template <bool C, bool P>
cudaError_t launch(Which which, int bn, const Args& a, cudaStream_t st) {
  if (which == kDq)
    return go(dq_d256<float, C, P>, dim3(bn, (a.sq + kT - 1) / kT),
              kDqSmem, st, a);
  return go(dkv_d256<float, C, P>, dim3(bn, (a.sk + kT - 1) / kT),
            kDkvSmem, st, a);
}

// dtype 0 (float32) only
int dispatch(Which which, int dtype, int b, int d, int causal, int dropout,
             const Args& a, void* stream_ptr) {
  if (d != kD || dtype != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int bn = b * a.n_heads;
#define PT_GO(C, P) launch<C, P>(which, bn, a, st)
#define PT_DROP(C) (dropout ? PT_GO(C, true) : PT_GO(C, false))
  const cudaError_t e = causal ? PT_DROP(true) : PT_DROP(false);
#undef PT_DROP
#undef PT_GO
  return (int)e;
}

DropParams drop_args(unsigned int threshold, const void* seed, float rinv) {
  return DropParams{threshold, static_cast<const uint32_t*>(seed), 0u, 0u,
                    rinv};
}

}  // namespace

// The two entries take the arguments of pt_flash_attn_bwd_dq and
// pt_flash_attn_bwd_dkv (flash_attn_bwd.cu), for d = 256 and dtype 0
// (float32; the bf16 kernels are flash_attn_wg256.cu's entries, the f32
// forward flash_attn_wide.cu's pt_flash_attn_fwd_wide). Strides are
// element strides (batch, seq, head) of [b, s, n, h] tensors whose
// head_dim stride is 1; lse is f32 [b, n, sq]. Unlike the
// bf16 dQ kernels, the dQ entry here reads delta = rowsum(dO * O) (o is
// not read), as the dK/dV entry does. Returns 0 on
// success, a cudaError_t code if a launch was refused, or -1 for a dtype
// / head_dim this file has no kernel for.
extern "C" int pt_flash_attn_bwd_dq_d256(
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
  (void)o; (void)o_sb; (void)o_ss; (void)o_sn;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = delta; a.dq = dq;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dqs = {dq_sb, dq_ss, dq_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = drop_args(threshold, seed, rinv);
  return dispatch(kDq, dtype, b, d, causal, dropout, a, stream_ptr);
}

extern "C" int pt_flash_attn_bwd_dkv_d256(
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
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = const_cast<float*>(lse); a.delta = delta; a.dk = dk; a.dv = dv;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = drop_args(threshold, seed, rinv);
  return dispatch(kDkv, dtype, b, d, causal, dropout, a, stream_ptr);
}
