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
// CTA. Here shared memory does not grow with D:
//  * the output's head_dim is split over the grid (blockIdx.z) in
//    256-wide chunks: a CTA owns 32 rows and one chunk of O (forward), of
//    dQ (dq_wide), or of dK and dV (dkv_wide);
//  * the products that run over the whole head_dim, the scores Q K^T,
//    dP = dO V^T and delta = rowsum(dO * O), are summed chunk by chunk
//    through the same [32 x 256] tiles (the chunk loop ends on the CTA's
//    own chunk, so the tiles it multiplies by are already loaded);
//  * each CTA keeps the online softmax of its own chunk; the softmax
//    state depends only on the scores, so every chunk's CTA computes the
//    same m and l, and only chunk 0 writes the lse (and, in dQ, delta).
// The price is the scores recomputed once per chunk (D / 256 times the
// head_dim-256 kernels' products), and Q and dO (or K and V) read again
// for every tile they meet. Tiles, threads and the FFMA products are
// flash_ffma.cuh's, as in flash_attn_d256.cu. No atomics, so the
// gradients are the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_ffma.cuh"
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

// -------------------------------------------------------------------- dQ

// one CTA an SM fits (137 KB of shared memory), so all 255 registers
// may go to it: at 128 (two CTAs' worth) the f32 dropout variants spill
template <typename T, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) dq_wide(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_q[];
  float* Qs = reinterpret_cast<float*>(smem_q);
  float* dOs = Qs + kTile;
  float* Ks = dOs + kTile;
  float* Vs = Ks + kTile;
  float* dSs = Vs + kTile;  // [kT][kPLd], query-major

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
  const T* ob = static_cast<const T*>(a.o) + bi * a.os.b + hi * a.os.n;
  const T* db = static_cast<const T*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  // delta = rowsum(dO * O) over the whole head_dim, chunk by chunk (O's
  // chunk goes through Ks, free until the key walk)
  float part[2] = {0.f, 0.f};
  for (int cc = 0; cc < nc; ++cc) {
    __syncthreads();
    load_rows(dOs, db + cc * kD, a.dos.s, q0, sq, 1.f, tid);
    load_rows(Ks, ob + cc * kD, a.os.s, q0, sq, 1.f, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int at = (2 * r + i) * kLd + g * 64 + c * 4;
        part[i] = dot4(ld4(dOs + at), ld4(Ks + at), part[i]);
      }
  }
  float lse_r[2], dl_r[2], acc[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float dl = part[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
    const int row = q0 + 2 * r + i;
    dl_r[i] = dl;
    lse_r[i] = row < sq ? a.lse[(long long)bh * sq + row] : 0.f;
    if (z == 0 && c == 0 && row < sq) a.delta[(long long)bh * sq + row] = dl;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  }

  const int nk = key_tiles(CAUSAL, sk, q0);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dpv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int i = 0; i < nc; ++i) {
      const int cc = chunk_of(i, z, nc);  // the last pass is chunk z
      __syncthreads();
      load_rows(Qs, qb + cc * kD, a.qs.s, q0, sq, 1.f, tid);
      load_rows(dOs, db + cc * kD, a.dos.s, q0, sq, 1.f, tid);
      load_rows(Ks, kb + cc * kD, a.ks.s, k0, sk, 1.f, tid);
      load_rows(Vs, vb + cc * kD, a.vs.s, k0, sk, 1.f, tid);
      __syncthreads();
      scores_add(s, Qs, r, Ks, c);
      scores_add(dpv, dOs, r, Vs, c);
    }
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
    accumulate(acc, dSs, r, Ks, c);  // Ks holds chunk z
  }

  T* out = static_cast<T*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n + z * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 2 * r + i;
    if (row < sq) store_row(out + (long long)row * a.dqs.s, acc[i], c, a.scale);
  }
}

// ----------------------------------------------------------------- dK, dV

// one CTA an SM fits (142 KB), as in dq_wide
template <typename T, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kThreads, 1) dkv_wide(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_kv[];
  float* Ks = reinterpret_cast<float*>(smem_kv);
  float* Vs = Ks + kTile;
  float* Qs = Vs + kTile;
  float* dOs = Qs + kTile;
  float* Ps = dOs + kTile;    // [kT][kPLd] dropout(P)^T, key-major
  float* dSs = Ps + kScores;  // [kT][kPLd] dS^T, key-major
  float* lse_s = dSs + kScores;
  float* dl_s = lse_s + kT;

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * kT;
  const int z = blockIdx.z, nc = a.nc;
  // keys 2r, 2r+1 of the CTA's tile; queries 2c, 2c+1 of the walked one
  const int tid = threadIdx.x, r = tid >> 4, c = tid & 15;
  const int sq = a.sq, sk = a.sk;
  const DropParams dp = drop_params<DROP>(a.dp);
  const T* qb = static_cast<const T*>(a.q) + bi * a.qs.b + hi * a.qs.n;
  const T* kb = static_cast<const T*>(a.k) + bi * a.ks.b + hi * a.ks.n;
  const T* vb = static_cast<const T*>(a.v) + bi * a.vs.b + hi * a.vs.n;
  const T* db = static_cast<const T*>(a.dout) + bi * a.dos.b + hi * a.dos.n;

  float dk[2][16], dv[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (sq + kT - 1) / kT;
  for (int qt = CAUSAL ? k0 / kT : 0; qt < nq; ++qt) {
    const int i0 = qt * kT;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float dpv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int i = 0; i < nc; ++i) {
      const int cc = chunk_of(i, z, nc);  // the last pass is chunk z
      __syncthreads();
      load_rows(Ks, kb + cc * kD, a.ks.s, k0, sk, 1.f, tid);
      load_rows(Vs, vb + cc * kD, a.vs.s, k0, sk, 1.f, tid);
      load_rows(Qs, qb + cc * kD, a.qs.s, i0, sq, 1.f, tid);
      load_rows(dOs, db + cc * kD, a.dos.s, i0, sq, 1.f, tid);
      if (i == 0 && tid < kT) {
        const bool in = i0 + tid < sq;
        lse_s[tid] = in ? a.lse[(long long)bh * sq + i0 + tid] : 0.f;
        dl_s[tid] = in ? a.delta[(long long)bh * sq + i0 + tid] : 0.f;
      }
      __syncthreads();
      // s[j][i]: key 2r + j against query 2c + i
      scores_add(s, Ks, r, Qs, c);
      scores_add(dpv, Vs, r, dOs, c);
    }
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
    accumulate(dv, Ps, r, dOs, c);  // dOs and Qs hold chunk z
    accumulate(dk, dSs, r, Qs, c);
  }

  T* dkb = static_cast<T*>(a.dk) + bi * a.dks.b + hi * a.dks.n + z * kD;
  T* dvb = static_cast<T*>(a.dv) + bi * a.dvs.b + hi * a.dvs.n + z * kD;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + 2 * r + j;
    if (key >= sk) continue;
    store_row(dkb + (long long)key * a.dks.s, dk[j], c, a.scale);
    store_row(dvb + (long long)key * a.dvs.s, dv[j], c, 1.f);
  }
}

// ------------------------------------------------------------- launching

enum Which { kFwd, kDq, kDkv };

template <bool C, bool P>
cudaError_t launch(Which which, int bn, const WideArgs& a, cudaStream_t st) {
  if (which == kFwd)
    return go(fwd_wide<float, C, P>, dim3(bn, (a.sq + kT - 1) / kT, a.nc),
              kFwdSmem, st, a);
  if (which == kDq)
    return go(dq_wide<float, C, P>, dim3(bn, (a.sq + kT - 1) / kT, a.nc),
              kDqSmem, st, a);
  return go(dkv_wide<float, C, P>, dim3(bn, (a.sk + kT - 1) / kT, a.nc),
            kDkvSmem, st, a);
}

// dtype 0 (float32) only
int dispatch(Which which, int dtype, int b, int d, int causal, int dropout,
             WideArgs& a, void* stream_ptr) {
  if (dtype != 0 || d <= kD || d % kD) return -1;
  a.nc = d / kD;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const int bn = b * a.n_heads;
#define PT_GO(C, P) launch<C, P>(which, bn, a, st)
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
