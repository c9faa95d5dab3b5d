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
//    It also computes delta = rowsum(dO * O) of its rows in f32, uses it
//    and writes it to a [b, n, sq] buffer for the next kernel.
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
//  * f32 (dq_ffma, dkv_ffma): exact FFMA, no TF32, so the gradients
//    agree with a float32 reference to ~1e-6. At 64 and 128 the f32
//    products set the pace (67 TFLOP/s), and a link carries only 3 D
//    (dQ) or 4 D (dK/dV) FMAs against its exponential, keep bits and dS.
//    So a consumer thread keeps its block of S and dP over the whole
//    head_dim in registers (8 rows by 4 at 64, 4 by 4 at 128) and forms
//    dS there (no partial scores in shared memory, as the wide kernels
//    need at 256 and above), stored once for the accumulating products.
//    A CTA of 384 threads owns 128 rows at 64 and 64 at 128 (query rows
//    for dQ, keys for dK/dV; at 64 the wider side halves the walked
//    tiles' reads and loads 12 floats for 32 FMAs where 64 rows load 8
//    for 16: 17% faster): 8 consumer warps and a producer warpgroup,
//    whose first warp copies every operand tile once, row-major, by
//    bulk copies counted on mbarriers (flash_bulk.cuh, the feeding of
//    flash_attn_wide.cu), two 64-row walked tiles in flight; setmaxnreg
//    72 / 208. Every product reads both operands along head_dim as
//    float4 rows, each load in one wavefront. The producer warpgroup's
//    three other warps compute each tile's keep bits and hand each
//    consumer thread its bits as one word in shared memory (on the
//    consumers, 4 Philox calls a thread a tile, dK/dV took 3.5% longer
//    at p 0.1). The dQ kernel computes delta first, from O and dO in
//    device memory, while the first tiles land.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bulk.cuh"
#include "flash_common.cuh"
#include "flash_ffma_tiles.cuh"
#include "flash_wgmma.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using namespace flash;
using namespace flash_ffma;
using namespace hopper;
using namespace flash_wg;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // written by the dQ kernel, read by dK/dV
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

// The f32 kernels (dq_ffma, dkv_ffma) on flash_ffma_tiles.cuh: a CTA
// owns R rows (query rows for dQ, keys for dK/dV; Ffma::kR) and walks
// the other side in kFR-row tiles.
template <int D>
struct FfmaBwd : Ffma<D> {
  using F = Ffma<D>;
  // resident rows of a thread's block
  static constexpr int kIR = F::kR / 16;
  // column steps of the score loops unrolled (dQ at 64 two: as fast as
  // one there, where a step's loads of the 8-row blocks take 48 registers)
  static constexpr int kDqUnroll = D == 64 ? 2 : 4;
  static constexpr int kDkvUnroll = 4;
  // a [walked row][resident row] score tile (dQ's dS; dK/dV's
  // dropout(P) and dS), its row stride 8 banks mod 32: a warp's float2
  // stores of it in the two wavefronts they need
  static constexpr int kSLd = F::kR + 8;
  static constexpr int kScore = kFR * kSLd;
  // score tiles: at 64 dQ's dS has two buffers (a tile's stores wait
  // for no reader of the last tile's) and dK/dV's dropout(P) and dS one
  // each; at 128 dQ's dS has one, and dK/dV's share one
  static constexpr int kDqScores = D == 64 ? 2 : 1;
  static constexpr int kDkvScores = D == 64 ? 2 : 1;
  // two resident tiles, two walked ones a stage
  static constexpr int kOperands = 2 * F::kRTile + 2 * F::kStages * F::kTile;
  static constexpr size_t kDqBytes =
      (kOperands + kDqScores * kScore + F::kR + F::kKeepWords) *
      sizeof(float);
  static constexpr size_t kDkvBytes =
      (kOperands + kDkvScores * kScore + F::kKeepWords) * sizeof(float);
  static_assert(kDqBytes <= 232448 && kDkvBytes <= 232448,
                "a CTA takes at most 227 KB of shared memory");
};

__device__ __forceinline__ int res_row(int i) { return (i & 1) + 8 * (i >> 1); }

// A consumer thread's parts (8 warps), for R resident rows and head_dim
// D:
//  * its block of S and dP (dK/dV: S^T and dP^T): resident rows rr +
//    res_row(i), i < R / 16 (rr, rr + 1, rr + 8, rr + 9, ...), against
//    walked rows wc + 8 j, j < 4, over the whole head_dim, in registers.
//    A warp's float4 loads of a column step read 4 resident rows (one
//    wavefront, broadcast) and 8 walked ones (one wavefront: the row
//    stride is 4 banks mod 32);
//  * the accumulation: resident rows 4 ua + i, i < 4, columns 4 ub + e
//    and D / 2 + 4 ub + e, e < 4.
template <int R, int D>
struct FRoles {
  int rr, wc, ua, ub;
  __device__ __forceinline__ explicit FRoles(int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    rr = (R / 4) * (warp & 3) + 2 * (lane >> 3);
    wc = 32 * (warp >> 2) + (lane & 7);
    ua = 4 * (warp % (R / 16)) + (lane >> 3);
    ub = 8 * (warp / (R / 16)) + (lane & 7);
  }
};

// s[i][j] = A[rr + res_row(i)] . B[wc + 8 j] over D columns, A resident
// and B walked, both row-major at D + 4: IR + 4 float4 loads for 16 IR
// FMAs a step, U steps unrolled
template <int D, int IR, int U, typename Ro>
__device__ __forceinline__ void ffma_scores(float s[IR][4], const float* A,
                                            const float* B, const Ro& ro) {
  constexpr int LD = Ffma<D>::kLd;
  const float* pa = A + ro.rr * LD;
  const float* pb = B + ro.wc * LD;
#pragma unroll
  for (int i = 0; i < IR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll (U)
  for (int t = 0; t < D; t += 4) {
    float4 x[IR], y[4];
#pragma unroll
    for (int i = 0; i < IR; ++i) x[i] = ld4(pa + res_row(i) * LD + t);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld4(pb + 8 * j * LD + t);
#pragma unroll
    for (int i = 0; i < IR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
}

// the thread's block x[i][j] into X[wc + 8 j][rr + res_row(i)] (row
// stride SLD), a float2 (two resident rows) a store
template <int IR, int SLD, typename Ro>
__device__ __forceinline__ void ffma_put(float* X, const float x[IR][4],
                                         const Ro& ro) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int rp = 0; rp < IR / 2; ++rp)
      *reinterpret_cast<float2*>(X + (ro.wc + 8 * j) * SLD + ro.rr +
                                 8 * rp) =
          make_float2(x[2 * rp][j], x[2 * rp + 1][j]);
}

// rows row0 + 4 ua + i (< limit) of acc times mul into out (row stride
// rs), at the thread's columns
template <int D, typename Ro>
__device__ __forceinline__ void ffma_store(float* out, long long rs,
                                           const float acc[4][8], int row0,
                                           int limit, float mul,
                                           const Ro& ro) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ro.ua + i;
    if (row >= limit) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(out + (long long)row * rs + (D / 2) * g +
                                 4 * ro.ub) =
          make_float4(acc[i][4 * g] * mul, acc[i][4 * g + 1] * mul,
                      acc[i][4 * g + 2] * mul, acc[i][4 * g + 3] * mul);
  }
}

// The keep bits of the consumers' links, computed by the producer
// warpgroup's keep warps: bit 4 i + j of consumer thread c's word is the
// keep bit of its link (resident row res0 + rr + res_row(i), walked row
// walk0 + 64 t + wc + 8 j of tile t). The resident rows are query rows
// (RES_ROWS, dQ) or keys (dK/dV), the Philox block's rows or columns.
// The lanes c and c ^ 1 hold the two walked rows of the same blocks, so
// keep warp kw's lane computes the 2 IR blocks of the pair (2 pp, 2 pp +
// 1), pp = 32 kw + lane (and + 96), into keep_s[st][c] after the
// consumers released stage st, then the warp arrives on its full
// barrier. The consumers spend no instruction on them.
template <int R, int D, int S, bool RES_ROWS, typename B>
__device__ __forceinline__ void ffma_keep_words(const DropParams& dp, int bh,
                                                int res0, int walk0, int nt,
                                                uint32_t* keep_s,
                                                const B& bars, int kw,
                                                int lane) {
  uint32_t phase = 0u;
  for (int t = 0; t < nt; ++t) {
    const int st = t % S;
    if (t >= S) flash_bulk::bar_wait(bars.empty(st), phase, st);
    for (int pp = 32 * kw + lane; pp < kFConsumers / 2;
         pp += 32 * kFKeepWarps) {
      const FRoles<R, D> ro(2 * pp);
      uint32_t w2[2] = {0u, 0u};
#pragma unroll 1
      for (int rp = 0; rp < R / 32; ++rp)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int res = res0 + ro.rr + 8 * rp;
          const int walk = walk0 + t * kFR + ro.wc + 8 * j;
          const uint4 w = RES_ROWS ? drop_block(dp, bh, res, walk)
                                   : drop_block(dp, bh, walk, res);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y)
              if (word_of(w, RES_ROWS ? 2 * x + y : 2 * y + x) >=
                  dp.threshold)
                w2[y] |= 1u << (4 * (2 * rp + x) + j);
        }
      keep_s[st * kFConsumers + 2 * pp] = w2[0];
      keep_s[st * kFConsumers + 2 * pp + 1] = w2[1];
    }
    flash_bulk::warp_release(bars.full(st), lane);
  }
}

// dQ: a CTA per R query rows (causal: the longest walks first), Q and
// dO resident, the keys walked by 64-key tiles of K and V. First delta =
// rowsum(dO * O) of the CTA's rows, 256 / R threads a row, read from
// device memory while the first copies land, written for dK/dV. Each
// tile: S and dP of the thread's block, then its dS = P (dropout(dP) -
// delta) in registers, once into shared memory, then dQ += dS K.
template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kFThreads, 1) dq_ffma(BwdArgs a) {
  using F = FfmaBwd<D>;
  constexpr int S = F::kStages, R = F::kR, IR = F::kIR;
  extern __shared__ __align__(16) unsigned char smem_dqf[];
  float* Qs = reinterpret_cast<float*>(smem_dqf);  // resident
  float* dOs = Qs + F::kRTile;                     // resident
  float* Kw = dOs + F::kRTile;  // stage st: K at Kw + 2 st kTile, V after
  float* dSs = Kw + 2 * S * F::kTile;              // dS as [key][query]
  float* dl_s = dSs + F::kDqScores * F::kScore;    // each row's delta
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(dl_s + R);

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = a.sq, sk = a.sk;
  const typename F::template Bars<DROP> bars(Qs);
  if (tid == 0) bars.init();
  __syncthreads();
  int nk = (sk + kFR - 1) / kFR;
  if (CAUSAL) nk = min(nk, (q0 + R - 1) / kFR + 1);
  uint32_t phase = 0u, bytes = 0u;

  if (warp >= kFConsumers / 32) {
    regs_dec<kFProdRegs>();
    const int pw = warp - kFConsumers / 32;
    if (DROP && pw > 0 && pw <= kFKeepWarps)
      ffma_keep_words<R, D, S, true>(drop_params<DROP>(a.dp), bh, q0, 0, nk,
                                     keep_s, bars, pw - 1, lane);
    if (pw != 0) return;
    const float* qb =
        static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
    const float* db =
        static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;
    const float* kb =
        static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n;
    const float* vb =
        static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n;
    flash_bulk::warp_load<D, F::kLd, R>(bars.misc(), bytes, Qs, qb, a.qs.s,
                                        q0, sq, lane);
    flash_bulk::warp_load<D, F::kLd, R>(bars.misc(), bytes, dOs, db,
                                        a.dos.s, q0, sq, lane);
    flash_bulk::warp_commit(bars.misc(), bytes, lane);
    for (int t = 0; t < nk; ++t) {
      const int st = t % S;
      float* dst = Kw + 2 * st * F::kTile;
      if (t >= S) flash_bulk::bar_wait(bars.empty(st), phase, st);
      flash_bulk::warp_load<D, F::kLd, kFR>(bars.full(st), bytes, dst, kb,
                                            a.ks.s, t * kFR, sk, lane);
      flash_bulk::warp_load<D, F::kLd, kFR>(bars.full(st), bytes,
                                            dst + F::kTile, vb, a.vs.s,
                                            t * kFR, sk, lane);
      flash_bulk::warp_commit(bars.full(st), bytes, lane);
    }
    return;
  }

  regs_inc<kFConsRegs>();
  const FRoles<R, D> ro(tid);
  {
    constexpr int TPR = kFConsumers / R;  // threads a row
    const int row = tid / TPR, part = tid % TPR;
    float x = 0.f;
    if (q0 + row < sq) {
      const long long at = (long long)(q0 + row);
      const float* op = static_cast<const float*>(a.o) + bi * a.os.b +
                        hi * a.os.n + at * a.os.s;
      const float* gp = static_cast<const float*>(a.dout) + bi * a.dos.b +
                        hi * a.dos.n + at * a.dos.s;
#pragma unroll
      for (int c = 4 * part; c < D; c += 4 * TPR)
        x = dot4(__ldg(reinterpret_cast<const float4*>(op + c)),
                 __ldg(reinterpret_cast<const float4*>(gp + c)), x);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (part == 0) {
      dl_s[row] = x;
      if (q0 + row < sq) a.delta[(long long)bh * sq + q0 + row] = x;
    }
  }
  flash_bulk::consumers_sync();
  const float scale2 = a.scale * kLog2e;
  float lse2[IR], dl[IR];
#pragma unroll
  for (int i = 0; i < IR; ++i) {
    const int row = q0 + ro.rr + res_row(i);
    dl[i] = dl_s[ro.rr + res_row(i)];
    lse2[i] = row < sq ? a.lse[(long long)bh * sq + row] * kLog2e : 0.f;
  }
  float acc[4][8];
  zero8(acc);

  flash_bulk::bar_wait(bars.misc(), phase, S);
  for (int t = 0; t < nk; ++t) {
    const int st = t % S, k0 = t * kFR;
    const float* Kt = Kw + 2 * st * F::kTile;
    flash_bulk::bar_wait(bars.full(st), phase, st);
    float s[IR][4], g[IR][4];
    ffma_scores<D, IR, F::kDqUnroll>(s, Qs, Kt, ro);
    ffma_scores<D, IR, F::kDqUnroll>(g, dOs, Kt + F::kTile, ro);
    const uint32_t keep = DROP ? keep_s[st * kFConsumers + tid] : 0u;
#pragma unroll
    for (int i = 0; i < IR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ro.rr + res_row(i), col = k0 + ro.wc + 8 * j;
        const float p = link_ok(CAUSAL, row, col, sq, sk)
                            ? ex2(fmaf(s[i][j], scale2, -lse2[i]))
                            : 0.f;
        float d = g[i][j];
        if (DROP) d = (keep >> (4 * i + j)) & 1u ? d * a.dp.rinv : 0.f;
        s[i][j] = p * (d - dl[i]);  // dS
      }
    float* X = dSs + (t % F::kDqScores) * F::kScore;
    if (F::kDqScores == 1) flash_bulk::consumers_sync();  // the last dS read
    ffma_put<IR, F::kSLd>(X, s, ro);
    flash_bulk::consumers_sync();
    ffma_accumulate<D, F::kSLd>(acc, X, Kt, ro);
    flash_bulk::warp_release(bars.empty(st), lane);
  }
  ffma_store<D>(static_cast<float*>(a.dq) + bi * a.dqs.b + hi * a.dqs.n,
                a.dqs.s, acc, q0, sq, a.scale, ro);
}

// dK/dV: a CTA per R keys, K and V resident, the queries walked by
// 64-row tiles of Q and dO (causal: from the block's first key on). Each
// tile: S^T and dP^T of the thread's block, then dropout(P)^T and dS^T
// in registers, each once into shared memory, then dV += dropout(P)^T
// dO and dK += dS^T Q; lse and delta of the thread's queries read from
// device memory while the tile lands.
template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kFThreads, 1) dkv_ffma(BwdArgs a) {
  using F = FfmaBwd<D>;
  constexpr int S = F::kStages, R = F::kR, IR = F::kIR;
  extern __shared__ __align__(16) unsigned char smem_dkvf[];
  float* Ks = reinterpret_cast<float*>(smem_dkvf);  // resident
  float* Vs = Ks + F::kRTile;                       // resident
  float* Qw = Vs + F::kRTile;  // stage st: Q at Qw + 2 st kTile, dO after
  float* Ps = Qw + 2 * S * F::kTile;  // score tiles as [query][key]
  uint32_t* keep_s =
      reinterpret_cast<uint32_t*>(Ps + F::kDkvScores * F::kScore);

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int k0 = blockIdx.y * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = a.sq, sk = a.sk;
  const typename F::template Bars<DROP> bars(Ks);
  if (tid == 0) bars.init();
  __syncthreads();
  // causal: the first query that sees key k0 is row k0
  const int i00 = CAUSAL ? k0 : 0;
  const int nq = sq > i00 ? (sq - i00 + kFR - 1) / kFR : 0;
  uint32_t phase = 0u, bytes = 0u;

  if (warp >= kFConsumers / 32) {
    regs_dec<kFProdRegs>();
    const int pw = warp - kFConsumers / 32;
    if (DROP && pw > 0 && pw <= kFKeepWarps)
      ffma_keep_words<R, D, S, false>(drop_params<DROP>(a.dp), bh, k0, i00,
                                      nq, keep_s, bars, pw - 1, lane);
    if (pw != 0) return;
    const float* qb =
        static_cast<const float*>(a.q) + bi * a.qs.b + hi * a.qs.n;
    const float* db =
        static_cast<const float*>(a.dout) + bi * a.dos.b + hi * a.dos.n;
    flash_bulk::warp_load<D, F::kLd, R>(
        bars.misc(), bytes, Ks,
        static_cast<const float*>(a.k) + bi * a.ks.b + hi * a.ks.n, a.ks.s,
        k0, sk, lane);
    flash_bulk::warp_load<D, F::kLd, R>(
        bars.misc(), bytes, Vs,
        static_cast<const float*>(a.v) + bi * a.vs.b + hi * a.vs.n, a.vs.s,
        k0, sk, lane);
    flash_bulk::warp_commit(bars.misc(), bytes, lane);
    for (int t = 0; t < nq; ++t) {
      const int st = t % S, i0 = i00 + t * kFR;
      float* dst = Qw + 2 * st * F::kTile;
      if (t >= S) flash_bulk::bar_wait(bars.empty(st), phase, st);
      flash_bulk::warp_load<D, F::kLd, kFR>(bars.full(st), bytes, dst, qb,
                                            a.qs.s, i0, sq, lane);
      flash_bulk::warp_load<D, F::kLd, kFR>(bars.full(st), bytes,
                                            dst + F::kTile, db, a.dos.s, i0,
                                            sq, lane);
      flash_bulk::warp_commit(bars.full(st), bytes, lane);
    }
    return;
  }

  regs_inc<kFConsRegs>();
  const FRoles<R, D> ro(tid);
  const float scale2 = a.scale * kLog2e;
  float dk[4][8], dv[4][8];
  zero8(dk);
  zero8(dv);

  flash_bulk::bar_wait(bars.misc(), phase, S);
  for (int t = 0; t < nq; ++t) {
    const int st = t % S, i0 = i00 + t * kFR;
    const float* Qt = Qw + 2 * st * F::kTile;
    const float* dOt = Qt + F::kTile;
    float lq2[4], dlq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = i0 + ro.wc + 8 * j;
      const bool in = qi < sq;
      lq2[j] = in ? a.lse[(long long)bh * sq + qi] * kLog2e : 0.f;
      dlq[j] = in ? a.delta[(long long)bh * sq + qi] : 0.f;
    }
    flash_bulk::bar_wait(bars.full(st), phase, st);
    float s[IR][4], g[IR][4];
    ffma_scores<D, IR, F::kDkvUnroll>(s, Ks, Qt, ro);
    ffma_scores<D, IR, F::kDkvUnroll>(g, Vs, dOt, ro);
    const uint32_t keep = DROP ? keep_s[st * kFConsumers + tid] : 0u;
#pragma unroll
    for (int i = 0; i < IR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + ro.rr + res_row(i), qi = i0 + ro.wc + 8 * j;
        const float p = link_ok(CAUSAL, qi, key, sq, sk)
                            ? ex2(fmaf(s[i][j], scale2, -lq2[j]))
                            : 0.f;
        float d = g[i][j], pd = p;
        if (DROP) {
          const bool kept = (keep >> (4 * i + j)) & 1u;
          d = kept ? d * a.dp.rinv : 0.f;
          pd = kept ? p * a.dp.rinv : 0.f;
        }
        s[i][j] = pd;                  // dropout(P)^T
        g[i][j] = p * (d - dlq[j]);    // dS^T
      }
    // the last tile's accumulations have read the score tiles
    flash_bulk::consumers_sync();
    if constexpr (F::kDkvScores == 2) {
      ffma_put<IR, F::kSLd>(Ps, s, ro);
      ffma_put<IR, F::kSLd>(Ps + F::kScore, g, ro);
      flash_bulk::consumers_sync();
      ffma_accumulate<D, F::kSLd>(dv, Ps, dOt, ro);
      ffma_accumulate<D, F::kSLd>(dk, Ps + F::kScore, Qt, ro);
    } else {
      // one tile: dropout(P), then dS after every read of it
      ffma_put<IR, F::kSLd>(Ps, s, ro);
      flash_bulk::consumers_sync();
      ffma_accumulate<D, F::kSLd>(dv, Ps, dOt, ro);
      flash_bulk::consumers_sync();
      ffma_put<IR, F::kSLd>(Ps, g, ro);
      flash_bulk::consumers_sync();
      ffma_accumulate<D, F::kSLd>(dk, Ps, Qt, ro);
    }
    flash_bulk::warp_release(bars.empty(st), lane);
  }
  ffma_store<D>(static_cast<float*>(a.dk) + bi * a.dks.b + hi * a.dks.n,
                a.dks.s, dk, k0, sk, a.scale, ro);
  ffma_store<D>(static_cast<float*>(a.dv) + bi * a.dvs.b + hi * a.dvs.n,
                a.dvs.s, dv, k0, sk, 1.f, ro);
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
    const DropParams dp = drop_params<DROP>(a.dp);
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
          keep_words<DKV>(dp, it.bh, it.own0, s0, p,
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

// The dQ kernel of each dtype: bf16 dq_wgmma, f32 dq_ffma; both compute
// delta = rowsum(dO * O) and write it to BwdArgs.delta for dK/dV
template <int D, bool C, bool P>
cudaError_t launch_dq(int dtype, const BwdArgs& a, cudaStream_t st) {
  if (dtype == 1) return go_wgmma<D, C, P, false>(a, st);
  if (!(rows16(a.q, a.qs) && rows16(a.k, a.ks) && rows16(a.v, a.vs) &&
        rows16(a.o, a.os) && rows16(a.dout, a.dos) && rows16(a.dq, a.dqs)))
    return cudaErrorInvalidValue;
  return go(dq_ffma<D, C, P>,
            dim3(a.batch * a.n_heads, (a.sq + Ffma<D>::kR - 1) / Ffma<D>::kR),
            kFThreads,
            FfmaBwd<D>::kDqBytes, st, a);
}

template <int D, bool C, bool P>
cudaError_t launch_dkv(int dtype, const BwdArgs& a, cudaStream_t st) {
  if (dtype == 1) return go_wgmma<D, C, P, true>(a, st);
  if (!(rows16(a.q, a.qs) && rows16(a.k, a.ks) && rows16(a.v, a.vs) &&
        rows16(a.dout, a.dos) && rows16(a.dk, a.dks) &&
        rows16(a.dv, a.dvs)))
    return cudaErrorInvalidValue;
  return go(dkv_ffma<D, C, P>,
            dim3(a.batch * a.n_heads, (a.sk + Ffma<D>::kR - 1) / Ffma<D>::kR),
            kFThreads,
            FfmaBwd<D>::kDkvBytes, st, a);
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
// given the stride a packed tensor would have; in f32 every row is
// 16-byte aligned (rows16). dropout != 0 regenerates the forward's keep
// bits from the threshold and the 64-bit seed at `seed` in device memory
// (lo, hi; read by the kernel); rinv = 1 / (1 - p). delta: the dQ kernel
// writes rowsum(dO * O) there (o is read for it), and the dK/dV kernel
// reads it. Returns 0 on success, a cudaError_t code if a launch or a
// tensor map was refused, or -1 for a dtype / head_dim this file has no
// kernel for.
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
    const void* seed, float rinv, void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq = dq;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.os = {o_sb, o_ss, o_sn};
  a.dos = {do_sb, do_ss, do_sn}; a.dqs = {dq_sb, dq_ss, dq_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
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
    const void* seed, float rinv, void* stream_ptr) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.delta = const_cast<float*>(delta);
  a.dk = dk; a.dv = dv;
  a.qs = {q_sb, q_ss, q_sn}; a.ks = {k_sb, k_ss, k_sn};
  a.vs = {v_sb, v_ss, v_sn}; a.dos = {do_sb, do_ss, do_sn};
  a.dks = {dk_sb, dk_ss, dk_sn}; a.dvs = {dv_sb, dv_ss, dv_sn};
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = {threshold, static_cast<const uint32_t*>(seed), 0u, 0u, rinv};
  return dispatch<true>(dtype, d, causal, dropout, a,
                        static_cast<cudaStream_t>(stream_ptr));
}
