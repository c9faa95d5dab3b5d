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
// edge is masked here), lse is not replicated over 8 sublanes. A loop
// over 64-key tiles takes the place of the sequential k-block grid axis,
// with the running (m, l, acc) in registers.
//
// What bounds it on an H100. Per call the work is 4*b*n*sq*sk*h flops
// (half that, causal) against (3*b*s*n*h + b*sq*n*h) elements moved.
// At the training shape (b 48, s 512, n 12, h 64) that is 38.7 GFLOP
// against 151 MB in bf16: 39 us at 989 TFLOP/s of bf16 tensor-core time
// and 45 us at 3.35 TB/s, so bf16 is bound by bytes, barely. Two more
// costs sit beside the products: one ex2 per link on the SFU (151 M
// links, about as long as the products), and with dropout one
// Philox4x32-10 call per 2x2 block of links, integer work that no
// tensor core does (chip_smoke.py reports its floor). In f32 the bytes
// double and the arithmetic runs on the FP32 pipes (67 TFLOP/s): 0.58
// ms for the same 38.7 GFLOP against 90 us of bytes, so f32 is bound by
// operations, and a link's 2 h FMAs carry its exponential, mask, keep
// bit and online-softmax share: every fixed cost of a tile weighs 1.5
// times what it weighs in the f32 dQ kernel (3 h FMAs a link).
//
// What the design does about that.
//  * bf16 (fwd_wgmma) runs on the backward's pipeline (flash_wgmma.cuh):
//    a persistent CTA per SM of 384 threads walks over (batch, head,
//    128-row block) work items. The producer warpgroup (setmaxnreg 64)
//    loads the item's Q tile by TMA into one of two buffers, so the
//    next item's Q lands while this one finishes, and streams 64-key K
//    and V tiles through an mbarrier ring (4 stages at h 64, 2 at h
//    128), 128-byte swizzled, read through tensor maps over the strided
//    views; TMA's out-of-bounds zero fill gives the ragged edge. The two
//    consumer warpgroups (setmaxnreg 216) own 64 query rows each. Each
//    warp takes its rows of Q into registers as wgmma A fragments once
//    per item (so the Q buffer is free for the item after next at once)
//    and S = Q K^T runs as wgmma m64n64k16 with A from registers and K
//    from shared memory: the products of m64n64 tiles are short, and
//    with both operands in shared memory S alone would read it at its
//    full rate. Then the online softmax on the accumulators in registers
//    (one ex2 per link, the scale folded in), P packed to bf16 A
//    fragments (the Pallas kernel casts p to v's dtype) and O += P V by
//    wgmma with A from registers and V read MN-major. B is read from
//    shared memory once per 64 rows of A. Each warpgroup issues S of
//    tile j together with O += P V of tile j - 1 and runs tile j's
//    softmax under that P V (FlashAttention-3's overlap within a
//    warpgroup); O is rescaled only after that P V's wait, so no
//    instruction writes an accumulator inside a wgmma window (which
//    makes ptxas serialise every wgmma).
//    Turns between the two consumer warpgroups on named barriers
//    (FlashAttention-3's ping-pong) measured no faster here, and are not
//    used. Under a causal mask a warpgroup skips the tiles wholly above
//    its rows; the softmax takes its row maxima from the raw scores and
//    masks only on tiles that cross the key bound or the diagonal.
//  * Dropout: the producer's 128 threads compute each consumer lane's 32
//    keep bits of a stage (keep_words, as the dQ kernel does: the links
//    are the same (owned query row, streamed key)) while the consumers
//    run earlier stages, so the Philox rounds run on warps of their own.
//    At p 0.1 their throughput, not the consumers, sets the kernel's
//    time (about twice its time at p 0): a cheaper mask is the lever.
//  * f32 (fwd_ffma): exact f32 FFMA, no TF32 and no tensor cores, so
//    results agree with a float32 reference to ~1e-6. It is the f32
//    backward's design (flash_ffma_tiles.cuh): a CTA of 384 threads
//    owns 128 query rows at 64 and 64 at 128, Q resident; one producer
//    thread copies Q once and streams 64-key tiles of K and V, two in
//    flight, and the producer warpgroup's four warps compute the keep
//    bits a word a consumer thread; setmaxnreg 72 / 208. Each tile is
//    one TMA box of rows d + 4 floats long, the 4 past d outside the
//    tensor and so zero-filled: it lands as the row-major tile at a
//    stride of d + 4 that the products read without bank conflicts,
//    and rows past the sequence land as zeros (the ragged edge). The
//    backward's bulk copy a row costs the issuing warp a loop over its
//    lanes; beside FFMA-bound consumers on its scheduler that starved
//    the walk (on an H100 the forward took 15% longer so). The scale is
//    folded into ex2. Unlike dQ, the forward does not know a row's
//    maximum before its walk. So each of the 8 consumer warps owns whole
//    rows (16 at 64, 8 at 128) against all 64 keys of a tile: a row's
//    maximum and sum are reduced by shuffles among the lanes that share
//    it, and those lanes then accumulate the same row's O from P in the
//    warp's own tile, so a tile costs no barrier among the consumers.
//    Under a causal mask the longest walks go first, a CTA stops at its
//    last visible tile and a warp skips the tiles above its rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------ f32, FFMA

// fwd_ffma's parts, on flash_ffma_tiles.cuh's tiles: a CTA owns R query
// rows (Ffma::kR: 128 at head_dim 64, 64 at 128) and walks the keys in
// kFR-key tiles of K and V. Each consumer warp owns WR = R / 8 of the
// rows and all kFR keys of a tile, so a row's maximum and sum never
// leave its warp, and the probabilities it stores are read back by the
// same warp: the tile loop has no barrier among the consumer warps.
//  * A lane is (rg, kg), rg = lane / KG of the warp's RG row groups and
//    kg = lane % KG of its KG key groups. It holds S of rows rg + RG i
//    (i < 4) against keys kg + KG j (j < JK) over the whole head_dim in
//    registers (4 x 8 at 64, 4 x 4 at 128). A column step's float4
//    loads read RG resident rows (broadcast) and KG walked ones: one
//    wavefront each at 64 (8 consecutive rows at a stride of 4 banks),
//    two at 128.
//  * The KG lanes of a row group share its rows: each row's maximum and
//    sum are reduced over them by shuffles, so every lane of a row holds
//    the same running maximum and applies the same rescale factor.
//  * P goes into the warp's own [kFR key][WR slot] tile, row rg + RG i
//    at slot 4 rg + i, so the same lane then accumulates O of its own
//    rows: acc[i][4 g + e], columns 4 kg + e + D / 2 g, a float4 of P
//    and two of V a key for 32 FMAs.
template <int D>
struct FwdFfma : Ffma<D> {
  using F = Ffma<D>;
  static constexpr int WR = F::kR / 8;  // rows of a consumer warp
  static constexpr int IR = 4;          // rows of a lane
  static constexpr int RG = WR / IR;    // row groups of a warp
  static constexpr int KG = 32 / RG;    // key groups (lanes of a row)
  static constexpr int JK = kFR / KG;   // keys of a lane in a tile
  static constexpr int U = D == 64 ? 2 : 4;  // column steps unrolled
  static constexpr int kP = kFR * WR;   // a warp's P tile
  // the mbarriers in an array of their own (TMA writes the tiles' row
  // padding), 8 bytes each: full and empty a stage, misc for Q
  static constexpr int kBarFloats = 2 * (2 * F::kStages + 1);
  // the tiles from a 128-byte-aligned base (TMA's rule): 128 bytes of
  // slack
  static constexpr size_t kBytes =
      (F::kRTile + 2 * F::kStages * F::kTile + 8 * kP + F::kKeepWords +
       kBarFloats) * sizeof(float) + 128;
  // full counts the copy thread's arrival (with its TMA bytes), or with
  // dropout the 4 producer warps' (after their keep bits); misc the copy
  // thread's
  template <bool DROP>
  using Bars = flash_bulk::Bars<0, 2, F::kStages, kFConsumers / 32,
                                DROP ? (kFThreads - kFConsumers) / 32 : 1>;
  // a tile's TMA bytes: rows of kLd floats, the padding included
  static constexpr uint32_t kRowBytes = F::kLd * sizeof(float);
  static_assert(IR * JK <= 32, "a lane's keep bits fill one word");
  static_assert(kBytes <= 232448,
                "a CTA takes at most 227 KB of shared memory");
};

// a lane's first row in the CTA's tile, its row group (ua = rg: P's
// slots 4 rg + i, ffma_accumulate's rows) and its key group (ub = kg:
// keys kg + KG j, ffma_accumulate's columns)
template <int D>
struct FwdRoles {
  using W = FwdFfma<D>;
  int rr, ua, ub;
  __device__ __forceinline__ explicit FwdRoles(int tid) {
    const int lane = tid & 31;
    ua = lane / W::KG;
    ub = lane % W::KG;
    rr = W::WR * (tid >> 5) + ua;
  }
};

// s[i][j] = Q[rr + RG i] . K[ub + KG j] over D columns, Q resident and
// K walked, both row-major at D + 4: 4 + JK float4 loads for 16 JK FMAs
// a step, U steps unrolled
template <int D>
__device__ __forceinline__ void fwd_scores(float (&s)[4][FwdFfma<D>::JK],
                                           const float* Q, const float* K,
                                           const FwdRoles<D>& ro) {
  using W = FwdFfma<D>;
  constexpr int LD = W::kLd, JK = W::JK;
  const float* pa = Q + ro.rr * LD;
  const float* pb = K + ro.ub * LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JK; ++j) s[i][j] = 0.f;
#pragma unroll (W::U)
  for (int t = 0; t < D; t += 4) {
    float4 x[4], y[JK];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld4(pa + W::RG * i * LD + t);
#pragma unroll
    for (int j = 0; j < JK; ++j) y[j] = ld4(pb + W::KG * j * LD + t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
}

// The keep bits of the consumers' links in tile t, on the producer
// warpgroup: bit JK i + j of consumer thread c's word is the keep bit of
// its link (query row q0 + rr + RG i, key 64 t + kg + KG j). A Philox
// block (2 rows, 2 keys) holds links of the four lanes (rg, kg) with
// rg / 2 and kg / 2 alike, so a unit of work is 8 blocks of those four
// lanes, byte b of their words: 256 units a tile at 64, 128 at 128, the
// lanes of producer warp pw taking units 32 pw + lane, + 128.
template <int D>
__device__ __forceinline__ void fwd_keep_tile(const DropParams& dp, int bh,
                                              int q0, int t,
                                              uint32_t* keep_s, int pw,
                                              int lane) {
  using W = FwdFfma<D>;
  constexpr int kBytesWord = W::IR * W::JK / 8;  // bytes of a word
  constexpr int kUnits = 8 * (W::RG / 2) * (W::KG / 2) * kBytesWord;
  unsigned char* words = reinterpret_cast<unsigned char*>(keep_s);
  for (int u = 32 * pw + lane; u < kUnits; u += kFThreads - kFConsumers) {
    const int b = u % kBytesWord, kh = (u / kBytesWord) % (W::KG / 2);
    const int rh = (u / kBytesWord / (W::KG / 2)) % (W::RG / 2);
    const int w = u / kBytesWord / (W::KG / 2) / (W::RG / 2);
    uint32_t bits[2][2] = {};  // [row parity][key parity]
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = (8 * b + e) / W::JK, j = (8 * b + e) % W::JK;
      const int row = q0 + W::WR * w + 2 * rh + W::RG * i;
      const int key = t * kFR + 2 * kh + W::KG * j;
      const uint4 blk = drop_block(dp, bh, row, key);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          if (word_of(blk, 2 * x + y) >= dp.threshold)
            bits[x][y] |= 1u << e;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int c = 32 * w + (2 * rh + x) * W::KG + 2 * kh + y;
        words[4 * c + b] = (unsigned char)bits[x][y];
      }
  }
}

// The online softmax of one tile for a lane's rows: the row maxima m
// (base-2 units of the scaled logits) and the per-lane partial sums l
// move on, O shrinks by the rows' factors, and s becomes P (with DROP,
// 0 for a dropped link and times rinv for a kept one, bit JK i + j of
// keep; l sums the un-dropped probabilities). The maxima come from the
// raw scores, max(s * scale2) = |scale2| max(+-s). Only an EDGE tile
// (one that crosses the key bound or the diagonal) masks, the links
// from hi[i] - KG j on: their scores become `masked`, below every real
// one once scaled, so that their probabilities come out 0 from the same
// ex2 (a row sees key 0 in its first tile, so m is real from there on).
// Masks and keep bits act by a select and by integer masking each link
// on its own: held as predicates over the row's shuffles, the causal
// dropout variant's would need more than the 7 predicate registers a
// thread has, and ptxas refuses it (C7600, "register count of '7'").
template <int D, bool DROP, bool EDGE, bool NEG>
__device__ __forceinline__ void fwd_softmax(
    float (&s)[4][FwdFfma<D>::JK], float scale2, const int* hi,
    uint32_t keep, float rinv, float* m, float* l, float acc[4][8]) {
  using W = FwdFfma<D>;
  constexpr float masked = NEG ? -kNeg : kNeg;
#pragma unroll
  for (int i = 0; i < W::IR; ++i) {
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < W::JK; ++j) {
      if (EDGE && W::KG * j >= hi[i]) s[i][j] = masked;
      mx = fmaxf(mx, NEG ? -s[i][j] : s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < W::KG; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx * fabsf(scale2));
    const float corr = ex2(m[i] - m_new);
    m[i] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < W::JK; ++j) {
      float p = ex2(fmaf(s[i][j], scale2, -m_new));
      ps += p;
      // times rinv or 0 by its keep bit, as integer masking
      if (DROP)
        p *= __int_as_float(-(int)((keep >> (W::JK * i + j)) & 1u) &
                            __float_as_int(rinv));
      s[i][j] = p;
    }
    l[i] = l[i] * corr + ps;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
  }
}

template <int D, bool DROP, bool NEG>
__device__ __forceinline__ void fwd_softmax_tile(
    float (&s)[4][FwdFfma<D>::JK], float scale2, bool edge, const int* hi,
    uint32_t keep, float rinv, float* m, float* l, float acc[4][8]) {
  if (edge)
    fwd_softmax<D, DROP, true, NEG>(s, scale2, hi, keep, rinv, m, l, acc);
  else
    fwd_softmax<D, DROP, false, NEG>(s, scale2, hi, keep, rinv, m, l, acc);
}

struct FfmaArgs {
  float* o;    // f32 [b, sq, n, D], contiguous
  float* lse;  // f32 [b, n, sq]
  int n_heads, sq, sk;
  float scale;
  DropParams dp;
};

// The f32 forward: a CTA per R query rows of a (batch, head) (causal:
// the longest walks first, and the CTA stops at its last visible tile),
// Q resident, K and V walked by 64-key tiles, each tile one TMA box of
// the tensor maps tq, tk, tv (hopper.cuh's f32_rows_map). Each tile,
// each consumer warp on its own: S of its rows, the online softmax, P
// into its tile, O += P V. A warp past its rows' last visible key only
// hands the tile back.
template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kFThreads, 1)
    fwd_ffma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const FfmaArgs a) {
  using W = FwdFfma<D>;
  constexpr int S = W::kStages, R = W::kR, IR = W::IR, JK = W::JK;
  extern __shared__ __align__(128) unsigned char smem_fwdf[];
  const uint32_t raw = smem_u32(smem_fwdf);
  float* Qs = reinterpret_cast<float*>(smem_fwdf +
                                       (((raw + 127u) & ~127u) - raw));
  float* Kw = Qs + W::kRTile;  // stage st: K at Kw + 2 st kTile, V after
  float* Ps = Kw + 2 * S * W::kTile;  // warp w's P tile at Ps + w kP
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(Ps + 8 * W::kP);

  const int bh = blockIdx.x;
  const int bi = bh / a.n_heads, hi = bh % a.n_heads;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sq = a.sq, sk = a.sk;
  const typename W::template Bars<DROP> bars(
      reinterpret_cast<float*>(keep_s + W::kKeepWords));
  if (tid == 0) bars.init();
  __syncthreads();
  int nk = (sk + kFR - 1) / kFR;
  if (CAUSAL) nk = min(nk, (q0 + R - 1) / kFR + 1);
  uint32_t phase = 0u;

  if (warp >= kFConsumers / 32) {
    // the producer warpgroup: one thread copies Q once, then K and V a
    // tile, each a TMA box; with dropout all its warps compute the
    // tile's keep bits after that thread's copies are issued
    regs_dec<kFProdRegs>();
    const int pw = warp - kFConsumers / 32;
    const bool copier = pw == 0 && lane == 0;
    if (copier) {
      mbar_expect_tx(bars.misc(), R * W::kRowBytes);
      tma_load_4d(smem_u32(Qs), &tq, bars.misc(), 0, hi, q0, bi);
      mbar_arrive(bars.misc());
    }
    if (!DROP && !copier) return;
    const DropParams dp = drop_params<DROP>(a.dp);
    for (int t = 0; t < nk; ++t) {
      const int st = t % S;
      if (t >= S) flash_bulk::bar_wait(bars.empty(st), phase, st);
      if (copier) {
        const uint32_t dst = smem_u32(Kw + 2 * st * W::kTile);
        mbar_expect_tx(bars.full(st), 2 * kFR * W::kRowBytes);
        tma_load_4d(dst, &tk, bars.full(st), 0, hi, t * kFR, bi);
        tma_load_4d(dst + W::kTile * sizeof(float), &tv, bars.full(st), 0,
                    hi, t * kFR, bi);
      }
      if (DROP) {
        fwd_keep_tile<D>(dp, bh, q0, t, keep_s + st * kFConsumers, pw,
                         lane);
        flash_bulk::warp_release(bars.full(st), lane);
      } else {
        mbar_arrive(bars.full(st));
      }
    }
    return;
  }

  regs_inc<kFConsRegs>();
  const FwdRoles<D> ro(tid);
  const int wrow = q0 + W::WR * warp;  // the warp's first query row
  // under a causal mask the tiles from wlast on lie wholly above the
  // warp's rows
  const int wlast = CAUSAL ? min(nk, (wrow + W::WR - 1) / kFR + 1) : nk;
  // the keys below klim[i] that the lane's row i may see (rows past sq
  // are never written, so they need no mask of their own)
  int klim[IR];
#pragma unroll
  for (int i = 0; i < IR; ++i)
    klim[i] = CAUSAL ? min(sk, q0 + ro.rr + W::RG * i + 1) : sk;
  const float scale2 = a.scale * kLog2e;  // softmax in base 2
  float* Pw = Ps + warp * W::kP;
  float acc[4][8], m[IR], l[IR];
  zero8(acc);
#pragma unroll
  for (int i = 0; i < IR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }

  flash_bulk::bar_wait(bars.misc(), phase, S);
  for (int t = 0; t < nk; ++t) {
    const int st = t % S, k0 = t * kFR;
    const float* Kt = Kw + 2 * st * W::kTile;
    flash_bulk::bar_wait(bars.full(st), phase, st);
    if (t < wlast) {
      float s[IR][JK];
      fwd_scores<D>(s, Qs, Kt, ro);
      const uint32_t keep = DROP ? keep_s[st * kFConsumers + tid] : 0u;
      const bool edge = k0 + kFR > sk || (CAUSAL && k0 + kFR - 1 > wrow);
      int hi_[IR];
#pragma unroll
      for (int i = 0; i < IR; ++i) hi_[i] = klim[i] - k0 - ro.ub;
      if (scale2 >= 0.f)
        fwd_softmax_tile<D, DROP, false>(s, scale2, edge, hi_, keep,
                                         a.dp.rinv, m, l, acc);
      else
        fwd_softmax_tile<D, DROP, true>(s, scale2, edge, hi_, keep,
                                        a.dp.rinv, m, l, acc);
      // P of row rg + RG i at slot 4 rg + i (the last tile's reads of the
      // warp's P tile are ordered before by warp_release's __syncwarp)
#pragma unroll
      for (int j = 0; j < JK; ++j)
        *reinterpret_cast<float4*>(Pw + (ro.ub + W::KG * j) * W::WR +
                                   4 * ro.ua) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
      ffma_accumulate<D, W::WR>(acc, Pw, Kt + W::kTile, ro);
    }
    flash_bulk::warp_release(bars.empty(st), lane);
  }

  // l over the row's KG lanes; O = acc / l_safe, lse = m + log(l_safe)
  float* ob = a.o + ((long long)bi * sq * a.n_heads + hi) * D;
#pragma unroll
  for (int i = 0; i < IR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < W::KG; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float l_safe = fmaxf(lt, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = q0 + ro.rr + W::RG * i;
    if (row >= sq) continue;
    if (ro.ub == 0)
      a.lse[(long long)bh * sq + row] = (m[i] + log2f(l_safe)) * kLn2;
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(ob + (long long)row * a.n_heads * D +
                                 (D / 2) * g + 4 * ro.ub) =
          make_float4(acc[i][4 * g] * inv, acc[i][4 * g + 1] * inv,
                      acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
  }
}

// ------------------------------------------ bf16, wgmma + TMA + mbarriers

struct FwdArgs {
  void* o;     // bf16 [b, sq, n, D], contiguous
  float* lse;  // f32 [b, n, sq]
  int batch, n_heads, sq, sk;
  float scale;
  DropParams dp;
};

// Shared memory, byte offsets from a 1024-aligned base. A tile of R rows
// is [D / 64 halves][R lines][128 bytes]. The owned Q tile has two
// buffers, so that the next item's load overlaps this one's products;
// the streamed K and V tiles have a ring of S stages. Each stage also
// holds the 32 keep bits of every consumer thread (u32 [256]).
template <int D>
struct FwdLayout {
  static constexpr int H = D / 64, S = ring<D>();
  static constexpr int kQTile = H * kOwn * kLine;
  static constexpr int kStrmTile = H * kStrm * kLine;
  // Q buffer b at b * kQTile; streamed tile i (K, V) of stage st at
  // kStrmAt + (i * S + st) * kStrmTile
  static constexpr int kStrmAt = 2 * kQTile;
  static constexpr int kKeep = kStrmAt + 2 * S * kStrmTile;
  static constexpr int kBar = kKeep + S * kConsumers * 4;
  static constexpr int kBytes = kBar + (4 + 2 * S) * 8 + 1024;
};

// The probabilities of a tile, p = 2^(s * scale2 - m) of each row, and
// their row sums; EDGE: 0 past hi[r]. With DROP, p is 0 for a dropped
// link and times rinv for a kept one (bit i of keep); the sums are of
// the un-dropped probabilities. (The row maxima m come from
// flash_wgmma.cuh's row_max.)
template <bool DROP, bool EDGE>
__device__ __forceinline__ void row_probs(const float* s, float scale2,
                                          const float* m, const int* hi,
                                          uint32_t keep, float rinv,
                                          float* ps, float* p) {
  const int lo[2] = {0, 0};
  float part[2][4] = {};  // four partial sums a row, as in row_max
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float e = ex2(fmaf(s[i], scale2, -m[r]));
    if (EDGE && !slot_ok(i, lo, hi)) e = 0.f;
    part[r][(i & 1) | ((i >> 1) & 2)] += e;
    if (DROP) e = ((keep >> i) & 1) ? e * rinv : 0.f;
    p[i] = e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    ps[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
}

// The online softmax of one k-tile for a consumer thread's two rows:
// the row maxima m and corr move on (flash_wgmma.cuh's online_max), the
// per-lane partial sums l too, and p gets the probabilities (row_probs).
// A masked probability is exactly 0.
template <bool DROP>
__device__ __forceinline__ void softmax_tile(const float* s, float scale2,
                                             bool edge, const int* hi,
                                             uint32_t keep, float rinv,
                                             float* m, float* l, float* corr,
                                             float* p) {
  online_max(s, scale2, edge, hi, m, corr);
  float ps[2];
  if (edge) row_probs<DROP, true>(s, scale2, m, hi, keep, rinv, ps, p);
  else row_probs<DROP, false>(s, scale2, m, hi, keep, rinv, ps, p);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
}

// A warp's 16 rows from row0 of an owned Q buffer (shared address q;
// line r's 16-byte chunk c sits at chunk c ^ (r % 8)) as the register A
// fragments of the D / 16 k-steps of S = Q K^T: a0 (g, 2t..), a1 (g+8,
// 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..) of each k-step's 16 columns.
// The buffer is released once they are loaded, so each fragment goes
// through an opaque asm: else the compiler may load it again from the
// buffer later (instead of keeping a register), after the producer has
// refilled it with another item's Q.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (*qf)[4],
                                             const unsigned char* q,
                                             int row0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned char* half = q + (kk >> 2) * kOwn * kLine;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = row0 + g + 8 * (x & 1), c = (kk & 3) * 2 + (x >> 1);
      qf[kk][x] = *reinterpret_cast<const uint32_t*>(
          half + r * kLine + ((c ^ (r & 7)) << 4) + 4 * t);
      asm volatile("" : "+r"(qf[kk][x]) :: "memory");
    }
  }
}

// S of a warpgroup's 64 query rows, Q as the register fragments qf,
// against a 64-key streamed tile over D (K-major in shared memory): only
// K is read from shared memory, half of what an S with both operands
// there reads
template <int D>
__device__ __forceinline__ void scores_rs(float* s, uint32_t (*qf)[4],
                                          uint32_t strm) {
  wgmma_rs<false>(s, qf[0], sw128_desc(strm));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_rs<true>(s, qf[kk], sw128_desc(strm + (kk >> 2) * kStrm * kLine +
                                          (kk & 3) * 32));
}

// Warpgroup 2 produces: TMA from one thread, the keep bits from all 128.
// Warpgroups 0 and 1 consume 64 query rows each: per k-tile, S by
// wgmma, the online softmax, O += P V by wgmma.
template <int D, bool CAUSAL, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using L = FwdLayout<D>;
  constexpr int H = L::H, S = L::S;
  extern __shared__ __align__(1024) unsigned char smem_fwd[];
  unsigned char* sm = align1024(smem_fwd);
  const uint32_t base = smem_u32(sm);
  const Bars<S> bars{base + L::kBar};
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(sm + L::kKeep);
  const int sq = a.sq, sk = a.sk;
  const int nblk = (sq + kOwn - 1) / kOwn;
  const int items = a.batch * a.n_heads * nblk;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) bars.init();
  __syncthreads();

  if (wg == 2) {
    regs_dec<kProducerRegs>();
    const DropParams dp = drop_params<DROP>(a.dp);
    const int p = tid - kConsumers;
    int tile = 0, n = 0;  // k-tiles and items of this CTA so far
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Item it = work_item<false, CAUSAL>(a, item, nblk);
      const int ob = n & 1;
      mbar_wait(bars.own_empty(ob), ((n >> 1) & 1) ^ 1);
      if (p == 0) {
        mbar_expect_tx(bars.own_full(ob), L::kQTile);
#pragma unroll
        for (int h = 0; h < H; ++h)
          tma_load_4d(base + ob * L::kQTile + h * kOwn * kLine, &tq,
                      bars.own_full(ob), h * 64, it.hi, it.own0, it.bi);
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
                          i ? &tv : &tk, bars.full(st), h * 64, it.hi, s0,
                          it.bi);
        }
        if (DROP)
          keep_words<false>(dp, it.bh, it.own0, s0, p,
                            keep_s + st * kConsumers);
        mbar_arrive(bars.full(st));
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int lrow = wg * 64 + warp * 16;  // the warp's first row in a block
    const float scale2 = a.scale * kLog2e;  // softmax in base 2
    const long long o_row = (long long)a.n_heads * D;  // O's row stride
    int tile = 0, n = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Item it = work_item<false, CAUSAL>(a, item, nblk);
      const int ob = n & 1;
      const int wrow = it.own0 + lrow;  // the warp's first query row
      const int rows[2] = {wrow + g, wrow + g + 8};
      // the keys below klim[r] that row r may see (rows past sq are
      // never written, so they need no mask of their own)
      int klim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        klim[r] = CAUSAL ? min(sk, rows[r] + 1) : sk;
      float acc[H][32];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
      // m in base-2 units of the scaled logits; l a per-lane partial sum
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
      // the warp's rows of Q in registers for the whole item: its
      // buffer is free for the item after next at once
      mbar_wait(bars.own_full(ob), (n >> 1) & 1);
      uint32_t qf[D / 16][4];
      load_q_frags<D>(qf, sm + ob * L::kQTile, lrow, g, t);
      release(bars.own_empty(ob), lane);
      // under a causal mask the k-tiles from wlast on lie wholly above
      // this warpgroup's rows
      const int wlast =
          CAUSAL ? min(it.last, (it.own0 + wg * 64 + 63) / kStrm + 1)
                 : it.last;
      // the K and V tiles of ring stage st
      auto strm_k = [&](int st) {
        return base + L::kStrmAt + st * L::kStrmTile;
      };
      auto strm_v = [&](int st) { return strm_k(st) + S * L::kStrmTile; };

      float s[32], pr[32], corr[2];
      uint32_t f[4][4];  // P of the pending tile, as bf16 A fragments
      // the online softmax of the scores s of the tile from key s0
      auto softmax = [&](int s0, uint32_t keep) {
        const bool edge =
            s0 + kStrm > sk || (CAUSAL && s0 + kStrm - 1 > wrow);
        const int hi[2] = {klim[0] - s0 - 2 * t, klim[1] - s0 - 2 * t};
        softmax_tile<DROP>(s, scale2, edge, hi, keep, a.dp.rinv, m, l, corr,
                           pr);
      };

      // the first tile: S alone
      int pst = tile % S;  // the pending tile's stage
      mbar_wait(bars.full(pst), (tile / S) & 1);
      wgmma_fence();
      scores_rs<D>(s, qf, strm_k(pst));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      softmax(it.first * kStrm, DROP ? keep_s[pst * kConsumers + tid] : 0u);
      pack_a(f, pr);  // O is 0 still: no rescale
      ++tile;
      // then per tile: S of this tile with O += P V of the last one, the
      // softmax under that P V, its wait, O *= corr
      for (int j = it.first + 1; j < wlast; ++j, ++tile) {
        const int st = tile % S;
        mbar_wait(bars.full(st), (tile / S) & 1);
        pin_frags(f);
        fence_accs<D>(acc);
        wgmma_fence();
        scores_rs<D>(s, qf, strm_k(st));
        wgmma_commit();
        accumulate<D>(acc, f, strm_v(pst));
        wgmma_commit();
        const uint32_t keep = DROP ? keep_s[st * kConsumers + tid] : 0u;
        wgmma_wait<1>();
        fence_acc(s);
        softmax(j * kStrm, keep);
        wgmma_wait<0>();
        fence_accs<D>(acc);
        release(bars.empty(pst), lane);
        // O *= corr, between the last P V's wait and the next issue
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i >> 1) & 1];
        pack_a(f, pr);
        pst = st;
      }
      // the last tile's O += P V
      pin_frags(f);
      fence_accs<D>(acc);
      wgmma_fence();
      accumulate<D>(acc, f, strm_v(pst));
      wgmma_commit();
      wgmma_wait<0>();
      release(bars.empty(pst), lane);
      // the tiles above this warpgroup's rows: only their stages
      for (int j = wlast; j < it.last; ++j, ++tile) {
        const int st = tile % S;
        mbar_wait(bars.full(st), (tile / S) & 1);
        release(bars.empty(st), lane);
      }
      fence_accs<D>(acc);

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
      store_acc_rows<D>(static_cast<__nv_bfloat16*>(a.o) +
                            (long long)it.bi * sq * o_row + it.hi * D,
                        o_row, acc, rows, sq, inv, t);
    }
  }
}

// ------------------------------------------------------------ launching

// fwd_ffma: tensor maps of q (R-row boxes), k and v (kFR-row boxes),
// every row 16-byte aligned (rows16); a CTA per R query rows of a
// (batch, head)
template <int D, bool C, bool DROP>
cudaError_t launch_ffma(const void* q, const void* k, const void* v,
                        const Strides& qs, const Strides& ks,
                        const Strides& vs, const FwdArgs& a,
                        cudaStream_t stream) {
  constexpr int R = FwdFfma<D>::kR;
  const int b = a.batch, n = a.n_heads;
  const long long o_row = (long long)n * D;  // O is packed
  CUtensorMap tq, tk, tv;
  if (!(rows16(q, qs) && rows16(k, ks) && rows16(v, vs) &&
        rows16(a.o, Strides{a.sq * o_row, o_row, D})) ||
      f32_rows_map(&tq, q, b, a.sq, n, D, qs.b, qs.s, qs.n, R) ||
      f32_rows_map(&tk, k, b, a.sk, n, D, ks.b, ks.s, ks.n, kFR) ||
      f32_rows_map(&tv, v, b, a.sk, n, D, vs.b, vs.s, vs.n, kFR))
    return cudaErrorInvalidValue;
  const FfmaArgs f{static_cast<float*>(a.o), a.lse, n, a.sq, a.sk, a.scale,
                   a.dp};
  return go(fwd_ffma<D, C, DROP>, dim3(b * n, (a.sq + R - 1) / R),
            kFThreads, FwdFfma<D>::kBytes, stream, tq, tk, tv, f);
}

// fwd_wgmma: tensor maps of q (kOwn-row boxes), k and v (kStrm-row
// boxes); one CTA per SM, or one per work item when there are fewer
template <int D, bool C, bool DROP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const Strides& qs, const Strides& ks,
                         const Strides& vs, const FwdArgs& a,
                         cudaStream_t stream) {
  const int b = a.batch, n = a.n_heads;
  CUtensorMap tq, tk, tv;
  if (bf16_rows_map(&tq, q, b, a.sq, n, D, qs.b, qs.s, qs.n, kOwn) ||
      bf16_rows_map(&tk, k, b, a.sk, n, D, ks.b, ks.s, ks.n, kStrm) ||
      bf16_rows_map(&tv, v, b, a.sk, n, D, vs.b, vs.s, vs.n, kStrm))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long items = (long long)b * n * ((a.sq + kOwn - 1) / kOwn);
  const dim3 grid((unsigned)(items < sms ? items : sms));
  return go(fwd_wgmma<D, C, DROP>, grid, kWgThreads, FwdLayout<D>::kBytes,
            stream, tq, tk, tv, a);
}

}  // namespace

// dtype: 0 = float32 (FFMA kernel), 1 = bfloat16 (wgmma kernel).
// Strides are element strides (batch, seq, head) of [b, s, n, h] tensors
// whose head_dim stride is 1; in bf16 they are the layout the tensor
// maps describe: multiples of 8 elements, and a dimension of size 1
// given the stride a packed tensor would have. o is written contiguous
// [b, sq, n, h], lse f32 [b, n, sq]. dropout != 0 applies attention
// dropout with the keep threshold, the 64-bit Philox seed at `seed` in
// device memory (two 32-bit words, lo then hi; read by the kernel) and
// rinv = 1 / (1 - p). Returns 0 on success, a cudaError_t
// code if a launch or a tensor map was refused, or -1 for a dtype /
// head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    const void* seed, float rinv, void* stream_ptr) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  const DropParams dp{threshold, static_cast<const uint32_t*>(seed), 0u, 0u,
                      rinv};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FwdArgs a{};
  a.o = o; a.lse = lse;
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = dp;

#define PT_GO(D, C, P)                                                 \
  (dtype == 1 ? launch_wgmma<D, C, P>(q, k, v, qs, ks, vs, a, stream) \
              : launch_ffma<D, C, P>(q, k, v, qs, ks, vs, a, stream))
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
