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
// double and the arithmetic runs on the FP32 pipes (67 TFLOP/s), so f32
// is bound by operations.
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
//  * f32 (flash_fwd_simt): exact f32 FFMA, no TF32, so results agree
//    with a float32 reference to ~1e-6. 256 threads each own a 4x4
//    block of S and a 4x(h/16) block of O; tiles sit transposed in
//    shared memory so every inner step is two 16-byte shared loads for
//    16 FMAs. Dropout costs one Philox4x32-10 call per 2x2 block.

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

// The larger of each of a thread's two rows' raw scores (slot i is in
// row (i / 2) % 2), NEG: of the negated scores; on an EDGE tile over the
// links below hi[r] only (see slot_ok)
// (four partial maxima a row, so the dependent chains are short)
template <bool NEG, bool EDGE>
__device__ __forceinline__ void row_max(const float* s, const int* hi,
                                        float* mx) {
  const int lo[2] = {0, 0};
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[r][k] = mx[r];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float& x = part[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)];
    if (!EDGE || slot_ok(i, lo, hi)) x = fmaxf(x, NEG ? -s[i] : s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]),
                  fmaxf(part[r][2], part[r][3]));
}

// The probabilities of a tile, p = 2^(s * scale2 - m) of each row, and
// their row sums; EDGE: 0 past hi[r]. With DROP, p is 0 for a dropped
// link and times rinv for a kept one (bit i of keep); the sums are of
// the un-dropped probabilities.
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
// the row maxima m (base-2 units of the scaled logits) and the per-lane
// partial sums l move on, p gets the probabilities (row_probs) and corr
// the factor by which the rows' earlier O shrinks. The maxima come from
// the raw scores, max(s * scale2) = |scale2| max(+-s); only an edge
// tile (one that crosses the key bound or the diagonal) masks, and a
// masked probability is exactly 0.
template <bool DROP>
__device__ __forceinline__ void softmax_tile(const float* s, float scale2,
                                             bool edge, const int* hi,
                                             uint32_t keep, float rinv,
                                             float* m, float* l, float* corr,
                                             float* p) {
  float mx[2] = {kNeg, kNeg};
  if (scale2 >= 0.f) {
    if (edge) row_max<false, true>(s, hi, mx);
    else row_max<false, false>(s, hi, mx);
  } else {
    if (edge) row_max<true, true>(s, hi, mx);
    else row_max<true, false>(s, hi, mx);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 lanes of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // a row with no link in this tile gets at most kNeg * |scale2|,
    // below any real logit: a real m stays, and its p are 0 anyway
    const float m_new = fmaxf(m[r], mx[r] * fabsf(scale2));
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
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
          keep_words<false>(a.dp, it.bh, it.own0, s0, p,
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

template <int D, bool C, bool DROP>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* o, float* lse, int b, int n, int sq, int sk,
                        Strides qs, Strides ks, Strides vs, float scale,
                        DropParams dp, cudaStream_t stream) {
  return go(flash_fwd_simt<D, C, DROP>, dim3(b * n, (sq + kBM - 1) / kBM),
            kSimtThreads, simt_smem_bytes<D>(), stream,
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), lse, n, sq,
            sk, qs, ks, vs, scale, dp);
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
// dropout with the keep threshold, the 64-bit Philox seed (seed_lo,
// seed_hi) and rinv = 1 / (1 - p). Returns 0 on success, a cudaError_t
// code if a launch or a tensor map was refused, or -1 for a dtype /
// head_dim this file has no kernel for.
extern "C" int pt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int b, int n, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sn,
    long long k_sb, long long k_ss, long long k_sn,
    long long v_sb, long long v_ss, long long v_sn,
    float scale, int causal, int dropout, unsigned int threshold,
    unsigned int seed_lo, unsigned int seed_hi, float rinv,
    void* stream_ptr) {
  if ((dtype != 0 && dtype != 1) || (d != 64 && d != 128)) return -1;
  const Strides qs{q_sb, q_ss, q_sn}, ks{k_sb, k_ss, k_sn},
      vs{v_sb, v_ss, v_sn};
  const DropParams dp{threshold, seed_lo, seed_hi, rinv};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  FwdArgs a{};
  a.o = o; a.lse = lse;
  a.batch = b; a.n_heads = n; a.sq = sq; a.sk = sk; a.scale = scale;
  a.dp = dp;

#define PT_GO(D, C, P)                                                      \
  (dtype == 1 ? launch_wgmma<D, C, P>(q, k, v, qs, ks, vs, a, stream)      \
              : launch_simt<D, C, P>(q, k, v, o, lse, b, n, sq, sk, qs, ks, \
                                     vs, scale, dp, stream))
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
