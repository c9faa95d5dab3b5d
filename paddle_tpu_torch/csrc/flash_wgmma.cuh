// The warp-specialised wgmma pipeline shared by the bf16 flash-attention
// kernels: the forward (fwd_wgmma, flash_attn_fwd.cu) and the dQ and
// dK/dV backward (dq_wgmma, dkv_wgmma, flash_attn_bwd.cu) at head_dim 64
// and 128, the forward, dQ and dK/dV at 256 (fwd_wg256, dq_wg256,
// dkv_wg256, flash_attn_wg256.cu: one owned buffer, the backward on
// 32-row streamed tiles, dK/dV on 64 owned keys, a register split of
// their own), and the forward, dQ and dK/dV above 256 (fwd_wgwide,
// dq_wgwide, dkv_wgwide, flash_attn_wgwide.cu: a CTA per 256-wide output
// chunk, the scores' operands streamed in 64-column sub-tiles).
//
// A CTA of 384 threads owns kOwn = 128 rows of one (batch, head): query
// rows for the forward and dQ, keys for dK/dV. Warpgroups 0 and 1 are
// consumers of 64 rows each; warpgroup 2 is the producer and gives up
// registers to them (setmaxnreg). One producer thread loads the owned
// tiles by TMA into two buffers and streams the kStrm-row tiles of the
// other side through an mbarrier ring; the producer's 128 threads also
// compute the stage's Philox keep bits. The grid is one CTA per SM, each
// walking over (batch, head, row block) work items. Here: the ring's
// depth and barriers, the register split, the products (S by wgmma_ss,
// X B by wgmma_rs_t on packed A fragments), the keep bits, the epilogue
// store, the work items and the launch helpers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace flash_wg {

using namespace flash;
using namespace hopper;

constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kConsumers = 256, kProducers = 128;
constexpr int kOwn = 128;        // rows a CTA owns, 64 per consumer
constexpr int kStrm = 64;        // rows of a streamed tile
constexpr int kLine = 128;       // bytes of a swizzled tile line (64 bf16)
constexpr int kProducerRegs = 64, kConsumerRegs = 216;
// setmaxnreg moves registers within the CTA's own pool, which is what
// __launch_bounds__(384, 1) gives every thread at launch (168): asking
// for more than the pool holds would spin in the allocation forever
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <=
                  168 * kWgThreads,
              "the warpgroups' registers exceed the CTA's pool");

// depth of the streamed-tile ring, as deep as shared memory allows
template <int D>
constexpr int ring() { return D == 64 ? 4 : 2; }

// The mbarriers: owned buffer b full and empty, ring stage s full and
// empty. Full: its TMA bytes have landed and every producer thread has
// stored its part (keep bits, lse, delta). Empty: every consumer warp is
// done with it.
template <int S>
struct Bars {
  uint32_t at;
  __device__ uint32_t own_full(int b) const { return at + 8 * b; }
  __device__ uint32_t own_empty(int b) const { return at + 16 + 8 * b; }
  __device__ uint32_t full(int s) const { return at + 32 + 8 * s; }
  __device__ uint32_t empty(int s) const { return at + 32 + 8 * (S + s); }
  __device__ void init() const {
    for (int b = 0; b < 2; ++b) {
      mbar_init(own_full(b), kProducers);
      mbar_init(own_empty(b), kConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), kProducers);
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_fence_init();
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// the register A fragments of k-steps 0..K-1 from a thread's 8 K score
// slots (slot 4 c + e is column 8 c + 2 t + e % 2 of row g + 8 (e / 2))
template <int K = 4>
__device__ __forceinline__ void pack_a(uint32_t (*f)[4], const float* x) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    f[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    f[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    f[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    f[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// The keep bits of one stage for two consumer lanes, g0 and g0 + 1, of
// consumer thread pair p (0..127): bit 4 c + e of a lane's word is its
// score slot 4 c + e, as the slot layout above, over C column chunks of
// 8 (a stage of 8 C streamed rows). Their owned rows (query rows for the
// forward and dQ, keys for dK/dV) share row >> 1, so both take their
// bits from the same two 2x2 Philox blocks per column chunk: 2 C Philox
// calls per pair and stage. With KEYS_OWNED the link is
// (streamed query, owned key), else (owned row, streamed key). The owned
// row r0 and the streamed column x are even, so a link's word in its
// block, (row & 1) * 2 + (col & 1) as philox.cuh's drop_keep takes it,
// is known at compile time here.
template <bool KEYS_OWNED, int C = 8>
__device__ __forceinline__ void keep_words(const DropParams& dp, int bh,
                                           int own0, int strm0, int p,
                                           uint32_t* words) {
  const int wg = p >> 6, w = (p >> 4) & 3, g0 = ((p >> 2) & 3) * 2;
  const int t = p & 3;
  const int r0 = own0 + wg * 64 + w * 16 + g0;
  uint32_t m[2] = {0u, 0u};
#pragma unroll 2
  for (int c = 0; c < C; ++c) {
    const int x = strm0 + c * 8 + 2 * t;
    uint32_t nib[2] = {0u, 0u};  // slots 4 c .. 4 c + 3 of lanes g0, g0 + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0 (+1) and r0 + 8 (+1)
      const int own = r0 + 8 * h;
      const uint4 w4 = KEYS_OWNED ? drop_block(dp, bh, x, own)
                                  : drop_block(dp, bh, own, x);
      const uint32_t wd[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (wd[KEYS_OWNED ? e * 2 + j : j * 2 + e] >= dp.threshold)
            nib[j] |= 1u << (2 * h + e);
    }
    m[0] |= nib[0] << (4 * c);
    m[1] |= nib[1] << (4 * c);
  }
  const int lane0 = wg * 128 + w * 32 + g0 * 4 + t;
  words[lane0] = m[0];
  words[lane0 + 4] = m[1];
}

// sum of the products of 8 bf16 pairs, in f32 (the dQ kernels' delta)
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

// write a warpgroup's 64 x D f32 accumulators (D / 64 halves) as bf16
// rows, row r times mul[r]; rows at or past limit are not written
template <int D>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* base,
                                               long long row_stride,
                                               float (*acc)[32],
                                               const int* rows, int limit,
                                               const float* mul, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= limit) continue;
    __nv_bfloat16* out = base + (long long)rows[r] * row_stride;
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(&out[h * 64 + c * 8 + 2 * t]) =
            pack_bf16(acc[h][c * 4 + 2 * r] * mul[r],
                      acc[h][c * 4 + 2 * r + 1] * mul[r]);
  }
}

// the same, every row times one mul
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base,
                                          long long row_stride,
                                          float (*acc)[32], const int* rows,
                                          int limit, float mul, int t) {
  const float muls[2] = {mul, mul};
  store_acc_rows<D>(base, row_stride, acc, rows, limit, muls, t);
}

// S (or dP) of a warpgroup's 64 owned rows against an R-row streamed
// tile (R 64 or 32: 32 or 16 score slots a thread) over D: both K-major
// in shared memory, the owned tile's halves O lines apart
template <int D, int R = kStrm, int O = kOwn>
__device__ __forceinline__ void scores(float* s, uint32_t own,
                                       uint32_t strm) {
  static_assert(R == 64 || R == 32, "a streamed tile is 64 or 32 rows");
  // k-step kk: half kk / 4 of both tiles, its 32-byte column kk % 4
  auto da = [&](int kk) {
    return sw128_desc(own + (kk >> 2) * O * kLine + (kk & 3) * 32);
  };
  auto db = [&](int kk) {
    return sw128_desc(strm + (kk >> 2) * R * kLine + (kk & 3) * 32);
  };
  if constexpr (R == 64) {
    wgmma_ss<false>(s, da(0), db(0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<true>(s, da(kk), db(kk));
  } else {
    wgmma_ss_n32<false>(s, da(0), db(0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n32<true>(s, da(kk), db(kk));
  }
}

// acc += X B, X the 64 x R bf16 fragments f (R / 16 k-steps), B an R-row
// streamed tile [R lines][D] read MN-major
template <int D, int R = kStrm>
__device__ __forceinline__ void accumulate(float (*acc)[32],
                                           uint32_t (*f)[4], uint32_t strm) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int j = 0; j < R / 16; ++j)
      wgmma_rs_t(acc[h], f[j],
                 sw128_desc(strm + h * R * kLine + j * 16 * kLine));
}

// Materialise all bf16 A fragments (K k-steps) of an accumulate product
// before it is issued: else the compiler may re-pack them one k-step at
// a time into registers of an accumulator, and ptxas then serialises
// every wgmma of the kernel.
template <int K = 4>
__device__ __forceinline__ void pin_frags(uint32_t (*f)[4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(f[j][k]) :: "memory");
}

template <int D>
__device__ __forceinline__ void fence_accs(float (*acc)[32]) {
#pragma unroll
  for (int h = 0; h < D / 64; ++h) fence_acc(acc[h]);
}

// slot i of a thread's scores is a valid link when lo[r] <= 8 (i / 4) +
// i % 2 < hi[r], r = (i / 2) % 2
__device__ __forceinline__ bool slot_ok(int i, const int* lo, const int* hi) {
  const int r = (i >> 1) & 1, x = (i >> 2) * 8 + (i & 1);
  return x >= lo[r] && x < hi[r];
}

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

// The maxima half of a k-tile's online softmax for a consumer thread's
// two rows: the row maxima m (base-2 units of the scaled logits) move on
// and corr gets the factor by which the rows' earlier O and l shrink.
// The maxima come from the raw scores, max(s * scale2) = |scale2|
// max(+-s); only an edge tile (one that crosses the key bound or the
// diagonal) masks, over the links below hi[r].
__device__ __forceinline__ void online_max(const float* s, float scale2,
                                           bool edge, const int* hi,
                                           float* m, float* corr) {
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
}

// The probabilities of a 64-key tile, p = 2^(s * scale2 - m) of each row
// (EDGE: 0 past hi[r]; DROP: 0 for a dropped link, times rinv for a kept
// one, bit i of keep), packed to the bf16 A fragments f of O += P V as
// they are computed (flash_attn_fwd.cu's row_probs keeps them in f32
// first: at head_dim 256 and above those 32 registers go to O), and
// their un-dropped row sums ps
template <bool DROP, bool EDGE>
__device__ __forceinline__ void probs_a(const float* s, float scale2,
                                        const float* m, const int* hi,
                                        uint32_t keep, float rinv,
                                        float* ps, uint32_t (*f)[4]) {
  const int lo[2] = {0, 0};
  float part[2][4] = {};  // four partial sums a row
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = (i >> 1) & 1;
    float e[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x = ex2(fmaf(s[i + u], scale2, -m[r]));
      if (EDGE && !slot_ok(i + u, lo, hi)) x = 0.f;
      part[r][u | ((i >> 1) & 2)] += x;
      if (DROP) x = ((keep >> (i + u)) & 1) ? x * rinv : 0.f;
      e[u] = x;
    }
    // slots 8 j + 2 k and + 1 are A fragment register k of k-step j
    f[i >> 3][(i >> 1) & 3] = pack_bf16(e[0], e[1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    ps[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
}

// One CTA per SM walks over work items (a (batch, head) and one block of
// its rows), item = blockIdx.x + i * gridDim.x: the items of one (batch,
// head) are neighbours, so the CTAs on the card at once share their
// streamed tiles in L2.
//
// The row block of an item. Its order within a (batch, head) turns by
// one per head: with item % nblk and a grid that is a multiple of nblk
// (132 CTAs, nblk 4 at s 512), each CTA would draw the same block every
// time, and under a causal mask the blocks' work differs up to 4-fold.
__device__ __forceinline__ int item_block(int item, int nblk) {
  return (item + item / nblk) % nblk;
}

// A work item: its (batch, head), its block of O owned rows from own0,
// and the R-row streamed tiles [first, last) that meet them: for the
// forward and dQ the k-tiles (under a causal mask, up to the block's
// last row), for dK/dV the q-tiles (under a causal mask, from the
// block's first key on). Args has the kernel's n_heads, sq and sk.
struct Item {
  int bh, bi, hi, own0, first, last;
};

template <bool DKV, bool CAUSAL, int R = kStrm, int O = kOwn,
          typename Args>
__device__ __forceinline__ Item work_item(const Args& a, int item,
                                          int nblk) {
  Item it;
  it.bh = item / nblk;
  it.bi = it.bh / a.n_heads;
  it.hi = it.bh % a.n_heads;
  it.own0 = item_block(item, nblk) * O;
  it.first = DKV && CAUSAL ? it.own0 / R : 0;
  it.last = ((DKV ? a.sq : a.sk) + R - 1) / R;
  if (!DKV && CAUSAL)
    it.last = min(it.last, (it.own0 + O - 1) / R + 1);
  return it;
}

// ------------------------------------------------------------ launching

template <typename Kern, typename... Args>
cudaError_t go(Kern kern, dim3 grid, int threads, size_t smem,
               cudaStream_t stream, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the streaming multiprocessors of the current device, cached per device
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kDevices) cached[dev] = *sms;
  return e;
}

}  // namespace flash_wg
