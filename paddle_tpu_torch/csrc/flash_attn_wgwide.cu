// Flash attention above head_dim 256 in bf16 on Hopper's tensor cores
// (sm_90a): the forward (O and lse) at any head_dim D that is a multiple
// of 256 above it, on the warp-specialised wgmma pipeline of
// flash_wgmma.cuh.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py `_fwd_kernel` (:175) at the
// head_dims the Pallas wrapper pads above 256 (:486-493;
// ops/flash_attention.py's kernel_head_dim pads 257 and up to the next
// multiple of 256), in bf16. The same function as fwd_wide
// (flash_attn_wide.cu, which keeps the f32 forward and both dtypes' dQ
// and dK/dV) and fwd_wg256: the key bound `col < sk`, the query bound
// `row < sq`, the top-left causal rule `row >= col` (k-tiles above a
// warpgroup's rows skipped), masking with -1e30, `l_safe = max(l,
// 1e-30)`, lse = m + log(l_safe) in f32 [b, n, sq] (dq_wide and dkv_wide
// read it); dropout from philox.cuh's keep bits of (seed, b*n + head,
// row, col), which do not depend on D, with the seed read from device
// memory, l summing the un-dropped probabilities and the kept ones
// scaled by 1/(1-p). q, k and v are read as strided [b, s, n, D] views
// through TMA tensor maps, with no copy; O is written contiguous.
//
// What bounds it on an H100. At b 2, s 512, n 4, D 1024 it does 4 b n
// s^2 D = 8.6 GFLOP (0.0087 ms at 989 TFLOP/s) against 4 b s n D x 2
// bytes (33.6 MB, 0.0100 ms at 3.35 TB/s): bound by bytes, nearly
// balanced.
//
// The design. No tile of the whole head_dim fits a CTA (a 128-row Q
// tile is 256 KB at D 1024), and O [64 x D] of a consumer warpgroup does
// not fit its registers above 256. So, as in fwd_wide, the output's
// head_dim is split into 256-wide chunks z: a work item is (batch, head,
// 128-row block, z), and each consumer warpgroup holds O_z [64 x 256]
// in f32, 128 registers a thread, as fwd_wg256 does.
//  * The scores S = sum_c Q_c K_c^T of a 64-key tile run as wgmma_ss
//    over the head_dim's 64-column sub-tiles c: the producer streams
//    (Q_c [128 x 64], K_c [64 x 64]) pairs, 24 KB, through a ring of 6
//    stages, and a consumer warpgroup keeps one sub-tile's 4 products in
//    flight while it releases the stage before. Q is thus read again
//    (from L2) for every key tile, and every chunk's CTA computes the
//    same S (D / 256 times the products of the scores, as fwd_wide).
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
// The cluster form, which would sum the partial scores of the D / 256
// chunk CTAs through distributed shared memory and read Q and K once, is
// not built.

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
constexpr int kQkS = 6, kVS = 2;        // stages of the two rings
// the producer's loop state and a Philox round do not fit the 56
// registers flash_attn_wg256.cu leaves it (ptxas spilled the dropout
// variants); O_z, S and P take about 180 of a consumer's 216
constexpr int kProdRegs = 72, kConsRegs = 216;
// as flash_wgmma.cuh's split: asking for more than the pool holds would
// spin in the allocation forever
static_assert(kProducers * kProdRegs + kConsumers * kConsRegs <=
                  168 * kWgThreads,
              "the warpgroups' registers exceed the CTA's pool");

struct Args {
  void* o;     // O, [b, sq, n, D] contiguous
  float* lse;  // [b, n, sq], written by chunk 0
  int batch, n_heads, sq, sk, nc;  // nc = D / 256 chunks
  float scale;
  DropParams dp;
};

// Shared memory, byte offsets from a 1024-aligned base: ring stage st's
// Q sub-tile [128 lines][128 bytes] at st * kQkStage and its K sub-tile
// [64 lines][128 bytes] after it; V stage vs [kZH halves][64 lines][128
// bytes] at kVAt + vs * kVTile; its keep words (u32 [256]) at kKeep.
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
// its Q and K tiles in L2)
template <bool CAUSAL>
__device__ __forceinline__ Item chunk_item(const Args& a, int item,
                                           int nblk, int* z) {
  *z = item % a.nc;
  return work_item<false, CAUSAL>(a, item / a.nc, nblk);
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
    const Item it = chunk_item<CAUSAL>(a, item, nblk, &z);
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
    const Item it = chunk_item<CAUSAL>(a, item, nblk, &z);
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

// ------------------------------------------------------------ launching

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
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // one CTA per SM, or one per work item when there are fewer
  const long long items =
      (long long)b * n * ((a.sq + kOwn - 1) / kOwn) * a.nc;
  const dim3 grid((unsigned)(items < sms ? items : sms));
  return go(fwd_wgwide<C, P>, grid, kWgThreads, Layout::kBytes, stream, tq,
            tk, tv, a);
}

}  // namespace

// The entry takes the arguments of pt_flash_attn_fwd (flash_attn_fwd.cu)
// and runs only dtype 1 (bfloat16) at d a multiple of 256 above 256;
// ops/flash_attention.py's _kernel_entry sends those here. Strides are
// element strides (batch, seq, head) of [b, s, n, d] tensors whose
// head_dim stride is 1, in the layout the tensor maps describe:
// multiples of 8 elements, and a dimension of size 1 given the stride a
// packed tensor would have. It writes O contiguous [b, sq, n, d] and lse
// f32 [b, n, sq], which flash_attn_wide.cu's dQ and dK/dV entries read.
// dropout != 0 draws the keep bits from the threshold and the 64-bit
// seed at `seed` in device memory (lo, hi; read by the kernel); rinv =
// 1 / (1 - p). Returns 0 on success, a cudaError_t code if a launch or
// a tensor map was refused, or -1 for a dtype / head_dim this file has
// no kernel for.
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
