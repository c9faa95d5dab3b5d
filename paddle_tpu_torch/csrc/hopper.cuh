// Hopper (sm_90a) building blocks of the warp-specialised kernels: TMA
// tensor maps and loads, mbarriers, wgmma descriptors and the
// m64n64k16 and m64n32k16 bf16 products, setmaxnreg.
//
// Shared-memory tiles are written by TMA with 128-byte swizzling: a tile
// of R rows x 64 bf16 is R lines of 128 bytes, and the 16-byte chunk c of
// line r sits at chunk c ^ (r % 8). Every tile starts on 1024 bytes, so
// the swizzle pattern is anchored where the wgmma descriptors expect it.
// A head_dim of 128 is two such tiles side by side ("halves").

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// expect `bytes` more of TMA traffic in this phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; a barrier that
// stays unfinished for 2^24 tries (seconds) traps, so a broken pipeline
// fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      ".reg .u32 N1;\n"
      "mov.u32 N1, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "add.u32 N1, N1, 1;\n"
      "setp.lt.u32 P1, N1, 16777216;\n"
      "@P1 bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// ------------------------------------------------------------------ TMA

// box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -------------------------------------------------------------- setmaxnreg

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr`. Both offsets are 1024 bytes: the stride between groups of 8
// lines, whichever of the two fields the operand's major mode reads it
// from (the other one is not used by the m64n64k16 and m64n32k16
// products here).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t kOff = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kOff << 16) | (kOff << 32) |
         (1ull << 62);
}

// 2^x, one MUFU.EX2 (flushes subnormals to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator (of N
// registers) across the asynchronous product that owns it
template <int N = 32>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define PT_WG_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define PT_WG_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define PT_WG_OUT32(d)                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),   \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),          \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),      \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),      \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),      \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),      \
      "=f"(d[31])

// d = A B^T (ACC: d += A B^T) over k16, A [64 x 16] and B [64 x 16]
// both K-major in shared memory. Accumulator slot i of a thread (warp w
// of the warpgroup, lane = 4 g + t) is row 16 w + g + 8 ((i % 4) / 2),
// column 8 (i / 4) + 2 t + i % 2. The first product of a sum takes
// ACC = false: d is then an output only, so no earlier value of d has
// to be kept (or moved into place) for it, which would make ptxas
// serialise the kernel's wgmma.
template <bool ACC>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da,
                                         uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WG_REGS32
        ", %32, %33, 1, 1, 1, 0, 0;\n"
        "}\n"
        : PT_WG_ACC32(d)
        : "l"(da), "l"(db));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WG_REGS32
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : PT_WG_OUT32(d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// d = A B^T (ACC: d += A B^T) over k16, A [64 x 16] bf16 in registers
// (the fragment layout of wgmma_rs_t below), B [64 x 16] K-major in
// shared memory as in wgmma_ss; ACC = false as there
template <bool ACC>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WG_REGS32
        ", {%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
        "}\n"
        : PT_WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WG_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : PT_WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
  }
}

// d += A B over k16, A [64 x 16] bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows: a0 (g, 2t..), a1 (g+8, 2t..), a2 (g,
// 2t+8..), a3 (g+8, 2t+8..)), B [16 x 64] MN-major in shared memory:
// 16 lines of 64 contiguous n-values
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : PT_WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define PT_WG_ACC16(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define PT_WG_OUT16(d)                                                      \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),   \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),          \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])

#define PT_WG_REGS16                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// wgmma_ss at N = 32 (m64n32k16): d = A B^T (ACC: d += A B^T), A [64 x
// 16] and B [32 x 16] both K-major in shared memory; slot i of a thread's
// 16 is row 16 w + g + 8 ((i % 4) / 2), column 8 (i / 4) + 2 t + i % 2
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db) {
  if constexpr (ACC) {
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PT_WG_REGS16
        ", %16, %17, 1, 1, 1, 0, 0;\n"
        "}\n"
        : PT_WG_ACC16(d)
        : "l"(da), "l"(db));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PT_WG_REGS16
        ", %16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : PT_WG_OUT16(d)
        : "l"(da), "l"(db), "r"(0));
  }
}

#undef PT_WG_REGS16
#undef PT_WG_OUT16
#undef PT_WG_ACC16
#undef PT_WG_REGS32
#undef PT_WG_OUT32
#undef PT_WG_ACC32

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a bf16 [b, s, n, d] tensor read through element strides
// (sb, ss, sn; d contiguous), whose boxes are `rows` sequence rows x 64
// columns of one (batch, head), 128-byte swizzled. Rows past s read as
// zeros. Returns 0, or nonzero when the driver refuses the layout.
inline int bf16_rows_map(CUtensorMap* map, const void* base, int b, int s,
                         int n, int d, long long sb, long long ss,
                         long long sn, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 1;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)r;
}

}  // namespace hopper
