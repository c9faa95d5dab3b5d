// Greedy hard NMS for Hopper (sm_90a): the keep mask of P independent
// problems of K candidates each, already sorted by score (descending).
//
// Replaces no Pallas kernel. The JAX package computes NMS in XLA:
// paddle_tpu/ops/detection.py `_greedy_nms_mask` (:488) is a K-step
// lax.fori_loop over a [K, K] IoU matrix, vmapped over (image, class).
// In torch ops that loop is K dependent steps of several launches each
// over a [P, K, K] IoU matrix (at YOLOv3's serving shape, 8 images x 80
// classes x nms_top_k 400: 400 steps and 410 MB), so the port writes
// the loop as one kernel: ops/nms.py `greedy_nms_mask` launches it,
// and `greedy_nms_mask_plain` there is the same loop batched in torch.
//
// What it computes, candidate by candidate in score order (i = 0..K-1):
// i is kept iff its score is valid (not -inf) and no kept j < i has
// IoU(j, i) > thr; after a kept i, while eta < 1 and thr > 0.5, thr *=
// eta (adaptive NMS, multiclass_nms_op.cc NMSFast). An invalid candidate
// is never kept and never suppresses. The IoU is `_pairwise_iou`'s
// arithmetic (:60-69) in its order, with every float operation a
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn): nvcc would otherwise contract a + b - w*h into an FMA,
// which torch's elementwise kernels never do, and the mask must be bit
// for bit the plain version's. The +1 of `normalized=False` (pixel
// boxes, YOLOv3's predict) is added as `_pairwise_iou` adds it.
//
// Design (simple first). One block of 256 threads per problem. The K
// boxes and their areas go to shared memory once. For each i the
// threads test their strided j < i (j = tid, tid + 256, ...) and
// combine with __syncthreads_or, the one barrier of a step. Every
// thread then knows the outcome, so each updates its own copy of thr
// (identically) and the thread that owns j = i records kept[i]; a
// thread reads kept[] only at its own j, so kept[] needs no barrier of
// its own. A step with an invalid i is skipped by every thread alike.
// K is bounded only by shared memory (22 bytes a candidate; above 48
// KB the launch opts in to more, up to 227 KB, about 10,000).
//
// What bounds it on an H100. The work is P * V * (V - 1) / 2 IoUs for V
// valid candidates a problem, ~14 FP32 operations each (67 TFLOP/s off
// the tensor cores), and the bytes are the boxes and scores read once
// and the mask written once (3.35 TB/s). At P 640, K 400 that is 11
// us of operations and 2 us of bytes. The dependent chain the bound
// leaves out sets the time: V steps, each a barrier and a test of
// ceil(i / 256) pairs a thread, one after the other.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fmax0(float a, float b) {
  return a > b ? a : b;
}
__device__ __forceinline__ float fmin0(float a, float b) {
  return a < b ? a : b;
}

// `_box_area`: max(x2 - x1 + off, 0) * max(y2 - y1 + off, 0)
__device__ __forceinline__ float box_area(float4 b, float off) {
  const float w = fmax0(__fadd_rn(__fsub_rn(b.z, b.x), off), 0.f);
  const float h = fmax0(__fadd_rn(__fsub_rn(b.w, b.y), off), 0.f);
  return __fmul_rn(w, h);
}

// `_pairwise_iou`(a = boxes[j], b = boxes[i])[j, i]
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b, float off) {
  const float ltx = fmax0(a.x, b.x), lty = fmax0(a.y, b.y);
  const float rbx = fmin0(a.z, b.z), rby = fmin0(a.w, b.w);
  const float w = fmax0(__fadd_rn(__fsub_rn(rbx, ltx), off), 0.f);
  const float h = fmax0(__fadd_rn(__fsub_rn(rby, lty), off), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
nms_greedy_kernel(const float4* __restrict__ boxes,
                  const float* __restrict__ scores,
                  uint8_t* __restrict__ keep, int k, float thr0, float eta,
                  float off) {
  extern __shared__ unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sarea + k);
  uint8_t* skept = svalid + k;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) {
    const float4 b = boxes[base + j];
    sbox[j] = b;
    sarea[j] = box_area(b, off);
    svalid[j] = scores[base + j] > -INFINITY;
    skept[j] = 0;
  }
  __syncthreads();
  float thr = thr0;
  const bool decays = eta < 1.f;
  for (int i = 0; i < k; ++i) {
    if (!svalid[i]) continue;   // the same branch in every thread
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    int sup = 0;
    for (int j = tid; j < i && !sup; j += kThreads)
      sup = skept[j] && iou(sbox[j], sarea[j], bi, ai, off) > thr;
    const bool kept = !__syncthreads_or(sup);
    if (tid == i % kThreads) skept[i] = kept;
    if (kept && decays && thr > 0.5f) thr = __fmul_rn(thr, eta);
  }
  for (int j = tid; j < k; j += kThreads) keep[base + j] = skept[j];
}

}  // namespace

// boxes [p, k, 4] f32 and scores [p, k] f32, contiguous, on the card;
// keep [p, k] uint8 out. Returns the launch's cudaError_t (0: launched).
extern "C" int pt_nms_greedy(const void* boxes, const void* scores,
                             void* keep, int p, int k, float iou_threshold,
                             float eta, int normalized, void* stream_ptr) {
  if (p <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (sizeof(float4) +
                                                sizeof(float) + 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  nms_greedy_kernel<<<p, kThreads, smem, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), k, iou_threshold, eta,
      normalized ? 0.f : 1.f);
  return static_cast<int>(cudaGetLastError());
}
