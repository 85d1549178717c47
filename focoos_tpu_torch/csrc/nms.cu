// Greedy NMS keep mask over score-sorted candidates, batched, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/nms_kernel.py, nms_keep_pallas (pallas_call at
// :59, body _nms_sweep_kernel :22), which the JAX package runs per image under
// jax.vmap from ops/nms.py::topk_nms. Semantics (focoos_tpu/ops/nms.py:21-42,
// IoU as focoos_tpu/ops/boxes.py:26-35): for each image b, with boxes [K, 4]
// xyxy sorted by score descending,
//   keep[i] = score[i] > 0  and  no j < i with keep[j] and IoU(j, i) > thr.
//
// What bounds it on this card: latency. The sweep is K dependent steps (box i
// cannot be decided before every earlier box is); the bytes are negligible
// (K*20 B in, K B out per image) and the K^2 IoUs are a few microseconds of
// CUDA-core work spread over the block.
//
// Design: one block per image. (1) The block loads the K boxes, their areas
// and the validity bits into shared memory. (2) All threads build the K x W
// overlap bitmask (W = ceil(K/32) words a row; bit t of word w of row r is
// IoU(r, 32w+t) > thr, set only for columns after the row), 12 KB at K=300 and
// 128 KB at K=1024. (3) One warp walks the rows: lane l holds word l of the
// "removed" mask (invalid or suppressed boxes), so W <= 32 words cover
// K <= 1024. Box i is kept if its bit is clear after rows 0..i-1, and a kept
// row ORs its mask row into the removed words: one shuffle, one conflict-free
// 128 B shared-memory read (prefetched independently of the chain) and one OR
// a step. The TPU kernel kept the [K, K] matrix and the keep vector in VMEM
// to run the sweep in one launch; the bitmask in shared memory does that job.
//
// Exactness: the keep mask must equal the plain version's bit for bit, and a
// single IoU rounding across the threshold would flip a box. Every product,
// sum and quotient of the IoU is formed with the _rn intrinsics (no FMA
// contraction, IEEE division), in the order torch's box_iou evaluates them:
// area = (x1-x0)*(y1-y0); inter = max(min(r)-max(l), 0) products;
// union = (area_r + area_c) - inter; iou = inter / max(union, 1e-9), with
// NaN propagating through max and min as it does in torch.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxK = 1024;  // MAX_K in focoos_tpu_torch/ops/nms.py
constexpr int kThreads = 512;

size_t smem_bytes(int K) {
  const int W = (K + 31) / 32;
  return (size_t)K * sizeof(float4) + (size_t)K * sizeof(float) + (size_t)K * W * sizeof(uint32_t) +
         32 * sizeof(uint32_t);
}

// max/min that propagate NaN as torch.maximum/minimum/clamp do (fmaxf/fminf
// drop a NaN operand, which would turn a NaN box into an overlap)
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 c, float area_c, float thr) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, c.z), max_nan(a.x, c.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, c.w), max_nan(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_c), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-9f)) > thr;  // a NaN IoU compares false, as in torch
}

__global__ void __launch_bounds__(kThreads) nms_keep_kernel(const float4* __restrict__ boxes,
                                                            const float* __restrict__ scores,
                                                            bool* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32;
  float4* box_s = reinterpret_cast<float4*>(smem);                // [K]
  float* area_s = reinterpret_cast<float*>(box_s + K);             // [K]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(area_s + K);      // [K, W]
  uint32_t* word_s = mask_s + (size_t)K * W;                       // [32]: validity, then removed
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float4* bx = boxes + (size_t)b * K;
  const float* sc = scores + (size_t)b * K;

  // (1) boxes, areas, validity words (a warp covers 32 consecutive boxes)
  for (int i0 = threadIdx.x - lane; i0 < K; i0 += kThreads) {
    const int i = i0 + lane;
    bool valid = false;
    if (i < K) {
      const float4 v = bx[i];
      box_s[i] = v;
      area_s[i] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
      valid = sc[i] > 0.f;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) word_s[i0 >> 5] = bits;
  }
  __syncthreads();

  // (2) overlap bitmask; consecutive threads take consecutive rows of one
  // word, so the column boxes they read are the same address (a broadcast)
  for (int idx = threadIdx.x; idx < K * W; idx += kThreads) {
    const int w = idx / K;
    const int r = idx - w * K;
    const int j0 = w * 32;
    uint32_t bits = 0;
    if (j0 + 31 > r) {
      const float4 a = box_s[r];
      const float area_a = area_s[r];
      const int jn = min(32, K - j0);
      for (int t = max(0, r + 1 - j0); t < jn; ++t) {
        if (overlaps(a, area_a, box_s[j0 + t], area_s[j0 + t], thr)) bits |= 1u << t;
      }
    }
    mask_s[(size_t)r * W + w] = bits;
  }
  __syncthreads();

  // (3) the sequential sweep, one warp
  if (threadIdx.x < 32) {
    uint32_t removed = lane < W ? ~word_s[lane] : 0xffffffffu;
    for (int i = 0; i < K; ++i) {
      const uint32_t row = lane < W ? mask_s[(size_t)i * W + lane] : 0u;
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      if (!((word >> (i & 31)) & 1u)) removed |= row;  // box i kept: suppress its overlaps
    }
    if (lane < W) word_s[lane] = removed;
    __syncwarp();
    for (int i = lane; i < K; i += 32) keep[(size_t)b * K + i] = !((word_s[i >> 5] >> (i & 31)) & 1u);
  }
}

}  // namespace

extern "C" int nms_keep(const void* boxes, const void* scores, void* keep, int B, int K, float thr,
                        void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (per device, so on every such launch)
    const cudaError_t err =
        cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<bool*>(keep), K, thr);
  return (int)cudaGetLastError();
}
