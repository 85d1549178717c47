// The two-launch alternative to focoos_tpu_torch/csrc/nms.cu, for timing it
// against the cluster design (tools/torch_nms_ab.py builds it with
// -I focoos_tpu_torch/csrc). The same IoU, tiles and sweep, arranged as:
// (1) a build kernel of B x ceil(K/32) blocks, block (w, b) writing the words
//     of row block w (32 rows, column words l >= w) into a global
//     [B, W, 32W+4] scratch (207 KB at B=16, K=300: it stays in the 50 MB L2);
// (2) a sweep kernel, one block per image: the block copies the image's
//     bitmask into shared memory and one warp sweeps it.
// Keep masks are those of nms_keep; the exported function takes the scratch
// (B * W * (32W+4) words, 16-byte aligned).
#include "nms.cu"

namespace {

constexpr int kBuildThreads = 256;

// box_s [K] float4 | area_s [K] | word_s [32]
size_t build_smem_bytes(int K) { return (size_t)K * (sizeof(float4) + sizeof(float)) + 32 * sizeof(uint32_t); }

__global__ void __launch_bounds__(kBuildThreads)
    nms_build_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, uint32_t* __restrict__ mask,
                     int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32, S = mask_stride(W);
  const int w = blockIdx.x, b = blockIdx.y;
  float4* box_s = reinterpret_cast<float4*>(smem);
  float* area_s = reinterpret_cast<float*>(box_s + K);
  uint32_t* word_s = reinterpret_cast<uint32_t*>(area_s + K);
  load_boxes(boxes + (size_t)b * K, scores + (size_t)b * K, K, box_s, area_s, word_s);
  __syncthreads();
  constexpr int kQ = 32 / kTileRows;
  const int n_tiles = kQ * (W - w);
  for (int k = threadIdx.x >> 5; k < n_tiles; k += kBuildThreads / 32) {
    const int r0 = 32 * w + kTileRows * (k % kQ);
    if (r0 < K) build_tile(box_s, area_s, K, S, r0, w + k / kQ, thr, mask + (size_t)b * W * S);
  }
}

// mask_s [W, S] | word_s [32]
__global__ void __launch_bounds__(kThreads)
    nms_sweep_kernel(const float* __restrict__ scores, const uint4* __restrict__ mask, bool* __restrict__ keep,
                     int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32, S = mask_stride(W);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  uint4* mask_s = reinterpret_cast<uint4*>(smem);
  uint32_t* word_s = reinterpret_cast<uint32_t*>(mask_s + W * S / 4);
  const float* sc = scores + (size_t)b * K;
  for (int i0 = threadIdx.x - lane; i0 < K; i0 += kThreads) {
    const uint32_t bits = __ballot_sync(0xffffffffu, i0 + lane < K && sc[i0 + lane] > 0.f);
    if (lane == 0) word_s[i0 >> 5] = bits;
  }
  const uint4* src = mask + (size_t)b * W * S / 4;
  for (int i = threadIdx.x; i < W * S / 4; i += kThreads) mask_s[i] = src[i];
  __syncthreads();
  if (threadIdx.x < 32) sweep(reinterpret_cast<const uint32_t*>(mask_s), word_s, W, S);
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += kThreads) keep[(size_t)b * K + i] = !((word_s[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

extern "C" int nms_keep_two_pass(const void* boxes, const void* scores, void* keep, void* mask, int B, int K,
                                 float thr, void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int W = (K + 31) / 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_build_kernel<<<dim3(W, B), kBuildThreads, build_smem_bytes(K), s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<uint32_t*>(mask), K, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)W * mask_stride(W) * sizeof(uint32_t) + 32 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_sweep_kernel<<<B, kThreads, smem, s>>>(static_cast<const float*>(scores), static_cast<const uint4*>(mask),
                                            static_cast<bool*>(keep), K);
  return (int)cudaGetLastError();
}
