// Greedy NMS keep mask over score-sorted candidates, batched, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/nms_kernel.py, nms_keep_pallas (pallas_call at
// :59, body _nms_sweep_kernel :22), which the JAX package runs per image under
// jax.vmap from ops/nms.py::topk_nms. Semantics (focoos_tpu/ops/nms.py:21-42,
// IoU as focoos_tpu/ops/boxes.py:26-35): for each image b, with boxes [K, 4]
// xyxy sorted by score descending,
//   keep[i] = score[i] > 0  and  no j < i with keep[j] and IoU(j, i) > thr.
//
// What bounds it on this card: latency. The bytes are negligible (K*20 B in,
// K B out per image) and the K(K-1)/2 IoUs are well under a microsecond of
// the card's fp32 rate; but box i cannot be decided before every earlier box
// is, so a launch is a chain of dependent steps, and one block per image left
// 116 of the 132 SMs idle at B=16 (and 131 for a single request).
//
// Design: one thread-block cluster of kCluster blocks per image.
// (1) Load. Every block reads the K boxes into its shared memory with their
//     areas and the validity words (bit i: score[i] > 0).
// (2) Build. The overlap bitmask has K rows of W = ceil(K/32) words; bit t of
//     word l of row r is IoU(r, 32l+t) > thr, set only for columns after the
//     row. Its upper triangle is cut into tiles of kTileRows rows by one word,
//     shared out over every warp of the cluster (8 SMs per image, not 1). In a
//     tile, lane t holds column box 32l+t in registers, each row box is a
//     shared-memory broadcast, and a ballot forms the row's word. Each word is
//     stored straight into rank 0's shared memory through distributed shared
//     memory, so the sweep reads only its own shared memory; a cluster barrier
//     closes the build.
// (3) Sweep, one warp of rank 0, 32 boxes a step (W steps instead of K).
//     Lane l holds word l of "removed" (invalid or suppressed boxes). For
//     word-block w every lane loads the 32 diagonal words (row 32w+t, word w)
//     and the 32 words it may OR (row 32w+t, word l) with 16-byte loads, none
//     of which depends on the chain; it then decides the block's 32 boxes as a
//     chain of register operations on removed[w] (one shuffle a step brings it
//     from lane w), each kept box ORing its word into the lane's accumulator
//     under the same predicate, off the chain.
// (4) Rank 0 writes keep. The TPU kernel kept the [K, K] matrix and the keep
//     vector in VMEM to run the sweep in one launch; rank 0's shared memory
//     does that job here (13 KB at K=300, 129 KB at K=1024).
//
// Exactness: the keep mask must equal the plain version's bit for bit, and a
// single IoU rounding across the threshold would flip a box. Every product,
// sum and quotient of the IoU is formed with the _rn intrinsics (no FMA
// contraction, IEEE division), in the order torch's box_iou evaluates them:
// area = (x1-x0)*(y1-y0); inter = max(min(r)-max(l), 0) products;
// union = (area_r + area_c) - inter; iou = inter / max(union, 1e-9), with NaN
// propagating through max and min as it does in torch (max.NaN / min.NaN).
// Where inter is 0 the IoU is 0, or NaN for a NaN union, so the division is
// skipped: both compare false for thr >= 0, and for thr < 0 the union alone
// tells them apart.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 1024;  // MAX_K in focoos_tpu_torch/ops/nms.py
constexpr int kCluster = 8;  // blocks per image: the portable cluster size
constexpr int kThreads = 512;
constexpr int kTileRows = 8;  // rows of one build tile (a divisor of 32)

// The bitmask is stored by column word: word l of row r at mask[l * S + r],
// with S = 32W + 4. So the 32 words of one word-block that a sweep step reads
// are contiguous (8 16-byte loads), and the lanes' columns start 4 banks apart
// (conflict-free 16-byte loads).
__host__ __device__ __forceinline__ int mask_stride(int W) { return 32 * W + 4; }

// mask_s [W, S] (used in rank 0) | box_s [K] float4 | area_s [K] | word_s [32]
size_t smem_bytes(int K) {
  const int W = (K + 31) / 32;
  return (size_t)W * mask_stride(W) * sizeof(uint32_t) + (size_t)K * (sizeof(float4) + sizeof(float)) +
         32 * sizeof(uint32_t);
}

// max/min that propagate NaN as torch.maximum/minimum/clamp do (fmaxf/fminf
// drop a NaN operand, which would turn a NaN box into an overlap)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// IoU(a, c) > thr, bit for bit as ops/boxes.py::box_iou and the comparison
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 c, float area_c, float thr) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, c.z), max_nan(a.x, c.x)), 0.f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, c.w), max_nan(a.y, c.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_c), inter), 1e-9f);
  if (inter == 0.f) return 0.f > thr && uni == uni;  // IoU 0, or NaN for a NaN union
  return __fdiv_rn(inter, uni) > thr;                 // a NaN IoU compares false, as in torch
}

// Boxes, areas and validity words of one image into shared memory; a warp
// covers 32 consecutive boxes, so its ballot is one validity word.
__device__ __forceinline__ void load_boxes(const float4* __restrict__ bx, const float* __restrict__ sc, int K,
                                           float4* box_s, float* area_s, uint32_t* word_s) {
  const int lane = threadIdx.x & 31;
  for (int i0 = threadIdx.x - lane; i0 < K; i0 += blockDim.x) {
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
}

// One warp: the words of rows r0 .. r0+kTileRows-1 in column word l. Lane t
// tests column 32l+t against each row and a ballot forms the row's word; lane
// i then stores row r0+i's word into mask ([W, S] by column word, any address
// space).
__device__ __forceinline__ void build_tile(const float4* box_s, const float* area_s, int K, int S, int r0, int l,
                                           float thr, uint32_t* mask) {
  const int lane = threadIdx.x & 31;
  const int c = 32 * l + lane;
  const float4 cb = c < K ? box_s[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float ca = c < K ? area_s[c] : 0.f;
  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const int r = r0 + i;
    if (r >= K) break;  // the same for the whole warp
    const bool ov = c < K && c > r && overlaps(box_s[r], area_s[r], cb, ca, thr);
    const uint32_t word = __ballot_sync(0xffffffffu, ov);
    if (lane == i) mine = word;
  }
  if (lane < kTileRows && r0 + lane < K) mask[(size_t)l * S + r0 + lane] = mine;
}

// Tile k of the upper triangle: word pair p = l(l+1)/2 + w (row block w <= column
// word l), quarter q of the row block. Returns false past the last row.
__device__ __forceinline__ bool tile_of(int k, int K, int& r0, int& l) {
  constexpr int kQ = 32 / kTileRows;
  const int p = k / kQ;
  l = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while (l * (l + 1) / 2 > p) --l;
  while ((l + 1) * (l + 2) / 2 <= p) ++l;
  r0 = 32 * (p - l * (l + 1) / 2) + kTileRows * (k % kQ);
  return r0 < K;
}

// Box t of a word-block, with its diagonal word d and the word m this lane
// may OR: when box t is not removed it is kept, so the later boxes of the
// block that it overlaps are removed, and m joins the lane's OR. Bit t of cur
// is final here (only earlier boxes set it), so the decision is exact.
__device__ __forceinline__ void decide(uint32_t& cur, uint32_t (&acc)[4], uint32_t d, uint32_t m, int t) {
  if (!((cur >> t) & 1u)) {
    cur |= d;
    acc[t & 3] |= m;
  }
}

// The greedy sweep by one warp over the bitmask ``mask`` [W, S]; word_s holds
// the validity words on entry and the removed words (not kept) on return.
// Rows past K and the words left of the diagonal are never written: their
// boxes are removed from the start, so their words are never used.
__device__ __forceinline__ void sweep(const uint32_t* mask, uint32_t* word_s, int W, int S) {
  const int lane = threadIdx.x & 31;
  uint32_t removed = lane < W ? ~word_s[lane] : 0xffffffffu;
  const uint32_t* column = mask + (size_t)min(lane, W - 1) * S;  // the words this lane ORs
  for (int w = 0; w < W; ++w) {
    const uint4* dp = reinterpret_cast<const uint4*>(mask + (size_t)w * S + 32 * w);  // a broadcast
    const uint4* mp = reinterpret_cast<const uint4*>(column + 32 * w);
    uint4 d[8], m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = dp[j], m[j] = mp[j];
    uint32_t cur = __shfl_sync(0xffffffffu, removed, w);
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      decide(cur, acc, d[j].x, m[j].x, 4 * j);
      decide(cur, acc, d[j].y, m[j].y, 4 * j + 1);
      decide(cur, acc, d[j].z, m[j].z, 4 * j + 2);
      decide(cur, acc, d[j].w, m[j].w, 4 * j + 3);
    }
    if (lane == w) removed = cur;
    else if (lane > w) removed |= acc[0] | acc[1] | acc[2] | acc[3];
  }
  if (lane < W) word_s[lane] = removed;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nms_keep_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, bool* __restrict__ keep,
                    int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block runs; waited for before the first remote store
  const int W = (K + 31) / 32, S = mask_stride(W);
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem);
  float4* box_s = reinterpret_cast<float4*>(mask_s + (size_t)W * S);
  float* area_s = reinterpret_cast<float*>(box_s + K);
  uint32_t* word_s = reinterpret_cast<uint32_t*>(area_s + K);
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;

  load_boxes(boxes + (size_t)b * K, scores + (size_t)b * K, K, box_s, area_s, word_s);
  __syncthreads();
  cluster_wait();  // every block of the cluster runs: rank 0's shared memory takes stores

  uint32_t* mask0 = cluster.map_shared_rank(mask_s, 0);
  constexpr int kWarps = kThreads / 32;
  const int n_tiles = (32 / kTileRows) * W * (W + 1) / 2;
  for (int k = rank * kWarps + (int)(threadIdx.x >> 5); k < n_tiles; k += kCluster * kWarps) {
    int r0, l;
    if (tile_of(k, K, r0, l)) build_tile(box_s, area_s, K, S, r0, l, thr, mask0);
  }
  cluster.sync();  // the bitmask is complete in rank 0's shared memory
  if (rank != 0) return;

  if (threadIdx.x < 32) sweep(mask_s, word_s, W, S);
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += kThreads) keep[(size_t)b * K + i] = !((word_s[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

extern "C" int nms_keep(const void* boxes, const void* scores, void* keep, int B, int K, float thr,
                        void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || B > (1 << 24)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (per device, so on every such launch)
    const cudaError_t err =
        cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_kernel<<<B * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<bool*>(keep), K, thr);
  return (int)cudaGetLastError();
}
