// Fused ResNet-D deep stem, inference, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/stem.py, fused_resnet_stem (pallas_call at
// :224, body _stem_kernel :72). In one launch, NHWC in and NHWC out:
//   y1 = relu(conv3x3_s2(x,  W1) * s1 + a1)   3 -> 32, H x W -> H1 x W1 (ceil(H/2))
//   y2 = relu(conv3x3_s1(y1, W2) * s2 + a2)   32 -> 32
//   y3 = relu(conv3x3_s1(y2, W3) * s3 + a3)   32 -> 64
//   out = maxpool3x3_s2_p1(y3), padded with -inf      -> ceil(H1/2) x ceil(W1/2)
// (s_i, a_i) is the eval BatchNorm folded per channel. Weights are HWIO
// [3, 3, Cin, Cout] fp32, the JAX package's layout.
//
// What bounds it on this card: arithmetic. The three convs are ~5.9 GFLOP per
// 640x640 image against ~1.2 MB of input and 1.6 MB of output, far above the
// card's ridge point. This kernel runs them on the fp32 CUDA cores, so it is
// expected to be slower than cuDNN's tensor-core convs; it stays on the path
// and both times are recorded (PERF.md).
//
// Design: one block owns an 8x8 tile of pooled outputs for all 64 channels.
// It stages the 43x43x3 input window in shared memory, then computes the
// halo'd intermediates y1 (21x21x32), y2 (19x19x32) and y3 (17x17x64) into
// shared memory, planar (channel-major), so that the lanes of a warp, which
// walk neighbouring pixels, read neighbouring words without bank conflicts.
// That is 194 KB of dynamic shared memory, under the 227 KB a block may opt
// into, and nothing between the input read and the output write touches
// device memory. Each thread computes 8 output channels of one pixel; the
// weights for those 8 channels are contiguous in HWIO and are read as two
// float4 loads that every lane of the warp shares (an L1 broadcast). Pixels
// outside the image are zero in y1/y2 (the convs' zero padding) and -inf in
// y3 (the pool's padding), so any H and W work. The TPU kernel's banded
// Toeplitz matmuls and row-parity DMA planes served the MXU and VMEM; they
// have no counterpart here.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 8;                // pooled outputs per block side
constexpr int kR3 = 2 * kTile + 1;      // y3 rows/cols a tile needs
constexpr int kR2 = kR3 + 2;            // y2
constexpr int kR1 = kR2 + 2;            // y1
constexpr int kRin = 2 * kR1 + 1;       // input window
constexpr int kCin = 3, kC1 = 32, kC2 = 32, kC3 = 64;
constexpr int kOct = 8;                 // output channels per thread
constexpr int kThreads = 256;
constexpr int kSmemFloats = kCin * kRin * kRin + kC1 * kR1 * kR1 + kC2 * kR2 * kR2 + kC3 * kR3 * kR3;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

// conv3x3 (pad 1) + folded BN + ReLU from one planar smem buffer into another.
// `in` is [CI][RIN][RIN]; `outs` is [CO][RO][RO]; output local (r, c) is the
// global position (gy0 + r, gx0 + c) of a Hc x Wc map and reads input local
// rows r*STRIDE + kh and columns c*STRIDE + kw.
template <int CI, int CO, int RIN, int RO, int STRIDE>
__device__ __forceinline__ void conv_stage(const float* in, const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, float* outs, int gy0,
                                           int gx0, int Hc, int Wc, float outside) {
  constexpr int kPix = RO * RO;
  constexpr int kGroups = CO / kOct;
  for (int item = threadIdx.x; item < kPix * kGroups; item += kThreads) {
    const int pix = item % kPix;
    const int g = item / kPix;
    const int r = pix / RO, c = pix % RO;
    const int gy = gy0 + r, gx = gx0 + c;
    float* o = outs + g * kOct * kPix + pix;
    if (gy < 0 || gy >= Hc || gx < 0 || gx >= Wc) {
#pragma unroll
      for (int j = 0; j < kOct; ++j) o[j * kPix] = outside;
      continue;
    }
    float acc[kOct];
#pragma unroll
    for (int j = 0; j < kOct; ++j) acc[j] = 0.f;
    for (int ci = 0; ci < CI; ++ci) {
      const float* ip = in + (ci * RIN + r * STRIDE) * RIN + c * STRIDE;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float v = ip[kh * RIN + kw];
          const float4* wp =
              reinterpret_cast<const float4*>(w + ((kh * 3 + kw) * CI + ci) * CO + g * kOct);
          const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
          acc[0] = fmaf(v, w0.x, acc[0]);
          acc[1] = fmaf(v, w0.y, acc[1]);
          acc[2] = fmaf(v, w0.z, acc[2]);
          acc[3] = fmaf(v, w0.w, acc[3]);
          acc[4] = fmaf(v, w1.x, acc[4]);
          acc[5] = fmaf(v, w1.y, acc[5]);
          acc[6] = fmaf(v, w1.z, acc[6]);
          acc[7] = fmaf(v, w1.w, acc[7]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kOct; ++j) {
      const int oc = g * kOct + j;
      o[j * kPix] = fmaxf(fmaf(acc[j], __ldg(scale + oc), __ldg(bias + oc)), 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) stem_kernel(
    const T* __restrict__ x,  // [B, H, W, 3]
    const float* __restrict__ w1, const float* __restrict__ s1, const float* __restrict__ a1,
    const float* __restrict__ w2, const float* __restrict__ s2, const float* __restrict__ a2,
    const float* __restrict__ w3, const float* __restrict__ s3, const float* __restrict__ a3,
    T* __restrict__ out,  // [B, H4, W4, 64]
    int H, int W, int H1, int W1, int H4, int W4) {
  extern __shared__ float smem[];
  float* xs = smem;                       // [3][kRin][kRin]
  float* y1 = xs + kCin * kRin * kRin;    // [32][kR1][kR1]
  float* y2 = y1 + kC1 * kR1 * kR1;       // [32][kR2][kR2]
  float* y3 = y2 + kC2 * kR2 * kR2;       // [64][kR3][kR3]

  const int b = blockIdx.z;
  const int py0 = blockIdx.y * kTile, px0 = blockIdx.x * kTile;
  // pooled row p reads y3 rows 2p-1..2p+1; each conv adds one row of halo and
  // conv1 doubles the extent: the input window starts at 4*py0 - 7
  const int iy0 = 4 * py0 - 7, ix0 = 4 * px0 - 7;
  const T* xb = x + (size_t)b * H * W * kCin;
  for (int i = threadIdx.x; i < kRin * kRin * kCin; i += kThreads) {
    const int ch = i % kCin;
    const int t = i / kCin;
    const int cx = t % kRin, ry = t / kRin;
    const int gy = iy0 + ry, gx = ix0 + cx;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = focoos::load_f32(xb + ((size_t)gy * W + gx) * kCin + ch);
    xs[(ch * kRin + ry) * kRin + cx] = v;
  }
  __syncthreads();
  conv_stage<kCin, kC1, kRin, kR1, 2>(xs, w1, s1, a1, y1, 2 * py0 - 3, 2 * px0 - 3, H1, W1, 0.f);
  __syncthreads();
  conv_stage<kC1, kC2, kR1, kR2, 1>(y1, w2, s2, a2, y2, 2 * py0 - 2, 2 * px0 - 2, H1, W1, 0.f);
  __syncthreads();
  conv_stage<kC2, kC3, kR2, kR3, 1>(y2, w3, s3, a3, y3, 2 * py0 - 1, 2 * px0 - 1, H1, W1, -INFINITY);
  __syncthreads();
  // maxpool 3x3 s2: pooled local (p, q) reads y3 local rows 2p..2p+2
  for (int i = threadIdx.x; i < kTile * kTile * kC3; i += kThreads) {
    const int oc = i % kC3;
    const int t = i / kC3;
    const int q = t % kTile, p = t / kTile;
    const int gy = py0 + p, gx = px0 + q;
    if (gy >= H4 || gx >= W4) continue;
    const float* base = y3 + (oc * kR3 + 2 * p) * kR3 + 2 * q;
    float m = -INFINITY;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) m = fmaxf(m, base[kh * kR3 + kw]);
    focoos::store_f32(out + (((size_t)b * H4 + gy) * W4 + gx) * kC3 + oc, m);
  }
}

template <typename T>
int launch(const void* x, const float* const* p, void* out, int B, int H, int W, cudaStream_t st) {
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;  // conv3x3 s2 p1
  const int H4 = (H1 + 1) / 2, W4 = (W1 + 1) / 2;  // maxpool3x3 s2 p1
  cudaError_t err = cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W4 + kTile - 1) / kTile, (H4 + kTile - 1) / kTile, B);
  stem_kernel<T><<<grid, kThreads, kSmemBytes, st>>>(static_cast<const T*>(x), p[0], p[1], p[2],
                                                     p[3], p[4], p[5], p[6], p[7], p[8],
                                                     static_cast<T*>(out), H, W, H1, W1, H4, W4);
  return (int)cudaGetLastError();
}

}  // namespace

// w_i are HWIO [3, 3, Cin, Cout] fp32, (s_i, a_i) the folded BN [Cout] fp32
extern "C" int fused_resnet_stem(const void* x, const void* w1, const void* s1, const void* a1,
                                 const void* w2, const void* s2, const void* a2, const void* w3,
                                 const void* s3, const void* a3, void* out, int B, int H, int W,
                                 int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const float* p[9] = {
      static_cast<const float*>(w1), static_cast<const float*>(s1), static_cast<const float*>(a1),
      static_cast<const float*>(w2), static_cast<const float*>(s2), static_cast<const float*>(a2),
      static_cast<const float*>(w3), static_cast<const float*>(s3), static_cast<const float*>(a3)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == focoos::kFloat32) return launch<float>(x, p, out, B, H, W, st);
  if (dtype == focoos::kBFloat16) return launch<__nv_bfloat16>(x, p, out, B, H, W, st);
  return (int)cudaErrorInvalidValue;
}
