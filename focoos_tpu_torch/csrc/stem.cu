// Fused ResNet-D deep stem, inference, on Hopper's tensor cores (sm_90a).
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
// What bounds it on this card: arithmetic. The convs are 5.84 GFLOP per
// 640x640 image (conv2 1.89, conv3 3.77: 97%) against 4.9 MB of input and
// 6.6 MB of output in fp32, far above the ridge point; no design of the stem
// is bound by memory. The plain version it is held against runs cuDNN with
// TF32 off, so on the fp32 CUDA cores too: an earlier version of this kernel
// lost to it (10.2 vs 6.4 ms at B=16) on efficiency, not on the units it ran
// on (FFMA with a shared-memory load and two weight loads per 8 FMAs, 194 KB
// of shared memory for one block of 8 warps per SM, ragged item loops).
//
// Design. All three convs are implicit GEMMs on the tensor cores, written
// here as mma.sync.m16n8k16 (bf16 operands, fp32 accumulators): M = the
// tile's pixels flattened row-major, N = Cout, K = 9 * Cin ordered
// (kh, kw, ci). For conv2 and conv3 (K = 288) a k16 step is one tap and half
// the input channels, and both operands come from shared memory by ldmatrix.
// conv1 (K = 27, padded to 32) gathers its A fragments from the fp32 input
// window. Precision:
//   - f32 input: every operand is split as a = hi + lo, hi = bf16_rn(a),
//     lo = bf16_rn(a - hi), where it is staged (weights once per block, y1
//     and y2 in the epilogue that writes them, x as conv1 gathers it), and
//     each product is hi*hi + hi*lo + lo*hi: three MMAs, ~16 bits of each
//     operand, an error near 1e-5 x max|ref| over the three chained convs
//     (single-pass TF32 would be near 3e-4).
//   - bf16 input: one MMA on bf16 weights for conv2 and conv3, y1 and y2
//     rounded to bf16 in shared memory, as the Pallas kernel does; conv1 keeps
//     split weights (x is exact in bf16); the output is rounded once.
// Tiling: a block owns an 8x8 tile of pooled outputs and all 64 channels:
// the 43x43x3 input window (fp32), y1 21x21, y2 19x19 (bf16 planes, NHWC, a
// pixel is 64 B = four 16 B chunks XOR-swizzled by pixel so that an ldmatrix
// of 8 consecutive pixels is free of bank conflicts), y3 17x17x64 in x's
// dtype for the pool. Dead buffers are reused: y2 takes the input window's
// place, y3 that of the input window and y1. Blocks are persistent: each
// stages the weights once, transposed to [n][k] (k contiguous, an odd number
// of 16 B chunks per row: ldmatrix conflict-free), and walks tiles; the next
// tile's input window is loaded into registers while the pool runs. Shared
// memory is 216 KB in f32 and 111 KB in bf16, one block of 8 warps per SM
// (two bf16 blocks would cap a thread at 128 registers; conv3's
// accumulators alone take 80, and that build spilled). Warp
// w owns 32 output channels and every (8/NB)-th m16 fragment, so it loads its
// B fragments once per k step for all its fragments, and keeps the
// accumulators in registers across the barrier after conv3's main loop. BN
// and ReLU are applied on the accumulators; out-of-image pixels are zero in
// y1/y2 (the convs' padding) and -inf in y3 (the pool's), so any H and W
// work. The pool reads 16 B vectors and stores NHWC 16 B at a time. The TPU
// kernel's block-Toeplitz bands and row-parity DMA planes served the MXU and
// VMEM; they have no counterpart here.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 8;             // pooled outputs per tile side
constexpr int kR3 = 2 * kTile + 1;   // y3 rows/cols a tile needs
constexpr int kR2 = kR3 + 2;         // y2
constexpr int kR1 = kR2 + 2;         // y1
constexpr int kRin = 2 * kR1 + 1;    // input window
constexpr int kP3 = kR3 * kR3, kP2 = kR2 * kR2, kP1 = kR1 * kR1;
constexpr int kCin = 3, kC1 = 32, kC3 = 64;
constexpr int kIn = kRin * kRin * kCin;  // input window values
constexpr int kK1 = 9 * kCin, kK1P = 32;  // conv1's GEMM depth, padded to two k16 steps
constexpr int kK = 9 * kC1;               // conv2's and conv3's
constexpr int kKS1 = kK1P + 8, kKS = kK + 8;  // weight row strides in bf16: 5 and 37 chunks of 16 B
constexpr int kPix = kC1 * 2;        // bytes of one y1/y2 pixel: 32 bf16
constexpr int kY3S = kC3 + 8;        // y3 pixel stride in elements
constexpr int kThreads = 256, kWarps = kThreads / 32;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory in bytes: [W1 planes][W2 planes][W3 planes][A: input window | y2 planes]
// [B: y1 planes], y3 over A and B once conv3's main loop is done. A plane set is hi (and lo
// when split); W1 is always split.
template <bool kSplit>
struct Layout {
  static constexpr int kPlanes = kSplit ? 2 : 1;
  static constexpr int kW1 = kC1 * kKS1 * 2, kW2 = kC1 * kKS * 2, kW3 = kC3 * kKS * 2;  // one plane each
  static constexpr int kY1 = kP1 * kPix, kY2 = kP2 * kPix;
  static constexpr int kA = cmax(kIn * 4, kPlanes * kY2);
  static constexpr int oW1 = 0, oW2 = 2 * kW1, oW3 = oW2 + kPlanes * kW2, oA = oW3 + kPlanes * kW3;
  static constexpr int oB = oA + kA, kBytes = oB + kPlanes * kY1;
};

// byte offset of 16 B chunk `ch` (channels 8ch..8ch+7) of pixel p in a y1/y2 plane
__device__ __forceinline__ int act_off(int p, int ch) { return p * kPix + ((ch ^ ((p >> 1) & 3)) << 4); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// (a, b) -> bf16x2 hi = rn(a, b) and lo = rn((a, b) - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, a: m16 x k16 row-major, b: k16 x n8, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
      " {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// this lane's ldmatrix row of a [n][KS] weight plane, channels nb*32..nb*32+31: matrices
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), then n + 16
template <int KS>
__device__ __forceinline__ uint32_t b_lane(uint32_t plane, int nb, int lane) {
  return plane + ((nb * 32 + ((lane >> 4) << 3) + (lane & 7)) * KS + ((lane >> 3) & 1) * 8) * 2;
}

// B fragments of the four n8 blocks of one k16 step
template <int KS>
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2], uint32_t addr) {
  uint32_t r[4], s[4];
  ldsm_x4(r, addr);
  ldsm_x4(s, addr + 16 * KS * 2);
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
  b[2][0] = s[0], b[2][1] = s[1], b[3][0] = s[2], b[3][1] = s[3];
}

// w [K][N] fp32 (HWIO flattened) -> [n][KS] bf16 hi plane, then the lo plane when split;
// k in [K, KP) is zero
template <int N, int K, int KP, int KS, bool kSplit>
__device__ void stage_weights(const float* __restrict__ w, char* dst) {
  __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(dst);
  __nv_bfloat16* lo = hi + N * KS;
  for (int i = threadIdx.x; i < KP * N; i += kThreads) {
    const int n = i % N, k = i / N;
    const float v = k < K ? __ldg(w + i) : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[n * KS + k] = h;
    if (kSplit) lo[n * KS + k] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

// channels n, n+1 of pixel o into a y1/y2 plane set
template <bool kSplit, int kPlane>
__device__ __forceinline__ void store_act(char* planes, int o, int n, float v0, float v1) {
  const int off = act_off(o, n >> 3) + (n & 7) * 2;
  uint32_t hi, lo;
  split2(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(planes + off) = hi;
  if (kSplit) *reinterpret_cast<uint32_t*>(planes + kPlane + off) = lo;
}

// The accumulators of one conv over the P output pixels of an RO-wide region (flattened
// row-major) and N channels. Warp w owns channels nb*32..nb*32+31 (nb = w % NB) and the m16
// fragments w/NB + f*(kWarps/NB); acc[f][j] holds n8 block j. A warp with fewer fragments
// repeats its last one in the main loop, so the loop has no branch, and does not store it.
template <int RO, int P, int N>
struct Acc {
  static constexpr int kNB = N / 32, kWPN = kWarps / kNB, kMF = (P + 15) / 16;
  static constexpr int kFPW = (kMF + kWPN - 1) / kWPN;
  float acc[kFPW][4][4];

  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int f = 0; f < kFPW; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;
  }
  static __device__ __forceinline__ int nb() { return (threadIdx.x >> 5) % kNB; }
  static __device__ __forceinline__ int frag(int f) { return (threadIdx.x >> 5) / kNB + f * kWPN; }
  // this lane's ldmatrix row of fragment f: output pixel (clamped)
  static __device__ __forceinline__ int a_row(int f) { return min(min(frag(f), kMF - 1) * 16 + (threadIdx.x & 15), P - 1); }

  // BN + ReLU on the accumulators c of fragment mf; store(o, n, v0, v1, inside) gets
  // channels n, n+1 of output pixel o, and whether it lies in the Hc x Wc map
  template <class Store>
  static __device__ __forceinline__ void epilogue(const float (&c)[4][4], int mf, const float* __restrict__ scale,
                                                  const float* __restrict__ bias, int gy0, int gx0, int Hc, int Wc,
                                                  Store store) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb() * 32 + j * 8 + 2 * (lane & 3);
      const float s0 = __ldg(scale + n), s1 = __ldg(scale + n + 1);
      const float a0 = __ldg(bias + n), a1 = __ldg(bias + n + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = mf * 16 + (lane >> 2) + 8 * hh;
        if (o >= P) continue;
        const int gy = gy0 + o / RO, gx = gx0 + o % RO;
        const bool inside = gy >= 0 && gy < Hc && gx >= 0 && gx < Wc;
        store(o, n, fmaxf(fmaf(c[j][2 * hh], s0, a0), 0.f), fmaxf(fmaf(c[j][2 * hh + 1], s1, a1), 0.f), inside);
      }
    }
  }
  template <class Store>
  __device__ __forceinline__ void epilogue(const float* __restrict__ scale, const float* __restrict__ bias, int gy0,
                                           int gx0, int Hc, int Wc, Store store) const {
#pragma unroll
    for (int f = 0; f < kFPW; ++f)
      if (frag(f) < kMF) epilogue(acc[f], frag(f), scale, bias, gy0, gx0, Hc, Wc, store);
  }
};

// conv1, 3 -> 32, stride 2, K = 27 padded to 32: A gathered from the fp32 input window
// ([kRin * kRin][3]; y1 local (r, c) reads window (2r + kh, 2c + kw)), split when kSplit
// (a bf16 input is exact in bf16); B split in both modes. y1 does not overlap the window,
// so each fragment goes to the epilogue as soon as it is done: one accumulator tile live.
template <bool kSplit, class Store>
__device__ __forceinline__ void conv1(const float* xs, uint32_t w, const float* __restrict__ scale,
                                      const float* __restrict__ bias, int gy0, int gx0, int Hc, int Wc, Store store) {
  using A = Acc<kR1, kP1, kC1>;
  const int lane = threadIdx.x & 31;
  // this lane's A columns k = 16s + 2q + {0, 1, 8, 9} as window offsets; -1 is padding
  int ko[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * s + 2 * (lane & 3) + (e & 1) + (e >> 1) * 8;
      ko[s][e] = k < kK1 ? ((k / 9) * kRin + (k / 3) % 3) * kCin + k % 3 : -1;
    }
  uint32_t bh[2][4][2], bl[2][4][2];
  const uint32_t wl = b_lane<kKS1>(w, 0, lane);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    load_b<kKS1>(bh[s], wl + s * 32);
    load_b<kKS1>(bl[s], wl + kC1 * kKS1 * 2 + s * 32);
  }
#pragma unroll 1
  for (int f = 0; f < A::kFPW && A::frag(f) < A::kMF; ++f) {
    const int mf = A::frag(f);
    float acc[4][4] = {};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // rows g and g + 8 of the fragment (A's row is lane / 4 here, not ldmatrix's)
      float v[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = min(mf * 16 + (lane >> 2) + 8 * hh, kP1 - 1);
        const float* px = xs + (2 * (o / kR1) * kRin + 2 * (o % kR1)) * kCin;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[hh][e] = ko[s][e] >= 0 ? px[ko[s][e]] : 0.f;
      }
      uint32_t a[4], al[4];
      split2(v[0][0], v[0][1], a[0], al[0]);
      split2(v[1][0], v[1][1], a[1], al[1]);
      split2(v[0][2], v[0][3], a[2], al[2]);
      split2(v[1][2], v[1][3], a[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kSplit) mma(acc[j], al, bh[s][j]);
        mma(acc[j], a, bl[s][j]);
        mma(acc[j], a, bh[s][j]);
      }
    }
    A::epilogue(acc, mf, scale, bias, gy0, gx0, Hc, Wc, store);
  }
}

// conv3x3 s1 (pad 1) from a 32-channel plane set of an RI-wide region (RI = RO + 2); a k16
// step is one tap and 16 input channels
template <int RI, int RO, int P, int N, bool kSplit>
__device__ __forceinline__ void conv_mma(Acc<RO, P, N>& t, uint32_t act, uint32_t w) {
  using A = Acc<RO, P, N>;
  constexpr int kActPlane = RI * RI * kPix, kWPlane = N * kKS * 2;
  const int lane = threadIdx.x & 31;
  int pin[A::kFPW];  // this lane's A row: input pixel at tap (0, 0)
#pragma unroll
  for (int f = 0; f < A::kFPW; ++f) pin[f] = (A::a_row(f) / RO) * RI + A::a_row(f) % RO;
  const uint32_t wl = b_lane<kKS>(w, A::nb(), lane);
#pragma unroll 1
  for (int ks = 0; ks < kK / 16; ++ks) {  // tap ks / 2, input channels 16 (ks % 2) ..
    const int doff = (ks / 6) * RI + (ks / 2) % 3;
    uint32_t b[4][2], bl[4][2];
    load_b<kKS>(b, wl + ks * 32);
    if (kSplit) load_b<kKS>(bl, wl + kWPlane + ks * 32);
#pragma unroll
    for (int f = 0; f < A::kFPW; ++f) {
      // matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15)
      const uint32_t aa = act + act_off(pin[f] + doff, 2 * (ks & 1) + (lane >> 4));
      uint32_t a[4], al[4];
      ldsm_x4(a, aa);
      if (kSplit) ldsm_x4(al, aa + kActPlane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kSplit) {
          mma(t.acc[f][j], al, b[j]);
          mma(t.acc[f][j], a, bl[j]);
        }
        mma(t.acc[f][j], a, b[j]);
      }
    }
  }
}

template <typename T>
struct Out;
template <>
struct Out<float> {
  static __device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
  static __device__ __forceinline__ uint4 vmax(uint4 x, uint4 y) {
    const float4 a = *reinterpret_cast<float4*>(&x), b = *reinterpret_cast<float4*>(&y);
    const float4 m = make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
    return *reinterpret_cast<const uint4*>(&m);
  }
};
template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ uint4 vmax(uint4 x, uint4 y) {
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&x);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __hmax2(a[i], b[i]);
    return x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) stem_kernel(
    const T* __restrict__ x,  // [B, H, W, 3]
    const float* __restrict__ w1, const float* __restrict__ s1, const float* __restrict__ a1,
    const float* __restrict__ w2, const float* __restrict__ s2, const float* __restrict__ a2,
    const float* __restrict__ w3, const float* __restrict__ s3, const float* __restrict__ a3,
    T* __restrict__ out,  // [B, H4, W4, 64]
    int B, int H, int W, int H1, int W1, int H4, int W4) {
  constexpr bool kSplit = sizeof(T) == 4;
  using L = Layout<kSplit>;
  extern __shared__ __align__(16) unsigned char smem[];
  char* const sm = reinterpret_cast<char*>(smem);
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // once per block; the first barrier in the loop covers them
  stage_weights<kC1, kK1, kK1P, kKS1, true>(w1, sm + L::oW1);
  stage_weights<kC1, kK, kK, kKS, kSplit>(w2, sm + L::oW2);
  stage_weights<kC3, kK, kK, kKS, kSplit>(w3, sm + L::oW3);

  const int tiles_x = (W4 + kTile - 1) / kTile, tiles_y = (H4 + kTile - 1) / kTile;
  const int ntiles = B * tiles_y * tiles_x;
  // the input window of a tile: pooled row p reads y3 rows 2p-1..2p+1; each conv adds one
  // row of halo and conv1 doubles the extent, so the window starts at 4*py0 - 7
  constexpr int kInIters = (kIn + kThreads - 1) / kThreads;
  float win[kInIters];
  auto load_window = [&](int tile) {
    const int b = tile / (tiles_x * tiles_y);
    const int iy0 = (tile / tiles_x) % tiles_y * kTile * 4 - 7, ix0 = tile % tiles_x * kTile * 4 - 7;
    const T* xb = x + (size_t)b * H * W * kCin;
    // the thread index read opaquely: otherwise the compiler hoists the kInIters offsets
    // below out of the tile loop, and they stay live (and spill) through the convs
    int tid;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
#pragma unroll
    for (int it = 0; it < kInIters; ++it) {
      const int i = tid + it * kThreads;
      const int gy = iy0 + i / kCin / kRin, gx = ix0 + i / kCin % kRin;
      win[it] = (i < kIn && gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? focoos::load_f32(xb + ((size_t)gy * W + gx) * kCin + i % kCin)
                    : 0.f;
    }
  };
  const int grid = gridDim.x;
  if ((int)blockIdx.x < ntiles) load_window(blockIdx.x);

  for (int tile = blockIdx.x; tile < ntiles; tile += grid) {
    const int b = tile / (tiles_x * tiles_y);
    const int py0 = (tile / tiles_x) % tiles_y * kTile, px0 = tile % tiles_x * kTile;
    float* xs = reinterpret_cast<float*>(sm + L::oA);
#pragma unroll
    for (int it = 0; it < kInIters; ++it)
      if (threadIdx.x + it * kThreads < kIn) xs[threadIdx.x + it * kThreads] = win[it];
    __syncthreads();

    char* y1 = sm + L::oB;  // conv1: window (A) -> y1 (B)
    conv1<kSplit>(xs, sa + L::oW1, s1, a1, 2 * py0 - 3, 2 * px0 - 3, H1, W1,
                  [&](int o, int n, float v0, float v1, bool inside) {
                    store_act<kSplit, L::kY1>(y1, o, n, inside ? v0 : 0.f, inside ? v1 : 0.f);
                  });
    __syncthreads();

    {  // conv2: y1 (B) -> y2 (A, where the dead input window was)
      Acc<kR2, kP2, kC1> acc;
      conv_mma<kR1, kR2, kP2, kC1, kSplit>(acc, sa + L::oB, sa + L::oW2);
      char* y2 = sm + L::oA;
      acc.epilogue(s2, a2, 2 * py0 - 2, 2 * px0 - 2, H1, W1, [&](int o, int n, float v0, float v1, bool inside) {
        store_act<kSplit, L::kY2>(y2, o, n, inside ? v0 : 0.f, inside ? v1 : 0.f);
      });
    }
    __syncthreads();

    {  // conv3: y2 (A) -> y3 over A and B, once every warp is done reading y2
      Acc<kR3, kP3, kC3> acc;
      conv_mma<kR2, kR3, kP3, kC3, kSplit>(acc, sa + L::oA, sa + L::oW3);
      __syncthreads();
      T* y3 = reinterpret_cast<T*>(sm + L::oA);
      acc.epilogue(s3, a3, 2 * py0 - 1, 2 * px0 - 1, H1, W1, [&](int o, int n, float v0, float v1, bool inside) {
        Out<T>::store2(y3 + o * kY3S + n, inside ? v0 : -INFINITY, inside ? v1 : -INFINITY);
      });
    }
    __syncthreads();
    if (tile + grid < ntiles) load_window(tile + grid);  // in flight during the pool

    // maxpool 3x3 s2: pooled local (p, q) reads y3 local rows 2p..2p+2; 16 B per item
    constexpr int kVec = 16 / sizeof(T), kChunks = kC3 / kVec;
    const T* y3 = reinterpret_cast<const T*>(sm + L::oA);
    for (int i = threadIdx.x; i < kTile * kTile * kChunks; i += kThreads) {
      const int ch = i % kChunks, p = i / kChunks / kTile, q = i / kChunks % kTile;
      const int gy = py0 + p, gx = px0 + q;
      if (gy >= H4 || gx >= W4) continue;
      const T* src = y3 + (2 * p * kR3 + 2 * q) * kY3S + ch * kVec;
      uint4 m = *reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int k = 1; k < 9; ++k) m = Out<T>::vmax(m, *reinterpret_cast<const uint4*>(src + ((k / 3) * kR3 + k % 3) * kY3S));
      *reinterpret_cast<uint4*>(out + (((size_t)b * H4 + gy) * W4 + gx) * kC3 + ch * kVec) = m;
    }
    __syncthreads();  // the next tile's input window overwrites y3
  }
}

template <typename T>
int launch(const void* x, const float* const* p, void* out, int B, int H, int W, cudaStream_t st) {
  using L = Layout<sizeof(T) == 4>;
  static_assert(L::kBytes <= 232448, "over the 227 KB a block can opt into");
  static_assert(kP3 * kY3S * sizeof(T) <= L::kA + L::kPlanes * L::kY1, "y3 must fit over A and B");
  constexpr int kMaxDevices = 64;
  static int grid_cap[kMaxDevices];  // blocks resident on the whole card, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid_cap[dev] == 0) {
    err = cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_kernel<T>, kThreads, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_cap[dev] = sms * per_sm;
  }
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2;    // conv3x3 s2 p1
  const int H4 = (H1 + 1) / 2, W4 = (W1 + 1) / 2;  // maxpool3x3 s2 p1
  const long long tiles = (long long)B * ((H4 + kTile - 1) / kTile) * ((W4 + kTile - 1) / kTile);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < grid_cap[dev] ? tiles : grid_cap[dev]);
  stem_kernel<T><<<grid, kThreads, L::kBytes, st>>>(static_cast<const T*>(x), p[0], p[1], p[2], p[3], p[4], p[5],
                                                   p[6], p[7], p[8], static_cast<T*>(out), B, H, W, H1, W1, H4, W4);
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
