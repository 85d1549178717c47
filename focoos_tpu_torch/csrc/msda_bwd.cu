// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/msda.py, the custom VJP of
// ms_deform_attn_fused (:167-186), whose backward _fused_bwd (:177) is the VJP
// of focoos_tpu/ops/deformable.py:323 ms_deform_attn_separable. Semantics are
// those of the forward in msda.cu: zeros padding, align_corners=False
// (pixel = loc * size - 0.5), an out-of-range corner contributes nothing to
// any gradient, floor() has no gradient. From g = dL/dout [B, Lq, Hh*D], with
// dot_c = sum_d g[d] * V_c[d] for each corner c of a sample (V_c = 0 for an
// invalid corner) and w_c its bilinear weight:
//   d value[b, s_c, h, :] += aw * w_c * g            for each valid corner c
//   d aw[b, q, h, l, p]    = sum_c w_c * dot_c
//   d loc_x                = aw * W_l * sum_c dw_c/dtx * dot_c
//   d loc_y                = aw * H_l * sum_c dw_c/dty * dot_c
// All three are linear in the corners' dot products, so one reduction over D
// per corner serves them all.
//
// What bounds it on this card: bytes. The corner rows are read as in the
// forward, and d value (138 MB in fp32 at the main-path shape B=16, Lq=300,
// Hh=8, L=3, P=4, D=32; 69 MB in bf16) is written whole: the wrapper
// zero-fills an fp32 accumulator (a memset) and the kernel adds into it with
// atomics. Larger than the 50 MB L2, its lines can cross HBM three times
// (zeros written, read back by the atomics, written again), where the bound
// counts one. Zeroing and accumulating a few images at a time (a memset and a
// launch each) measured slower at every chunk size tried (1, 2 and 4 images).
//
// d value and the incoming gradient are in value's dtype; d value always
// accumulates in fp32 and is rounded once. For bf16 values the fp32
// accumulator is the wrapper's scratch, and the kernel converts it to the
// bf16 d value itself: it runs as a cooperative launch (every block resident
// at once, warps striding over the items), waits at a grid barrier for the
// last atomic, then converts with every thread, the most recently written
// lines first (they are still in L2). No second launch. This is the simple
// design, not a fast one: it takes about as long as the fp32 kernel plus a
// separate cast did. Two others measured: accumulating in bf16 (one
// red.v2.bf16x2 a lane and corner: tools/msda_bwd_bf16_atomics.cu) halves
// the fill's and the atomics' bytes and is faster than fp32, but rounds once
// per contribution, and rows that many samples share (the model's own
// locations; small maps) miss the 2^-6 x max|ref| tolerance; converting each
// (b, h) slice in the block that finishes it, with items in (b, h, q) order,
// measured twice as slow (one block converts 1.1 MB, and the last slices'
// conversions form a tail).
//
// Design: the forward's layout (csrc/msda.cu), one warp per (b, q, h).
// Vector path (D = 4, 8, 16 or 32; value, grad 16-byte aligned): R = D / 4
// lanes per row, four channels a lane, so d value takes one 16-byte vector
// atomic (atomicAdd on float4, sm_90) per lane per corner. Value and grad
// rows are read with 16-byte (fp32) or 8-byte (bf16) loads, all of a round's
// eight samples issued before their arithmetic. Each lane's partial dot
// products of a round are summed over the R lanes of a row by a
// reduce-scatter (R - 1 shuffles for R rows), one shuffle hands each corner's
// dot to the lane that computed that corner, and two shuffle steps over the
// four corners give the sample's d aw and d loc. General path (any D, any
// alignment): lanes over D, scalar loads and atomics, four warp sums a
// sample. Nothing is saved from the forward but value, loc and aw: the corner
// weights are recomputed here, so no [B, Lq, Hh, L, P, D] intermediate exists
// (the port's counterpart of the JAX remat default, ops/deformable.py:346-377).
// Atomics add in a run-dependent order, so d value is not bit-reproducible
// between runs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
using focoos::Corner;
using focoos::LevelTable;

// Corner entry e (= lane) with dc = its dot product: sum the three gradients
// over the sample's four corner lanes and write them from corner 0's lane.
__device__ __forceinline__ void write_sample_grads(const Corner& e, float dc, int lane, int base, int n,
                                                   int warp, const LevelTable& lv, float* __restrict__ d_loc,
                                                   float* __restrict__ d_aw) {
  const int c = lane & 3;
  float s_aw = 0.f, s_tx = 0.f, s_ty = 0.f;
  if (e.ok) {
    const float wx = (c & 1) ? e.tx : 1.f - e.tx, wy = (c >> 1) ? e.ty : 1.f - e.ty;
    s_aw = e.wgeom * dc;
    s_tx = ((c & 1) ? wy : -wy) * dc;
    s_ty = ((c >> 1) ? wx : -wx) * dc;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s_aw += __shfl_xor_sync(0xffffffffu, s_aw, o);
    s_tx += __shfl_xor_sync(0xffffffffu, s_tx, o);
    s_ty += __shfl_xor_sync(0xffffffffu, s_ty, o);
  }
  const int i = base + (lane >> 2);
  if (c == 0 && i < n) {
    const size_t k = (size_t)warp * n + i;
    if (d_aw != nullptr) d_aw[k] = s_aw;
    if (d_loc != nullptr) {
      d_loc[2 * k] = e.a * (float)lv.w[e.l] * s_tx;
      d_loc[2 * k + 1] = e.a * (float)lv.h[e.l] * s_ty;
    }
  }
}

// After every block's atomics, d value = the fp32 accumulator rounded to bf16,
// converted by every thread of the grid, from the end backwards (the lines
// written last are the likeliest still in L2). Only in a cooperative launch:
// the barrier waits for all blocks, which must be resident together.
// barrier: an int the wrapper zeroed. out null: the accumulator is the result.
__device__ __forceinline__ void convert_after_all(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                                                  long long n, int* barrier) {
  if (out == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's atomics before its arrival
    atomicAdd(barrier, 1);
    while (*reinterpret_cast<volatile int*>(barrier) < (int)gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (n + 3) / 4 - 1 - ((long long)blockIdx.x * kThreads + threadIdx.x); j >= 0; j -= stride) {
    const long long i = 4 * j;
    if (i + 4 <= n) {  // the wrapper's buffers are 16-byte aligned and n is counted from their start
      const float4 f = __ldcg(reinterpret_cast<const float4*>(acc + i));  // from L2: the atomics wrote there
      *reinterpret_cast<uint2*>(out + i) = make_uint2(focoos::pack_bf16x2(f.x, f.y), focoos::pack_bf16x2(f.z, f.w));
    } else {
      for (long long k = i; k < n; ++k) out[k] = __float2bfloat16(__ldcg(acc + k));
    }
  }
}

// kCoop: a cooperative launch that strides over the items and converts a bf16
// d value at the end; otherwise one item a warp and the grid covers them all.
template <typename T, int R, bool kCoop>  // R lanes per value row, four channels each
__global__ void __launch_bounds__(kThreads) msda_backward_vector(
    const T* __restrict__ value,     // [B, S, Hh, D], 16-byte aligned
    const float* __restrict__ loc,   // [B, Lq, Hh, L, P, 2] (x, y) in [0, 1]
    const float* __restrict__ aw,    // [B, Lq, Hh, L, P]
    const T* __restrict__ grad,      // [B, Lq, Hh * D], 16-byte aligned
    float* __restrict__ acc,         // [B, S, Hh, D] fp32, zeroed by the wrapper; null: d value not wanted
    __nv_bfloat16* __restrict__ out, // bf16 d value converted from acc; null: acc is d value
    float* __restrict__ d_loc,       // [B, Lq, Hh, L, P, 2]; null: not wanted
    float* __restrict__ d_aw,        // [B, Lq, Hh, L, P]; null: not wanted
    int* barrier, long long n_acc, LevelTable lv_param, int n_warps, int S, int Lq, int Hh, int L, int P) {
  constexpr int D = 4 * R;
  constexpr int G = 32 / R;    // value rows per load instruction
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int lane = threadIdx.x & 31;
  const int n = L * P;
  const int r = lane % R;
  const int row = Hh * D;  // elements between two spatial positions
  // after the reduce-scatter, lane (e % G) * R + e / G holds the dot of corner entry e
  const int gather = (lane % G) * R + lane / G;
  // warp = (b * Lq + q) * Hh + h: the loc/aw/grad rows of an item are contiguous. Whole warps
  // stride over the items, so the shuffles below always see 32 lanes.
  for (int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5; warp < n_warps;
       warp += kCoop ? gridDim.x * kWarpsPerBlock : n_warps) {
    const int h = warp % Hh;
    const int b = warp / (Hh * Lq);
    const float* loc_w = loc + (size_t)warp * n * 2;
    const float* aw_w = aw + (size_t)warp * n;
    const size_t slice = ((size_t)b * S * Hh + h) * D + r * 4;
    const T* vb = value + slice;
    float* dvb = acc == nullptr ? nullptr : acc + slice;
    float4 g;
    focoos::unpack(focoos::ldg4(grad + (size_t)warp * D + r * 4), g);

    for (int base = 0; base < n; base += 8) {
      const Corner e = focoos::corner(lane, base, n, P, lv, loc_w, aw_w, row);
      const float w_e = e.ok ? e.a * e.wgeom : 0.f;
      decltype(focoos::ldg4(vb)) v[R];
      int off[R];
      float w[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {  // all loads first
        const int src = k * G + lane / R;  // the lane that holds this row's corner
        off[k] = __shfl_sync(0xffffffffu, e.off, src);
        w[k] = __shfl_sync(0xffffffffu, w_e, src);
        v[k] = focoos::ldg4(vb + off[k]);
      }
      float dot[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float4 f;
        focoos::unpack(v[k], f);
        dot[k] = g.x * f.x + g.y * f.y + g.z * f.z + g.w * f.w;
        if (dvb != nullptr && w[k] != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dvb + off[k]), make_float4(w[k] * g.x, w[k] * g.y, w[k] * g.z, w[k] * g.w));
      }
      // reduce-scatter over the R lanes of a row: lane r ends with the whole dot of instruction r
#pragma unroll
      for (int half = R / 2; half >= 1; half >>= 1) {
        const bool upper = (r & half) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? dot[j] : dot[j + half];
          const float keep = upper ? dot[j + half] : dot[j];
          dot[j] = keep + __shfl_xor_sync(0xffffffffu, send, half);
        }
      }
      write_sample_grads(e, __shfl_sync(0xffffffffu, dot[0], gather), lane, base, n, warp, lv, d_loc, d_aw);
    }
  }
  if (kCoop) convert_after_all(acc, out, n_acc, barrier);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kCoop>
__global__ void __launch_bounds__(kThreads) msda_backward_general(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    const T* __restrict__ grad, float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
    float* __restrict__ d_loc, float* __restrict__ d_aw, int* barrier, long long n_acc, LevelTable lv_param,
    int n_warps, int S, int Lq, int Hh, int D, int L, int P) {
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int lane = threadIdx.x & 31;
  const int n = L * P;
  const int row = Hh * D;
  for (int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5; warp < n_warps;
       warp += kCoop ? gridDim.x * kWarpsPerBlock : n_warps) {
    const int h = warp % Hh;
    const int b = warp / (Hh * Lq);
    const float* loc_w = loc + (size_t)warp * n * 2;
    const float* aw_w = aw + (size_t)warp * n;
    const T* g_w = grad + (size_t)warp * D;
    const size_t slice = ((size_t)b * S * Hh + h) * D;
    const T* vb = value + slice;
    float* dvb = acc == nullptr ? nullptr : acc + slice;

    for (int base = 0; base < n; base += 8) {
      const Corner e = focoos::corner(lane, base, n, P, lv, loc_w, aw_w, row);
      const float w_e = e.ok ? e.a * e.wgeom : 0.f;
      float mine = 0.f;  // the dot of this lane's corner entry
      for (int s = 0; s < 8 && base + s < n; ++s) {
        int off[4];
        float w[4], dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          off[c] = __shfl_sync(0xffffffffu, e.off, 4 * s + c);
          w[c] = __shfl_sync(0xffffffffu, w_e, 4 * s + c);
        }
        for (int d = lane; d < D; d += 32) {
          const float gd = focoos::load_f32(g_w + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dot[c] = fmaf(gd, focoos::load_f32(vb + off[c] + d), dot[c]);
            if (dvb != nullptr && w[c] != 0.f) atomicAdd(dvb + off[c] + d, w[c] * gd);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t = warp_sum(dot[c]);
          if (lane == 4 * s + c) mine = t;
        }
      }
      write_sample_grads(e, mine, lane, base, n, warp, lv, d_loc, d_aw);
    }
  }
  if (kCoop) convert_after_all(acc, out, n_acc, barrier);
}

// One block per 8 items, or (cooperative) as many blocks as fit on the card
// at once, the items strided over them.
template <typename... KArgs, typename... Args>
int launch_kernel(void (*kernel)(KArgs...), bool cooperative, long long n_warps, cudaStream_t st, Args... args) {
  unsigned blocks = (unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (!cooperative) {
    kernel<<<blocks, kThreads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((long long)per_sm * sms < (long long)blocks) blocks = (unsigned)(per_sm * sms);
  void* argv[] = {static_cast<void*>(&args)...};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads), argv,
                                          0, st);
}

template <typename T, int R>
int launch_vector(__nv_bfloat16* out, int n_warps, cudaStream_t st, const T* v, const float* l, const float* a,
                  const T* g, float* acc, float* dl, float* da, int* barrier, long long n_acc, const LevelTable& lv,
                  int S, int Lq, int Hh, int L, int P) {
  return launch_kernel(out != nullptr ? msda_backward_vector<T, R, true> : msda_backward_vector<T, R, false>,
                       out != nullptr, n_warps, st, v, l, a, g, acc, out, dl, da, barrier, n_acc, lv, n_warps, S, Lq, Hh,
                       L, P);
}

template <typename T>
int launch(bool vector, const void* value, const void* loc, const void* aw, const void* grad, float* acc,
           __nv_bfloat16* out, float* dl, float* da, int* barrier, long long n_acc, const LevelTable& lv, int n_warps,
           int S, int Lq, int Hh, int D, int L, int P, cudaStream_t st) {
  const T* v = static_cast<const T*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const T* g = static_cast<const T*>(grad);
  if (!vector)
    return launch_kernel(out != nullptr ? msda_backward_general<T, true> : msda_backward_general<T, false>,
                         out != nullptr, n_warps, st, v, l, a, g, acc, out, dl, da, barrier, n_acc, lv, n_warps, S, Lq,
                         Hh, D, L, P);
  if ((reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(acc)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (D % 4 == 0 ? D / 4 : 0) {
    case 1: return launch_vector<T, 1>(out, n_warps, st, v, l, a, g, acc, dl, da, barrier, n_acc, lv, S, Lq, Hh, L, P);
    case 2: return launch_vector<T, 2>(out, n_warps, st, v, l, a, g, acc, dl, da, barrier, n_acc, lv, S, Lq, Hh, L, P);
    case 4: return launch_vector<T, 4>(out, n_warps, st, v, l, a, g, acc, dl, da, barrier, n_acc, lv, S, Lq, Hh, L, P);
    case 8: return launch_vector<T, 8>(out, n_warps, st, v, l, a, g, acc, dl, da, barrier, n_acc, lv, S, Lq, Hh, L, P);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// value and grad in one dtype (dtype: kFloat32 or kBFloat16); loc, aw, d loc and d aw fp32.
// d_value: null when not wanted. fp32 values: the fp32 d value, zeroed by the caller, and acc null. bf16
// values: the bf16 d value (written whole), and acc the caller's zeroed fp32 scratch of B*S*Hh*D + 4 floats
// (the accumulator, then the grid barrier's int counter).
// vector: 1 for the vector path (D in {4, 8, 16, 32}; value, grad and acc 16-byte aligned), 0 for the general path
extern "C" int msda_backward(const void* value, const void* loc, const void* aw, const void* grad,
                             void* d_value, void* acc, void* d_loc, void* d_aw, const int* level_hw,
                             int n_levels, int B, int S, int Lq, int Hh, int D, int P, int dtype,
                             int vector, void* stream) {
  LevelTable lv;
  const int err = focoos::make_level_table(level_hw, n_levels, S, Hh, D, &lv);
  if (err != 0) return err;
  const long long n_warps = (long long)B * Lq * Hh;
  if (n_warps == 0) return (int)cudaSuccess;
  if (n_warps > (1LL << 26) || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(d_loc);
  float* da = static_cast<float*>(d_aw);
  const long long n_acc = (long long)B * S * Hh * D;
  if (dtype == focoos::kFloat32) {
    if (acc != nullptr) return (int)cudaErrorInvalidValue;
    return launch<float>(vector != 0, value, loc, aw, grad, static_cast<float*>(d_value), nullptr, dl, da, nullptr,
                         n_acc, lv, (int)n_warps, S, Lq, Hh, D, n_levels, P, st);
  }
  if (dtype == focoos::kBFloat16) {
    if ((d_value == nullptr) != (acc == nullptr)) return (int)cudaErrorInvalidValue;
    float* a = static_cast<float*>(acc);
    return launch<__nv_bfloat16>(vector != 0, value, loc, aw, grad, a, static_cast<__nv_bfloat16*>(d_value), dl, da,
                                 a == nullptr ? nullptr : reinterpret_cast<int*>(a + n_acc), n_acc, lv, (int)n_warps,
                                 S, Lq, Hh, D, n_levels, P, st);
  }
  return (int)cudaErrorInvalidValue;
}
