// Multi-scale deformable attention, backward, for Hopper (sm_90a), with d
// value accumulated in bf16 for bf16 values: a design measured and not taken
// (tools/torch_msda_ab.py times it beside focoos_tpu_torch/csrc/msda_bwd.cu).
// Its C interface: d_value in value's dtype, zeroed by the caller, and no
// fp32 scratch. Build: nvcc ... -I focoos_tpu_torch/csrc.
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
// forward, and d value (138 MB in fp32, 69 MB in bf16 at the main-path shape
// B=16, Lq=300, Hh=8, L=3, P=4, D=32) is written whole: the wrapper
// zero-fills it (a memset) and the kernel adds into it with atomics. Larger
// than the 50 MB L2, its lines can cross HBM three times (zeros written, read
// back by the atomics, written again), where the bound counts one. Zeroing
// and accumulating a few images at a time (a memset and a launch each)
// measured slower at every chunk size tried (1, 2 and 4 images).
//
// d value and the incoming gradient are in value's dtype. For bf16 values
// the kernel accumulates d value in bf16 itself, with Hopper's bf16
// reductions (one 8-byte red.v2.bf16x2 a lane and corner on the vector path,
// one bf16 atomic add on the general one): half the bytes of an fp32 buffer in the fill and the atomics, and no
// second pass to convert. A row of d value takes few contributions (on
// average 300*3*4*4 / 8400 ~ 1.7 at the main-path shape, about 12 on the
// 20x20 level), so it rounds a few times where an fp32 sum rounds once.
//
// Design: the forward's layout (csrc/msda.cu), one warp per (b, q, h).
// Vector path (D = 4, 8, 16 or 32; value, grad 16-byte aligned): R = D / 4
// lanes per row, four channels a lane, so d value takes one 16-byte vector
// atomic (atomicAdd on float4, sm_90) per lane per corner in fp32, one
// 8-byte bf16x2 vector reduction in bf16. Value and grad rows are read with 16-byte
// (fp32) or 8-byte (bf16) loads, all of a round's eight samples issued before their arithmetic. Each
// lane's partial dot products of a round are summed over the R lanes of a row
// by a reduce-scatter (R - 1 shuffles for R rows), one shuffle hands each
// corner's dot to the lane that computed that corner, and two shuffle steps
// over the four corners give the sample's d aw and d loc. General path (any
// D, any alignment): lanes over D, scalar loads and atomics, four warp sums
// a sample. Nothing is saved from the forward but value, loc and aw: the
// corner weights are recomputed here, so no [B, Lq, Hh, L, P, D]
// intermediate exists (the port's counterpart of the JAX remat default,
// ops/deformable.py:346-377). Atomics add in a run-dependent order, so
// d value is not bit-reproducible between runs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
using focoos::Corner;
using focoos::LevelTable;

// d value += four channels: fp32 one 16-byte atomic; bf16 one 8-byte vector
// reduction of two bf16x2 (sm_90's red.v2.bf16x2; no value comes back)
__device__ __forceinline__ void atomic_add4(float* p, float4 v) { atomicAdd(reinterpret_cast<float4*>(p), v); }
__device__ __forceinline__ void atomic_add4(__nv_bfloat16* p, float4 v) {
  asm volatile("red.global.add.noftz.v2.bf16x2 [%0], {%1, %2};" ::"l"(p), "r"(focoos::pack_bf16x2(v.x, v.y)),
               "r"(focoos::pack_bf16x2(v.z, v.w)) : "memory");
}
__device__ __forceinline__ void atomic_add1(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add1(__nv_bfloat16* p, float v) { atomicAdd(p, __float2bfloat16(v)); }

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

template <typename T, int R>  // R lanes per value row, four channels each
__global__ void __launch_bounds__(kThreads) msda_backward_vector(
    const T* __restrict__ value,     // [B, S, Hh, D], 16-byte aligned
    const float* __restrict__ loc,   // [B, Lq, Hh, L, P, 2] (x, y) in [0, 1]
    const float* __restrict__ aw,    // [B, Lq, Hh, L, P]
    const T* __restrict__ grad,      // [B, Lq, Hh * D], 16-byte aligned
    T* __restrict__ d_value,         // [B, S, Hh, D], zeroed by the wrapper; null: not wanted
    float* __restrict__ d_loc,       // [B, Lq, Hh, L, P, 2]; null: not wanted
    float* __restrict__ d_aw,        // [B, Lq, Hh, L, P]; null: not wanted
    LevelTable lv_param, int n_warps, int S, int Lq, int Hh, int L, int P) {
  constexpr int D = 4 * R;
  constexpr int G = 32 / R;    // value rows per load instruction
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave: the shuffles below see 32 lanes
  // warp = (b * Lq + q) * Hh + h: the loc/aw/grad rows of this warp are contiguous
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const int n = L * P;
  const float* loc_w = loc + (size_t)warp * n * 2;
  const float* aw_w = aw + (size_t)warp * n;
  const int r = lane % R;
  const int row = Hh * D;  // elements between two spatial positions
  const size_t slice = ((size_t)b * S * Hh + h) * D + r * 4;
  const T* vb = value + slice;
  T* dvb = d_value == nullptr ? nullptr : d_value + slice;
  float4 g;
  focoos::unpack(focoos::ldg4(grad + (size_t)warp * D + r * 4), g);
  // after the reduce-scatter, lane (e % G) * R + e / G holds the dot of corner entry e
  const int gather = (lane % G) * R + lane / G;

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
        atomic_add4(dvb + off[k], make_float4(w[k] * g.x, w[k] * g.y, w[k] * g.z, w[k] * g.w));
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_backward_general(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    const T* __restrict__ grad, T* __restrict__ d_value, float* __restrict__ d_loc,
    float* __restrict__ d_aw, LevelTable lv_param, int n_warps, int S, int Lq, int Hh, int D, int L, int P) {
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const int n = L * P;
  const float* loc_w = loc + (size_t)warp * n * 2;
  const float* aw_w = aw + (size_t)warp * n;
  const T* g_w = grad + (size_t)warp * D;
  const int row = Hh * D;
  const size_t slice = ((size_t)b * S * Hh + h) * D;
  const T* vb = value + slice;
  T* dvb = d_value == nullptr ? nullptr : d_value + slice;

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
          if (dvb != nullptr && w[c] != 0.f) atomic_add1(dvb + off[c] + d, w[c] * gd);
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

template <typename T>
int launch(bool vector, const void* value, const void* loc, const void* aw, const void* grad,
           void* d_value, float* dl, float* da, const LevelTable& lv, int n_warps, int S, int Lq, int Hh,
           int D, int L, int P, cudaStream_t st) {
  const unsigned blocks = (unsigned)(((long long)n_warps * 32 + kThreads - 1) / kThreads);
  const T* v = static_cast<const T*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const T* g = static_cast<const T*>(grad);
  T* dv = static_cast<T*>(d_value);
  if (!vector) {
    msda_backward_general<T><<<blocks, kThreads, 0, st>>>(v, l, a, g, dv, dl, da, lv, n_warps, S, Lq, Hh, D, L, P);
    return (int)cudaGetLastError();
  }
  if ((reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(grad) | reinterpret_cast<uintptr_t>(dv)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (D % 4 == 0 ? D / 4 : 0) {
    case 1: msda_backward_vector<T, 1><<<blocks, kThreads, 0, st>>>(v, l, a, g, dv, dl, da, lv, n_warps, S, Lq, Hh, L, P); break;
    case 2: msda_backward_vector<T, 2><<<blocks, kThreads, 0, st>>>(v, l, a, g, dv, dl, da, lv, n_warps, S, Lq, Hh, L, P); break;
    case 4: msda_backward_vector<T, 4><<<blocks, kThreads, 0, st>>>(v, l, a, g, dv, dl, da, lv, n_warps, S, Lq, Hh, L, P); break;
    case 8: msda_backward_vector<T, 8><<<blocks, kThreads, 0, st>>>(v, l, a, g, dv, dl, da, lv, n_warps, S, Lq, Hh, L, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// value, grad and d value in one dtype (dtype: kFloat32 or kBFloat16); loc, aw, d loc and d aw fp32.
// vector: 1 for the vector path (D in {4, 8, 16, 32}; value, grad and d value 16-byte aligned), 0 for the general path
extern "C" int msda_backward(const void* value, const void* loc, const void* aw, const void* grad,
                             void* d_value, void* d_loc, void* d_aw, const int* level_hw,
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
  if (dtype == focoos::kFloat32)
    return launch<float>(vector != 0, value, loc, aw, grad, d_value, dl, da, lv, (int)n_warps, S, Lq, Hh, D, n_levels,
                         P, st);
  if (dtype == focoos::kBFloat16)
    return launch<__nv_bfloat16>(vector != 0, value, loc, aw, grad, d_value, dl, da, lv, (int)n_warps, S, Lq, Hh,
                                 D, n_levels, P, st);
  return (int)cudaErrorInvalidValue;
}
