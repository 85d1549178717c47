// Multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/msda.py, the custom VJP of
// ms_deform_attn_fused (:167-186), whose backward _fused_bwd (:177) is the VJP
// of focoos_tpu/ops/deformable.py:323 ms_deform_attn_separable. Semantics are
// those of the forward in msda.cu: zeros padding, align_corners=False
// (pixel = loc * size - 0.5), an out-of-range corner contributes nothing to
// any gradient, floor() has no gradient. From g = dL/dout [B, Lq, Hh*D]:
//   d value[b, s_c, h, d]  += aw * w_c * g[d]          for each valid corner c
//   d aw[b, q, h, l, p]     = sum_d g[d] * s[d]         s = sum_c w_c * V_c
//   d loc_x                 = aw * W_l * sum_d g[d] * ds/dtx,  ds/dtx = (1-ty)(V01-V00) + ty(V11-V10)
//   d loc_y                 = aw * H_l * sum_d g[d] * ds/dty,  ds/dty = (1-tx)(V10-V00) + tx(V11-V01)
// (V_c = 0 for an invalid corner).
//
// What bounds it on this card: the scattered reads of the corners (as in the
// forward) and the atomic adds into d value: at the main-path shape (B=16,
// Lq=300, Hh=8, L=3, P=4, D=32) about 59M fp32 atomics per call into a 138 MB
// d value, most of which misses the 50 MB L2.
//
// Design: the forward's layout, one warp per (b, q, h), lanes over D. Nothing
// is saved from the forward but value, loc and aw: the corner weights are
// recomputed here, so no [B, Lq, Hh, L, P, D] intermediate exists (the port's
// counterpart of the JAX remat default, ops/deformable.py:346-377). Per
// sample, each lane reads its channel of the four corners once, adds
// aw * w_c * g[d] into d value with an atomic (fp32; the wrapper casts for a
// bf16 value), and keeps per-lane partial sums of g*s, g*ds/dtx and g*ds/dty,
// which three warp shuffle reductions turn into d aw and d loc. D > 32 loops
// over chunks of 32 channels before the reduction. Atomics sum in a
// run-dependent order, so d value is not bit-reproducible between runs.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_backward_kernel(
    const T* __restrict__ value,     // [B, S, Hh, D]
    const float* __restrict__ loc,   // [B, Lq, Hh, L, P, 2] (x, y) in [0, 1]
    const float* __restrict__ aw,    // [B, Lq, Hh, L, P]
    const float* __restrict__ grad,  // [B, Lq, Hh * D]
    float* __restrict__ d_value,     // [B, S, Hh, D], zeroed by the wrapper; null: not wanted
    float* __restrict__ d_loc,       // [B, Lq, Hh, L, P, 2]; null: not wanted
    float* __restrict__ d_aw,        // [B, Lq, Hh, L, P]; null: not wanted
    LevelTable lv, int n_warps, int S, int Lq, int Hh, int D, int L, int P) {
  // kThreads is a multiple of 32: every lane of a warp has the same warp
  // index, so a warp leaves here whole and the shuffles below see 32 lanes
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * Hh + h: the loc/aw/grad rows of this warp are contiguous
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const float* loc_w = loc + (size_t)warp * L * P * 2;
  const float* aw_w = aw + (size_t)warp * L * P;
  const float* g_w = grad + (size_t)warp * D;
  const long long row = (long long)Hh * D;  // elements between two spatial positions
  const size_t base = (size_t)b * S * row + (size_t)h * D;
  const T* vb = value + base;
  float* dvb = d_value == nullptr ? nullptr : d_value + base;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const long long lstart = (long long)lv.start[l] * row;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float a = __ldg(aw_w + i);
      const float x = __ldg(loc_w + 2 * i) * wl - 0.5f;
      const float y = __ldg(loc_w + 2 * i + 1) * hl - 0.5f;
      const float xf = floorf(x), yf = floorf(y);
      const float tx = x - xf, ty = y - yf;
      // validity in float: a far out-of-range location never becomes an int
      const bool x0ok = xf >= 0.f && xf <= (float)(wl - 1);
      const bool x1ok = xf + 1.f >= 0.f && xf + 1.f <= (float)(wl - 1);
      const bool y0ok = yf >= 0.f && yf <= (float)(hl - 1);
      const bool y1ok = yf + 1.f >= 0.f && yf + 1.f <= (float)(hl - 1);
      const bool ok00 = y0ok && x0ok, ok01 = y0ok && x1ok, ok10 = y1ok && x0ok, ok11 = y1ok && x1ok;
      float gs = 0.f, gtx = 0.f, gty = 0.f;  // this lane's share of the sums over d
      if (ok00 || ok01 || ok10 || ok11) {    // the same for every lane of the warp
        const long long x0 = (long long)xf, y0 = (long long)yf;
        // element offsets of the corners; used only where the corner is valid
        const long long o00 = lstart + (y0 * wl + x0) * row;
        const long long o01 = o00 + row;
        const long long o10 = o00 + (long long)wl * row;
        const long long o11 = o10 + row;
        const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
        const float w10 = (1.f - tx) * ty, w11 = tx * ty;
        for (int d = lane; d - lane < D; d += 32) {
          if (d < D) {
            const float gd = __ldg(g_w + d);
            const float v00 = ok00 ? focoos::load_f32(vb + o00 + d) : 0.f;
            const float v01 = ok01 ? focoos::load_f32(vb + o01 + d) : 0.f;
            const float v10 = ok10 ? focoos::load_f32(vb + o10 + d) : 0.f;
            const float v11 = ok11 ? focoos::load_f32(vb + o11 + d) : 0.f;
            gs += gd * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
            gtx += gd * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
            gty += gd * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
            if (dvb != nullptr) {
              const float ag = a * gd;
              if (ok00) atomicAdd(dvb + o00 + d, ag * w00);
              if (ok01) atomicAdd(dvb + o01 + d, ag * w01);
              if (ok10) atomicAdd(dvb + o10 + d, ag * w10);
              if (ok11) atomicAdd(dvb + o11 + d, ag * w11);
            }
          }
        }
      }
      gs = warp_sum(gs);
      gtx = warp_sum(gtx);
      gty = warp_sum(gty);
      if (lane == 0) {
        const size_t k = (size_t)warp * L * P + i;
        if (d_aw != nullptr) d_aw[k] = gs;
        if (d_loc != nullptr) {
          d_loc[2 * k] = a * (float)wl * gtx;
          d_loc[2 * k + 1] = a * (float)hl * gty;
        }
      }
    }
  }
}

}  // namespace

extern "C" int msda_backward(const void* value, const void* loc, const void* aw, const void* grad,
                             void* d_value, void* d_loc, void* d_aw, const int* level_hw,
                             int n_levels, int B, int S, int Lq, int Hh, int D, int P, int dtype,
                             void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  LevelTable lv;
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = level_hw[2 * l];
    lv.w[l] = level_hw[2 * l + 1];
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start != S) return (int)cudaErrorInvalidValue;
  const long long n_warps = (long long)B * Lq * Hh;
  if (n_warps == 0) return (int)cudaSuccess;
  const long long blocks = (n_warps * 32 + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dv = static_cast<float*>(d_value);
  float* dl = static_cast<float*>(d_loc);
  float* da = static_cast<float*>(d_aw);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  const float* g = static_cast<const float*>(grad);
  if (dtype == focoos::kFloat32) {
    msda_backward_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(value), l, a, g, dv, dl, da, lv, (int)n_warps, S, Lq, Hh, D,
        n_levels, P);
  } else if (dtype == focoos::kBFloat16) {
    msda_backward_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), l, a, g, dv, dl, da, lv, (int)n_warps, S, Lq,
        Hh, D, n_levels, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
