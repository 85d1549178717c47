// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/msda.py, msda_pallas (pallas_call at :132,
// body _msda_level_kernel :37). Semantics: focoos_tpu/ops/deformable.py:59
// ms_deform_attn: for each (batch b, query q, head h),
//   out[b, q, h*D + d] = sum_{l, p} aw[b,q,h,l,p] * bilinear(value_l[:, :, h, d], loc[b,q,h,l,p])
// with zeros padding, align_corners=False (pixel = loc * size - 0.5).
//
// What bounds it on this card: memory latency of scattered reads. Each
// (b, q, h) reads L*P*4 rows of D values at data-dependent positions and does
// two FMAs per value read; at the main-path shape (B=16, S=8400, Hh*D=256)
// the value tensor is 138 MB in fp32, larger than the 50 MB L2, so most
// corner reads go to HBM. There is nothing for the tensor cores to do.
//
// Design: one warp per (b, q, h), lanes over D. On the main path D=32, so a
// corner read is 32 contiguous channels of value[b, s, h, :] (128 B in fp32,
// 64 B in bf16): one coalesced transaction, and the corner weights and
// indices are the same across the warp. The 4*L*P samples accumulate in an
// fp32 register; nothing but the [B, Lq, Hh*D] output is written, so the
// intermediates that the TPU kernel kept in VMEM never exist here at all. The
// Pallas kernel's row-one-hot matmul is a trick for the MXU, which cannot
// gather; the card gathers directly. The value tensor is the flat
// [B, S, Hh, D] projection of the encoder memory, with per-level start
// offsets passed by value, so no per-level copy is made.
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

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_forward_kernel(
    const T* __restrict__ value,    // [B, S, Hh, D]
    const float* __restrict__ loc,  // [B, Lq, Hh, L, P, 2] (x, y) in [0, 1]
    const float* __restrict__ aw,   // [B, Lq, Hh, L, P]
    T* __restrict__ out,            // [B, Lq, Hh * D]
    LevelTable lv, int n_warps, int S, int Lq, int Hh, int D, int L, int P) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * Hh + h: the loc/aw rows of this warp are contiguous
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const float* loc_w = loc + (size_t)warp * L * P * 2;
  const float* aw_w = aw + (size_t)warp * L * P;
  const size_t row = (size_t)Hh * D;  // elements between two spatial positions
  const T* vb = value + (size_t)b * S * row + (size_t)h * D;

  for (int d = lane; d - lane < D; d += 32) {
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const T* vl = vb + (size_t)lv.start[l] * row + (active ? d : 0);
#pragma unroll 4
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
        if (!((x0ok || x1ok) && (y0ok || y1ok))) continue;
        const int x0 = (int)xf, y0 = (int)yf;
        float s = 0.f;
        if (active) {
          if (y0ok && x0ok) s += (1.f - tx) * (1.f - ty) * focoos::load_f32(vl + (size_t)(y0 * wl + x0) * row);
          if (y0ok && x1ok) s += tx * (1.f - ty) * focoos::load_f32(vl + (size_t)(y0 * wl + x0 + 1) * row);
          if (y1ok && x0ok) s += (1.f - tx) * ty * focoos::load_f32(vl + (size_t)((y0 + 1) * wl + x0) * row);
          if (y1ok && x1ok) s += tx * ty * focoos::load_f32(vl + (size_t)((y0 + 1) * wl + x0 + 1) * row);
        }
        acc += a * s;
      }
    }
    if (active) focoos::store_f32(out + (size_t)warp * D + d, acc);
  }
}

}  // namespace

extern "C" int msda_forward(const void* value, const void* loc, const void* aw, void* out,
                            const int* level_hw, int n_levels, int B, int S, int Lq, int Hh,
                            int D, int P, int dtype, void* stream) {
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
  if (dtype == focoos::kFloat32) {
    msda_forward_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<float*>(out), lv, (int)n_warps, S, Lq, Hh, D,
        n_levels, P);
  } else if (dtype == focoos::kBFloat16) {
    msda_forward_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<__nv_bfloat16*>(out), lv, (int)n_warps, S, Lq,
        Hh, D, n_levels, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
