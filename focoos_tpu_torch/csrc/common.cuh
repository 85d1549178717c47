// Shared helpers for the hand-written Hopper kernels of focoos_tpu_torch.
//
// Every kernel here is compiled by nvcc into its own shared library with a
// plain C interface (see focoos_tpu_torch/ops/cuda_build.py) and loaded with
// ctypes: no PyTorch headers, so nvcc compiles the kernel and nothing else.
// Each exported C function launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace focoos {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of values as fp32: four floats, or eight bf16 (a bf16 is the high
// half of its fp32, so the widening is exact)
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) f[2 * j] = __uint_as_float(u[j] << 16), f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
}
// four values as fp32 from 16 bytes (fp32) or 8 bytes (bf16)
__device__ __forceinline__ void unpack(const uint4& v, float4& f) {
  f = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ void unpack(const uint2& v, float4& f) {
  f = make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                  __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// the bits of four values: 16 bytes of fp32, 8 bytes of bf16
__device__ __forceinline__ uint4 ldg4(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
__device__ __forceinline__ uint2 ldg4(const __nv_bfloat16* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
// one 16-byte store of four floats, or of eight floats rounded to bf16
__device__ __forceinline__ void store16(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&a)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]),
                                            pack_bf16x2(a[4], a[5]), pack_bf16x2(a[6], a[7]));
}

// ---------------------------------------------------------------------------
// Multi-scale deformable attention (msda.cu, msda_bwd.cu)

constexpr int kMaxLevels = 8;

struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// The level table from (h, w) pairs; cudaErrorInvalidValue unless the levels
// fill S and one batch's [S, Hh, D] elements have int offsets.
inline int make_level_table(const int* level_hw, int n_levels, int S, int Hh, int D, LevelTable* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  int start = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  if (start != S || (long long)S * Hh * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  return 0;
}

// The level table copied into shared memory; every thread of the block calls
// this before any returns. Indexed by a level that differs between lanes, a
// kernel parameter compiles to a chain of constant-bank loads; a
// shared-memory read is one instruction.
__device__ __forceinline__ const LevelTable& shared_level_table(const LevelTable& param) {
  __shared__ LevelTable table;
  if (threadIdx.x < 3 * kMaxLevels)
    reinterpret_cast<int*>(&table)[threadIdx.x] = reinterpret_cast<const int*>(&param)[threadIdx.x];
  __syncthreads();
  return table;
}

// One bilinear corner of one sample. off: element offset of its value row
// within the (b, h) slice, 0 where the corner lies outside the map; ok: it
// lies inside; wgeom: its bilinear weight; a: the sample's attention weight.
struct Corner {
  int off, l;
  float a, tx, ty, wgeom;
  bool ok;
};

// Corner (lane % 4) of sample base + lane / 4 of a warp whose L*P = n samples
// start at loc_w / aw_w: eight samples per call, one corner a lane, read with
// one coalesced load of the warp. Validity is decided in float, so a far
// out-of-range location never becomes an int. Corner c is (x0 + (c & 1),
// y0 + (c >> 1)), as in the plain version (ops/deformable.py).
__device__ __forceinline__ Corner corner(int lane, int base, int n, int P, const LevelTable& lv,
                                         const float* __restrict__ loc_w, const float* __restrict__ aw_w,
                                         int row) {
  Corner e{0, 0, 0.f, 0.f, 0.f, 0.f, false};
  const int i = base + (lane >> 2), c = lane & 3;
  if (i < n) {
    const int l = i / P;
    const int hl = lv.h[l], wl = lv.w[l];
    // loc * size - 0.5 rounded after the product and again after the
    // difference, as the plain version and JAX compute it: contracted into
    // one FMA, a point within an ulp of a pixel edge falls in the other cell
    const float x = __fsub_rn(__fmul_rn(__ldg(loc_w + 2 * i), (float)wl), 0.5f);
    const float y = __fsub_rn(__fmul_rn(__ldg(loc_w + 2 * i + 1), (float)hl), 0.5f);
    const float xf = floorf(x), yf = floorf(y);
    const float cx = xf + (float)(c & 1), cy = yf + (float)(c >> 1);
    e.l = l;
    e.a = __ldg(aw_w + i);
    e.tx = x - xf;
    e.ty = y - yf;
    e.ok = cx >= 0.f && cx <= (float)(wl - 1) && cy >= 0.f && cy <= (float)(hl - 1);
    e.wgeom = ((c & 1) ? e.tx : 1.f - e.tx) * ((c >> 1) ? e.ty : 1.f - e.ty);
    if (e.ok) e.off = (lv.start[l] + (int)cy * wl + (int)cx) * row;
  }
  return e;
}

}  // namespace focoos
