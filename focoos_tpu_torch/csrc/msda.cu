// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces: focoos_tpu/ops/pallas/msda.py, msda_pallas (pallas_call at :132,
// body _msda_level_kernel :37). Semantics: focoos_tpu/ops/deformable.py:59
// ms_deform_attn: for each (batch b, query q, head h),
//   out[b, q, h*D + d] = sum_{l, p} aw[b,q,h,l,p] * bilinear(value_l[:, :, h, d], loc[b,q,h,l,p])
// with zeros padding, align_corners=False (pixel = loc * size - 0.5).
//
// What bounds it on this card: bytes. Each (b, q, h) reads L*P*4 rows of D
// values at data-dependent positions and does two FMAs per value read; at the
// main-path shape (B=16, S=8400, Hh*D=256, fp32) the value tensor is 138 MB,
// larger than the 50 MB L2, and the rows the samples touch (about 60% for
// uniform locations) come from HBM once if the L2 keeps them between queries.
// There is nothing for the tensor cores to do. What keeps a simple kernel
// from that bound is latency: a chain of scattered reads with few in flight.
//
// Design: one warp per (b, q, h). Vector path (D * sizeof(T) = 16, 32, 64
// or 128 bytes and a 16-byte aligned value):
// - A value row is read by R = D * sizeof(T) / 16 lanes with 16-byte loads,
//   so one load instruction of the warp fetches G = 32 / R rows: the four
//   corners of G / 4 samples (D=32: fp32 one sample, bf16 two).
// - The warp's loc and aw are read once, coalesced, eight samples at a time:
//   lane j works out corner j % 4 of sample j / 4 (its row offset, and
//   aw * bilinear weight; a corner outside the map reads row 0 of the slice
//   with weight 0), and __shfl_sync hands each load its (offset, weight).
// - No branch around a load: a round's loads depend on nothing but the
//   shuffles, so they are in flight together. Reading an invalid corner's
//   row 0 (an L2 hit) measured faster than skipping the load.
// - The level table is read from shared memory: indexed by a level that
//   differs between lanes, the kernel parameter compiles to a chain of
//   constant-bank loads each round.
// - Each lane accumulates its 16 bytes of channels in fp32; one shuffle
//   reduction over the G row groups at the end, one 16-byte store per lane.
// General path (any D, any alignment): the lanes over D, scalar loads, the
// same clamped, branch-free corners. ops/msda.py picks the path and counts it.
// Nothing but the [B, Lq, Hh*D] output is written: the intermediates that
// the TPU kernel kept in VMEM never exist. The Pallas kernel's row-one-hot
// matmul is a trick for the MXU, which cannot gather; the card gathers
// directly from the flat [B, S, Hh, D] projection of the encoder memory,
// with per-level start offsets passed by value, so no per-level copy is made.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
using focoos::LevelTable;

template <typename T, int R>  // R lanes per value row, 16 bytes each
__global__ void __launch_bounds__(kThreads) msda_forward_vector(
    const T* __restrict__ value,    // [B, S, Hh, D], 16-byte aligned
    const float* __restrict__ loc,  // [B, Lq, Hh, L, P, 2] (x, y) in [0, 1]
    const float* __restrict__ aw,   // [B, Lq, Hh, L, P]
    T* __restrict__ out,            // [B, Lq, Hh * D]
    LevelTable lv_param, int n_warps, int S, int Lq, int Hh, int L, int P) {
  constexpr int kVec = 16 / sizeof(T);  // channels per lane
  constexpr int D = R * kVec;
  constexpr int G = 32 / R;  // value rows per load instruction
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave: the shuffles below see 32 lanes
  // warp = (b * Lq + q) * Hh + h: the loc/aw rows of this warp are contiguous
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const int n = L * P;
  const float* loc_w = loc + (size_t)warp * n * 2;
  const float* aw_w = aw + (size_t)warp * n;
  const int row = Hh * D;  // elements between two spatial positions
  const T* vb = value + ((size_t)b * S * Hh + h) * D + (lane % R) * kVec;

  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  for (int base = 0; base < n; base += 8) {
    const focoos::Corner e = focoos::corner(lane, base, n, P, lv, loc_w, aw_w, row);
    const float w_e = e.ok ? e.a * e.wgeom : 0.f;
    uint4 v[R];
    float w[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {  // all loads first
      const int src = k * G + lane / R;  // the lane that holds this row's corner
      const int off = __shfl_sync(0xffffffffu, e.off, src);
      w[k] = __shfl_sync(0xffffffffu, w_e, src);
      v[k] = __ldg(reinterpret_cast<const uint4*>(vb + off));
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float f[kVec];
      focoos::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = fmaf(w[k], f[j], acc[j]);
    }
  }
#pragma unroll
  for (int o = R; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < R) focoos::store16(out + (size_t)warp * D + lane * kVec, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) msda_forward_general(
    const T* __restrict__ value, const float* __restrict__ loc, const float* __restrict__ aw,
    T* __restrict__ out, LevelTable lv_param, int n_warps, int S, int Lq, int Hh, int D, int L, int P) {
  const LevelTable& lv = focoos::shared_level_table(lv_param);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int h = warp % Hh;
  const int b = warp / (Hh * Lq);
  const int n = L * P;
  const float* loc_w = loc + (size_t)warp * n * 2;
  const float* aw_w = aw + (size_t)warp * n;
  const int row = Hh * D;
  const T* vb = value + ((size_t)b * S * Hh + h) * D;

  for (int d = lane; d - lane < D; d += 32) {
    const int dc = d < D ? d : 0;  // a lane past D reads channel 0 and stores nothing
    float acc = 0.f;
    for (int base = 0; base < n; base += 8) {
      const focoos::Corner e = focoos::corner(lane, base, n, P, lv, loc_w, aw_w, row);
      const float w_e = e.ok ? e.a * e.wgeom : 0.f;
      const int m = min(32, 4 * (n - base));  // corner entries of this round
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        const int off = __shfl_sync(0xffffffffu, e.off, k);
        acc = fmaf(__shfl_sync(0xffffffffu, w_e, k), focoos::load_f32(vb + off + dc), acc);
      }
    }
    if (d < D) focoos::store_f32(out + (size_t)warp * D + d, acc);
  }
}

template <typename T>
int launch(bool vector, const void* value, const void* loc, const void* aw, void* out,
           const LevelTable& lv, int n_warps, int S, int Lq, int Hh, int D, int L, int P,
           cudaStream_t st) {
  const unsigned blocks = (unsigned)(((long long)n_warps * 32 + kThreads - 1) / kThreads);
  const T* v = static_cast<const T*>(value);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  T* o = static_cast<T*>(out);
  if (!vector) {
    msda_forward_general<T><<<blocks, kThreads, 0, st>>>(v, l, a, o, lv, n_warps, S, Lq, Hh, D, L, P);
    return (int)cudaGetLastError();
  }
  if ((reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int row_bytes = D * (int)sizeof(T);
  switch (row_bytes % 16 == 0 ? row_bytes / 16 : 0) {
    case 1: msda_forward_vector<T, 1><<<blocks, kThreads, 0, st>>>(v, l, a, o, lv, n_warps, S, Lq, Hh, L, P); break;
    case 2: msda_forward_vector<T, 2><<<blocks, kThreads, 0, st>>>(v, l, a, o, lv, n_warps, S, Lq, Hh, L, P); break;
    case 4: msda_forward_vector<T, 4><<<blocks, kThreads, 0, st>>>(v, l, a, o, lv, n_warps, S, Lq, Hh, L, P); break;
    case 8: msda_forward_vector<T, 8><<<blocks, kThreads, 0, st>>>(v, l, a, o, lv, n_warps, S, Lq, Hh, L, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vector: 1 for the vector path (D * sizeof(T) in {16, 32, 64, 128}, value 16-byte aligned), 0 for the general path
extern "C" int msda_forward(const void* value, const void* loc, const void* aw, void* out,
                            const int* level_hw, int n_levels, int B, int S, int Lq, int Hh,
                            int D, int P, int dtype, int vector, void* stream) {
  LevelTable lv;
  const int err = focoos::make_level_table(level_hw, n_levels, S, Hh, D, &lv);
  if (err != 0) return err;
  const long long n_warps = (long long)B * Lq * Hh;
  if (n_warps == 0) return (int)cudaSuccess;
  if (n_warps > (1LL << 26) || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == focoos::kFloat32)
    return launch<float>(vector != 0, value, loc, aw, out, lv, (int)n_warps, S, Lq, Hh, D, n_levels, P, st);
  if (dtype == focoos::kBFloat16)
    return launch<__nv_bfloat16>(vector != 0, value, loc, aw, out, lv, (int)n_warps, S, Lq, Hh, D, n_levels, P, st);
  return (int)cudaErrorInvalidValue;
}
