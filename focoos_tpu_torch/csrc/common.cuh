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

namespace focoos {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

}  // namespace focoos
