// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Element types the wrappers pass in: 0 = float32, 1 = bfloat16.
enum ElemType : int { ELEM_F32 = 0, ELEM_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Dynamic shared memory above the 48 KB default must be opted into per
// kernel; the attribute is set only when a launch needs it.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// gridDim.y is capped at 65,535: a grid whose y counts column blocks (K4)
// or row blocks (K5) is launched once for each 65,535 of them, the kernel
// taking the first.
constexpr long long kMaxGridY = 65535;
