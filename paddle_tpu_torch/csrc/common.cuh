// Helpers shared by the port's kernels: f32 <-> storage-type conversion and
// a block-wide sum. Every kernel computes in f32 and stores in the input
// type (float, __nv_bfloat16 or __half), as the Pallas kernels they replace
// do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace pt {

// dtype codes passed through the C interface (see ops/kernels/_build.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round-to-nearest-even store in the storage type
__device__ __forceinline__ float from_f32(float x, const float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x,
                                                  const __nv_bfloat16*) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ __half from_f32(float x, const __half*) {
  return __float2half_rn(x);
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v) {
  *p = from_f32(v, p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of one float per thread over the whole block; every thread gets the
// result. `scratch` holds 32 floats of shared memory. blockDim.x must be a
// multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : 0.f;
  return warp_sum(v);
}

}  // namespace pt
