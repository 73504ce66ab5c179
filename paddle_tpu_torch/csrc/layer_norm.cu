// Row LayerNorm forward and residual-add + LayerNorm forward for Hopper.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel (B5) and
// ::_add_ln_fwd_kernel (B6).
//
// What bounds it on the H100: bytes. Per row of D elements the kernel does
// ~8 flops per element against 2 (LN) or 4 (add-LN) element reads/writes, far
// below the ~20 flop/byte balance point of f32, so the floor is HBM traffic.
// Design: one thread block per row, f32 statistics from block-wide sums
// (mean, then mean((x - mean)^2), as the Pallas kernel), the row re-read from
// L1/L2 for the second and third passes instead of HBM (a 4 KB row of the
// serving shapes stays cache-resident between passes), and mean/rstd written
// as [R] f32 instead of the TPU's (R, 128) lane-broadcast.
//
// add-LN stores s = x + y in the input type first and normalizes the STORED
// (rounded) s -- bf16 parity with the dense x + y depends on it.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd, int D,
                  float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) acc += pt::to_f32(xr[i]);
  const float mean = pt::block_sum(acc, scratch) / D;

  acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = pt::to_f32(xr[i]) - mean;
    acc += c * c;
  }
  const float var = pt::block_sum(acc, scratch) / D;
  const float rs = 1.f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = (pt::to_f32(xr[i]) - mean) * rs;
    pt::store(yr + i, c * w[i] + b[i]);
  }
  if (threadIdx.x == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const float* __restrict__ w, const float* __restrict__ b,
                      T* __restrict__ s, T* __restrict__ y,
                      float* __restrict__ mu, float* __restrict__ rstd, int D,
                      float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  const T* rr = r + row * D;
  T* sr = s + row * D;
  T* yr = y + row * D;

  // pass 1: store the sum in the input type, accumulate the stored value.
  // Each thread later re-reads only the elements it wrote itself.
  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    pt::store(sr + i, pt::to_f32(xr[i]) + pt::to_f32(rr[i]));
    acc += pt::to_f32(sr[i]);
  }
  const float mean = pt::block_sum(acc, scratch) / D;

  acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = pt::to_f32(sr[i]) - mean;
    acc += c * c;
  }
  const float var = pt::block_sum(acc, scratch) / D;
  const float rs = 1.f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = (pt::to_f32(sr[i]) - mean) * rs;
    pt::store(yr + i, c * w[i] + b[i]);
  }
  if (threadIdx.x == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers; w and b are
// f32 [D]; x, y, s are [R, D] row-major of `dtype` (pt::kF32 / pt::kBF16);
// mu and rstd are f32 [R]. Returns cudaGetLastError() after the launch.
extern "C" int ln_fwd(const void* x, const void* w, const void* b, void* y,
                      void* mu, void* rstd, int R, int D, float eps, int dtype,
                      void* stream) {
  if (R <= 0 || D <= 0) return R < 0 || D < 0 ? cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* m = static_cast<float*>(mu);
  float* rs = static_cast<float*>(rstd);
  if (dtype == pt::kF32) {
    ln_fwd_kernel<float><<<R, kThreads, 0, st>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(y), m, rs,
        D, eps);
  } else if (dtype == pt::kBF16) {
    ln_fwd_kernel<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf,
        static_cast<__nv_bfloat16*>(y), m, rs, D, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int add_ln_fwd(const void* x, const void* r, const void* w,
                          const void* b, void* s, void* y, void* mu,
                          void* rstd, int R, int D, float eps, int dtype,
                          void* stream) {
  if (R <= 0 || D <= 0) return R < 0 || D < 0 ? cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* m = static_cast<float*>(mu);
  float* rs = static_cast<float*>(rstd);
  if (dtype == pt::kF32) {
    add_ln_fwd_kernel<float><<<R, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(r), wf, bf,
        static_cast<float*>(s), static_cast<float*>(y), m, rs, D, eps);
  } else if (dtype == pt::kBF16) {
    add_ln_fwd_kernel<__nv_bfloat16><<<R, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(r), wf, bf,
        static_cast<__nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(y), m, rs,
        D, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
