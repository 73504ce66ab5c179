// Row LayerNorm forward, residual-add + LayerNorm forward and LayerNorm
// backward for Hopper.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel (B5),
// ::_add_ln_fwd_kernel (B6) and ::_ln_bwd_kernel (B7, see ln_bwd_kernel).
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

// Backward of the row LayerNorm (B7), in the recompute form of
// paddle_tpu/ops/pallas/layer_norm.py::_ln_bwd_kernel: x_hat comes back from
// the saved (mean, rstd), and with g_hat = g * w
//   dx = rstd * (g_hat - mean(g_hat) - x_hat * mean(g_hat * x_hat)).
// Bound by bytes like the forward (x and g read, dx written). One block owns
// kBwdRows consecutive rows: per row, two block sums, then dx; the block's
// dgamma = sum(g * x_hat) and dbeta = sum(g) over its rows collect in shared
// memory (each thread only ever touches its own columns, so no atomics) and
// are written as one [D] f32 row of the [n_blocks, D] partials. The sum over
// blocks runs outside the kernel, as in the JAX package, and is
// deterministic.
constexpr int kBwdRows = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ rstd,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  int R, int D) {
  extern __shared__ float part[];  // [2][D]: dgamma, dbeta of this block
  __shared__ float scratch[32];
  float* dw = part;
  float* db = part + D;
  for (int i = threadIdx.x; i < D; i += kThreads) dw[i] = db[i] = 0.f;

  const int r0 = blockIdx.x * kBwdRows;
  const int r1 = min(r0 + kBwdRows, R);
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (size_t)row * D;
    const T* gr = g + (size_t)row * D;
    const float mean = mu[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xh = (pt::to_f32(xr[i]) - mean) * rs;
      const float gw = pt::to_f32(gr[i]) * w[i];
      s1 += gw;
      s2 += gw * xh;
    }
    const float m1 = pt::block_sum(s1, scratch) / D;
    const float m2 = pt::block_sum(s2, scratch) / D;
    T* dxr = dx + (size_t)row * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float xh = (pt::to_f32(xr[i]) - mean) * rs;
      const float gv = pt::to_f32(gr[i]);
      pt::store(dxr + i, rs * (gv * w[i] - m1 - xh * m2));
      dw[i] += gv * xh;
      db[i] += gv;
    }
  }
  for (int i = threadIdx.x; i < D; i += kThreads) {
    dw_part[(size_t)blockIdx.x * D + i] = dw[i];
    db_part[(size_t)blockIdx.x * D + i] = db[i];
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

// x, g and dx are [R, D] of `dtype`; w, mu and rstd f32 ([D], [R], [R]);
// dw_part and db_part f32 [ceil(R / 16), D] (ln_bwd_rows() rows per block).
extern "C" int ln_bwd_rows() { return kBwdRows; }

extern "C" int ln_bwd(const void* x, const void* w, const void* mu,
                      const void* rstd, const void* g, void* dx, void* dw_part,
                      void* db_part, int R, int D, int dtype, void* stream) {
  if (R <= 0 || D <= 0) return R < 0 || D < 0 ? cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (R + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * sizeof(float) * (size_t)D;
  const float* wf = static_cast<const float*>(w);
  const float* m = static_cast<const float*>(mu);
  const float* rs = static_cast<const float*>(rstd);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
  cudaError_t e;
  if (dtype == pt::kF32) {
    e = cudaFuncSetAttribute(ln_bwd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    ln_bwd_kernel<float><<<n, kThreads, smem, st>>>(
        static_cast<const float*>(x), wf, m, rs, static_cast<const float*>(g),
        static_cast<float*>(dx), dwp, dbp, R, D);
  } else if (dtype == pt::kBF16) {
    e = cudaFuncSetAttribute(ln_bwd_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    ln_bwd_kernel<__nv_bfloat16><<<n, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), wf, m, rs,
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx),
        dwp, dbp, R, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
