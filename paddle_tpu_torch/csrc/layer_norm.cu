// Row LayerNorm forward, residual-add + LayerNorm forward and LayerNorm
// backward for Hopper.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel (B5),
// ::_add_ln_fwd_kernel (B6) and ::_ln_bwd_kernel (B7, see ln_bwd_kernel).
//
// What bounds them on the H100: bytes. Per row of D elements a kernel does
// ~8 flops per element against 2 (LN) or 4 (add-LN) element reads/writes, far
// below the ~20 flop/byte balance point of f32, so the floor is HBM traffic.
// All keep f32 statistics, two-pass as the Pallas kernels (mean, then
// mean((x - mean)^2)), and write mean/rstd as [R] f32 instead of the TPU's
// (R, 128) lane-broadcast.
//
// B5 (ln_fwd_kernel) has to keep enough loads in flight to fill HBM, so one
// warp owns a row and the row sits in registers: for D = 128 kN each lane
// loads its 4 kN values once (16-byte loads for f32, 8-byte loads of 4
// values for bf16: kN loads in flight per lane before the first reduction),
// takes the mean and then the centred sum of squares from those registers
// with warp shuffles (no block barrier; in a fixed order, see
// ln_fwd_kernel), and writes y from them, with w and b in 16-byte loads that
// the block's warps share through L1. A block has 4 warps, one row each,
// and the grid at most as many blocks as fit on the card at once, whose
// warps then stride over the rows (the decode step's 8 rows are two blocks):
// float32 rows of 1024 take 121 registers a thread, so an SM holds 4 such
// blocks, and one row per warp over 4,096 rows would need a second wave of
// blocks. The register path takes kN in 1..8 and 16 (D 128 to 1024, and
// 2048); any other D, or x or y not aligned for the wide loads (a
// contiguous view at an offset), takes the looped path of the same kernel
// (kN = 0): three passes over the row, the second and third from L1/L2.
// ln_fwd_path says which path a call takes.
//
// B6 (add_ln_fwd_kernel) gives each row one thread block and block-wide sums
// (the row re-read from L1/L2 for the second and third passes).
//
// add-LN stores s = x + y in x's type first and normalizes the STORED
// (rounded) s -- bf16 parity with the dense x + y depends on it. The addends
// may differ in type: under AMP O1 the residual stream x is float32 and the
// attention branch y bfloat16 (or float16). Each addend is loaded in its own
// type and the sum taken in f32, as the Pallas kernel casts each to f32; s
// and LN(s) are stored in x's type. Instantiated for (f32, f32),
// (bf16, bf16), (f32, bf16) and (f32, f16): the pairs the router sends.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename TR>
__global__ void __launch_bounds__(kThreads)
    add_ln_fwd_kernel(const T* __restrict__ x, const TR* __restrict__ r,
                      const float* __restrict__ w, const float* __restrict__ b,
                      T* __restrict__ s, T* __restrict__ y,
                      float* __restrict__ mu, float* __restrict__ rstd, int D,
                      float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  const TR* rr = r + row * D;
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
//   dx = rstd * (g_hat - mean(g_hat) - x_hat * mean(g_hat * x_hat)),
//   dgamma = sum over rows of g * x_hat, dbeta = sum over rows of g.
// What bounds it on the H100: bytes (x and g read, dx written; ~10 flops per
// element). The kernel has to keep enough loads in flight to fill HBM, so
// one warp owns a row: its lanes read x and g once, with 16-byte loads (8
// for bf16), into registers, reduce the two means with warp shuffles (no
// block barrier per row) and write dx from registers. Warps stride over the
// rows in a grid of a few blocks per SM, each lane summing dgamma and dbeta
// of its columns in registers over its warp's rows; the block's warps
// combine them once, in shared memory, in warp order, into one [D] f32
// partial row per block. ln_bwd_reduce_kernel then sums the partial rows in
// block order and writes dweight and dbias: no atomics, deterministic.
//
// The register path takes D = 128 kN for kN <= 8 (each lane holds 4 kN
// values of x and of g, and 8 kN sums); any other D, or rows not
// aligned for the wide loads, takes the looped path of the same kernel
// (kN = 0): two passes over the row (the second from L1/L2) with the sums in
// each warp's own rows of shared memory.
constexpr int kBwdWarps = 8;  // warps per block, one row each at a time
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

// Row LayerNorm forward (B5): one warp a row, rows striding by the grid's
// warps. kN > 0: the register path for D = 128 kN; kN = 0: the looped path
// for any D.
//
// Both paths add in the order of a 256-thread block that sums its row with
// pt::block_sum, thread t adding columns t, t + 256, t + 512, ... in turn,
// as add_ln_fwd_kernel does: the row's sum and centred sum of squares, and
// so y, mu and rstd, are bit for bit those of that one-block-per-row design
// on either path. The two paths agree exactly on the same row, and a greedy
// token at a one-ulp tie does not move with the kernel's layout.
constexpr int kFwdWarps = 4;  // warps per block
// Blocks an SM must hold at once: a budget of 170 registers a thread, in
// which no instantiation spills (ptxas spilled float32 kN = 5 with the
// thread count alone, and float32 kN = 16 at 4 blocks, 128 registers).
constexpr int kFwdMinBlocks = 3;

// pt::block_sum's second stage on the 8 warp sums of a 256-thread block:
// lanes 0..7 hold them, the rest 0, and the xor shuffles add lanes 16 and 8
// (zeros), then 4, 2 and 1 apart.
__device__ __forceinline__ float block_order_total(const float (&ws)[8]) {
  float t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = ws[i] + 0.f;
  return ((t[0] + t[4]) + (t[2] + t[6])) + ((t[1] + t[5]) + (t[3] + t[7]));
}

// The register path's layout holds, in lane l, the whole share of the block
// threads t = 128 h + 4 l + e (h in 0..1, e in 0..3): p[h][e] is thread t's
// partial. Block warp 4 h + l / 8 is lanes 8 (l / 8) .. + 7, its lane
// 4 (l % 8) + e: its xor shuffles 16, 8 and 4 apart are this warp's 4, 2 and
// 1 apart, and 2 and 1 apart are within p[h][.].
__device__ __forceinline__ float block_order_sum(float (&p)[2][4]) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[h][e] += __shfl_xor_sync(0xffffffffu, p[h][e], o);
  float ws[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = (p[h][0] + p[h][2]) + (p[h][1] + p[h][3]);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ws[4 * h + g] = __shfl_sync(0xffffffffu, s, 8 * g);
  }
  return block_order_total(ws);
}

template <typename T, int kN>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mu, float* __restrict__ rstd, int R,
                  int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kFwdWarps;
  for (int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5); row < R;
       row += stride) {
    float mean, rs;
    if constexpr (kN > 0) {
      // column 128 j + 4 lane + e is block thread 128 (j % 2) + 4 lane + e's
      // (j / 2)-th
      const size_t off = (size_t)row * D + 4 * lane;
      float v[kN][4], p[2][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) load4(x + off + 128 * j, v[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[h][e] = 0.f;
#pragma unroll
          for (int j = h; j < kN; j += 2) p[h][e] += v[j][e];
        }
      mean = block_order_sum(p) / D;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[h][e] = 0.f;
#pragma unroll
          for (int j = h; j < kN; j += 2) {
            const float c = v[j][e] - mean;
            p[h][e] += c * c;
          }
        }
      rs = 1.f / sqrtf(block_order_sum(p) / D + eps);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float wv[4], bv[4], o[4];
        load4(w + 4 * lane + 128 * j, wv);
        load4(b + 4 * lane + 128 * j, bv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float c = (v[j][e] - mean) * rs;
          o[e] = c * wv[e] + bv[e];
        }
        store4(y + off + 128 * j, o);
      }
    } else {
      // lane l plays block thread 32 i + l of block warp i
      const T* xr = x + (size_t)row * D;
      T* yr = y + (size_t)row * D;
      float ws[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ws[i] = 0.f;
        for (int c = 32 * i + lane; c < D; c += 256)
          ws[i] += pt::to_f32(xr[c]);
        ws[i] = pt::warp_sum(ws[i]);
      }
      mean = block_order_total(ws) / D;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ws[i] = 0.f;
        for (int c = 32 * i + lane; c < D; c += 256) {
          const float d = pt::to_f32(xr[c]) - mean;
          ws[i] += d * d;
        }
        ws[i] = pt::warp_sum(ws[i]);
      }
      rs = 1.f / sqrtf(block_order_total(ws) / D + eps);
      for (int c = lane; c < D; c += 32) {
        const float d = (pt::to_f32(xr[c]) - mean) * rs;
        pt::store(yr + c, d * w[c] + b[c]);
      }
    }
    if (lane == 0) {
      mu[row] = mean;
      rstd[row] = rs;
    }
  }
}

template <typename T>
using LnFwdKernel = void (*)(const T*, const float*, const float*, T*,
                             float*, float*, int, int, float);

// kN of the register path for rows of D elements, or 0 (the looped path):
// D = 128 kN for kN in 1..8 or 16, and `wide` (x and y aligned for
// 4-element loads, w and b for 16-byte loads).
int ln_fwd_kn(int D, bool wide) {
  if (!wide || D % 128 != 0) return 0;
  const int kn = D / 128;
  return (kn <= 8 || kn == 16) ? kn : 0;
}

template <typename T>
LnFwdKernel<T> ln_fwd_pick(int kn) {
  switch (kn) {
    case 1: return ln_fwd_kernel<T, 1>;
    case 2: return ln_fwd_kernel<T, 2>;
    case 3: return ln_fwd_kernel<T, 3>;
    case 4: return ln_fwd_kernel<T, 4>;
    case 5: return ln_fwd_kernel<T, 5>;
    case 6: return ln_fwd_kernel<T, 6>;
    case 7: return ln_fwd_kernel<T, 7>;
    case 8: return ln_fwd_kernel<T, 8>;
    case 16: return ln_fwd_kernel<T, 16>;
  }
  return ln_fwd_kernel<T, 0>;
}

template <typename T>
bool ln_fwd_wide(const void* x, const void* w, const void* b, const void* y) {
  return ((uintptr_t)x | (uintptr_t)y) % (4 * sizeof(T)) == 0 &&
         ((uintptr_t)w | (uintptr_t)b) % 16 == 0;
}

// One row per warp, up to as many blocks as fit on the card at once.
template <typename T>
int launch_ln_fwd(const void* x, const float* w, const float* b, void* y,
                  float* mu, float* rs, int R, int D, float eps,
                  cudaStream_t st) {
  const LnFwdKernel<T> fn = ln_fwd_pick<T>(ln_fwd_kn(D, ln_fwd_wide<T>(
      x, w, b, y)));
  int per_sm = 0, dev = 0, n_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, 32 * kFwdWarps, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long rows = (R + kFwdWarps - 1) / kFwdWarps;
  const int blocks =
      (int)std::min(rows, (long long)std::max(per_sm, 1) * n_sm);
  fn<<<blocks, 32 * kFwdWarps, 0, st>>>(static_cast<const T*>(x), w, b,
                                        static_cast<T*>(y), mu, rs, R, D, eps);
  return cudaGetLastError();
}

// Shared memory: dgamma sums [n_warps][D], then dbeta sums [n_warps][D].
template <typename T, int kN>
__global__ void __launch_bounds__(kBwdWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ rstd,
                  const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ dw_part, float* __restrict__ db_part,
                  int R, int D) {
  extern __shared__ float part[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* sdw = part + (size_t)warp * D;
  float* sdb = part + (size_t)(n_warps + warp) * D;
  const int stride = gridDim.x * n_warps;

  if constexpr (kN > 0) {
    float dw[kN][4], db[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[j][e] = db[j][e] = 0.f;
    for (int row = blockIdx.x * n_warps + warp; row < R; row += stride) {
      const size_t off = (size_t)row * D + 4 * lane;
      float xh[kN][4], gv[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        load4(x + off + 128 * j, xh[j]);
        load4(g + off + 128 * j, gv[j]);
      }
      const float mean = mu[row], rs = rstd[row];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float wv[4];
        load4(w + 4 * lane + 128 * j, wv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xh[j][e] = (xh[j][e] - mean) * rs;
          const float gw = gv[j][e] * wv[e];
          s1 += gw;
          s2 += gw * xh[j][e];
        }
      }
      const float m1 = pt::warp_sum(s1) / D;
      const float m2 = pt::warp_sum(s2) / D;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float wv[4], o[4];
        load4(w + 4 * lane + 128 * j, wv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e] = rs * (gv[j][e] * wv[e] - m1 - xh[j][e] * m2);
          dw[j][e] += gv[j][e] * xh[j][e];
          db[j][e] += gv[j][e];
        }
        store4(dx + off + 128 * j, o);
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      store4(sdw + 128 * j + 4 * lane, dw[j]);
      store4(sdb + 128 * j + 4 * lane, db[j]);
    }
  } else {
    for (int i = lane; i < D; i += 32) sdw[i] = sdb[i] = 0.f;
    for (int row = blockIdx.x * n_warps + warp; row < R; row += stride) {
      const T* xr = x + (size_t)row * D;
      const T* gr = g + (size_t)row * D;
      const float mean = mu[row], rs = rstd[row];
      float s1 = 0.f, s2 = 0.f;
      for (int i = lane; i < D; i += 32) {
        const float xh = (pt::to_f32(xr[i]) - mean) * rs;
        const float gw = pt::to_f32(gr[i]) * w[i];
        s1 += gw;
        s2 += gw * xh;
      }
      const float m1 = pt::warp_sum(s1) / D;
      const float m2 = pt::warp_sum(s2) / D;
      T* dxr = dx + (size_t)row * D;
      for (int i = lane; i < D; i += 32) {
        const float xh = (pt::to_f32(xr[i]) - mean) * rs;
        const float gv = pt::to_f32(gr[i]);
        pt::store(dxr + i, rs * (gv * w[i] - m1 - xh * m2));
        sdw[i] += gv * xh;
        sdb[i] += gv;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < n_warps; ++k) {
      a += part[(size_t)k * D + i];
      b += part[(size_t)(n_warps + k) * D + i];
    }
    dw_part[(size_t)blockIdx.x * D + i] = a;
    db_part[(size_t)blockIdx.x * D + i] = b;
  }
}

// dweight[c] and dbias[c] = the sums over the n partial rows, in row order
// within each of 8 slices of rows, then slice order. A block takes 32
// columns (grid x) of dweight (grid y = 0) or dbias (y = 1).
constexpr int kReduceSlices = 8;

template <typename Tw>
__global__ void __launch_bounds__(32 * kReduceSlices)
    ln_bwd_reduce_kernel(const float* __restrict__ dw_part,
                         const float* __restrict__ db_part, int n, int D,
                         Tw* __restrict__ dweight, Tw* __restrict__ dbias) {
  __shared__ float sums[kReduceSlices][32];
  const int c = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + c;
  const float* src = blockIdx.y == 0 ? dw_part : db_part;
  float a = 0.f;
  if (col < D)
    for (int r = slice; r < n; r += kReduceSlices)
      a += src[(size_t)r * D + col];
  sums[slice][c] = a;
  __syncthreads();
  if (slice == 0 && col < D) {
    for (int k = 1; k < kReduceSlices; ++k) a += sums[k][c];
    pt::store((blockIdx.y == 0 ? dweight : dbias) + col, a);
  }
}

template <typename T>
using LnBwdKernel = void (*)(const T*, const float*, const float*,
                             const float*, const T*, T*, float*, float*, int,
                             int);

// The instantiation for rows of D elements: the register path when D is a
// multiple of 128 up to 1024 and `wide` (x, g, dx and w aligned for
// 4-element loads), else the looped path.
template <typename T>
LnBwdKernel<T> ln_bwd_pick(int D, bool wide) {
  if (wide && D % 128 == 0) {
    switch (D / 128) {
      case 1: return ln_bwd_kernel<T, 1>;
      case 2: return ln_bwd_kernel<T, 2>;
      case 3: return ln_bwd_kernel<T, 3>;
      case 4: return ln_bwd_kernel<T, 4>;
      case 5: return ln_bwd_kernel<T, 5>;
      case 6: return ln_bwd_kernel<T, 6>;
      case 7: return ln_bwd_kernel<T, 7>;
      case 8: return ln_bwd_kernel<T, 8>;
    }
  }
  return ln_bwd_kernel<T, 0>;
}

// Warps per block: kBwdWarps while their [2][n_warps][D] f32 sums fit in
// shared memory, fewer for wide rows; 0 when one warp's do not fit.
int ln_bwd_warps(int D) {
  return (int)std::min<long long>(kBwdWarps, kSmemMax / (8LL * D));
}

// Launch geometry: the kernel, its warps per block, dynamic shared memory,
// and the attribute that admits it; an error when D is too wide.
template <typename T>
cudaError_t ln_bwd_prepare(int D, bool wide, LnBwdKernel<T>* fn, int* nw,
                           size_t* smem) {
  *fn = ln_bwd_pick<T>(D, wide);
  *nw = ln_bwd_warps(D);
  if (*nw == 0) return cudaErrorInvalidValue;
  *smem = 8 * (size_t)*nw * D;
  return cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// Blocks of the grid: as many as fit on the card at once, at most one per
// n_warps rows.
template <typename T>
int ln_bwd_grid(int R, int D) {
  LnBwdKernel<T> fn;
  int nw, per_sm = 0, dev = 0, n_sm = 0;
  size_t smem;
  if (ln_bwd_prepare<T>(D, true, &fn, &nw, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * nw,
                                                    smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const long long rows = (R + (long long)nw - 1) / nw;
  const long long fit = (long long)std::max(per_sm, 1) * n_sm;
  return (int)std::max(1LL, std::min(rows, fit));
}

template <typename T>
int launch_ln_bwd(const void* x, const float* w, const float* mu,
                  const float* rs, const void* g, void* dx, float* dwp,
                  float* dbp, int R, int D, int n_blocks, cudaStream_t st) {
  // a lane's loads in the register path: 4 elements of x, g, dx; 4 of w
  const bool wide =
      ((uintptr_t)x | (uintptr_t)g | (uintptr_t)dx) % (4 * sizeof(T)) == 0 &&
      (uintptr_t)w % 16 == 0;
  LnBwdKernel<T> fn;
  int nw;
  size_t smem;
  cudaError_t e = ln_bwd_prepare<T>(D, wide, &fn, &nw, &smem);
  if (e != cudaSuccess) return e;
  fn<<<n_blocks, 32 * nw, smem, st>>>(
      static_cast<const T*>(x), w, mu, rs, static_cast<const T*>(g),
      static_cast<T*>(dx), dwp, dbp, R, D);
  return cudaGetLastError();
}

template <typename Tw>
int launch_ln_bwd_reduce(const float* dwp, const float* dbp, int n, int D,
                         void* dweight, void* dbias, cudaStream_t st) {
  ln_bwd_reduce_kernel<Tw><<<dim3((D + 31) / 32, 2), 32 * kReduceSlices, 0,
                             st>>>(dwp, dbp, n, D, static_cast<Tw*>(dweight),
                                   static_cast<Tw*>(dbias));
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Pointers are device pointers; w and b are
// f32 [D]; x, y, s are [R, D] row-major of `dtype` (pt::kF32 / pt::kBF16);
// mu and rstd are f32 [R]. Returns cudaGetLastError() after the launch.
//
// ln_fwd_path returns the kN of B5's register path that a call on these
// pointers would take (D = 128 kN), 0 for the looped path, -1 for an
// unknown dtype.
extern "C" int ln_fwd(const void* x, const void* w, const void* b, void* y,
                      void* mu, void* rstd, int R, int D, float eps, int dtype,
                      void* stream) {
  if (R <= 0 || D <= 0) return R < 0 || D < 0 ? cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* m = static_cast<float*>(mu);
  float* rs = static_cast<float*>(rstd);
  if (dtype == pt::kF32)
    return launch_ln_fwd<float>(x, wf, bf, y, m, rs, R, D, eps, st);
  if (dtype == pt::kBF16)
    return launch_ln_fwd<__nv_bfloat16>(x, wf, bf, y, m, rs, R, D, eps, st);
  return cudaErrorInvalidValue;
}

extern "C" int ln_fwd_path(const void* x, const void* w, const void* b,
                           const void* y, int D, int dtype) {
  if (dtype == pt::kF32) return ln_fwd_kn(D, ln_fwd_wide<float>(x, w, b, y));
  if (dtype == pt::kBF16)
    return ln_fwd_kn(D, ln_fwd_wide<__nv_bfloat16>(x, w, b, y));
  return -1;
}

template <typename T, typename TR>
static void launch_add_ln_fwd(const void* x, const void* r, const float* w,
                              const float* b, void* s, void* y, float* mu,
                              float* rstd, int R, int D, float eps,
                              cudaStream_t st) {
  add_ln_fwd_kernel<T, TR><<<R, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const TR*>(r), w, b,
      static_cast<T*>(s), static_cast<T*>(y), mu, rstd, D, eps);
}

// x, s and y are [R, D] of `dtype`, r [R, D] of `rdtype`; the pairs taken
// are (f32, f32), (bf16, bf16), (f32, bf16) and (f32, f16).
extern "C" int add_ln_fwd(const void* x, const void* r, const void* w,
                          const void* b, void* s, void* y, void* mu,
                          void* rstd, int R, int D, float eps, int dtype,
                          int rdtype, void* stream) {
  if (R <= 0 || D <= 0) return R < 0 || D < 0 ? cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* m = static_cast<float*>(mu);
  float* rs = static_cast<float*>(rstd);
  if (dtype == pt::kF32 && rdtype == pt::kF32) {
    launch_add_ln_fwd<float, float>(x, r, wf, bf, s, y, m, rs, R, D, eps, st);
  } else if (dtype == pt::kBF16 && rdtype == pt::kBF16) {
    launch_add_ln_fwd<__nv_bfloat16, __nv_bfloat16>(x, r, wf, bf, s, y, m, rs,
                                                    R, D, eps, st);
  } else if (dtype == pt::kF32 && rdtype == pt::kBF16) {
    launch_add_ln_fwd<float, __nv_bfloat16>(x, r, wf, bf, s, y, m, rs, R, D,
                                            eps, st);
  } else if (dtype == pt::kF32 && rdtype == pt::kF16) {
    launch_add_ln_fwd<float, __half>(x, r, wf, bf, s, y, m, rs, R, D, eps,
                                     st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x, g and dx are [R, D] of `dtype`; w, mu and rstd f32 ([D], [R], [R]);
// dw_part and db_part f32 [n_blocks, D] scratch, n_blocks from
// ln_bwd_blocks(R, D, dtype); dweight and dbias [D] of `wdtype`. Launches
// the row kernel, then the reduction of the partial rows; returns
// cudaGetLastError() after them. ln_bwd_blocks returns -1 when D is too wide
// for the kernel (or the card cannot be queried).
extern "C" int ln_bwd_blocks(int R, int D, int dtype) {
  if (R <= 0 || D <= 0) return -1;
  if (dtype == pt::kF32) return ln_bwd_grid<float>(R, D);
  if (dtype == pt::kBF16) return ln_bwd_grid<__nv_bfloat16>(R, D);
  return -1;
}

extern "C" int ln_bwd(const void* x, const void* w, const void* mu,
                      const void* rstd, const void* g, void* dx, void* dw_part,
                      void* db_part, void* dweight, void* dbias, int R, int D,
                      int n_blocks, int dtype, int wdtype, void* stream) {
  if (R <= 0 || D <= 0 || n_blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* m = static_cast<const float*>(mu);
  const float* rs = static_cast<const float*>(rstd);
  float* dwp = static_cast<float*>(dw_part);
  float* dbp = static_cast<float*>(db_part);
  int e;
  if (dtype == pt::kF32)
    e = launch_ln_bwd<float>(x, wf, m, rs, g, dx, dwp, dbp, R, D, n_blocks,
                             st);
  else if (dtype == pt::kBF16)
    e = launch_ln_bwd<__nv_bfloat16>(x, wf, m, rs, g, dx, dwp, dbp, R, D,
                                     n_blocks, st);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  if (wdtype == pt::kF32)
    return launch_ln_bwd_reduce<float>(dwp, dbp, n_blocks, D, dweight, dbias,
                                       st);
  if (wdtype == pt::kBF16)
    return launch_ln_bwd_reduce<__nv_bfloat16>(dwp, dbp, n_blocks, D, dweight,
                                               dbias, st);
  return cudaErrorInvalidValue;
}
