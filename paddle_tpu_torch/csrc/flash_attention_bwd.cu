// Flash-attention backward for Hopper: dQ (B3) and dK/dV (B4) of
// softmax(q k^T * scale [+ causal mask]) v, in the recompute form
// (FlashAttention-2): p = exp(s - lse) from the forward's lse, and
// ds = p * (dp - delta) * scale with dp = dO v^T and delta = rowsum(dO * O)
// computed by the caller.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_dq_kernel (B3) and
// ::_dkv_kernel (B4). As on the TPU they are two kernels, so that every output
// tile has exactly one owner: no atomics, and the result is deterministic.
//   dq:  one block per (batch*head, 64 query rows), looping over the key tiles
//        those rows can see: dq = sum_k ds k.
//   dkv: one block per (batch*head, 64 keys), looping over the query tiles
//        that can see them: dv = sum_q p^T dO, dk = sum_q ds^T q.
// The loops inside the block replace the TPU's sequential grid axis, and the
// f32 accumulators live in registers instead of VMEM scratch.
//
// What bounds it on the H100: operations. Per visible (query, key) pair dq
// does 3 and dkv 4 dot products of length D (~6D and ~8D flops) against a few
// bytes per pair, far above the f32 balance point. This first version runs
// the products on the f32 SIMT units (67 TFLOP/s peak), not the tensor cores.
// Its design keeps the SIMT units fed from shared memory: a block of 256
// threads is a 16 x 16 grid, and thread (ty, tx) owns rows ty + 16i and
// columns tx + 16j of every 64-wide tile product, a 4 x 4 (or 4 x 8 at
// D = 128) register tile, so each pair of shared-memory loads feeds 2-4 FMAs
// instead of one. Tiles are padded by one float per row, which keeps the
// transposed reads free of bank conflicts. No score, probability or ds tile
// ever reaches device memory.
//
// Conventions kept from the Pallas kernels: a masked score is -1e30 and p is
// forced to 0 wherever s <= -1e30 / 2 (fully masked rows have lse == -1e30
// too, where exp(s - lse) would be 1); the causal mask compares global
// positions, kv_offset + key > q_offset + row; inputs are read in their type
// (f32 or bf16), all math is f32, and each output is rounded once. Tiles that
// the causal mask hides entirely are skipped.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;     // a 16 x 16 grid of threads
constexpr int kTile = 64;         // query rows and keys per tile
constexpr int kLdS = kTile + 1;   // padded row of a [kTile][kTile] tile

// Shared-memory floats of one [kTile][kD] operand tile, rows padded by one.
template <int kD>
__host__ __device__ constexpr int tile_floats() {
  return kTile * (kD + 1);
}

// dst[r][d] = src[row0 + r][d] as f32; rows >= n_rows and columns >= D are 0.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int n_rows, int D) {
  constexpr int kLd = kD + 1;
  for (int i = threadIdx.x; i < kTile * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const int row = row0 + r;
    dst[r * kLd + d] =
        (row < n_rows && d < D) ? pt::to_f32(src[(size_t)row * D + d]) : 0.f;
  }
}

// s[i][j] = q[ty+16i] . k[tx+16j] and dp[i][j] = dO[ty+16i] . v[tx+16j]:
// the score tile and dO v^T, both [query][key].
template <int kD>
__device__ __forceinline__ void score_tiles(const float* qs, const float* ks,
                                            const float* dos, const float* vs,
                                            float (&s)[4][4], float (&dp)[4][4],
                                            int ty, int tx) {
  constexpr int kLd = kD + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * kLd + d];
      c[i] = dos[(ty + 16 * i) * kLd + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ks[(tx + 16 * j) * kLd + d];
      e[j] = vs[(tx + 16 * j) * kLd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * b[j];
        dp[i][j] += c[i] * e[j];
      }
  }
}

// p and ds of the thread's 4 x 4 (query, key) entries, written to the shared
// [query][key] tiles ps (when given) and dss.
__device__ __forceinline__ void probs_and_ds(
    const float (&s)[4][4], const float (&dp)[4][4], const float (&lse)[4],
    const float (&delta)[4], float* ps, float* dss, int q0, int k0, int ty,
    int tx, int S, int Sk, float scale, int causal, int q_offset,
    int kv_offset) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      float sc = s[i][j] * scale;
      if (row >= S || key >= Sk ||
          (causal && kv_offset + key > q_offset + row))
        sc = kNeg;
      const float p = sc <= kNeg * 0.5f ? 0.f : expf(sc - lse[i]);
      const int at = (ty + 16 * i) * kLdS + tx + 16 * j;
      if (ps != nullptr) ps[at] = p;
      dss[at] = p * (dp[i][j] - delta[i]) * scale;
    }
  }
}

// acc[i][j] += sum_k A(ty+16i, k) * B(k, tx+16j) over k < kTile, with
// A(m, k) = a[m * a_m + k * a_k] and B(k, n) = b[k * (kD + 1) + n].
template <int kD>
__device__ __forceinline__ void accumulate(float (&acc)[4][kD / 16],
                                           const float* a, int a_m, int a_k,
                                           const float* b, int ty, int tx) {
  constexpr int kLd = kD + 1;
  constexpr int kN = kD / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float x[4], y[kN];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * a_m + k * a_k];
#pragma unroll
    for (int j = 0; j < kN; ++j) y[j] = b[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] += x[i] * y[j];
  }
}

// out[row0 + ty + 16i][tx + 16j] = acc[i][j], rounded once to T.
template <typename T, int kD>
__device__ __forceinline__ void store_tile(T* __restrict__ out,
                                           const float (&acc)[4][kD / 16],
                                           int row0, int n_rows, int D, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      const int col = tx + 16 * j;
      if (col < D) pt::store(out + (size_t)row * D + col, acc[i][j]);
    }
  }
}

template <int kD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * tile_floats<kD>() + kTile * kLdS);
}

template <int kD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * tile_floats<kD>() + 2 * kTile * kLdS + 2 * kTile);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S,
                    int Sk, int D, float scale, int causal, int q_offset,
                    int kv_offset) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + tile_floats<kD>();
  float* ks = dos + tile_floats<kD>();
  float* vs = ks + tile_floats<kD>();
  float* dss = vs + tile_floats<kD>();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;
  load_tile<T, kD>(qs, q + bh * S * D, q0, S, D);
  load_tile<T, kD>(dos, dout + bh * S * D, q0, S, D);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[bh * S + row] : 0.f;
  }

  // key tiles these rows can see at all (_dq_kernel's `visible`)
  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) {
    const int last_key = q_offset + min(q0 + kTile, S) - 1 - kv_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kTile + 1);
  }

  float acc[4][kD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's ks and dss are consumed
    load_tile<T, kD>(ks, kh, k0, Sk, D);
    load_tile<T, kD>(vs, vh, k0, Sk, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles<kD>(qs, ks, dos, vs, s, dp, ty, tx);
    probs_and_ds(s, dp, lse_r, delta_r, nullptr, dss, q0, k0, ty, tx, S, Sk,
                 scale, causal, q_offset, kv_offset);
    __syncthreads();
    accumulate<kD>(acc, dss, kLdS, 1, ks, ty, tx);  // dq += ds k
  }
  store_tile<T, kD>(dq + bh * S * D, acc, q0, S, D, ty, tx);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int D, float scale,
                     int causal, int q_offset, int kv_offset) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile_floats<kD>();
  float* qs = vs + tile_floats<kD>();
  float* dos = qs + tile_floats<kD>();
  float* ps = dos + tile_floats<kD>();
  float* dss = ps + kTile * kLdS;
  float* lse_s = dss + kTile * kLdS;
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const T* qh = q + bh * S * D;
  const T* doh = dout + bh * S * D;
  load_tile<T, kD>(ks, k + bh * Sk * D, k0, Sk, D);
  load_tile<T, kD>(vs, v + bh * Sk * D, k0, Sk, D);

  float dk_acc[4][kD / 16], dv_acc[4][kD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (S + kTile - 1) / kTile;
  for (int t = 0; t < n_q; ++t) {
    const int q0 = t * kTile;
    // _dkv_kernel's `visible`: the tile's last query position is at or past
    // this block's first key (uniform over the block)
    if (causal && q_offset + q0 + kTile - 1 < kv_offset + k0) continue;
    __syncthreads();  // the previous tile's qs, dos, ps and dss are consumed
    load_tile<T, kD>(qs, qh, q0, S, D);
    load_tile<T, kD>(dos, doh, q0, S, D);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = q0 + r;
      lse_s[r] = row < S ? lse[bh * S + row] : 0.f;
      delta_s[r] = row < S ? delta[bh * S + row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4], lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lse_r[i] = lse_s[ty + 16 * i];
      delta_r[i] = delta_s[ty + 16 * i];
    }
    score_tiles<kD>(qs, ks, dos, vs, s, dp, ty, tx);
    probs_and_ds(s, dp, lse_r, delta_r, ps, dss, q0, k0, ty, tx, S, Sk, scale,
                 causal, q_offset, kv_offset);
    __syncthreads();
    // [key][col] outputs: A(key, row) is the transposed [row][key] tile
    accumulate<kD>(dv_acc, ps, 1, kLdS, dos, ty, tx);   // dv += p^T dO
    accumulate<kD>(dk_acc, dss, 1, kLdS, qs, ty, tx);   // dk += ds^T q
  }
  store_tile<T, kD>(dk + bh * Sk * D, dk_acc, k0, Sk, D, ty, tx);
  store_tile<T, kD>(dv + bh * Sk * D, dv_acc, k0, Sk, D, ty, tx);
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int S,
              int Sk, int D, float scale, int causal, int q_offset,
              int kv_offset, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_dq_kernel<T, kD><<<dim3(BH, (S + kTile - 1) / kTile), kThreads, smem,
                           st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, Sk, D, scale, causal, q_offset, kv_offset);
  return cudaGetLastError();
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BH,
               int S, int Sk, int D, float scale, int causal, int q_offset,
               int kv_offset, cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_dkv_kernel<T, kD><<<dim3(BH, (Sk + kTile - 1) / kTile), kThreads,
                            smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, D, scale, causal,
      q_offset, kv_offset);
  return cudaGetLastError();
}

bool bad_shape(int BH, int S, int Sk, int D) {
  return BH < 0 || S < 0 || Sk < 0 || D <= 0 || D > 128 ||
         (S + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535;
}

}  // namespace

// C interface (bound with ctypes). q, dout and dq are [BH, S, D]; k, v, dk and
// dv [BH, Sk, D], all row-major of `dtype` (pt::kF32 / pt::kBF16); lse and
// delta are f32 [BH, S]. Head dims up to 128 (tiles of 64 or 128 columns,
// zero-padded). Each returns cudaGetLastError() after its one launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int S, int Sk,
                            int D, float scale, int causal, int q_offset,
                            int kv_offset, int dtype, void* stream) {
  if (bad_shape(BH, S, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DQ(T, KD)                                                        \
  return launch_dq<T, KD>(q, k, v, dout, lse, delta, dq, BH, S, Sk, D,     \
                          scale, causal, q_offset, kv_offset, st)
  if (dtype == pt::kF32) {
    if (D <= 64) PT_DQ(float, 64);
    PT_DQ(float, 128);
  }
  if (dtype == pt::kBF16) {
    if (D <= 64) PT_DQ(__nv_bfloat16, 64);
    PT_DQ(__nv_bfloat16, 128);
  }
#undef PT_DQ
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int BH,
                             int S, int Sk, int D, float scale, int causal,
                             int q_offset, int kv_offset, int dtype,
                             void* stream) {
  if (bad_shape(BH, S, Sk, D)) return cudaErrorInvalidValue;
  if (BH == 0 || Sk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_DKV(T, KD)                                                        \
  return launch_dkv<T, KD>(q, k, v, dout, lse, delta, dk, dv, BH, S, Sk, D, \
                           scale, causal, q_offset, kv_offset, st)
  if (dtype == pt::kF32) {
    if (D <= 64) PT_DKV(float, 64);
    PT_DKV(float, 128);
  }
  if (dtype == pt::kBF16) {
    if (D <= 64) PT_DKV(__nv_bfloat16, 64);
    PT_DKV(__nv_bfloat16, 128);
  }
#undef PT_DKV
  return cudaErrorInvalidValue;
}
