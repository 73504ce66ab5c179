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
// What bounds them on the H100: operations. Per visible (query, key) pair dq
// does 3 and dkv 4 dot products of length D (~6D and ~8D flops) against a few
// bytes per pair, far above the balance point.
//
// dkv runs its four products on the tensor cores (csrc/mma.cuh), float32
// through 3xTF32 and bf16 K Q^T / V dO^T through bf16 mma.sync; p and ds stay
// f32 and are split for the products they feed (two passes with a bf16
// operand). Four warps own 16 keys each, keys being the M dimension of
//   S^T = K Q^T and dP^T = V dO^T  (A from the block's k and v tiles),
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale,
//   dV += P^T dO and dK += dS^T Q  (P^T and dS^T fed from registers),
// so no probability or ds tile touches shared memory. k and v stay in shared
// memory for the whole loop; q and dO tiles, with their lse and delta, stream
// through a two-stage cp.async ring, the next tile's copy in flight while this
// one is multiplied. Blocks of the first key tiles, which the most query tiles
// see under the causal mask, are launched first (grid y in key order).
//
// dq (B3) still runs on the f32 SIMT units: a block of 256 threads is a
// 16 x 16 grid, and thread (ty, tx) owns rows ty + 16i and columns tx + 16j of
// every 64-wide tile product, a 4 x 4 (or 4 x 8 at D = 128) register tile, so
// each pair of shared-memory loads feeds 2-4 FMAs instead of one. Tiles are
// padded by one float per row, which keeps the transposed reads free of bank
// conflicts.
//
// Conventions kept from the Pallas kernels: a masked score is -1e30 and p is
// forced to 0 wherever s <= -1e30 / 2, i.e. at every masked entry (fully
// masked rows have lse == -1e30 too, where exp(s - lse) would be 1); the
// causal mask compares global positions, kv_offset + key > q_offset + row;
// inputs are read in their type (f32 or bf16), all math is f32, and each
// output is rounded once. Tiles that
// the causal mask hides entirely are skipped.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ds of the thread's 4 x 4 (query, key) entries, written to the shared
// [query][key] tile dss.
__device__ __forceinline__ void probs_and_ds(
    const float (&s)[4][4], const float (&dp)[4][4], const float (&lse)[4],
    const float (&delta)[4], float* dss, int q0, int k0, int ty,
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
      dss[(ty + 16 * i) * kLdS + tx + 16 * j] =
          p * (dp[i][j] - delta[i]) * scale;
    }
  }
}

// acc[i][j] += sum_k A(ty+16i, k) * B(k, tx+16j) over k < kTile, with
// A(m, k) = a[m * kLdS + k] and B(k, n) = b[k * (kD + 1) + n].
template <int kD>
__device__ __forceinline__ void accumulate(float (&acc)[4][kD / 16],
                                           const float* a, const float* b,
                                           int ty, int tx) {
  constexpr int kLd = kD + 1;
  constexpr int kN = kD / 16;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float x[4], y[kN];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * kLdS + k];
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
    probs_and_ds(s, dp, lse_r, delta_r, dss, q0, k0, ty, tx, S, Sk, scale,
                 causal, q_offset, kv_offset);
    __syncthreads();
    accumulate<kD>(acc, dss, ks, ty, tx);  // dq += ds k
  }
  store_tile<T, kD>(dq + bh * S * D, acc, q0, S, D, ty, tx);
}

constexpr int kDkvThreads = 128;  // four warps, 16 keys each

// Dynamic shared memory of the dK/dV kernel: the k and v tiles, then two
// stages of (q tile, dO tile, lse[64], delta[64]).
template <typename T, int kD>
__host__ __device__ constexpr size_t dkv_tile_bytes() {
  return sizeof(T) * kTile * pt::TileLd<T, kD>::value;
}

template <typename T, int kD>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return 2 * dkv_tile_bytes<T, kD>() + 2 * kTile * sizeof(float);
}

template <typename T, int kD>
constexpr size_t dkv_smem_bytes() {
  return 2 * dkv_tile_bytes<T, kD>() + 2 * dkv_stage_bytes<T, kD>();
}

template <typename T, int kD>
__global__ void __launch_bounds__(kDkvThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int D, float scale,
                     int causal, int q_offset, int kv_offset, int vec) {
  constexpr int kLd = pt::TileLd<T, kD>::value;
  constexpr size_t kTileB = dkv_tile_bytes<T, kD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = reinterpret_cast<T*>(smem_raw + kTileB);
  unsigned char* ring = smem_raw + 2 * kTileB;
  auto stage_q = [&](int st) {
    return reinterpret_cast<T*>(ring + st * dkv_stage_bytes<T, kD>());
  };
  auto stage_do = [&](int st) {
    return reinterpret_cast<T*>(ring + st * dkv_stage_bytes<T, kD>() +
                                kTileB);
  };
  auto stage_stats = [&](int st) {  // lse[64], then delta[64]
    return reinterpret_cast<float*>(ring + st * dkv_stage_bytes<T, kD>() +
                                    2 * kTileB);
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const T* qh = q + bh * S * D;
  const T* doh = dout + bh * S * D;

  // the first query tile that sees this block's first key (_dkv_kernel's
  // `visible`, q_offset + q0 + kTile - 1 >= kv_offset + k0); every later
  // tile sees it too
  const int n_q = (S + kTile - 1) / kTile;
  int t0 = 0;
  if (causal) {
    const int x = kv_offset + k0 - q_offset - (kTile - 1);
    t0 = x <= 0 ? 0 : (x + kTile - 1) / kTile;
  }

  auto load_q = [&](int tile, int st) {
    const int q0 = tile * kTile;
    pt::load_tile<T, kTile, kD, kLd, kDkvThreads>(stage_q(st), qh, q0, S, D,
                                                   vec);
    pt::load_tile<T, kTile, kD, kLd, kDkvThreads>(stage_do(st), doh, q0, S,
                                                   D, vec);
    // threads 0..63 copy lse, 64..127 delta
    const int i = threadIdx.x & (kTile - 1);
    const float* src = threadIdx.x < kTile ? lse : delta;
    const bool in = q0 + i < S;
    pt::cp_async4(stage_stats(st) + threadIdx.x,
                  in ? src + bh * S + q0 + i : src, in);
  };
  pt::load_tile<T, kTile, kD, kLd, kDkvThreads>(ks, k + bh * Sk * D, k0, Sk,
                                                 D, vec);
  pt::load_tile<T, kTile, kD, kLd, kDkvThreads>(vs, v + bh * Sk * D, k0, Sk,
                                                 D, vec);
  if (t0 < n_q) load_q(t0, 0);
  pt::cp_async_commit();

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[dn][c] = dv_acc[dn][c] = 0.f;
  const int key0 = k0 + warp * 16;    // the warp's 16 keys
  const int key_base = key0 + g;  // this thread's keys key_base, key_base + 8

  for (int it = t0; it < n_q; ++it) {
    const int st = (it - t0) & 1;
    const int q0 = it * kTile;
    if (it + 1 < n_q) {
      load_q(it + 1, st ^ 1);
      pt::cp_async_commit();
      pt::cp_async_wait<1>();  // tile it (and k, v) have landed
    } else {
      pt::cp_async_wait<0>();
    }
    __syncthreads();
    const T* qs = stage_q(st);
    const T* dos = stage_do(st);
    const float* lse_s = stage_stats(st);
    const float* delta_s = lse_s + kTile;

    // p^T: element c of p[nt] is key key_base + 8 (c / 2), query column
    // 8 nt + 2 t + c % 2 of the tile
    float p[8][4];
    pt::warp_gemm_nt<T, kD>(p, ks + warp * 16 * kLd, qs);  // K Q^T
    // Only a tile that crosses S, Sk or the warp's causal diagonal is masked
    // (a fully masked row lies in such a tile: it sees no key).
    const bool edge =
        q0 + kTile > S || key0 + 16 > Sk ||
        (causal && kv_offset + key0 + 15 > q_offset + q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * nt + 2 * t + (c & 1);
        const int row = q0 + col;
        const int key = key_base + 8 * (c >> 1);
        const float sc = p[nt][c] * scale;
        const bool masked =
            edge && (row >= S || key >= Sk ||
                     (causal && kv_offset + key > q_offset + row));
        p[nt][c] = masked ? 0.f : expf(sc - lse_s[col]);
      }
    pt::warp_gemm_pb<T, kD>(dv_acc, p, dos);  // dv += p^T dO

    float ds[8][4];
    pt::warp_gemm_nt<T, kD>(ds, vs + warp * 16 * kLd, dos);  // V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[nt][c] = p[nt][c] * (ds[nt][c] - delta_s[8 * nt + 2 * t + (c & 1)]) *
                    scale;
    pt::warp_gemm_pb<T, kD>(dk_acc, ds, qs);  // dk += ds^T q
    __syncthreads();  // this stage is consumed before it is refilled
  }
  pt::cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  pt::warp_store<T, kD>(dk + bh * Sk * D, dk_acc, key0, Sk, D, one);
  pt::warp_store<T, kD>(dv + bh * Sk * D, dv_acc, key0, Sk, D, one);
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
  constexpr size_t smem = dkv_smem_bytes<T, kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // cp.async moves 16-byte chunks: rows of a multiple of 16 bytes, aligned
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                   (uintptr_t)dout) % 16 == 0;
  flash_dkv_kernel<T, kD><<<dim3(BH, (Sk + kTile - 1) / kTile), kDkvThreads,
                            smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, D, scale, causal,
      q_offset, kv_offset, vec);
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
