// Flash-attention forward for Hopper: softmax(q k^T * scale [+ causal mask]) v
// with an online softmax over key tiles, emitting (out, lse).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel_resident (B1)
// and ::_fwd_kernel (B2): one kernel computes the function of both, since the
// TPU's choice between them (whether a head's K/V fit VMEM) has no meaning
// here -- a block streams K/V tiles through shared memory either way.
//
// What bounds it on the H100: at the serving shapes (S = Sk = 128..192,
// D = 64) a head's q, k, v and out are 4 x S x D elements against
// ~2 x S^2 x D flops (causal), ~S/8 flops per byte in f32: below the f32
// balance point, so the floor is HBM bytes -- but this first kernel runs its
// products on the f32 SIMT units (no tensor cores), which caps it at the
// 67 TFLOP/s f32 rate long before the bytes do. The design keeps every
// intermediate (scores, probabilities, the running max/sum and the output
// accumulator) on chip, so each input is read from HBM once per q tile and
// only out and lse are written.
//
// Layout: one thread block per (batch*head, tile of kBlockQ query rows); the
// loop over key tiles inside the block replaces the TPU's sequential k grid
// axis. Four warps; each warp owns kRowsPerWarp query rows. For one row, lane
// j scores keys j and j + 32 of the tile (conflict-free: K rows are padded by
// one float in shared memory), the warp reduces the row max and sum with
// shuffles, and lane j accumulates output columns j, j + 32, ... so the P.V
// product reads V rows contiguously.
//
// Conventions kept from the Pallas kernel: a masked score is -1e30 (not -inf);
// a row whose every key is masked returns out = 0 and lse = -1e30; the causal
// mask compares global positions, kv_offset + key > q_offset + row. Key tiles
// wholly in a row block's future are skipped (the result is the same: their
// probabilities are exactly 0).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;

// DC = ceil(head_dim / 32) column chunks per lane; the key tile shrinks for
// wide heads so that the static shared memory stays under 48 KB.
template <int DC>
struct Tile {
  static constexpr int kD = DC * 32;
  static constexpr int kBlockK = DC <= 2 ? 64 : 32;
  static constexpr int kKeysPerLane = kBlockK / 32;
};

template <typename T, int DC>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int Sk, int D,
                     float scale, int causal, int q_offset, int kv_offset) {
  using Tl = Tile<DC>;
  constexpr int kD = Tl::kD;
  constexpr int kBlockK = Tl::kBlockK;
  constexpr int kKPL = Tl::kKeysPerLane;
  __shared__ float qs[kBlockQ][kD];
  __shared__ float ks[kBlockK][kD + 1];
  __shared__ float vs[kBlockK][kD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const T* qh = q + bh * S * D;
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  for (int i = tid; i < kBlockQ * kD; i += kWarps * 32) {
    const int r = i / kD, d = i % kD;
    const int row = q0 + r;
    qs[r][d] = (row < S && d < D) ? pt::to_f32(qh[(size_t)row * D + d]) : 0.f;
  }

  // key tiles this block can see at all
  int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, S) - 1;
    const int last_key = q_offset + last_row - kv_offset;  // inclusive
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockK + 1);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < kBlockK * kD; i += kWarps * 32) {
      const int j = i / kD, d = i % kD;
      const int key = k0 + j;
      const bool in = key < Sk && d < D;
      ks[j][d] = in ? pt::to_f32(kh[(size_t)key * D + d]) : 0.f;
      vs[j][d] = in ? pt::to_f32(vh[(size_t)key * D + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int row = q0 + r;
      if (row >= S) break;  // warp-uniform
      float s[kKPL];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < kKPL; ++c) {
        const int j = lane + 32 * c;
        const int key = k0 + j;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) acc += qs[r][d] * ks[j][d];
        float sc = acc * scale;
        if (key >= Sk || (causal && kv_offset + key > q_offset + row))
          sc = kNeg;
        s[c] = sc;
        mx = fmaxf(mx, sc);
      }
      mx = pt::warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const bool alive = m_new > kNeg / 2;  // row has an unmasked key so far
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKPL; ++c) {
        s[c] = alive ? expf(s[c] - m_new) : 0.f;
        psum += s[c];
      }
      psum = pt::warp_sum(psum);
      const float corr = alive ? expf(m[i] - m_new) : 1.f;
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
      float acc[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] = 0.f;
#pragma unroll
      for (int c = 0; c < kKPL; ++c) {
#pragma unroll 8
        for (int src = 0; src < 32; ++src) {
          const float p = __shfl_sync(0xffffffffu, s[c], src);
          const int j = src + 32 * c;
#pragma unroll
          for (int dc = 0; dc < DC; ++dc) acc[dc] += p * vs[j][lane + 32 * dc];
        }
      }
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) o[i][dc] = o[i][dc] * corr + acc[dc];
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = q0 + warp * kRowsPerWarp + i;
    if (row >= S) break;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (bh * S + row) * D;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = lane + 32 * dc;
      if (d < D) pt::store(orow + d, o[i][dc] / safe_l);
    }
    if (lane == 0)
      lse[bh * S + row] = l[i] == 0.f ? kNeg : m[i] + logf(safe_l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, int Sk, int D, float scale, int causal,
           int q_offset, int kv_offset, cudaStream_t st) {
  const dim3 grid(BH, (S + kBlockQ - 1) / kBlockQ);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  float* lp = static_cast<float*>(lse);
  const int dc = (D + 31) / 32;
#define PT_FLASH_CASE(N)                                                    \
  case N:                                                                   \
    flash_fwd_kernel<T, N><<<grid, block, 0, st>>>(                         \
        qp, kp, vp, op, lp, S, Sk, D, scale, causal, q_offset, kv_offset);  \
    break;
  switch (dc) {
    PT_FLASH_CASE(1)
    PT_FLASH_CASE(2)
    PT_FLASH_CASE(3)
    PT_FLASH_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_FLASH_CASE
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). q is [BH, S, D], k and v [BH, Sk, D], out
// [BH, S, D], all row-major of `dtype` (pt::kF32 / pt::kBF16); lse is f32
// [BH, S]. Head dims up to 128. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int BH, int S, int Sk, int D,
                         float scale, int causal, int q_offset, int kv_offset,
                         int dtype, void* stream) {
  if (BH < 0 || S < 0 || Sk < 0 || D <= 0 || D > 128)
    return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch<float>(q, k, v, out, lse, BH, S, Sk, D, scale, causal,
                         q_offset, kv_offset, st);
  if (dtype == pt::kBF16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, BH, S, Sk, D, scale,
                                 causal, q_offset, kv_offset, st);
  return cudaErrorInvalidValue;
}
