// Flash-attention forward for Hopper: softmax(q k^T * scale [+ causal mask]) v
// with an online softmax over key tiles, emitting (out, lse).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel_resident (B1)
// and ::_fwd_kernel (B2): one kernel computes the function of both, since the
// TPU's choice between them (whether a head's K/V fit VMEM) has no meaning
// here -- a block streams K/V tiles through shared memory either way.
//
// What bounds it on the H100: operations. At the training shape (S = 1024,
// D = 64, causal) a head does ~2 x S^2 x D flops against 4 x S x D elements
// of q, k, v and out, ~S/4 flops per f32 byte, far above the balance point.
// The card's fastest float32-accurate products are the tensor cores' 3xTF32
// (495 / 3 = 165 TFLOP/s), so both products run there (csrc/mma.cuh):
//   S = Q K^T:  float -> 3xTF32 m16n8k8 mma.sync; bf16 / f16 -> m16n8k16 in
//               that type with ldmatrix fragments (exact products, f32 sums).
//   O += P V:   P stays f32 as in the Pallas kernel (it computes in f32 for
//               every input type), so it is split too: 3xTF32 for float V,
//               two passes for bf16 or f16 V (exact in TF32). P is not
//               rounded to V's type, which would change the function.
// A single TF32 pass is never used: the port's float32 contract is TF32 off.
//
// Layout: one block of four warps per (batch*head, 64 query rows); each warp
// owns 16 rows (the m16 of mma) and keeps its scores, probabilities, row
// max/sum and output accumulator in registers; the online softmax runs on the
// C fragments (row max and sum by two quad shuffles), and the score fragments
// feed P V as A operands directly (mma.cuh's c_as_a). K/V tiles of 64 keys
// (32 for head dims above 128) stream through a two-stage ring in dynamic
// shared memory with cp.async: the next tile's copy is in flight while this
// one is multiplied. Routed through
// mma.sync, not wgmma: wgmma's TF32 form wants both operands K-major, so V
// would need a transposed copy in shared memory, and mma.sync's fragments let
// P stay in registers between the two products. The grid visits the query
// tiles with the most causal work (the last ones) first.
//
// Conventions kept from the Pallas kernel: a masked score is -1e30 (not -inf);
// a row whose every key is masked returns out = 0 and lse = -1e30; the causal
// mask compares global positions, kv_offset + key > q_offset + row. Key tiles
// wholly in a row block's future are skipped (the result is the same: their
// probabilities are exactly 0). Ragged S, Sk and D are zero-padded in shared
// memory and masked.
//
// Head dims 129..256 (tiles of 256 columns) meet the card's two budgets. The
// two-stage ring of 64-key tiles would take 5 x 64 x 260 x 4 = 332,800 bytes
// of shared memory in float32, above the 227 KB a block may have, so the
// tiles hold 32 keys (199,680 bytes in float32, 101,376 in 16-bit types).
// The output accumulator o is 128 floats a thread; P V sums each 64 columns'
// fresh fragments in turn (mma.cuh's kChunk), so they add 32 registers, not
// 128.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block

// keys per K/V tile, and the columns of one P V chunk (see above)
template <int kD>
__host__ __device__ constexpr int block_k() {
  return kD <= 128 ? 64 : 32;
}
template <int kD>
__host__ __device__ constexpr int pv_chunk() {
  return kD <= 128 ? kD : 64;
}

// Dynamic shared memory: the q tile and two stages of (k, v) tiles.
template <typename T, int kD>
constexpr size_t smem_bytes() {
  return sizeof(T) * (kBlockQ + 4 * block_k<kD>()) *
         pt::TileLd<T, kD>::value;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int Sk, int D,
                     float scale, int causal, int q_offset, int kv_offset,
                     int vec) {
  constexpr int kLd = pt::TileLd<T, kD>::value;
  constexpr int kBlockK = block_k<kD>();
  constexpr int kTile = kBlockK * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kv = qs + kBlockQ * kLd;  // stage s: k at kv + 2s kTile, v after it

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last tiles first
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  // key tiles this block can see at all
  int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, S) - 1;
    const int last_key = q_offset + last_row - kv_offset;  // inclusive
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockK + 1);
  }

  auto load_kv = [&](int tile, int stage) {
    T* ks = kv + 2 * stage * kTile;
    pt::load_tile<T, kBlockK, kD, kLd, kThreads>(ks, kh, tile * kBlockK, Sk,
                                                 D, vec);
    pt::load_tile<T, kBlockK, kD, kLd, kThreads>(ks + kTile, vh,
                                                 tile * kBlockK, Sk, D, vec);
  };
  pt::load_tile<T, kBlockQ, kD, kLd, kThreads>(qs, q + bh * S * D, q0, S, D,
                                               vec);
  if (n_tiles > 0) load_kv(0, 0);
  pt::cp_async_commit();

  const int row0 = q0 + warp * 16;    // the warp's 16 rows
  const int row_base = row0 + g;  // this thread's rows row_base, row_base + 8
  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      pt::cp_async_commit();
      pt::cp_async_wait<1>();  // tile it (and the q tile) have landed
    } else {
      pt::cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv + 2 * (it & 1) * kTile;

    float s[kBlockK / 8][4];
    pt::warp_gemm_nt<T, kD, kBlockK>(s, qs + warp * 16 * kLd, ks);

    // masked scores and the online softmax, on the C fragments: element c
    // of s[nt] is row row_base + 8 (c / 2), key k0 + 8 nt + 2 t + c % 2.
    // Only a tile that crosses Sk or the warp's causal diagonal is masked.
    const bool edge =
        k0 + kBlockK > Sk ||
        (causal && kv_offset + k0 + kBlockK - 1 > q_offset + row0);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * nt + 2 * t + (c & 1);
        const int row = row_base + 8 * (c >> 1);
        float sc = s[nt][c] * scale;
        if (edge &&
            (key >= Sk || (causal && kv_offset + key > q_offset + row)))
          sc = kNeg;
        s[nt][c] = sc;
        mx[c >> 1] = fmaxf(mx[c >> 1], sc);
      }
    float m_new[2], corr[2], psum[2] = {0.f, 0.f};
    bool alive[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m[h], pt::quad_max(mx[h]));
      alive[h] = m_new[h] > kNeg / 2;  // the row has an unmasked key so far
      corr[h] = alive[h] ? expf(m[h] - m_new[h]) : 1.f;
      m[h] = m_new[h];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        s[nt][c] = alive[h] ? expf(s[nt][c] - m_new[h]) : 0.f;
        psum[h] += s[nt][c];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + pt::quad_sum(psum[h]);
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dn][c] *= corr[c >> 1];

    pt::warp_gemm_pb<T, kD, kBlockK, kLd, pv_chunk<kD>()>(
        o, s, ks + kTile);  // o += p v
    __syncthreads();  // this stage is consumed before it is refilled
  }
  pt::cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float safe_l = l[h] == 0.f ? 1.f : l[h];
    inv[h] = 1.f / safe_l;
    const int row = row_base + 8 * h;
    if (t == 0 && row < S)
      lse[bh * S + row] = l[h] == 0.f ? kNeg : m[h] + logf(safe_l);
  }
  pt::warp_store<T, kD>(out + bh * S * D, o, row0, S, D, inv);
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int S, int Sk, int D, float scale, int causal,
           int q_offset, int kv_offset, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<T, kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  // cp.async moves 16-byte chunks: rows of a multiple of 16 bytes, aligned
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  flash_fwd_kernel<T, kD><<<dim3(BH, (S + kBlockQ - 1) / kBlockQ), kThreads,
                            smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, Sk, D, scale, causal, q_offset, kv_offset,
      vec);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). q is [BH, S, D], k and v [BH, Sk, D], out
// [BH, S, D], all row-major of `dtype` (pt::kF32 / pt::kBF16 / pt::kF16);
// lse is f32 [BH, S]. Head dims up to 256 (tiles of 64, 128 or 256 columns,
// zero-padded).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int BH, int S, int Sk, int D,
                         float scale, int causal, int q_offset, int kv_offset,
                         int dtype, void* stream) {
  if (BH < 0 || S < 0 || Sk < 0 || D <= 0 || D > 256 ||
      (S + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_FWD(T, KD)                                                       \
  return launch<T, KD>(q, k, v, out, lse, BH, S, Sk, D, scale, causal,     \
                       q_offset, kv_offset, st)
  if (dtype == pt::kF32) {
    if (D <= 64) PT_FWD(float, 64);
    if (D <= 128) PT_FWD(float, 128);
    PT_FWD(float, 256);
  }
  if (dtype == pt::kBF16) {
    if (D <= 64) PT_FWD(__nv_bfloat16, 64);
    if (D <= 128) PT_FWD(__nv_bfloat16, 128);
    PT_FWD(__nv_bfloat16, 256);
  }
  if (dtype == pt::kF16) {
    if (D <= 64) PT_FWD(__half, 64);
    if (D <= 128) PT_FWD(__half, 128);
    PT_FWD(__half, 256);
  }
#undef PT_FWD
  return cudaErrorInvalidValue;
}
