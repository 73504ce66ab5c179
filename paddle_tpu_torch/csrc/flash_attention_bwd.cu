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
// Both kernels run their products on the tensor cores (csrc/mma.cuh):
// float32 through 3xTF32, bf16 or f16 Q K^T, dO V^T (and their transposes)
// through mma.sync in that type with ldmatrix; p and ds stay f32 and are
// split for the products they feed (two passes against a bf16 or f16
// operand). Each block is four warps over 64 rows (queries for dq, keys for
// dkv), 16 rows per warp, so every warp's scores, probabilities and ds stay
// in its C fragments and feed the next product from registers: no
// probability or ds tile touches shared memory. The block's own 64-row tiles stay on chip for the whole loop;
// the other side's tiles stream through a two-stage cp.async ring, the
// next tile's copy in flight while this one is multiplied. Blocks whose loop
// is longest under the causal mask are launched first.
//
// dq (B3): warps own 16 query rows each; the q and dO tiles stay with the
// block for the whole loop, and each thread's lse and delta (rows g and
// g + 8 of its warp) in registers; k and v tiles stream. Per key tile:
//   S = Q K^T, dP = dO V^T, P = exp(S scale - lse), dS = P (dP - delta) scale,
//   dQ += dS K  (dS, a 16 x 64 C fragment, is the A operand; K the B tile).
// Each tile's dS K is summed in a fresh fragment and added with float32
// adds: a query block sees up to 64 key tiles at S = 4096, and one tensor-core
// accumulator taking them all would drift past the float32 tolerance.
// In float32 the 3xTF32 split is integer work on the ALUs which, counted in
// instructions, takes about as long to issue as the products: every warp
// splits every k and v value it reads, and k feeds two products. So at head
// dims up to 64 (dq_split) each warp first reads its q and dO rows into
// registers, and the block splits each streamed k and v tile once, hi in
// place and lo into the space the q and dO tiles held. (Timed against
// splitting in every warp on the H100: faster at the training shape, for
// twice the shared-memory reads of k and v.)
//
// dkv (B4): warps own 16 keys each, keys being the M dimension of
//   S^T = K Q^T and dP^T = V dO^T  (A from the block's k and v tiles),
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale,
//   dV += P^T dO and dK += dS^T Q  (P^T and dS^T fed from registers);
// k and v stay resident, and q and dO tiles, with their lse and delta,
// stream.
//
// Conventions kept from the Pallas kernels: a masked score is -1e30 and p is
// forced to 0 wherever s <= -1e30 / 2, i.e. at every masked entry (fully
// masked rows have lse == -1e30 too, where exp(s - lse) would be 1); the
// causal mask compares global positions, kv_offset + key > q_offset + row;
// inputs are read in their type (f32, bf16 or f16), all math is f32, and
// each output is rounded once. Tiles that the causal mask hides entirely are
// skipped.
//
// Head dims 129..256 (tiles of 256 columns). The block's own two 64-row
// tiles take 133,120 bytes of shared memory in float32, so the streamed
// tiles shrink to keep two stages under the 227 KB a block may have: 16 rows
// in float32, 32 in bf16 and f16 (stream_rows). dq keeps its 128-float
// accumulator a thread, and each dS K sums 64 columns' fresh fragments at a
// time. dK and dV together would need 256 accumulator floats a thread, over
// the 255-register limit, so a dkv block owns 128 of the output columns
// (grid z picks which); it computes the score products over all 256
// columns, as the other half's block does too, and multiplies only its own
// columns of dO and q.

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // four warps, 16 query rows (dq) or keys each
constexpr int kTile = 64;      // the block's own rows (queries or keys)

// Rows of a streamed tile (keys for dq, queries for dkv): 64, or for head
// dims above 128 as many as let two stages fit beside the block's own tiles.
template <typename T, int kD>
__host__ __device__ constexpr int stream_rows() {
  return kD <= 128 ? kTile : sizeof(T) == 4 ? 16 : 32;
}

// Output columns of one dkv block, and the columns of one fresh-fragment
// chunk of the P-side products (mma.cuh's warp_gemm_pb).
template <int kD>
__host__ __device__ constexpr int dkv_cols() {
  return kD <= 128 ? kD : 128;
}
template <int kCols>
__host__ __device__ constexpr int pb_chunk() {
  return kCols <= 128 ? kCols : 64;
}

// Bytes of one [rows][kD] tile of T in shared memory (TileLd row stride).
template <typename T, int kD, int kRows = kTile>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * kRows * pt::TileLd<T, kD>::value;
}

// Dynamic shared memory of the dQ kernel: two stages of (k tile, v tile),
// then the q and dO tiles. With dq_split, the q and dO tiles are read into
// registers first and their space holds the lo planes of the k and v tiles
// of the current stage.
template <typename T, int kD>
constexpr size_t dq_smem_bytes() {
  return 4 * tile_bytes<T, kD, stream_rows<T, kD>()>() +
         2 * tile_bytes<T, kD>();
}

// float32 rows of up to 64 columns: the warps' q and dO rows in registers,
// and each k and v tile split once per block (split_tiles). At 128 columns
// the rows would take 128 more registers a thread; bf16 has nothing to
// split (its k is exact in TF32, and its q k^T and dO v^T are bf16).
template <typename T, int kD>
__host__ __device__ constexpr bool dq_split() {
  return sizeof(T) == 4 && kD == 64;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S,
                    int Sk, int D, float scale, int causal, int q_offset,
                    int kv_offset, int vec) {
  constexpr int kLd = pt::TileLd<T, kD>::value;
  constexpr int kBlockK = stream_rows<T, kD>();  // keys per k/v tile
  constexpr int kTileE = kBlockK * kLd;  // elements of one k or v tile
  constexpr bool kSplit = dq_split<T, kD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: k at kv + 2 s kTileE, v after it
  T* kv = reinterpret_cast<T*>(smem_raw);
  T* qs = kv + 4 * kTileE;
  T* dos = qs + kTile * kLd;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last tiles first
  const T* kh = k + bh * Sk * D;
  const T* vh = v + bh * Sk * D;

  // key tiles these rows can see at all (_dq_kernel's `visible`)
  int n_tiles = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_key = q_offset + min(q0 + kTile, S) - 1 - kv_offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / kBlockK + 1);
  }

  auto load_kv = [&](int tile, int stage) {
    T* ks = kv + 2 * stage * kTileE;
    pt::load_tile<T, kBlockK, kD, kLd, kThreads>(ks, kh, tile * kBlockK, Sk,
                                                 D, vec);
    pt::load_tile<T, kBlockK, kD, kLd, kThreads>(ks + kTileE, vh,
                                                 tile * kBlockK, Sk, D, vec);
  };
  pt::load_tile<T, kTile, kD, kLd, kThreads>(qs, q + bh * S * D, q0, S, D,
                                             vec);
  pt::load_tile<T, kTile, kD, kLd, kThreads>(dos, dout + bh * S * D, q0, S, D,
                                             vec);
  // the warp's q and dO rows (dq_split); unused otherwise
  float qa[kSplit ? kD / 8 : 1][4], da[kSplit ? kD / 8 : 1][4];
  if constexpr (kSplit) {
    pt::cp_async_commit();
    pt::cp_async_wait<0>();
    __syncthreads();
    pt::load_a_rows<kD>(qa, qs + warp * 16 * kLd);
    pt::load_a_rows<kD>(da, dos + warp * 16 * kLd);
    __syncthreads();  // the q and dO tiles become the lo planes
  }
  if (n_tiles > 0) load_kv(0, 0);
  pt::cp_async_commit();

  const int row0 = q0 + warp * 16;  // the warp's 16 rows
  const int row_base = row0 + g;    // this thread's rows row_base, row_base + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + 8 * h;
    lse_r[h] = row < S ? lse[bh * S + row] : 0.f;
    delta_r[h] = row < S ? delta[bh * S + row] : 0.f;
  }
  float dq_acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[dn][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockK;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, (it + 1) & 1);
      pt::cp_async_commit();
      pt::cp_async_wait<1>();  // tile it (and q, dO) have landed
    } else {
      pt::cp_async_wait<0>();
    }
    __syncthreads();
    T* ks = kv + 2 * (it & 1) * kTileE;
    T* vs = ks + kTileE;

    // p = Q K^T and ds = dO V^T; element c of p[nt] is row
    // row_base + 8 (c / 2), key k0 + 8 nt + 2 t + c % 2
    float p[kBlockK / 8][4], ds[kBlockK / 8][4];
    if constexpr (kSplit) {
      pt::split_tiles<kTile, kD, kThreads>(ks, qs, vs, dos);  // lo: qs, dos
      __syncthreads();
      pt::warp_gemm_nt_split2<kD>(p, qa, ks, qs, ds, da, vs, dos);
    } else {
      pt::warp_gemm_nt<T, kD, kBlockK>(p, qs + warp * 16 * kLd, ks);
      pt::warp_gemm_nt<T, kD, kBlockK>(ds, dos + warp * 16 * kLd, vs);
    }
    // Only a tile that crosses S, Sk or the warp's causal diagonal is masked
    // (a fully masked row lies in such a tile: it sees no key).
    const bool edge =
        row0 + 16 > S || k0 + kBlockK > Sk ||
        (causal && kv_offset + k0 + kBlockK - 1 > q_offset + row0);
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * nt + 2 * t + (c & 1);
        const int row = row_base + 8 * (c >> 1);
        const bool masked =
            edge && (row >= S || key >= Sk ||
                     (causal && kv_offset + key > q_offset + row));
        const int h = c >> 1;
        const float pv = masked ? 0.f : expf(p[nt][c] * scale - lse_r[h]);
        ds[nt][c] = pv * (ds[nt][c] - delta_r[h]) * scale;
      }
    if constexpr (kSplit)
      pt::warp_gemm_pb_split<kD>(dq_acc, ds, ks, qs);  // dq += ds k
    else
      pt::warp_gemm_pb<T, kD, kBlockK, kLd, pb_chunk<kD>()>(dq_acc, ds, ks);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  pt::cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  pt::warp_store<T, kD>(dq + bh * S * D, dq_acc, row0, S, D, one);
}

// Dynamic shared memory of the dK/dV kernel: the k and v tiles, then two
// stages of (q tile, dO tile, lse[rows], delta[rows]) of stream_rows rows.
template <typename T, int kD>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  constexpr int kRows = stream_rows<T, kD>();
  return 2 * tile_bytes<T, kD, kRows>() + 2 * kRows * sizeof(float);
}

template <typename T, int kD>
constexpr size_t dkv_smem_bytes() {
  return 2 * tile_bytes<T, kD>() + 2 * dkv_stage_bytes<T, kD>();
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int D, float scale,
                     int causal, int q_offset, int kv_offset, int vec) {
  constexpr int kLd = pt::TileLd<T, kD>::value;
  constexpr int kBlockQ = stream_rows<T, kD>();  // query rows per q/dO tile
  constexpr int kCols = dkv_cols<kD>();          // dk/dv columns of a block
  constexpr size_t kTileB = tile_bytes<T, kD>();
  constexpr size_t kQTileB = tile_bytes<T, kD, kBlockQ>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = reinterpret_cast<T*>(smem_raw + kTileB);
  unsigned char* ring = smem_raw + 2 * kTileB;
  auto stage_q = [&](int st) {
    return reinterpret_cast<T*>(ring + st * dkv_stage_bytes<T, kD>());
  };
  auto stage_do = [&](int st) {
    return reinterpret_cast<T*>(ring + st * dkv_stage_bytes<T, kD>() +
                                kQTileB);
  };
  auto stage_stats = [&](int st) {  // lse[kBlockQ], then delta[kBlockQ]
    return reinterpret_cast<float*>(ring + st * dkv_stage_bytes<T, kD>() +
                                    2 * kQTileB);
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  // this block's dk/dv columns (a constant 0 up to 128 columns)
  const int col0 = kD > kCols ? blockIdx.z * kCols : 0;
  const T* qh = q + bh * S * D;
  const T* doh = dout + bh * S * D;

  // the first query tile that sees this block's first key (_dkv_kernel's
  // `visible`, q_offset + q0 + kBlockQ - 1 >= kv_offset + k0); every later
  // tile sees it too
  const int n_q = (S + kBlockQ - 1) / kBlockQ;
  int t0 = 0;
  if (causal) {
    const int x = kv_offset + k0 - q_offset - (kBlockQ - 1);
    t0 = x <= 0 ? 0 : (x + kBlockQ - 1) / kBlockQ;
  }

  auto load_q = [&](int tile, int st) {
    const int q0 = tile * kBlockQ;
    pt::load_tile<T, kBlockQ, kD, kLd, kThreads>(stage_q(st), qh, q0, S, D,
                                                 vec);
    pt::load_tile<T, kBlockQ, kD, kLd, kThreads>(stage_do(st), doh, q0, S,
                                                 D, vec);
    // threads 0..kBlockQ-1 copy lse, the next kBlockQ delta
    if (2 * kBlockQ >= kThreads || threadIdx.x < 2 * kBlockQ) {
      const int i = threadIdx.x & (kBlockQ - 1);
      const float* src = threadIdx.x < kBlockQ ? lse : delta;
      const bool in = q0 + i < S;
      pt::cp_async4(stage_stats(st) + threadIdx.x,
                    in ? src + bh * S + q0 + i : src, in);
    }
  };
  pt::load_tile<T, kTile, kD, kLd, kThreads>(ks, k + bh * Sk * D, k0, Sk, D,
                                             vec);
  pt::load_tile<T, kTile, kD, kLd, kThreads>(vs, v + bh * Sk * D, k0, Sk, D,
                                             vec);
  if (t0 < n_q) load_q(t0, 0);
  pt::cp_async_commit();

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int dn = 0; dn < kCols / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[dn][c] = dv_acc[dn][c] = 0.f;
  const int key0 = k0 + warp * 16;    // the warp's 16 keys
  const int key_base = key0 + g;  // this thread's keys key_base, key_base + 8

  for (int it = t0; it < n_q; ++it) {
    const int st = (it - t0) & 1;
    const int q0 = it * kBlockQ;
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
    const float* delta_s = lse_s + kBlockQ;

    // p^T: element c of p[nt] is key key_base + 8 (c / 2), query column
    // 8 nt + 2 t + c % 2 of the tile
    float p[kBlockQ / 8][4];
    pt::warp_gemm_nt<T, kD, kBlockQ>(p, ks + warp * 16 * kLd, qs);  // K Q^T
    // Only a tile that crosses S, Sk or the warp's causal diagonal is masked
    // (a fully masked row lies in such a tile: it sees no key).
    const bool edge =
        q0 + kBlockQ > S || key0 + 16 > Sk ||
        (causal && kv_offset + key0 + 15 > q_offset + q0);
#pragma unroll
    for (int nt = 0; nt < kBlockQ / 8; ++nt)
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
    // dv += p^T dO, over this block's columns of dO
    pt::warp_gemm_pb<T, kCols, kBlockQ, kLd, pb_chunk<kD>()>(dv_acc, p,
                                                            dos + col0);

    float ds[kBlockQ / 8][4];
    pt::warp_gemm_nt<T, kD, kBlockQ>(ds, vs + warp * 16 * kLd, dos);  // V dO^T
#pragma unroll
    for (int nt = 0; nt < kBlockQ / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[nt][c] = p[nt][c] * (ds[nt][c] - delta_s[8 * nt + 2 * t + (c & 1)]) *
                    scale;
    pt::warp_gemm_pb<T, kCols, kBlockQ, kLd, pb_chunk<kD>()>(
        dk_acc, ds, qs + col0);  // dk += ds^T q, this block's columns
    __syncthreads();  // this stage is consumed before it is refilled
  }
  pt::cp_async_wait<0>();

  const float one[2] = {1.f, 1.f};
  pt::warp_store<T, kCols>(dk + bh * Sk * D, dk_acc, key0, Sk, D, one, col0);
  pt::warp_store<T, kCols>(dv + bh * Sk * D, dv_acc, key0, Sk, D, one, col0);
}

// cp.async moves 16-byte chunks: rows of a multiple of 16 bytes, aligned
template <typename T>
int use_vec(int D, const void* q, const void* k, const void* v,
            const void* dout) {
  const uintptr_t bases =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout;
  return (D * sizeof(T)) % 16 == 0 && bases % 16 == 0;
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int S,
              int Sk, int D, float scale, int causal, int q_offset,
              int kv_offset, cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<T, kD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_dq_kernel<T, kD><<<dim3(BH, (S + kTile - 1) / kTile), kThreads, smem,
                           st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, Sk, D, scale, causal, q_offset, kv_offset,
      use_vec<T>(D, q, k, v, dout));
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
  flash_dkv_kernel<T, kD><<<dim3(BH, (Sk + kTile - 1) / kTile,
                                 kD / dkv_cols<kD>()),
                            kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, D, scale, causal,
      q_offset, kv_offset, use_vec<T>(D, q, k, v, dout));
  return cudaGetLastError();
}

bool bad_shape(int BH, int S, int Sk, int D) {
  return BH < 0 || S < 0 || Sk < 0 || D <= 0 || D > 256 ||
         (S + kTile - 1) / kTile > 65535 || (Sk + kTile - 1) / kTile > 65535;
}

}  // namespace

// C interface (bound with ctypes). q, dout and dq are [BH, S, D]; k, v, dk and
// dv [BH, Sk, D], all row-major of `dtype` (pt::kF32 / pt::kBF16 /
// pt::kF16); lse and delta are f32 [BH, S]. Head dims up to 256 (tiles of
// 64, 128 or 256 columns, zero-padded). Each returns cudaGetLastError()
// after its one launch.
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
    if (D <= 128) PT_DQ(float, 128);
    PT_DQ(float, 256);
  }
  if (dtype == pt::kBF16) {
    if (D <= 64) PT_DQ(__nv_bfloat16, 64);
    if (D <= 128) PT_DQ(__nv_bfloat16, 128);
    PT_DQ(__nv_bfloat16, 256);
  }
  if (dtype == pt::kF16) {
    if (D <= 64) PT_DQ(__half, 64);
    if (D <= 128) PT_DQ(__half, 128);
    PT_DQ(__half, 256);
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
    if (D <= 128) PT_DKV(float, 128);
    PT_DKV(float, 256);
  }
  if (dtype == pt::kBF16) {
    if (D <= 64) PT_DKV(__nv_bfloat16, 64);
    if (D <= 128) PT_DKV(__nv_bfloat16, 128);
    PT_DKV(__nv_bfloat16, 256);
  }
  if (dtype == pt::kF16) {
    if (D <= 64) PT_DKV(__half, 64);
    if (D <= 128) PT_DKV(__half, 128);
    PT_DKV(__half, 256);
  }
#undef PT_DKV
  return cudaErrorInvalidValue;
}
