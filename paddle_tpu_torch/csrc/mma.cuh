// Tensor-core fragments for the attention kernels: warp-level mma.sync
// products in TF32 (m16n8k8) and bf16 (m16n8k16), the 3xTF32 split that
// keeps float32 products float32-accurate, ldmatrix, and cp.async copies.
//
// Fragment layouts of one warp (PTX ISA, "Matrix Fragments for mma"), with
// g = lane / 4 and t = lane % 4:
//   C/D, 16 x 8 f32: c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//        c3 = C[g+8][2t+1].
//   A, 16 x 8 tf32 (row): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//        a3 = A[g+8][t+4].
//   B, 8 x 8 tf32 (col): b0 = B[t][g], b1 = B[t+4][g].
//   A, 16 x 16 bf16: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//        a2 = A[g][2t+8..], a3 = A[g+8][2t+8..].
//   B, 16 x 8 bf16: b0 = B[2t..2t+1][g], b1 = B[2t+8..][g].
//
// A C fragment feeds the next product as its A operand without shuffles: a
// sum over k may run in any order as long as A and B agree, so the k step's
// logical column t is taken as physical column 2t and t + 4 as 2t + 1. Then
// a = {c0, c2, c1, c3} (c_as_a), and the B operand reads rows 2t and 2t + 1.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (ties away, as cvt.rna);
// a b = lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms summed first and
// lo_a lo_b (~2^-22 |a b|) dropped. A value of bf16 is exact in TF32 (its
// lo is 0), so a product with one bf16 operand takes two passes.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"

namespace pt {

// x rounded to TF32, to nearest with ties away from zero: the value of
// cvt.rna.tf32.f32, computed as an integer add and mask on the magnitude
// bits (half of the 13 dropped bits added, then cleared). The H100 runs these
// on the integer pipes; the cvt instruction made both float32 kernels slower
// at the training shape.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a b, m16n8k8, TF32 inputs, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b, m16n8k16, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A operand of m16n8k8 held as its 3xTF32 split.
struct FragA {
  Split x[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  return {{split_tf32(a0), split_tf32(a1), split_tf32(a2), split_tf32(a3)}};
}

// The A operand {c0, c2, c1, c3} of a C fragment (see the note above).
__device__ __forceinline__ FragA c_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// d += a b for float32 a and b: three TF32 products.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           Split b0, Split b1) {
  mma_tf32(d, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b0.hi, b1.hi);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b0.lo, b1.lo);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b0.hi, b1.hi);
}

// d += a b for float32 a and a b exact in TF32 (bf16 values): two products.
__device__ __forceinline__ void mma_2xtf32(float (&d)[4], const FragA& a,
                                           uint32_t b0, uint32_t b1) {
  mma_tf32(d, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b0, b1);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b0, b1);
}

// The bits of a bf16 value widened to f32 (exact, hence exact TF32).
__device__ __forceinline__ uint32_t bf16_bits_as_f32(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register j receives matrix j (row l / 4, columns 2(l % 4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !full.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Shared-memory row stride (elements) of a tile of kD columns: f32 rows
// padded by 4 floats (the fragment reads A[g][t], B[g][t] and B[2t][g] hit
// 32 distinct banks), bf16 rows by 8 (16 bytes: ldmatrix rows on distinct
// banks).
template <typename T, int kD>
struct TileLd {
  static constexpr int value = sizeof(T) == 4 ? kD + 4 : kD + 8;
};

// dst[r][c] = src[row0 + r][c] for r < kRows, c < kD, in the storage type
// (row stride kLd); rows >= n_rows and columns >= D are zero. With vec (D
// elements a multiple of 16 bytes, base 16-byte aligned) the copy is issued
// as cp.async and completes at a later cp_async_wait; else it is a plain
// copy, complete on return.
template <typename T, int kRows, int kD, int kLd, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int n_rows, int D,
                                          bool vec) {
  if (vec) {
    constexpr int kE = 16 / sizeof(T);  // elements per 16-byte chunk
    constexpr int kChunks = kRows * kD / kE;
    for (int i = threadIdx.x; i < kChunks; i += kThreads) {
      const int r = i / (kD / kE), c = i % (kD / kE) * kE;
      const int row = row0 + r;
      const bool in = row < n_rows && c < D;
      cp_async16(dst + r * kLd + c, in ? src + (size_t)row * D + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      const int row = row0 + r;
      dst[r * kLd + c] = (row < n_rows && c < D) ? src[(size_t)row * D + c]
                                                  : T(0.f);
    }
  }
}

// One warp: c = A B^T, the 16 x 64 product of a (16 rows) and b (64 rows),
// both row-major [row][kD] tiles of T in shared memory with the TileLd
// stride; c[nt] is the C fragment of columns 8nt..8nt+7. float: 3xTF32 with
// fragments read as scalars; bf16: bf16 products with ldmatrix.
template <typename T, int kD>
__device__ __forceinline__ void warp_gemm_nt(float (&c)[8][4],
                                             const T* __restrict__ a,
                                             const T* __restrict__ b) {
  constexpr int kLd = TileLd<T, kD>::value;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  if constexpr (sizeof(T) == 4) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const float* ar =
          reinterpret_cast<const float*>(a) + g * kLd + 8 * ks + t;
      const FragA fa = split_a(ar[0], ar[8 * kLd], ar[4], ar[8 * kLd + 4]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* br = reinterpret_cast<const float*>(b) +
                          (8 * nt + g) * kLd + 8 * ks + t;
        mma_3xtf32(c[nt], fa, split_tf32(br[0]), split_tf32(br[4]));
      }
    }
  } else {
    const int r8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (r8 + 8 * hi8) * kLd + 16 * ks + 8 * hi16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf,
                    b + (16 * np + r8 + 8 * hi16) * kLd + 16 * ks + 8 * hi8);
        mma_bf16(c[2 * np], af, bf[0], bf[1]);
        mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// One warp: o[dn] += P B for P the 16 x 64 f32 C fragments p (kept in f32
// precision through the split) and b a row-major [64][kD] tile of T in
// shared memory; o[dn] is the C fragment of columns 8dn..8dn+7. float
// B: 3xTF32; bf16 B: two passes.
//
// The product is summed in a fresh fragment and added to o with float32
// adds. The tensor cores' float32 accumulation does not round to nearest,
// and its error grows with the mma additions into one fragment: a dK/dV
// accumulator that took every query tile in place drifted past the float32
// tolerance at S = 4096. Here a fragment takes 24 (or 16) additions.
template <typename T, int kD>
__device__ __forceinline__ void warp_gemm_pb(float (&o)[kD / 8][4],
                                             const float (&p)[8][4],
                                             const T* __restrict__ b) {
  constexpr int kLd = TileLd<T, kD>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float part[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[dn][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const FragA fa = c_as_a(p[j]);
    const T* br = b + (8 * j + 2 * t) * kLd + g;  // rows 2t and 2t + 1
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      if constexpr (sizeof(T) == 4) {
        const float* bf = reinterpret_cast<const float*>(br);
        mma_3xtf32(part[dn], fa, split_tf32(bf[8 * dn]),
                   split_tf32(bf[kLd + 8 * dn]));
      } else {
        mma_2xtf32(part[dn], fa, bf16_bits_as_f32(br[8 * dn]),
                   bf16_bits_as_f32(br[kLd + 8 * dn]));
      }
    }
  }
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] += part[dn][c];
}

// Float32 products against a tile split once per block. A block whose
// warps all multiply the same streamed tile splits each value of it once
// (split_tiles: hi in place, lo into a plane of the same layout), where
// warp_gemm_nt and warp_gemm_pb would split it again in every warp; the
// warps then read both parts. The A rows of warp_gemm_nt_split2 are the
// warp's own, held raw in registers (load_a_rows) and split per k step.

// a[ks] = {A[g][8ks+t], A[g+8][8ks+t], A[g][8ks+t+4], A[g+8][8ks+t+4]}:
// the m16n8k8 A operands of the 16 rows at `a_rows` (row-major, TileLd
// stride), every k step.
template <int kD>
__device__ __forceinline__ void load_a_rows(float (&a)[kD / 8][4],
                                            const float* __restrict__ a_rows) {
  constexpr int kLd = TileLd<float, kD>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const float* ar = a_rows + g * kLd + 8 * ks + t;
    a[ks][0] = ar[0], a[ks][1] = ar[8 * kLd], a[ks][2] = ar[4],
    a[ks][3] = ar[8 * kLd + 4];
  }
}

// Block-wide, for two [kRows][kD] tiles a and b: each value x becomes
// tf32(x) (its TF32 hi part, kept as float bits) and its lo plane (a_lo,
// b_lo) takes tf32(x - hi) at the same place.
template <int kRows, int kD, int kThreads>
__device__ __forceinline__ void split_tiles(float* a, float* a_lo, float* b,
                                            float* b_lo) {
  constexpr int kLd = TileLd<float, kD>::value;
  for (int i = threadIdx.x; i < kRows * kD / 4; i += kThreads) {
    const int o = i / (kD / 4) * kLd + i % (kD / 4) * 4;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float* tile = m ? b : a;
      float* lo = m ? b_lo : a_lo;
      const float4 x = *reinterpret_cast<const float4*>(tile + o);
      const Split s0 = split_tf32(x.x), s1 = split_tf32(x.y),
                  s2 = split_tf32(x.z), s3 = split_tf32(x.w);
      *reinterpret_cast<uint4*>(tile + o) =
          make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(lo + o) =
          make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
  }
}

__device__ __forceinline__ Split split_at(const float* hi, const float* lo,
                                          int i) {
  return {__float_as_uint(hi[i]), __float_as_uint(lo[i])};
}

// Two products of warp_gemm_nt's form for float32, c0 = A0 B0^T and
// c1 = A1 B1^T, in one pass over k (two independent chains for the tensor
// cores), with each A from load_a_rows and each B split by split_tiles
// (parts b and b_lo).
template <int kD>
__device__ __forceinline__ void warp_gemm_nt_split2(
    float (&c0)[8][4], const float (&a0)[kD / 8][4],
    const float* __restrict__ b0, const float* __restrict__ b0_lo,
    float (&c1)[8][4], const float (&a1)[kD / 8][4],
    const float* __restrict__ b1, const float* __restrict__ b1_lo) {
  constexpr int kLd = TileLd<float, kD>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c0[nt][e] = c1[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const FragA f0 = split_a(a0[ks][0], a0[ks][1], a0[ks][2], a0[ks][3]);
    const FragA f1 = split_a(a1[ks][0], a1[ks][1], a1[ks][2], a1[ks][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int o = (8 * nt + g) * kLd + 8 * ks + t;
      mma_3xtf32(c0[nt], f0, split_at(b0, b0_lo, o),
                 split_at(b0, b0_lo, o + 4));
      mma_3xtf32(c1[nt], f1, split_at(b1, b1_lo, o),
                 split_at(b1, b1_lo, o + 4));
    }
  }
}

// warp_gemm_pb for a float32 b split by split_tiles (parts b and b_lo); the
// same fresh-fragment sum.
template <int kD>
__device__ __forceinline__ void warp_gemm_pb_split(
    float (&o)[kD / 8][4], const float (&p)[8][4], const float* __restrict__ b,
    const float* __restrict__ b_lo) {
  constexpr int kLd = TileLd<float, kD>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float part[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[dn][c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const FragA fa = c_as_a(p[j]);
    const int br = (8 * j + 2 * t) * kLd + g;  // rows 2t and 2t + 1
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      mma_3xtf32(part[dn], fa, split_at(b, b_lo, br + 8 * dn),
                 split_at(b, b_lo, br + kLd + 8 * dn));
  }
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] += part[dn][c];
}

// Store a warp's 16 x kD C fragments (rows row0 + g, row0 + g + 8) to the
// row-major [n_rows][D] array out, each value times mul[h] (h = 0 for row
// g, 1 for row g + 8), rounded once to T.
template <typename T, int kD>
__device__ __forceinline__ void warp_store(T* __restrict__ out,
                                           const float (&c)[kD / 8][4],
                                           int row0, int n_rows, int D,
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_rows) continue;
    T* orow = out + (size_t)row * D;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col < D) store(orow + col, c[dn][2 * h] * mul[h]);
      if (col + 1 < D) store(orow + col + 1, c[dn][2 * h + 1] * mul[h]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace pt
