// pair_tile.cuh — the block tile shared by nbr_adjacency.cu and pairdist.cu.
//
// Both kernels evaluate, for a block's ROWS rows i and COLS columns j of the
// point set x (N, FP) fp32,
//
//   d2(i, j) = (|x_i|^2 + |x_j|^2) - 2 x_i.x_j
//
// with one arithmetic, kept here so the two agree bit for bit (the dense
// kernel's d2 <= eps2 is the adjacency the ε-neighbour kernel packs):
//   * norms as sequential round-to-nearest products and sums in feature
//     order (Tile::norms), the same for a point as a row and as a column;
//   * the dot product as sequential fmaf from 0 in feature order, the row
//     value first (each kernel's inner loop: fmaf(row[f], col[f], acc));
//   * then sq_dist's (xx + yy) - 2 dot with round-to-nearest intrinsics.
// Both files are built with -fmad=false, so nvcc contracts none of it.
// Every step commutes exactly (fmaf's product is exact, and so is the
// scaling by 2), so d2(i, j) and d2(j, i) are the same float.
//
// Tile::stage copies the tile's rows and columns into shared memory,
// transposed (feature-major), so a thread reads the values of several
// rows or columns at one feature as one float4.  Points past N read as
// zero vectors: the reference's zero padding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_tile {

template <int ROWS, int COLS, int THREADS>
struct Tile {
  static_assert(ROWS % 16 == 0 && COLS % 16 == 0 && THREADS % 32 == 0, "");
  // transposed strides (floats): ≡ 4 (mod 32), so the staging stores of a
  // warp (16 points × 2 float4 quarters) hit 32 distinct banks, and a
  // multiple of 4, so every feature row stays 16-byte aligned
  static constexpr int kRowStride = ROWS + 4;
  static constexpr int kColStride = COLS + 4;
  static_assert(kRowStride % 32 == 4 && kColStride % 32 == 4, "");

  // shared-memory floats of the operands and norms for FP features:
  // rT[FP][kRowStride], cT[FP][kColStride], xxs[ROWS], yys[COLS]
  template <int FP>
  static constexpr int floats() {
    return FP * (kRowStride + kColStride) + ROWS + COLS;
  }

  // Stage rows r0 .. r0+ROWS-1 into rT[f * kRowStride + r] and columns
  // c0 .. c0+COLS-1 into cT[f * kColStride + c].  A warp task loads float4
  // quarters 2qp, 2qp+1 of 16 consecutive points: each point's first (or
  // next) 32 bytes, whole sectors.
  template <int FP>
  static __device__ __forceinline__ void stage(const float* __restrict__ x,
                                               int n, int r0, int c0,
                                               float* rT, float* cT) {
    constexpr int kGroups = (ROWS + COLS) / 16;
    constexpr int kTasks = kGroups * (FP / 8);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int t = warp; t < kTasks; t += THREADS / 32) {
      const int pg = t % kGroups, q = (t / kGroups) * 2 + (lane >> 4);
      const int p = pg * 16 + (lane & 15);
      const bool row = p < ROWS;
      const int g = row ? r0 + p : c0 + p - ROWS;
      float* dst = row ? rT + p : cT + (p - ROWS);
      const int stride = row ? kRowStride : kColStride;
      const float4 v = g < n ? __ldg(reinterpret_cast<const float4*>(
                                         x + (size_t)g * FP) + q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[(4 * q + 0) * stride] = v.x;
      dst[(4 * q + 1) * stride] = v.y;
      dst[(4 * q + 2) * stride] = v.z;
      dst[(4 * q + 3) * stride] = v.w;
    }
  }

  // Squared norms of the staged points into xxs (rows) and yys (columns),
  // one point a thread at a time: a sequential sum of round-to-nearest
  // squares in feature order.
  template <int FP>
  static __device__ __forceinline__ void norms(const float* rT,
                                               const float* cT, float* xxs,
                                               float* yys) {
    for (int p = threadIdx.x; p < ROWS + COLS; p += THREADS) {
      const bool col = p < COLS;
      const float* v = col ? cT + p : rT + (p - COLS);
      const int stride = col ? kColStride : kRowStride;
      float s = 0.f;
#pragma unroll
      for (int f = 0; f < FP; ++f) {
        const float e = v[f * stride];
        s = __fadd_rn(s, __fmul_rn(e, e));
      }
      (col ? yys[p] : xxs[p - COLS]) = s;
    }
  }
};

__device__ __forceinline__ float sq_dist(float xx, float yy, float dot) {
  return __fsub_rn(__fadd_rn(xx, yy), __fmul_rn(2.f, dot));
}

// A block above 48 KB of dynamic shared memory (FP = 64) needs the opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace pair_tile
