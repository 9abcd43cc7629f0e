// pairdist.cu — the dense squared-distance matrix behind the seed (legacy)
// DBSCAN path, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pairdist.py:_kernel
// (launched by pairdist).  For x (N, F) fp32 it writes every entry
//
//   out[i, j] = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 0)              fp32
//
// of the (N, N) matrix, row-major, with no padding rows or columns.  The
// arithmetic is pair_tile.cuh's, shared with nbr_adjacency.cu: so
// out[i, j] <= eps2 is, bit for bit, the adjacency that kernel packs, and
// the dense and streaming DBSCAN paths see the same graph.
//
// Bound on an H100: the kernel writes N^2 fp32 and performs N^2 (2F + 3)
// flops.  At F = 16 that is 15.3 MB at N = 1955 (4.6 us at 3.35 TB/s)
// against 0.13 G flops (2.0 us at 67 TFLOP/s fp32): the output stream
// bounds it, so the design is about keeping stores in flight:
//   * one 256-thread block per 64-row x 128-column tile (496 blocks at
//     N = 1955, one wave of up to 4 blocks per SM), its rows and columns
//     staged once in shared memory (pair_tile.cuh) and each norm computed
//     once per tile;
//   * a warp owns 8 rows and walks them in two steps of 4 rows x 128
//     columns (a 4 x 4 register tile per lane); each step's results are
//     stored before the next step is computed, so the step's stores drain
//     while the next one computes instead of every block computing first
//     and storing after;
//   * a row segment is written as whole 16-byte stores at any N: N odd
//     leaves row i's first column 4-byte aligned only, so each lane takes
//     the aligned group that starts (i*N + c0) mod 4 columns before its own
//     four, gathering the missing values from the lane before it with one
//     rotation by a lane (4 shuffles); lane 0 writes the segment's
//     unaligned head and tail as scalars.  Every store instruction of a
//     warp covers 512 contiguous bytes.  The stores are plain: streaming
//     (evict-first) stores were no faster here.
// Built with -fmad=false: no product or sum here is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using pair_tile::sq_dist;

constexpr int kRows = 64;                  // block tile: 64 rows ...
constexpr int kCols = 128;                 // ... by 128 columns
constexpr int kThreads = 256;              // eight warps
using Tile = pair_tile::Tile<kRows, kCols, kThreads>;
constexpr int kStepRows = 4;               // rows per warp step
constexpr int kWarpRows = kRows / (kThreads / 32);   // 8 rows per warp

// Write v (columns 4 lane .. 4 lane + 3 of a 128-column segment) to
// seg[0 .. len): whole 16-byte groups wherever they lie inside the segment.
__device__ __forceinline__ void store_segment(float* seg, int len,
                                              const float (&v)[4], int lane) {
  const int m = (int)((reinterpret_cast<uintptr_t>(seg) >> 2) & 3);
  float g[4];
  int start = 4 * lane;
  if (m == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) g[u] = v[u];
  } else {
    // the lane before holds the m columns that precede this lane's four;
    // lane 0 receives lane 31's, the segment's last m columns
    float p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      p[u] = __shfl_sync(0xffffffffu, v[u], (lane + 31) & 31);
    start -= m;
    switch (m) {                           // constant indices: registers
      case 1: g[0] = p[3]; g[1] = v[0]; g[2] = v[1]; g[3] = v[2]; break;
      case 2: g[0] = p[2]; g[1] = p[3]; g[2] = v[0]; g[3] = v[1]; break;
      default: g[0] = p[1]; g[1] = p[2]; g[2] = p[3]; g[3] = v[0]; break;
    }
  }
  if (start >= 0 && start + 3 < len) {
    *reinterpret_cast<float4*>(seg + start) = make_float4(g[0], g[1], g[2],
                                                          g[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int col = start + u;
      if (col < 0) col += kCols;           // lane 0: lane 31's tail columns
      if (col < len) seg[col] = g[u];
    }
  }
}

// FP: feature count padded (with zeros) to 16, 32 or 64.
template <int FP>
__global__ void __launch_bounds__(kThreads, 4)
pairdist_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* rT = smem;
  float* cT = rT + FP * Tile::kRowStride;
  float* xxs = cT + FP * Tile::kColStride;
  float* yys = xxs + kRows;

  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kCols;
  Tile::stage<FP>(x, n, r0, c0, rT, cT);
  __syncthreads();
  Tile::norms<FP>(rT, cT, xxs, yys);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = min(kCols, n - c0);
  float yy[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) yy[q] = yys[4 * lane + q];

#pragma unroll 1
  for (int s = 0; s < kWarpRows / kStepRows; ++s) {
    const int rb = warp * kWarpRows + s * kStepRows;
    if (r0 + rb >= n) break;               // uniform across the warp
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
#pragma unroll 16
    for (int f = 0; f < FP; ++f) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(rT + f * Tile::kRowStride + rb);
      const float4 b4 =
          *reinterpret_cast<const float4*>(cT + f * Tile::kColStride + 4 * lane);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(a[k], b[q], acc[k][q]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = r0 + rb + k;
      if (i >= n) break;                   // uniform across the warp
      const float xx = xxs[rb + k];
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d2 = sq_dist(xx, yy[q], acc[k][q]);
        v[q] = d2 < 0.f ? 0.f : d2;
      }
      store_segment(out + (size_t)i * n + c0, len, v, lane);
    }
  }
}

template <int FP>
cudaError_t launch(const float* x, int n, float* out, cudaStream_t stream) {
  const dim3 grid((n + kCols - 1) / kCols, (n + kRows - 1) / kRows);
  const int smem = Tile::floats<FP>() * (int)sizeof(float);
  const cudaError_t err = pair_tile::allow_smem(pairdist_kernel<FP>, smem);
  if (err != cudaSuccess) return err;
  pairdist_kernel<FP><<<grid, kThreads, smem, stream>>>(x, n, out);
  return cudaGetLastError();
}

}  // namespace

// x: (n, fp) fp32, contiguous, 16-byte aligned; out: (n, n) fp32,
// contiguous, 4-byte aligned.  fp is 16, 32 or 64 (features zero-padded).
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int pairdist(const float* x, int n, int fp, float* out,
                        cudaStream_t stream) {
  if (n <= 0 || (n + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  switch (fp) {
    case 16: return (int)launch<16>(x, n, out, stream);
    case 32: return (int)launch<32>(x, n, out, stream);
    case 64: return (int)launch<64>(x, n, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
