// pairdist.cu — the dense squared-distance matrix behind the seed (legacy)
// DBSCAN path, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pairdist.py:_kernel
// (launched by pairdist).  For x (N, F) fp32 it writes every entry
//
//   out[i, j] = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 0)              fp32
//
// of the (N, N) matrix, row-major, with no padding rows or columns.
//
// Bound on an H100: the kernel writes N^2 fp32 and performs N^2 (2F + 3)
// flops.  At F = 16 that is 1 GiB written at N = 16384 (0.32 ms at
// 3.35 TB/s) against 9.4 G flops (0.14 ms at 67 TFLOP/s fp32): the output
// stream bounds it, so the design is about stores:
//   * a block owns a 64 x 64 output tile; a warp writes two rows of it,
//     each 64 consecutive floats as 16 float4 stores (scalar stores when
//     N is not a multiple of 4), so every store instruction of a warp
//     covers whole 128-byte lines;
//   * the tile's 64 row vectors and 64 column vectors (columns stored
//     transposed, so a thread reads its 4 columns as one float4) and their
//     norms are staged in shared memory once; each thread then forms a
//     4 x 4 patch of the tile with 16 FMAs per float4 pair it reads.
// Arithmetic is exactly the ε-neighbour kernel's (nbr_adjacency.cu): norms
// as sequential products and sums, the dot product as sequential fmaf from
// 0 (fp32, no tensor cores, no TF32), then (xx + yy) - 2 xy with
// round-to-nearest intrinsics that nvcc cannot contract (the file is built
// with -fmad=false besides).  So out[i, j] <= eps2 is, bit for bit, the
// adjacency that kernel packs, and the dense and streaming DBSCAN paths
// see the same graph.  Tuning (wider tiles per block, TMA stores) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                    // output tile is kTile x kTile
constexpr int kThreads = 256;                // 16 column groups x 16 rows
constexpr int kColPad = kTile + 4;           // transposed row, float4-aligned

// FP: feature count padded (with zeros) to 16, 32 or 64.  VEC: N % 4 == 0
// and the output is 16-byte aligned, so rows are written as float4.
template <int FP, bool VEC>
__global__ void __launch_bounds__(kThreads)
pairdist_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  __shared__ __align__(16) float xr[kTile][FP];       // the tile's rows
  __shared__ __align__(16) float xc[FP][kColPad];     // its columns, transposed
  __shared__ float xxr[kTile];
  __shared__ float yyc[kTile];

  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile * FP; t += kThreads) {
    const int r = t / FP, f = t % FP;
    const int i = i0 + r, j = j0 + r;
    xr[r][f] = (i < n) ? x[(size_t)i * FP + f] : 0.f;
    xc[f][r] = (j < n) ? x[(size_t)j * FP + f] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < FP; ++f) s = __fadd_rn(s, __fmul_rn(xr[r][f], xr[r][f]));
    xxr[r] = s;
  } else if (threadIdx.x < 2 * kTile) {
    const int c = threadIdx.x - kTile;
    float s = 0.f;
#pragma unroll
    for (int f = 0; f < FP; ++f) s = __fadd_rn(s, __fmul_rn(xc[f][c], xc[f][c]));
    yyc[c] = s;
  }
  __syncthreads();

  // thread -> columns 4*tc .. 4*tc+3 of rows tr, tr+16, tr+32, tr+48
  const int tc = threadIdx.x % 16;
  const int tr = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

#pragma unroll
  for (int f = 0; f < FP; f += 4) {
    float4 cv[4];                              // cv[u] = columns at feature f+u
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cv[u] = *reinterpret_cast<const float4*>(&xc[f + u][4 * tc]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 rv = *reinterpret_cast<const float4*>(&xr[tr + 16 * k][f]);
      acc[k][0] = fmaf(rv.x, cv[0].x, acc[k][0]);
      acc[k][0] = fmaf(rv.y, cv[1].x, acc[k][0]);
      acc[k][0] = fmaf(rv.z, cv[2].x, acc[k][0]);
      acc[k][0] = fmaf(rv.w, cv[3].x, acc[k][0]);
      acc[k][1] = fmaf(rv.x, cv[0].y, acc[k][1]);
      acc[k][1] = fmaf(rv.y, cv[1].y, acc[k][1]);
      acc[k][1] = fmaf(rv.z, cv[2].y, acc[k][1]);
      acc[k][1] = fmaf(rv.w, cv[3].y, acc[k][1]);
      acc[k][2] = fmaf(rv.x, cv[0].z, acc[k][2]);
      acc[k][2] = fmaf(rv.y, cv[1].z, acc[k][2]);
      acc[k][2] = fmaf(rv.z, cv[2].z, acc[k][2]);
      acc[k][2] = fmaf(rv.w, cv[3].z, acc[k][2]);
      acc[k][3] = fmaf(rv.x, cv[0].w, acc[k][3]);
      acc[k][3] = fmaf(rv.y, cv[1].w, acc[k][3]);
      acc[k][3] = fmaf(rv.z, cv[2].w, acc[k][3]);
      acc[k][3] = fmaf(rv.w, cv[3].w, acc[k][3]);
    }
  }

  const int jc = j0 + 4 * tc;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = tr + 16 * k;
    const int i = i0 + r;
    if (i >= n) break;
    const float xx = xxr[r];
    float d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float d2 = __fsub_rn(__fadd_rn(xx, yyc[4 * tc + q]),
                                 __fmul_rn(2.f, acc[k][q]));
      d[q] = d2 < 0.f ? 0.f : d2;
    }
    float* row = out + (size_t)i * n;
    if (VEC) {
      if (jc < n)                              // n % 4 == 0: all 4 or none
        *reinterpret_cast<float4*>(row + jc) = make_float4(d[0], d[1], d[2], d[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (jc + q < n) row[jc + q] = d[q];
    }
  }
}

template <int FP>
void launch(const float* x, int n, float* out, bool vec, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles), block(kThreads);
  if (vec)
    pairdist_kernel<FP, true><<<grid, block, 0, stream>>>(x, n, out);
  else
    pairdist_kernel<FP, false><<<grid, block, 0, stream>>>(x, n, out);
}

}  // namespace

// x: (n, fp) fp32, contiguous; out: (n, n) fp32, contiguous.  fp is 16, 32
// or 64 (features zero-padded).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int pairdist(const float* x, int n, int fp, float* out,
                        cudaStream_t stream) {
  if (n <= 0 || n > 65535 * kTile) return (int)cudaErrorInvalidValue;
  const bool vec = (n % 4 == 0) && ((uintptr_t)out % 16 == 0);
  switch (fp) {
    case 16: launch<16>(x, n, out, vec, stream); break;
    case 32: launch<32>(x, n, out, vec, stream); break;
    case 64: launch<64>(x, n, out, vec, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
