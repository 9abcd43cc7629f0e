// nbr_adjacency.cu — the ε-neighbourhood kernel behind DBSCAN workload
// discovery, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pairdist.py:_nbr_kernel
// (launched by _neighbor_adjacency_pallas).  For x (N, F) fp32 and every row
// i < Npad it writes
//
//   counts[i]             #{ j < N : d2(i, j) <= eps2 }              int32
//   packed[i, j / 8]      bit j % 8 set iff j < N and d2(i, j) <= eps2  uint8
//
// with d2(i, j) = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 0) in fp32.  Rows
// N <= i < Npad are zero vectors, as in the reference's zero padding (their
// columns are masked, their rows are not).
//
// Bound on an H100: N^2 F fused multiply-adds on the CUDA cores (F = 16:
// 4.3 G FMA at N = 16384, 0.13 ms at 67 TFLOP/s fp32) against N^2 / 8 bytes
// written (10 us at 3.35 TB/s) — arithmetic bounds it.  What the design does
// about it:
//   * no (N, N) fp32 tile ever leaves registers: each distance is formed,
//     thresholded and reduced to one bit of a __ballot_sync word;
//   * a block owns a strip of 32 rows and walks every column tile itself,
//     so the per-row counts accumulate in registers (the TPU kernel carried
//     them across its sequential grid axis; a parallel grid would need a
//     popcount recount pass, which this design does not have);
//   * the strip's rows and norms sit in shared memory and are read as
//     float4 broadcasts, each lane keeps its columns in registers, and every
//     shared-memory load feeds 4 * (64 / F) FMAs;
//   * a warp's 32 lanes cover 32 consecutive columns of one row, so the
//     ballot word is the reference's bit layout (column j in byte j / 8,
//     bit j % 8, LSB first) stored little-endian; lanes store it byte by
//     byte, since a row is Npad / 8 bytes and need not be word aligned.
// Arithmetic keeps the reference's order: norms as sequential products and
// sums, the dot product as sequential fmaf from 0 (fp32, no tensor cores,
// no TF32), then (xx + yy) - 2 xy with round-to-nearest intrinsics that nvcc
// cannot contract.  The clamp at 0 is folded into the compare (eps2 >= 0).
// Tuning (wgmma, TMA) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // warps per block
constexpr int kRowsPerWarp = 8;              // strip rows each warp owns
constexpr int kRows = kWarps * kRowsPerWarp; // strip height per block

template <int FP>
__device__ __forceinline__ float sq_norm(const float* v) {
  float s = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) s = __fadd_rn(s, __fmul_rn(v[f], v[f]));
  return s;
}

// FP: feature count padded (with zeros) to 16, 32 or 64.
template <int FP>
__global__ void __launch_bounds__(kWarps * 32)
nbr_adjacency_kernel(const float* __restrict__ x, int n, int npad, int width,
                     float eps2, int* __restrict__ counts,
                     uint8_t* __restrict__ packed) {
  constexpr int kCols = 64 / FP;             // 32-column groups per lane
  constexpr int kTile = 32 * kCols;          // columns per pass
  __shared__ __align__(16) float xs[kRows][FP];
  __shared__ float xxs[kRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;

  for (int t = threadIdx.x; t < kRows * FP; t += blockDim.x) {
    const int r = t / FP, i = r0 + r;
    xs[r][t % FP] = (i < n) ? x[(size_t)i * FP + t % FP] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < kRows) xxs[threadIdx.x] = sq_norm<FP>(xs[threadIdx.x]);
  __syncthreads();

  int cnt[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) cnt[k] = 0;
  const int wr0 = warp * kRowsPerWarp;

  for (int j0 = 0; j0 < npad; j0 += kTile) {
    float xj[kCols][FP];
    float yy[kCols];
    bool valid[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c * 32 + lane;
      valid[c] = j < n;
      const float4* src =
          reinterpret_cast<const float4*>(x + (size_t)(valid[c] ? j : 0) * FP);
#pragma unroll
      for (int f = 0; f < FP; f += 4) {
        const float4 v = valid[c] ? __ldg(src + f / 4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        xj[c][f] = v.x;
        xj[c][f + 1] = v.y;
        xj[c][f + 2] = v.z;
        xj[c][f + 3] = v.w;
      }
      yy[c] = sq_norm<FP>(xj[c]);
    }

#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = wr0 + k;
      const int i = r0 + r;
      if (i >= npad) break;                  // uniform across the warp
      float dot[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) dot[c] = 0.f;
#pragma unroll
      for (int f = 0; f < FP; f += 4) {
        const float4 xi = *reinterpret_cast<const float4*>(&xs[r][f]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dot[c] = fmaf(xi.x, xj[c][f], dot[c]);
          dot[c] = fmaf(xi.y, xj[c][f + 1], dot[c]);
          dot[c] = fmaf(xi.z, xj[c][f + 2], dot[c]);
          dot[c] = fmaf(xi.w, xj[c][f + 3], dot[c]);
        }
      }
      const float xx = xxs[r];
      uint32_t word[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float d2 =
            __fsub_rn(__fadd_rn(xx, yy[c]), __fmul_rn(2.f, dot[c]));
        word[c] = __ballot_sync(0xffffffffu, valid[c] && d2 <= eps2);
        cnt[k] += __popc(word[c]);
      }
      if (lane < 4 * kCols) {                // one byte of the tile each
        const int b = (j0 >> 3) + lane;
        if (b < width) {
          uint32_t w = word[0];
#pragma unroll
          for (int c = 1; c < kCols; ++c)
            if ((lane >> 2) == c) w = word[c];
          packed[(size_t)i * width + b] = (uint8_t)(w >> ((lane & 3) * 8));
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int i = r0 + wr0 + k;
      if (i < npad) counts[i] = cnt[k];
    }
  }
}

}  // namespace

// x: (n, fp) fp32, contiguous, 16-byte aligned; counts: (npad,) int32;
// packed: (npad, npad / 8) uint8.  npad is a multiple of 8 and >= n.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nbr_adjacency(const float* x, int n, int npad, int fp,
                             float eps2, int* counts, uint8_t* packed,
                             cudaStream_t stream) {
  if (npad <= 0 || npad % 8 != 0 || n > npad) return (int)cudaErrorInvalidValue;
  const int width = npad / 8;
  const dim3 grid((npad + kRows - 1) / kRows), block(kWarps * 32);
  switch (fp) {
    case 16:
      nbr_adjacency_kernel<16><<<grid, block, 0, stream>>>(
          x, n, npad, width, eps2, counts, packed);
      break;
    case 32:
      nbr_adjacency_kernel<32><<<grid, block, 0, stream>>>(
          x, n, npad, width, eps2, counts, packed);
      break;
    case 64:
      nbr_adjacency_kernel<64><<<grid, block, 0, stream>>>(
          x, n, npad, width, eps2, counts, packed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
