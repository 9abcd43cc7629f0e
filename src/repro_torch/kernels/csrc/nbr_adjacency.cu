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
// with d2(i, j) = max((|x_i|^2 + |x_j|^2) - 2 x_i.x_j, 0) in fp32 (the
// arithmetic of pair_tile.cuh).  Rows N <= i < Npad are zero vectors, as in
// the reference's zero padding (their columns are masked, their rows are
// not).
//
// Bound on an H100: F fused multiply-adds per unordered pair on the CUDA
// cores (F = 16: 0.12 G FMA at N = 3910, 4 us at 67 TFLOP/s fp32; 2.1 G at
// N = 16384, 0.07 ms) against N^2 / 8 bytes written (2 us at N = 3910) —
// arithmetic bounds it.  Hopper's tensor cores cannot keep the bits: wgmma
// on fp32 is TF32, Hopper has no packed fp32x2 FMA, and split-precision
// products sum in another order.  So the design feeds the FFMA pipes and
// halves their work:
//   * d2(i, j) and d2(j, i) are the same float (pair_tile.cuh), so a block
//     owns a pair of 128-point tiles I <= J (a one-dimensional grid over
//     the triangle, T(T+1)/2 blocks for T tiles: 496 at N = 3910) and its
//     one 128 x 128 evaluation gives both the bits of rows I over columns
//     J and, mirrored, those of rows J over columns I.  Padding is not
//     symmetric (columns >= N are masked, rows are not), so each side gets
//     its own mask; a diagonal block writes its tile once;
//   * the tiles' points are staged once in shared memory, feature-major;
//     each of 256 threads keeps an 8 x 8 register tile of pairs (rows
//     8ty .. 8ty+7, columns 4tx .. 4tx+3 and 64+4tx .. 64+4tx+3), so four
//     conflict-free float4 loads at a feature feed 64 FMAs; 2 blocks (16
//     warps) per SM (4 would leave 64 registers a thread, under the
//     tile's 64 accumulators and operands).  The staging is synchronous:
//     with two blocks per SM one block's copies overlap the other's
//     arithmetic, and a persistent grid that staged each block's next
//     tile pair with cp.async into a second buffer measured no faster
//     (PERF.md): the kernel is bound by instruction issue, not staging;
//   * no (N, N) fp32 value leaves registers: each pair costs its F FMAs,
//     (xx + yy) - 2 dot, a compare that yields an all-ones mask, and one
//     and-or into each side's bit words (so no shifts per bit).  The
//     direct side collects nibbles that neighbouring threads join with one
//     shuffle into whole bytes (column j in byte j / 8, bit j % 8, LSB
//     first); the mirrored side's 8 rows a thread owns are a whole byte
//     already;
//   * both sides' bytes are staged in shared memory; one thread a row then
//     adds the row's popcount to counts[i] with one integer atomic — exact
//     and order-free, so counts stay bit-equal — and writes the row's 16
//     bytes as one 16-byte store when the row width Npad / 8 is a multiple
//     of 16 (byte stores otherwise).  The C entry zeroes counts first;
//     with a single tile (Npad <= 128, the quickstart and serving
//     analyses) the block stores them instead, so such a call is one
//     launch.
// Built with -fmad=false: no product or sum here is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using pair_tile::sq_dist;

constexpr int kTile = 128;                 // points per tile, rows = columns
constexpr int kThreads = 256;              // 16 x 16 threads, 8 x 8 pairs each
constexpr int kBytes = kTile / 8;          // packed bytes of a tile row
using Tile = pair_tile::Tile<kTile, kTile, kThreads>;

// FP: feature count padded (with zeros) to 16, 32 or 64.  wide: rows of
// `packed` are 16-byte aligned (width % 16 == 0, aligned base).
template <int FP>
__global__ void __launch_bounds__(kThreads, 2)
nbr_adjacency_kernel(const float* __restrict__ x, int n, int npad, int width,
                     float eps2, int* __restrict__ counts,
                     uint8_t* __restrict__ packed, bool wide) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) uint8_t direct[kTile][kBytes];   // rows I, cols J
  __shared__ __align__(16) uint8_t mirror[kTile][kBytes];   // rows J, cols I
  float* rT = smem;
  float* cT = rT + FP * Tile::kRowStride;
  float* xxs = cT + FP * Tile::kColStride;
  float* yys = xxs + kTile;

  // block b -> tiles I <= J, J-major over the triangle
  const int b = blockIdx.x;
  int J = (int)((sqrtf(8.f * (float)b + 1.f) - 1.f) * 0.5f);
  while ((J + 1) * (J + 2) / 2 <= b) ++J;
  while (J * (J + 1) / 2 > b) --J;
  const int I = b - J * (J + 1) / 2;
  const bool diag = I == J;
  const int r0 = I * kTile, c0 = J * kTile;

  Tile::stage<FP>(x, n, r0, c0, rT, cT);
  __syncthreads();
  Tile::norms<FP>(rT, cT, xxs, yys);       // read after the next barrier

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // acc[k][c]: row 8ty + k; column 4tx + c (c < 4) or 64 + 4tx + c - 4
  float acc[8][8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[k][c] = 0.f;
#pragma unroll 16
  for (int f = 0; f < FP; ++f) {
    const float* rf = rT + f * Tile::kRowStride;
    const float* cf = cT + f * Tile::kColStride;
    const float4 a0 = *reinterpret_cast<const float4*>(rf + 8 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(rf + 8 * ty + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(cf + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(cf + 64 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[k][c] = fmaf(a[k], bv[c], acc[k][c]);
  }
  __syncthreads();                         // the norms are in shared memory

  float yy[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    yy[c] = yys[4 * tx + c];
    yy[4 + c] = yys[64 + 4 * tx + c];
  }
  // direct side: lo/hi bit 4k + c is row k, column c (lo: 4tx + c, hi:
  // 64 + 4tx + c); mirrored side: tlo/thi bit 8c + k, byte c a column
  uint32_t lo = 0, hi = 0, tlo = 0, thi = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float xx = xxs[8 * ty + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t ml =
          sq_dist(xx, yy[c], acc[k][c]) <= eps2 ? ~0u : 0u;
      const uint32_t mh =
          sq_dist(xx, yy[4 + c], acc[k][4 + c]) <= eps2 ? ~0u : 0u;
      lo |= ml & (1u << (4 * k + c));
      hi |= mh & (1u << (4 * k + c));
      tlo |= ml & (1u << (8 * c + k));
      thi |= mh & (1u << (8 * c + k));
    }
  }
  // the direct side masks columns j >= n, the mirrored side rows i >= n
  lo &= ((1u << min(max(n - (c0 + 4 * tx), 0), 4)) - 1u) * 0x11111111u;
  hi &= ((1u << min(max(n - (c0 + 64 + 4 * tx), 0), 4)) - 1u) * 0x11111111u;
  const uint32_t rows_ok = (1u << min(max(n - (r0 + 8 * ty), 0), 8)) - 1u;
  tlo &= rows_ok * 0x01010101u;
  thi &= rows_ok * 0x01010101u;

  // direct byte tx/2 (columns 8(tx/2) ..) joins the low nibbles of tx and
  // tx ^ 1, byte 8 + tx/2 their high nibbles: the even thread writes the
  // first, the odd one the second
  const bool odd = tx & 1;
  const uint32_t other = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  const uint32_t mine = odd ? hi : lo;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t m = (mine >> (4 * k)) & 15u, o = (other >> (4 * k)) & 15u;
    direct[8 * ty + k][odd ? 8 + (tx >> 1) : (tx >> 1)] =
        (uint8_t)(odd ? (o | (m << 4)) : (m | (o << 4)));
  }
  // mirrored: column c's byte over this thread's 8 rows
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mirror[4 * tx + c][ty] = (uint8_t)(tlo >> (8 * c));
    mirror[64 + 4 * tx + c][ty] = (uint8_t)(thi >> (8 * c));
  }
  __syncthreads();

  // threads 0..127: direct row r0 + r over columns from c0; 128..255: the
  // mirrored row c0 + r over columns from r0 (none on the diagonal)
  const bool mirrored = threadIdx.x >= kTile;
  if (mirrored && diag) return;
  const int r = threadIdx.x & (kTile - 1);
  const int row = (mirrored ? c0 : r0) + r;
  if (row >= npad) return;
  const uint8_t* src = mirrored ? mirror[r] : direct[r];
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const int cnt = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  if (gridDim.x == 1) counts[row] = cnt;
  else if (cnt) atomicAdd(counts + row, cnt);
  uint8_t* dst = packed + (size_t)row * width + (mirrored ? r0 : c0) / 8;
  if (wide) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const int left = width - (mirrored ? r0 : c0) / 8;
#pragma unroll
    for (int q = 0; q < kBytes; ++q)
      if (q < left) dst[q] = src[q];
  }
}

template <int FP>
cudaError_t launch(const float* x, int n, int npad, float eps2, int* counts,
                   uint8_t* packed, cudaStream_t stream) {
  const int width = npad / 8;
  const int tiles = (npad + kTile - 1) / kTile;
  const int blocks = tiles * (tiles + 1) / 2;
  const int smem = Tile::floats<FP>() * (int)sizeof(float);
  const bool wide = width % 16 == 0 && (uintptr_t)packed % 16 == 0;
  cudaError_t err = pair_tile::allow_smem(nbr_adjacency_kernel<FP>, smem);
  if (err == cudaSuccess && blocks > 1)
    err = cudaMemsetAsync(counts, 0, (size_t)npad * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  nbr_adjacency_kernel<FP><<<blocks, kThreads, smem, stream>>>(
      x, n, npad, width, eps2, counts, packed, wide);
  return cudaGetLastError();
}

}  // namespace

// x: (n, fp) fp32, contiguous, 16-byte aligned; counts: (npad,) int32;
// packed: (npad, npad / 8) uint8.  npad is a multiple of 8 and >= n.
// Launches on `stream` (after zeroing counts when npad > 128) and returns
// the CUDA error code (0 on success).
extern "C" int nbr_adjacency(const float* x, int n, int npad, int fp,
                             float eps2, int* counts, uint8_t* packed,
                             cudaStream_t stream) {
  if (npad <= 0 || npad % 8 != 0 || n > npad || npad > 32768 * kTile)
    return (int)cudaErrorInvalidValue;
  switch (fp) {
    case 16: return (int)launch<16>(x, n, npad, eps2, counts, packed, stream);
    case 32: return (int)launch<32>(x, n, npad, eps2, counts, packed, stream);
    case 64: return (int)launch<64>(x, n, npad, eps2, counts, packed, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
