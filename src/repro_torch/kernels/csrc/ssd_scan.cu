// ssd_scan.cu — Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:30
// (_kernel, launched by _ssd_fwd).  For x (B, S, H, P), dt (B, S, H),
// A (H,), Bm and Cm (B, S, G, N), with head h reading group
// h / (H / G), it writes y (B, S, H, P) and the final state (B, H, N, P),
// both fp32.  Per chunk of Q rows, with a_i = dt_i * A and cum the
// chunk's inclusive cumsum of a:
//
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//            + exp(cum_i) C_i . S_prev
//   S_new  = exp(cum_last) S_prev + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
//
// x, Bm and Cm are bf16 or fp32 and read through strides (the conv output
// they are split from is not copied); dt and A are fp32; all arithmetic is
// fp32 on the CUDA cores.
//
// Bound on an H100: per chunk and group 2 Q^2 N flops for C . B^T, per
// head Q(Q+1)/2 (2P + 3) for the masked scores times x and 4 Q N P for the
// state read and update, against x, B, C, dt read once and y and the
// state written once.  At the serving shapes (Q = 16) the bytes bound it;
// at Q = 256 the operations do.  This first kernel is simple and right,
// not fast.  What the design does:
//   * the TPU ran chunks as a sequential grid axis with the (H, N, P)
//     state in VMEM scratch; here one block owns one (batch, head) and
//     loops over all chunks itself, with that head's (N, P) fp32 state in
//     shared memory (32 KB at N = 128, P = 64) for the whole sequence;
//     the state is written to device memory once, at the end;
//   * a chunk does not fit in shared memory (B and C of a 256-row chunk
//     are 256 KB in fp32), so it is walked in 32-row tiles, like a flash
//     tile loop with a decay mask instead of a softmax: for each row tile
//     i, the C rows stay in shared memory while the B and x tiles j <= i
//     stream through; tiles above the diagonal are skipped and j > i is
//     masked inside the diagonal tile before the exp, so exp never sees a
//     positive difference (the reference masks with -1e30 first);
//   * every row reads S_prev before any thread updates it: a block-wide
//     barrier separates the row tiles from the state update, where each
//     thread owns a fixed set of (n, p) entries;
//   * C . B^T is recomputed per head, not shared across the heads of a
//     group (r times the 2 Q^2 N of the bound); sharing it, wgmma tiles
//     and TMA are later work.
// Shared memory: the state N P, C and B row tiles 32 (N + 1) each (padded
// against bank conflicts), an x tile 32 P, the 32 x 33 score tile, and cum
// and dt of the chunk, in fp32: 80 KB at N = 128, P = 64, Q = 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // rows per tile
constexpr int kParts = kThreads / kRows;  // threads per row: 8
constexpr int kMaxN = 128;                // largest d_state
constexpr int kNSlots = kMaxN / kRows;    // state rows a thread owns: 4
constexpr int kSc = kRows + 1;            // score tile row stride

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  float* y;
  float* state;
  int S, H, G, N, Q;
  long long xs[3], dts[2], bs[3], cs[3];  // strides in elements
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// rows [r0, r0 + rows) of a (S, width) operand, starting at `base` with row
// stride `rs`, into smem rows of stride `ld`; rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base,
                                          long long rs, int r0, int rows,
                                          int width) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const int r = e / width, col = e % width;
    dst[r * ld + col] =
        r < rows ? to_f32(base[(long long)(r0 + r) * rs + col]) : 0.f;
  }
}

template <int P, typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const Params p) {
  constexpr int PC = P / kParts;          // columns a thread owns
  extern __shared__ float smem[];
  const int N = p.N, N1 = p.N + 1, Q = p.Q;
  float* st = smem;                       // [N][P] carried state
  float* cs = st + N * P;                 // [kRows][N1] C rows of tile i
  float* bsm = cs + kRows * N1;           // [kRows][N1] B rows of tile j
  float* xsm = bsm + kRows * N1;          // [kRows][P] x rows of tile j
  float* sc = xsm + kRows * P;            // [kRows][kSc] scores
  float* cum = sc + kRows * kSc;          // [Q]
  float* dtc = cum + Q;                   // [Q]

  const int tid = threadIdx.x;
  const int row = tid / kParts, part = tid % kParts;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float a = p.A[h];

  const T* xb = static_cast<const T*>(p.x) + b * p.xs[0] + h * p.xs[2];
  const float* dtb = p.dt + b * p.dts[0] + h;
  const T* bb = static_cast<const T*>(p.b) + b * p.bs[0] + g * p.bs[2];
  const T* cb = static_cast<const T*>(p.c) + b * p.cs[0] + g * p.cs[2];
  float* yb = p.y + ((long long)b * p.S * p.H + h) * P;
  const long long ys = (long long)p.H * P;

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    __syncthreads();                      // the last update is complete
    for (int i = tid; i < Q; i += kThreads)
      dtc[i] = dtb[(long long)(c0 + i) * p.dts[1]];
    __syncthreads();
    if (tid < 32) {                       // cum: warp 0, lane segments
      const int len = (Q + 31) / 32;
      const int s0 = min(Q, tid * len), s1 = min(Q, s0 + len);
      float run = 0.f;
      for (int i = s0; i < s1; ++i) {
        run += dtc[i] * a;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int i = s0; i < s1; ++i) cum[i] += excl;
    }

    // y for each row tile i: the state read, then the tiles j <= i
    for (int i0 = 0; i0 < Q; i0 += kRows) {
      const int rows_i = min(kRows, Q - i0);
      __syncthreads();                    // cum ready; cs free
      load_rows(cs, N1, cb, p.cs[1], c0 + i0, rows_i, N);
      __syncthreads();
      float inter[PC], acc[PC];
#pragma unroll
      for (int k = 0; k < PC; ++k) inter[k] = acc[k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float cv = cs[row * N1 + n];
#pragma unroll
        for (int k = 0; k < PC; ++k)
          inter[k] = fmaf(cv, st[n * P + part + k * kParts], inter[k]);
      }
      const int gi = i0 + row;
      const bool live = row < rows_i;
      for (int j0 = 0; j0 <= i0; j0 += kRows) {
        const int rows_j = min(kRows, Q - j0);
        __syncthreads();                  // bsm, xsm, sc free
        load_rows(bsm, N1, bb, p.bs[1], c0 + j0, rows_j, N);
        load_rows(xsm, P, xb, p.xs[1], c0 + j0, rows_j, P);
        __syncthreads();
        for (int j = part; j < kRows; j += kParts) {
          const int gj = j0 + j;
          float val = 0.f;
          if (live && j < rows_j && gj <= gi) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n)
              dot = fmaf(cs[row * N1 + n], bsm[j * N1 + n], dot);
            val = dot * expf(cum[gi] - cum[gj]) * dtc[gj];
          }
          sc[row * kSc + j] = val;
        }
        __syncthreads();
        const int jn = j0 == i0 ? min(rows_j, row + 1) : rows_j;
        for (int j = 0; j < jn; ++j) {
          const float s = sc[row * kSc + j];
#pragma unroll
          for (int k = 0; k < PC; ++k)
            acc[k] = fmaf(s, xsm[j * P + part + k * kParts], acc[k]);
        }
      }
      if (live) {
        const float e = expf(cum[gi]);
        float* yr = yb + (long long)(c0 + gi) * ys;
#pragma unroll
        for (int k = 0; k < PC; ++k)
          yr[part + k * kParts] = acc[k] + e * inter[k];
      }
    }

    // state update: every row has read S_prev
    const float clast = cum[Q - 1];
    float su[kNSlots][PC];
#pragma unroll
    for (int m = 0; m < kNSlots; ++m)
#pragma unroll
      for (int k = 0; k < PC; ++k) su[m][k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += kRows) {
      const int rows_j = min(kRows, Q - j0);
      __syncthreads();                    // bsm, xsm, sc free
      load_rows(bsm, N1, bb, p.bs[1], c0 + j0, rows_j, N);
      load_rows(xsm, P, xb, p.xs[1], c0 + j0, rows_j, P);
      if (tid < rows_j) sc[tid] = expf(clast - cum[j0 + tid]) * dtc[j0 + tid];
      __syncthreads();
      for (int j = 0; j < rows_j; ++j) {
        const float w = sc[j];
#pragma unroll
        for (int m = 0; m < kNSlots; ++m) {
          const int n = row + m * kRows;
          const float bw = n < N ? w * bsm[j * N1 + n] : 0.f;
#pragma unroll
          for (int k = 0; k < PC; ++k)
            su[m][k] = fmaf(bw, xsm[j * P + part + k * kParts], su[m][k]);
        }
      }
    }
    const float tot = expf(clast);
#pragma unroll
    for (int m = 0; m < kNSlots; ++m) {
      const int n = row + m * kRows;
      if (n < N) {
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          float* sp = st + n * P + part + k * kParts;
          *sp = *sp * tot + su[m][k];
        }
      }
    }
  }
  __syncthreads();
  float* so = p.state + ((long long)b * p.H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) so[e] = st[e];
}

int smem_bytes(int Q, int N, int P) {
  return 4 * (N * P + 2 * kRows * (N + 1) + kRows * P + kRows * kSc + 2 * Q);
}

template <int P, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  static int configured = 48 * 1024;      // dynamic smem allowed so far
  const int smem = smem_bytes(p.Q, p.N, P);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(p.H, B);
  ssd_fwd_kernel<P, T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const Params& p, int B, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8, T>(p, B, s);
    case 16: return launch<16, T>(p, B, s);
    case 32: return launch<32, T>(p, B, s);
    case 64: return launch<64, T>(p, B, s);
    case 128: return launch<128, T>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, Bm, Cm: 0 = fp32, 1 = bf16.  Strides are in elements; the
// last axis of every input is contiguous.  Q divides S.  Returns the
// cudaError_t of the launch (0 on success); the wrapper raises on others.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* state, int dtype, int B, int S, int H,
    int P, int G, int N, int Q,
    long long xsb, long long xss, long long xsh,
    long long dtsb, long long dtss,
    long long bsb, long long bss, long long bsg,
    long long csb, long long css, long long csg, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G || N <= 0 ||
      N > kMaxN || Q <= 0 || S % Q || B > 65535)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = Bm; p.c = Cm;
  p.y = static_cast<float*>(y); p.state = static_cast<float*>(state);
  p.S = S; p.H = H; p.G = G; p.N = N; p.Q = Q;
  p.xs[0] = xsb; p.xs[1] = xss; p.xs[2] = xsh;
  p.dts[0] = dtsb; p.dts[1] = dtss;
  p.bs[0] = bsb; p.bs[1] = bss; p.bs[2] = bsg;
  p.cs[0] = csb; p.cs[1] = css; p.cs[2] = csg;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(P, p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(P, p, B, s);
  return cudaErrorInvalidValue;
}
