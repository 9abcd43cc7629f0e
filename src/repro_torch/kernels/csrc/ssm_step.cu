// ssm_step.cu — one Mamba2 mixer's decode step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference decodes through plain XLA ops
// (src/repro/models/mamba2.py: mamba2_step, ssd_step).  It fuses what
// models/mamba2.py:mamba2_step does between in_proj and out_proj, some 45
// small kernels eagerly, into two launches.  For a batch row b, with the
// in_proj output row zx = [z (DI) | xBC (CD) | dt (H)], DI = H P,
// CD = DI + 2 G N, the conv rows (K - 1, CD) and the state (H, N, P):
//
//   xBC'   = silu(sum_j rows_j w_j + xBC w_{K-1} + conv_b)   (depthwise)
//   dt     = softplus(dt + dt_bias),  A = -exp(A_log)
//   S_h    = S_h exp(dt_h A_h) + dt_h B_g x_h^T             (in place)
//   y_h    = C_g . S_h + D_h x_h,     g = y silu(z)
//   out    = g rsqrt(mean(g^2) + eps) (1 + norm)
//   rows   = [rows_1 .. rows_{K-2}, xBC]                    (in place)
//
// Everything is computed in fp32; the state stays fp32.  In bf16 every
// value is rounded to bf16 where the plain step rounds it (the conv sum,
// + conv_b, the sigmoid and the product of each SiLU, y before the gate,
// the gate), so the kernel does the same work, not less.
//
// Bound on an H100: bytes.  A step reads and writes the fp32 state once,
// 2 H N P 4 bytes a row (2.1 MB each way at mamba2-1.3b), against ~8 flops
// an element; the conv rows, zx and the parameters are a few KB.
//
// ssm_decode_step: a block owns (batch row, head, 16 of the P columns)
//   with 128 threads, four a state row (a float4 each), 32 rows a pass.
//   It issues its state loads first, then computes the conv and SiLU of
//   its 16 x columns and of its group's B and C (recomputed by every
//   block of the group: 2 N channels of K taps, from L2) while they are in
//   flight; the update, C . S and the store follow in registers, C . S
//   summed over the rows by shuffles and one shared-memory pass.  It
//   writes g for its columns and the sum of their g^2.  The conv rows are
//   only read here: the B and C channels are read by every block of the
//   group, so none of them may shift them.
// ssm_decode_norm: a block owns (batch row, 256 channels); it sums the
//   row's partial g^2, normalises its columns of g in place, and shifts
//   its channels of the conv rows in place.
//
// Neither name holds "ssd_fwd": the benchmark counts kernels of that
// name against the prefill scan's launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 16;           // P columns a step block owns
constexpr int kStepThreads = 128;   // 4 threads a state row, 32 rows a pass
constexpr int kRowsPerPass = kStepThreads / 4;
constexpr int kMaxN = 128;          // largest d_state
constexpr int kPasses = kMaxN / kRowsPerPass;
constexpr int kMaxK = 8;            // largest d_conv
constexpr int kNormThreads = 256;
// channels a step block convolves: its columns and 2 N, in rounds
constexpr int kConvRounds = (kCols + 2 * kMaxN + kStepThreads - 1) /
                            kStepThreads;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float: where the plain step stores a T
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// PyTorch's sigmoid: 1 / (1 + exp(-v)) in fp32
__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}

// x * sigmoid(x) with the sigmoid rounded before the product, as
// models/mamba2._silu computes it
template <typename T>
__device__ __forceinline__ float silu(float v) {
  return rnd<T>(__fmul_rn(v, rnd<T>(sigmoid_f(v))));
}

template <typename T>
struct StepParams {
  const T* zx;          // (B, DI + CD + H)
  const T* conv;        // (B, K - 1, CD)
  float* state;         // (B, H, N, P)
  const T* conv_w;      // (K, CD)
  const T* conv_b;      // (CD,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D_skip;   // (H,)
  T* out;               // (B, DI): g, normalised in place afterwards
  float* part;          // (B, H P / kCols): sums of g^2
  int H, P, G, N, K;
};

// channel c's conv over the K - 1 stored rows and the new row, + conv_b,
// then SiLU
// (unrolled to kMaxK taps, so that every load is issued at once)
template <typename T>
__device__ __forceinline__ float conv_silu(const StepParams<T>& p,
                                           const T* rows, const T* xbc,
                                           int CD, int c) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxK - 1; ++j)
    if (j < p.K - 1)
      acc = fmaf(to_f(__ldg(rows + j * CD + c)),
                 to_f(__ldg(p.conv_w + j * CD + c)), acc);
  acc = fmaf(to_f(__ldg(xbc + c)), to_f(__ldg(p.conv_w + (p.K - 1) * CD + c)),
             acc);
  const float v = rnd<T>(__fadd_rn(rnd<T>(acc), to_f(__ldg(p.conv_b + c))));
  return silu<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
    ssm_decode_step(const StepParams<T> p) {
  __shared__ float xs[kCols], bs[kMaxN], cs[kMaxN];
  __shared__ float red[kStepThreads / 32][kCols];
  const int blocks_per_head = p.P / kCols;
  const int h = blockIdx.x / blocks_per_head;
  const int col0 = (blockIdx.x % blocks_per_head) * kCols;
  const int b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int DI = p.H * p.P, GN = p.G * p.N, CD = DI + 2 * GN;
  const T* zrow = p.zx + static_cast<int64_t>(b) * (DI + CD + p.H);
  const T* rows = p.conv + static_cast<int64_t>(b) * (p.K - 1) * CD;
  const int tid = threadIdx.x, q = tid & 3, r = tid >> 2;

  // the state loads go out first
  float* srow = p.state + (static_cast<int64_t>(b) * p.H + h) * p.N * p.P +
                col0 + 4 * q;
  float sv[kPasses][4];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int n = r + kRowsPerPass * i;
    if (n < p.N) {
      const float4 t = *reinterpret_cast<const float4*>(
          srow + static_cast<int64_t>(n) * p.P);
      sv[i][0] = t.x; sv[i][1] = t.y; sv[i][2] = t.z; sv[i][3] = t.w;
    }
  }

  // conv + SiLU of the block's x columns and of its group's B and C, in
  // rounds unrolled so that their loads overlap
#pragma unroll
  for (int round = 0; round < kConvRounds; ++round) {
    const int i = tid + round * kStepThreads;
    if (i >= kCols + 2 * p.N) break;
    if (i < kCols) {
      xs[i] = conv_silu(p, rows, zrow + DI, CD, h * p.P + col0 + i);
    } else if (i < kCols + p.N) {
      const int n = i - kCols;
      bs[n] = conv_silu(p, rows, zrow + DI, CD, DI + g * p.N + n);
    } else {
      const int n = i - kCols - p.N;
      cs[n] = conv_silu(p, rows, zrow + DI, CD, DI + GN + g * p.N + n);
    }
  }
  // softplus with PyTorch's threshold of 20
  float dt = __fadd_rn(to_f(zrow[DI + CD + h]), p.dt_bias[h]);
  dt = dt > 20.f ? dt : log1pf(expf(dt));
  const float decay = expf(__fmul_rn(dt, -expf(p.A_log[h])));
  __syncthreads();

  // s <- s decay + (dt B_n) x_p, then y_p += C_n s, as ssd_step rounds
  float y[4] = {0.f, 0.f, 0.f, 0.f};
  float xq[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) xq[e] = xs[4 * q + e];
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int n = r + kRowsPerPass * i;
    if (n < p.N) {
      const float db = __fmul_rn(dt, bs[n]), c = cs[n];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv[i][e] = __fadd_rn(__fmul_rn(sv[i][e], decay),
                             __fmul_rn(db, xq[e]));
        y[e] = fmaf(c, sv[i][e], y[e]);
      }
      *reinterpret_cast<float4*>(srow + static_cast<int64_t>(n) * p.P) =
          make_float4(sv[i][0], sv[i][1], sv[i][2], sv[i][3]);
    }
  }
  // sum y over the rows: the 8 of a warp by shuffles, the 4 warps in
  // shared memory
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      y[e] += __shfl_xor_sync(0xffffffffu, y[e], off);
  if ((tid & 31) < 4)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[tid >> 5][4 * q + e] = y[e];
  __syncthreads();

  if (tid < kCols) {
    float yc = 0.f;
#pragma unroll
    for (int w = 0; w < kStepThreads / 32; ++w) yc += red[w][tid];
    const int col = h * p.P + col0 + tid;
    yc = rnd<T>(__fadd_rn(yc, __fmul_rn(p.D_skip[h], xs[tid])));
    const float gate = rnd<T>(__fmul_rn(yc, silu<T>(to_f(zrow[col]))));
    p.out[static_cast<int64_t>(b) * DI + col] = from_f<T>(gate);
    float sq = __fmul_rn(gate, gate);
#pragma unroll
    for (int off = kCols / 2; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0x0000ffffu, sq, off);
    if (tid == 0)
      p.part[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = sq;
  }
}

template <typename T>
struct NormParams {
  T* out;              // (B, DI)
  const float* part;   // (B, nparts)
  const T* norm;       // (DI,)
  T* conv;             // (B, K - 1, CD)
  const T* zx;         // (B, DI + CD + H)
  int DI, CD, H, K, nparts;
  float inv_di, eps;
};

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    ssm_decode_norm(const NormParams<T> p) {
  __shared__ float warp_sum[kNormThreads / 32];
  __shared__ float total;
  const int b = blockIdx.y, tid = threadIdx.x;
  float acc = 0.f;
  for (int i = tid; i < p.nparts; i += kNormThreads)
    acc += p.part[static_cast<int64_t>(b) * p.nparts + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kNormThreads / 32; ++w) t += warp_sum[w];
    total = t;
  }
  __syncthreads();
  // rmsnorm as models/layers.rmsnorm: g rsqrt(mean + eps), then (1 + norm)
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(total, p.inv_di), p.eps));
  const int c = blockIdx.x * kNormThreads + tid;
  if (c < p.DI) {
    T* o = p.out + static_cast<int64_t>(b) * p.DI + c;
    const float v = __fmul_rn(__fmul_rn(to_f(*o), rstd),
                              __fadd_rn(1.f, to_f(p.norm[c])));
    *o = from_f<T>(v);
  }
  if (c < p.CD) {
    T* rows = p.conv + static_cast<int64_t>(b) * (p.K - 1) * p.CD + c;
    for (int j = 0; j + 1 < p.K - 1; ++j) rows[j * p.CD] = rows[(j + 1) * p.CD];
    rows[(p.K - 2) * p.CD] =
        p.zx[static_cast<int64_t>(b) * (p.DI + p.CD + p.H) + p.DI + c];
  }
}

template <typename T>
cudaError_t launch(const void* zx, void* conv, void* state,
                   const void* conv_w, const void* conv_b,
                   const void* dt_bias, const void* A_log,
                   const void* D_skip, const void* norm, void* out,
                   void* part, int B, int H, int P, int G, int N, int K,
                   float eps, cudaStream_t stream) {
  StepParams<T> sp;
  sp.zx = static_cast<const T*>(zx);
  sp.conv = static_cast<const T*>(conv);
  sp.state = static_cast<float*>(state);
  sp.conv_w = static_cast<const T*>(conv_w);
  sp.conv_b = static_cast<const T*>(conv_b);
  sp.dt_bias = static_cast<const float*>(dt_bias);
  sp.A_log = static_cast<const float*>(A_log);
  sp.D_skip = static_cast<const float*>(D_skip);
  sp.out = static_cast<T*>(out);
  sp.part = static_cast<float*>(part);
  sp.H = H; sp.P = P; sp.G = G; sp.N = N; sp.K = K;
  const int nparts = H * (P / kCols);
  ssm_decode_step<T><<<dim3(nparts, B), kStepThreads, 0, stream>>>(sp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  NormParams<T> np;
  np.out = static_cast<T*>(out);
  np.part = static_cast<const float*>(part);
  np.norm = static_cast<const T*>(norm);
  np.conv = static_cast<T*>(conv);
  np.zx = static_cast<const T*>(zx);
  np.DI = H * P; np.CD = H * P + 2 * G * N; np.H = H; np.K = K;
  np.nparts = nparts;
  // as torch.mean scales its sum: by 1 / n, rounded to fp32
  np.inv_di = 1.f / static_cast<float>(np.DI);
  np.eps = eps;
  const int slices = (np.CD + kNormThreads - 1) / kNormThreads;
  ssm_decode_norm<T><<<dim3(slices, B), kNormThreads, 0, stream>>>(np);
  return cudaGetLastError();
}

}  // namespace

// One decode step of one Mamba2 mixer on `stream`: updates `state` and
// `conv` in place and writes the normalised gated output to `out`;
// `part` is scratch of B * H * (P / 16) floats.  dtype 0 is fp32, 1 bf16
// (zx, conv, conv_w, conv_b, norm, out; state, dt_bias, A_log, D_skip are
// fp32).  Returns a cudaError_t (0 on success).
extern "C" int ssm_decode(const void* zx, void* conv, void* state,
                          const void* conv_w, const void* conv_b,
                          const void* dt_bias, const void* A_log,
                          const void* D_skip, const void* norm, void* out,
                          void* part, int dtype, int B, int H, int P, int G,
                          int N, int K, float eps, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || P < kCols || P % kCols || G < 1 ||
      H % G || N < 1 || N > kMaxN || K < 2 || K > kMaxK)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(zx, conv, state, conv_w, conv_b, dt_bias, A_log,
                         D_skip, norm, out, part, B, H, P, G, N, K, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(zx, conv, state, conv_w, conv_b, dt_bias,
                                 A_log, D_skip, norm, out, part, B, H, P, G,
                                 N, K, eps, s);
  return cudaErrorInvalidValue;
}
