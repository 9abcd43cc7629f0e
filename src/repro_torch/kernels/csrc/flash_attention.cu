// flash_attention.cu — GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:34
// (_kernel, launched by _flash_fwd).  For q (B, Sq, H, d) and k, v
// (B, Skv, K, d), bf16 or fp32, read in that layout through strides, it
// writes out (B, Sq, H, d) in q's dtype:
//
//   s[i, j]  = (q_i . k_j) * d^-1/2, then softcap * tanh(s / softcap)
//              when softcap != 0; -1e30 where the key is masked:
//              j > i (causal), j <= i - window (window > 0), j >= kv_len
//   out[i]   = softmax_j(s[i, :]) . v, by the online softmax over KV tiles
//
// with query head h reading KV head h / (H / K).  All arithmetic is fp32:
// per tile m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum p, acc = acc * corr + p . v; then acc / max(l, 1e-30).
// These are the reference's formulas, so a row whose early tiles are fully
// masked comes out as the reference's does (its corr is exp(-1e30 - m) = 0).
//
// Bound on an H100: 4 d flops per visible (query, key) pair and head
// (qwen2, d = 128: 512 per pair) against q, k, v, out read or written once
// (about 2 d bytes per query row and head in bf16): above a few hundred
// keys per row the work, not the bytes, bounds it.  This first kernel is
// simple and right, not fast: it runs on the CUDA cores in fp32 (67 TFLOP/s
// peak, not the 989 of bf16 wgmma).  What the design does:
//   * the TPU ran KV blocks as a sequential grid axis with m, l, acc in VMEM
//     scratch; here a block owns one (batch, head, 64-row query tile) and
//     loops over the KV tiles itself, so m, l and acc stay in registers and
//     the output is written once;
//   * four threads share a query row, each holding a quarter of q and acc
//     (as float4s, interleaved so a warp's shared-memory reads are four
//     neighbouring float4 broadcasts); the four partial dot products meet
//     by two shuffles;
//   * a 32-row K and V tile is staged in shared memory as fp32 by the whole
//     block (coalesced reads along d), and feeds 64 query rows;
//   * tiles that lie entirely above the causal diagonal or before the
//     window are skipped: for every row they are fully masked after (or,
//     with a window, before) a visible key, where the update is exact
//     (p = 0, corr = 1) or wiped (corr = 0);
//   * a row that sees no key at all (qi >= kv_len + window - 1 with a
//     window, or kv_len = 0) gets the reference's answer directly: there
//     every tile is fully masked, so p = exp(-1e30 + 1e30) = 1 at each of
//     the kv_pad positions of its padded KV (Skv rounded up to the
//     reference's KV tile), and out = (v summed over the Skv rows) / kv_pad.
// Head widths 32, 64, 112 (zamba2-7b: 7 float4 chunks per thread), 128
// and 224.  Shared memory is 2 * 32 * d * 4 bytes: 28 KB at d = 112, 32 KB
// at d = 128, 56 KB at d = 224, which takes the dynamic-shared-memory
// attribute.  wgmma, TMA and
// bf16 tensor-core tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kSplit = 4;                 // threads per query row
constexpr int kThreads = kRows * kSplit;
constexpr int kBK = 32;                   // KV rows per shared-memory tile
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, G, kv_len, kv_pad;
  long long qs[3], ks[3], vs[3], os[3];   // batch, sequence, head strides
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int C = D / 16;               // float4 chunks per thread
  constexpr int D4 = D / 4;               // float4s per row
  extern __shared__ float4 smem[];
  float4* ks = smem;                      // [kBK][D4]
  float4* vs = smem + kBK * D4;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int row = tid / kSplit, part = tid % kSplit;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.G;
  const int q0 = blockIdx.x * kRows, qi = q0 + row;
  const bool live = qi < p.Sq;

  // thread `part` owns elements c * 16 + part * 4 + {0..3} of its row
  float4 qr[C], acc[C];
  const T* qrow = q + b * p.qs[0] + (long long)qi * p.qs[1] + h * p.qs[2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = c * 16 + part * 4;
    qr[c] = live ? make_float4(to_f32(qrow[e]), to_f32(qrow[e + 1]),
                               to_f32(qrow[e + 2]), to_f32(qrow[e + 3]))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg, l = 0.f;
  bool seen = false;                      // any visible key in the row

  int hi = p.kv_len;
  if (p.causal) hi = min(hi, q0 + kRows);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1) / kBK * kBK;

  const T* kb = k + b * p.ks[0] + kh * p.ks[2];
  const T* vb = v + b * p.vs[0] + kh * p.vs[2];
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();                      // the previous tile is consumed
    for (int t = tid; t < kBK * D; t += kThreads) {
      const int r = t / D, c = t % D, kk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kk < p.kv_len) {
        kx = to_f32(kb[kk * p.ks[1] + c]);
        vx = to_f32(vb[kk * p.vs[1] + c]);
      }
      ksf[t] = kx;
      vsf[t] = vx;
    }
    __syncthreads();

    float s[kBK];
    float mcur = kNeg;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kx = ks[j * D4 + c * 4 + part];
        dot = fmaf(qr[c].x, kx.x, dot);
        dot = fmaf(qr[c].y, kx.y, dot);
        dot = fmaf(qr[c].z, kx.z, dot);
        dot = fmaf(qr[c].w, kx.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float sv = dot * p.scale;
      if (p.softcap != 0.f) sv = p.softcap * tanhf(sv / p.softcap);
      const int kp = k0 + j;
      const bool ok = kp < p.kv_len && (!p.causal || kp <= qi) &&
                      (p.window <= 0 || kp > qi - p.window);
      seen |= ok;
      s[j] = ok ? sv : kNeg;
      mcur = fmaxf(mcur, s[j]);
    }
    const float mnew = fmaxf(m, mcur);
    const float corr = expf(m - mnew);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - mnew);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vx = vs[j * D4 + c * 4 + part];
        acc[c].x = fmaf(s[j], vx.x, acc[c].x);
        acc[c].y = fmaf(s[j], vx.y, acc[c].y);
        acc[c].z = fmaf(s[j], vx.z, acc[c].z);
        acc[c].w = fmaf(s[j], vx.w, acc[c].w);
      }
    }
    m = mnew;
  }

  if (live && !seen) {                    // the reference's empty row
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < p.Skv; ++j) {
      const T* vr = vb + j * p.vs[1];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * 16 + part * 4;
        acc[c].x += to_f32(vr[e]);
        acc[c].y += to_f32(vr[e + 1]);
        acc[c].z += to_f32(vr[e + 2]);
        acc[c].w += to_f32(vr[e + 3]);
      }
    }
    l = (float)p.kv_pad;
  }
  if (live) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + b * p.os[0] + (long long)qi * p.os[1] + h * p.os[2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = c * 16 + part * 4;
      store(orow + e, acc[c].x / den);
      store(orow + e + 1, acc[c].y / den);
      store(orow + e + 2, acc[c].z / den);
      store(orow + e + 3, acc[c].w / den);
    }
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int smem = 2 * kBK * D * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D, T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Params& p, int B, int H, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, T>(p, B, H, s);
    case 64: return launch<64, T>(p, B, H, s);
    case 112: return launch<112, T>(p, B, H, s);
    case 128: return launch<128, T>(p, B, H, s);
    case 224: return launch<224, T>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  Strides are in elements.  kv_pad: Skv
// rounded up to the reference's KV tile.  Returns the cudaError_t of the
// launch (0 on success); the wrapper raises on others.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int d,
    int B, int Sq, int Skv, int H, int K, int kv_len, int kv_pad,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || K <= 0 || H % K || B > 65535 ||
      H > 65535 || kv_len > Skv || kv_pad < Skv)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Sq = Sq; p.Skv = Skv; p.G = H / K; p.kv_len = kv_len;
  p.kv_pad = kv_pad;
  p.qs[0] = qsb; p.qs[1] = qss; p.qs[2] = qsh;
  p.ks[0] = ksb; p.ks[1] = kss; p.ks[2] = ksh;
  p.vs[0] = vsb; p.vs[1] = vss; p.vs[2] = vsh;
  p.os[0] = osb; p.os[1] = oss; p.os[2] = osh;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(d, p, B, H, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, p, B, H, s);
  return cudaErrorInvalidValue;
}
