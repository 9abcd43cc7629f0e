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
// with query head h reading KV head h / (H / K).  Per tile, in fp32:
// m_new = max(m, rowmax), p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum p, acc = acc * corr + p . v; then acc / max(l, 1e-30).
// These are the reference's formulas, so a row whose early tiles are fully
// masked comes out as the reference's does (its corr is exp(-1e30 - m) = 0).
// A row that sees no key at all (qi >= kv_len + window - 1 with a window,
// or kv_len = 0) gets the reference's answer directly: there every tile is
// fully masked, so p = exp(-1e30 + 1e30) = 1 at each of the kv_pad
// positions of its padded KV (Skv rounded up to the reference's KV tile),
// and out = (v summed over the Skv rows) / kv_pad.
//
// Bound on an H100: 4 d flops per visible (query, key) pair and head
// (qwen2, d = 128: 512 per pair) against q, k, v, out read or written once
// (about 2 d bytes per query row and head in bf16): above a few hundred
// keys per row the work, not the bytes, bounds it.  The dtype picks one of
// two kernels:
//
// bf16: flash_fwd_wgmma, on the tensor cores (989 TFLOP/s dense bf16).
//   * A block is two consumer warpgroups (256 threads) and owns a (batch,
//     head, 128-row query tile): each warpgroup 64 rows, each warp 16;
//     both read every K/V tile the block loads.  Query tiles run
//     last-first, so the long causal rows start first.  A warpgroup skips
//     a tile that is fully masked for its rows after (causal) or before
//     (window) their visible keys, and a tile visible to all its rows
//     skips the mask arithmetic.
//   * Q, K and V arrive by TMA (tensor maps encoded on the host per call:
//     4-D (d, S, heads, B) through the caller's strides, 64 x 64 boxes of
//     128-byte rows, 128-byte swizzle, zero fill past every edge).  d is
//     cut into 64-column chunks (d = 112 and 224 read zeros past d).  K
//     and V tiles of 64 keys run through a two-stage ring, each stage
//     completed on its own mbarrier; thread 0 refills a stage as soon as
//     the warpgroup has finished the two products that read it, so the
//     next tile's copy overlaps this tile's work.
//   * S = Q . K^T is d/16 wgmma m64n64k16 steps, both operands K-major in
//     shared memory; the online softmax runs on the fp32 accumulator
//     fragments (a row's 64 scores are spread over a quad of threads: the
//     row max and the visible flag meet by two shuffles).
//   * O += P . V takes P from registers (the S accumulator is the A
//     fragment layout) and V from shared memory as an MN-major operand,
//     one m64n64k16 per 64-column chunk of d and 16 keys.  P enters in
//     bf16 as hi + lo (hi = bf16(p), lo = bf16(p - hi)), two products per
//     step, which leaves ~2^-17 of p: P rounded once to bf16 put up to
//     2.9x the bf16 tolerance (1e-3 + 2^-7 |plain|) between kernel and
//     plain version on the serving shapes, hi + lo at most 0.8x
//     (tests/test_torch_flash_attention.py emulates both on the CPU).
//   * Tiles above the causal diagonal or before the window are skipped.
//   * Shared memory: Q (2 x d/64 chunks of 8 KB) and two stages of K and
//     V: 96 KB at d = 128 (two blocks, four warpgroups per SM), 192 KB at
//     d = 224 and 256 (both four chunks; 256 takes 16 k steps of Q . K^T,
//     224 takes 14 and reads zeros past d).
//   * Not yet here: warp specialisation (a producer warp, consumers in
//     ping-pong) and the next tile's Q . K^T issued before this tile's
//     softmax, so a warpgroup's softmax does not overlap its own products;
//     the other warpgroups on the SM overlap them instead.
// fp32: flash_fwd_kernel, on the CUDA cores in fp32 (the first design, kept
//   for the 2e-5 tolerance of fp32 inputs): a block owns a (batch, head,
//   64-row query tile) and walks 32-row KV tiles staged in shared memory as
//   fp32; four threads share a query row, each holding a quarter of q and
//   acc as float4s; the partial dot products meet by two shuffles.
//   Shared memory 2 * 32 * d * 4 bytes (64 KB at d = 256, above the 48 KB
//   default, so the launch raises the limit first).
// Head widths 32, 64, 112 (zamba2-7b), 128, 224 (gemma2) and 256
// (paligemma-3b).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int C = D / 16;               // float4 chunks per thread
  constexpr int D4 = D / 4;               // float4s per row
  extern __shared__ float4 smem[];
  float4* ks = smem;                      // [kBK][D4]
  float4* vs = smem + kBK * D4;

  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);
  float* __restrict__ o = static_cast<float*>(p.o);

  const int tid = threadIdx.x;
  const int row = tid / kSplit, part = tid % kSplit;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / p.G;
  const int q0 = blockIdx.x * kRows, qi = q0 + row;
  const bool live = qi < p.Sq;

  // thread `part` owns elements c * 16 + part * 4 + {0..3} of its row
  float4 qr[C], acc[C];
  const float* qrow = q + b * p.qs[0] + (long long)qi * p.qs[1] + h * p.qs[2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = c * 16 + part * 4;
    qr[c] = live ? make_float4(qrow[e], qrow[e + 1], qrow[e + 2],
                               qrow[e + 3])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg, l = 0.f;
  bool seen = false;                      // any visible key in the row

  int hi = p.kv_len;
  if (p.causal) hi = min(hi, q0 + kRows);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1) / kBK * kBK;

  const float* kb = k + b * p.ks[0] + kh * p.ks[2];
  const float* vb = v + b * p.vs[0] + kh * p.vs[2];
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();                      // the previous tile is consumed
    for (int t = tid; t < kBK * D; t += kThreads) {
      const int r = t / D, c = t % D, kk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kk < p.kv_len) {
        kx = kb[kk * p.ks[1] + c];
        vx = vb[kk * p.vs[1] + c];
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
      const float* vr = vb + j * p.vs[1];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int e = c * 16 + part * 4;
        acc[c].x += vr[e];
        acc[c].y += vr[e + 1];
        acc[c].z += vr[e + 2];
        acc[c].w += vr[e + 3];
      }
    }
    l = (float)p.kv_pad;
  }
  if (live) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = o + b * p.os[0] + (long long)qi * p.os[1] + h * p.os[2];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = c * 16 + part * 4;
      orow[e] = acc[c].x / den;
      orow[e + 1] = acc[c].y / den;
      orow[e + 2] = acc[c].z / den;
      orow[e + 3] = acc[c].w / den;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                 // query rows and keys per tile
constexpr int kChunkBytes = 64 * 64 * 2;  // one 64 x 64 bf16 box
constexpr int kWgs = 2;                   // consumer warpgroups per block
constexpr int kBlockRows = kWgs * kTile;  // query rows per block
constexpr int kWgThreads = 128 * kWgs;

struct TmaParams {
  CUtensorMap q, k, v;                    // 4-D (d, S, heads, B) maps
  const __nv_bfloat16* vp;                // v, for rows that see no key
  __nv_bfloat16* o;
  int Sq, Skv, G, kv_len, kv_pad;
  long long vs[3], os[3];                 // batch, sequence, head strides
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor of a 1024-aligned tile of 128-byte rows
// in the 128-byte swizzle (what TMA wrote): 8-row groups 1024 bytes apart
// (SBO); the leading offset is unused for these tiles (K-major with K
// inside one row, or MN-major with N = 64, one swizzle atom).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 box at (column c0, row c1, head c2, batch c3) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving register traffic across async wgmma
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 fp32) (+)= A (smem, K-major) . B (smem, K-major), k = 16
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the hi and lo bf16 pairs of (x, y): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x);
  const __nv_bfloat16 yh = __float2bfloat16_rn(y);
  hi = pack_bf16(__bfloat162float(xh), __bfloat162float(yh));
  lo = pack_bf16(x - __bfloat162float(xh), y - __bfloat162float(yh));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads)
flash_fwd_wgmma(const __grid_constant__ TmaParams p) {
  constexpr int NC = (D + 63) / 64;       // 64-column chunks of d
  constexpr int KS = D / 16;              // k steps of Q . K^T
  constexpr int kStage = 2 * NC * kChunkBytes;   // K and V of one tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                     // kWgs x NC chunks
  uint8_t* kv = base + kWgs * NC * kChunkBytes;  // two stages: K, V chunks
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + 2 * kStage);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;     // long causal rows first
  const int q0 = qt * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.G;
  const int a0 = q0 + kTile * wg;         // this warpgroup's first row
  int hi = p.kv_len;
  if (p.causal) hi = min(hi, q0 + kBlockRows);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / kTile * kTile
                              : 0;
  const int ntiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int t) {
    uint8_t* st = kv + (t & 1) * kStage;
    uint64_t* bar = &bars[1 + (t & 1)];
    mbar_expect(bar, kStage);
    for (int c = 0; c < NC; ++c) {
      tma_load(st + c * kChunkBytes, &p.k, bar, 64 * c, lo + t * kTile, kh,
               b);
      tma_load(st + (NC + c) * kChunkBytes, &p.v, bar, 64 * c,
               lo + t * kTile, kh, b);
    }
  };
  if (tid == 0) {
    mbar_expect(&bars[0], kWgs * NC * kChunkBytes);
    for (int w = 0; w < kWgs; ++w)
      for (int c = 0; c < NC; ++c)
        tma_load(qs + (w * NC + c) * kChunkBytes, &p.q, &bars[0], 64 * c,
                 q0 + kTile * w, h, b);
    for (int t = 0; t < min(2, ntiles); ++t) load_kv(t);
  }

  // this thread's rows and columns of every 64 x 64 fragment: rows
  // r0 = a0 + 16 warp + lane / 4 and r0 + 8; in each 8-column block j,
  // columns 8 j + 2 (lane % 4) and the next
  const int r0 = a0 + warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  bool seen[2] = {false, false};
  const uint32_t q_addr = smem_u32(qs + wg * NC * kChunkBytes);

  mbar_wait(&bars[0], 0);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = lo + t * kTile;
    const uint32_t k_addr = smem_u32(kv + (t & 1) * kStage);
    const uint32_t v_addr = k_addr + NC * kChunkBytes;
    mbar_wait(&bars[1 + (t & 1)], (t >> 1) & 1);
    // a tile that this warpgroup's rows see nothing of after (causal) or
    // before (window) their visible keys changes nothing: p = 0 there, or
    // its p = 1 would be wiped by corr = 0 at the first visible key
    const bool skip = a0 >= p.Sq || (p.causal && k0 > a0 + kTile - 1) ||
                      (p.window > 0 && k0 + kTile - 1 <= a0 - p.window);
    // every key of the tile visible to every row: no mask work
    const bool full = k0 + kTile <= p.kv_len &&
                      (!p.causal || k0 + kTile - 1 <= a0) &&
                      (p.window <= 0 || k0 > a0 + kTile - 1 - p.window);
    if (!skip) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    keep(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(q_addr + off), sw128_desc(k_addr + off), 1);
    }
    wg_commit();
    wg_wait();
    keep(s);

    // scale, softcap, mask; the row max over the quad
    float mcur[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= p.scale;
      if (p.softcap != 0.f) s[i] = p.softcap * tanhf(s[i] / p.softcap);
    }
    if (full) {
      seen[0] = seen[1] = true;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = r0 + ((i & 2) ? 8 : 0);
        const int kp = k0 + 8 * (i / 4) + c2 + (i & 1);
        const bool ok = kp < p.kv_len && (!p.causal || kp <= qi) &&
                        (p.window <= 0 || kp > qi - p.window);
        seen[(i >> 1) & 1] |= ok;
        s[i] = ok ? s[i] : kNeg;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mcur[(i >> 1) & 1] = fmaxf(mcur[(i >> 1) & 1], s[i]);
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 1));
      mcur[r] = fmaxf(mcur[r], __shfl_xor_sync(0xffffffffu, mcur[r], 2));
      const float mnew = fmaxf(m[r], mcur[r]);
      corr[r] = __expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __expf(s[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];  // partial
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // P as the A fragments of four k = 16 steps, hi and lo
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_pack(s[8 * k + 2 * e], s[8 * k + 2 * e + 1], ph[k][e],
                   pl[k][e]);
#pragma unroll
    for (int c = 0; c < NC; ++c) keep(o[c]);
#pragma unroll
    for (int k = 0; k < 4; ++k) { keep(ph[k]); keep(pl[k]); }
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t dv = sw128_desc(v_addr + c * kChunkBytes + k * 2048);
        wgmma_rs(o[c], ph[k], dv);
        wgmma_rs(o[c], pl[k], dv);
      }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int c = 0; c < NC; ++c) keep(o[c]);
#pragma unroll
    for (int k = 0; k < 4; ++k) { keep(ph[k]); keep(pl[k]); }
    }
    __syncthreads();                      // every warp is done with stage
    if (tid == 0 && t + 2 < ntiles) load_kv(t + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    seen[r] = __shfl_xor_sync(0xffffffffu, (int)seen[r], 1) | seen[r];
    seen[r] = __shfl_xor_sync(0xffffffffu, (int)seen[r], 2) | seen[r];
  }
  const __nv_bfloat16* vb = p.vp + b * p.vs[0] + kh * p.vs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= p.Sq) continue;
    if (!seen[r]) {                       // the reference's empty row
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[c][4 * j + 2 * r] = o[c][4 * j + 2 * r + 1] = 0.f;
      for (int kk = 0; kk < p.Skv; ++kk) {
        const __nv_bfloat16* vr = vb + kk * p.vs[1];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * c + 8 * j + c2;
            if (col < D) {
              o[c][4 * j + 2 * r] += __bfloat162float(vr[col]);
              o[c][4 * j + 2 * r + 1] += __bfloat162float(vr[col + 1]);
            }
          }
      }
      l[r] = (float)p.kv_pad;
    }
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = p.o + b * p.os[0] + (long long)qi * p.os[1] +
                          h * p.os[2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + c2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[c][4 * j + 2 * r] / den,
                        o[c][4 * j + 2 * r + 1] / den);
      }
  }
}

template <int D>
cudaError_t launch_wgmma(const TmaParams& p, int B, int H,
                         cudaStream_t stream) {
  constexpr int NC = (D + 63) / 64;
  const int smem = 1024 + (kWgs + 4) * NC * kChunkBytes + 64;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.Sq + kBlockRows - 1) / kBlockRows, H, B);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(int d, const TmaParams& p, int B, int H,
                           cudaStream_t s) {
  switch (d) {
    case 32: return launch_wgmma<32>(p, B, H, s);
    case 64: return launch_wgmma<64>(p, B, H, s);
    case 112: return launch_wgmma<112>(p, B, H, s);
    case 128: return launch_wgmma<128>(p, B, H, s);
    case 224: return launch_wgmma<224>(p, B, H, s);
    case 256: return launch_wgmma<256>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (d, S, heads, B) bf16 through element strides (sequence, head, batch);
// 64 x 64 boxes, 128-byte swizzle, zeros past every edge
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d, int S,
            int heads, int B, long long ss, long long sh, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int smem = 2 * kBK * D * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(int d, const Params& p, int B, int H,
                          cudaStream_t s) {
  switch (d) {
    case 32: return launch<32>(p, B, H, s);
    case 64: return launch<64>(p, B, H, s);
    case 112: return launch<112>(p, B, H, s);
    case 128: return launch<128>(p, B, H, s);
    case 224: return launch<224>(p, B, H, s);
    case 256: return launch<256>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32 (CUDA cores), 1 = bf16 (wgmma; every stride a multiple
// of 8 elements and the bases 16-byte aligned, as TMA needs).  Strides are
// in elements.  kv_pad: Skv rounded up to the reference's KV tile.
// Returns the cudaError_t of the launch (0 on success); the wrapper raises
// on others.
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (Skv <= 0) return cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return cudaErrorInvalidValue;
    TmaParams p;
    if (!encode(enc, &p.q, q, d, Sq, H, B, qss, qsh, qsb) ||
        !encode(enc, &p.k, k, d, Skv, K, B, kss, ksh, ksb) ||
        !encode(enc, &p.v, v, d, Skv, K, B, vss, vsh, vsb))
      return cudaErrorInvalidValue;
    p.vp = static_cast<const __nv_bfloat16*>(v);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.Sq = Sq; p.Skv = Skv; p.G = H / K; p.kv_len = kv_len;
    p.kv_pad = kv_pad;
    p.vs[0] = vsb; p.vs[1] = vss; p.vs[2] = vsh;
    p.os[0] = osb; p.os[1] = oss; p.os[2] = osh;
    p.causal = causal; p.window = window;
    p.softcap = softcap; p.scale = scale;
    return dispatch_wgmma(d, p, B, H, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
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
  return dispatch_fp32(d, p, B, H, s);
}
