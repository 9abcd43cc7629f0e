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
// x, Bm and Cm are read through strides (the conv output they are split
// from is not copied); dt and A are fp32.  Bound on an H100: per chunk and
// group 2 Q^2 N flops for C . B^T, per head Q(Q+1)/2 (2P + 3) for the
// masked scores times x and 4 Q N P for the state read and update, against
// x, B, C, dt read once and y and the state written once.  At the serving
// shapes (Q = 16) the bytes bound it, on the tensor cores at Q = 256 too.
// The dtype of x, Bm, Cm picks one of two kernels:
//
// bf16: ssd_fwd_mma, the four products on the tensor cores as
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  m16n8k16 rather than
//   wgmma: at the serving chunk (Q = 16) one m16 fragment covers the chunk
//   and a 64-row wgmma tile would be three quarters empty; the one product
//   with M >= 64 (the state update, M = N) shares its fragments' loads
//   with the rest of the per-warp loop and stays on mma.sync.
//   * A block owns (batch, a run of R <= 4 heads of one group, a slice of
//     PS = 8 or 16 of the P columns); warp w is head h0 + w.  The entry
//     point picks the largest R whose block fits in shared memory, and
//     halves PS when the grid would not fill the device's SMs (B = 1).
//   * C . B^T is computed once per (batch, group, chunk) and block, in
//     16-row tiles shared by the block's heads through shared memory
//     (fp32); each head then applies its own exp(cum_i - cum_j), masked to
//     j <= i before the exp (as the reference), and dt_j.
//   * x, B and C are exact in bf16.  The three fp32 operands enter as
//     hi + lo bf16 pairs, two products each (~2^-17 of the value left):
//     the decay-weighted scores, the state S_prev (its split copy, [p][n]
//     in shared memory, feeds C . S_prev), and w * x with
//     w = exp(cum_last - cum) dt (the weight sits on x, not on B, because
//     a B operand fragment of x serves all N/16 row tiles of the update).
//     The carried state is the update's fp32 accumulator in registers and
//     is never rounded.
//   * A chunk is walked in sub-chunks of at most 64 rows, the state passed
//     between them as between chunks (the SSD's state-passing form holds
//     for any split, so this is the same function): at Q = 256 that is a
//     quarter of the intra-chunk work and of the shared memory.
//   * A sub-chunk's C, B and x rows and dt arrive by cp.async (16 bytes;
//     4 for dt) into one of two buffers while the previous sub-chunk is
//     computed; C and B with an XOR swizzle of their 16-byte groups
//     against bank conflicts; zero fill for rows past the sub-chunk
//     (padded to 16) and for N padded to 16 m.  Padded rows carry
//     x = B = C = dt = 0, which leaves cum and the state untouched, and
//     are not written.
//   * The final state leaves through shared memory as 16-byte stores.
//   * Not yet here: a persistent grid; at B = 1 the 128 blocks of 4 warps
//     leave the SMs latency-bound.
// fp32: ssd_fwd_kernel, on the CUDA cores (the first design, kept for fp32
//   inputs): one block per (batch, head) walks every chunk with the (N, P)
//   fp32 state in shared memory and the chunk in 32-row tiles (the
//   diagonal tile masked before the exp); C . B^T recomputed per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// rows [r0, r0 + rows) of a (S, width) operand, starting at `base` with row
// stride `rs`, into smem rows of stride `ld`; rows past `rows` are zero
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* base,
                                          long long rs, int r0, int rows,
                                          int width) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const int r = e / width, col = e % width;
    dst[r * ld + col] =
        r < rows ? base[(long long)(r0 + r) * rs + col] : 0.f;
  }
}

template <int P>
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

  const float* xb =
      static_cast<const float*>(p.x) + b * p.xs[0] + h * p.xs[2];
  const float* dtb = p.dt + b * p.dts[0] + h;
  const float* bb =
      static_cast<const float*>(p.b) + b * p.bs[0] + g * p.bs[2];
  const float* cb =
      static_cast<const float*>(p.c) + b * p.cs[0] + g * p.cs[2];
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


// ---------------------------------------------------------------------------
// bf16 route: mma.sync tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kMaxHeads = 4;              // heads (one warp each) per block

struct MmaParams {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  float* y;
  float* state;
  int S, H, G, N, Q, P, R;
  long long xs[3], dts[2], bs[3], cs[3];  // strides in elements
};

// a chunk is walked in sub-chunks of at most kSub rows (the state passed
// between them: the same function, since the SSD's state-passing form
// holds for any split of the sequence)
constexpr int kSub = 64;

// byte offsets of one block's shared memory:
// two buffers, each the C and B rows of a sub-chunk [Tp][NP] (swizzled),
// x [R][Tp][PS] and dt [R][Tp]; then the C.B^T row tile [16][Tp + 4]
// fp32, cum [R][Tp] and the split state [R][hi, lo][PS][NP + 8]; the
// final state's staging [R][NP][PS] fp32 reuses all of it.  Tp is the
// sub-chunk's rows padded to 16.
struct MmaSmem {
  int c, b, x, dt, buf, cb, cum, ss, total;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline MmaSmem mma_smem(int Q, int NP, int PS, int R) {
  const int Tp = round16(Q < kSub ? Q : kSub);
  MmaSmem m;
  m.c = 0;
  m.b = m.c + Tp * NP * 2;
  m.x = m.b + Tp * NP * 2;
  m.dt = m.x + R * Tp * PS * 2;
  m.buf = m.dt + R * Tp * 4;
  m.cb = 2 * m.buf;
  m.cum = m.cb + 16 * (Tp + 4) * 4;
  m.ss = m.cum + R * Tp * 4;
  const int main = m.ss + R * 2 * PS * (NP + 8) * 2;
  const int stage = R * NP * PS * 4;
  m.total = main > stage ? main : stage;
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row r, column n) in a [rows][NP] tile whose 16-byte
// groups are XOR-swizzled by the row
template <int NP>
__device__ __forceinline__ int swz(int r, int n) {
  constexpr int CH = NP / 8;
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  return r * NP + ((((n >> 3) ^ (r & MASK))) << 3) + (n & 7);
}

// the bf16 pair at (r, n), (r, n + 1) of a swizzled [rows][NP] tile
template <int NP>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* t, int r,
                                            int n) {
  return *reinterpret_cast<const uint32_t*>(t + swz<NP>(r, n));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool real) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(real ? 4 : 0)
               : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the hi and lo bf16 pairs of (x, y): hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  hi = pack_bf16(xh, yh);
  lo = pack_bf16(x - xh, y - yh);
}

template <int PS, int MT>
__global__ void __launch_bounds__(kMaxHeads * 32)
ssd_fwd_mma(const MmaParams p) {
  constexpr int NP = 16 * MT;             // N padded to the k step
  constexpr int NB = PS / 8;              // 8-column blocks of the slice
  constexpr int CH = NP / 8;              // 16-byte groups of a B, C row
  constexpr int LDS = NP + 8;             // row of the split state
  extern __shared__ __align__(16) uint8_t ssd_smem_raw[];
  uint8_t* sm = ssd_smem_raw;
  const int Q = p.Q, R = p.R;
  const int T = Q < kSub ? Q : kSub, Tp = round16(T), ldcb = Tp + 4;
  const int per = (Q + T - 1) / T;        // sub-chunks per chunk
  const int nsub = p.S / Q * per;
  const MmaSmem L = mma_smem(Q, NP, PS, R);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8, rr = lane % 8;
  const int h0 = blockIdx.x * R, h = h0 + w, p0 = blockIdx.y * PS;
  const int b = blockIdx.z, grp = h0 / (p.H / p.G);
  const float a = p.A[h];

  float* CBs = reinterpret_cast<float*>(sm + L.cb);
  float* cum = reinterpret_cast<float*>(sm + L.cum) + w * Tp;
  __nv_bfloat16* Sh = reinterpret_cast<__nv_bfloat16*>(sm + L.ss) +
                      w * 2 * PS * LDS;
  __nv_bfloat16* Sl = Sh + PS * LDS;

  const __nv_bfloat16* xb = p.x + b * p.xs[0] + p0;
  const float* dtb = p.dt + b * p.dts[0];
  const __nv_bfloat16* bb = p.b + b * p.bs[0] + grp * p.bs[2];
  const __nv_bfloat16* cb = p.c + b * p.cs[0] + grp * p.cs[2];

  // the copies of sub-chunk u (rows start.. of length len, zeros past it)
  // into buffer u & 1
  auto issue = [&](int u) {
    const int start = u / per * Q + u % per * T;
    const int len = min(T, Q - u % per * T);
    const uint32_t base = smem_u32(sm + (u & 1) * L.buf);
    for (int e = tid; e < Tp * CH; e += blockDim.x) {
      const int r = e / CH, n = (e % CH) * 8;
      const bool real = r < len && n < p.N;
      const long long row = start + (real ? r : 0);
      const int col = real ? n : 0;
      const uint32_t off = 2 * swz<NP>(r, n);
      cp16(base + L.c + off, cb + row * p.cs[1] + col, real);
      cp16(base + L.b + off, bb + row * p.bs[1] + col, real);
    }
    for (int e = tid; e < R * Tp * NB; e += blockDim.x) {
      const int hw = e / (Tp * NB), r = (e / NB) % Tp, ch = e % NB;
      const bool real = r < len;
      cp16(base + L.x + 2 * ((hw * Tp + r) * PS + ch * 8),
           xb + (long long)(start + (real ? r : 0)) * p.xs[1] +
               (long long)(h0 + hw) * p.xs[2] + ch * 8,
           real);
    }
    for (int e = tid; e < R * Tp; e += blockDim.x) {
      const int hw = e / Tp, r = e % Tp;
      const bool real = r < len;
      cp4(base + L.dt + 4 * e,
          dtb + (long long)(start + (real ? r : 0)) * p.dts[1] + h0 + hw,
          real);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float st[MT][NB][4];                    // the carried state, fp32
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][nb][e] = 0.f;
  for (int e = lane; e < 2 * PS * LDS; e += 32)
    Sh[e] = __float2bfloat16_rn(0.f);

  issue(0);
  for (int u = 0; u < nsub; ++u) {
    const int start = u / per * Q + u % per * T;
    const int len = min(T, Q - u % per * T), lp = round16(len);
    __syncthreads();                      // sub-chunk u - 1 is consumed
    if (u + 1 < nsub) {
      issue(u + 1);                       // in flight during this one
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    uint8_t* buf = sm + (u & 1) * L.buf;
    const __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(buf + L.c);
    const uint32_t bs_a = smem_u32(buf + L.b);
    const __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(buf + L.b);
    const __nv_bfloat16* Xw =
        reinterpret_cast<__nv_bfloat16*>(buf + L.x) + w * Tp * PS;
    const uint32_t xw_a = smem_u32(Xw);
    const float* dts = reinterpret_cast<float*>(buf + L.dt) + w * Tp;

    // cum of this warp's head (padded rows: dt = 0, cum flat)
    {
      const int seg = (lp + 31) / 32;
      const int s0 = min(lp, lane * seg), s1 = min(lp, s0 + seg);
      float run = 0.f;
      for (int i = s0; i < s1; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int i = s0; i < s1; ++i) cum[i] += excl;
      __syncwarp();
    }
    const float clast = cum[lp - 1];

    for (int i0 = 0; i0 < lp; i0 += 16) {
      // C . B^T for the blocks (row tile i0, column tiles j0 <= i0), shared
      // by the block's heads
      for (int j0 = 16 * w; j0 <= i0; j0 += 16 * R) {
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int k = 0; k < MT; ++k) {
          const int n0 = 16 * k + 2 * t4;
          const uint32_t af[4] = {
              ld_pair<NP>(Cs, i0 + g, n0), ld_pair<NP>(Cs, i0 + g + 8, n0),
              ld_pair<NP>(Cs, i0 + g, n0 + 8),
              ld_pair<NP>(Cs, i0 + g + 8, n0 + 8)};
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const int j = j0 + 8 * nb + g;
            mma16816(d[nb], af, ld_pair<NP>(Bs, j, n0),
                     ld_pair<NP>(Bs, j, n0 + 8));
          }
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int j = j0 + 8 * nb + 2 * t4;
          *reinterpret_cast<float2*>(CBs + g * ldcb + j) =
              make_float2(d[nb][0], d[nb][1]);
          *reinterpret_cast<float2*>(CBs + (g + 8) * ldcb + j) =
              make_float2(d[nb][2], d[nb][3]);
        }
      }
      __syncthreads();

      // this head's rows i0..i0+15: the masked scores times x, then C times
      // the split state
      float yi[NB][4], yo[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[nb][e] = yo[nb][e] = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += 16) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e & 1) * 8, i = i0 + r;
          const int j = j0 + 2 * t4 + (e >> 1) * 8;
          const float2 v = *reinterpret_cast<const float2*>(CBs + r * ldcb + j);
          const float s0 = j <= i ? v.x * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          const float s1 =
              j + 1 <= i ? v.y * expf(cum[i] - cum[j + 1]) * dts[j + 1] : 0.f;
          split_pack(s0, s1, ah[e], al[e]);
        }
        if constexpr (NB == 2) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xw_a + 2 * ((j0 + (mi & 1) * 8 + rr) * PS +
                                    (mi >> 1) * 8));
          mma16816(yi[0], ah, xf[0], xf[1]);
          mma16816(yi[0], al, xf[0], xf[1]);
          mma16816(yi[1], ah, xf[2], xf[3]);
          mma16816(yi[1], al, xf[2], xf[3]);
        } else {
          uint32_t xf[2];
          ldsm_x2_t(xf, xw_a + 2 * ((j0 + (mi & 1) * 8 + rr) * PS));
          mma16816(yi[0], ah, xf[0], xf[1]);
          mma16816(yi[0], al, xf[0], xf[1]);
        }
      }
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const int n0 = 16 * k + 2 * t4;
        const uint32_t af[4] = {
            ld_pair<NP>(Cs, i0 + g, n0), ld_pair<NP>(Cs, i0 + g + 8, n0),
            ld_pair<NP>(Cs, i0 + g, n0 + 8),
            ld_pair<NP>(Cs, i0 + g + 8, n0 + 8)};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int o = (8 * nb + g) * LDS + n0;
          mma16816(yo[nb], af, *reinterpret_cast<const uint32_t*>(Sh + o),
                   *reinterpret_cast<const uint32_t*>(Sh + o + 8));
          mma16816(yo[nb], af, *reinterpret_cast<const uint32_t*>(Sl + o),
                   *reinterpret_cast<const uint32_t*>(Sl + o + 8));
        }
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = i0 + g + 8 * e2;
        if (i < len) {
          const float ei = expf(cum[i]);
          float* yr = p.y +
                      (((long long)b * p.S + start + i) * p.H + h) * p.P +
                      p0 + 2 * t4;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            *reinterpret_cast<float2*>(yr + 8 * nb) =
                make_float2(yi[nb][2 * e2] + ei * yo[nb][2 * e2],
                            yi[nb][2 * e2 + 1] + ei * yo[nb][2 * e2 + 1]);
        }
      }
      __syncthreads();                    // CBs is rewritten next
    }

    // the state update: S = exp(cum_last) S + B^T (w * x), hi + lo
    const float tot = expf(clast);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][nb][e] *= tot;
    for (int j0 = 0; j0 < lp; j0 += 16) {
      uint32_t wh[NB][2], wl[NB][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 2 * t4 + 8 * e;
        const float w0 = expf(clast - cum[j]) * dts[j];
        const float w1 = expf(clast - cum[j + 1]) * dts[j + 1];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const __nv_bfloat16* xr = Xw + j * PS + 8 * nb + g;
          split_pack(w0 * __bfloat162float(xr[0]),
                     w1 * __bfloat162float(xr[PS]), wh[nb][e], wl[nb][e]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];                   // B^T rows n, columns j
        ldsm_x4_t(af, bs_a + 2 * swz<NP>(j0 + (mi >> 1) * 8 + rr,
                                         16 * m + (mi & 1) * 8));
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mma16816(st[m][nb], af, wh[nb][0], wh[nb][1]);
          mma16816(st[m][nb], af, wl[nb][0], wl[nb][1]);
        }
      }
    }
    // the split copy that the next sub-chunk's C . S_prev reads ([p][n])
    __syncwarp();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * m + g + (e >> 1) * 8;
          const int pp = 8 * nb + 2 * t4 + (e & 1);
          const float v = st[m][nb][e];
          const __nv_bfloat16 vh = __float2bfloat16_rn(v);
          Sh[pp * LDS + n] = vh;
          Sl[pp * LDS + n] = __float2bfloat16_rn(v - __bfloat162float(vh));
        }
    __syncwarp();
  }

  // the final state through shared memory, as 16-byte stores
  __syncthreads();
  float* stg = reinterpret_cast<float*>(sm) + w * NP * PS;    // [NP][PS]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stg[(16 * m + g + (e >> 1) * 8) * PS + 8 * nb + 2 * t4 + (e & 1)] =
            st[m][nb][e];
  __syncwarp();
  float* so = p.state + ((long long)b * p.H + h) * p.N * p.P + p0;
  for (int e = lane; e < p.N * (PS / 4); e += 32) {
    const int n = e / (PS / 4), q4 = e % (PS / 4);
    *reinterpret_cast<float4*>(so + (long long)n * p.P + 4 * q4) =
        *reinterpret_cast<const float4*>(stg + n * PS + 4 * q4);
  }
}

int smem_bytes(int Q, int N, int P) {
  return 4 * (N * P + 2 * kRows * (N + 1) + kRows * P + kRows * kSc + 2 * Q);
}

template <int P>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  static int configured = 48 * 1024;      // dynamic smem allowed so far
  const int smem = smem_bytes(p.Q, p.N, P);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(p.H, B);
  ssd_fwd_kernel<P><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(int P, const Params& p, int B, cudaStream_t s) {
  switch (P) {
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int PS, int MT>
cudaError_t launch_mma(const MmaParams& p, int B, cudaStream_t stream) {
  static int configured = 48 * 1024;      // dynamic smem allowed so far
  const int smem = mma_smem(p.Q, 16 * MT, PS, p.R).total;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fwd_mma<PS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(p.H / p.R, p.P / PS, B);
  ssd_fwd_mma<PS, MT><<<grid, 32 * p.R, smem, stream>>>(p);
  return cudaGetLastError();
}

// m16 tiles of N, rounded up to the power of two that is instantiated
int mma_tiles(int N) {
  const int mt = (N + 15) / 16;
  return mt <= 1 ? 1 : mt <= 2 ? 2 : mt <= 4 ? 4 : 8;
}

template <int PS>
cudaError_t dispatch_mt(const MmaParams& p, int B, cudaStream_t s) {
  switch (mma_tiles(p.N)) {
    case 1: return launch_mma<PS, 1>(p, B, s);
    case 2: return launch_mma<PS, 2>(p, B, s);
    case 4: return launch_mma<PS, 4>(p, B, s);
    default: return launch_mma<PS, 8>(p, B, s);
  }
}

// The bf16 grid on the current device: R heads of one group per block,
// the largest divisor of H / G up to kMaxHeads whose block fits in shared
// memory, and PS columns of P per block, 16, or 8 when the grid would not
// fill the SMs.
cudaError_t mma_grid(int B, int H, int P, int G, int N, int Q, int* R,
                     int* PS) {
  static int dev_seen = -1, sms = 0, smem_max = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != dev_seen) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    dev_seen = dev;
  }
  const int NP = 16 * mma_tiles(N);
  *PS = P < 16 ? 8 : 16;
  *R = 0;
  for (int r = kMaxHeads; r >= 1 && *R == 0; --r)
    if ((H / G) % r == 0 && mma_smem(Q, NP, *PS, r).total <= smem_max)
      *R = r;
  if (*R == 0) return cudaErrorInvalidValue;
  if (*PS == 16 && static_cast<long long>(B) * (H / *R) * (P / 16) < sms)
    *PS = 8;
  return cudaSuccess;
}

bool valid_shape(int B, int S, int H, int P, int G, int N, int Q) {
  return B > 0 && S > 0 && H > 0 && G > 0 && H % G == 0 && N > 0 &&
         N <= kMaxN && Q > 0 && S % Q == 0 && B <= 65535 &&
         (P == 8 || P == 16 || P == 32 || P == 64 || P == 128);
}

}  // namespace

// dtype of x, Bm, Cm: 0 = fp32 (CUDA cores), 1 = bf16 (mma.sync; bases and
// strides 16-byte aligned, rows of Bm and Cm readable up to N rounded to
// 8).  Strides are in elements; the last axis of every input is
// contiguous.  Q divides S.  Returns the cudaError_t of the launch (0 on
// success); the wrapper raises on others.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* state, int dtype, int B, int S, int H,
    int P, int G, int N, int Q,
    long long xsb, long long xss, long long xsh,
    long long dtsb, long long dtss,
    long long bsb, long long bss, long long bsg,
    long long csb, long long css, long long csg, void* stream) {
  if (!valid_shape(B, S, H, P, G, N, Q)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    int R, PS;
    const cudaError_t e = mma_grid(B, H, P, G, N, Q, &R, &PS);
    if (e != cudaSuccess) return e;
    MmaParams p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.dt = static_cast<const float*>(dt);
    p.A = static_cast<const float*>(A);
    p.b = static_cast<const __nv_bfloat16*>(Bm);
    p.c = static_cast<const __nv_bfloat16*>(Cm);
    p.y = static_cast<float*>(y); p.state = static_cast<float*>(state);
    p.S = S; p.H = H; p.G = G; p.N = N; p.Q = Q; p.P = P; p.R = R;
    p.xs[0] = xsb; p.xs[1] = xss; p.xs[2] = xsh;
    p.dts[0] = dtsb; p.dts[1] = dtss;
    p.bs[0] = bsb; p.bs[1] = bss; p.bs[2] = bsg;
    p.cs[0] = csb; p.cs[1] = css; p.cs[2] = csg;
    return PS == 16 ? dispatch_mt<16>(p, B, s) : dispatch_mt<8>(p, B, s);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
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
  return dispatch_fp32(P, p, B, s);
}

// The bf16 kernel's grid for these shapes on the current device, as
// ssd_scan_fwd launches it: grid[0] = R heads per block, grid[1] = PS
// columns of P per block.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_grid(int B, int S, int H, int P, int G, int N,
                             int Q, int* grid) {
  if (!valid_shape(B, S, H, P, G, N, Q)) return cudaErrorInvalidValue;
  return mma_grid(B, H, P, G, N, Q, &grid[0], &grid[1]);
}
