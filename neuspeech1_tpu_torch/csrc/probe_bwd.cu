// Attention backward probe from a given lse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU tuning probes of the flash backward (P-bwd):
//   perf/bwd_probe.py::make_bwd (bf16 or f32 dot operands) and
//   perf/btc_probe.py::make_bwd_btc ([B, T, H*D] layout, f32 operands).
// Per (batch*head), from bf16 q, k, v, o, do [TK, 64] and a GIVEN f32 lse
// [TK] (the probes feed lse ~ N(8, 0.1^2), so p is not normalised):
//   s     = q k^T * D^-1/2, columns >= t_valid set to -1e30
//   p     = exp(s - lse)                       (f32; masked columns 0)
//   dv    = p^T do,  dp = do v^T,  delta = rowsum(do * o)
//   ds    = p (dp - delta) * D^-1/2
//   dq    = ds k,    dk = ds^T q               (all rows of q contribute)
// OPS = bf16: p and ds rounded to bf16 before their products, every product
// on bf16 operands with f32 accumulation (mma.sync.m16n8k16). OPS = f32:
// every product on f32 operands in f32 on the CUDA cores (FFMA), the
// precision of the TPU's multi-pass f32 dot; no TF32. dq, dk, dv are
// rounded to bf16 once.
//
// What bounds it: at B*H = 512, TK = 1536 (1500 kept), D = 64 the five
// products are 755 GFLOP: 0.763 ms at the bf16 tensor-core rate (989
// TFLOP/s); the f32 variant bounds against the f32 CUDA-core rate (67
// TFLOP/s), 11.3 ms. Bytes (six [TK, 64] bf16 arrays and lse) are ~0.1 ms.
//
// Design, deterministic: the TPU grid walked q blocks in order and carried
// dk/dv in VMEM; Hopper blocks run in parallel, so, as the flash backward
// kernel (flash_bwd_btc.cu), three kernels without atomics:
//   1. delta = rowsum(do * o) in f32, one warp per row;
//   2. dk/dv: one CTA per 64 K/V rows, walking q in tiles of R rows and
//      recomputing s^T, p^T, dp^T and ds^T;
//   3. dq: one CTA per R q rows, walking K/V in 64-row tiles.
// The seven products (s and dp in both 2 and 3) are two more than the five
// the bound counts. R (16-row multiples, 32 or 64) is what the TPU block_q
// maps to. The f32 kernels keep their operands in shared memory as f32 in
// the orientation each product reads (both orientations where two products
// read one array) and give each of 256 threads a TM x TN tile of outputs.
//
// C entry point: nsp_probe_bwd, below. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an instance that is not built).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBlockK = 64;   // K/V rows per dk/dv CTA and per dq tile
constexpr int kPad = 8;       // bf16 row padding of shared tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, t;  // in elements; the head dim is contiguous
};

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int n_heads, tk, t_valid;
  Strides st;
  float scale;
};

__device__ __forceinline__ long long head_base(const Args& a, int bh) {
  return (bh / a.n_heads) * a.st.b + (bh % a.n_heads) * a.st.h;
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kD + kPad],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
  }
}

__device__ __forceinline__ void load_a_frags(uint32_t (&f)[kD / 16][4],
                                             const __nv_bfloat16* src,
                                             long long row_stride, int row_lo,
                                             int tg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    f[kk][0] = load_u32(src + row_lo * row_stride + c);
    f[kk][1] = load_u32(src + (row_lo + 8) * row_stride + c);
    f[kk][2] = load_u32(src + row_lo * row_stride + c + 8);
    f[kk][3] = load_u32(src + (row_lo + 8) * row_stride + c + 8);
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(do * o) in f32, one warp per row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128) delta_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 4 + warp;
  const int bh = blockIdx.y;
  if (row >= a.tk) return;
  const long long off = head_base(a, bh) + row * a.st.t;
  float acc = __bfloat162float(a.o[off + 2 * lane]) *
                  __bfloat162float(a.dout[off + 2 * lane]) +
              __bfloat162float(a.o[off + 2 * lane + 1]) *
                  __bfloat162float(a.dout[off + 2 * lane + 1]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) a.delta[static_cast<long long>(bh) * a.tk + row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 operands: 2. dk/dv, one CTA of four warps per 64 K/V rows.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(128) dkdv_bf16_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 q_s[R][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 do_s[R][kD + kPad];
  __shared__ float lse_s[R], delta_s[R];

  const int kv0 = blockIdx.x * kBlockK;
  const int bh = blockIdx.y;
  const long long base = head_base(a, bh);
  const __nv_bfloat16* q = a.q + base;
  const __nv_bfloat16* dout = a.dout + base;
  const float* lse = a.lse + static_cast<long long>(bh) * a.tk;
  const float* delta = a.delta + static_cast<long long>(bh) * a.tk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_lo = kv0 + warp * 16 + g, row_hi = row_lo + 8;
  const bool keep_lo = row_lo < a.t_valid, keep_hi = row_hi < a.t_valid;

  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  load_a_frags(kf, a.k + base, a.st.t, row_lo, tg);
  load_a_frags(vf, a.v + base, a.st.t, row_lo, tg);
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;
  }
  const float scale_log2 = a.scale * kLog2e;

  for (int q0 = 0; q0 < a.tk; q0 += R) {
    load_tile<R, 128>(q_s, q, a.st.t, q0);
    load_tile<R, 128>(do_s, dout, a.st.t, q0);
    for (int i = threadIdx.x; i < R; i += 128) {
      lse_s[i] = lse[q0 + i] * kLog2e;
      delta_s[i] = delta[q0 + i];
    }
    __syncthreads();

    // p^T = exp(K Q^T * scale - lse[col]); masked K rows give 0
    float st[R / 8][4];
#pragma unroll
    for (int nt = 0; nt < R / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* qr = &q_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(st[nt], kf[kk], load_u32(qr), load_u32(qr + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + tg * 2 + (e & 1);
        st[nt][e] = (e < 2 ? keep_lo : keep_hi)
                        ? exp2f(st[nt][e] * scale_log2 - lse_s[cl]) : 0.f;
      }
    }
    // dv += bf16(p^T) do
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint32_t af[4] = {
          pack_f32x2(st[2 * kk][0], st[2 * kk][1]),
          pack_f32x2(st[2 * kk][2], st[2 * kk][3]),
          pack_f32x2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_f32x2(st[2 * kk + 1][2], st[2 * kk + 1][3]),
      };
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        const int c = nd * 8 + g;
        mma_16816(dv_acc[nd], af, pack_bf16x2(do_s[r][c], do_s[r + 1][c]),
                  pack_bf16x2(do_s[r + 8][c], do_s[r + 9][c]));
      }
    }
    // dp^T = V do^T, ds^T = p^T (dp^T - delta[col]) * scale
    float dst[R / 8][4];
#pragma unroll
    for (int nt = 0; nt < R / 8; ++nt) {
      dst[nt][0] = dst[nt][1] = dst[nt][2] = dst[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* dr = &do_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(dst[nt], vf[kk], load_u32(dr), load_u32(dr + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + tg * 2 + (e & 1);
        dst[nt][e] = st[nt][e] * (dst[nt][e] - delta_s[cl]) * a.scale;
      }
    }
    // dk += bf16(ds^T) q
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      const uint32_t af[4] = {
          pack_f32x2(dst[2 * kk][0], dst[2 * kk][1]),
          pack_f32x2(dst[2 * kk][2], dst[2 * kk][3]),
          pack_f32x2(dst[2 * kk + 1][0], dst[2 * kk + 1][1]),
          pack_f32x2(dst[2 * kk + 1][2], dst[2 * kk + 1][3]),
      };
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        const int c = nd * 8 + g;
        mma_16816(dk_acc[nd], af, pack_bf16x2(q_s[r][c], q_s[r + 1][c]),
                  pack_bf16x2(q_s[r + 8][c], q_s[r + 9][c]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dk = a.dk + base;
  __nv_bfloat16* dv = a.dv + base;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(dk + row_lo * a.st.t + c) =
        pack_f32x2(dk_acc[nd][0], dk_acc[nd][1]);
    *reinterpret_cast<uint32_t*>(dv + row_lo * a.st.t + c) =
        pack_f32x2(dv_acc[nd][0], dv_acc[nd][1]);
    *reinterpret_cast<uint32_t*>(dk + row_hi * a.st.t + c) =
        pack_f32x2(dk_acc[nd][2], dk_acc[nd][3]);
    *reinterpret_cast<uint32_t*>(dv + row_hi * a.st.t + c) =
        pack_f32x2(dv_acc[nd][2], dv_acc[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: 3. dq, one CTA of R / 16 warps per R q rows.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(R * 2) dq_bf16_kernel(Args a) {
  constexpr int kThreads = R * 2;
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][kD + kPad];

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const long long base = head_base(a, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const long long stat = static_cast<long long>(bh) * a.tk;

  uint32_t qf[kD / 16][4], dof[kD / 16][4];
  load_a_frags(qf, a.q + base, a.st.t, row_lo, tg);
  load_a_frags(dof, a.dout + base, a.st.t, row_lo, tg);
  const float lse_lo = a.lse[stat + row_lo] * kLog2e;
  const float lse_hi = a.lse[stat + row_hi] * kLog2e;
  const float dl_lo = a.delta[stat + row_lo], dl_hi = a.delta[stat + row_hi];
  float acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const float scale_log2 = a.scale * kLog2e;

  for (int kv0 = 0; kv0 < a.tk; kv0 += kBlockK) {
    load_tile<kBlockK, kThreads>(k_s, a.k + base, a.st.t, kv0);
    load_tile<kBlockK, kThreads>(v_s, a.v + base, a.st.t, kv0);
    __syncthreads();
    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(s[nt], qf[kk], load_u32(kr), load_u32(kr + 8));
        const __nv_bfloat16* vr = &v_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(dp[nt], dof[kk], load_u32(vr), load_u32(vr + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
        const float p = col < a.t_valid
            ? exp2f(s[nt][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi)) * a.scale;
      }
    }
    // dq += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t af[4] = {
          pack_f32x2(dp[2 * kk][0], dp[2 * kk][1]),
          pack_f32x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_f32x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_f32x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
      };
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        const int c = nd * 8 + g;
        mma_16816(acc[nd], af, pack_bf16x2(k_s[r][c], k_s[r + 1][c]),
                  pack_bf16x2(k_s[r + 8][c], k_s[r + 9][c]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dq = a.dq + base;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(dq + row_lo * a.st.t + c) =
        pack_f32x2(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<uint32_t*>(dq + row_hi * a.st.t + c) =
        pack_f32x2(acc[nd][2], acc[nd][3]);
  }
}

// ---------------------------------------------------------------------------
// f32 operands on the CUDA cores. 256 threads as a 16 x 16 grid; for an
// M x N output each thread owns rows ty * TM .. and columns tx * TN ...
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;
constexpr int kFP = 4;  // f32 row padding

// c[i][j] += sum_k At[k][i0 + i] * B[k][j0 + j] over k < 64 (shared, f32)
template <int TM, int TN>
__device__ __forceinline__ void gemm_f32(float (&c)[TM][TN], const float* at,
                                         int lda, const float* b, int ldb,
                                         int i0, int j0) {
#pragma unroll 8
  for (int kk = 0; kk < kD; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = at[kk * lda + i0 + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[kk * ldb + j0 + j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }
}

// ROWS x 64 bf16 rows of one head into shared f32, natural ([r][d], pitch
// 64 + kFP) and/or transposed ([d][r], pitch ROWS + kFP)
template <int ROWS>
__device__ __forceinline__ void load_f32(float* nat, float* tr,
                                         const __nv_bfloat16* src,
                                         long long row_stride, int row0) {
  for (int i = threadIdx.x; i < ROWS * kD / 2; i += kF32Threads) {
    const int r = i / (kD / 2), c = (i % (kD / 2)) * 2;
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
        src + (row0 + r) * row_stride + c);
    const float x0 = __low2float(x), x1 = __high2float(x);
    if (nat != nullptr) {
      nat[r * (kD + kFP) + c] = x0;
      nat[r * (kD + kFP) + c + 1] = x1;
    }
    if (tr != nullptr) {
      tr[c * (ROWS + kFP) + r] = x0;
      tr[(c + 1) * (ROWS + kFP) + r] = x1;
    }
  }
}

template <int R>
struct F32Dkdv {
  // shared f32 arrays: Kt, Vt [64][64]; Qt, dOt [64][R]; Q, dO [R][64];
  // P, DS [R][64] (q-major, so that they are the A operands of dv and dk)
  static constexpr int kKV = kD * (kBlockK + kFP);
  static constexpr int kQT = kD * (R + kFP);
  static constexpr int kQN = R * (kD + kFP);
  static constexpr int kFloats = 2 * kKV + 2 * kQT + 4 * kQN + 2 * R;
  static constexpr size_t kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "above a block's shared memory");
};

template <int R>
__global__ void __launch_bounds__(kF32Threads) dkdv_f32_kernel(Args a) {
  using L = F32Dkdv<R>;
  extern __shared__ __align__(16) float fsm[];
  float* kt = fsm;
  float* vt = kt + L::kKV;
  float* qt = vt + L::kKV;
  float* dot = qt + L::kQT;
  float* qn = dot + L::kQT;
  float* don = qn + L::kQN;
  float* pm = don + L::kQN;
  float* dsm = pm + L::kQN;
  float* lse_s = dsm + L::kQN;
  float* delta_s = lse_s + R;

  const int kv0 = blockIdx.x * kBlockK;
  const int bh = blockIdx.y;
  const long long base = head_base(a, bh);
  const long long stat = static_cast<long long>(bh) * a.tk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int kTN = R / 16;  // 64 x R products: 4 x (R/16) per thread

  load_f32<kBlockK>(nullptr, kt, a.k + base, a.st.t, kv0);
  load_f32<kBlockK>(nullptr, vt, a.v + base, a.st.t, kv0);
  float dk[4][4] = {}, dv[4][4] = {};

  for (int q0 = 0; q0 < a.tk; q0 += R) {
    load_f32<R>(qn, qt, a.q + base, a.st.t, q0);
    load_f32<R>(don, dot, a.dout + base, a.st.t, q0);
    for (int i = threadIdx.x; i < R; i += kF32Threads) {
      lse_s[i] = a.lse[stat + q0 + i];
      delta_s[i] = a.delta[stat + q0 + i];
    }
    __syncthreads();
    // s^T = K Q^T, p^T = exp(s^T * scale - lse); dp^T = V dO^T
    float st[4][kTN] = {}, dpt[4][kTN] = {};
    gemm_f32<4, kTN>(st, kt, kBlockK + kFP, qt, R + kFP, ty * 4, tx * kTN);
    gemm_f32<4, kTN>(dpt, vt, kBlockK + kFP, dot, R + kFP, ty * 4, tx * kTN);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool keep = kv0 + ty * 4 + i < a.t_valid;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int qc = tx * kTN + j;
        const float p = keep ? expf(st[i][j] * a.scale - lse_s[qc]) : 0.f;
        pm[qc * (kD + kFP) + ty * 4 + i] = p;
        dsm[qc * (kD + kFP) + ty * 4 + i] =
            p * (dpt[i][j] - delta_s[qc]) * a.scale;
      }
    }
    __syncthreads();
    // dv += p^T dO, dk += ds^T Q (k runs over this tile's R q rows)
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float pv[4], dsv[4], dov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pm[kk * (kD + kFP) + ty * 4 + i];
        dsv[i] = dsm[kk * (kD + kFP) + ty * 4 + i];
        dov[i] = don[kk * (kD + kFP) + tx * 4 + i];
        qv[i] = qn[kk * (kD + kFP) + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (kv0 + ty * 4 + i) * a.st.t + base;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int c = tx * 4 + j;
      *reinterpret_cast<uint32_t*>(a.dk + row + c) = pack_f32x2(dk[i][j], dk[i][j + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + row + c) = pack_f32x2(dv[i][j], dv[i][j + 1]);
    }
  }
}

template <int R>
struct F32Dq {
  // Qt, dOt [64][R] (resident); Kt, Vt [64][64], K [64][64], DSt [64][R]
  static constexpr int kQT = kD * (R + kFP);
  static constexpr int kKV = kD * (kBlockK + kFP);
  static constexpr int kFloats = 3 * kQT + 3 * kKV;
  static constexpr size_t kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "above a block's shared memory");
};

template <int R>
__global__ void __launch_bounds__(kF32Threads) dq_f32_kernel(Args a) {
  using L = F32Dq<R>;
  extern __shared__ __align__(16) float fsm[];
  float* qt = fsm;
  float* dot = qt + L::kQT;
  float* dst = dot + L::kQT;  // [kv][q]
  float* kt = dst + L::kQT;
  float* vt = kt + L::kKV;
  float* kn = vt + L::kKV;

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const long long base = head_base(a, bh);
  const long long stat = static_cast<long long>(bh) * a.tk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int kTM = R / 16;  // R x 64 products: (R/16) x 4 per thread

  load_f32<R>(nullptr, qt, a.q + base, a.st.t, q0);
  load_f32<R>(nullptr, dot, a.dout + base, a.st.t, q0);
  float lse_r[kTM], dl_r[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    lse_r[i] = a.lse[stat + q0 + ty * kTM + i];
    dl_r[i] = a.delta[stat + q0 + ty * kTM + i];
  }
  float dq[kTM][4] = {};

  for (int kv0 = 0; kv0 < a.tk; kv0 += kBlockK) {
    load_f32<kBlockK>(kn, kt, a.k + base, a.st.t, kv0);
    load_f32<kBlockK>(nullptr, vt, a.v + base, a.st.t, kv0);
    __syncthreads();
    float s[kTM][4] = {}, dp[kTM][4] = {};
    gemm_f32<kTM, 4>(s, qt, R + kFP, kt, kBlockK + kFP, ty * kTM, tx * 4);
    gemm_f32<kTM, 4>(dp, dot, R + kFP, vt, kBlockK + kFP, ty * kTM, tx * 4);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx * 4 + j;
        const float p = kv0 + kc < a.t_valid
            ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dst[kc * (R + kFP) + ty * kTM + i] = p * (dp[i][j] - dl_r[i]) * a.scale;
      }
    }
    __syncthreads();
    // dq += ds K: At = DSt [kv][q], B = K [kv][d]
    gemm_f32<kTM, 4>(dq, dst, R + kFP, kn, kD + kFP, ty * kTM, tx * 4);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = (q0 + ty * kTM + i) * a.st.t + base;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      *reinterpret_cast<uint32_t*>(a.dq + row + tx * 4 + j) =
          pack_f32x2(dq[i][j], dq[i][j + 1]);
    }
  }
}

template <int R>
int launch(const Args& a, int n_bh, int f32_ops, cudaStream_t s) {
  delta_kernel<<<dim3((a.tk + 3) / 4, n_bh), 128, 0, s>>>(a);
  if (f32_ops) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_f32_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(F32Dkdv<R>::kBytes));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dq_f32_kernel<R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(F32Dq<R>::kBytes));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_f32_kernel<R><<<dim3(a.tk / kBlockK, n_bh), kF32Threads,
                         F32Dkdv<R>::kBytes, s>>>(a);
    dq_f32_kernel<R><<<dim3(a.tk / R, n_bh), kF32Threads, F32Dq<R>::kBytes, s>>>(a);
  } else {
    dkdv_bf16_kernel<R><<<dim3(a.tk / kBlockK, n_bh), 128, 0, s>>>(a);
    dq_bf16_kernel<R><<<dim3(a.tk / R, n_bh), R * 2, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, do, dq, dk, dv: (batch * heads) x tk rows of 64 bf16, row r of
// head (b, h) at b * s_b + h * s_h + r * s_t (elements; rows 16-byte
// aligned); lse: [batch * heads, tk] f32; delta: the same shape, f32
// scratch. rows: 32 or 64 (tk a multiple of 64 and of rows, checked by the
// caller); f32_ops: 0 for bf16 operands, 1 for f32.
extern "C" int nsp_probe_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             int n_bh, int n_heads, int tk, int t_valid,
                             int rows, int f32_ops, long long s_b,
                             long long s_h, long long s_t, float scale,
                             void* stream) {
  using bf = __nv_bfloat16;
  const Args a{static_cast<const bf*>(q), static_cast<const bf*>(k),
               static_cast<const bf*>(v), static_cast<const bf*>(o),
               static_cast<const bf*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<bf*>(dq),
               static_cast<bf*>(dk), static_cast<bf*>(dv), n_heads, tk,
               t_valid, Strides{s_b, s_h, s_t}, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 32) return launch<32>(a, n_bh, f32_ops, s);
  if (rows == 64) return launch<64>(a, n_bh, f32_ops, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
