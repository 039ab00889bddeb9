// Flash-attention backward for Hopper (sm_90a) on [B, T, H, D] bf16 tensors.
//
// Replaces neuspeech1_tpu/ops/flash_attention.py::_bwd_kernel_btc, the Pallas
// TPU kernel behind the custom_vjp of flash_attention_bthd. From q, k, v, the
// forward's o and lse [B, H, Tq] f32, and do, per (batch, head):
//   p     = exp(q k^T * scale - lse)              (masked entries 0)
//   dv    = bf16(p)^T do
//   delta = rowsum(do * o)                         (f32)
//   ds    = bf16(p * (do v^T - delta))
//   dq    = ds bf16(k * scale),   dk = ds^T bf16(q * scale)
// with f32 accumulation, the rounding points of the TPU kernel. Masks are the
// forward's: columns at or past kv_len, and above the diagonal when causal.
// K/V rows at or past kv_len get dk = dv = 0 exactly (the TPU kernel got this
// from padding; here the rows are zero-filled and written as zeros).
//
// What bounds it: at the encoder's shape (B=8, T=1500, H=8, D=64) the
// backward does about 3.5x the forward's 37 GFLOP, some 129 GFLOP: seven
// T x T x D products (s, dv, dp and dk in the dk/dv kernel; s, dp and dq in
// the dq kernel, so the scores and dp are computed twice) against about
// 100 MB of traffic: the tensor cores are the limit.
//
// Design, simple first and deterministic. The TPU grid ran its q blocks in
// order and carried dk/dv across them in VMEM with the whole K/V resident;
// on Hopper blocks run in parallel, so the work is split three ways:
//   1. delta: one warp per q row, rowsum(do * o) in f32 -> [B, H, Tq].
//   2. dk/dv: one CTA of four warps per (64-row K/V tile, head, batch). Each
//      warp keeps its 16 K and V rows as mma.sync A fragments and its dk/dv
//      sums in f32 registers, and walks q in tiles staged in shared memory,
//      recomputing p^T from lse and the scores. No atomics.
//   3. dq: one CTA per (64-row q tile, head, batch), walking K/V tiles like
//      the forward kernel.
// Products are mma.sync.m16n8k16 (bf16 in, f32 out); an accumulator tile is
// reused as the A fragment of the next product, as in the forward kernel.
// Under causal masking both loops skip fully masked tiles. wgmma, TMA and
// pipelining are later work.
//
// C entry point: nsp_flash_bwd_btc_bf16 (below). It returns
// cudaGetLastError() after the launches; 0 means the kernels were queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 64;   // K/V rows per tile
constexpr int kBlockQdq = 64; // q rows per CTA of the dq kernel
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // shared row padding (bf16): conflict-free reads
constexpr float kLog2e = 1.4426950408889634f;

// q rows per shared tile of the dk/dv kernel: 64, or 32 at D=128 to bound
// the registers of the score tiles.
template <int D>
struct DkdvTile {
  static constexpr int kBlockQ = D == 128 ? 32 : 64;
};

struct Strides {
  long long b, t, h;  // in elements; the head dimension is contiguous
};

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

// bf16(x * scale) of two elements, packed: the scaled k / q operands.
__device__ __forceinline__ uint32_t pack_scaled(__nv_bfloat16 lo, __nv_bfloat16 hi,
                                                float scale) {
  return pack_f32x2(__bfloat162float(lo) * scale, __bfloat162float(hi) * scale);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [row0, row0 + ROWS) of one head into shared memory with 16-byte
// loads; rows at or past n_valid become zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// A fragments (16 rows x D) of rows row_lo and row_lo + 8 from global memory;
// rows at or past n_valid are zeros.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4],
                                             const __nv_bfloat16* src,
                                             long long row_stride, int row_lo,
                                             int n_valid, int tg) {
  const bool in_lo = row_lo < n_valid;
  const bool in_hi = row_lo + 8 < n_valid;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    f[kk][0] = in_lo ? load_u32(src + row_lo * row_stride + c) : 0u;
    f[kk][1] = in_hi ? load_u32(src + (row_lo + 8) * row_stride + c) : 0u;
    f[kk][2] = in_lo ? load_u32(src + row_lo * row_stride + c + 8) : 0u;
    f[kk][3] = in_hi ? load_u32(src + (row_lo + 8) * row_stride + c + 8) : 0u;
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(do * o) in f32, one warp per row.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int n_heads, int t_q,
                       Strides os, Strides dos) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  if (row >= t_q) return;
  const __nv_bfloat16* op = o + batch * os.b + head * os.h + row * os.t;
  const __nv_bfloat16* dp = dout + batch * dos.b + head * dos.h + row * dos.t;
  float acc = 0.f;
  for (int c = lane * 2; c < D; c += 64) {
    acc += __bfloat162float(op[c]) * __bfloat162float(dp[c]) +
           __bfloat162float(op[c + 1]) * __bfloat162float(dp[c + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    delta[(static_cast<long long>(batch) * n_heads + head) * t_q + row] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one CTA per 64-row K/V tile, looping over q tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int n_heads, int t_q,
                      int t_kv, int kv_len, int causal, Strides qs, Strides ks,
                      Strides vs, Strides dos, Strides dks, Strides dvs,
                      float scale) {
  constexpr int BQ = DkdvTile<D>::kBlockQ;
  __shared__ __align__(16) __nv_bfloat16 q_s[BQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 do_s[BQ][D + kPad];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int kv0 = blockIdx.x * kBlockK;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;

  q += batch * qs.b + head * qs.h;
  k += batch * ks.b + head * ks.h;
  v += batch * vs.b + head * vs.h;
  dout += batch * dos.b + head * dos.h;
  dk += batch * dks.b + head * dks.h;
  dv += batch * dvs.b + head * dvs.h;
  const long long stat0 = (static_cast<long long>(batch) * n_heads + head) * t_q;
  lse += stat0;
  delta += stat0;

  const int row_lo = kv0 + warp * 16 + g;  // K/V rows of this thread
  const int row_hi = row_lo + 8;

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;
  }

  if (kv0 < kv_len) {
    uint32_t kf[D / 16][4];
    uint32_t vf[D / 16][4];
    load_a_frags<D>(kf, k, ks.t, row_lo, kv_len, tg);
    load_a_frags<D>(vf, v, vs.t, row_lo, kv_len, tg);

    const float scale_log2 = scale * kLog2e;
    const int n_q_tiles = (t_q + BQ - 1) / BQ;
    // causal: q rows before kv0 see none of this tile's columns
    const int j0 = causal ? kv0 / BQ : 0;
    for (int j = j0; j < n_q_tiles; ++j) {
      const int q0 = j * BQ;
      load_tile<BQ, D>(q_s, q, qs.t, q0, t_q);
      load_tile<BQ, D>(do_s, dout, dos.t, q0, t_q);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < t_q;
        lse_s[i] = in ? lse[q0 + i] * kLog2e : INFINITY;  // p = 0 past t_q
        delta_s[i] = in ? delta[q0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T: this warp's 16 K rows against the tile's BQ q rows.
      float st[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* qr = &q_s[nt * 8 + g][kk * 16 + tg * 2];
          mma_16816(st[nt], kf[kk], load_u32(qr), load_u32(qr + 8));
        }
      }
      // p^T = exp(s * scale - lse[col]), masked entries 0.
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + tg * 2 + (e & 1);  // q column in the tile
          const int row = e < 2 ? row_lo : row_hi;
          const bool valid = row < kv_len && (!causal || row <= q0 + cl);
          st[nt][e] = valid ? exp2f(st[nt][e] * scale_log2 - lse_s[cl]) : 0.f;
        }
      }
      // dv += bf16(p^T) do
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {
            pack_f32x2(st[2 * kk][0], st[2 * kk][1]),
            pack_f32x2(st[2 * kk][2], st[2 * kk][3]),
            pack_f32x2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
            pack_f32x2(st[2 * kk + 1][2], st[2 * kk + 1][3]),
        };
        const int r = kk * 16 + tg * 2;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const int c = nd * 8 + g;
          const uint32_t b0 = pack_bf16x2(do_s[r][c], do_s[r + 1][c]);
          const uint32_t b1 = pack_bf16x2(do_s[r + 8][c], do_s[r + 9][c]);
          mma_16816(dv_acc[nd], a, b0, b1);
        }
      }
      // dp^T = V do^T, then ds^T = p^T (dp^T - delta[col]) in place.
      float dpt[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* dr = &do_s[nt * 8 + g][kk * 16 + tg * 2];
          mma_16816(dpt[nt], vf[kk], load_u32(dr), load_u32(dr + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + tg * 2 + (e & 1);
          dpt[nt][e] = st[nt][e] * (dpt[nt][e] - delta_s[cl]);
        }
      }
      // dk += bf16(ds^T) bf16(q * scale)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t a[4] = {
            pack_f32x2(dpt[2 * kk][0], dpt[2 * kk][1]),
            pack_f32x2(dpt[2 * kk][2], dpt[2 * kk][3]),
            pack_f32x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
            pack_f32x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
        };
        const int r = kk * 16 + tg * 2;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const int c = nd * 8 + g;
          const uint32_t b0 = pack_scaled(q_s[r][c], q_s[r + 1][c], scale);
          const uint32_t b1 = pack_scaled(q_s[r + 8][c], q_s[r + 9][c], scale);
          mma_16816(dk_acc[nd], a, b0, b1);
        }
      }
      __syncthreads();
    }
  }

  // Rows at or past kv_len are written as exact zeros.
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (row_lo < t_kv) {
      const bool z = row_lo >= kv_len;
      *reinterpret_cast<uint32_t*>(dk + row_lo * dks.t + c) =
          z ? 0u : pack_f32x2(dk_acc[nd][0], dk_acc[nd][1]);
      *reinterpret_cast<uint32_t*>(dv + row_lo * dvs.t + c) =
          z ? 0u : pack_f32x2(dv_acc[nd][0], dv_acc[nd][1]);
    }
    if (row_hi < t_kv) {
      const bool z = row_hi >= kv_len;
      *reinterpret_cast<uint32_t*>(dk + row_hi * dks.t + c) =
          z ? 0u : pack_f32x2(dk_acc[nd][2], dk_acc[nd][3]);
      *reinterpret_cast<uint32_t*>(dv + row_hi * dvs.t + c) =
          z ? 0u : pack_f32x2(dv_acc[nd][2], dv_acc[nd][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per 64-row q tile, looping over K/V tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int n_heads, int t_q,
                    int kv_len, int causal, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][D + kPad];

  const int q0 = blockIdx.x * kBlockQdq;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;

  q += batch * qs.b + head * qs.h;
  k += batch * ks.b + head * ks.h;
  v += batch * vs.b + head * vs.h;
  dout += batch * dos.b + head * dos.h;
  dq += batch * dqs.b + head * dqs.h;
  const long long stat0 = (static_cast<long long>(batch) * n_heads + head) * t_q;

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const bool in_lo = row_lo < t_q;
  const bool in_hi = row_hi < t_q;

  uint32_t qf[D / 16][4];
  uint32_t dof[D / 16][4];
  load_a_frags<D>(qf, q, qs.t, row_lo, t_q, tg);
  load_a_frags<D>(dof, dout, dos.t, row_lo, t_q, tg);
  // rows past t_q: lse = +inf makes their p exactly 0
  const float lse_lo = in_lo ? lse[stat0 + row_lo] * kLog2e : INFINITY;
  const float lse_hi = in_hi ? lse[stat0 + row_hi] * kLog2e : INFINITY;
  const float dl_lo = in_lo ? delta[stat0 + row_lo] : 0.f;
  const float dl_hi = in_hi ? delta[stat0 + row_hi] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  const float scale_log2 = scale * kLog2e;
  int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQdq, t_q) - 1;
    n_tiles = min(n_tiles, last_row / kBlockK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockK;
    load_tile<kBlockK, D>(k_s, k, ks.t, kv0, kv_len);
    load_tile<kBlockK, D>(v_s, v, vs.t, kv0, kv_len);
    __syncthreads();

    // s = Q K^T and dp = dO V^T for this warp's 16 rows, 64 columns.
    float s[kBlockK / 8][4];
    float dp[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(s[nt], qf[kk], load_u32(kr), load_u32(kr + 8));
        const __nv_bfloat16* vr = &v_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(dp[nt], dof[kk], load_u32(vr), load_u32(vr + 8));
      }
    }
    // ds = p (dp - delta), p = exp(s * scale - lse), masked entries 0.
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        const bool valid = col < kv_len && (!causal || col <= row);
        const float p = valid
            ? exp2f(s[nt][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_lo : dl_hi));
      }
    }
    // dq += bf16(ds) bf16(k * scale)
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32x2(dp[2 * kk][0], dp[2 * kk][1]),
          pack_f32x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_f32x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_f32x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
      };
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int c = nd * 8 + g;
        const uint32_t b0 = pack_scaled(k_s[r][c], k_s[r + 1][c], scale);
        const uint32_t b1 = pack_scaled(k_s[r + 8][c], k_s[r + 9][c], scale);
        mma_16816(acc[nd], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (in_lo) {
      *reinterpret_cast<uint32_t*>(dq + row_lo * dqs.t + c) =
          pack_f32x2(acc[nd][0], acc[nd][1]);
    }
    if (in_hi) {
      *reinterpret_cast<uint32_t*>(dq + row_hi * dqs.t + c) =
          pack_f32x2(acc[nd][2], acc[nd][3]);
    }
  }
}

template <int D>
void launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, const __nv_bfloat16* o,
            const __nv_bfloat16* dout, const float* lse, float* delta,
            __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int batch,
            int n_heads, int t_q, int t_kv, int kv_len, int causal,
            const Strides (&st)[8], float scale, cudaStream_t stream) {
  const Strides &qs = st[0], &ks = st[1], &vs = st[2], &os = st[3],
                &dos = st[4], &dqs = st[5], &dks = st[6], &dvs = st[7];
  flash_bwd_delta_kernel<D>
      <<<dim3((t_q + kWarps - 1) / kWarps, n_heads, batch), kThreads, 0, stream>>>(
          o, dout, delta, n_heads, t_q, os, dos);
  flash_bwd_dkdv_kernel<D>
      <<<dim3((t_kv + kBlockK - 1) / kBlockK, n_heads, batch), kThreads, 0, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, n_heads, t_q, t_kv, kv_len, causal,
          qs, ks, vs, dos, dks, dvs, scale);
  flash_bwd_dq_kernel<D>
      <<<dim3((t_q + kBlockQdq - 1) / kBlockQdq, n_heads, batch), kThreads, 0, stream>>>(
          q, k, v, dout, lse, delta, dq, n_heads, t_q, kv_len, causal, qs, ks,
          vs, dos, dqs, scale);
}

}  // namespace

// q, o, do, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D], all bf16 with the
// head dimension contiguous and every row 16-byte aligned. lse: [B, H, Tq]
// f32 from the forward kernel; delta: [B, H, Tq] f32 scratch. strides: 24
// element strides, (batch, time, head) of q, k, v, o, do, dq, dk, dv in that
// order. The caller checks shapes and 1 <= kv_len <= Tk.
extern "C" int nsp_flash_bwd_btc_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int n_heads, int t_q, int t_kv, int kv_len,
    int head_dim, int causal, const long long* strides, float scale,
    void* stream) {
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  using bf = __nv_bfloat16;
  const bf* q_ = static_cast<const bf*>(q);
  const bf* k_ = static_cast<const bf*>(k);
  const bf* v_ = static_cast<const bf*>(v);
  const bf* o_ = static_cast<const bf*>(o);
  const bf* do_ = static_cast<const bf*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  bf* dq_ = static_cast<bf*>(dq);
  bf* dk_ = static_cast<bf*>(dk);
  bf* dv_ = static_cast<bf*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32>(q_, k_, v_, o_, do_, lse_, delta_, dq_, dk_, dv_, batch, n_heads,
                 t_q, t_kv, kv_len, causal, st, scale, s);
      break;
    case 64:
      launch<64>(q_, k_, v_, o_, do_, lse_, delta_, dq_, dk_, dv_, batch, n_heads,
                 t_q, t_kv, kv_len, causal, st, scale, s);
      break;
    case 128:
      launch<128>(q_, k_, v_, o_, do_, lse_, delta_, dq_, dk_, dv_, batch, n_heads,
                  t_q, t_kv, kv_len, causal, st, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
