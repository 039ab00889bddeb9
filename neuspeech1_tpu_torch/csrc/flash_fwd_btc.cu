// Flash-attention forward for Hopper (sm_90a) on [B, T, H, D] bf16 tensors.
//
// Replaces neuspeech1_tpu/ops/flash_attention.py::_fwd_kernel_btc, the Pallas
// TPU kernel behind flash_attention_bthd (K1), and the same kernel body with
// has_bias=True behind fwd_arrays_btc_bias (K4, ring attention). Per (batch,
// head) it computes
//   o   = softmax(q k^T * D^-1/2 + mask) v
//   lse = logsumexp over the columns of the scaled, masked scores
// with two masks: kv_len (columns >= kv_len) and causal (column > row); or,
// in the HAS_BIAS instantiation, an explicit additive f32 bias row over the
// key axis (0 for a kept column, NEG_INF = -1e30 for a masked one).
// Rounding points follow the TPU kernel: scores and softmax statistics in f32,
// p rounded to bf16 before the PV product, f32 accumulation, o rounded once.
//
// What bounds it: at the encoder's shape (B=8, T=1500, H=8, D=64) one call
// moves about 49 MB (q, k, v, o in bf16) against about 37 GFLOP
// (4*B*H*T*T*D), some 750 FLOP per byte, so the tensor cores are the limit
// once each K/V tile is reused across a whole q tile.
//
// Design, simple first: one CTA of four warps per (64-row q tile, head,
// batch). Each warp owns 16 q rows, keeps them as mma.sync A fragments in
// registers, and walks K/V in 64-row tiles staged in shared memory. Scores
// and the output accumulate through mma.sync.m16n8k16 (bf16 in, f32 out);
// an online softmax keeps each row's max and sum in f32 registers. Columns
// are masked before the row max (the TPU kernel instead relied on padded K
// rows being layer-normed), and K/V rows at or past kv_len are zero-filled in
// shared memory, so padding is never read. Strides are arguments, so a
// [B, T, H*D] projection output is passed as it lies. wgmma, TMA and
// double-buffered loads are later work.
//
// The bias row (HAS_BIAS, K4) is staged per K tile in shared memory beside
// the tile, in raw-score units: b / scale for a kept column, -inf for a bias
// at or below kMaskedBias. It is added to the scores before the row max, so a
// masked column never enters the max, as the kv_len mask above. The TPU
// kernel instead took the max over the raw products of every column and
// added the bias inside the exponent; that is safe only because the masked K
// rows there (padded, layer-normed encoder states) are bounded, and this
// choice needs no such bound. Both give a fully masked row lse = -inf and
// o = 0/0 = NaN, on which the ring's merge gates: here its max stays -inf,
// every p is exp2(-inf) = 0, l = 0. The HAS_BIAS=false instantiation is K1
// unchanged.
//
// C entry points: nsp_flash_fwd_btc_bf16 (K1) and nsp_flash_fwd_btc_bias_bf16
// (K4), below. Each returns cudaGetLastError() after the launch; 0 means the
// kernel was queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // q rows per CTA, 16 per warp
constexpr int kBlockK = 64;  // K/V rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Row padding of the shared tiles, in bf16 elements: with a row pitch of
// D + 8 the fragment reads below touch 32 distinct banks per warp.
constexpr int kPad = 8;
// A bias at or below this masks its column (the bias rows carry -1e30).
constexpr float kMaskedBias = -1e29f;

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

// Two floats rounded to bf16, the lower-indexed element in the low half.
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

// Copies rows [row0, row0 + kBlockK) of one head into shared memory with
// 16-byte loads; rows at or past n_valid become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int n_heads, int t_q, int kv_len, int causal, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale,
                 const float* __restrict__ bias) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][D + kPad];
  // HAS_BIAS: the tile's bias row in raw-score units, -inf where masked
  __shared__ float bias_s[HAS_BIAS ? kBlockK : 1];

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row within the warp's 16 rows
  const int tg = lane & 3;  // fragment column pair

  q += batch * qs.b + head * qs.h;
  k += batch * ks.b + head * ks.h;
  v += batch * vs.b + head * vs.h;
  o += batch * os.b + head * os.h;

  // Each thread holds rows row_lo and row_hi = row_lo + 8 of the warp's tile.
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const bool in_lo = row_lo < t_q;
  const bool in_hi = row_hi < t_q;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = in_lo ? load_u32(q + row_lo * qs.t + c) : 0u;
    qf[kk][1] = in_hi ? load_u32(q + row_hi * qs.t + c) : 0u;
    qf[kk][2] = in_lo ? load_u32(q + row_lo * qs.t + c + 8) : 0u;
    qf[kk][3] = in_hi ? load_u32(q + row_hi * qs.t + c + 8) : 0u;
  }

  const float scale_log2 = scale * 1.4426950408889634f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running raw-score row max
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the row sum
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, t_q) - 1;
    n_tiles = min(n_tiles, last_row / kBlockK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * kBlockK;
    load_tile<D>(k_s, k, ks.t, kv0, kv_len);
    load_tile<D>(v_s, v, vs.t, kv0, kv_len);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < kBlockK; i += kThreads) {
        const float b = kv0 + i < kv_len ? bias[kv0 + i] : 0.f;
        bias_s[i] = b <= kMaskedBias ? -INFINITY : b / scale;
      }
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 columns.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + g][kk * 16 + tg * 2];
        mma_16816(s[nt], qf[kk], load_u32(kr), load_u32(kr + 8));
      }
    }

    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += bias_s[nt * 8 + tg * 2 + (e & 1)];
      }
    }

    if (causal || kv0 + kBlockK > kv_len) {
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= kv_len || (causal && col > row)) s[nt][e] = -INFINITY;
        }
      }
    }

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    // The four threads of a fragment row differ in the low two lane bits.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float new_lo = fmaxf(m_lo, mx_lo);
    const float new_hi = fmaxf(m_hi, mx_hi);
    // A row whose columns are all masked so far keeps m = -inf; shifting by
    // 0 then makes its p exactly 0 instead of NaN.
    const float sh_lo = new_lo == -INFINITY ? 0.f : new_lo * scale_log2;
    const float sh_hi = new_hi == -INFINITY ? 0.f : new_hi * scale_log2;
    const float alpha_lo = exp2f(m_lo * scale_log2 - sh_lo);
    const float alpha_hi = exp2f(m_hi * scale_log2 - sh_hi);
    m_lo = new_lo;
    m_hi = new_hi;

    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] * scale_log2 - sh_lo);
      s[nt][1] = exp2f(s[nt][1] * scale_log2 - sh_lo);
      s[nt][2] = exp2f(s[nt][2] * scale_log2 - sh_hi);
      s[nt][3] = exp2f(s[nt][3] * scale_log2 - sh_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= alpha_lo;
      acc[nd][1] *= alpha_lo;
      acc[nd][2] *= alpha_hi;
      acc[nd][3] *= alpha_hi;
    }

    // acc += bf16(p) v. The accumulator layout of score columns
    // [16kk, 16kk + 16) is the A-fragment layout of k-step kk.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32x2(s[2 * kk][0], s[2 * kk][1]),
          pack_f32x2(s[2 * kk][2], s[2 * kk][3]),
          pack_f32x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int c = nd * 8 + g;
        const uint32_t b0 = pack_bf16x2(v_s[r][c], v_s[r + 1][c]);
        const uint32_t b1 = pack_bf16x2(v_s[r + 8][c], v_s[r + 9][c]);
        mma_16816(acc[nd], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }

#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (in_lo) {
      *reinterpret_cast<uint32_t*>(o + row_lo * os.t + c) =
          pack_f32x2(acc[nd][0] / l_lo, acc[nd][1] / l_lo);
    }
    if (in_hi) {
      *reinterpret_cast<uint32_t*>(o + row_hi * os.t + c) =
          pack_f32x2(acc[nd][2] / l_hi, acc[nd][3] / l_hi);
    }
  }
  if (tg == 0) {
    float* lse_row = lse + (static_cast<long long>(batch) * n_heads + head) * t_q;
    if (in_lo) lse_row[row_lo] = m_lo * scale + logf(l_lo);
    if (in_hi) lse_row[row_hi] = m_hi * scale + logf(l_hi);
  }
}

template <int D, bool HAS_BIAS>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int batch, int n_heads, int t_q, int kv_len, int causal,
            Strides qs, Strides ks, Strides vs, Strides os, float scale,
            const void* bias, cudaStream_t stream) {
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, n_heads, batch);
  flash_fwd_kernel<D, HAS_BIAS><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n_heads, t_q, kv_len, causal, qs, ks, vs, os,
      scale, static_cast<const float*>(bias));
}

template <bool HAS_BIAS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int batch, int n_heads, int t_q, int kv_len, int head_dim,
             int causal, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, const void* bias, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      launch<32, HAS_BIAS>(q, k, v, o, lse, batch, n_heads, t_q, kv_len, causal, qs, ks, vs, os, scale, bias, st);
      break;
    case 64:
      launch<64, HAS_BIAS>(q, k, v, o, lse, batch, n_heads, t_q, kv_len, causal, qs, ks, vs, os, scale, bias, st);
      break;
    case 128:
      launch<128, HAS_BIAS>(q, k, v, o, lse, batch, n_heads, t_q, kv_len, causal, qs, ks, vs, os, scale, bias, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; o: [B, Tq, H, D], all bf16 with the
// head dimension contiguous and every row 16-byte aligned; lse: [B, H, Tq]
// f32, contiguous. Strides are in elements. The caller checks shapes and
// 1 <= kv_len <= Tk.
extern "C" int nsp_flash_fwd_btc_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int n_heads, int t_q, int kv_len, int head_dim, int causal,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh,
    float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh};
  const Strides vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  return dispatch<false>(q, k, v, o, lse, batch, n_heads, t_q, kv_len,
                         head_dim, causal, qs, ks, vs, os, scale, nullptr,
                         static_cast<cudaStream_t>(stream));
}

// K4: as above with every key column kept (kv_len = Tk), no causal mask, and
// bias: [Tk] f32, contiguous, added to the scaled scores of every row. A row
// whose every column carries a bias <= -1e29 gets lse = -inf and o = NaN.
extern "C" int nsp_flash_fwd_btc_bias_bf16(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int batch, int n_heads, int t_q, int t_kv, int head_dim,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_st, long long o_sh,
    float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh};
  const Strides vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  return dispatch<true>(q, k, v, o, lse, batch, n_heads, t_q, t_kv, head_dim,
                        0, qs, ks, vs, os, scale, bias,
                        static_cast<cudaStream_t>(stream));
}
