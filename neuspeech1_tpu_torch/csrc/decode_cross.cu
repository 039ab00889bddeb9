// Decode cross-attention for Hopper (sm_90a): a few query rows against the
// whole encoder K/V cache, bf16 in, f32 softmax and accumulation, bf16 out.
//
// Replaces neuspeech1_tpu/ops/flash_attention.py::_decode_cross_kernel (the
// Pallas TPU kernel behind flash_decode_cross, [B, H, T, D] cache) and
// ::_decode_cross_btc_kernel (flash_decode_cross_btc, [B, T, H*D] cache). Per
// (batch, head) it computes, for Tq <= 64 query rows,
//   s = q k^T * D^-1/2 (f32), masked at kv_len
//   o = (bf16(exp(s - m)) v) / sum(exp(s - m))
// with the TPU kernel's rounding points: scores stay f32 (no bf16 rounding),
// the unnormalised exp is rounded to the value dtype before the PV product,
// the PV sum is f32 and is divided by the f32 row sum at the end. The cache
// is read through its (b, h, t) strides, so both cache layouts are this code.
//
// What bounds it: the bytes of the cache. At the beam-search step (16
// utterances, H=8, T=1500, D=64) one call reads 49.2 MB of K and V against
// about 2 * 2 * 80 * 8 * 1500 * 64 = 0.25 GFLOP, some 5 FLOP per byte: the
// memory system is the limit by two orders of magnitude.
//
// Design, simple first: the cache rows [0, kv_len) are cut into splits of
// rows_per_split rows, one CTA of four warps per (split, head, batch), so
// that B*H*splits CTAs keep the card's 132 SMs streaming (B*H alone is 64 for
// greedy at B=8). A CTA stages its query rows once, then walks its rows in
// 32-row K/V tiles through shared memory: scores on the CUDA cores (a warp
// per query row, a lane per cache row), an online softmax in f32 per query
// row, and the PV product with a thread per (query row group, head channel)
// holding its sums in registers. Rows at or past kv_len are never read. With
// one split the CTA writes o; with more it writes its f32 partial sums, row
// max and row sum, and a second kernel combines the splits in a fixed order.
// The running max makes the rounding of exp(s - m) to bf16 relative to a
// tile's running max instead of the row's final max (the bound is stated in
// chip_smoke.py). wgmma, TMA and asynchronous copies are later work.
//
// C entry point: nsp_decode_cross_bf16 (below). It returns cudaGetLastError()
// after the launches; 0 means the kernels were queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxQ = 64;    // query rows per call
constexpr int kTile = 32;    // cache rows per shared tile: one per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Strides {
  long long b, t, h;  // in elements; the head dimension is contiguous
};

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Shared memory rows are D/2 + 1 words (an odd count), so the 32 lanes of a
// warp reading the same word of 32 different rows hit 32 different banks.
template <int D>
struct Smem {
  static constexpr int kPitch = D / 2 + 1;
  uint32_t q[kMaxQ * kPitch];
  uint32_t k[kTile * kPitch];
  uint32_t v[kTile * kPitch];
  float p[kMaxQ][kTile + 1];
  float m[kMaxQ], l[kMaxQ], alpha[kMaxQ];
};

// Rows [row0, row0 + n) of one head into shared memory, 16 bytes a load;
// tile rows at or past n become zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;
  constexpr int kPitch = Smem<D>::kPitch;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride +
                                            c * 8);
    }
    uint32_t* row = dst + r * kPitch + c * 4;
    row[0] = val.x;
    row[1] = val.y;
    row[2] = val.z;
    row[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_cross_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int n_heads, int t_q, int kv_len, int rows_per_split,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale) {
  __shared__ __align__(16) Smem<D> sm;
  constexpr int kPitch = Smem<D>::kPitch;
  // PV: thread (group, d) owns head channel d of query rows group,
  // group + kGroups, ...
  constexpr int kGroups = kThreads / D;
  constexpr int kRows = kMaxQ / kGroups;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = threadIdx.x % D;
  const int group = threadIdx.x / D;

  q += batch * qs.b + head * qs.h;
  k += batch * ks.b + head * ks.h;
  v += batch * vs.b + head * vs.h;

  for (int i = threadIdx.x; i < t_q * (D / 2); i += kThreads) {
    const int r = i / (D / 2);
    const int w = i % (D / 2);
    sm.q[r * kPitch + w] =
        *reinterpret_cast<const uint32_t*>(q + r * qs.t + 2 * w);
  }
  for (int i = threadIdx.x; i < t_q; i += kThreads) {
    sm.m[i] = -INFINITY;
    sm.l[i] = 0.f;
  }

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  const int row_begin = split * rows_per_split;
  const int row_end = min(kv_len, row_begin + rows_per_split);
  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    const int n = min(kTile, row_end - t0);  // >= 1 valid row
    load_tile<D>(sm.k, k, ks.t, t0, n);
    load_tile<D>(sm.v, v, vs.t, t0, n);
    __syncthreads();

    // scores: warp w takes query rows w, w + 4, ...; lane j cache row j
    for (int i = warp; i < t_q; i += kWarps) {
      float s = -INFINITY;
      if (lane < n) {
        const uint32_t* qr = sm.q + i * kPitch;
        const uint32_t* kr = sm.k + lane * kPitch;
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < D / 2; ++w) {
          const uint32_t a = qr[w], b = kr[w];
          dot = fmaf(lo_f(a), lo_f(b), dot);
          dot = fmaf(hi_f(a), hi_f(b), dot);
        }
        s = dot * scale;
      }
      const float m_old = sm.m[i];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: lane 0 < n
      const float p = expf(s - m_new);                // masked lanes: 0
      const float sum = warp_sum(p);
      sm.p[i][lane] = bf16_round(p);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        sm.alpha[i] = alpha;
        sm.l[i] = sm.l[i] * alpha + sum;
        sm.m[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + bf16(p) v over the tile's rows
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = group + r * kGroups;
      if (i < t_q) {
        float sum = acc[r] * sm.alpha[i];
        for (int j = 0; j < n; ++j) {
          const uint32_t w = sm.v[j * kPitch + d / 2];
          sum = fmaf(sm.p[i][j], (d & 1) ? hi_f(w) : lo_f(w), sum);
        }
        acc[r] = sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = group + r * kGroups;
    if (i >= t_q) continue;
    if (n_split == 1) {
      o[batch * os.b + i * os.t + head * os.h + d] =
          __float2bfloat16_rn(acc[r] / sm.l[i]);
    } else {
      const long long row =
          ((static_cast<long long>(batch) * n_heads + head) * n_split + split) *
              t_q + i;
      part_o[row * D + d] = acc[r];
      if (d == 0) {
        part_ml[2 * row] = sm.m[i];
        part_ml[2 * row + 1] = sm.l[i];
      }
    }
  }
}

// o = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s over the splits s,
// M = max_s m_s, in the splits' order.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_cross_combine(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ o, int n_heads, int t_q,
                     int n_split, Strides os) {
  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const long long base =
      (static_cast<long long>(batch) * n_heads + head) * n_split;
  for (int e = threadIdx.x; e < t_q * D; e += kThreads) {
    const int i = e / D;
    const int d = e % D;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) {
      mx = fmaxf(mx, part_ml[2 * ((base + s) * t_q + i)]);
    }
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long row = (base + s) * t_q + i;
      const float w = expf(part_ml[2 * row] - mx);
      num = fmaf(w, part_o[row * D + d], num);
      den = fmaf(w, part_ml[2 * row + 1], den);
    }
    o[batch * os.b + i * os.t + head * os.h + d] = __float2bfloat16_rn(num / den);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, void* part_o,
            void* part_ml, int batch, int n_heads, int t_q, int kv_len,
            int n_split, int rows_per_split, Strides qs, Strides ks,
            Strides vs, Strides os, float scale, cudaStream_t stream) {
  const dim3 grid(n_split, n_heads, batch);
  decode_cross_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), n_heads, t_q,
      kv_len, rows_per_split, qs, ks, vs, os, scale);
  if (n_split > 1) {
    decode_cross_combine<D><<<dim3(n_heads, batch), kThreads, 0, stream>>>(
        static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
        static_cast<__nv_bfloat16*>(o), n_heads, t_q, n_split, os);
  }
}

}  // namespace

// q: [B, Tq, H, D]; k, v: rows t of head h of batch b at b*sb + t*st + h*sh
// ([B, H, T, D] or [B, T, H*D]); o: [B, Tq, H, D]; all bf16 with the head
// dimension contiguous and every row 16-byte aligned (q's 4-byte). part_o:
// [B, H, n_split, Tq, D] f32 and part_ml: [B, H, n_split, Tq, 2] f32 scratch,
// read only when n_split > 1. Strides are in elements. The caller checks
// shapes, 1 <= Tq <= 64, 1 <= kv_len <= T and
// n_split = ceil(kv_len / rows_per_split) with rows_per_split > 0.
extern "C" int nsp_decode_cross_bf16(
    const void* q, const void* k, const void* v, void* o, void* part_o,
    void* part_ml, int batch, int n_heads, int t_q, int kv_len, int head_dim,
    int n_split, int rows_per_split, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, float scale, void* stream) {
  if (t_q < 1 || t_q > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh};
  const Strides vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      launch<32>(q, k, v, o, part_o, part_ml, batch, n_heads, t_q, kv_len,
                 n_split, rows_per_split, qs, ks, vs, os, scale, st);
      break;
    case 64:
      launch<64>(q, k, v, o, part_o, part_ml, batch, n_heads, t_q, kv_len,
                 n_split, rows_per_split, qs, ks, vs, os, scale, st);
      break;
    case 128:
      launch<128>(q, k, v, o, part_o, part_ml, batch, n_heads, t_q, kv_len,
                  n_split, rows_per_split, qs, ks, vs, os, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
