// The multi-query cached self-attention decode step for Hopper (sm_90a): the
// speculative decoder's draft-verify step (and its prompt's prefill). Write
// this step's G new K/V columns into the cache in place, then attend each of
// the G queries over the columns its mask allows, bf16 in and out.
//
// Replaces neuspeech1_tpu/ops/decode_step.py::_kernel_multi, the Pallas TPU
// kernel behind fused_self_decode_multi. Per (row, head), with the cache
// k_t, v_t laid out [B, H, Dh, Tmax] (time last, as the decode loop keeps
// it) and query i's mask row m_i [Tmax]:
//   k_t[..., idx + i] = k_new_i; v_t[..., idx + i] = v_new_i     (i < G)
//   s_it = m_it ? f32(bf16(sum_d q_id k_t[d, t])) * Dh^-1/2 : -1e30
//   p_i  = bf16(exp(s_i - max s_i) / sum exp(s_i - max s_i))
//   ctx_i = bf16(sum_t p_it v_t[:, t])                            (f32 sum)
// with the TPU kernel's rounding points: the score is accumulated in f32 and
// rounded once to the cache dtype, then scaled in f32; the probabilities are
// normalised in f32 and rounded; the PV sum is f32 and rounded once. All G
// columns land before any query attends, as in the TPU kernel: the caller's
// mask keeps query i off the block's columns past idx + i.
//
// What bounds it: the bytes of the cache columns it reads. At the verify
// step of whisper-base speculative serving (16 rows, H=8, Dh=64, G=4,
// Tmax=516, late in the request at idx=508) one call reads
// 2 * 16*8*64*512 * 2 B = 16.8 MB of K/V against 4 * 4 * 16*8*64*512 =
// 67 MFLOP: memory-bound. The TPU kernel exists to read each cache column
// once for all G queries instead of G times; this kernel does the same.
//
// Design: one CTA of four warps per (row, head). The G new columns go to the
// cache first and are staged in shared memory; the score and PV loops take
// columns idx .. idx+G-1 from there and never read back what this CTA just
// wrote, so the writes and the reads cannot race. Scores run with a thread
// per column: the thread reads the column's Dh values once (the reads of a
// [Dh, T] pane coalesce along T) and accumulates all G dot products from
// it. A column no query's mask allows is not read at all. The score rows
// (G x Tmax f32) live in dynamic shared memory sized per call: the
// speculative cache holds P + G * max_new columns, not at most 448. The
// maxima and sums are block reductions of G values at once; the PV product
// runs with a warp per head channel, lanes along T, G sums per lane, and
// reads a V column only where some query's probability is not 0.
//
// The mask row may broadcast over the batch (row stride 0: the prefill's
// contiguous [1, 1, P, Tmax] rule) or differ per row (the verify step's
// [B, 1, G, Tmax] mask with the holes of rejected drafts).
//
// C entry point: nsp_decode_step_multi_bf16 (below). It returns
// cudaGetLastError() after the launch; 0 means the kernel was queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxDh = 128;
constexpr int kMaxG = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB per block
constexpr float kMasked = -1e30f;  // NEG_INF of the TPU kernel

struct Strides {
  long long b, g, h;  // in elements; the head dimension is contiguous
};

// Floats of dynamic shared memory: q and the new K/V columns [G][Dh] each,
// the reduction slots [kWarps][kMaxG], the scores [G][Tmax]. The Python
// wrapper computes the same (ops/decode_step.py::multi_smem_bytes).
__host__ __device__ inline long long smem_floats(int g_n, int head_dim,
                                                 int t_max) {
  return static_cast<long long>(g_n) * (3 * head_dim + t_max) +
         kWarps * kMaxG;
}

// Reduces x[0 .. g_n) over the block (max or sum), each lane of each warp
// ending with the block's G results. g_n is the same in every thread.
template <int GMAX>
__device__ __forceinline__ void block_reduce(float (&x)[GMAX], int g_n,
                                             float* red, bool is_max) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
      float v = x[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, v, off);
        v = is_max ? fmaxf(v, y) : v + y;
      }
      x[g] = v;
    }
  }
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) red[warp * kMaxG + g] = x[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < g_n) {
      float v = red[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        v = is_max ? fmaxf(v, red[w * kMaxG + g]) : v + red[w * kMaxG + g];
      }
      x[g] = v;
    }
  }
}

// GMAX bounds g_n from above at compile time, so that the per-query sums
// stay in registers; g_n <= GMAX is the launch's query count.
template <int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_step_multi_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_new,
                         const __nv_bfloat16* __restrict__ v_new,
                         const uint8_t* __restrict__ mask,
                         __nv_bfloat16* k_t, __nv_bfloat16* v_t,
                         __nv_bfloat16* __restrict__ ctx, int g_n,
                         int n_heads, int head_dim, int t_max, int idx,
                         Strides qs, Strides ks, Strides vs, Strides cs,
                         long long m_sb, long long m_sg, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [G][Dh]
  float* kn_s = q_s + g_n * head_dim;   // [G][Dh]: the new K columns
  float* vn_s = kn_s + g_n * head_dim;  // [G][Dh]: the new V columns
  float* red = vn_s + g_n * head_dim;   // [kWarps][kMaxG]
  float* p_s = red + kWarps * kMaxG;    // [G][Tmax]: scores, then probs

  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pane = (static_cast<long long>(row) * n_heads + head) *
                         head_dim * t_max;
  k_t += pane;  // [Dh, Tmax] of this (row, head)
  v_t += pane;
  mask += row * m_sb;  // [G, Tmax] of this row (stride 0: broadcast)

  for (int i = threadIdx.x; i < g_n * head_dim; i += kThreads) {
    const int g = i / head_dim;
    const int d = i - g * head_dim;
    const __nv_bfloat16 kn = k_new[row * ks.b + g * ks.g + head * ks.h + d];
    const __nv_bfloat16 vn = v_new[row * vs.b + g * vs.g + head * vs.h + d];
    q_s[i] = __bfloat162float(q[row * qs.b + g * qs.g + head * qs.h + d]);
    kn_s[i] = __bfloat162float(kn);
    vn_s[i] = __bfloat162float(vn);
    k_t[d * t_max + idx + g] = kn;
    v_t[d * t_max + idx + g] = vn;
  }
  __syncthreads();

  float mx[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) mx[g] = kMasked;
  for (int t = threadIdx.x; t < t_max; t += kThreads) {
    bool allow[GMAX];
    bool any = false;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      allow[g] = g < g_n && mask[g * m_sg + t] != 0;
      any |= allow[g];
    }
    float dot[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) dot[g] = 0.f;
    if (any) {
      const int j = t - idx;  // the block's own column j, from shared memory
      const bool fresh = j >= 0 && j < g_n;
      for (int d = 0; d < head_dim; ++d) {
        const float kv = fresh ? kn_s[j * head_dim + d]
                               : __bfloat162float(k_t[d * t_max + t]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < g_n) dot[g] = fmaf(q_s[g * head_dim + d], kv, dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) {
        const float s =
            allow[g] ? __bfloat162float(__float2bfloat16_rn(dot[g])) * scale
                     : kMasked;
        p_s[g * t_max + t] = s;
        mx[g] = fmaxf(mx[g], s);
      }
    }
  }
  block_reduce<GMAX>(mx, g_n, red, true);

  float sum[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) sum[g] = 0.f;
  for (int t = threadIdx.x; t < t_max; t += kThreads) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) {
        const float p = expf(p_s[g * t_max + t] - mx[g]);
        p_s[g * t_max + t] = p;
        sum[g] += p;
      }
    }
  }
  block_reduce<GMAX>(sum, g_n, red, false);
  for (int t = threadIdx.x; t < t_max; t += kThreads) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) {
        p_s[g * t_max + t] =
            __bfloat162float(__float2bfloat16_rn(p_s[g * t_max + t] / sum[g]));
      }
    }
  }
  __syncthreads();

  for (int d = warp; d < head_dim; d += kWarps) {
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    for (int t = lane; t < t_max; t += 32) {
      float p[GMAX];
      bool any = false;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        p[g] = g < g_n ? p_s[g * t_max + t] : 0.f;
        any |= p[g] != 0.f;
      }
      if (!any) continue;  // masked for every query: p is exactly 0
      const int j = t - idx;
      const float vv = (j >= 0 && j < g_n)
                           ? vn_s[j * head_dim + d]
                           : __bfloat162float(v_t[d * t_max + t]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) acc[g] = fmaf(p[g], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < g_n) {
        float a = acc[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
        }
        if (lane == 0) {
          ctx[row * cs.b + g * cs.g + head * cs.h + d] =
              __float2bfloat16_rn(a);
        }
      }
    }
  }
}

template <int GMAX>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* mask, void* k_t, void* v_t, void* ctx, int rows,
           int g_n, int n_heads, int head_dim, int t_max, int idx,
           Strides qs, Strides ks, Strides vs, Strides cs, long long m_sb,
           long long m_sg, float scale, cudaStream_t stream) {
  const auto kernel = decode_step_multi_kernel<GMAX>;
  const int smem =
      static_cast<int>(4 * smem_floats(g_n, head_dim, t_max));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(n_heads, rows), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(k_t),
      static_cast<__nv_bfloat16*>(v_t), static_cast<__nv_bfloat16*>(ctx), g_n,
      n_heads, head_dim, t_max, idx, qs, ks, vs, cs, m_sb, m_sg, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k_new, v_new, ctx: [rows, G, H, Dh] bf16 (row, query and head strides
// given, head dimension contiguous); mask: [rows or 1, G, Tmax] bytes, 0 or
// 1 (row stride m_sb, 0 to broadcast; query stride m_sg; Tmax contiguous);
// k_t, v_t: contiguous [rows, H, Dh, Tmax] bf16, updated in place at columns
// idx .. idx+G-1. The caller checks shapes; this entry refuses G outside
// [1, 16], Dh > 128, columns past Tmax and a score row beyond the block's
// shared memory.
extern "C" int nsp_decode_step_multi_bf16(
    const void* q, const void* k_new, const void* v_new, const void* mask,
    void* k_t, void* v_t, void* ctx, int rows, int g_n, int n_heads,
    int head_dim, int t_max, int idx, long long q_sb, long long q_sg,
    long long q_sh, long long k_sb, long long k_sg, long long k_sh,
    long long v_sb, long long v_sg, long long v_sh, long long c_sb,
    long long c_sg, long long c_sh, long long m_sb, long long m_sg,
    float scale, void* stream) {
  if (g_n < 1 || g_n > kMaxG || head_dim < 1 || head_dim > kMaxDh ||
      idx < 0 || idx + g_n > t_max ||
      4 * smem_floats(g_n, head_dim, t_max) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sg, q_sh}, ks{k_sb, k_sg, k_sh},
      vs{v_sb, v_sg, v_sh}, cs{c_sb, c_sg, c_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_n <= 4) {
    return launch<4>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n,
                     n_heads, head_dim, t_max, idx, qs, ks, vs, cs, m_sb,
                     m_sg, scale, s);
  }
  if (g_n <= 8) {
    return launch<8>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n,
                     n_heads, head_dim, t_max, idx, qs, ks, vs, cs, m_sb,
                     m_sg, scale, s);
  }
  return launch<16>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n, n_heads,
                    head_dim, t_max, idx, qs, ks, vs, cs, m_sb, m_sg, scale,
                    s);
}
