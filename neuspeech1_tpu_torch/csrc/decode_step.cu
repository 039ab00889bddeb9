// One cached self-attention decode step for Hopper (sm_90a): write this
// step's K/V column into the cache in place, then attend over the columns
// 0..idx, bf16 in and out.
//
// Replaces neuspeech1_tpu/ops/decode_step.py::_kernel, the Pallas TPU kernel
// behind fused_self_decode. Per (row, head), with the cache k_t, v_t laid out
// [B, H, Dh, Tmax] (time last, as the decode loop keeps it):
//   k_t[..., idx] = k_new; v_t[..., idx] = v_new
//   s_t  = f32(bf16(sum_d q_d k_t[d, t])) * Dh^-1/2       for t <= idx
//   p    = bf16(exp(s - max s) / sum exp(s - max s))
//   ctx  = bf16(sum_t p_t v_t[:, t])                        (f32 sum)
// with the TPU kernel's rounding points: the score is accumulated in f32 and
// rounded once to the cache dtype, then scaled in f32; the probabilities are
// normalised in f32 and rounded; the PV sum is f32 and rounded once.
//
// What bounds it: the bytes of the cache columns it reads. At the beam step
// (80 rows, H=8, Dh=64, idx=131) one call reads 2 * 80*8*64*132 * 2 B =
// 21.6 MB against 4 * 80*8*64*132 = 21.6 MFLOP: memory-bound.
//
// Design: one CTA of four warps per (row, head). The new column goes to the
// cache first; the score loop and the PV loop take column idx from shared
// memory (the values just written) and never read it back from device
// memory, so the write and the reads of that column cannot race. Scores run
// with a thread per column, so the reads of a [Dh, T] row coalesce along T;
// the max and the sum are block reductions; the PV product runs with a warp
// per head channel, lanes along T, reduced by shuffles.
//
// C entry point: nsp_decode_step_bf16 (below). It returns cudaGetLastError()
// after the launch; 0 means the kernel was queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 448;  // max_target_positions
constexpr int kMaxDh = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct RowHead {
  long long b, h;  // in elements; the head dimension is contiguous
};

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new,
                   __nv_bfloat16* k_t, __nv_bfloat16* v_t,
                   __nv_bfloat16* __restrict__ ctx, int n_heads, int head_dim,
                   int t_max, int idx, RowHead qs, RowHead ks, RowHead vs,
                   RowHead cs, float scale) {
  __shared__ float q_s[kMaxDh], kn_s[kMaxDh], vn_s[kMaxDh];
  __shared__ float p_s[kMaxT];
  __shared__ float red[kWarps];

  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pane = (static_cast<long long>(row) * n_heads + head) *
                         head_dim * t_max;
  k_t += pane;  // [Dh, Tmax] of this (row, head)
  v_t += pane;

  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    const __nv_bfloat16 kn = k_new[row * ks.b + head * ks.h + d];
    const __nv_bfloat16 vn = v_new[row * vs.b + head * vs.h + d];
    q_s[d] = __bfloat162float(q[row * qs.b + head * qs.h + d]);
    kn_s[d] = __bfloat162float(kn);
    vn_s[d] = __bfloat162float(vn);
    k_t[d * t_max + idx] = kn;
    v_t[d * t_max + idx] = vn;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = threadIdx.x; t <= idx; t += kThreads) {
    float dot = 0.f;
    if (t == idx) {
      for (int d = 0; d < head_dim; ++d) dot = fmaf(q_s[d], kn_s[d], dot);
    } else {
      for (int d = 0; d < head_dim; ++d) {
        dot = fmaf(q_s[d], __bfloat162float(k_t[d * t_max + t]), dot);
      }
    }
    const float s = __bfloat162float(__float2bfloat16_rn(dot)) * scale;
    p_s[t] = s;
    mx = fmaxf(mx, s);
  }
  mx = block_reduce(mx, red, true);

  float sum = 0.f;
  for (int t = threadIdx.x; t <= idx; t += kThreads) {
    const float p = expf(p_s[t] - mx);
    p_s[t] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  for (int t = threadIdx.x; t <= idx; t += kThreads) {
    p_s[t] = __bfloat162float(__float2bfloat16_rn(p_s[t] / sum));
  }
  __syncthreads();

  for (int d = warp; d < head_dim; d += kWarps) {
    float acc = 0.f;
    for (int t = lane; t <= idx; t += 32) {
      const float vv =
          t == idx ? vn_s[d] : __bfloat162float(v_t[d * t_max + t]);
      acc = fmaf(p_s[t], vv, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      ctx[row * cs.b + head * cs.h + d] = __float2bfloat16_rn(acc);
    }
  }
}

}  // namespace

// q, k_new, v_new, ctx: [rows, 1, H, Dh] bf16 (row and head strides given,
// head dimension contiguous); k_t, v_t: contiguous [rows, H, Dh, Tmax] bf16,
// updated in place at column idx. The caller checks shapes, Dh <= 128,
// Tmax <= 448 and 0 <= idx < Tmax.
extern "C" int nsp_decode_step_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_t, void* v_t,
    void* ctx, int rows, int n_heads, int head_dim, int t_max, int idx,
    long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long v_sb, long long v_sh, long long c_sb, long long c_sh,
    float scale, void* stream) {
  if (head_dim > kMaxDh || t_max > kMaxT || idx < 0 || idx >= t_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_step_kernel<<<dim3(n_heads, rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(k_t), static_cast<__nv_bfloat16*>(v_t),
      static_cast<__nv_bfloat16*>(ctx), n_heads, head_dim, t_max, idx,
      RowHead{q_sb, q_sh}, RowHead{k_sb, k_sh}, RowHead{v_sb, v_sh},
      RowHead{c_sb, c_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}
