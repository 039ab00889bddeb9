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
// (80 rows, H=8, Dh=64, idx=131) one call reads 2 * 80*8*64*131 * 2 B =
// 21.5 MB against 4 * 80*8*64*132 = 21.6 MFLOP: memory-bound, 6.6 us at the
// H100 SXM's 3.35 TB/s.
//
// Design: one CTA of four warps per (row, head), as many resident per SM as
// shared memory allows (five at the beam step), so the card keeps the bytes
// of many panes in flight.
// - First every copy of the pane goes out at once: the [Dh, idx] K columns,
//   then the V columns, by cp.async into shared memory (16, 8 or 4 bytes a
//   copy as the rows' alignment allows; plain loads for an odd Tmax), rows
//   of `cols` columns (idx + 1 rounded up to 16, plus 8 so that ldmatrix's
//   eight rows fall in distinct banks). V lands while the scores and the
//   softmax run. Where both panes do not fit the block's shared memory (Dh
//   128 and a long cache), V follows K into the same buffer.
// - The new column goes into the shared copies (column idx of K once K has
//   landed, of V once V has) from the registers that hold k_new and v_new,
//   and into the cache in place at the end, after every copy has landed:
//   the kernel never reads it back from device memory. V's columns past idx
//   are zeroed in shared memory (0 x NaN would be NaN; p is 0 there), and
//   the head dim is padded to 32 rows of zeros.
// - Scores and PV on the tensor cores (mma.sync m16n8k16, the query in row
//   0 of the A operand): K's [Dh, 8] column blocks by ldmatrix.trans, a warp
//   per block in turn; V's [8, 16] blocks by ldmatrix, a warp per 16 head
//   channels. The row max and sum are warp shuffles and one exchange
//   between the warps each. Every sum is taken in a fixed order, so the
//   bits repeat from run to run.
//
// C entry point: nsp_decode_step_bf16 (below). It returns the launch's
// cudaError_t; 0 means the kernel was queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_sm90.cuh"

namespace {

constexpr int kMaxT = 448;  // max_target_positions
constexpr int kMaxDh = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmem = 232448;  // the H100's 227 KB per block

struct RowHead {
  long long b, h;  // in elements; the head dimension is contiguous
};

// Bytes of dynamic shared memory for head dim dh and rows of `cols`
// columns, one pane buffer or two (ops/decode_step.py::step_smem_bytes
// computes the same; a CPU test holds the two together): the K and V panes
// [dk][cols] bf16 (dk: dh rounded up to 32), then q [dk] bf16, the scores
// [cols] f32, p [cols] bf16, and the warps' partial max or sum.
__host__ __device__ constexpr int smem_bytes(int dh, int cols, int panes) {
  return panes * ((dh + 31) / 32 * 32) * cols * 2 +
         2 * ((dh + 31) / 32 * 32) + 6 * cols + 4 * kWarps;
}

// Max or sum over the block: a warp's lanes by shuffles, then the warps'
// values from shared memory in order.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red may still be read from a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Columns [0, n) of the pane's dh rows (row stride t_max) into a [dh][cols]
// buffer, VB bytes a copy (a copy may reach past n, never past t_max).
template <int VB>
__device__ __forceinline__ void copy_pane(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int dh,
                                          int t_max, int cols, int n) {
  constexpr int E = VB / 2;  // columns per copy
  const int per_row = (n + E - 1) / E;
  for (int i = threadIdx.x; i < dh * per_row; i += kThreads) {
    const int d = i / per_row;
    const int c = (i % per_row) * E;
    if constexpr (VB >= 4) {
      cp_async<VB>(smem_addr(dst + d * cols + c),
                   src + static_cast<long long>(d) * t_max + c, VB);
    } else {
      dst[d * cols + c] = src[static_cast<long long>(d) * t_max + c];
    }
  }
}

template <int DH, int VB>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new,
                   __nv_bfloat16* k_t, __nv_bfloat16* v_t,
                   __nv_bfloat16* __restrict__ ctx, int n_heads, int head_dim,
                   int t_max, int idx, int cols, int panes, RowHead qs,
                   RowHead ks, RowHead vs, RowHead cs, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int dk = (head_dim + 31) / 32 * 32;  // head dim rows, zero-padded
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + (panes - 1) * dk * cols;
  __nv_bfloat16* q_s = k_s + panes * dk * cols;  // [dk]
  float* sc_s = reinterpret_cast<float*>(q_s + dk);  // [cols]
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(sc_s + cols);
  float* red = reinterpret_cast<float*>(p_s + cols);  // [kWarps]
  const int extent = cols - 8;  // columns the products cover
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const long long pane = (static_cast<long long>(row) * n_heads + head) *
                         head_dim * t_max;
  k_t += pane;  // [Dh, Tmax] of this (row, head)
  v_t += pane;

  // Every copy of the pane at once: K, then V (unless V must wait for K's
  // buffer).
  copy_pane<VB>(k_s, k_t, head_dim, t_max, cols, idx);
  cp_async_commit();
  if (panes == 2) copy_pane<VB>(v_s, v_t, head_dim, t_max, cols, idx);
  cp_async_commit();

  // The head dim's padding rows of both panes are zeros.
  for (int i = tid; i < (dk - head_dim) * cols; i += kThreads) {
    const int off = (head_dim + i / cols) * cols + i % cols;
    k_s[off] = __float2bfloat16_rn(0.f);
    v_s[off] = __float2bfloat16_rn(0.f);
  }
  __nv_bfloat16 kn = __float2bfloat16_rn(0.f), vn = kn;
  for (int d = tid; d < dk; d += kThreads) {
    __nv_bfloat16 qd = __float2bfloat16_rn(0.f);
    if (d < head_dim) {
      kn = k_new[row * ks.b + head * ks.h + d];
      vn = v_new[row * vs.b + head * vs.h + d];
      qd = q[row * qs.b + head * qs.h + d];
    }
    q_s[d] = qd;
  }
  cp_async_wait<1>();
  __syncthreads();
  if (tid < head_dim) k_s[tid * cols + idx] = kn;  // dk <= kThreads
  __syncthreads();

  // Scores: warp w takes the 8-column blocks w, w + 4, ...; q in row 0 of
  // the A operand (lanes 0-3 hold it), K's block by ldmatrix.trans, two
  // 16-row steps of the head dim per ldmatrix.
  float mx = -INFINITY;
  for (int nb = warp; nb < extent / 8; nb += kWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < DH; k0 += 32) {
      if (k0 >= dk) break;
      uint32_t b[4];
      ldsm_x4_t(b, smem_addr(k_s + (k0 + lane) * cols + 8 * nb));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = k0 + 16 * h + 2 * t;
        const uint32_t a[4] = {
            g == 0 ? *reinterpret_cast<const uint32_t*>(q_s + d) : 0u, 0u,
            g == 0 ? *reinterpret_cast<const uint32_t*>(q_s + d + 8) : 0u,
            0u};
        mma16816(acc, a, b[2 * h], b[2 * h + 1]);
      }
    }
    if (g == 0) {
      const int c = 8 * nb + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = bf16_round(acc[e]) * scale;
        sc_s[c + e] = s;
        if (c + e <= idx) mx = fmaxf(mx, s);
      }
    }
  }
  mx = block_reduce<true>(mx, red);

  float sum = 0.f;
  for (int c = tid; c <= idx; c += kThreads) {
    const float p = expf(sc_s[c] - mx);
    sc_s[c] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);
  for (int c = tid; c < extent; c += kThreads) {
    p_s[c] = __float2bfloat16_rn(c <= idx ? sc_s[c] / sum : 0.f);
  }
  if (panes == 1) {  // V into K's buffer, now that the scores are done
    __syncthreads();
    copy_pane<VB>(v_s, v_t, head_dim, t_max, cols, idx);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  // Column idx of V from v_new (thread d holds v_new[d]), the columns after
  // it zeros.
  if (tid < head_dim) {
    v_s[tid * cols + idx] = vn;
    for (int c = idx + 1; c < extent; ++c) {
      v_s[tid * cols + c] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  // PV: warp w takes the 16 head channels 16 w, 16 (w + 4), ...; p in row 0
  // of the A operand, V's [16 channels, 16 columns] block by ldmatrix.
  for (int d0 = 16 * warp; d0 < dk; d0 += 16 * kWarps) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int c0 = 0; c0 < extent; c0 += 16) {
      uint32_t b[4];
      ldsm_x4(b, smem_addr(v_s + (d0 + 8 * (lane >> 4) + (lane & 7)) * cols +
                           c0 + 8 * ((lane >> 3) & 1)));
      const uint32_t a[4] = {
          g == 0 ? *reinterpret_cast<const uint32_t*>(p_s + c0 + 2 * t) : 0u,
          0u,
          g == 0 ? *reinterpret_cast<const uint32_t*>(p_s + c0 + 8 + 2 * t)
                 : 0u,
          0u};
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
    if (g == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int d = d0 + 8 * n + 2 * t;
        if (d < head_dim) {
          ctx[row * cs.b + head * cs.h + d] = __float2bfloat16_rn(acc[n][0]);
        }
        if (d + 1 < head_dim) {
          ctx[row * cs.b + head * cs.h + d + 1] =
              __float2bfloat16_rn(acc[n][1]);
        }
      }
    }
  }
  // The new column into the cache, once the copies have landed.
  if (tid < head_dim) {
    k_t[tid * static_cast<long long>(t_max) + idx] = kn;
    v_t[tid * static_cast<long long>(t_max) + idx] = vn;
  }
}

template <int DH, int VB>
int launch(const void* q, const void* k_new, const void* v_new, void* k_t,
           void* v_t, void* ctx, int rows, int n_heads, int head_dim,
           int t_max, int idx, int cols, int panes, RowHead qs, RowHead ks,
           RowHead vs, RowHead cs, float scale, cudaStream_t stream) {
  // A plain launch, not one of one-CTA clusters: the decode loops alternate
  // this kernel with K6's cluster launches, and launched as a cluster of
  // one it added about 0.4 ms a call to the beam loop on an H100 (PERF.md).
  static int raised[kMaxDevices] = {};
  const auto kernel = decode_step_kernel<DH, VB>;
  const int smem = smem_bytes(head_dim, cols, panes);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (raised[dev] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = smem;
    }
  }
  kernel<<<dim3(n_heads, rows), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(k_t), static_cast<__nv_bfloat16*>(v_t),
      static_cast<__nv_bfloat16*>(ctx), n_heads, head_dim, t_max, idx, cols,
      panes, qs, ks, vs, cs, scale);
  return static_cast<int>(cudaGetLastError());
}

// The copy width: the widest of 16, 8 and 4 bytes that the cache rows'
// alignment (Tmax * 2 bytes apart, from the caches' addresses) allows; 2
// for an odd Tmax.
template <int DH>
int launch_dh(const void* q, const void* k_new, const void* v_new, void* k_t,
              void* v_t, void* ctx, int rows, int n_heads, int head_dim,
              int t_max, int idx, int cols, int panes, RowHead qs,
              RowHead ks, RowHead vs, RowHead cs, float scale,
              cudaStream_t stream) {
#define NSP_LAUNCH(VB)                                                     \
  launch<DH, VB>(q, k_new, v_new, k_t, v_t, ctx, rows, n_heads, head_dim,  \
                 t_max, idx, cols, panes, qs, ks, vs, cs, scale, stream)
  const uintptr_t align = (reinterpret_cast<uintptr_t>(k_t) |
                           reinterpret_cast<uintptr_t>(v_t) |
                           static_cast<uintptr_t>(t_max) * 2) & 15;
  if (align == 0) return NSP_LAUNCH(16);
  if (align % 8 == 0) return NSP_LAUNCH(8);
  if (align % 4 == 0) return NSP_LAUNCH(4);
  return NSP_LAUNCH(2);
#undef NSP_LAUNCH
}

}  // namespace

// q, k_new, v_new, ctx: [rows, 1, H, Dh] bf16 (row and head strides given,
// head dimension contiguous); k_t, v_t: contiguous [rows, H, Dh, Tmax] bf16,
// updated in place at column idx. The plan
// (ops/decode_step.py::step_plan): rows of `cols` columns (8 past a multiple
// of 16 that is at least idx + 1) in `panes` buffers (2: K and V together;
// 1: V after K).
// The caller checks shapes; this entry refuses Dh past 128, Tmax past 448,
// idx outside [0, Tmax) and a plan that does not fit the block.
extern "C" int nsp_decode_step_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_t, void* v_t,
    void* ctx, int rows, int n_heads, int head_dim, int t_max, int idx,
    int cols, int panes, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long v_sb, long long v_sh, long long c_sb,
    long long c_sh, float scale, void* stream) {
  if (head_dim < 1 || head_dim > kMaxDh || t_max > kMaxT || idx < 0 ||
      idx >= t_max || cols % 16 != 8 || cols - 8 < idx + 1 ||
      (panes != 1 && panes != 2) ||
      smem_bytes(head_dim, cols, panes) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const RowHead qs{q_sb, q_sh}, ks{k_sb, k_sh}, vs{v_sb, v_sh}, cs{c_sb, c_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NSP_LAUNCH_DH(DH)                                                   \
  launch_dh<DH>(q, k_new, v_new, k_t, v_t, ctx, rows, n_heads, head_dim,    \
                t_max, idx, cols, panes, qs, ks, vs, cs, scale, s)
  if (head_dim <= 32) return NSP_LAUNCH_DH(32);
  if (head_dim <= 64) return NSP_LAUNCH_DH(64);
  return NSP_LAUNCH_DH(128);
#undef NSP_LAUNCH_DH
}
