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
// normalised by the whole row's f32 sum, then rounded; the PV sum is f32 and
// rounded once. All G columns land before any query attends, as in the TPU
// kernel: the caller's mask keeps query i off the block's columns past
// idx + i. A column that no query's mask allows contributes nothing, even
// where it holds NaN (a query whose mask allows no column at all gets a
// context of 0, where the plain version averages every column).
//
// What bounds it: the bytes of the cache columns it reads. At the verify
// step of whisper-base speculative serving (16 rows, H=8, Dh=64, G=4,
// Tmax=516, late in the request at idx=508) one call reads
// 2 * 16*8*64*512 * 2 B = 16.8 MB of K/V against 4 * 4 * 16*8*64*512 =
// 67 MFLOP: memory-bound. The TPU kernel exists to read each cache column
// once for all G queries instead of G times; this kernel does the same.
//
// Design:
// - A (row, head) is one thread-block cluster of `cluster` CTAs (1-8, the
//   wrapper's plan: ops/decode_step.py::multi_plan); CTA r owns the
//   columns [r * cols, (r + 1) * cols) below Tmax, cols a multiple of the
//   32-column tile.
// - A CTA first turns its mask rows into bit words (one per query and tile,
//   and their union), lists the tiles some query allows, writes the new
//   columns that lie in its range and stages them in shared memory.
// - Then one ring of kStages [Dh, 32] tiles, filled by cp.async (16, 8 or 4
//   bytes a copy as Tmax's alignment allows, zeros past Tmax), streams the
//   listed K tiles and then the listed V tiles, so that the first V tiles
//   are in flight while the scores are exchanged. A tile that holds new
//   columns takes them from shared memory, never from what was just
//   written to the cache.
// - Scores s = q k on the tensor cores (mma.sync m16n8k16, the G queries
//   padded to 16 rows, K by ldmatrix.trans from the [Dh, T] tile), a warp
//   per 8 columns; masked scores are selected out, and kept in shared
//   memory ([G, cols] f32, only this CTA's columns).
// - The cluster exchanges each query's max, then its sum, through
//   distributed shared memory, so p is normalised by the whole row's sum
//   before its bf16 rounding, as in the TPU kernel.
// - ctx = p v on the tensor cores, a warp per Dh/4 channels; V's columns
//   that no query allows are zeroed in the operand registers (select, not
//   multiply: 0 x NaN would be NaN). The CTAs' partial contexts are summed
//   through distributed shared memory in rank order: the same bits on every
//   run, no atomics.
//
// The mask row may broadcast over the batch (row stride 0: the prefill's
// contiguous [1, 1, P, Tmax] rule) or differ per row (the verify step's
// [B, 1, G, Tmax] mask with the holes of rejected drafts).
//
// C entry point: nsp_decode_step_multi_bf16 (below). It returns the launch's
// cudaError_t; 0 means the kernel was queued.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxG = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;     // cache columns per tile
constexpr int kStages = 4;    // tiles in the ring
constexpr int kMaxSmem = 232448;  // the H100's 227 KB per block

struct Strides {
  long long b, g, h;  // in elements; the head dimension is contiguous
};

// Bytes of dynamic shared memory for G queries, head dim dh and a range of
// cols columns, in the order laid out below (ops/decode_step.py::
// multi_smem_bytes computes the same; a CPU test holds the two together):
// the ring, q [16][dh] bf16, the new K and V columns [G][dh] bf16, the
// scores [G][cols] f32, p [16][cols + 8] bf16, the bit words [G + 1][tiles]
// and the tile list [tiles], then 128 floats of row values and the list's
// length, rounded up to 16 bytes.
__host__ __device__ constexpr long long smem_bytes(long long g, long long dh,
                                                   long long cols) {
  return kStages * dh * 64 + 32 * dh + 4 * g * dh + 4 * g * cols +
         32 * cols + 256 + 4 * (g + 2) * (cols / 32) + 528;
}

// Element i of `x` in each of the cluster's n CTAs, in rank order: the
// peers' loads first (independent, so their latencies overlap), then the
// max or the sum.
__device__ __forceinline__ float cluster_max(cg::cluster_group cl,
                                             float* x, int i, int n) {
  float v[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) {
    v[c] = c < n ? (n == 1 ? x : cl.map_shared_rank(x, c))[i] : -INFINITY;
  }
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) m = fmaxf(m, v[c]);
  return m;
}
__device__ __forceinline__ float cluster_sum(cg::cluster_group cl,
                                             float* x, int i, int n) {
  float v[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) {
    v[c] = c < n ? (n == 1 ? x : cl.map_shared_rank(x, c))[i] : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) s += v[c];
  return s;
}

template <int DH, int VB>
__global__ void __launch_bounds__(kThreads)
decode_step_multi_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k_new,
                         const __nv_bfloat16* __restrict__ v_new,
                         const uint8_t* __restrict__ mask,
                         __nv_bfloat16* k_t, __nv_bfloat16* v_t,
                         __nv_bfloat16* __restrict__ ctx, int g_n,
                         int n_heads, int t_max, int idx, int cols,
                         Strides qs, Strides ks, Strides vs, Strides cs,
                         long long m_sb, long long m_sg, float scale) {
  constexpr int kTileBytes = DH * 64;   // [DH][32] bf16
  constexpr int kQRow = 2 * DH;         // bytes of a q row
  constexpr int kNB = DH / 32;          // n8 blocks of ctx per warp
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(cluster.num_blocks());
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_cap = cols / kTile;
  const int p_pitch = 2 * cols + 16;  // bytes of a p row

  uint8_t* ring = smem;
  uint8_t* q_sm = ring + kStages * kTileBytes;
  __nv_bfloat16* kn_s = reinterpret_cast<__nv_bfloat16*>(q_sm + 16 * kQRow);
  __nv_bfloat16* vn_s = kn_s + g_n * DH;
  float* sc = reinterpret_cast<float*>(vn_s + g_n * DH);  // [G][cols]
  uint8_t* p_sm = reinterpret_cast<uint8_t*>(sc + g_n * cols);
  uint32_t* bits = reinterpret_cast<uint32_t*>(p_sm + 16 * p_pitch);
  uint32_t* any = bits + g_n * tiles_cap;  // [tiles]
  int* list = reinterpret_cast<int*>(any + tiles_cap);
  float* red = reinterpret_cast<float*>(list + tiles_cap);  // [4][16]
  float* m_cta = red + kWarps * kMaxG;
  float* l_cta = m_cta + kMaxG;
  float* m_row = l_cta + kMaxG;
  float* l_row = m_row + kMaxG;
  int* n_list_s = reinterpret_cast<int*>(l_row + kMaxG);
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t q_s = smem_addr(q_sm);
  const uint32_t p_s = smem_addr(p_sm);

  const int c0 = rank * cols;
  const int c1 = min(t_max, c0 + cols);
  const int n_tiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
  const long long pane =
      (static_cast<long long>(row) * n_heads + head) * DH * t_max;
  k_t += pane;  // [DH, Tmax] of this (row, head)
  v_t += pane;
  mask += row * m_sb;  // [G, Tmax] of this row (stride 0: broadcast)

  // q (zero rows past G) and the new columns, all loaded at once (each
  // loop below is unrolled, so no load waits for an earlier one's store)
  constexpr int kPer = 16 * DH / kThreads;
  __nv_bfloat16 xq[kPer], xk[kPer], xv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = (threadIdx.x + i * kThreads) / DH;
    const int d = (threadIdx.x + i * kThreads) % DH;
    xq[i] = xk[i] = xv[i] = __float2bfloat16_rn(0.f);
    if (g < g_n) {
      xq[i] = q[row * qs.b + g * qs.g + head * qs.h + d];
      xk[i] = k_new[row * ks.b + g * ks.g + head * ks.h + d];
      xv[i] = v_new[row * vs.b + g * vs.g + head * vs.h + d];
    }
  }
  // the mask as bit words: bit j of word (g, w) is column c0 + 32 w + j;
  // warp `warp` takes the words warp, warp + 4, ..., kBatch at a time, all
  // of a batch's bytes loaded before its ballots
  constexpr int kBatch = 8;
  const int n_words = g_n * n_tiles;
  for (int base = 0; base < n_words; base += kWarps * kBatch) {
    bool on[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int pr = base + warp + kWarps * i;
      const int t = c0 + (pr % n_tiles) * kTile + lane;
      on[i] = pr < n_words && t < c1 && mask[(pr / n_tiles) * m_sg + t] != 0;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int pr = base + warp + kWarps * i;
      if (pr < n_words) {
        const uint32_t word = __ballot_sync(0xffffffffu, on[i]);
        if (lane == 0) {
          bits[(pr / n_tiles) * tiles_cap + pr % n_tiles] = word;
        }
      }
    }
  }
  // stage q and the new columns; write the new columns that lie in this
  // CTA's range to the cache
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int g = (threadIdx.x + i * kThreads) / DH;
    const int d = (threadIdx.x + i * kThreads) % DH;
    *reinterpret_cast<__nv_bfloat16*>(q_sm + swz<kQRow>(g, d / 8) +
                                      (d % 8) * 2) = xq[i];
    if (g < g_n) {
      kn_s[g * DH + d] = xk[i];
      vn_s[g * DH + d] = xv[i];
      const int t = idx + g;
      if (t >= c0 && t < c1) {
        k_t[d * t_max + t] = xk[i];
        v_t[d * t_max + t] = xv[i];
      }
    }
  }
  if (threadIdx.x < kMaxG) {
    l_cta[threadIdx.x] = 0.f;
    m_cta[threadIdx.x] = -INFINITY;
  }
  __syncthreads();
  // the tiles some query allows, in order
  if (warp == 0) {
    int n = 0;
    for (int w0 = 0; w0 < n_tiles; w0 += 32) {
      const int w = w0 + lane;
      uint32_t u = 0;
      if (w < n_tiles) {
        for (int g = 0; g < g_n; ++g) u |= bits[g * tiles_cap + w];
        any[w] = u;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, u != 0);
      if (u != 0) list[n + __popc(ballot & ((1u << lane) - 1u))] = w;
      n += __popc(ballot);
    }
    if (lane == 0) *n_list_s = n;
  }
  __syncthreads();
  const int n_list = *n_list_s;
  const int n_loads = 2 * n_list;  // K tiles, then V tiles

  // load j of the sequence into ring slot j % kStages; a group is committed
  // even when empty so that the wait below counts loads
  auto issue = [&](int j) {
    if (j < n_loads) {
      const __nv_bfloat16* src = j < n_list ? k_t : v_t;
      const int t0 = c0 + list[j < n_list ? j : j - n_list] * kTile;
      const uint32_t dst = ring_s + (j % kStages) * kTileBytes;
      if constexpr (VB >= 4) {
        constexpr int kCopies = 64 / VB;  // per 64-byte tile row
#pragma unroll
        for (int e = threadIdx.x; e < DH * kCopies; e += kThreads) {
          const int r = e / kCopies;
          const int b = (e % kCopies) * VB;  // byte in the tile row
          const int col = t0 + b / 2;
          const int valid = min(VB, max(0, 2 * (t_max - col)));
          cp_async<VB>(dst + swz<64>(r, b >> 4) + (b & 15),
                       src + r * static_cast<long long>(t_max) +
                           (valid ? col : 0),
                       valid);
        }
      } else {  // odd Tmax: rows are 2-byte aligned, so plain loads
        for (int e = threadIdx.x; e < DH * kTile; e += kThreads) {
          const int r = e / kTile;
          const int c = e % kTile;
          const int col = t0 + c;
          const __nv_bfloat16 x =
              col < t_max ? src[r * static_cast<long long>(t_max) + col]
                          : __float2bfloat16_rn(0.f);
          *reinterpret_cast<__nv_bfloat16*>(ring + (j % kStages) * kTileBytes +
                                            swz<64>(r, c >> 3) +
                                            (c & 7) * 2) = x;
        }
      }
    }
    cp_async_commit();
  };

  // this CTA's load j: wait for it, and patch in the new columns it holds
  auto arrive = [&](int j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int t0 = c0 + list[j < n_list ? j : j - n_list] * kTile;
    if (idx < t0 + kTile && idx + g_n > t0) {
      const __nv_bfloat16* fresh = j < n_list ? kn_s : vn_s;
      for (int e = threadIdx.x; e < g_n * DH; e += kThreads) {
        const int g = e / DH;
        const int d = e % DH;
        const int c = idx + g - t0;
        if (c >= 0 && c < kTile) {
          *reinterpret_cast<__nv_bfloat16*>(ring + (j % kStages) * kTileBytes +
                                            swz<64>(d, c >> 3) +
                                            (c & 7) * 2) = fresh[g * DH + d];
        }
      }
      __syncthreads();
    }
    return ring_s + (j % kStages) * kTileBytes;
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  // q as the A operand, all of Dh
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    ldsm_x4(qa[kk], q_s + swz<kQRow>(lane & 15, 2 * kk + (lane >> 4)));
  }

  // scores: warp w takes the tile's columns 8 w .. 8 w + 7; this thread's
  // are 8 w + 2 (lane % 4) + {0, 1}, for queries lane / 4 (+ 8)
  const int tl = warp * 8 + (lane & 3) * 2;
  float mx[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_list; ++j) {
    const uint32_t tile = arrive(j);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kp = 0; kp < DH / 32; ++kp) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + swz<64>(kp * 32 + lane, warp));
      mma16816(s, qa[2 * kp], b[0], b[1]);
      mma16816(s, qa[2 * kp + 1], b[2], b[3]);
    }
    const int w = list[j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = (lane >> 2) + 8 * h;
      if (g < g_n) {
        const uint32_t word = bits[g * tiles_cap + w];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = (word >> (tl + e)) & 1u
                              ? bf16_round(s[2 * h + e]) * scale
                              : -INFINITY;
          sc[g * cols + j * kTile + tl + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    __syncthreads();  // the slot is refilled by the next issue
  }

  // the barrier over the cluster's CTAs (this CTA alone in a cluster of one)
  auto cluster_barrier = [&] {
    if (n_cta > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  // each query's max over the cluster
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(mx[h]);
    if ((lane & 3) == 0) red[warp * kMaxG + (lane >> 2) + 8 * h] = m;
  }
  __syncthreads();
  if (threadIdx.x < kMaxG) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w * kMaxG + threadIdx.x]);
    m_cta[threadIdx.x] = m;
  }
  cluster_barrier();
  if (threadIdx.x < kMaxG) {
    m_row[threadIdx.x] = cluster_max(cluster, m_cta, threadIdx.x, n_cta);
  }
  __syncthreads();
  // exp and each query's sum over the cluster (masked scores: exactly 0)
  const int n_cols = n_list * kTile;
  for (int g = warp; g < g_n; g += kWarps) {
    const float m = m_row[g];
    float sum = 0.f;
    for (int c = lane; c < n_cols; c += 32) {
      const float x = sc[g * cols + c];
      const float p = x == -INFINITY ? 0.f : expf(x - m);
      sc[g * cols + c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) l_cta[g] = sum;
  }
  cluster_barrier();
  if (threadIdx.x < kMaxG) {
    l_row[threadIdx.x] = cluster_sum(cluster, l_cta, threadIdx.x, n_cta);
  }
  __syncthreads();
  // p = bf16(exp / sum), zero rows past G
  for (int e = threadIdx.x; e < 16 * n_cols; e += kThreads) {
    const int g = e / n_cols;
    const int c = e % n_cols;
    float p = 0.f;
    if (g < g_n && l_row[g] > 0.f) p = sc[g * cols + c] / l_row[g];
    *reinterpret_cast<__nv_bfloat16*>(p_sm + g * p_pitch + 2 * c) =
        __float2bfloat16_rn(p);
  }
  __syncthreads();

  // ctx = p v: warp w takes the head channels of n8 blocks w * kNB ..
  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  for (int j = 0; j < n_list; ++j) {
    const uint32_t tile = arrive(n_list + j);
    const uint32_t keep = any[list[j]];
    // this thread's V columns: 16 kk + 2 (lane % 4) + {0, 1} (+ 8)
    uint32_t sel[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t two = (keep >> (16 * kk + 8 * half + (lane & 3) * 2)) & 3u;
        sel[kk][half] = ((two & 1u) ? 0x0000ffffu : 0u) |
                        ((two & 2u) ? 0xffff0000u : 0u);
      }
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      ldsm_x4(pa[kk], p_s + (lane & 15) * p_pitch +
                          (j * kTile + 16 * kk + 8 * (lane >> 4)) * 2);
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz<64>((warp * kNB + n) * 8 + (lane & 7), lane >> 3));
      mma16816(acc[n], pa[0], b[0] & sel[0][0], b[1] & sel[0][1]);
      mma16816(acc[n], pa[1], b[2] & sel[1][0], b[3] & sel[1][1]);
    }
    __syncthreads();  // the slot is refilled by the next issue
  }
  cp_async_wait<0>();
  __syncthreads();

  // the CTA's partial ctx [16][DH] f32 over the ring; summed over the
  // cluster in rank order, CTA `rank` writing its share
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const int d = (warp * kNB + n) * 8 + (lane & 3) * 2;
    const int g = lane >> 2;
    *reinterpret_cast<float2*>(part + g * DH + d) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * DH + d) =
        make_float2(acc[n][2], acc[n][3]);
  }
  cluster_barrier();
  for (int e = rank * kThreads + threadIdx.x; e < g_n * DH;
       e += n_cta * kThreads) {
    const float sum = cluster_sum(cluster, part, e, n_cta);
    const int g = e / DH;
    const int d = e % DH;
    ctx[row * cs.b + g * cs.g + head * cs.h + d] = __float2bfloat16_rn(sum);
  }
  if (n_cta > 1) {
    cluster.sync();  // no CTA leaves while a peer reads its shared memory
  }
}

template <int DH, int VB>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* mask, void* k_t, void* v_t, void* ctx, int rows,
           int g_n, int n_heads, int t_max, int idx, int cluster, int cols,
           Strides qs, Strides ks, Strides vs, Strides cs, long long m_sb,
           long long m_sg, float scale, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  return launch_clusters(
      decode_step_multi_kernel<DH, VB>, raised, dim3(cluster, n_heads, rows),
      kThreads, cluster, static_cast<int>(smem_bytes(g_n, DH, cols)), stream,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(k_t),
      static_cast<__nv_bfloat16*>(v_t), static_cast<__nv_bfloat16*>(ctx), g_n,
      n_heads, t_max, idx, cols, qs, ks, vs, cs, m_sb, m_sg, scale);
}

// The copy width: the widest of 16, 8 and 4 bytes that the cache rows'
// alignment (Tmax * 2 bytes apart) allows; 2 for an odd Tmax.
template <int DH>
int launch_dh(const void* q, const void* k_new, const void* v_new,
              const void* mask, void* k_t, void* v_t, void* ctx, int rows,
              int g_n, int n_heads, int t_max, int idx, int cluster, int cols,
              Strides qs, Strides ks, Strides vs, Strides cs, long long m_sb,
              long long m_sg, float scale, cudaStream_t stream) {
#define NSP_LAUNCH(VB)                                                       \
  launch<DH, VB>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n, n_heads,   \
                 t_max, idx, cluster, cols, qs, ks, vs, cs, m_sb, m_sg, scale, \
                 stream)
  if (t_max % 8 == 0) return NSP_LAUNCH(16);
  if (t_max % 4 == 0) return NSP_LAUNCH(8);
  if (t_max % 2 == 0) return NSP_LAUNCH(4);
  return NSP_LAUNCH(2);
#undef NSP_LAUNCH
}

}  // namespace

// q, k_new, v_new, ctx: [rows, G, H, Dh] bf16 (row, query and head strides
// given, head dimension contiguous); mask: [rows or 1, G, Tmax] bytes, 0 or
// 1 (row stride m_sb, 0 to broadcast; query stride m_sg; Tmax contiguous);
// k_t, v_t: contiguous [rows, H, Dh, Tmax] bf16 with 16-byte aligned panes,
// updated in place at columns idx .. idx+G-1. `cluster` CTAs (1-8) split
// each (row, head), CTA r taking the columns [r * cols, (r + 1) * cols)
// below Tmax (ops/decode_step.py::multi_plan). The caller checks shapes;
// this entry refuses G outside [1, 16], Dh other than 32, 64 or 128,
// columns past Tmax, a plan that leaves columns out or whose range does not
// fit the block's shared memory.
extern "C" int nsp_decode_step_multi_bf16(
    const void* q, const void* k_new, const void* v_new, const void* mask,
    void* k_t, void* v_t, void* ctx, int rows, int g_n, int n_heads,
    int head_dim, int t_max, int idx, int cluster, int cols, long long q_sb,
    long long q_sg, long long q_sh, long long k_sb, long long k_sg,
    long long k_sh, long long v_sb, long long v_sg, long long v_sh,
    long long c_sb, long long c_sg, long long c_sh, long long m_sb,
    long long m_sg, float scale, void* stream) {
  if (g_n < 1 || g_n > kMaxG || idx < 0 || idx + g_n > t_max ||
      cluster < 1 || cluster > kMaxCluster || cols < kTile ||
      cols % kTile != 0 ||
      static_cast<long long>(cluster) * cols < t_max ||
      smem_bytes(g_n, head_dim, cols) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_sg, q_sh}, ks{k_sb, k_sg, k_sh},
      vs{v_sb, v_sg, v_sh}, cs{c_sb, c_sg, c_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dh<32>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n,
                           n_heads, t_max, idx, cluster, cols, qs, ks, vs, cs,
                           m_sb, m_sg, scale, s);
    case 64:
      return launch_dh<64>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n,
                           n_heads, t_max, idx, cluster, cols, qs, ks, vs, cs,
                           m_sb, m_sg, scale, s);
    case 128:
      return launch_dh<128>(q, k_new, v_new, mask, k_t, v_t, ctx, rows, g_n,
                            n_heads, t_max, idx, cluster, cols, qs, ks, vs,
                            cs, m_sb, m_sg, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
