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
// memory system is the limit by two orders of magnitude. So the design keeps
// enough loads in flight on every SM and keeps the issue slots free for
// them:
//
// - A (batch, head, group of up to 32 query rows) is one thread-block
//   cluster of `cluster` CTAs (1-8, the wrapper's plan: ops/decode_cross.py
//   ::plan); CTA r streams the cache rows [r * rows_per_split,
//   (r + 1) * rows_per_split) clipped at kv_len.
// - A CTA streams its rows through R rings of 16-row K/V chunks, two deep,
//   filled by cp.async, 16 bytes a lane (ring g takes chunks g, g + R,
//   ...); rows at or past the range's end are zero-filled by the copy and
//   never read. With up to 16 query rows one warp runs each of 4 rings;
//   with more, two warps, one m16 tile of query rows each, share each of 8
//   rings (a named barrier per ring): the cache is read once and a warp's
//   chain of work stays one tile long. No CTA barrier runs in the loop.
// - The products run on the tensor cores (mma.sync m16n8k16): s = q k^T
//   from ldmatrix'd K rows, then p v with p taken from s's accumulators as
//   bf16 and V by ldmatrix.trans. Each warp keeps an online softmax
//   (running max and f32 row sum) over its ring's chunks.
// - The merge: the rings' (max, sum, o) combine in shared memory; after
//   one barrier over the cluster, CTA r reads every CTA's (max, sum, o)
//   through distributed shared memory, one round of loads, and writes its
//   share of o, in a fixed order (rings, then ranks): one launch, no global
//   scratch, the same bits on every run.
// The running max makes the rounding of exp(s - m) to bf16 relative to a
// ring's running max instead of the row's final max (the bound is stated in
// chip_smoke.py, K6_REL_TOL).
//
// C entry point: nsp_decode_cross_bf16 (below). It returns the launch's
// cudaError_t; 0 means the kernel was queued.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxQ = 64;       // query rows per call
constexpr int kGroupRows = 32;  // query rows per CTA: up to two m16 tiles
constexpr int kChunk = 16;      // cache rows a ring takes a step
constexpr int kStages = 2;      // chunks in each ring

struct Strides {
  long long b, t, h;  // in elements; the head dimension is contiguous
};

// Rings per CTA of MT m16 tiles (each run by MT warps: 16 warps, a whole
// SM's registers, for two tiles), and CTAs per SM at 128 registers a
// thread.
constexpr int rings(int mt) { return mt == 1 ? 4 : 8; }
template <int MT>
constexpr int min_blocks() {
  return 16 / (rings(MT) * MT);
}

// A CTA of MT m16 tiles of query rows runs rings(MT) MT warps: warp w takes
// tile w / rings and shares ring w % rings with the other tile's warp, so
// the cache is read once for all the CTA's query rows while each warp holds
// one tile's sums. The dynamic shared memory, in bytes: the rings (K and V chunks),
// then the query tile, then the merge's row values (per ring: max, sum,
// weight; per CTA: max, sum). After the stream the rings hold the partial
// o, [ring][kRows][D] f32.
template <int D, int MT>
struct Layout {
  static constexpr int kRings = rings(MT);
  static constexpr int kThreads = 32 * kRings * MT;
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kChunkBytes = kChunk * kRowBytes;  // K or V
  static constexpr int kStageBytes = 2 * kChunkBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kRows = 16 * MT;
  static constexpr int kQ = kRings * kRingBytes;
  static constexpr int kRowVals = kQ + kRows * kRowBytes;
  static constexpr int kBytes = kRowVals + (3 * kRings + 2) * kGroupRows * 4;
  static_assert(kRings * kRows * D * 4 <= kQ, "partial o fits the rings");
};

// The merge of a CTA's rings and of the cluster's CTAs: each ring's warps
// have left their (max, sum, o) of query rows [0, nq) in shared memory (o:
// [kRings][ROWS][D] f32 at `smem`, the row values m_w [kRings][32], l_w
// [kRings][32], then room for sc_w [kRings][32], m_cta [32], l_cta [32]).
// The four rings' values combine in shared memory; after one barrier over
// the cluster, CTA `split` reads every CTA's (max, sum, o) through
// distributed shared memory, one round of loads, and writes its share of o
// (rows t of `o` at o + t * o_st), in a fixed order (rings, then ranks):
// the same bits on every run. NT: the CTA's threads.
template <int D, int ROWS, int NT, int R>
__device__ __forceinline__ void merge_store(cg::cluster_group& cluster,
                                            uint8_t* smem, float* m_w,
                                            int nq, int split, int n_split,
                                            __nv_bfloat16* o, long long o_st) {
  constexpr int kRows = ROWS;
  constexpr int kThreads = NT;
  constexpr int kRings = R;
  float* l_w = m_w + kRings * kGroupRows;
  float* sc_w = l_w + kRings * kGroupRows;
  float* m_cta = sc_w + kRings * kGroupRows;
  float* l_cta = m_cta + kGroupRows;
  __syncthreads();
  // the CTA's rows: max and sum over its warps, each warp's weight
  for (int r = threadIdx.x; r < nq; r += kThreads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kRings; ++w) mx = fmaxf(mx, m_w[w * kGroupRows + r]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kRings; ++w) {
      const float f =
          mx == -INFINITY ? 0.f : expf(m_w[w * kGroupRows + r] - mx);
      sc_w[w * kGroupRows + r] = f;
      l = fmaf(f, l_w[w * kGroupRows + r], l);
    }
    m_cta[r] = mx;
    l_cta[r] = l;
  }
  __syncthreads();
  float* o_cta = reinterpret_cast<float*>(smem);  // over warp 0's rows
  for (int e = threadIdx.x; e < nq * D; e += kThreads) {
    const int r = e / D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRings; ++w) {
      sum = fmaf(sc_w[w * kGroupRows + r], o_cta[w * kRows * D + e], sum);
    }
    o_cta[e] = sum;
  }
  // every CTA's (max, sum, o) is ready: a barrier over the cluster, or over
  // this CTA alone
  if (n_split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  // o over the cluster's CTAs in rank order; CTA `split` writes elements
  // split * 128 + ..., two a thread at a time, all of their peers' values
  // loaded before the sums (one round of distributed shared memory loads)
  auto peer = [&](float* p, int c) {
    return n_split == 1 ? p : cluster.map_shared_rank(p, c);
  };
  constexpr int kPerThread = 2;
  for (int e0 = split * kThreads + threadIdx.x; e0 < nq * D;
       e0 += kPerThread * n_split * kThreads) {
    float m_c[kPerThread][kMaxCluster], l_c[kPerThread][kMaxCluster];
    float o_c[kPerThread][kMaxCluster];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = e0 + u * n_split * kThreads;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < n_split && e < nq * D) {
          m_c[u][c] = peer(m_cta, c)[e / D];
          l_c[u][c] = peer(l_cta, c)[e / D];
          o_c[u][c] = peer(o_cta, c)[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = e0 + u * n_split * kThreads;
      if (e >= nq * D) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < n_split) mx = fmaxf(mx, m_c[u][c]);
      }
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < n_split) {
          const float f =
              m_c[u][c] == -INFINITY ? 0.f : expf(m_c[u][c] - mx);
          num = fmaf(f, o_c[u][c], num);
          den = fmaf(f, l_c[u][c], den);
        }
      }
      o[(e / D) * o_st + e % D] = __float2bfloat16_rn(num / den);
    }
  }
  if (n_split > 1) {
    cluster.sync();  // no CTA leaves while a peer reads its shared memory
  }
}

template <int D, int MT>
__global__ void __launch_bounds__(Layout<D, MT>::kThreads, min_blocks<MT>())
decode_cross_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, int n_heads, int t_q,
                    int kv_len, int rows_per_split, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale) {
  using L = Layout<D, MT>;
  constexpr int kRings = L::kRings;
  constexpr int kThreads = L::kThreads;
  constexpr int kRows = L::kRows;
  constexpr int kRowBytes = L::kRowBytes;
  constexpr int kDC = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int head = blockIdx.y % n_heads;
  const int q0 = (blockIdx.y / n_heads) * kGroupRows;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rg = warp % kRings;  // this warp's ring
  const int mt = warp / kRings;  // and its m16 tile of query rows
  const int tr = mt * 32 + lane;  // this thread among the ring's
  const int nq = min(kRows, t_q - q0);  // >= 1 query rows of this CTA

  const uint32_t smem_s = smem_addr(smem);
  const uint32_t q_s = smem_s + L::kQ;
  float* m_w = reinterpret_cast<float*>(smem + L::kRowVals);  // [rings][32]
  float* l_w = m_w + kRings * kGroupRows;                     // [rings][32]

  q += batch * qs.b + head * qs.h + q0 * qs.t;
  k += batch * ks.b + head * ks.h;
  v += batch * vs.b + head * vs.h;

  const int row_begin = split * rows_per_split;
  const int row_end = min(kv_len, row_begin + rows_per_split);
  const int n_chunks =
      row_end > row_begin ? (row_end - row_begin + kChunk - 1) / kChunk : 0;
  const int my_n = n_chunks > rg ? (n_chunks - rg + kRings - 1) / kRings : 0;
  const uint32_t ring = smem_s + rg * L::kRingBytes;

  // chunk i of this ring (cache rows from row_begin + (rg + 4 i) * 16) into
  // slot i % kStages, copied by the ring's threads; a group is committed
  // even when empty so that the wait below counts chunks
  auto issue = [&](int i) {
    if (i < my_n) {
      const int r0 = row_begin + (rg + kRings * i) * kChunk;
      const uint32_t kd = ring + (i % kStages) * L::kStageBytes;
      const uint32_t vd = kd + L::kChunkBytes;
#pragma unroll
      for (int e = tr; e < kChunk * kDC; e += 32 * MT) {
        const int r = e / kDC;
        const int c = e % kDC;
        const bool in = r0 + r < row_end;
        const long long t = in ? r0 + r : row_begin;
        const int off = swz<kRowBytes>(r, c);
        cp_async<16>(kd + off, k + t * ks.t + c * 8, in ? 16 : 0);
        cp_async<16>(vd + off, v + t * vs.t + c * 8, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // the ring's warps agree that a slot has landed, or is free again
  auto ring_sync = [&] {
    if constexpr (MT == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "r"(32 * MT)
                   : "memory");
    }
  };

  // the query rows by 4-byte copies (q rows are 4-byte aligned), zeros past
  // nq, in a group of their own ahead of the first chunks, so that their
  // latency runs under the chunks'
  for (int i = threadIdx.x; i < kRows * (D / 2); i += kThreads) {
    const int r = i / (D / 2);
    const int w = i % (D / 2);
    cp_async<4>(q_s + swz<kRowBytes>(r, w >> 2) + (w & 3) * 4,
                q + (r < nq ? r : 0) * qs.t + 2 * w, r < nq ? 4 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  cp_async_wait<kStages - 1>();  // the query group
  __syncthreads();

  float acc[D / 8][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int i = 0; i < my_n; ++i) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    ring_sync();
    const uint32_t kt = ring + (i % kStages) * L::kStageBytes;
    const uint32_t vt = kt + L::kChunkBytes;
    const int r0 = row_begin + (rg + kRings * i) * kChunk;

    // s = q k^T: [this warp's 16 query rows] x [16 cache rows], two n8
    // blocks
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4], a[4];
      ldsm_x4(b, kt + swz<kRowBytes>((lane & 7) + ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
      ldsm_x4(a, q_s + swz<kRowBytes>(mt * 16 + (lane & 15),
                                      2 * kk + (lane >> 4)));
      mma16816(s[0], a, b[0], b[1]);
      mma16816(s[1], a, b[2], b[3]);
    }

    // online softmax per query row (h: rows lane/4 and lane/4 + 8 of the
    // m16 tile); this thread's cache rows are c0 + {0, 1, 8, 9}
    const int c0 = r0 + (lane & 3) * 2;
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[4];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + (e >> 1) * 8 + (e & 1);
        x[e] = col < row_end ? s[e >> 1][2 * h + (e & 1)] * scale : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      const float m_old = m_run[h];
      const float m_new = fmaxf(m_old, quad_max(mx));
      // a chunk wholly past the range, before any valid row: nothing
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_old - m_use);  // 0 on the first rows
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = expf(x[e] - m_use);  // masked rows: 0
        sum += x[e];
      }
      m_run[h] = m_new;
      l_run[h] = l_run[h] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
      // the A operand of p v: rows h, cache rows (e >> 1) * 8
      pa[h] = pack_bf16(x[0], x[1]);
      pa[2 + h] = pack_bf16(x[2], x[3]);
    }

    // o += bf16(p) v: V rows by ldmatrix.trans, two n8 blocks of D a load
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_t(b, vt + swz<kRowBytes>((lane & 7) + (((lane >> 3) & 1) << 3),
                                       2 * j + (lane >> 4)));
      mma16816(acc[2 * j], pa, b[0], b[1]);
      mma16816(acc[2 * j + 1], pa, b[2], b[3]);
    }
    ring_sync();  // the slot is refilled by the next issue
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // each warp's (max, sum, o) of its tile's rows into its ring's slot of
  // the merge's values, o over the rings
  float* o_w = reinterpret_cast<float*>(smem) + rg * kRows * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + (lane >> 2) + 8 * h;
    const float l = quad_sum(l_run[h]);
    if (r >= nq) continue;  // a padding row
    if ((lane & 3) == 0) {
      m_w[rg * kGroupRows + r] = m_run[h];
      l_w[rg * kGroupRows + r] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(o_w + r * D + d) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
  merge_store<D, kRows, kThreads, kRings>(
      cluster, smem, m_w, nq, split, n_split,
      o + batch * os.b + q0 * os.t + head * os.h, os.t);
}

template <int D, int MT>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int t_q, int kv_len, int cluster, int rows_per_split,
           Strides qs, Strides ks, Strides vs, Strides os, float scale,
           cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const int q_groups = (t_q + kGroupRows - 1) / kGroupRows;
  return launch_clusters(
      decode_cross_kernel<D, MT>, raised,
      dim3(cluster, n_heads * q_groups, batch), Layout<D, MT>::kThreads,
      cluster, Layout<D, MT>::kBytes, stream, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n_heads, t_q, kv_len, rows_per_split, qs, ks, vs, os, scale);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int n_heads, int t_q, int kv_len, int cluster,
             int rows_per_split, Strides qs, Strides ks, Strides vs,
             Strides os, float scale, cudaStream_t stream) {
  if (t_q <= 16) {
    return launch<D, 1>(q, k, v, o, batch, n_heads, t_q, kv_len, cluster,
                        rows_per_split, qs, ks, vs, os, scale, stream);
  }
  return launch<D, 2>(q, k, v, o, batch, n_heads, t_q, kv_len, cluster,
                      rows_per_split, qs, ks, vs, os, scale, stream);
}

}  // namespace

// q: [B, Tq, H, D]; k, v: rows t of head h of batch b at b*sb + t*st + h*sh
// ([B, H, T, D] or [B, T, H*D]); o: [B, Tq, H, D]; all bf16 with the head
// dimension contiguous and every row 16-byte aligned (q's 4-byte). Strides
// are in elements. `cluster` CTAs (1-8) split each (batch, head, group of
// 32 query rows), CTA r taking rows [r * rows_per_split,
// (r + 1) * rows_per_split) below kv_len (ops/decode_cross.py::plan). The
// caller checks shapes; this entry refuses Tq outside [1, 64], a head dim
// other than 32, 64 or 128, kv_len < 1, a cluster that is not a power of two
// up to 8 and a plan that leaves rows out.
extern "C" int nsp_decode_cross_bf16(
    const void* q, const void* k, const void* v, void* o, int batch,
    int n_heads, int t_q, int kv_len, int head_dim, int cluster,
    int rows_per_split, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, void* stream) {
  if (t_q < 1 || t_q > kMaxQ || kv_len < 1 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      rows_per_split < 1 ||
      static_cast<long long>(cluster) * rows_per_split < kv_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh};
  const Strides vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_d<32>(q, k, v, o, batch, n_heads, t_q, kv_len, cluster,
                          rows_per_split, qs, ks, vs, os, scale, st);
    case 64:
      return launch_d<64>(q, k, v, o, batch, n_heads, t_q, kv_len, cluster,
                          rows_per_split, qs, ks, vs, os, scale, st);
    case 128:
      return launch_d<128>(q, k, v, o, batch, n_heads, t_q, kv_len, cluster,
                           rows_per_split, qs, ks, vs, os, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
