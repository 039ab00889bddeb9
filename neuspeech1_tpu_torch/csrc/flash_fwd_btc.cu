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
// What bounds it: at the training shape (B=64, T=1500, H=8, D=64) the two
// products are 2.95e11 FLOP against about 393 MB of q, k, v and o in bf16,
// some 750 FLOP per byte, so the tensor cores are the limit (0.30 ms at the
// bf16 peak). The exponentials come close: one per score, 1.15e9 there, and
// MUFU's 16 a clock per SM also need about 0.30 ms, so the softmax has to run
// under the products, not between them.
//
// Design (FlashAttention-3's shape). A CTA is a producer and consumer
// warpgroups of 64 q rows each: three (a wide CTA, 192 rows, one to an SM)
// where t_q > 64 and wide CTAs fill the SMs twice over, else one (narrow,
// two to an SM: the decoder's cross attention, Tq = 64, and small grids);
// the launcher picks. CTAs are persistent: as many as the SMs hold, each
// walking work items (q tile, head, batch) with the q tile fastest, so the
// CTAs in flight share their heads' K/V in L2, and a CTA's next item is
// loaded while it finishes the last. The producer's one thread issues TMA
// copies into 128-byte (64-byte at D=32) swizzled shared memory, tracked by
// mbarriers: Q once per item, and K/V in tiles of BK rows (128; 64 at D=128,
// which bounds the registers) through a ring of kStages stages (4 wide, 3
// narrow); the tensor maps end at t_q and kv_len, so rows past them arrive
// as zeros. Consumers wait for a stage, release it when their products are
// done, and never meet at a CTA barrier. Per tile j and consumer warpgroup:
//   S_{j+1} = Q K_{j+1}^T      wgmma, A and B from shared memory (K-major)
//   O += bf16(P_j) V_j          wgmma, A from registers, B the V tile read
//                               MN-major: no transpose copy, no scalar packing
//   softmax(S_{j+1})            row max, exp2, row sum, while O's product runs
//   O *= alpha, P = bf16(S)     after both products are done
// so the next tile's scores are issued before this tile's exponentials and
// PV, and waited for only after them; the A fragments are converted outside
// any product in flight (ptxas serializes wgmmas whose inputs are written
// by other instructions while a chain is in flight, C7515).
// What this does about the mma.sync kernel it replaces (160 TFLOP/s, 16% of
// peak): both products on asynchronous wgmma.m64nNk16 (was mma.sync
// m16n8k16); the V operand is read by the tensor cores from its swizzled tile
// (was packed per fragment from two 16-bit shared loads); the next tiles'
// copies run under this tile's products, and no thread but one spends an
// instruction on them (was a synchronous copy by every thread between two
// barriers); masks are tested only on the kv_len tail tile and the causal
// diagonal tiles, and K4's bias row is converted to raw-score units once per
// staged tile, by the producer, read one tile ahead (was a division per tile
// in every thread, and a 20-byte spill at D=64).
// Columns are masked before the row max, and K/V rows at or past kv_len are
// zeros in shared memory, so padded rows (garbage, even NaN) are never read.
// No atomics: the same inputs give the same bits.
// Dynamic shared memory at D = 64 / 32 / 128: wide 157 / 81 / 181 KB, narrow
// 108 / 56 / 116 KB, opted in once per kernel and device. Registers: narrow
// 155-168 per thread; wide 128 at launch, moved by setmaxnreg to 160 for each
// consumer and 32 for the producer; no spills (the build log has ptxas's
// report; chip_smoke.py's build phase prints it).
//
// The bias row (HAS_BIAS, K4) is staged per K tile beside the tile and
// converted to raw-score units, b / scale for a kept column and -inf for a
// bias at or below kMaskedBias; it is added to the scores before the row
// max, so a masked column never enters the max, as the kv_len mask above.
// The TPU kernel instead took the max over the raw products of every column
// and added the bias inside the exponent; that is safe only because the
// masked K rows there (padded, layer-normed encoder states) are bounded, and
// this choice needs no such bound. Both give a fully masked row lse = -inf
// and o = 0/0 = NaN, on which the ring's merge gates: here its max stays
// -inf, every p is exp2(-inf) = 0, l = 0. The HAS_BIAS=false instantiations
// are K1.
//
// C entry points: nsp_flash_fwd_btc_bf16 (K1) and nsp_flash_fwd_btc_bias_bf16
// (K4), below. Each returns cudaGetLastError() after the launch; 0 means the
// kernel was queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

// K/V rows per tile: 128, or 64 at D=128 (the S accumulator, the P
// fragments and the O accumulator share each thread's registers).
template <int D>
constexpr int block_k() {
  return D == 128 ? 64 : 128;
}

// Consumer warpgroups (64 q rows each) of a wide CTA: each K/V tile is read
// once for 192 q rows. Narrow CTAs alone at the training shape read 4.7 GB
// of K/V from L2 and are bound by it (perf/fwd_variants.py, variants narrow,
// narrow_no_softmax, narrow_no_pv); two consumer warpgroups were slower than
// three (variant wide2).
constexpr int kWideWarpgroups = 3;

// The producer follows the consumers (wgmma needs each warpgroup's four
// warps aligned to a multiple of four): one warp beside one consumer
// warpgroup; beside more, a whole warpgroup, so that setmaxnreg can move
// its registers to the consumers.
template <int WG>
constexpr int n_threads() {
  return WG == 1 ? 160 : 128 * (WG + 1);
}
// Registers per thread after setmaxnreg, producer and consumers; two
// consumer warpgroups: 128 x 40 + 256 x 232 = 64512 of the SM's 65536;
// three: 128 x 32 + 384 x 160 = 65536.
template <int WG>
__host__ __device__ constexpr int producer_regs() {
  return WG == 2 ? 40 : 32;
}
template <int WG>
__host__ __device__ constexpr int consumer_regs() {
  return WG == 2 ? 232 : 160;
}

// Dynamic shared memory of a CTA of WG consumer warpgroups: Q [64 WG, D],
// then kStages ring stages of K and V [BK, D] and the bias row [BK] f32,
// then the mbarriers: a full and an empty one for Q and for each stage.
template <int D, int WG>
struct Smem {
  static constexpr int kBK = block_k<D>();
  static constexpr int kStages = WG == 1 ? 3 : 4;
  static constexpr int kTileQ = 64 * WG * D * 2;
  static constexpr int kTileK = kBK * D * 2;
  static constexpr int kBias = 2 * kTileK;
  static constexpr int kStage = round_up_1k(kBias + kBK * 4);
  static constexpr int kBars = kTileQ + kStages * kStage;
  static constexpr int kBytes = kBars + 16 * (1 + kStages) + 1024;
};

static_assert(Smem<32, kWideWarpgroups>::kBytes <= 232448,
              "over 227 KB at D=32");
static_assert(Smem<64, kWideWarpgroups>::kBytes <= 232448,
              "over 227 KB at D=64");
static_assert(Smem<128, kWideWarpgroups>::kBytes <= 232448,
              "over 227 KB at D=128");
static_assert(Smem<64, 1>::kBytes <= 113 * 1024,
              "two one-warpgroup CTAs no longer share an SM");

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const float* bias;
  int batch, n_heads, t_q, kv_len, causal;
  long long o_sb, o_st, o_sh;
  float scale;
};

// TMA: the box at (column c0, row c1, head c2, batch c3) of a [B, T, H, D]
// map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A [ROWS, D] tile at row0: one box per kAtomCols block of D, written where
// Swz<D> puts the block; the map's rows end at t_q or kv_len, and TMA fills
// rows past the end with zeros.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int head,
                                         int batch) {
  constexpr int kA = Swz<D>::kAtomCols;
#pragma unroll
  for (int blk = 0; blk < D / kA; ++blk) {
    tma_load(dst + blk * ROWS * Swz<D>::kRowBytes, map, bar, blk * kA, row0,
             head, batch);
  }
}

template <int D, bool HAS_BIAS, int WG>
__global__ void __launch_bounds__(n_threads<WG>(), WG == 1 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = Smem<D, WG>;
  constexpr int BQ = 64 * WG;
  constexpr int BK = L::kBK;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t q_s = base;
  const uint32_t ring = base + L::kTileQ;
  const uint32_t q_full = base + L::kBars;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full_bar = q_full + 16;           // + 8 s
  const uint32_t empty_bar = q_full + 16 + 8 * S;  // + 8 s

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t_q = p.t_q;
  const int kv_len = p.kv_len;
  // K4 has no causal mask: its instantiations keep no state for one
  const bool causal = !HAS_BIAS && p.causal;

  // Work item w: q tile w % n_qt of (batch, head) w / n_qt. The CTA takes
  // items blockIdx.x, + gridDim.x, ...: at any time the CTAs work on
  // neighbouring items, so a head's K/V is read from L2 by all its q tiles.
  const int n_qt = (t_q + BQ - 1) / BQ;
  const int n_items = n_qt * p.n_heads * p.batch;
  struct Item {
    int q0, head, batch, n;  // n: the K/V tiles it reads
  };
  auto item = [&](int w) {
    Item it;
    it.q0 = (w % n_qt) * BQ;
    it.head = (w / n_qt) % p.n_heads;
    it.batch = w / n_qt / p.n_heads;
    it.n = (kv_len + BK - 1) / BK;
    if (causal) it.n = min(it.n, (min(it.q0 + BQ, t_q) - 1) / BK + 1);
    return it;
  };
  // K/V tiles are counted over the CTA's items: tile c sits in stage c % S
  auto stage_of = [&](int c) { return ring + (c % S) * L::kStage; };

  if (threadIdx.x == 0) {
    // Q: filled by the producer, emptied by each consumer warp once the
    // item's last scores are done; a stage: filled by the producer warp's
    // lanes (all 32 when they write the bias row), emptied by each consumer
    // warp once its PV product is done
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * WG);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, HAS_BIAS ? 32 : 1);
      mbar_init(empty_bar + 8 * s, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // The producer warp: per item, Q once its predecessor's scores are done,
    // then K, V (and the bias row) of every tile into the ring, each stage
    // once its consumers have released it.
    if constexpr (WG > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   ::"n"(producer_regs<WG>()));
      if (warp != 0) return;
    }
    // HAS_BIAS: this lane's entries of the next tile's bias row, read one
    // tile ahead so that their latency passes while the stage is waited for
    float next_bias[BK / 32];
    auto fetch_bias = [&](int j) {
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const int col = j * BK + 32 * i + lane;
        next_bias[i] = col < kv_len ? p.bias[col] : 0.f;
      }
    };
    int c = 0;
    int round = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++round) {
      const Item it = item(w);
      mbar_wait(q_empty, (round & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(q_full, L::kTileQ);
        tma_tile<D, BQ>(q_s, &map_q, q_full, it.q0, it.head, it.batch);
      }
      if constexpr (HAS_BIAS) fetch_bias(0);
      for (int j = 0; j < it.n; ++j, ++c) {
        const int s = c % S;
        const uint32_t st = stage_of(c);
        mbar_wait(empty_bar + 8 * s, ((c / S) & 1) ^ 1);
        if constexpr (HAS_BIAS) {
          // the bias row in raw-score units, once per staged tile
          float* b = reinterpret_cast<float*>(sm + (st - base) + L::kBias);
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            const float x = next_bias[i];
            b[32 * i + lane] = x <= kMaskedBias ? -INFINITY : x / p.scale;
          }
          if (j + 1 < it.n) fetch_bias(j + 1);
        }
        if (lane == 0) {
          mbar_arrive_tx(full_bar + 8 * s, 2 * L::kTileK);
          tma_tile<D, BK>(st, &map_k, full_bar + 8 * s, j * BK, it.head,
                          it.batch);
          tma_tile<D, BK>(st + L::kTileK, &map_v, full_bar + 8 * s, j * BK,
                          it.head, it.batch);
        } else if (HAS_BIAS) {
          mbar_arrive(full_bar + 8 * s);
        }
      }
    }
    return;
  }
  if constexpr (WG > 1) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(consumer_regs<WG>()));
  }

  const int g = lane >> 2;
  const int tg = lane & 3;
  const float scale_log2 = p.scale * kLog2e;
  int wg_row0, row_lo, row_hi;  // this warpgroup's first q row; this thread's
  float m_lo, m_hi;             // running raw-score row max
  float l_lo, l_hi;             // this thread's part of the row sum
  float alpha_lo, alpha_hi;     // rescale of O by the new max
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];
  float oacc[D / 2];

  // S = Q K^T (+ the bias) for this warpgroup's 64 rows and the BK columns
  // of tile c.
  auto issue_s = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BK>(sacc, desc_k<D, BQ>(q_s, wg * 64, kk),
                   desc_k<D, BK>(stage_of(c), 0, kk), kk);
    }
    wgmma_commit();
  };
  // O += bf16(P) V of tile c
  auto issue_pv = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<D>(oacc, pa[kk], desc_mn<D, BK>(stage_of(c) + L::kTileK, kk));
    }
    wgmma_commit();
  };
  // Each consumer warp is done with tile c's stage, or with Q.
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty_bar + 8 * (c % S));
  };
  auto release_q = [&]() {
    if (lane == 0) mbar_arrive(q_empty);
  };
  // The online softmax of the scores in sacc of the item's j-th tile: the
  // masks (only on the tiles that reach past kv_len or the diagonal) go in
  // before the row max, as the bias did; sacc becomes
  // p = exp2((s - max) * scale * log2e); sets the rescale alpha of
  // everything before.
  auto softmax = [&](int j, int c, auto masked) {
    if constexpr (HAS_BIAS) {
      const float2* b = reinterpret_cast<const float2*>(
          sm + (stage_of(c) - base) + L::kBias);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const float2 x = b[4 * nt + tg];
        sacc[4 * nt] += x.x;
        sacc[4 * nt + 1] += x.y;
        sacc[4 * nt + 2] += x.x;
        sacc[4 * nt + 3] += x.y;
      }
    }
    if constexpr (decltype(masked)::value) {
      const int kv0 = j * BK;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (col >= kv_len || (causal && col > row)) {
            sacc[4 * nt + e] = -INFINITY;
          }
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * nt], sacc[4 * nt + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * nt + 2], sacc[4 * nt + 3]));
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
    alpha_lo = exp2_approx(m_lo * scale_log2 - sh_lo);
    alpha_hi = exp2_approx(m_hi * scale_log2 - sh_hi);
    m_lo = new_lo;
    m_hi = new_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[4 * nt + e] = exp2_approx(
            fmaf(sacc[4 * nt + e], scale_log2, e < 2 ? -sh_lo : -sh_hi));
      }
      sum_lo += sacc[4 * nt] + sacc[4 * nt + 1];
      sum_hi += sacc[4 * nt + 2] + sacc[4 * nt + 3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
  };
  auto softmax_tile = [&](int j, int c) {
    const int kv0 = j * BK;
    if (kv0 + BK > kv_len || (causal && kv0 + BK - 1 > wg_row0)) {
      softmax(j, c, std::true_type{});
    } else {
      softmax(j, c, std::false_type{});
    }
  };

  int c = 0;
  int round = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++round) {
    const Item it = item(w);
    wg_row0 = it.q0 + wg * 64;
    row_lo = wg_row0 + warp * 16 + g;
    row_hi = row_lo + 8;
    m_lo = m_hi = -INFINITY;
    l_lo = l_hi = 0.f;
    zero(oacc);

    // The item's first tile: its scores alone.
    mbar_wait(q_full, round & 1);
    mbar_wait(full_bar + 8 * (c % S), (c / S) & 1);
    wgmma_fence();
    issue_s(c);
    wgmma_wait<0>();
    fence_regs(sacc);
    if (it.n == 1) release_q();
    softmax_tile(0, c);
    pack_a<BK>(pa, sacc);

    for (int j = 0; j + 1 < it.n; ++j) {
      const int cj = c + j;
      mbar_wait(full_bar + 8 * ((cj + 1) % S), ((cj + 1) / S) & 1);
      wgmma_fence();
      issue_s(cj + 1);
      issue_pv(cj);
      // S of tile cj + 1 is ready, and O's product runs on under the
      // softmax; except in K4, where the P fragments must be free for the
      // bias row's registers (a wide CTA's consumers get 160, and with both
      // live ptxas spilled)
      wgmma_wait<HAS_BIAS ? 0 : 1>();
      fence_regs(sacc);
      if (j + 2 == it.n) release_q();  // the item's last scores are done
      softmax_tile(j + 1, cj + 1);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(cj);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? alpha_hi : alpha_lo;
      pack_a<BK>(pa, sacc);
    }
    wgmma_fence();
    issue_pv(c + it.n - 1);
    wgmma_wait<0>();
    fence_regs(oacc);
    release(c + it.n - 1);
    c += it.n;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    __nv_bfloat16* o = p.o + it.batch * p.o_sb + it.head * p.o_sh;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + tg * 2;
      if (row_lo < t_q) {
        *reinterpret_cast<uint32_t*>(o + row_lo * p.o_st + col) =
            pack_f32x2(oacc[4 * nd] / l_lo, oacc[4 * nd + 1] / l_lo);
      }
      if (row_hi < t_q) {
        *reinterpret_cast<uint32_t*>(o + row_hi * p.o_st + col) =
            pack_f32x2(oacc[4 * nd + 2] / l_hi, oacc[4 * nd + 3] / l_hi);
      }
    }
    if (tg == 0) {
      const long long bh =
          static_cast<long long>(it.batch) * p.n_heads + it.head;
      float* lse = p.lse + bh * t_q;
      if (row_lo < t_q) lse[row_lo] = m_lo * p.scale + logf(l_lo);
      if (row_hi < t_q) lse[row_hi] = m_hi * p.scale + logf(l_hi);
    }
  }
}

// The TMA map of a [B, T, H, D] bf16 tensor whose rows end at n_rows, in
// boxes of [box_rows, kAtomCols] swizzled as Swz<D>; false if the driver
// refuses it.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int batch, int n_rows,
              int n_heads, Strides st, int box_rows) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {Swz<D>::kAtomCols,
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operands {
  const void *q, *k, *v;
  Strides qs, ks, vs;
  int batch;
};

// The SMs of a device, read once per device.
int sm_count(int dev) {
  static int count[16] = {};
  if (dev < 16 && count[dev]) return count[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 16) count[dev] = n;
  return n;
}

// One CTA per work item, or, where there are more items than the SMs hold
// CTAs, as many CTAs as they hold, each walking its share of the items.
template <int D, bool HAS_BIAS, int WG>
int launch_wg(const Operands& in, const Params& p, cudaStream_t stream) {
  constexpr int kBytes = Smem<D, WG>::kBytes;
  const auto kernel = flash_fwd_kernel<D, HAS_BIAS, WG>;
  // Opt in to the dynamic shared memory, and count the CTAs an SM holds,
  // once per kernel and device.
  static int resident[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = dev < 16 ? resident[dev] : 0;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, n_threads<WG>(), kBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < 16) resident[dev] = per_sm;
  }
  CUtensorMap mq, mk, mv;
  if (!make_map<D>(&mq, in.q, in.batch, p.t_q, p.n_heads, in.qs, 64 * WG) ||
      !make_map<D>(&mk, in.k, in.batch, p.kv_len, p.n_heads, in.ks,
                   block_k<D>()) ||
      !make_map<D>(&mv, in.v, in.batch, p.kv_len, p.n_heads, in.vs,
                   block_k<D>())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(
      (p.t_q + 64 * WG - 1) / (64 * WG)) * p.n_heads * in.batch;
  const long long ctas =
      std::min(items, static_cast<long long>(per_sm) * sm_count(dev));
  kernel<<<static_cast<unsigned>(ctas), n_threads<WG>(), kBytes, stream>>>(
      mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// Wide CTAs where t_q > 64 and they fill the SMs twice over; narrow ones
// for short queries (the decoder's cross attention, Tq = 64) and small
// grids, where 192-row CTAs would leave rows or SMs idle.
template <int D, bool HAS_BIAS>
int launch(const Operands& in, const Params& p, cudaStream_t stream) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRows = 64 * kWideWarpgroups;
  const long long wide_ctas = static_cast<long long>(
      (p.t_q + kRows - 1) / kRows) * p.n_heads * in.batch;
  if (p.t_q > 64 && wide_ctas >= 2 * sm_count(dev)) {
    return launch_wg<D, HAS_BIAS, kWideWarpgroups>(in, p, stream);
  }
  return launch_wg<D, HAS_BIAS, 1>(in, p, stream);
}

template <bool HAS_BIAS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int batch, int n_heads, int t_q, int kv_len, int head_dim,
             int causal, Strides qs, Strides ks, Strides vs, Strides os,
             float scale, const void* bias, void* stream) {
  const Operands in{q, k, v, qs, ks, vs, batch};
  const Params p{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                 static_cast<const float*>(bias), batch, n_heads, t_q, kv_len,
                 causal, os.b, os.t, os.h, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32, HAS_BIAS>(in, p, s);
    case 64:
      return launch<64, HAS_BIAS>(in, p, s);
    case 128:
      return launch<128, HAS_BIAS>(in, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
                         stream);
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
                        0, qs, ks, vs, os, scale, bias, stream);
}
