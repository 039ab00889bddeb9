// Full-row attention forward probe for Hopper (sm_90a) on bf16 tensors.
//
// Replaces the Pallas TPU tuning probes of the flash forward (P-fwd):
//   perf/kernel_probe.py::make_kernel (modes), ::make_online (n_kb column
//   blocks), ::make_semantics (grid hints); perf/mxu_probe.py::make_fwd
//   (q sub-tiles); perf/btc_probe.py::make_fwd_btc, ::make_fwd_btc_sem
//   ([B, T, H*D] layout, lse out).
// Per (batch*head) and query row, over TK keys of which t_valid are kept:
//   s   = q k^T * D^-1/2 (f32), columns >= t_valid set to -1e30 (not NOMASK)
//   m   = the exact row max of s over each of n_kb column blocks, taken as a
//         running max from block to block (m starts at -1e30)
//   p   = f(s - m), l = rowsum(p)
//   o   = (bf16(p) v) / l  (f32 accumulation, o rounded to bf16 once)
//   lse = m + log(l)        (optional)
// with f = exp (BASE, NOMASK), x * 0.001 + 1 (NOEXP), or
// bf16(exp(bf16(x))) widened to f32 (BF16EXP); at each block boundary l and
// the accumulator are scaled by exp(m_old - m_new), as make_online does.
//
// What bounds it: at B*H = 512, TK = 1536, D = 64 and 1500 kept columns the
// two products are 4 * 512 * 1536 * 1500 * 64 = 302 GFLOP against 403 MB of
// q, k, v, o: the tensor cores (0.305 ms at 989 TFLOP/s), not the bytes. One
// exponential per score, 1.2e9, needs 0.33 ms of MUFU (16 a clock per SM),
// so the softmax has to run under the products.
//
// Design (K1's pipeline, csrc/flash_fwd_btc.cu). The TPU block held block_q
// rows of scores over all 1536 columns in VMEM; the old kernel here kept 32
// rows of f32 scores over all columns in shared memory (192 KB, one 4-warp
// CTA an SM, every score through shared memory three times, mma.sync, K/V
// copied by every thread between two barriers: 11.5 ms). Now a CTA is one
// producer warp (one warpgroup beside two consumers, for setmaxnreg) and WG
// consumer warpgroups of 64 q rows each, persistent, walking (head, q tile)
// items. The producer's one thread issues TMA copies into 128-byte swizzled
// shared memory, counted on mbarriers: Q once per item, K (and V) in tiles
// of BK rows through a ring of stages. Scores stay in registers. The TPU's
// semantics need the exact block max before any p (NOEXP is linear in s - m
// and BF16EXP rounds it, so an online rescale cannot compute them), so each
// item takes two sweeps over K in the one launch:
//   1. S = Q K^T (wgmma, both operands in shared memory), the masked row max
//      of each column block; at most 4 maxima a row, kept in registers.
//   2. S again, p = f(s - m) with m known (no running-max rescale inside a
//      block; the online correction only at the n_kb block boundaries), and
//      O += bf16(P) V (wgmma, A from registers, V read MN-major from its
//      swizzled tile: no transpose copy). The next tile's scores are issued
//      with this tile's PV and waited for before its exponentials, as in K1.
// That is 1.5x the function's products (a 0.458 ms floor) and no max
// updates or rescales in the serial path, which bound K1. One launch a call.
// The probe variants map onto the schedule (neuspeech1_tpu_torch/perf/
// common.py): block_q -> rows = 64 WG (bq256 -> one warpgroup, two CTAs an
// SM; bq512 -> two); n_sub -> how the consumer warpgroups share the tensor
// cores: 1 free-running, 2 ping-pong (each warpgroup's products of a K tile
// issue in its turn, handed on by named barriers, so one warpgroup's softmax
// runs under the other's products), 4 ping-pong on 64-column tiles (four
// turns per 128 columns); order -> the items' walk: 0 head-major (a head's
// q tiles in consecutive items, so the CTAs in flight share its K/V in L2),
// 1 q-tile-major (the same q tile of consecutive heads). BK is 128, or 64
// where n_sub = 4 or a column block is not a multiple of 128 (TK = 256, n_kb
// = 4 in the CPU tests' geometry). Both layouts are one 2-D view: rows of
// the B*TK (or B*H*TK) time steps, each head a 64-column box of a row.
// Masked columns (and, in NOMASK, none) are tested only on the tiles that
// reach past t_valid. No atomics: the same inputs give the same bits.
// Dynamic shared memory: one warpgroup 105 KB (two CTAs an SM), two 145 KB.
// Registers: 168 a thread at launch; two warpgroups' consumers move to 232
// by setmaxnreg, no spills; one warpgroup stays at 168 (two CTAs of five
// warps), where the BF16EXP and NOMASK instances with 128-row K tiles spill
// 156 and 24 bytes (ptxas, the build log).
//
// C entry point: nsp_probe_fwd_bf16, below. Returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for a schedule that is not built).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kD = 64;             // head dim
constexpr float kNegInf = -1e30f;  // the probes' NEG_INF
constexpr int kMaxBlocks = 4;      // n_kb: block maxima kept per row

enum Mode { BASE = 0, NOMASK = 1, NOEXP = 2, BF16EXP = 3 };

// A schedule: WG consumer warpgroups, K tiles of BK rows, and whether the
// warpgroups take turns on the tensor cores (n_sub > 1).
template <int WG, int BK, bool TURNS>
struct Sched {
  static constexpr int kThreads = WG == 1 ? 160 : 128 * (WG + 1);
  static constexpr int kStages = (WG == 1 ? 3 : 4) * (128 / BK);
  static constexpr int kTileQ = 64 * WG * kD * 2;
  static constexpr int kTileK = BK * kD * 2;
  static constexpr int kStage = 2 * kTileK;  // K and V
  static constexpr int kBars = kTileQ + kStages * kStage;
  static constexpr int kBytes = kBars + 16 * (1 + kStages) + 1024;
  static_assert(!TURNS || WG > 1, "one warpgroup takes no turns");
};

static_assert(Sched<1, 128, false>::kBytes <= 113 * 1024,
              "two one-warpgroup CTAs no longer share an SM");
static_assert(Sched<2, 64, true>::kBytes <= 232448, "over 227 KB");

// Registers per thread after setmaxnreg, producer and consumers, with two
// consumer warpgroups: 128 x 40 + 256 x 232 = 64512 of the SM's 65536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int n_bh, n_heads, tk, t_valid, n_kb, order;
  long long o_sb, o_sh, o_st;
  float scale;
};

template <int MODE, int WG, int BK, bool TURNS>
__global__ void __launch_bounds__(Sched<WG, BK, TURNS>::kThreads,
                                  WG == 1 ? 2 : 1)
probe_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Params p) {
  using L = Sched<WG, BK, TURNS>;
  constexpr int BQ = 64 * WG;
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
  const int n_t = p.tk / BK;           // K tiles of one sweep
  const int t_per_b = n_t / p.n_kb;    // K tiles of one column block
  const int n_qt = p.tk / BQ;
  const int n_items = n_qt * p.n_bh;
  // Work item w: (head bh, first q row q0), head-major or q-tile-major.
  auto item = [&](int w, int& bh, int& q0) {
    if (p.order == 0) {
      bh = w / n_qt;
      q0 = (w % n_qt) * BQ;
    } else {
      bh = w % p.n_bh;
      q0 = (w / p.n_bh) * BQ;
    }
  };
  // K/V tiles are counted over the CTA's items and sweeps: tile c sits in
  // stage c % S
  auto stage_of = [&](int c) { return ring + (c % S) * L::kStage; };

  if (threadIdx.x == 0) {
    // Q: filled by the producer, emptied by each consumer warp once the
    // item's last scores are done; a stage: filled by the producer, emptied
    // by each consumer warp once its products on the stage are done
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * WG);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // The producer: per item, Q once its predecessor's scores are done, then
    // the K tiles of sweep 1 and the K and V tiles of sweep 2 into the ring,
    // each stage once its consumers have released it.
    if constexpr (WG > 1) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    }
    if (threadIdx.x != WG * 128) return;
    int c = 0;
    int round = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++round) {
      int bh, q0;
      item(w, bh, q0);
      // the head's box: its 64 columns of the rows of its batch entry
      const int col = (bh % p.n_heads) * kD;
      const int row = (bh / p.n_heads) * p.tk;
      mbar_wait(q_empty, (round & 1) ^ 1);
      mbar_arrive_tx(q_full, L::kTileQ);
      tma_load_2d(q_s, &map_q, q_full, col, row + q0);
      for (int sweep = 0; sweep < 2; ++sweep) {
        for (int j = 0; j < n_t; ++j, ++c) {
          const int s = c % S;
          const uint32_t st = stage_of(c);
          mbar_wait(empty_bar + 8 * s, ((c / S) & 1) ^ 1);
          mbar_arrive_tx(full_bar + 8 * s, (sweep + 1) * L::kTileK);
          tma_load_2d(st, &map_k, full_bar + 8 * s, col, row + j * BK);
          if (sweep == 1) {
            tma_load_2d(st + L::kTileK, &map_v, full_bar + 8 * s, col,
                        row + j * BK);
          }
        }
      }
    }
    return;
  }
  if constexpr (WG > 1) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  }

  const int g = lane >> 2;
  const int tg = lane & 3;
  const float scale = p.scale;
  const float scale_log2 = scale * kLog2e;
  const int t_valid = p.t_valid;
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];
  float oacc[kD / 2];
  // the running max of s at the end of each column block, this thread's
  // two rows
  float bm_lo[kMaxBlocks], bm_hi[kMaxBlocks];

  // The turns: warpgroup w issues its products after bar_sync(1 + w) and
  // hands the turn on with bar_arrive to the next; the last warpgroup
  // opens the first turn, and the first closes the last one at the end.
  auto turn_begin = [&]() {
    if constexpr (TURNS) bar_sync(1 + wg, 256);
  };
  auto turn_end = [&]() {
    if constexpr (TURNS) bar_arrive(1 + (wg + 1) % WG, 256);
  };
  if constexpr (TURNS) {
    if (wg == WG - 1) bar_arrive(1, 256);
  }

  // S = Q K^T for this warpgroup's 64 rows and the BK columns of tile c.
  auto issue_s = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wgmma_ss<BK>(sacc, desc_k<kD, BQ>(q_s, wg * 64, kk),
                   desc_k<kD, BK>(stage_of(c), 0, kk), kk);
    }
    wgmma_commit();
  };
  // O += bf16(P) V of tile c
  auto issue_pv = [&](int c) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<kD>(oacc, pa[kk], desc_mn<kD, BK>(stage_of(c) + L::kTileK, kk));
    }
    wgmma_commit();
  };
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty_bar + 8 * (c % S));
  };
  auto release_q = [&]() {
    if (lane == 0) mbar_arrive(q_empty);
  };
  // Is column e of this thread's n-tile nt in tile j masked?
  auto masked_col = [&](int j, int nt, int e) {
    return j * BK + nt * 8 + tg * 2 + (e & 1) >= t_valid;
  };
  // The tile reaches past t_valid (NOMASK keeps every column): only such
  // tiles test their columns.
  auto tile_masked = [&](int j) {
    return MODE != NOMASK && (j + 1) * BK > t_valid;
  };

  int c = 0;
  int round = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++round) {
    int bh, q0;
    item(w, bh, q0);
    const int row_lo = q0 + wg * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    mbar_wait(q_full, round & 1);

    // Sweep 1: the raw row max of each column block, then the running max
    // in s units (from -1e30, as the probes start it).
    float run_lo = kNegInf, run_hi = kNegInf;
    for (int b = 0; b < p.n_kb; ++b) {
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
      for (int jj = 0; jj < t_per_b; ++jj, ++c) {
        const int j = b * t_per_b + jj;
        mbar_wait(full_bar + 8 * (c % S), (c / S) & 1);
        wgmma_fence();
        turn_begin();
        issue_s(c);
        turn_end();
        wgmma_wait<0>();
        fence_regs(sacc);
        release(c);
        if (tile_masked(j)) {
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (masked_col(j, nt, e)) sacc[4 * nt + e] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          mx_lo = fmaxf(mx_lo, fmaxf(sacc[4 * nt], sacc[4 * nt + 1]));
          mx_hi = fmaxf(mx_hi, fmaxf(sacc[4 * nt + 2], sacc[4 * nt + 3]));
        }
      }
      // the four threads of a fragment row differ in the low two lane bits
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      // scale is a power of two: max(raw) * scale = max(raw * scale)
      run_lo = fmaxf(run_lo, mx_lo * scale);
      run_hi = fmaxf(run_hi, mx_hi * scale);
#pragma unroll
      for (int i = 0; i < kMaxBlocks; ++i) {
        if (i == b) {
          bm_lo[i] = run_lo;
          bm_hi[i] = run_hi;
        }
      }
    }

    // Sweep 2: p = f(s - m) with the block's m, O += bf16(P) V.
    float m_lo = bm_lo[0], m_hi = bm_hi[0];
    float l_lo = 0.f, l_hi = 0.f;
    float alpha_lo = 1.f, alpha_hi = 1.f;
    zero(oacc);
    // Tile j starts block b > 0: m moves to the block's max, l and (once
    // the previous PV is done) O are scaled by exp(m_old - m_new).
    auto enter_block = [&](int b) {
      float n_lo = bm_lo[0], n_hi = bm_hi[0];
#pragma unroll
      for (int i = 1; i < kMaxBlocks; ++i) {
        if (i == b) {
          n_lo = bm_lo[i];
          n_hi = bm_hi[i];
        }
      }
      alpha_lo = exp2_approx((m_lo - n_lo) * kLog2e);
      alpha_hi = exp2_approx((m_hi - n_hi) * kLog2e);
      m_lo = n_lo;
      m_hi = n_hi;
      l_lo *= alpha_lo;
      l_hi *= alpha_hi;
    };
    // sacc <- p of tile j, l += its row sums.
    auto softmax_as = [&](int j, auto masked) {
      const float sh_lo = m_lo * kLog2e, sh_hi = m_hi * kLog2e;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float raw = sacc[4 * nt + e];
          const float m = e < 2 ? m_lo : m_hi;
          const bool out =
              decltype(masked)::value && masked_col(j, nt, e);
          float pr;
          if constexpr (MODE == NOEXP) {
            const float s = out ? kNegInf : raw * scale;
            pr = __fmaf_rn(s - m, 0.001f, 1.0f);
          } else if constexpr (MODE == BF16EXP) {
            const float s = out ? kNegInf : raw * scale;
            pr = bf16_round(exp2_approx(bf16_round(s - m) * kLog2e));
          } else {
            pr = out ? 0.f
                     : exp2_approx(fmaf(raw, scale_log2,
                                        e < 2 ? -sh_lo : -sh_hi));
          }
          sacc[4 * nt + e] = pr;
        }
        sum_lo += sacc[4 * nt] + sacc[4 * nt + 1];
        sum_hi += sacc[4 * nt + 2] + sacc[4 * nt + 3];
      }
      l_lo += sum_lo;
      l_hi += sum_hi;
    };
    auto softmax = [&](int j) {
      if (tile_masked(j)) {
        softmax_as(j, std::true_type{});
      } else {
        softmax_as(j, std::false_type{});
      }
    };

    // The first tile: its scores alone.
    mbar_wait(full_bar + 8 * (c % S), (c / S) & 1);
    wgmma_fence();
    turn_begin();
    issue_s(c);
    turn_end();
    wgmma_wait<0>();
    fence_regs(sacc);
    if (n_t == 1) release_q();
    softmax(0);
    pack_a<BK>(pa, sacc);

    for (int j = 0; j + 1 < n_t; ++j) {
      const int cj = c + j;
      mbar_wait(full_bar + 8 * ((cj + 1) % S), ((cj + 1) / S) & 1);
      wgmma_fence();
      turn_begin();
      issue_s(cj + 1);
      issue_pv(cj);
      turn_end();
      // S of tile j + 1 is ready; O's product runs on under the softmax
      wgmma_wait<1>();
      fence_regs(sacc);
      if (j + 2 == n_t) release_q();  // the item's last scores are done
      const bool new_block = (j + 1) % t_per_b == 0;
      if (new_block) enter_block((j + 1) / t_per_b);
      softmax(j + 1);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(cj);
      if (new_block) {
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) {
          oacc[i] *= (i & 2) ? alpha_hi : alpha_lo;
        }
      }
      pack_a<BK>(pa, sacc);
    }
    wgmma_fence();
    turn_begin();
    issue_pv(c + n_t - 1);
    turn_end();
    wgmma_wait<0>();
    fence_regs(oacc);
    release(c + n_t - 1);
    c += n_t;

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const int batch = bh / p.n_heads, head = bh % p.n_heads;
    __nv_bfloat16* o = p.o + batch * p.o_sb + head * p.o_sh;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const int col = nd * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(o + row_lo * p.o_st + col) =
          pack_f32x2(oacc[4 * nd] / l_lo, oacc[4 * nd + 1] / l_lo);
      *reinterpret_cast<uint32_t*>(o + row_hi * p.o_st + col) =
          pack_f32x2(oacc[4 * nd + 2] / l_hi, oacc[4 * nd + 3] / l_hi);
    }
    if (p.lse != nullptr && tg == 0) {
      float* lse = p.lse + static_cast<long long>(bh) * p.tk;
      lse[row_lo] = m_lo + logf(l_lo);
      lse[row_hi] = m_hi + logf(l_hi);
    }
  }
  // close the turn the last warpgroup handed to the first
  if constexpr (TURNS) {
    if (wg == 0) bar_sync(1, 256);
  }
}

// The SMs of a device, read once per device.
int sm_count(int dev) {
  static int count[16] = {};
  if (dev < 16 && count[dev]) return count[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 16) count[dev] = n;
  return n;
}

struct Args {
  const void *q, *k, *v;
  int n_b;        // rows of the 2-D view: n_b * tk
  long long s_t;  // elements between consecutive rows
};

// As many persistent CTAs as the SMs hold, or one per item if fewer.
template <int MODE, int WG, int BK, bool TURNS>
int launch(const Args& a, const Params& p, cudaStream_t stream) {
  using L = Sched<WG, BK, TURNS>;
  const auto kernel = probe_fwd_kernel<MODE, WG, BK, TURNS>;
  // Opt in to the dynamic shared memory, and count the CTAs an SM holds,
  // once per kernel and device.
  static int resident[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = dev < 16 ? resident[dev] : 0;
  if (per_sm == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, L::kThreads, L::kBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < 16) resident[dev] = per_sm;
  }
  const long long cols = static_cast<long long>(p.n_heads) * kD;
  const long long rows = static_cast<long long>(a.n_b) * p.tk;
  CUtensorMap mq, mk, mv;
  if (!make_map_2d(&mq, a.q, cols, rows, a.s_t * 2, 64 * WG) ||
      !make_map_2d(&mk, a.k, cols, rows, a.s_t * 2, BK) ||
      !make_map_2d(&mv, a.v, cols, rows, a.s_t * 2, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items =
      static_cast<long long>(p.tk / (64 * WG)) * p.n_bh;
  const long long ctas =
      std::min(items, static_cast<long long>(per_sm) * sm_count(dev));
  kernel<<<static_cast<unsigned>(ctas), L::kThreads, L::kBytes, stream>>>(
      mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int WG, int BK, bool TURNS>
int launch_mode(int mode, const Args& a, const Params& p, cudaStream_t s) {
  switch (mode) {
    case BASE:
      return launch<BASE, WG, BK, TURNS>(a, p, s);
    case NOMASK:
      return launch<NOMASK, WG, BK, TURNS>(a, p, s);
    case NOEXP:
      return launch<NOEXP, WG, BK, TURNS>(a, p, s);
    case BF16EXP:
      return launch<BF16EXP, WG, BK, TURNS>(a, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BK>
int launch_tile(int mode, int rows, int n_sub, const Args& a, const Params& p,
                cudaStream_t s) {
  if (rows == 64 && n_sub == 1) return launch_mode<1, BK, false>(mode, a, p, s);
  if (rows == 128 && n_sub == 1) {
    return launch_mode<2, BK, false>(mode, a, p, s);
  }
  if (rows == 128 && (n_sub == 2 || n_sub == 4)) {
    return launch_mode<2, BK, true>(mode, a, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: (batch * heads) x tk rows of 64 bf16, row r of head (b, h) at
// b * s_b + h * s_h + r * s_t (elements), laid out as one 2-D array of
// batch * tk rows of heads * 64 elements (s_b = tk * s_t; s_h = 64 where
// heads > 1). lse: null or [batch * heads, tk] f32. Schedules: (rows,
// n_sub) = (64, 1), (128, 1), (128, 2), (128, 4), every mode; K tiles of
// 128 rows, or 64 where n_sub = 4 or tk / n_kb is not a multiple of 128.
// The caller checks tk % rows == 0, tk % (64 * n_kb) == 0 and n_kb <= 4
// (ops/probe_fwd.py::plan and check_schedule).
extern "C" int nsp_probe_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int n_bh, int n_heads,
                                  int tk, int t_valid, int mode, int rows,
                                  int n_sub, int n_kb, int order,
                                  long long s_b, long long s_h, long long s_t,
                                  float scale, void* stream) {
  if (n_kb < 1 || n_kb > kMaxBlocks || tk % rows || tk % (64 * n_kb) ||
      s_b != static_cast<long long>(tk) * s_t || (n_heads > 1 && s_h != kD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, n_bh / n_heads, s_t};
  const Params p{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                 n_bh, n_heads, tk, t_valid, n_kb, order, s_b, s_h, s_t,
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sub == 4 || (tk / n_kb) % 128) {
    return launch_tile<64>(mode, rows, n_sub, a, p, s);
  }
  return launch_tile<128>(mode, rows, n_sub, a, p, s);
}
