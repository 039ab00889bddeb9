// Attention backward probe from a given lse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU tuning probes of the flash backward (P-bwd):
//   perf/bwd_probe.py::make_bwd (bf16 or f32 dot operands) and
//   perf/btc_probe.py::make_bwd_btc ([B, T, H*D] layout, f32 operands).
// Per (batch*head), from bf16 q, k, v, o, do [TK, 64] and a GIVEN f32 lse
// [TK] (the probes feed lse ~ N(8, 0.1^2), so p is not normalised):
//   s     = q k^T * D^-1/2, columns >= t_valid set to -1e30
//   p     = exp(s - lse)                       (f32; masked columns 0)
//   dv    = p^T do,  dp = do v^T,  delta = rowsum(do * o)
//   ds    = p (dp - delta) * D^-1/2
//   dq    = ds k,    dk = ds^T q               (all rows of q contribute)
// OPS = bf16: p and ds rounded to bf16 before their products. OPS = f32:
// every product on f32 operands, the precision of the TPU's multi-pass f32
// dot; no TF32. f32 accumulation; dq, dk, dv rounded to bf16 once.
//
// What bounds it: at B*H = 512, TK = 1536 (1500 kept), D = 64 the five
// products are 755 GFLOP, 0.763 ms at the bf16 tensor-core rate (989
// TFLOP/s); bytes (six [TK, 64] bf16 arrays and lse) are ~0.1 ms. The f32
// mode runs on the same tensor cores (below): 11 bf16 passes, 1.679 ms.
//
// f32 operands as exact bf16 splits. q, k, v, o, do are bf16, so the
// products s = q k^T and dp = do v^T are exact in one bf16 pass. p and ds
// are f32: each is split into three bf16 terms, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x exactly (24 bits of
// significand in three 8-bit pieces; p ~ 3e-4 leaves lo ~ 5e-9, a normal
// bf16). dv, dk and dq take three passes (hi, mid, lo) into one f32
// accumulator, each pass's products exact. The bf16 mode is the same
// pipeline with the passes cut to hi: its bf16(p) and bf16(ds) are hi.
// TF32 wgmma would keep 10 bits, and needs both operands K-major.
//
// Design: three launches, no atomics (the same inputs give the same bits).
//   1. delta = rowsum(do * o) in f32, eight threads a row, 16-byte loads.
//   2. dk/dv and 3. dq: one persistent, warp-specialized kernel template
//      (probe_bwd_kernel<DKDV, BN, F32>). A CTA is two consumer warpgroups
//      and a producer warpgroup (setmaxnreg moves registers from the
//      producer to the consumers). A work item is 128 RESIDENT rows of one
//      head, 64 per consumer warpgroup, held in shared memory while the
//      item walks the head's STREAMED rows in tiles of BN:
//        dk/dv: resident K, V rows; streamed q, do tiles (BN = R = 64 or
//               32) with their lse and delta;
//          s^T = K Q^T, dp^T = V dO^T          wgmma, both from shared
//          p^T = exp(s^T * scale - lse[col])   (K rows >= t_valid: 0)
//          dv += p^T dO                         wgmma, A from registers,
//          ds^T = p^T (dp^T - delta[col])       B = the tile read MN-major
//          dk += ds^T Q
//        dq: resident q, do rows (their lse and delta in registers);
//            streamed K, V tiles of 64 rows up to t_valid;
//          s = Q K^T, dp = dO V^T, p (columns >= t_valid: 0), ds,
//          dq += ds K.
//      The producer's one thread issues TMA copies into 128-byte swizzled
//      shared memory, counted on mbarriers: the resident pair into one of
//      two buffers (the next item's loads run under this item's last
//      tiles), the streamed pair (and, for dk/dv, lse and delta by bulk
//      copy) into a ring of stages that the consumers release tile by tile.
//      The two consumer warpgroups take turns issuing each tile's scores
//      (named barriers), so that one's exponentials and ds overlap the
//      other's products; within a warpgroup dp's product runs under the
//      exponentials, and the dk (dq) products run on into the next tile's
//      scores. The D^-1/2 = 2^-3 of ds moves to the epilogue of dk and dq
//      (the same bits: a power of two commutes with every rounding above
//      f32's underflow).
//   What bounds it (perf/probe_bwd_variants.py, at the probes' shape): not
//   the tensor cores alone (34% of the bf16 bound) and not MUFU's rate:
//   without exponentials the bf16 call takes 78% of the time, but a
//   quarter or half of them moved to the FMA pipe makes it slower; each
//   warpgroup's serial chain (scores, exponentials, dv, ds, dk) with two
//   warpgroups an SM. Turns on every product instead of the scores are
//   slower; free-running warpgroups lose 1-2% in f32.
//   dq is recomputed from s and dp in its own kernel (seven products, a
//   1.069 ms floor in bf16), not summed from the dk/dv items: that would
//   move every item's partial dq through an f32 workspace in a fixed order
//   (12 partials of each q row at this shape, 4.8 GB of reads and writes).
// Masks only where an item or tile reaches past t_valid. K/V rows at or
// past t_valid get dk = dv = 0 exactly. The exponential: bf16 mode MUFU
// ex2 on log2e-scaled scores; f32 mode expf(s - lse), as the plain version.
// R (rows = 64 or 32) is what the TPU's block_q maps to: the q rows of the
// dk/dv kernel's streamed tiles. The ring holds 512 streamed rows (8 or 16
// stages; 8 for dq): a ring of 384 rows, 6 stages at R = 64, was 8-10%
// slower in bf16 (perf/probe_bwd_variants.py ring_*), 256 rows 1-3%.
// Dynamic shared memory: dk/dv 201888 bytes (R 64) or 202016 (R 32), dq
// 197792; one CTA an SM. ptxas (CUDA 12.8): 168 registers at launch, the
// consumers' code under setmaxnreg's 232, no spills; in the f32 dk/dv
// instance at R = 64 ptxas serializes the wgmmas (C7512, too few
// registers for p, ds and three split fragments in flight).
//
// C entry point: nsp_probe_bwd, below. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for an instance that is not built).
// Card tests (the machine with the card has no JAX, so without the
// conftest): python -m pytest tests/test_torch_cuda_kernels.py
// --noconftest -q -k probe_bwd

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kRes = 128;       // resident rows of an item: two warpgroups
constexpr int kDqTile = 64;     // K/V rows of the dq kernel's streamed tiles
constexpr int kRingRows = 512;  // streamed rows the ring holds
constexpr int kThreads = 384;   // two consumer warpgroups, one producer
constexpr int kConsumerWarps = 8;

// Registers per thread after setmaxnreg, producer and consumers:
// 128 x 40 + 256 x 232 = 64512 of the SM's 65536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The dynamic shared memory of one instance: two resident buffers of two
// [128, 64] tiles, kStages ring stages of two [BN, 64] tiles, each stage's
// lse and delta rows (dk/dv), the mbarriers (two full and two empty for
// the resident buffers, one of each per stage) and 1 KB of alignment.
template <bool DKDV, int BN>
struct Sched {
  static constexpr int kTileRes = kRes * kD * 2;
  static constexpr int kTileN = BN * kD * 2;
  static constexpr int kStages = kRingRows / BN;
  static constexpr int kStage = 2 * kTileN;
  static constexpr int kStats = DKDV ? 2 * BN * 4 : 0;
  static constexpr int kStatsOff = 4 * kTileRes + kStages * kStage;
  static constexpr int kBars = kStatsOff + kStages * kStats;
  static constexpr int kBytes = kBars + 8 * (4 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over 227 KB");
};

struct Params {
  const float* lse;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int n_bh, n_heads, tk, t_valid;
  long long s_b, s_h, s_t;
  float scale;
};

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The f32 values of a packed bf16 pair's low and high halves.
__device__ __forceinline__ float bf16_lo(uint32_t h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t h) {
  return __uint_as_float(h & 0xffff0000u);
}

// The A fragments of P register-sourced passes over an accumulator tile of
// N columns (fragment kk: columns [16 kk, 16 kk + 16)): pass 0 holds
// bf16(x); with P = 3, passes 1 and 2 hold bf16 of what is left, so that
// hi + mid + lo = x exactly.
template <int P, int N>
__device__ __forceinline__ void split_a(uint32_t (&a)[P][N / 16][4],
                                        const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = d[8 * kk + 2 * r];
      float x1 = d[8 * kk + 2 * r + 1];
      const uint32_t hi = pack_f32x2(x0, x1);
      a[0][kk][r] = hi;
      if constexpr (P == 3) {
        x0 -= bf16_lo(hi);
        x1 -= bf16_hi(hi);
        const uint32_t mid = pack_f32x2(x0, x1);
        a[1][kk][r] = mid;
        a[2][kk][r] = pack_f32x2(x0 - bf16_lo(mid), x1 - bf16_hi(mid));
      }
    }
  }
}

// d += A B over the P passes of A (k = 16 kk): B is the [K, 64] tile at
// `b`, read MN-major (k its row, n the head dim).
template <int P, int K>
__device__ __forceinline__ void passes_rs(float (&d)[kD / 2],
                                          const uint32_t (&a)[P][K / 16][4],
                                          uint32_t b) {
#pragma unroll
  for (int t = 0; t < P; ++t) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wgmma_rs<kD>(d, a[t][kk], desc_mn<kD, K>(b, kk));
    }
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(do * o) in f32: eight threads a row, 8 elements each.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
delta_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout, float* delta,
             int n_heads, int tk, long long s_b, long long s_h,
             long long s_t) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;
  const int c = threadIdx.x % 8;
  const int bh = blockIdx.y;
  const long long off =
      (bh / n_heads) * s_b + (bh % n_heads) * s_h + row * s_t + c * 8;
  const uint4 ov = *reinterpret_cast<const uint4*>(o + off);
  const uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
  const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = __bfloat1622float2(oh[e]);
    const float2 b = __bfloat1622float2(dh[e]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
#pragma unroll
  for (int s = 4; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (c == 0) delta[static_cast<long long>(bh) * tk + row] = acc;
}

// ---------------------------------------------------------------------------
// 2. and 3.: DKDV = true, the dk/dv kernel (resident K and V, streamed q and
// do tiles of BN rows); false, the dq kernel (resident q and do, streamed K
// and V tiles of 64 rows). F32: three passes per product with p or ds.
// ---------------------------------------------------------------------------
template <bool DKDV, int BN, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
probe_bwd_kernel(const __grid_constant__ CUtensorMap map_r0,
                 const __grid_constant__ CUtensorMap map_r1,
                 const __grid_constant__ CUtensorMap map_n0,
                 const __grid_constant__ CUtensorMap map_n1, const Params p) {
  using L = Sched<DKDV, BN>;
  constexpr int S = L::kStages;
  constexpr int P = F32 ? 3 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t ring = base + 4 * L::kTileRes;
  const uint32_t stats = base + L::kStatsOff;
  const uint32_t res_full = base + L::kBars;       // + 8 b, b = 0, 1
  const uint32_t res_empty = res_full + 16;        // + 8 b
  const uint32_t full_bar = res_full + 32;         // + 8 s
  const uint32_t empty_bar = full_bar + 8 * S;     // + 8 s

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tk = p.tk;
  const int t_valid = p.t_valid;
  const int n_rb = tk / kRes;  // resident blocks of a head
  const int n_items = p.n_bh * n_rb;
  // streamed tiles of an item: every q tile (dk/dv); the K/V tiles that
  // hold a column below t_valid (dq)
  const int n_t = DKDV ? tk / BN : (t_valid + BN - 1) / BN;
  // A dk/dv item wholly at or past t_valid loads nothing: its rows are 0.
  auto loaded = [&](int r0) { return !DKDV || r0 < t_valid; };
  // Resident buffers are counted over the CTA's loaded items (use u in
  // buffer u % 2), streamed tiles over the CTA's items (tile c in stage
  // c % S).
  auto res_of = [&](int u) { return base + (u & 1) * 2 * L::kTileRes; };
  auto stage_of = [&](int c) { return ring + (c % S) * L::kStage; };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full + 8 * b, 1);
      mbar_init(res_empty + 8 * b, kConsumerWarps);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: per item, the resident pair once its buffer is free,
    // then the streamed tiles into the ring, each stage once both consumer
    // warpgroups have released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 256) return;
    int c = 0;
    int u = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int bh = w / n_rb;
      const int r0 = (w % n_rb) * kRes;
      if (!loaded(r0)) continue;
      // the head's box: its 64 columns of the rows of its batch entry
      const int col = (bh % p.n_heads) * kD;
      const int row = (bh / p.n_heads) * tk;
      const uint32_t rf = res_full + 8 * (u & 1);
      mbar_wait(res_empty + 8 * (u & 1), ((u >> 1) & 1) ^ 1);
      mbar_arrive_tx(rf, 2 * L::kTileRes);
      tma_load_2d(res_of(u), &map_r0, rf, col, row + r0);
      tma_load_2d(res_of(u) + L::kTileRes, &map_r1, rf, col, row + r0);
      ++u;
      for (int j = 0; j < n_t; ++j, ++c) {
        const int s = c % S;
        const uint32_t fb = full_bar + 8 * s;
        const uint32_t st = stage_of(c);
        mbar_wait(empty_bar + 8 * s, ((c / S) & 1) ^ 1);
        mbar_arrive_tx(fb, L::kStage + L::kStats);
        tma_load_2d(st, &map_n0, fb, col, row + j * BN);
        tma_load_2d(st + L::kTileN, &map_n1, fb, col, row + j * BN);
        if constexpr (DKDV) {
          const long long off = static_cast<long long>(bh) * tk + j * BN;
          const uint32_t sd = stats + s * L::kStats;
          bulk_load(sd, p.lse + off, BN * 4, fb);
          bulk_load(sd + BN * 4, p.delta + off, BN * 4, fb);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int g = lane >> 2;
  const int tg = lane & 3;
  const float scale = p.scale;
  const float scale_log2 = scale * kLog2e;
  float acc0[kD / 2];               // dk (dk/dv) or dq
  float acc1[DKDV ? kD / 2 : 2];    // dv
  float sacc[BN / 2];
  float dpacc[BN / 2];
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty_bar + 8 * (c % S));
  };
  // The two consumer warpgroups take turns issuing each tile's scores
  // (named barriers 1 and 2): warpgroup w issues after bar_sync(1 + w) and
  // hands the turn to the other by bar_arrive, so that the first's
  // exponentials start while the second's products run. The second opens
  // the first turn; the first closes the last one at the end.
  auto turn_begin = [&]() { bar_sync(1 + wg, 256); };
  auto turn_end = [&]() { bar_arrive(2 - wg, 256); };
  if (wg == 1) bar_arrive(1, 256);

  int c = 0;
  int u = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int bh = w / n_rb;
    const int r0 = (w % n_rb) * kRes;
    // this thread's two resident rows
    const int row_lo = r0 + wg * 64 + warp * 16 + g;
    const int row_hi = row_lo + 8;
    zero(acc0);
    zero(acc1);
    if (loaded(r0)) {
      // dq: the two rows' lse (log2 units in bf16 mode) and delta
      float lse_lo = 0.f, lse_hi = 0.f, dl_lo = 0.f, dl_hi = 0.f;
      if constexpr (!DKDV) {
        const long long st0 = static_cast<long long>(bh) * tk;
        const float m = F32 ? 1.f : kLog2e;
        lse_lo = p.lse[st0 + row_lo] * m;
        lse_hi = p.lse[st0 + row_hi] * m;
        dl_lo = p.delta[st0 + row_lo];
        dl_hi = p.delta[st0 + row_hi];
      }
      // dk/dv: K rows at or past t_valid (the item that reaches past it)
      const bool keep_lo = row_lo < t_valid;
      const bool keep_hi = row_hi < t_valid;
      const uint32_t rt = res_of(u);
      mbar_wait(res_full + 8 * (u & 1), (u >> 1) & 1);

      for (int j = 0; j < n_t; ++j, ++c) {
        const uint32_t st = stage_of(c);
        mbar_wait(full_bar + 8 * (c % S), (c / S) & 1);
        // s (s^T) and dp (dp^T): this warpgroup's 64 resident rows against
        // the tile's BN rows
        wgmma_fence();
        turn_begin();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          wgmma_ss<BN>(sacc, desc_k<kD, kRes>(rt, wg * 64, kk),
                       desc_k<kD, BN>(st, 0, kk), kk);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          wgmma_ss<BN>(dpacc, desc_k<kD, kRes>(rt + L::kTileRes, wg * 64, kk),
                       desc_k<kD, BN>(st + L::kTileN, 0, kk), kk);
        }
        wgmma_commit();
        turn_end();
        // s is ready, and so are the previous tile's products: its stage
        // is free
        wgmma_wait<1>();
        fence_regs(sacc);
        if (j > 0) release(c - 1);

        const float* lse_s = reinterpret_cast<const float*>(
            sm + (stats - base) + (c % S) * L::kStats);
        const float* delta_s = lse_s + BN;
        // p = exp(s * scale - lse), masked entries 0
        auto exp_tile = [&](auto masked) {
#pragma unroll
          for (int nt = 0; nt < BN / 8; ++nt) {
            float2 lc = make_float2(0.f, 0.f);
            if constexpr (DKDV) {
              lc = *reinterpret_cast<const float2*>(lse_s + nt * 8 + tg * 2);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float l;
              if constexpr (DKDV) {
                l = (e & 1) ? lc.y : lc.x;
              } else {
                l = e < 2 ? lse_lo : lse_hi;
              }
              float& x = sacc[4 * nt + e];
              float pr;
              if constexpr (F32) {
                pr = expf(x * scale - l);
              } else if constexpr (DKDV) {
                pr = exp2_approx(fmaf(x, scale_log2, -l * kLog2e));
              } else {
                pr = exp2_approx(fmaf(x, scale_log2, -l));
              }
              if constexpr (decltype(masked)::value) {
                bool keep;
                if constexpr (DKDV) {
                  keep = e < 2 ? keep_lo : keep_hi;
                } else {
                  keep = j * BN + nt * 8 + tg * 2 + (e & 1) < t_valid;
                }
                pr = keep ? pr : 0.f;
              }
              x = pr;
            }
          }
        };
        const bool masked = DKDV ? r0 + kRes > t_valid
                                 : (j + 1) * BN > t_valid;
        if (masked) {
          exp_tile(std::true_type{});
        } else {
          exp_tile(std::false_type{});
        }

        if constexpr (DKDV) {
          // dv += p^T dO (the do tile MN-major)
          uint32_t pa[P][BN / 16][4];
          split_a<P, BN>(pa, sacc);
          wgmma_fence();
          passes_rs<P, BN>(acc1, pa, st + L::kTileN);
          wgmma_commit();
          wgmma_wait<1>();  // dp^T is ready; dv runs on
        } else {
          wgmma_wait<0>();
        }
        fence_regs(dpacc);
        // ds = p (dp - delta), the 2^-3 left to the epilogue
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          float2 dc = make_float2(0.f, 0.f);
          if constexpr (DKDV) {
            dc = *reinterpret_cast<const float2*>(delta_s + nt * 8 + tg * 2);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dl;
            if constexpr (DKDV) {
              dl = (e & 1) ? dc.y : dc.x;
            } else {
              dl = e < 2 ? dl_lo : dl_hi;
            }
            float& x = dpacc[4 * nt + e];
            x = sacc[4 * nt + e] * (x - dl);
          }
        }
        if constexpr (DKDV && F32) {
          // dv's three passes done: their fragments' registers are free
          wgmma_wait<0>();
        }
        // dk += ds^T Q (the q tile MN-major); dq += ds K (the K tile)
        uint32_t da[P][BN / 16][4];
        split_a<P, BN>(da, dpacc);
        wgmma_fence();
        passes_rs<P, BN>(acc0, da, st);
        wgmma_commit();  // runs on into the next tile
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      release(c - 1);
      if (lane == 0) mbar_arrive(res_empty + 8 * (u & 1));
      ++u;
    }

    // The epilogue: dk and dq scaled by 2^-3; dk/dv rows at or past t_valid
    // written as exact zeros.
    const long long out = (bh / p.n_heads) * p.s_b + (bh % p.n_heads) * p.s_h;
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      const int col = nd * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row_hi : row_lo;
        const long long at = out + row * p.s_t + col;
        const float a0 = acc0[4 * nd + 2 * h] * scale;
        const float a1 = acc0[4 * nd + 2 * h + 1] * scale;
        if constexpr (DKDV) {
          const bool z = row >= t_valid;
          *reinterpret_cast<uint32_t*>(p.dk + at) =
              z ? 0u : pack_f32x2(a0, a1);
          *reinterpret_cast<uint32_t*>(p.dv + at) =
              z ? 0u
                : pack_f32x2(acc1[4 * nd + 2 * h], acc1[4 * nd + 2 * h + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(p.dq + at) = pack_f32x2(a0, a1);
        }
      }
    }
  }
  if (wg == 0) bar_sync(1, 256);
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

// The 2-D view every array shares: n_b * tk rows of n_heads * 64 elements.
struct View {
  long long cols, rows, row_bytes;
};

// One persistent CTA per SM (one fits), or one per item if fewer.
template <bool DKDV, int BN, bool F32>
int launch(const void* r0, const void* r1, const void* n0, const void* n1,
           const View& view, const Params& p, cudaStream_t stream) {
  using L = Sched<DKDV, BN>;
  const auto kernel = probe_bwd_kernel<DKDV, BN, F32>;
  // Opt in to the dynamic shared memory once per kernel and device.
  static bool opted[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16 || !opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) opted[dev] = true;
  }
  CUtensorMap m0, m1, m2, m3;
  if (!make_map_2d(&m0, r0, view.cols, view.rows, view.row_bytes, kRes) ||
      !make_map_2d(&m1, r1, view.cols, view.rows, view.row_bytes, kRes) ||
      !make_map_2d(&m2, n0, view.cols, view.rows, view.row_bytes, BN) ||
      !make_map_2d(&m3, n1, view.cols, view.rows, view.row_bytes, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(p.n_bh) * (p.tk / kRes);
  const long long ctas =
      std::min(items, static_cast<long long>(sm_count(dev)));
  kernel<<<static_cast<unsigned>(ctas), kThreads, L::kBytes, stream>>>(
      m0, m1, m2, m3, p);
  return static_cast<int>(cudaGetLastError());
}

template <int R, bool F32>
int launch_all(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const View& view, const Params& p,
               cudaStream_t stream) {
  delta_kernel<<<dim3(p.tk / 32, p.n_bh), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), p.delta, p.n_heads, p.tk,
      p.s_b, p.s_h, p.s_t);
  const int err = launch<true, R, F32>(k, v, q, dout, view, p, stream);
  if (err != 0) return err;
  return launch<false, kDqTile, F32>(q, dout, k, v, view, p, stream);
}

}  // namespace

// q, k, v, o, do, dq, dk, dv: (batch * heads) x tk rows of 64 bf16, row r of
// head (b, h) at b * s_b + h * s_h + r * s_t (elements), laid out as one 2-D
// array of batch * tk rows of heads * 64 elements (s_b = tk * s_t; s_h = 64
// where heads > 1; rows 16-byte aligned). lse: [batch * heads, tk] f32;
// delta: the same shape, f32 scratch. rows: 32 or 64; tk a multiple of 128;
// 1 <= t_valid <= tk (ops/probe_bwd.py::plan); f32_ops: 0 for bf16
// operands, 1 for f32.
extern "C" int nsp_probe_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             int n_bh, int n_heads, int tk, int t_valid,
                             int rows, int f32_ops, long long s_b,
                             long long s_h, long long s_t, float scale,
                             void* stream) {
  if (tk % kRes || t_valid < 1 || t_valid > tk ||
      s_b != static_cast<long long>(tk) * s_t ||
      (n_heads > 1 && s_h != kD)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using bf = __nv_bfloat16;
  const View view{static_cast<long long>(n_heads) * kD,
                  static_cast<long long>(n_bh / n_heads) * tk, s_t * 2};
  const Params p{static_cast<const float*>(lse), static_cast<float*>(delta),
                 static_cast<bf*>(dq), static_cast<bf*>(dk),
                 static_cast<bf*>(dv), n_bh, n_heads, tk, t_valid,
                 s_b, s_h, s_t, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 64) {
    return f32_ops ? launch_all<64, true>(q, k, v, o, dout, view, p, s)
                   : launch_all<64, false>(q, k, v, o, dout, view, p, s);
  }
  if (rows == 32) {
    return f32_ops ? launch_all<32, true>(q, k, v, o, dout, view, p, s)
                   : launch_all<32, false>(q, k, v, o, dout, view, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
