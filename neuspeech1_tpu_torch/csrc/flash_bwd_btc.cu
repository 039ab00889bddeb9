// Flash-attention backward for Hopper (sm_90a) on [B, T, H, D] bf16 tensors.
//
// Replaces neuspeech1_tpu/ops/flash_attention.py::_bwd_kernel_btc, the Pallas
// TPU kernel behind the custom_vjp of flash_attention_bthd (K2), and the same
// kernel body with has_bias=True behind bwd_arrays_btc_bias (K4, ring
// attention). From q, k, v, the forward's o and lse [B, H, Tq] f32, and do,
// per (batch, head):
//   p     = exp(q k^T * scale - lse)              (masked entries 0)
//   dv    = bf16(p)^T do
//   delta = rowsum(do * o)                         (f32)
//   ds    = bf16(p * (do v^T - delta))
//   dq    = ds bf16(k * scale),   dk = ds^T bf16(q * scale)
// with f32 accumulation and one bf16 rounding of each output: the rounding
// points of the TPU kernel. Masks are the forward's: columns at or past
// kv_len, and above the diagonal when causal. K/V rows at or past kv_len get
// dk = dv = 0 exactly (the TPU kernel got this from padding; here the rows
// are zero-filled and written as zeros).
//
// What bounds it: the function needs five T x T x D products (s, dp, dv, dk,
// dq); at the training shape (B=64, T=1500, H=8, D=64) that is 7.4e11 FLOP,
// 0.75 ms at the bf16 tensor-core peak, against 0.79 GB of traffic (eight
// bf16 tensors read or written once, 0.23 ms): the tensor cores are the
// limit. Without atomics (the gradients
// must be the same bits run to run) dq and dk/dv are summed over different
// axes by different CTAs, so s and dp are computed twice: seven products,
// 1.03e12 FLOP at that shape.
//
// Design. Three launches, in order on the caller's stream:
//   1. delta = rowsum(do * o) in f32, D/8 threads per row, 16-byte loads.
//   2. dk/dv: one CTA of two warpgroups per 128 K/V rows, each warpgroup
//      owning 64 rows, with the K and V tile resident in shared memory. It
//      walks q in tiles of BQ rows (64; 32 at D=128, which bounds the
//      registers) that flow through a ring of q, do, lse and delta tiles.
//      Per tile and warpgroup:
//        s^T = K Q^T, dp^T = V dO^T      wgmma, A and B from shared memory
//        p^T = exp2(s^T...)              while dp^T runs
//        dv += bf16(p^T) dO               wgmma, A from registers, B = the do
//        ds^T = p^T (dp^T - delta)        tile read transposed (MN-major),
//        dk += bf16(ds^T) Q_s             while dv runs
//      dk and dv stay in f32 registers across the walk; their products run
//      on into the next tile's barrier and s^T, dp^T.
//   3. dq: one CTA of two warpgroups per 128 q rows (Q and dO resident),
//      walking K/V in 64-row tiles through the same kind of ring:
//        s = Q K^T, dp = dO V^T, p while dp runs, dq += bf16(ds) K_s.
// What this does about the mma.sync kernel it replaces (16% of peak):
//   - every product is an asynchronous wgmma.m64nNk16 from shared-memory
//     descriptors (s and dp issued together, the exp and ds formed while
//     the next product runs), where the old kernel issued mma.sync.m16n8k16;
//   - tiles are copied by cp.async into 128-byte (64-byte at D=32) swizzled
//     rows, the layout the descriptors name, through a ring of kStages = 4
//     (3 at D=128) tiles, two (one) copied ahead of the tile being
//     multiplied, one barrier per tile; the old kernel copied each tile
//     synchronously between two barriers;
//   - the scaled operands Q_s = bf16(q * scale) and K_s = bf16(k * scale)
//     are made once per tile, by the thread that copied each 16 bytes, into
//     a shadow tile of the ring, never inside the product loop (the old
//     kernel rebuilt them per fragment). At D=64 the scale is 2^-3:
//     bf16(x * 2^-3) = bf16(x) * 2^-3 exactly and a sum of terms each
//     scaled by 2^-3 is the same f32 sum scaled by 2^-3, so there the
//     kernels read q and k themselves and scale dk and dq once in the
//     epilogue (the same bits, barring f32 underflow below 2^-123);
//   - the masks are tested only on tiles that reach past t_q, kv_len or
//     the diagonal; the exp is MUFU ex2 (ftz);
//   - no atomics: the same inputs give the same bits.
// What still bounds it (perf/bwd_variants.py's ablations at the training
// shape): the dk/dv kernel, 60% of the time, where each warpgroup's chain
// s -> exp -> dv, dp -> ds -> dk is serial and two warpgroups per SM
// overlap it only in part; its exp alone is a sixth of it, while the dq
// kernel's exp is hidden.
// Dynamic shared memory (dk/dv; dq): 101 KB; 101 KB at D=64 (two dq CTAs
// per SM), 69 KB; 69 KB at D=32, 140 KB; 212 KB at D=128, opted in once
// per kernel and device. ptxas (sm_90a, CUDA 12.8): dk/dv 187, 154, 208
// registers at D=64, 32, 128; dq 122-128, 108-112, 162-166; no spills.
//
// K4 (HAS_BIAS): instead of the kv_len and causal masks an additive f32 bias
// row over the key axis enters p = exp(q k^T * scale + bias - lse), and a
// column whose bias is at or below -1e29 gets p = 0 exactly, as the forward
// keeps it out of the row max. lse and o are given: in ring attention they
// are the GLOBAL ones, merged over every key block, so p and delta carry the
// global normalisation and each block's dq, dk, dv are partial sums of the
// global gradients. The dk/dv kernel reads its two rows' bias once per
// thread; the dq kernel carries each K tile's bias in the ring beside the
// tile. The HAS_BIAS=false instantiations are K2.
//
// C entry points: nsp_flash_bwd_btc_bf16 (K2) and nsp_flash_bwd_btc_bias_bf16
// (K4), below. Each returns cudaGetLastError() after the launches; 0 means
// the kernels were queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups: the delta and dq kernels
// Two warpgroups of 64 K/V rows per dk/dv CTA: with three the registers
// (at most 168) no longer hold the products and ptxas serializes them.
constexpr int kDkdvWarpgroups = 2;
constexpr int kDkdvThreads = 128 * kDkdvWarpgroups;
constexpr int kBlockKV = 64 * kDkdvWarpgroups;  // K/V rows per dk/dv CTA
constexpr int kBlockQdq = 128; // q rows per CTA of the dq kernel
constexpr int kBlockKdq = 64;  // K/V rows per tile of the dq kernel
// The backward's tiles: the shared-memory layout (Swz, flash_sm90.cuh) and
// the q rows and ring stages of each kernel.
template <int D>
struct Cfg : Swz<D> {
  // q rows per tile of the dk/dv kernel
  static constexpr int kBlockQ = D == 128 ? 32 : 64;
  // Tiles in each ring, and how many are copied ahead of the one being
  // multiplied: the last stage is the previous tile, whose dv/dk (dq)
  // products may still be reading it while the next tile starts.
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kAhead = kStages - 2;
  // At D=64 scale = 2^-3: dk and dq are scaled in the epilogue (exactly the
  // same bits); otherwise the ring carries bf16(x * scale) tiles.
  static constexpr bool kScaleInEpilogue = D == 64;
};

struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float *lse, *bias;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int n_heads, t_q, t_kv, kv_len, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
};

// dst = bf16(src * scale) over the 16-byte chunks this thread copied into
// src with load_tile<D, ROWS, NT> (the same index map), so no barrier is
// needed between this thread's cp.async wait and the conversion.
template <int D, int ROWS, int NT = kThreads>
__device__ __forceinline__ void scale_tile(uint8_t* dst, const uint8_t* src,
                                           float scale) {
  constexpr int kC = Cfg<D>::kChunks;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kC; i += NT) {
    const uint32_t off = swz_offset<D, ROWS>(i / kC, i % kC);
    uint4 val = *reinterpret_cast<const uint4*>(src + off);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + off) = val;
  }
}

// Dynamic shared memory of the dk/dv kernel: K and V [kBlockKV, D], then
// kStages ring stages of q, do (and q_s) [BQ, D], lse and delta [BQ] f32.
template <int D>
struct DkdvSmem {
  static constexpr int kBQ = Cfg<D>::kBlockQ;
  static constexpr int kTileKV = kBlockKV * D * 2;
  static constexpr int kTileQ = kBQ * D * 2;
  static constexpr int kQs = Cfg<D>::kScaleInEpilogue ? 0 : 2 * kTileQ;
  static constexpr int kLse = (Cfg<D>::kScaleInEpilogue ? 2 : 3) * kTileQ;
  static constexpr int kStage = round_up_1k(kLse + 2 * kBQ * 4);
  static constexpr int kBytes = 2 * kTileKV + Cfg<D>::kStages * kStage + 1024;
};

// Dynamic shared memory of the dq kernel: q and do [kBlockQdq, D], then
// kStages ring stages of k, v (and k_s) [kBlockKdq, D] and the bias row.
template <int D>
struct DqSmem {
  static constexpr int kTileQ = kBlockQdq * D * 2;
  static constexpr int kTileK = kBlockKdq * D * 2;
  static constexpr int kKs = Cfg<D>::kScaleInEpilogue ? 0 : 2 * kTileK;
  static constexpr int kBias = (Cfg<D>::kScaleInEpilogue ? 2 : 3) * kTileK;
  static constexpr int kStage = round_up_1k(kBias + kBlockKdq * 4);
  static constexpr int kBytes = 2 * kTileQ + Cfg<D>::kStages * kStage + 1024;
};

static_assert(DqSmem<128>::kBytes <= 232448, "dq kernel over 227 KB");
static_assert(DkdvSmem<128>::kBytes <= 232448, "dk/dv kernel over 227 KB");

// ---------------------------------------------------------------------------
// 1. delta = rowsum(do * o) in f32: D/8 threads per row, 8 elements each.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Params p) {
  constexpr int kC = D / 8;
  constexpr int kRows = kThreads / kC;
  const int row = blockIdx.x * kRows + threadIdx.x / kC;
  const int c = threadIdx.x % kC;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  float acc = 0.f;
  if (row < p.t_q) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        p.o + batch * p.os.b + head * p.os.h + row * p.os.t + c * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        p.dout + batch * p.dos.b + head * p.dos.h + row * p.dos.t + c * 8);
    const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(oh[e]);
      const float2 b = __bfloat1622float2(dh[e]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
  }
#pragma unroll
  for (int off = kC / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < p.t_q && c == 0) {
    p.delta[(static_cast<long long>(batch) * p.n_heads + head) * p.t_q + row] =
        acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dk, dv: one CTA per kBlockKV K/V rows, walking the q tiles.
// ---------------------------------------------------------------------------
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<D>;
  using L = DkdvSmem<D>;
  constexpr int BQ = C::kBlockQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t k_s = base;
  const uint32_t v_s = base + L::kTileKV;
  const uint32_t ring = base + 2 * L::kTileKV;

  const int kv0 = blockIdx.x * kBlockKV;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int t_q = p.t_q;
  const int kv_len = p.kv_len;

  const __nv_bfloat16* q = p.q + batch * p.qs.b + head * p.qs.h;
  const __nv_bfloat16* dout = p.dout + batch * p.dos.b + head * p.dos.h;
  const long long stat0 =
      (static_cast<long long>(batch) * p.n_heads + head) * t_q;
  const float* lse = p.lse + stat0;
  const float* delta = p.delta + stat0;

  const int row_lo = kv0 + wg * 64 + warp * 16 + g;  // K/V rows of this thread
  const int row_hi = row_lo + 8;

  float dk_acc[D / 2];
  float dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);

  if (kv0 < kv_len) {
    // HAS_BIAS: this thread's two K rows' bias in log2 units, and whether
    // the row is kept at all
    float bb_lo = 0.f, bb_hi = 0.f;
    bool keep_lo = row_lo < kv_len, keep_hi = row_hi < kv_len;
    if constexpr (HAS_BIAS) {
      const float b_lo = keep_lo ? p.bias[row_lo] : 0.f;
      const float b_hi = keep_hi ? p.bias[row_hi] : 0.f;
      keep_lo = keep_lo && b_lo > kMaskedBias;
      keep_hi = keep_hi && b_hi > kMaskedBias;
      bb_lo = b_lo * kLog2e;
      bb_hi = b_hi * kLog2e;
    }

    auto load_stage = [&](int j, int s) {
      const uint32_t st = ring + s * L::kStage;
      const int q0 = j * BQ;
      load_tile<D, BQ, kDkdvThreads>(st, q, p.qs.t, q0, t_q);
      load_tile<D, BQ, kDkdvThreads>(st + L::kTileQ, dout, p.dos.t, q0, t_q);
      for (int i = threadIdx.x; i < BQ; i += kDkdvThreads) {
        const bool in = q0 + i < t_q;
        cp_async4(st + L::kLse + 4 * i, lse + (in ? q0 + i : 0), in);
        cp_async4(st + L::kLse + 4 * (BQ + i), delta + (in ? q0 + i : 0), in);
      }
    };

    load_tile<D, kBlockKV, kDkdvThreads>(
        k_s, p.k + batch * p.ks.b + head * p.ks.h, p.ks.t, kv0, kv_len);
    load_tile<D, kBlockKV, kDkdvThreads>(
        v_s, p.v + batch * p.vs.b + head * p.vs.h, p.vs.t, kv0, kv_len);
    // causal: q rows before kv0 see none of this CTA's columns
    const int j0 = p.causal ? kv0 / BQ : 0;
    const int n = (t_q + BQ - 1) / BQ - j0;
#pragma unroll
    for (int s = 0; s < C::kAhead; ++s) {
      if (s < n) load_stage(j0 + s, s);
      cp_async_commit();
    }

    const float scale_log2 = p.scale * kLog2e;
    for (int i = 0; i < n; ++i) {
      const int s = i % C::kStages;
      const int q0 = (j0 + i) * BQ;
      const uint32_t st = ring + s * L::kStage;
      uint8_t* st_ptr = sm + (st - base);
      cp_async_wait<C::kAhead - 1>();
      if constexpr (!C::kScaleInEpilogue) {
        scale_tile<D, BQ, kDkdvThreads>(st_ptr + L::kQs, st_ptr, p.scale);
      }
      fence_proxy_async();
      // tile i landed, and every warpgroup's products of tile i-2 are done
      __syncthreads();
      if (i + C::kAhead < n) {
        load_stage(j0 + i + C::kAhead, (i + C::kAhead) % C::kStages);
      }
      cp_async_commit();

      const float* lse_s = reinterpret_cast<const float*>(st_ptr + L::kLse);
      const float* delta_s = lse_s + BQ;
      // s^T = K Q^T and dp^T = V dO^T: this warpgroup's 64 K/V rows against
      // the tile's BQ q rows
      float sacc[BQ / 2];
      float dpacc[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ>(sacc, desc_k<D, kBlockKV>(k_s, wg * 64, kk),
                     desc_k<D, BQ>(st, 0, kk), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ>(dpacc, desc_k<D, kBlockKV>(v_s, wg * 64, kk),
                     desc_k<D, BQ>(st + L::kTileQ, 0, kk), kk);
      }
      wgmma_commit();
      // s^T is ready, and so are the previous tile's dv and dk products
      wgmma_wait<1>();
      fence_regs(sacc);
      // p^T = exp(s * scale - lse[col]), masked entries 0; the masks are
      // tested only on tiles that reach past t_q, kv_len or the diagonal
      auto exp_tile = [&](auto masked) {
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = nt * 8 + tg * 2 + (e & 1);  // q column in the tile
            const float lse_l2 = lse_s[cl] * kLog2e;
            float& x = sacc[4 * nt + e];
            if constexpr (HAS_BIAS) {
              const bool valid = (e < 2 ? keep_lo : keep_hi) &&
                                 (!decltype(masked)::value || q0 + cl < t_q);
              x = valid ? exp2_approx(x * scale_log2 +
                                      (e < 2 ? bb_lo : bb_hi) - lse_l2)
                        : 0.f;
            } else if constexpr (decltype(masked)::value) {
              const int row = e < 2 ? row_lo : row_hi;
              const bool valid = row < kv_len && q0 + cl < t_q &&
                                 (!p.causal || row <= q0 + cl);
              x = valid ? exp2_approx(x * scale_log2 - lse_l2) : 0.f;
            } else {
              x = exp2_approx(x * scale_log2 - lse_l2);
            }
          }
        }
      };
      const bool full = q0 + BQ <= t_q && kv0 + kBlockKV <= kv_len &&
                        (!p.causal || kv0 + kBlockKV - 1 <= q0);
      if (full) {
        exp_tile(std::false_type{});
      } else {
        exp_tile(std::true_type{});
      }
      // dv += bf16(p^T) do
      uint32_t pa[BQ / 16][4];
      pack_a<BQ>(pa, sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<D>(dv_acc, pa[kk], desc_mn<D, BQ>(st + L::kTileQ, kk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // dp^T is ready; dv runs on
      fence_regs(dpacc);
      // ds^T = p^T (dp^T - delta[col])
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + tg * 2 + (e & 1);
          float& x = dpacc[4 * nt + e];
          x = sacc[4 * nt + e] * (x - delta_s[cl]);
        }
      }
      // dk += bf16(ds^T) bf16(q * scale) (q itself when the epilogue scales)
      uint32_t da[BQ / 16][4];
      pack_a<BQ>(da, dpacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<D>(dk_acc, da[kk], desc_mn<D, BQ>(st + L::kQs, kk));
      }
      wgmma_commit();  // dv and dk run on into the next tile
    }
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
  }

  // Rows at or past kv_len are written as exact zeros.
  const float dk_scale = C::kScaleInEpilogue ? p.scale : 1.f;
  __nv_bfloat16* dk = p.dk + batch * p.dks.b + head * p.dks.h;
  __nv_bfloat16* dv = p.dv + batch * p.dvs.b + head * p.dvs.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (row_lo < p.t_kv) {
      const bool z = row_lo >= kv_len;
      *reinterpret_cast<uint32_t*>(dk + row_lo * p.dks.t + c) =
          z ? 0u : pack_f32x2(dk_acc[4 * nd] * dk_scale,
                              dk_acc[4 * nd + 1] * dk_scale);
      *reinterpret_cast<uint32_t*>(dv + row_lo * p.dvs.t + c) =
          z ? 0u : pack_f32x2(dv_acc[4 * nd], dv_acc[4 * nd + 1]);
    }
    if (row_hi < p.t_kv) {
      const bool z = row_hi >= kv_len;
      *reinterpret_cast<uint32_t*>(dk + row_hi * p.dks.t + c) =
          z ? 0u : pack_f32x2(dk_acc[4 * nd + 2] * dk_scale,
                              dk_acc[4 * nd + 3] * dk_scale);
      *reinterpret_cast<uint32_t*>(dv + row_hi * p.dvs.t + c) =
          z ? 0u : pack_f32x2(dv_acc[4 * nd + 2], dv_acc[4 * nd + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per kBlockQdq q rows, walking the K/V tiles. Two CTAs share
// an SM (at most 128 registers) except at D=128.
// ---------------------------------------------------------------------------
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<D>;
  using L = DqSmem<D>;
  constexpr int BK = kBlockKdq;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t q_s = base;
  const uint32_t do_s = base + L::kTileQ;
  const uint32_t ring = base + 2 * L::kTileQ;

  const int q0 = blockIdx.x * kBlockQdq;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int t_q = p.t_q;
  const int kv_len = p.kv_len;

  const __nv_bfloat16* k = p.k + batch * p.ks.b + head * p.ks.h;
  const __nv_bfloat16* v = p.v + batch * p.vs.b + head * p.vs.h;
  const long long stat0 =
      (static_cast<long long>(batch) * p.n_heads + head) * t_q;

  const int row_lo = q0 + wg * 64 + warp * 16 + g;  // q rows of this thread
  const int row_hi = row_lo + 8;
  const bool in_lo = row_lo < t_q;
  const bool in_hi = row_hi < t_q;
  // rows past t_q: lse = +inf makes their p exactly 0
  const float lse_lo = in_lo ? p.lse[stat0 + row_lo] * kLog2e : INFINITY;
  const float lse_hi = in_hi ? p.lse[stat0 + row_hi] * kLog2e : INFINITY;
  const float dl_lo = in_lo ? p.delta[stat0 + row_lo] : 0.f;
  const float dl_hi = in_hi ? p.delta[stat0 + row_hi] : 0.f;

  auto load_stage = [&](int j, int s) {
    const uint32_t st = ring + s * L::kStage;
    const int kv0 = j * BK;
    load_tile<D, BK, kThreads>(st, k, p.ks.t, kv0, kv_len);
    load_tile<D, BK, kThreads>(st + L::kTileK, v, p.vs.t, kv0, kv_len);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < BK; i += kThreads) {
        const bool in = kv0 + i < kv_len;
        cp_async4(st + L::kBias + 4 * i, p.bias + (in ? kv0 + i : 0), in);
      }
    }
  };

  load_tile<D, kBlockQdq, kThreads>(
      q_s, p.q + batch * p.qs.b + head * p.qs.h, p.qs.t, q0, t_q);
  load_tile<D, kBlockQdq, kThreads>(
      do_s, p.dout + batch * p.dos.b + head * p.dos.h, p.dos.t, q0, t_q);
  int n = (kv_len + BK - 1) / BK;
  if (p.causal) {
    const int last_row = min(q0 + kBlockQdq, t_q) - 1;
    n = min(n, last_row / BK + 1);
  }
#pragma unroll
  for (int s = 0; s < C::kAhead; ++s) {
    if (s < n) load_stage(s, s);
    cp_async_commit();
  }

  float dq_acc[D / 2];
  zero(dq_acc);
  const float scale_log2 = p.scale * kLog2e;
  for (int j = 0; j < n; ++j) {
    const int s = j % C::kStages;
    const int kv0 = j * BK;
    const uint32_t st = ring + s * L::kStage;
    uint8_t* st_ptr = sm + (st - base);
    cp_async_wait<C::kAhead - 1>();
    if constexpr (!C::kScaleInEpilogue) {
      scale_tile<D, BK>(st_ptr + L::kKs, st_ptr, p.scale);
    }
    fence_proxy_async();
    // tile j landed, and every warpgroup's dq product of tile j-2 is done
    __syncthreads();
    if (j + C::kAhead < n) {
      load_stage(j + C::kAhead, (j + C::kAhead) % C::kStages);
    }
    cp_async_commit();

    // s = Q K^T and dp = dO V^T: this warpgroup's 64 q rows, BK columns
    float sacc[BK / 2];
    float dpacc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BK>(sacc, desc_k<D, kBlockQdq>(q_s, wg * 64, kk),
                   desc_k<D, BK>(st, 0, kk), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BK>(dpacc, desc_k<D, kBlockQdq>(do_s, wg * 64, kk),
                   desc_k<D, BK>(st + L::kTileK, 0, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // s is ready
    fence_regs(sacc);
    // p = exp(s * scale - lse), masked entries 0; the column masks are
    // tested only on tiles that reach past kv_len or the diagonal
    const float* bias_s = reinterpret_cast<const float*>(st_ptr + L::kBias);
    float pv[BK / 2];
    auto exp_tile = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = nt * 8 + tg * 2 + (e & 1);
          const int col = kv0 + cl;
          const float lse_r = e < 2 ? lse_lo : lse_hi;
          const float x = sacc[4 * nt + e];
          float& y = pv[4 * nt + e];
          if constexpr (HAS_BIAS) {
            const float b = bias_s[cl];
            const bool valid = (!decltype(masked)::value || col < kv_len) &&
                               b > kMaskedBias;
            y = valid ? exp2_approx(x * scale_log2 + b * kLog2e - lse_r) : 0.f;
          } else if constexpr (decltype(masked)::value) {
            const int row = e < 2 ? row_lo : row_hi;
            const bool valid = col < kv_len && (!p.causal || col <= row);
            y = valid ? exp2_approx(x * scale_log2 - lse_r) : 0.f;
          } else {
            y = exp2_approx(x * scale_log2 - lse_r);
          }
        }
      }
    };
    if (kv0 + BK <= kv_len && (!p.causal || kv0 + BK - 1 <= q0)) {
      exp_tile(std::false_type{});
    } else {
      exp_tile(std::true_type{});
    }
    wgmma_wait<0>();
    fence_regs(dpacc);
    // ds = p (dp - delta)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      dpacc[i] = pv[i] * (dpacc[i] - ((i & 2) ? dl_hi : dl_lo));
    }
    // dq += bf16(ds) bf16(k * scale) (k itself when the epilogue scales)
    uint32_t da[BK / 16][4];
    pack_a<BK>(da, dpacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<D>(dq_acc, da[kk], desc_mn<D, BK>(st + L::kKs, kk));
    }
    // Waited for here: letting it run into the next tile, as the dk/dv
    // kernel does, makes ptxas serialize this kernel's wgmmas (C7515).
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
  }

  const float dq_scale = C::kScaleInEpilogue ? p.scale : 1.f;
  __nv_bfloat16* dq = p.dq + batch * p.dqs.b + head * p.dqs.h;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (in_lo) {
      *reinterpret_cast<uint32_t*>(dq + row_lo * p.dqs.t + c) =
          pack_f32x2(dq_acc[4 * nd] * dq_scale, dq_acc[4 * nd + 1] * dq_scale);
    }
    if (in_hi) {
      *reinterpret_cast<uint32_t*>(dq + row_hi * p.dqs.t + c) =
          pack_f32x2(dq_acc[4 * nd + 2] * dq_scale,
                     dq_acc[4 * nd + 3] * dq_scale);
    }
  }
}

template <int D, bool HAS_BIAS>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kDeltaRows = kThreads / (D / 8);
  flash_bwd_delta_kernel<D><<<dim3((p.t_q + kDeltaRows - 1) / kDeltaRows,
                                   p.n_heads, batch),
                              kThreads, 0, stream>>>(p);
  // Opt in to the dynamic shared memory once per kernel and device.
  static bool opted[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16 || !opted[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, HAS_BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvSmem<D>::kBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, HAS_BIAS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DqSmem<D>::kBytes);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) opted[dev] = true;
  }
  flash_bwd_dkdv_kernel<D, HAS_BIAS>
      <<<dim3((p.t_kv + kBlockKV - 1) / kBlockKV, p.n_heads, batch),
         kDkdvThreads,
         DkdvSmem<D>::kBytes, stream>>>(p);
  flash_bwd_dq_kernel<D, HAS_BIAS>
      <<<dim3((p.t_q + kBlockQdq - 1) / kBlockQdq, p.n_heads, batch), kThreads,
         DqSmem<D>::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_BIAS>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, const void* bias, void* delta,
             void* dq, void* dk, void* dv, int batch, int n_heads, int t_q,
             int t_kv, int kv_len, int head_dim, int causal,
             const long long* strides, float scale, void* stream) {
  using bf = __nv_bfloat16;
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const Params p{static_cast<const bf*>(q), static_cast<const bf*>(k),
                 static_cast<const bf*>(v), static_cast<const bf*>(o),
                 static_cast<const bf*>(dout), static_cast<const float*>(lse),
                 static_cast<const float*>(bias), static_cast<float*>(delta),
                 static_cast<bf*>(dq), static_cast<bf*>(dk),
                 static_cast<bf*>(dv), n_heads, t_q, t_kv, kv_len, causal,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32, HAS_BIAS>(p, batch, s);
    case 64:
      return launch<64, HAS_BIAS>(p, batch, s);
    case 128:
      return launch<128, HAS_BIAS>(p, batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, do, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D], all bf16 with the
// head dimension contiguous and every row 16-byte aligned. lse: [B, H, Tq]
// f32 from the forward kernel; delta: [B, H, Tq] f32 scratch. strides: 24
// element strides, (batch, time, head) of q, k, v, o, do, dq, dk, dv in that
// order. The caller checks shapes and 1 <= kv_len <= Tk.
extern "C" int nsp_flash_bwd_btc_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int n_heads, int t_q, int t_kv, int kv_len,
    int head_dim, int causal, const long long* strides, float scale,
    void* stream) {
  return dispatch<false>(q, k, v, o, dout, lse, nullptr, delta, dq, dk, dv,
                         batch, n_heads, t_q, t_kv, kv_len, head_dim, causal,
                         strides, scale, stream);
}

// K4: as above with every key column kept (kv_len = Tk), no causal mask, and
// bias: [Tk] f32, contiguous. lse and o may be the global ones of a ring.
extern "C" int nsp_flash_bwd_btc_bias_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* bias, void* delta,
    void* dq, void* dk, void* dv, int batch, int n_heads, int t_q, int t_kv,
    int head_dim, const long long* strides, float scale, void* stream) {
  return dispatch<true>(q, k, v, o, dout, lse, bias, delta, dq, dk, dv, batch,
                        n_heads, t_q, t_kv, t_kv, head_dim, 0, strides, scale,
                        stream);
}
