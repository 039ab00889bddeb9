// Grouped GEMM of a mixture-of-experts layer for Hopper (sm_90a): the rows
// of x, sorted by expert, times their expert's weight,
//   y[r] = x[r] @ W[e]     (W [E, K, N], the forward)       or
//   y[r] = x[r] @ W[e]^T   (W [E, N, K], the input gradient)
// for offs[e] <= r < offs[e + 1]; bf16 in, f32 accumulation, bf16 out.
//
// Replaces no TPU kernel: the JAX package has no expert layer. It runs the
// routed experts of models/moe_lm.py, whose gate-up (2048 -> 2816) and down
// (1408 -> 2048) products over ~96,600 routed rows a layer are most of the
// language-model step's operations.
//
// What bounds it: at ~1,500 rows an expert every product does about 1,000
// operations per byte of weight and activation it reads once, well past the
// H100's ~295: it is bound by the tensor cores.
//
// Design: csrc/probe_dot.cu's persistent TMA-ring wgmma pipeline (128 x 256
// output tiles, 64-deep stages, a ring of 3, a producer warpgroup with one
// TMA thread and two consumer warpgroups of 64 rows), with the work list
// read from the expert row offsets on the device, so the host never learns
// the routing. Each CTA reads offs into shared memory and counts each
// expert's 128-row tiles (an empty expert has none); a work item is one
// (expert, n-tile, m-tile), experts in order and the m-tiles of one n-tile
// consecutive, so the CTAs in flight share the expert's weight panel in L2.
// A tile's rows start at the expert's first row and may run past its last:
// TMA reads the next expert's rows (or zeros past the array's end) and the
// epilogue writes only the expert's own rows and the columns below N, from
// a swizzled staging buffer, 16 bytes a thread. In the forward W[e] is read
// N-major as four [64, 64] boxes a stage (wgmma's B transposed); in the
// input gradient W[e] is [N, K], K-major, read as one [256, 64] box. Where
// N % 256 == 128 the last n-tile skips its second 128 columns. No atomics:
// the same inputs give the same bits.
//
// C entry point: nsp_moe_grouped_gemm_bf16, below. Returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 384;  // two consumer warpgroups and a producer one
constexpr int kMaxExperts = 256;
constexpr int kTileA = kBM * kBK * 2;  // [128, 64]
constexpr int kTileB = kBK * kBN * 2;  // four [64, 64] boxes or one [256, 64]
constexpr int kStage = kTileA + kTileB;
constexpr int kOut = 64 * kBN * 2;     // one warpgroup's [64, 256]
constexpr int kBars = kStages * kStage + 2 * kOut;
constexpr int kTable = kBars + 16 * kStages;  // offs and tile starts
constexpr int kBytes = kTable + 2 * 4 * (kMaxExperts + 1) + 1024;
static_assert(kBytes <= 232448, "over 227 KB");
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// wgmma.m64n128k16 bf16 -> f32, A K-major and B MN-major (transposed), both
// from shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// kTransB false: W is [E, K, N] (map: [E K rows, N columns], [64, 64]
// boxes); true: W is [E, N, K] (map: [E N rows, K columns], [256, 64]
// boxes).
template <bool kTransB>
__global__ void __launch_bounds__(kThreads, 1)
moe_grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_w,
                        const int* __restrict__ offs,
                        __nv_bfloat16* __restrict__ y, int n, int k,
                        int experts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t ring = base;
  const uint32_t out = base + kStages * kStage;  // + kOut wg
  const uint32_t full_bar = base + kBars;        // + 8 s
  const uint32_t empty_bar = full_bar + 8 * kStages;
  int* offs_s = reinterpret_cast<int*>(sm + kTable);  // [experts + 1]
  int* tiles_s = offs_s + kMaxExperts + 1;  // m-tiles before expert e

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int n_nt = (n + kBN - 1) / kBN;
  const int n_k = k / kBK;

  for (int e = threadIdx.x; e <= experts; e += blockDim.x) {
    offs_s[e] = offs[e];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int e = 0; e < experts; ++e) {
      tiles_s[e] = t;
      t += (offs_s[e + 1] - offs_s[e] + kBM - 1) / kBM;
    }
    tiles_s[experts] = t;
    // a stage: filled by the producer, emptied by each consumer warp once
    // its products on it are done
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_items = tiles_s[experts] * n_nt;

  // Work item w: expert e (the last whose first item is at or before w:
  // never an empty one), then n-tile, then m-tile (fastest).
  auto item = [&](int w, int& e, int& row0, int& n0) {
    int lo = 0, hi = experts - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tiles_s[mid] * n_nt <= w) lo = mid; else hi = mid - 1;
    }
    e = lo;
    const int tiles = tiles_s[e + 1] - tiles_s[e];
    const int j = w - tiles_s[e] * n_nt;
    n0 = (j / tiles) * kBN;
    row0 = offs_s[e] + (j % tiles) * kBM;
  };
  auto stage_of = [&](int c) { return ring + (c % kStages) * kStage; };

  if (wg == 2) {
    // The producer: the k-stages of every item of this CTA, in order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 256) return;
    int c = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      int e, row0, n0;
      item(w, e, row0, n0);
      for (int kt = 0; kt < n_k; ++kt, ++c) {
        const int s = c % kStages;
        const uint32_t st = stage_of(c);
        mbar_wait(empty_bar + 8 * s, ((c / kStages) & 1) ^ 1);
        mbar_arrive_tx(full_bar + 8 * s, kStage);
        tma_load_2d(st, &map_x, full_bar + 8 * s, kt * kBK, row0);
        if (kTransB) {
          tma_load_2d(st + kTileA, &map_w, full_bar + 8 * s, kt * kBK,
                      e * n + n0);
        } else {
#pragma unroll
          for (int a = 0; a < kBN / 64; ++a) {
            tma_load_2d(st + kTileA + a * 64 * 128, &map_w, full_bar + 8 * s,
                        n0 + a * 64, e * k + kt * kBK);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int g8 = lane >> 2;
  const int tg = lane & 3;
  const int wt = threadIdx.x & 127;  // thread of the warpgroup
  const uint32_t my_out = out + wg * kOut;
  uint8_t* my_out_ptr = sm + (my_out - base);
  float acc0[64], acc1[64];  // columns [0, 128) and [128, 256)

  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty_bar + 8 * (c % kStages));
  };
  // This warpgroup's 64 rows of the tile's products over stage c; the
  // second 128 columns only where they lie below N.
  auto issue = [&](int c, bool first, bool second) {
    const uint32_t st = stage_of(c);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_k<64, kBM>(st, wg * 64, kk);
      const int scale_d = first && kk == 0 ? 0 : 1;
      if (kTransB) {
        wgmma_ss<128>(acc0, da, desc_k<64, kBN>(st + kTileA, 0, kk), scale_d);
        if (second) {
          wgmma_ss<128>(acc1, da, desc_k<64, kBN>(st + kTileA, 128, kk),
                        scale_d);
        }
      } else {
        // B: two atoms of 64 columns per 128, 64 k rows each
        wgmma_ss_tb(acc0, da, desc_mn<128, kBK>(st + kTileA, kk), scale_d);
        if (second) {
          wgmma_ss_tb(acc1, da,
                      desc_mn<128, kBK>(st + kTileA + 2 * 64 * 128, kk),
                      scale_d);
        }
      }
    }
    wgmma_commit();
  };
  // One accumulator's [64, 128] into the staging buffer, columns from
  // col0: the 16-byte chunk of (row r, column c) of the [64, 64] box c / 64
  // sits at chunk (c % 64) / 8 ^ r % 8 of the box's row r.
  auto stage_out = [&](const float(&d)[64], int col0) {
    const int r_lo = warp * 16 + g8;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int col = col0 + nt * 8;
      const int box = col / 64;
      const int chunk = (col % 64) / 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + 8 * h;
        const uint32_t off = box * 64 * 128 + r * 128 +
                             ((chunk ^ (r & 7)) << 4) + tg * 4;
        *reinterpret_cast<uint32_t*>(my_out_ptr + off) =
            pack_f32x2(d[4 * nt + 2 * h], d[4 * nt + 2 * h + 1]);
      }
    }
  };

  int c = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    int e, row0, n0;
    item(w, e, row0, n0);
    const bool second = n0 + 128 < n;
    for (int kt = 0; kt < n_k; ++kt, ++c) {
      mbar_wait(full_bar + 8 * (c % kStages), (c / kStages) & 1);
      wgmma_fence();
      issue(c, kt == 0, second);
      if (kt > 0) {
        wgmma_wait<1>();
        release(c - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    release(c - 1);

    // The epilogue: stage the tile, then write the expert's rows below N,
    // 16 bytes a thread; the barriers keep the staging buffer whole
    // between the writes of one tile and the reads of the next.
    bar_sync(1 + wg, 128);
    stage_out(acc0, 0);
    stage_out(acc1, 128);
    bar_sync(1 + wg, 128);
    const int r0 = row0 + wg * 64;
    const int row_end = offs_s[e + 1];
#pragma unroll 4
    for (int i = wt; i < 64 * (kBN / 8); i += 128) {
      const int r = i / (kBN / 8);
      const int chunk = i % (kBN / 8);
      const int col = n0 + chunk * 8;
      if (r0 + r < row_end && col < n) {
        const int box = chunk / 8;
        const uint4 v = *reinterpret_cast<const uint4*>(
            my_out_ptr + box * 64 * 128 + r * 128 +
            (((chunk % 8) ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>(y + static_cast<long long>(r0 + r) * n +
                                  col) = v;
      }
    }
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

template <bool kTransB>
cudaError_t opt_in(int dev) {
  static bool opted[16] = {};
  if (dev < 16 && opted[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_grouped_gemm_kernel<kTransB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err == cudaSuccess && dev < 16) opted[dev] = true;
  return err;
}

}  // namespace

// x: [rows, k] bf16, rows sorted by expert; offs: int32 [experts + 1] on the
// device, offs[0] = 0, non-decreasing, offs[experts] = rows; w: bf16 [experts,
// k, n] (trans 0) or [experts, n, k] (trans 1); y: [rows, n] bf16. All
// contiguous; k a multiple of 64, n of 128, 1 <= experts <= 256, rows > 0
// (checked by the caller, ops/moe_gemm.py::check_shapes). As many persistent
// CTAs as the SMs, or as many as the tiles can need if fewer.
extern "C" int nsp_moe_grouped_gemm_bf16(const void* x, const void* w,
                                         const void* offs, void* y, int rows,
                                         int k, int n, int experts, int trans,
                                         void* stream) {
  if (k % kBK || k < kBK || n % 128 || experts < 1 ||
      experts > kMaxExperts || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = trans ? opt_in<true>(dev) : opt_in<false>(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mw;
  const long long w_rows = static_cast<long long>(experts) * (trans ? n : k);
  const int w_cols = trans ? k : n;
  if (!make_map_2d(&mx, x, k, rows, 2LL * k, kBM) ||
      !make_map_2d(&mw, w, w_cols, w_rows, 2LL * w_cols, trans ? kBN : kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // at most one partial m-tile per expert beyond the rows' own
  const long long tiles =
      (static_cast<long long>(rows) / kBM + experts) * ((n + kBN - 1) / kBN);
  const long long ctas = std::min(tiles, static_cast<long long>(sm_count(dev)));
  const auto s = static_cast<cudaStream_t>(stream);
  if (trans) {
    moe_grouped_gemm_kernel<true><<<static_cast<unsigned>(ctas), kThreads,
                                    kBytes, s>>>(
        mx, mw, static_cast<const int*>(offs),
        static_cast<__nv_bfloat16*>(y), n, k, experts);
  } else {
    moe_grouped_gemm_kernel<false><<<static_cast<unsigned>(ctas), kThreads,
                                     kBytes, s>>>(
        mx, mw, static_cast<const int*>(offs),
        static_cast<__nv_bfloat16*>(y), n, k, experts);
  }
  return static_cast<int>(cudaGetLastError());
}
