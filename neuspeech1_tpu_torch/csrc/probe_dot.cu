// Batched dot probe for Hopper (sm_90a): c[g] = a[g] @ b[g], bf16 in, f32
// accumulation, bf16 out.
//
// Replaces the Pallas TPU matrix-unit rate probe perf/mxu_probe.py::make_dot
// (P-dot): per grid step one [512, K] @ [K, 1536] product, K in 64..512.
//
// What bounds it: at n = 256, M = 512, N = 1536 the bf16 output alone is
// 403 MB, so every K of the probe is bytes-bound on the H100 (0.140 ms at
// K = 64 and 0.280 ms at K = 512 against 0.026 and 0.208 ms of products).
// The TPU question, whether a K = 64 contraction streams at the full matrix
// rate, cannot be asked at this shape here; the probe times it as it is.
//
// Design. The old kernel (mma.sync, B fragments packed from two 2-byte
// shared loads, a synchronous unpipelined K loop with two barriers a
// 32-wide step, 4-byte output stores eight rows apart, no overlap of a
// tile's epilogue with anything: 2.03 ms at K = 512) is replaced by the
// Hopper GEMM shape. Persistent CTAs, one an SM (214 KB of shared memory),
// walk 128 x 256 output tiles with the 4 m-tiles of one (batch, n-tile)
// consecutive, so that the CTAs in flight read each B panel from L2 (and
// each batch entry's A, 512 x K, stays there across its 6 n-tiles). A
// producer warp's one thread issues TMA loads of A [128, 64] and B [64,
// 256] (four [64, 64] boxes), 128-byte swizzled, into a ring of 3 stages
// counted on mbarriers; the ring runs on across tile boundaries, so at
// K = 64, where a tile is one stage, the next tiles' loads run under this
// tile's epilogue. Two consumer warpgroups of 64 rows each run
// wgmma.m64n128k16 twice per 16-deep slice (the 256 columns), A K-major and
// B read MN-major from its swizzled boxes (b is N-contiguous), keeping one
// stage's products in flight while releasing the one before. The epilogue
// rounds to bf16 into a swizzled [64, 256] staging buffer per warpgroup
// and writes it with four TMA stores in one bulk group; the buffer is
// reused once that group has been read (cp.async.bulk.wait_group.read), a
// tile later. Tile 128 x 256 x 64 by the shared-memory budget: 3 stages of
// 48 KB and 64 KB of staging. No atomics: the same inputs give the same
// bits.
//
// C entry point: nsp_probe_dot_bf16, below. Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 384;  // two consumer warpgroups and a producer one
constexpr int kTileA = kBM * kBK * 2;           // [128, 64]
constexpr int kTileB = kBK * kBN * 2;           // four [64, 64] boxes
constexpr int kStage = kTileA + kTileB;
constexpr int kOut = 64 * kBN * 2;              // one warpgroup's [64, 256]
constexpr int kBars = kStages * kStage + 2 * kOut;
constexpr int kBytes = kBars + 16 * kStages + 1024;
static_assert(kBytes <= 232448, "over 227 KB");
// Registers per thread after setmaxnreg: 128 x 40 + 256 x 232 = 64512.
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

__global__ void __launch_bounds__(kThreads, 1)
probe_dot_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_c, int batch, int m,
                 int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm;
  const uint32_t base = smem_base(smem_raw, &sm);
  const uint32_t ring = base;
  const uint32_t out = base + kStages * kStage;  // + kOut wg
  const uint32_t full_bar = base + kBars;        // + 8 s
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int n_mt = m / kBM;
  const int per_batch = n_mt * (n / kBN);
  const int n_items = batch * per_batch;
  const int n_k = k / kBK;
  // Work item w: batch entry g, then n-tile, then m-tile (fastest).
  auto item = [&](int w, int& g, int& m0, int& n0) {
    g = w / per_batch;
    const int r = w % per_batch;
    n0 = (r / n_mt) * kBN;
    m0 = (r % n_mt) * kBM;
  };
  auto stage_of = [&](int c) { return ring + (c % kStages) * kStage; };

  if (threadIdx.x == 0) {
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

  if (wg == 2) {
    // The producer: the k-stages of every item of this CTA, in order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x != 256) return;
    int c = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      int g, m0, n0;
      item(w, g, m0, n0);
      for (int kt = 0; kt < n_k; ++kt, ++c) {
        const int s = c % kStages;
        const uint32_t st = stage_of(c);
        mbar_wait(empty_bar + 8 * s, ((c / kStages) & 1) ^ 1);
        mbar_arrive_tx(full_bar + 8 * s, kStage);
        tma_load_2d(st, &map_a, full_bar + 8 * s, kt * kBK, g * m + m0);
#pragma unroll
        for (int a = 0; a < kBN / 64; ++a) {
          tma_load_2d(st + kTileA + a * 64 * 128, &map_b, full_bar + 8 * s,
                      n0 + a * 64, g * k + kt * kBK);
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
  // This warpgroup's 64 rows of the tile's products over stage c.
  auto issue = [&](int c, bool first) {
    const uint32_t st = stage_of(c);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = desc_k<64, kBM>(st, wg * 64, kk);
      const int scale_d = first && kk == 0 ? 0 : 1;
      // B: two atoms of 64 columns per 128, 64 k rows each
      wgmma_ss_tb(acc0, da, desc_mn<128, kBK>(st + kTileA, kk), scale_d);
      wgmma_ss_tb(acc1, da, desc_mn<128, kBK>(st + kTileA + 2 * 64 * 128, kk),
                  scale_d);
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
    int g, m0, n0;
    item(w, g, m0, n0);
    for (int kt = 0; kt < n_k; ++kt, ++c) {
      mbar_wait(full_bar + 8 * (c % kStages), (c / kStages) & 1);
      wgmma_fence();
      issue(c, kt == 0);
      if (kt > 0) {
        wgmma_wait<1>();
        release(c - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    release(c - 1);

    // The epilogue: the staging buffer is free once the previous tile's
    // stores have read it.
    if (wt == 0) bulk_wait_read<0>();
    bar_sync(1 + wg, 128);
    stage_out(acc0, 0);
    stage_out(acc1, 128);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (wt == 0) {
#pragma unroll
      for (int box = 0; box < kBN / 64; ++box) {
        tma_store_2d(&map_c, my_out + box * 64 * 128, n0 + box * 64,
                     g * m + m0 + wg * 64);
      }
      bulk_commit();
    }
  }
  if (wt == 0) bulk_wait<0>();
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

}  // namespace

// a: [batch, m, k], b: [batch, k, n], c: [batch, m, n], bf16, contiguous;
// m a multiple of 128, n of 256, k of 64 (checked by the caller,
// ops/probe_dot.py::plan). As many persistent CTAs as the SMs, or one per
// output tile if fewer.
extern "C" int nsp_probe_dot_bf16(const void* a, const void* b, void* c,
                                  int batch, int m, int n, int k,
                                  void* stream) {
  if (m % kBM || n % kBN || k % kBK || k < kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 16 || !opted[dev]) {
    err = cudaFuncSetAttribute(probe_dot_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 16) opted[dev] = true;
  }
  const long long rows_a = static_cast<long long>(batch) * m;
  const long long rows_b = static_cast<long long>(batch) * k;
  CUtensorMap ma, mb, mc;
  if (!make_map_2d(&ma, a, k, rows_a, 2LL * k, kBM) ||
      !make_map_2d(&mb, b, n, rows_b, 2LL * n, kBK) ||
      !make_map_2d(&mc, c, n, rows_a, 2LL * n, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items =
      static_cast<long long>(batch) * (m / kBM) * (n / kBN);
  const long long ctas = std::min(items, static_cast<long long>(sm_count(dev)));
  probe_dot_kernel<<<static_cast<unsigned>(ctas), kThreads, kBytes,
                     static_cast<cudaStream_t>(stream)>>>(ma, mb, mc, batch,
                                                          m, n, k);
  return static_cast<int>(cudaGetLastError());
}
