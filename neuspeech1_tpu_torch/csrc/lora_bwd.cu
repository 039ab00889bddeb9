// LoRA fc adapter backward for Hopper (sm_90a): the rank-r gradients of one
// adapted matmul y = x (W + s A B) from its activations, in bf16 with f32
// accumulation.
//
// Replaces neuspeech1_tpu/ops/lora_bwd.py::_kernel, the Pallas TPU kernel
// behind lora_adapter_bwd (caller models/lora.py::_folded_linear_bwd). For
// x [N, din], dy [N, dout], A [din, r], B [r, dout] bf16:
//   t1 = dy B^T, u = x A              [N, r]   f32
//   dA = x^T bf16(t1)                 [din, r] f32
//   dB = bf16(u)^T dy                 [r, dout] f32
//   dE = sum_n u * t1                 [r]      f32  (from the f32 t1, u)
// the TPU kernel's rounding points. r <= 64 is zero-padded to RP in {32,
// 64}, the wgmma width; any N is taken, the ragged last tile zero-filled.
//
// What bounds it: the narrow products do 4 N (din + dout) r FLOP against
// 2 N (din + dout) bytes of x and dy, 64 FLOP per byte at r = 32: below the
// card's ~295, so the bytes of x and dy are the limit (0.147 ms at the
// training step's fc1 and fc2, N = 96000, 512 <-> 2048, on an H100 SXM).
//
// Design: one pass over x and dy, as the TPU kernel, which kept the
// [din, r] and [r, dout] f32 sums resident while it walked the tokens. On
// Hopper no CTA holds them (327 KB of f32 at fc1), nor one 64-token tile of
// x and dy (327 KB of bf16), so:
// - x and dy are cut into panels of 64 columns (x's first, then dy's). A
//   thread-block cluster of `cluster` CTAs (the wrapper's plan:
//   ops/lora_bwd.py::plan) splits the panels, `pc` per CTA in order, and
//   walks a contiguous range of 64-token tiles; the grid is as many
//   clusters as the card holds at once.
// - Each CTA TMA-loads only its panels of each tile (128-byte swizzle, rows
//   past N zero-filled) into a ring of kStages tiles tracked by mbarriers:
//   every byte of x and dy is read from device memory once.
// - Its two warpgroups split the CTA's panels. Each forms partial t1 (over
//   its dy panels) and u (over its x panels) with wgmma, B^T and A^T slices
//   resident in shared memory; warpgroup 1's partial plus warpgroup 0's is
//   the CTA's.
// - The cluster sums the CTAs' partials through distributed shared memory
//   in rank order, in f32, before the bf16 rounding of t1 and u (a rounding
//   point of the TPU kernel): CTA c sums rows [c 64 / cluster, ...) of every
//   peer, adds their u t1 to its dE, writes the rows in bf16 into its own
//   shared memory; after a cluster barrier each CTA copies the other rows
//   from its peers.
// - dA[panel] += x_panel^T bf16(t1) and dB^T[panel] += dy_panel^T bf16(u)
//   on wgmma (A fragments by ldmatrix.trans from the tile, bf16(t1) or
//   bf16(u) as the shared-memory B operand), summed in registers across the
//   cluster's tiles.
// - Each cluster writes its sums to one partial buffer; a second launch sums
//   them over clusters in a fixed order. No atomics: the result has the same
//   bits on every run.
// Shapes past the plan (more than 80 panels at RP 32, 48 at RP 64: din +
// dout above 5120 or 3072) run the wide path below, the earlier three-stage
// design, which reads x and dy twice.
//
// C entry points: nsp_lora_bwd_bf16 and nsp_lora_bwd_wide_bf16 (below).
// Each returns the launches' cudaError_t; 0 means the kernels were queued.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTok = 64;      // tokens per tile: the wgmma M
constexpr int kCols = 64;     // columns of x or dy per panel
constexpr int kStages = 2;    // token tiles in flight per CTA
constexpr int kThreads = 256;  // two warpgroups
constexpr int kXPad = 4;      // floats past each row of the partial sums
constexpr int kMaxSmem = 232448;  // the H100's 227 KB per block
constexpr int kPanelBytes = kTok * kCols * 2;

// Panels a warpgroup holds sums for (registers: 16 or 32 per panel and
// thread); a CTA holds twice as many.
__host__ __device__ constexpr int per_warpgroup(int rp) {
  return rp == 32 ? 5 : 3;
}

// Bytes of dynamic shared memory for pc panels per CTA at width rp, in the
// order laid out below (ops/lora_bwd.py::smem_bytes computes the same; a CPU
// test holds the two together): the ring of tiles, the B^T and A^T slices
// [pc][rp][64] bf16, bf16(t1) and bf16(u) [64][rp], the partial t1 | u
// [64][2 rp + kXPad] f32, the mbarriers, and the base's alignment.
__host__ __device__ constexpr int smem_bytes(int pc, int rp) {
  return kStages * pc * kTok * kCols * 2 + pc * rp * kCols * 2 +
         2 * kTok * rp * 2 + kTok * (2 * rp + kXPad) * 4 + 64 + 1024;
}

template <int RP>
__global__ void __launch_bounds__(kThreads, 1)
lora_bwd_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_dy,
                const __nv_bfloat16* __restrict__ a,  // A [din, rank]
                const __nv_bfloat16* __restrict__ b,  // B [rank, dout]
                float* __restrict__ part, int din, int dout, int rank,
                int tiles, int pc) {
  constexpr int PW = per_warpgroup(RP);
  constexpr int kRowB = RP * 2;          // bytes of a bf16 t1 or u row
  constexpr int XS = 2 * RP + kXPad;     // floats of a partial row
  constexpr int kWBytes = RP * kCols * 2;  // a panel's weight slice
  cg::cluster_group cl = cg::this_cluster();
  const int csize = static_cast<int>(cl.num_blocks());
  const int crank = static_cast<int>(cl.block_rank());
  const int cid = blockIdx.x / csize;
  const int nclusters = gridDim.x / csize;
  const int nx = (din + kCols - 1) / kCols;
  const int np = nx + (dout + kCols - 1) / kCols;
  const int q0 = min(np, crank * pc);
  const int p = min(np, q0 + pc) - q0;  // this CTA's panels [q0, q0 + p)
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp4 = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // warpgroup 0 takes the CTA's panels [0, half), 1 the rest; of each
  // warpgroup's wn panels the first wnx are x's
  const int half = (p + 1) >> 1;
  const int w0 = wg == 0 ? 0 : half;
  const int wn = wg == 0 ? half : p - half;
  const int wnx = max(0, min(wn, nx - q0 - w0));

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sp;
  const uint32_t base = smem_base(smem_raw, &sp);
  const uint32_t ring = base;
  const uint32_t wts = ring + kStages * pc * kPanelBytes;
  const uint32_t tb = wts + pc * kWBytes;  // bf16(t1) [64][RP], swizzled
  const uint32_t ub = tb + kTok * kRowB;   // bf16(u)
  float* xch = reinterpret_cast<float*>(sp + (ub + kTok * kRowB - base));
  const uint32_t bars = ub + kTok * kRowB + kTok * XS * 4;

  // The weight slices, as B operands [RP rows][64 columns] K-major: A^T
  // for an x panel, B for a dy panel; zeros past rank, din and dout.
  for (int e = tid; e < p * RP * kCols; e += kThreads) {
    const int j = e / (RP * kCols);
    const int rem = e % (RP * kCols);
    const int q = q0 + j;
    int r, c;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (q < nx) {
      c = rem / RP;
      r = rem % RP;
      const int row = q * kCols + c;
      if (row < din && r < rank) v = a[static_cast<long long>(row) * rank + r];
    } else {
      r = rem / kCols;
      c = rem % kCols;
      const int col = (q - nx) * kCols + c;
      if (col < dout && r < rank) v = b[static_cast<long long>(r) * dout + col];
    }
    *reinterpret_cast<__nv_bfloat16*>(sp + (wts - base) + j * kWBytes +
                                      swz_offset<64, RP>(r, c >> 3) +
                                      (c & 7) * 2) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  // This cluster's tiles [t_lo, t_lo + nt).
  const int t_lo = static_cast<int>(static_cast<long long>(cid) * tiles /
                                    nclusters);
  const int nt = static_cast<int>(static_cast<long long>(cid + 1) * tiles /
                                  nclusters) - t_lo;
  auto issue = [&](int it) {
    const int s = it % kStages;
    const uint32_t bar = bars + 8 * s;
    mbar_arrive_tx(bar, p * kPanelBytes);
    const int row = (t_lo + it) * kTok;
    for (int j = 0; j < p; ++j) {
      const int q = q0 + j;
      const uint32_t dst = ring + (s * pc + j) * kPanelBytes;
      if (q < nx) {
        tma_load_2d(dst, &map_x, bar, q * kCols, row);
      } else {
        tma_load_2d(dst, &map_dy, bar, (q - nx) * kCols, row);
      }
    }
  };
  if (tid == 0) {
    for (int it = 0; it < min(nt, kStages); ++it) issue(it);
  }

  const int rows_c = kTok / csize;  // rows of t1 and u this CTA sums
  float acc[PW][RP / 2];
#pragma unroll
  for (int jj = 0; jj < PW; ++jj) zero(acc[jj]);
  float de0 = 0.f, de1 = 0.f;  // dE at columns 2 (tid % (RP / 2)), + 1

  for (int it = 0; it < nt; ++it) {
    const int s = it % kStages;
    mbar_wait(bars + 8 * s, (it / kStages) & 1);
    const uint32_t st = ring + s * pc * kPanelBytes;

    // 1. This warpgroup's partial u (x panels) and t1 (dy panels).
    float tacc[RP / 2], uacc[RP / 2];
    zero(tacc);
    zero(uacc);
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < PW; ++jj) {
      if (jj < wnx) {
        const int j = w0 + jj;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<RP>(uacc, desc_k<64, 64>(st + j * kPanelBytes, 0, kk),
                       desc_k<64, RP>(wts + j * kWBytes, 0, kk), 1);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < PW; ++jj) {
      if (jj < wn - wnx) {
        const int j = w0 + wnx + jj;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<RP>(tacc, desc_k<64, 64>(st + j * kPanelBytes, 0, kk),
                       desc_k<64, RP>(wts + j * kWBytes, 0, kk), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tacc);
    fence_regs(uacc);

    // 2. The CTA's partial [64][t1 | u]: warpgroup 1's, then 0's added.
    float* xr = xch + (16 * warp4 + g) * XS + 2 * t;
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < RP / 8; ++j) {
        *reinterpret_cast<float2*>(xr + 8 * j) =
            make_float2(tacc[4 * j], tacc[4 * j + 1]);
        *reinterpret_cast<float2*>(xr + 8 * XS + 8 * j) =
            make_float2(tacc[4 * j + 2], tacc[4 * j + 3]);
        *reinterpret_cast<float2*>(xr + RP + 8 * j) =
            make_float2(uacc[4 * j], uacc[4 * j + 1]);
        *reinterpret_cast<float2*>(xr + 8 * XS + RP + 8 * j) =
            make_float2(uacc[4 * j + 2], uacc[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < RP / 8; ++j) {
        float2* p0 = reinterpret_cast<float2*>(xr + 8 * j);
        float2* p1 = reinterpret_cast<float2*>(xr + 8 * XS + 8 * j);
        float2* p2 = reinterpret_cast<float2*>(xr + RP + 8 * j);
        float2* p3 = reinterpret_cast<float2*>(xr + 8 * XS + RP + 8 * j);
        float2 v0 = *p0, v1 = *p1, v2 = *p2, v3 = *p3;
        v0.x += tacc[4 * j];
        v0.y += tacc[4 * j + 1];
        v1.x += tacc[4 * j + 2];
        v1.y += tacc[4 * j + 3];
        v2.x += uacc[4 * j];
        v2.y += uacc[4 * j + 1];
        v3.x += uacc[4 * j + 2];
        v3.y += uacc[4 * j + 3];
        *p0 = v0;
        *p1 = v1;
        *p2 = v2;
        *p3 = v3;
      }
    }
    cl.sync();

    // 3. Rows [crank rows_c, +rows_c) of t1 and u, summed over the cluster
    //    in rank order; their share of dE; rounded into this CTA's tiles.
    for (int e = tid; e < rows_c * (RP / 2); e += kThreads) {
      const int row = crank * rows_c + e / (RP / 2);
      const int col = 2 * (e % (RP / 2));
      float2 tv[kMaxCluster], uv[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < csize) {
          const float* px = cl.map_shared_rank(xch, c) + row * XS + col;
          tv[c] = *reinterpret_cast<const float2*>(px);
          uv[c] = *reinterpret_cast<const float2*>(px + RP);
        }
      }
      float2 ts = tv[0], us = uv[0];
#pragma unroll
      for (int c = 1; c < kMaxCluster; ++c) {
        if (c < csize) {
          ts.x += tv[c].x;
          ts.y += tv[c].y;
          us.x += uv[c].x;
          us.y += uv[c].y;
        }
      }
      de0 += us.x * ts.x;
      de1 += us.y * ts.y;
      const int off = swz_offset<RP, kTok>(row, col >> 3) + (col & 7) * 2;
      *reinterpret_cast<uint32_t*>(sp + (tb - base) + off) =
          pack_f32x2(ts.x, ts.y);
      *reinterpret_cast<uint32_t*>(sp + (ub - base) + off) =
          pack_f32x2(us.x, us.y);
    }
    cl.sync();

    // 4. The other CTAs' rows, from their shared memory (rows lie whole and
    //    in order in the swizzled tiles).
    {
      const int chunks = rows_c * kRowB / 16;  // of one CTA's rows
      for (int e = tid; e < csize * 2 * chunks; e += kThreads) {
        const int c = e / (2 * chunks);
        if (c == crank) continue;
        const int m = (e / chunks) & 1;
        const uint32_t off = (m ? ub : tb) - base + c * rows_c * kRowB +
                             (e % chunks) * 16;
        uint4* local = reinterpret_cast<uint4*>(sp + off);
        *local = *cl.map_shared_rank(local, c);
      }
    }
    fence_proxy_async();
    __syncthreads();

    // 5. dA[panel] += x_panel^T bf16(t1), dB^T[panel] += dy_panel^T bf16(u):
    //    A by ldmatrix.trans from the tile (rows 16 warp4.. of the panel's
    //    columns, 16 tokens a step), B the bf16 tile, MN-major.
    {
      uint32_t af[2][4][4];
      const int lr = (lane & 7) + ((lane >> 4) << 3);
      const int lc = 2 * warp4 + ((lane >> 3) & 1);
#pragma unroll
      for (int jj = 0; jj < PW; ++jj) {
        if (jj < wn) {
          const uint32_t panel = st + (w0 + jj) * kPanelBytes;
          const uint32_t bt = jj < wnx ? tb : ub;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int r = 16 * kk + lr;
            ldsm_x4_t(af[jj & 1][kk], panel + r * 128 + ((lc ^ (r & 7)) << 4));
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<RP>(acc[jj], af[jj & 1][kk], desc_mn<RP, kTok>(bt, kk));
          }
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int jj = 0; jj < PW; ++jj) fence_regs(acc[jj]);
    }

    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && it + kStages < nt) issue(it + kStages);
  }
  cl.sync();  // no CTA leaves while a peer may still read its tiles

  // This cluster's sums: panel q's rows at q 64, then each CTA's dE.
  float* out = part + static_cast<long long>(cid) *
                          (static_cast<long long>(np) * kCols * RP +
                           csize * RP);
#pragma unroll
  for (int jj = 0; jj < PW; ++jj) {
    if (jj < wn) {
      float* o = out + (static_cast<long long>(q0 + w0 + jj) * kCols +
                        16 * warp4 + g) * RP + 2 * t;
#pragma unroll
      for (int j = 0; j < RP / 8; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) =
            make_float2(acc[jj][4 * j], acc[jj][4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * RP + 8 * j) =
            make_float2(acc[jj][4 * j + 2], acc[jj][4 * j + 3]);
      }
    }
  }
  xch[2 * tid] = de0;
  xch[2 * tid + 1] = de1;
  __syncthreads();
  if (tid < RP) {
    float sum = 0.f;
    for (int m = 0; m < kThreads / (RP / 2); ++m) {
      sum += xch[2 * ((tid >> 1) + m * (RP / 2)) + (tid & 1)];
    }
    out[static_cast<long long>(np) * kCols * RP + crank * RP + tid] = sum;
  }
}

// dA, dB and dE from the clusters' sums, each summed over clusters (and dE
// over each cluster's CTAs) in order.
__global__ void lora_reduce_kernel(const float* __restrict__ part,
                                   int nclusters, int csize, int np, int nx,
                                   int din, int dout, int rank, int rp,
                                   float* __restrict__ da,
                                   float* __restrict__ db,
                                   float* __restrict__ de) {
  const long long stride = static_cast<long long>(np) * kCols * rp +
                           csize * rp;
  const long long n_da = static_cast<long long>(din) * rank;
  const long long n_db = static_cast<long long>(rank) * dout;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n_da + n_db + rank;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    if (i < n_da + n_db) {
      long long src;
      if (i < n_da) {
        src = (i / rank) * rp + i % rank;
      } else {
        const long long k = i - n_da;  // (o, j), j fastest: rows read whole
        src = (static_cast<long long>(nx) * kCols + k / rank) * rp + k % rank;
      }
      for (int c = 0; c < nclusters; ++c) sum += part[c * stride + src];
      if (i < n_da) {
        da[i] = sum;
      } else {
        const long long k = i - n_da;
        db[(k % rank) * dout + k / rank] = sum;
      }
    } else {
      const int j = static_cast<int>(i - n_da - n_db);
      for (int c = 0; c < nclusters; ++c) {
        for (int r = 0; r < csize; ++r) {
          sum += part[c * stride + static_cast<long long>(np) * kCols * rp +
                      r * rp + j];
        }
      }
      de[j] = sum;
    }
  }
}

// The TMA map of a [n, cols] bf16 row-major matrix in boxes of [64 tokens,
// 64 columns], 128-byte swizzled; rows past n and columns past cols load as
// zeros. False if the driver refuses it.
bool make_map_2d(CUtensorMap* map, const void* ptr, int n, int cols) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kCols, kTok};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Clusters of `cluster` CTAs with `smem` bytes that the device holds at
// once, per kernel, device, cluster size and panels per CTA, asked once.
template <int RP>
int resident_clusters(int cluster, int pc, int smem) {
  static int known[kMaxDevices][4][2 * per_warpgroup(32) + 1] = {};
  const auto kernel = lora_bwd_kernel<RP>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) return -1;
  const int ci = cluster == 1 ? 0 : cluster == 2 ? 1 : cluster == 4 ? 2 : 3;
  int& n = known[dev][ci][pc];
  if (n == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return -1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int found = 0;
    err = cudaOccupancyMaxActiveClusters(&found, kernel, &cfg);
    if (err != cudaSuccess || found < 1) return -1;
    n = found;
  }
  return n;
}

template <int RP>
int launch_one_pass(const void* x, const void* dy, const __nv_bfloat16* a,
                    const __nv_bfloat16* b, int n, int din, int dout,
                    int rank, int cluster, int pc, int max_clusters,
                    float* part, float* da, float* db, float* de,
                    cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  const int smem = smem_bytes(pc, RP);
  const int nx = (din + kCols - 1) / kCols;
  const int np = nx + (dout + kCols - 1) / kCols;
  if (pc < 1 || pc > 2 * per_warpgroup(RP) || cluster * pc < np ||
      smem > kMaxSmem || max_clusters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int resident = resident_clusters<RP>(cluster, pc, smem);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (n + kTok - 1) / kTok;
  const int nclusters = std::min(std::min(max_clusters, resident), tiles);
  CUtensorMap mx, mdy;
  if (!make_map_2d(&mx, x, n, din) || !make_map_2d(&mdy, dy, n, dout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaGetDevice(&dev);
  raised[dev] = kMaxSmem;  // resident_clusters raised the limit
  int err = launch_clusters(lora_bwd_kernel<RP>, raised,
                            dim3(nclusters * cluster), kThreads, cluster,
                            smem, stream, mx, mdy, a, b, part, din, dout,
                            rank, tiles, pc);
  if (err != 0) return err;
  const long long outs = static_cast<long long>(din) * rank +
                         static_cast<long long>(rank) * dout + rank;
  const int blocks = static_cast<int>(std::min((outs + 255) / 256, 2048LL));
  lora_reduce_kernel<<<blocks, 256, 0, stream>>>(part, nclusters, cluster, np,
                                                 nx, din, dout, rank, RP, da,
                                                 db, de);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide path, for shapes past the one-pass plan: t1u, then atb twice, then
// three ordered reduces.
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kWideThreads = kWarps * 32;
constexpr int kTokTile = 64;    // tokens per CTA in t1u, 16 per warp
constexpr int kTile = 64;       // atb output tile (rows and columns)
constexpr int kSlice = 64;      // tokens per shared-memory slice in atb
constexpr int kChunk = 2048;    // tokens per atb partial sum
constexpr int kPad = 8;

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[RP/8] += rows (row_lo, row_lo + 8) of act [N, width] times W^T, with W
// [rank, width] row-major (B, or A transposed); W rows at or past rank are 0.
template <int RP>
__device__ __forceinline__ void narrow_product(float (&acc)[RP / 8][4],
                                               const __nv_bfloat16* act,
                                               const __nv_bfloat16* w,
                                               int width, int rank, int row_lo,
                                               int n, int g, int tg) {
  const bool in_lo = row_lo < n;
  const bool in_hi = row_lo + 8 < n;
  const __nv_bfloat16* lo = act + static_cast<long long>(row_lo) * width;
  const __nv_bfloat16* hi = lo + 8LL * width;
  for (int k0 = 0; k0 < width; k0 += 16) {
    const int c = k0 + tg * 2;
    const uint32_t a[4] = {
        in_lo ? load_u32(lo + c) : 0u, in_hi ? load_u32(hi + c) : 0u,
        in_lo ? load_u32(lo + c + 8) : 0u, in_hi ? load_u32(hi + c + 8) : 0u};
#pragma unroll
    for (int nt = 0; nt < RP / 8; ++nt) {
      const int r = nt * 8 + g;
      const __nv_bfloat16* wr = w + static_cast<long long>(r) * width + c;
      const uint32_t b0 = r < rank ? load_u32(wr) : 0u;
      const uint32_t b1 = r < rank ? load_u32(wr + 8) : 0u;
      mma16816(acc[nt], a, b0, b1);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. t1 = dy B^T, u = x A per 64-token tile; bf16 copies and partial dE.
// ---------------------------------------------------------------------------
template <int RP>
__global__ void __launch_bounds__(kWideThreads)
lora_t1u_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ dy,
                const __nv_bfloat16* __restrict__ at,  // A^T [rank, din]
                const __nv_bfloat16* __restrict__ b,   // B [rank, dout]
                __nv_bfloat16* __restrict__ t1b,       // [N, RP]
                __nv_bfloat16* __restrict__ ub,        // [N, RP]
                float* __restrict__ de_part,           // [tiles, RP]
                int n, int din, int dout, int rank) {
  __shared__ float de_s[kWarps][RP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int row_lo = blockIdx.x * kTokTile + warp * 16 + g;
  const int row_hi = row_lo + 8;

  float t1[RP / 8][4];
  float u[RP / 8][4];
#pragma unroll
  for (int nt = 0; nt < RP / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t1[nt][e] = u[nt][e] = 0.f;
  }
  narrow_product<RP>(t1, dy, b, dout, rank, row_lo, n, g, tg);
  narrow_product<RP>(u, x, at, din, rank, row_lo, n, g, tg);

  // Rows past N hold zeros in both, so they add nothing to dE.
#pragma unroll
  for (int nt = 0; nt < RP / 8; ++nt) {
    const int c = nt * 8 + tg * 2;
    if (row_lo < n) {
      *reinterpret_cast<uint32_t*>(t1b + static_cast<long long>(row_lo) * RP + c) =
          pack_f32x2(t1[nt][0], t1[nt][1]);
      *reinterpret_cast<uint32_t*>(ub + static_cast<long long>(row_lo) * RP + c) =
          pack_f32x2(u[nt][0], u[nt][1]);
    }
    if (row_hi < n) {
      *reinterpret_cast<uint32_t*>(t1b + static_cast<long long>(row_hi) * RP + c) =
          pack_f32x2(t1[nt][2], t1[nt][3]);
      *reinterpret_cast<uint32_t*>(ub + static_cast<long long>(row_hi) * RP + c) =
          pack_f32x2(u[nt][2], u[nt][3]);
    }
    // dE over this thread's two rows, then over the 8 row groups (lane
    // bits 2-4) of the warp.
    float e0 = u[nt][0] * t1[nt][0] + u[nt][2] * t1[nt][2];
    float e1 = u[nt][1] * t1[nt][1] + u[nt][3] * t1[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      e0 += __shfl_xor_sync(0xffffffffu, e0, off);
      e1 += __shfl_xor_sync(0xffffffffu, e1, off);
    }
    if (g == 0) {
      de_s[warp][c] = e0;
      de_s[warp][c + 1] = e1;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < RP; c += kWideThreads) {
    de_part[static_cast<long long>(blockIdx.x) * RP + c] =
        de_s[0][c] + de_s[1][c] + de_s[2][c] + de_s[3][c];
  }
}

// ---------------------------------------------------------------------------
// 2. part[chunk][m][j] = sum over the chunk's tokens of X[t][m] Y[t][j], for
//    X [N, M] and Y [N, J] bf16 row-major (M and J multiples of 8).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWideThreads)
lora_atb_kernel(const __nv_bfloat16* __restrict__ xm,
                const __nv_bfloat16* __restrict__ ym,
                float* __restrict__ part, int n, int m_dim, int j_dim) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kSlice][kTile + kPad];
  __shared__ __align__(16) __nv_bfloat16 y_s[kSlice][kTile + kPad];
  const int m0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int chunk = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int mr = warp * 16 + g;  // this thread's output rows mr, mr + 8

  float acc[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  const int t_end = min(n, (chunk + 1) * kChunk);
  for (int t0 = chunk * kChunk; t0 < t_end; t0 += kSlice) {
    // Stage X[t0:t0+64, m0:m0+64] and Y[t0:t0+64, j0:j0+64]; zeros past the
    // token end and past M / J.
    for (int i = threadIdx.x; i < kSlice * (kTile / 8); i += kWideThreads) {
      const int r = i / (kTile / 8);
      const int c = (i % (kTile / 8)) * 8;
      const long long t = t0 + r;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      uint4 yv = make_uint4(0u, 0u, 0u, 0u);
      if (t < t_end) {
        if (m0 + c < m_dim) {
          xv = *reinterpret_cast<const uint4*>(xm + t * m_dim + m0 + c);
        }
        if (j0 + c < j_dim) {
          yv = *reinterpret_cast<const uint4*>(ym + t * j_dim + j0 + c);
        }
      }
      *reinterpret_cast<uint4*>(&x_s[r][c]) = xv;
      *reinterpret_cast<uint4*>(&y_s[r][c]) = yv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk) {
      const int r = kk * 16 + tg * 2;  // token rows of the k step
      const uint32_t a[4] = {
          pack_bf16x2(x_s[r][mr], x_s[r + 1][mr]),
          pack_bf16x2(x_s[r][mr + 8], x_s[r + 1][mr + 8]),
          pack_bf16x2(x_s[r + 8][mr], x_s[r + 9][mr]),
          pack_bf16x2(x_s[r + 8][mr + 8], x_s[r + 9][mr + 8]),
      };
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int c = nt * 8 + g;
        const uint32_t b0 = pack_bf16x2(y_s[r][c], y_s[r + 1][c]);
        const uint32_t b1 = pack_bf16x2(y_s[r + 8][c], y_s[r + 9][c]);
        mma16816(acc[nt], a, b0, b1);
      }
    }
    __syncthreads();
  }

  float* out = part + static_cast<long long>(chunk) * m_dim * j_dim;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int j = j0 + nt * 8 + tg * 2;  // j_dim is even: j + 1 < j_dim too
    if (j >= j_dim) continue;
    const int m_lo = m0 + mr;
    if (m_lo < m_dim) {
      out[static_cast<long long>(m_lo) * j_dim + j] = acc[nt][0];
      out[static_cast<long long>(m_lo) * j_dim + j + 1] = acc[nt][1];
    }
    if (m_lo + 8 < m_dim) {
      out[static_cast<long long>(m_lo + 8) * j_dim + j] = acc[nt][2];
      out[static_cast<long long>(m_lo + 8) * j_dim + j + 1] = acc[nt][3];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. out[m][j] = sum over p of part[p][m][j], for m < rows, j < cols_out;
//    a part is part_size floats of rows cols_in wide. Summed in order.
// ---------------------------------------------------------------------------
__global__ void lora_wide_reduce_kernel(const float* __restrict__ part, int n_parts,
                                   long long part_size, int rows, int cols_in,
                                   int cols_out, float* __restrict__ out) {
  const long long size = static_cast<long long>(rows) * cols_out;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < size; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long src = (i / cols_out) * cols_in + i % cols_out;
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[p * part_size + src];
    out[i] = s;
  }
}

void reduce_wide(const float* part, int n_parts, long long part_size, int rows,
            int cols_in, int cols_out, float* out, cudaStream_t stream) {
  const long long size = static_cast<long long>(rows) * cols_out;
  const int blocks = static_cast<int>(std::min((size + 255) / 256, 4096LL));
  lora_wide_reduce_kernel<<<blocks, 256, 0, stream>>>(part, n_parts, part_size, rows,
                                                 cols_in, cols_out, out);
}

template <int RP>
void launch_wide(const __nv_bfloat16* x, const __nv_bfloat16* dy,
            const __nv_bfloat16* at, const __nv_bfloat16* b, int n, int din,
            int dout, int rank, __nv_bfloat16* t1b, __nv_bfloat16* ub,
            float* de_part, float* da_part, float* db_part, float* da,
            float* db, float* de, cudaStream_t stream) {
  const int tiles = (n + kTokTile - 1) / kTokTile;
  const int chunks = (n + kChunk - 1) / kChunk;
  lora_t1u_kernel<RP><<<tiles, kWideThreads, 0, stream>>>(
      x, dy, at, b, t1b, ub, de_part, n, din, dout, rank);
  // dA partials: X = x [N, din], Y = bf16(t1) [N, RP]
  lora_atb_kernel<<<dim3((din + kTile - 1) / kTile, (RP + kTile - 1) / kTile,
                         chunks), kWideThreads, 0, stream>>>(x, t1b, da_part, n,
                                                         din, RP);
  // dB partials: X = bf16(u) [N, RP], Y = dy [N, dout]
  lora_atb_kernel<<<dim3((RP + kTile - 1) / kTile, (dout + kTile - 1) / kTile,
                         chunks), kWideThreads, 0, stream>>>(ub, dy, db_part, n,
                                                         RP, dout);
  reduce_wide(da_part, chunks, 1LL * din * RP, din, RP, rank, da, stream);
  reduce_wide(db_part, chunks, 1LL * RP * dout, rank, dout, dout, db, stream);
  reduce_wide(de_part, tiles, RP, 1, RP, rank, de, stream);
}

}  // namespace

// One pass. x [N, din], dy [N, dout]: bf16, contiguous, 16-byte aligned;
// a = A [din, rank], b = B [rank, dout]: bf16, contiguous; din and dout
// multiples of 16, 1 <= rank <= rp, rp in {32, 64}. The plan (ops/
// lora_bwd.py::plan): clusters of `cluster` CTAs of `pc` panels each, at
// most max_clusters of them; part: max_clusters x (np 64 rp + cluster rp)
// f32 scratch (np = ceil(din / 64) + ceil(dout / 64)). Outputs: da
// [din, rank], db [rank, dout], de [rank] f32.
extern "C" int nsp_lora_bwd_bf16(const void* x, const void* dy, const void* a,
                                 const void* b, int n, int din, int dout,
                                 int rank, int rp, int cluster, int pc,
                                 int max_clusters, void* part, void* da,
                                 void* db, void* de, void* stream) {
  using bf = __nv_bfloat16;
  if (rank < 1 || rank > rp || din % 16 || dout % 16 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf* a_ = static_cast<const bf*>(a);
  const bf* b_ = static_cast<const bf*>(b);
  float* part_ = static_cast<float*>(part);
  float* da_ = static_cast<float*>(da);
  float* db_ = static_cast<float*>(db);
  float* de_ = static_cast<float*>(de);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rp) {
    case 32:
      return launch_one_pass<32>(x, dy, a_, b_, n, din, dout, rank, cluster,
                                 pc, max_clusters, part_, da_, db_, de_, s);
    case 64:
      return launch_one_pass<64>(x, dy, a_, b_, n, din, dout, rank, cluster,
                                 pc, max_clusters, part_, da_, db_, de_, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of `cluster` CTAs of `pc` panels at width rp that the current
// device holds at once (the one-pass kernel's grid is at most this many),
// or a negative number if the device refuses the configuration.
extern "C" int nsp_lora_bwd_resident(int rp, int cluster, int pc) {
  if ((rp != 32 && rp != 64) || pc < 1 || pc > 2 * per_warpgroup(rp) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)) {
    return -1;
  }
  const int smem = smem_bytes(pc, rp);
  return rp == 32 ? resident_clusters<32>(cluster, pc, smem)
                  : resident_clusters<64>(cluster, pc, smem);
}

// The wide path. x [N, din], dy [N, dout], at = A^T [rank, din], b = B
// [rank, dout]: bf16, contiguous, din and dout multiples of 16, 1 <= rank <=
// rp, rp in {16, 32, 64}. Scratch (caller-allocated): t1b, ub [N, rp] bf16;
// de_part [ceil(N / 64), rp], da_part [ceil(N / 2048), din, rp], db_part
// [ceil(N / 2048), rp, dout] f32. Outputs: da [din, rank], db [rank, dout],
// de [rank] f32.
extern "C" int nsp_lora_bwd_wide_bf16(const void* x, const void* dy,
                                      const void* at, const void* b, int n,
                                      int din, int dout, int rank, int rp,
                                      void* t1b, void* ub, void* de_part,
                                      void* da_part, void* db_part, void* da,
                                      void* db, void* de, void* stream) {
  using bf = __nv_bfloat16;
  const bf* x_ = static_cast<const bf*>(x);
  const bf* dy_ = static_cast<const bf*>(dy);
  const bf* at_ = static_cast<const bf*>(at);
  const bf* b_ = static_cast<const bf*>(b);
  bf* t1b_ = static_cast<bf*>(t1b);
  bf* ub_ = static_cast<bf*>(ub);
  float* dep = static_cast<float*>(de_part);
  float* dap = static_cast<float*>(da_part);
  float* dbp = static_cast<float*>(db_part);
  float* da_ = static_cast<float*>(da);
  float* db_ = static_cast<float*>(db);
  float* de_ = static_cast<float*>(de);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rp) {
    case 16:
      launch_wide<16>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep,
                      dap, dbp, da_, db_, de_, s);
      break;
    case 32:
      launch_wide<32>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep,
                      dap, dbp, da_, db_, de_, s);
      break;
    case 64:
      launch_wide<64>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep,
                      dap, dbp, da_, db_, de_, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
