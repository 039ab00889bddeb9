// What the decode-attention kernels for Hopper (sm_90a) share: mma.sync
// m16n8k16 bf16 products with f32 sums, their ldmatrix operand loads,
// cp.async copies with zero-fill, the swizzle of a shared tile's 16-byte
// chunks, and the launch of a grid of thread-block clusters with dynamic
// shared memory. Included by decode_cross.cu (K6) and decode_step_multi.cu
// (K8); everything is in an anonymous namespace, so each source gets its
// own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile whose rows are
// ROW_BYTES long: the chunk index is XOR-ed with the row so that the eight
// rows an ldmatrix reads at one chunk fall in eight different bank groups.
template <int ROW_BYTES>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(ROW_BYTES % 64 == 0, "rows of 64-byte multiples");
  const int s = ROW_BYTES == 64 ? (r >> 1) & 3 : r & 7;
  return r * ROW_BYTES + ((c ^ s) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copies N bytes (16, 8 or 4) from global to shared memory asynchronously;
// only the first `valid` bytes are read, the rest of the N are zeros.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int valid) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(valid)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Launches `kernel` on `grid` in clusters of cluster_x CTAs along x, with
// `smem` bytes of dynamic shared memory. The kernel's shared-memory limit is
// raised once per device (the attribute is per device) and recorded in
// `raised` [kMaxDevices], the caller's per-kernel record; the host cost of a
// launch is then one cudaLaunchKernelEx.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int* raised, dim3 grid,
                    int threads, int cluster_x, int smem, cudaStream_t stream,
                    Args... args) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (raised[dev] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = smem;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
