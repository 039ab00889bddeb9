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
// Design, simple first: one CTA of eight warps per 128 x 128 output tile of
// one batch entry, K walked in steps of 32 through shared memory (A tile
// [128][32], B tile [32][128], 16-byte loads, no pipelining), each warp a
// 32 x 64 sub-tile of mma.sync.m16n8k16 with f32 accumulators, rounded to
// bf16 once at the store. wgmma, TMA and a staged pipeline are later work.
//
// C entry point: nsp_probe_dot_bf16, below. Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kPad = 8;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
probe_dot_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kBM][kBK + kPad];
  __shared__ __align__(16) __nv_bfloat16 b_s[kBK][kBN + kPad];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const long long batch = blockIdx.z;
  a += batch * m * k;
  b += batch * k * n;
  c += batch * m * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // 4 x 2 warps

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), cc = (i % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&a_s[r][cc]) =
          *reinterpret_cast<const uint4*>(a + (m0 + r) * static_cast<long long>(k) + k0 + cc);
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), cc = (i % (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&b_s[r][cc]) =
          *reinterpret_cast<const uint4*>(b + (k0 + r) * static_cast<long long>(n) + n0 + cc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g, cc = kk * 16 + tg * 2;
        af[i][0] = load_u32(&a_s[r][cc]);
        af[i][1] = load_u32(&a_s[r + 8][cc]);
        af[i][2] = load_u32(&a_s[r][cc + 8]);
        af[i][3] = load_u32(&a_s[r + 8][cc + 8]);
      }
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = wn + j * 8 + g;
        const uint32_t b0 = pack_bf16x2(b_s[r][cc], b_s[r + 1][cc]);
        const uint32_t b1 = pack_bf16x2(b_s[r + 8][cc], b_s[r + 9][cc]);
        mma_16816(acc[0][j], af[0], b0, b1);
        mma_16816(acc[1][j], af[1], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = m0 + wm + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = n0 + wn + j * 8 + tg * 2;
      *reinterpret_cast<uint32_t*>(c + r * n + cc) = pack_f32x2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(c + (r + 8) * n + cc) =
          pack_f32x2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

// a: [batch, m, k], b: [batch, k, n], c: [batch, m, n], bf16, contiguous;
// m and n multiples of 128, k a multiple of 32 (checked by the caller).
extern "C" int nsp_probe_dot_bf16(const void* a, const void* b, void* c,
                                  int batch, int m, int n, int k, void* stream) {
  probe_dot_kernel<<<dim3(n / kBN, m / kBM, batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
