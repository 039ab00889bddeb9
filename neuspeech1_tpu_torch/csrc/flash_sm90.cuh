// What the wgmma kernels for Hopper (sm_90a) share: the swizzled
// shared-memory layout of a [ROWS, D] bf16 tile, its cp.async copy with
// zero-fill, the wgmma descriptors that name it, and the wgmma.m64nNk16
// products (A from shared memory or from registers) with their fences;
// mbarriers, named barriers, TMA loads and stores with the tensor-map
// encoder (cuTensorMapEncodeTiled). Included by flash_fwd_btc.cu,
// flash_bwd_btc.cu, lora_bwd.cu, probe_fwd.cu, probe_bwd.cu and
// probe_dot.cu, with decode_sm90.cuh (ldmatrix, mma.sync, cp.async groups,
// cluster launches); everything is in an anonymous namespace, so each
// source gets its own copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: see encoder())
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// A bias at or below this masks its column (the bias rows carry -1e30).
constexpr float kMaskedBias = -1e29f;

struct Strides {
  long long b, t, h;  // in elements; the head dimension is contiguous
};

// The shared-memory layout of a [ROWS, D] bf16 tile: D is cut into blocks of
// kAtomCols columns (64, or 32 at D=32), each block [ROWS][kAtomCols] with
// the 16-byte chunks of row r permuted by the 128-byte (64-byte) swizzle,
// chunk c at c ^ (r % 8) (c ^ ((r / 2) % 4)). Tiles start 1024-byte aligned,
// so this is the swizzle of the absolute address that wgmma applies.
template <int D>
struct Swz {
  static constexpr int kAtomCols = D == 32 ? 32 : 64;
  static constexpr int kRowBytes = kAtomCols * 2;
  static constexpr int kChunks = D / 8;  // 16-byte chunks of one row
  static constexpr uint64_t kSwizzle = D == 32 ? 2 : 1;  // B64 : B128
};

template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz_offset(int r, int chunk) {
  using C = Swz<D>;
  constexpr int kPerAtom = C::kAtomCols / 8;
  const int blk = chunk / kPerAtom;
  const int c = chunk % kPerAtom;
  const int sw = D == 32 ? (r >> 1) & 3 : r & 7;
  return blk * ROWS * C::kRowBytes + r * C::kRowBytes + ((c ^ sw) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async and
// st.shared) visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma.wait_group.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) of a [ROWS, D] tile, the
// k-th 16-column slice of D. SBO steps 8 rows; LBO is unused (one k slice
// lies inside one swizzle row).
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using C = Swz<D>;
  constexpr int kPerAtom = C::kAtomCols / 16;
  const uint32_t addr = tile + (kk / kPerAtom) * ROWS * C::kRowBytes +
                        row0 * C::kRowBytes + (kk % kPerAtom) * 32;
  return make_desc(addr, 16, 8 * C::kRowBytes, C::kSwizzle);
}

// MN-major operand: the [ROWS, D] tile read as B[k, n] with k the row (the
// reduction runs over the tile's rows) and n in D; rows [16 kk, 16 kk + 16).
// SBO steps 8 rows, LBO steps one kAtomCols block of D.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using C = Swz<D>;
  return make_desc(tile + kk * 16 * C::kRowBytes, ROWS * C::kRowBytes,
                   8 * C::kRowBytes, C::kSwizzle);
}

// wgmma.m64nNk16 bf16 -> f32. _ss: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d. _rs: A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B MN-major, d += A B.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x (MUFU ex2, flushing subnormal results to 0; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a register-sourced wgmma from an accumulator tile of N
// columns: fragment kk holds columns [16 kk, 16 kk + 16), rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_f32x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Copies rows [row0, row0 + ROWS) of one head into a swizzled [ROWS, D]
// tile by cp.async, 16 bytes a thread of NT; rows at or past n_valid are
// zeros.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_valid) {
  constexpr int kC = Swz<D>::kChunks;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kC; i += NT) {
    const int r = i / kC;
    const int c = i % kC;
    const bool in = row0 + r < n_valid;
    const long long off = in ? (row0 + r) * row_stride + c * 8 : 0;
    cp_async16(dst + swz_offset<D, ROWS>(r, c), src + off, in);
  }
}

// The 1024-byte aligned start of the dynamic shared memory, as a shared
// address and a generic pointer.
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw, uint8_t** ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t base = (a + 1023u) & ~1023u;
  *ptr = raw + (base - a);
  return base;
}

constexpr int round_up_1k(int x) { return (x + 1023) / 1024 * 1024; }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box at (column c0, row c1) of a 2-D map into shared memory,
// counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: a swizzled [rows, 64] bf16 box from shared memory to (column c0,
// row c1) of a 2-D map, in the thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups are still reading
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over n threads: wait for
// them, or only count this thread's arrival.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (this library
// links nothing but the runtime).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeFn>(ptr);
    }
  }
  return fn;
}

// The TMA map of a 2-D bf16 array of `rows` rows of `cols` elements,
// `row_bytes` apart, in boxes of [box_rows, 64] swizzled by 128 bytes (the
// Swz<64> layout of each box); false if the encoder refuses it.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, long long cols,
                        long long rows, long long row_bytes, int box_rows) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
