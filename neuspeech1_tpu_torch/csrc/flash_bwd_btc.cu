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

namespace {

constexpr int kThreads = 256;  // two warpgroups: the delta and dq kernels
// Two warpgroups of 64 K/V rows per dk/dv CTA: with three the registers
// (at most 168) no longer hold the products and ptxas serializes them.
constexpr int kDkdvWarpgroups = 2;
constexpr int kDkdvThreads = 128 * kDkdvWarpgroups;
constexpr int kBlockKV = 64 * kDkdvWarpgroups;  // K/V rows per dk/dv CTA
constexpr int kBlockQdq = 128; // q rows per CTA of the dq kernel
constexpr int kBlockKdq = 64;  // K/V rows per tile of the dq kernel
constexpr float kLog2e = 1.4426950408889634f;
// A bias at or below this masks its column (the bias rows carry -1e30).
constexpr float kMaskedBias = -1e29f;

// The shared-memory layout of a [ROWS, D] bf16 tile: D is cut into blocks of
// kAtomCols columns (64, or 32 at D=32), each block [ROWS][kAtomCols] with
// the 16-byte chunks of row r permuted by the 128-byte (64-byte) swizzle,
// chunk c at c ^ (r % 8) (c ^ ((r / 2) % 4)). Tiles start 1024-byte aligned,
// so this is the swizzle of the absolute address that wgmma applies.
template <int D>
struct Cfg {
  static constexpr int kAtomCols = D == 32 ? 32 : 64;
  static constexpr int kRowBytes = kAtomCols * 2;
  static constexpr int kChunks = D / 8;  // 16-byte chunks of one row
  static constexpr uint64_t kSwizzle = D == 32 ? 2 : 1;  // B64 : B128
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

template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz_offset(int r, int chunk) {
  using C = Cfg<D>;
  constexpr int kPerAtom = C::kAtomCols / 8;
  const int blk = chunk / kPerAtom;
  const int c = chunk % kPerAtom;
  const int sw = D == 32 ? (r >> 1) & 3 : r & 7;
  return blk * ROWS * C::kRowBytes + r * C::kRowBytes + ((c ^ sw) << 4);
}

struct Strides {
  long long b, t, h;  // in elements; the head dimension is contiguous
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
  using C = Cfg<D>;
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
  using C = Cfg<D>;
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

struct Params {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float *lse, *bias;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int n_heads, t_q, t_kv, kv_len, causal;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
};

// Copies rows [row0, row0 + ROWS) of one head into a swizzled [ROWS, D]
// tile by cp.async, 16 bytes a thread; rows at or past n_valid are zeros.
template <int D, int ROWS, int NT = kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_valid) {
  constexpr int kC = Cfg<D>::kChunks;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * kC; i += NT) {
    const int r = i / kC;
    const int c = i % kC;
    const bool in = row0 + r < n_valid;
    const long long off = in ? (row0 + r) * row_stride + c * 8 : 0;
    cp_async16(dst + swz_offset<D, ROWS>(r, c), src + off, in);
  }
}

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

// The 1024-byte aligned start of the dynamic shared memory, as a shared
// address and a generic pointer.
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw, uint8_t** ptr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t base = (a + 1023u) & ~1023u;
  *ptr = raw + (base - a);
  return base;
}

constexpr int round_up_1k(int x) { return (x + 1023) / 1024 * 1024; }

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
    load_tile<D, BK>(st, k, p.ks.t, kv0, kv_len);
    load_tile<D, BK>(st + L::kTileK, v, p.vs.t, kv0, kv_len);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < BK; i += kThreads) {
        const bool in = kv0 + i < kv_len;
        cp_async4(st + L::kBias + 4 * i, p.bias + (in ? kv0 + i : 0), in);
      }
    }
  };

  load_tile<D, kBlockQdq>(q_s, p.q + batch * p.qs.b + head * p.qs.h, p.qs.t,
                          q0, t_q);
  load_tile<D, kBlockQdq>(do_s, p.dout + batch * p.dos.b + head * p.dos.h,
                          p.dos.t, q0, t_q);
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
