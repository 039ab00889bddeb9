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
// the TPU kernel's rounding points. r <= 64 is zero-padded to RP in {16, 32,
// 64}, the mma.sync tile; any N is taken, the ragged last tile zero-filled.
//
// What bounds it: the narrow products do about 8 N (din + dout) r FLOP
// against 2 N (din + dout) bytes of x and dy, some 130 FLOP per byte at
// r = 32: below the card's ~295, so the bytes of x and dy are the limit.
//
// Design, simple first and deterministic. The TPU grid walked the token
// blocks in order and kept the [din, r] / [r, dout] sums in VMEM; on Hopper
// blocks run in parallel and a CTA cannot hold a [2048, 32] f32 sum, so:
//   1. t1u: one CTA of four warps per 64 tokens computes t1 and u with
//      mma.sync (fragments read straight from global memory), writes
//      bf16(t1) and bf16(u) [N, RP] and the tile's partial dE [RP].
//   2. atb: dA and dB are both X^T Y over tokens (X = x, Y = bf16(t1); X =
//      bf16(u), Y = dy). One CTA per (64 x 64 output tile, 2048-token chunk)
//      stages 64-token slices of X and Y in shared memory and writes its
//      partial sum.
//   3. reduce: sums the partials of dA, dB and dE over chunks in a fixed
//      order (no atomics, so the result does not change from run to run).
// x and dy are read twice (steps 1 and 2), where the TPU kernel read them
// once; fusing the passes is later work, as are wgmma and TMA.
//
// C entry point: nsp_lora_bwd_bf16 (below). It returns cudaGetLastError()
// after the launches; 0 means the kernels were queued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTokTile = 64;    // tokens per CTA in t1u, 16 per warp
constexpr int kTile = 64;       // atb output tile (rows and columns)
constexpr int kSlice = 64;      // tokens per shared-memory slice in atb
constexpr int kChunk = 2048;    // tokens per atb partial sum
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
      mma_16816(acc[nt], a, b0, b1);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. t1 = dy B^T, u = x A per 64-token tile; bf16 copies and partial dE.
// ---------------------------------------------------------------------------
template <int RP>
__global__ void __launch_bounds__(kThreads)
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
  for (int c = threadIdx.x; c < RP; c += kThreads) {
    de_part[static_cast<long long>(blockIdx.x) * RP + c] =
        de_s[0][c] + de_s[1][c] + de_s[2][c] + de_s[3][c];
  }
}

// ---------------------------------------------------------------------------
// 2. part[chunk][m][j] = sum over the chunk's tokens of X[t][m] Y[t][j], for
//    X [N, M] and Y [N, J] bf16 row-major (M and J multiples of 8).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
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
    for (int i = threadIdx.x; i < kSlice * (kTile / 8); i += kThreads) {
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
        mma_16816(acc[nt], a, b0, b1);
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
__global__ void lora_reduce_kernel(const float* __restrict__ part, int n_parts,
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

void reduce(const float* part, int n_parts, long long part_size, int rows,
            int cols_in, int cols_out, float* out, cudaStream_t stream) {
  const long long size = static_cast<long long>(rows) * cols_out;
  const int blocks = static_cast<int>(std::min((size + 255) / 256, 4096LL));
  lora_reduce_kernel<<<blocks, 256, 0, stream>>>(part, n_parts, part_size, rows,
                                                 cols_in, cols_out, out);
}

template <int RP>
void launch(const __nv_bfloat16* x, const __nv_bfloat16* dy,
            const __nv_bfloat16* at, const __nv_bfloat16* b, int n, int din,
            int dout, int rank, __nv_bfloat16* t1b, __nv_bfloat16* ub,
            float* de_part, float* da_part, float* db_part, float* da,
            float* db, float* de, cudaStream_t stream) {
  const int tiles = (n + kTokTile - 1) / kTokTile;
  const int chunks = (n + kChunk - 1) / kChunk;
  lora_t1u_kernel<RP><<<tiles, kThreads, 0, stream>>>(
      x, dy, at, b, t1b, ub, de_part, n, din, dout, rank);
  // dA partials: X = x [N, din], Y = bf16(t1) [N, RP]
  lora_atb_kernel<<<dim3((din + kTile - 1) / kTile, (RP + kTile - 1) / kTile,
                         chunks), kThreads, 0, stream>>>(x, t1b, da_part, n,
                                                         din, RP);
  // dB partials: X = bf16(u) [N, RP], Y = dy [N, dout]
  lora_atb_kernel<<<dim3((RP + kTile - 1) / kTile, (dout + kTile - 1) / kTile,
                         chunks), kThreads, 0, stream>>>(ub, dy, db_part, n,
                                                         RP, dout);
  reduce(da_part, chunks, 1LL * din * RP, din, RP, rank, da, stream);
  reduce(db_part, chunks, 1LL * RP * dout, rank, dout, dout, db, stream);
  reduce(de_part, tiles, RP, 1, RP, rank, de, stream);
}

}  // namespace

// x [N, din], dy [N, dout], at = A^T [rank, din], b = B [rank, dout]: bf16,
// contiguous, din and dout multiples of 16, 1 <= rank <= rp, rp in {16, 32,
// 64}. Scratch (caller-allocated): t1b, ub [N, rp] bf16; de_part [ceil(N /
// 64), rp], da_part [ceil(N / 2048), din, rp], db_part [ceil(N / 2048), rp,
// dout] f32. Outputs: da [din, rank], db [rank, dout], de [rank] f32.
extern "C" int nsp_lora_bwd_bf16(const void* x, const void* dy, const void* at,
                                 const void* b, int n, int din, int dout,
                                 int rank, int rp, void* t1b, void* ub,
                                 void* de_part, void* da_part, void* db_part,
                                 void* da, void* db, void* de, void* stream) {
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
      launch<16>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep, dap, dbp,
                 da_, db_, de_, s);
      break;
    case 32:
      launch<32>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep, dap, dbp,
                 da_, db_, de_, s);
      break;
    case 64:
      launch<64>(x_, dy_, at_, b_, n, din, dout, rank, t1b_, ub_, dep, dap, dbp,
                 da_, db_, de_, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
