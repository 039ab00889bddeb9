// Full-row attention forward probe for Hopper (sm_90a) on bf16 tensors.
//
// Replaces the Pallas TPU tuning probes of the flash forward (P-fwd):
//   perf/kernel_probe.py::make_kernel (modes), ::make_online (n_kb column
//   blocks), ::make_semantics (grid hints); perf/mxu_probe.py::make_fwd
//   (q sub-tiles); perf/btc_probe.py::make_fwd_btc, ::make_fwd_btc_sem
//   ([B, T, H*D] layout, lse out).
// Per (batch*head) and query row, over TK keys of which t_valid are kept:
//   s   = q k^T * D^-1/2 (f32), columns >= t_valid set to -1e30 (not NOMASK)
//   m   = row max of s, p = f(s - m), l = rowsum(p)
//   o   = (bf16(p) v) / l  (f32 accumulation, o rounded to bf16 once)
//   lse = m + log(l)        (optional)
// with f = exp (BASE, NOMASK), x * 0.001 + 1 (NOEXP), or
// bf16(exp(bf16(x))) widened to f32 (BF16EXP). With n_kb > 1 the columns are
// taken in n_kb blocks with an online softmax (running max m, l and the
// accumulator rescaled by exp(m_old - m_new)), as make_online does.
//
// What bounds it: at B*H = 512, TK = 1536, D = 64 and 1500 kept columns the
// two products are 4 * 512 * 1536 * 1500 * 64 = 302 GFLOP against 403 MB of
// q, k, v, o: the tensor cores (0.305 ms at 989 TFLOP/s), not the bytes.
//
// Design. The TPU block held block_q rows of scores over all 1536 columns and
// the whole K/V in VMEM; a Hopper block has 227 KB of shared memory. So a CTA
// of four warps owns R query rows and keeps their f32 scores over one column
// block (TK / n_kb keys) in shared memory: R * (TK / n_kb) * 4 B, 192 KB at
// R = 32, n_kb = 1 (dynamic shared memory, opted in per launch). Phases per
// column block:
//   1. QK: K streamed through shared memory in 64-row tiles; each warp holds
//      its 16 q rows as mma.sync A fragments and writes scaled, masked
//      scores for its share of the tile's columns.
//   2. softmax, per sub-tile of R / N_SUB rows: exact row max over the block,
//      p = f(s - m) written back in place, row sum; running stats in shared
//      memory.
//   3. PV, per sub-tile: acc += bf16(p) V with V streamed in 32-row tiles
//      into the sub-tile's own buffer.
// N_SUB > 1 (make_fwd's n_sub) gives each sub-tile its own warps and named
// barrier after the block-wide QK phase, so one sub-tile's exp overlaps
// another's PV products; the output is the same for every N_SUB. A sub-tile
// of 8 rows runs its PV products on half-filled 16-row fragments.
// The grid is 1-D; `order` picks its raster: 0 head-major (consecutive CTAs
// are one head's q blocks and share its K/V in L2), 1 q-block-major
// (consecutive CTAs are the same q block of different heads). That order is
// what a Mosaic dimension_semantics hint can change on the TPU; the output
// does not depend on it.
//
// C entry point: nsp_probe_fwd_bf16, below. Returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for an instance that is not built).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKTile = 64;    // K rows per QK tile
constexpr int kVTile = 32;    // V rows per PV tile
constexpr int kPad = 8;       // bf16 row padding of the K/V tiles
constexpr int kSPad = 4;      // f32 row padding of the score rows
constexpr float kNegInf = -1e30f;  // the probes' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { BASE = 0, NOMASK = 1, NOEXP = 2, BF16EXP = 3 };

struct Strides {
  long long b, h, t;  // in elements; the head dim is contiguous
};

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

// Barrier over the nthreads threads of one sub-tile (id 1..3), the whole CTA
// (nthreads == kThreads) or one warp.
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  if (nthreads == kThreads) {
    __syncthreads();
  } else if (nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
  }
}

// rows [row0, row0 + ROWS) of one head into shared memory, 16-byte loads by
// `nthreads` threads, this one being number `tid` of them
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kD + kPad],
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int tid, int nthreads) {
  constexpr int kChunks = kD / 8;
  for (int i = tid; i < ROWS * kChunks; i += nthreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
  }
}

template <int MODE>
__device__ __forceinline__ float prob(float x) {
  if constexpr (MODE == NOEXP) {
    return x * 0.001f + 1.0f;
  } else if constexpr (MODE == BF16EXP) {
    const float xb = __bfloat162float(__float2bfloat16(x));
    return __bfloat162float(__float2bfloat16(exp2f(xb * kLog2e)));
  } else {
    return exp2f(x * kLog2e);
  }
}

template <int R, int NSUB>
struct Layout {
  static constexpr int kRG = R / 16;             // 16-row groups of the QK phase
  static constexpr int kQKSplit = kWarps / kRG;  // warps per row group (QK)
  static constexpr int kSR = R / NSUB;           // rows per sub-tile
  static constexpr int kWS = kWarps / NSUB;      // warps per sub-tile
  static constexpr int kRW = kSR < 16 ? kSR : 16;  // rows per PV fragment
  static constexpr int kPVGroups = kSR / kRW;    // fragments per sub-tile
  static constexpr int kPVSplit = kWS / kPVGroups;  // warps per fragment
  static constexpr int kND = kD / kPVSplit;      // head-dim columns per warp
  static_assert(kRG >= 1 && kRG <= kWarps, "R must be 16 or 32");
  static_assert(kWS >= 1 && kPVGroups >= 1 && kPVSplit >= 1, "bad N_SUB");
  static constexpr int kTileBytes =
      (kKTile > NSUB * kVTile ? kKTile : NSUB * kVTile) * (kD + kPad) * 2;
};

template <int R, int NSUB>
size_t smem_bytes(int kb) {
  return static_cast<size_t>(R) * (kb + kSPad) * 4 + 3 * R * 4 +
         Layout<R, NSUB>::kTileBytes;
}

template <int MODE, int R, int NSUB>
__global__ void __launch_bounds__(kThreads)
probe_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int n_bh, int n_heads, int tk, int t_valid, int n_kb,
                 int order, Strides st, float scale) {
  using L = Layout<R, NSUB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = tk / n_kb;
  const int pitch = kb + kSPad;
  float* s_buf = reinterpret_cast<float*>(smem);
  float* m_s = s_buf + R * pitch;
  float* l_s = m_s + R;
  float* c_s = l_s + R;
  unsigned char* tiles = reinterpret_cast<unsigned char*>(c_s + R);
  auto k_s = reinterpret_cast<__nv_bfloat16(*)[kD + kPad]>(tiles);

  const int n_qb = tk / R;
  int qb, bh;
  if (order == 0) {
    qb = blockIdx.x % n_qb;
    bh = blockIdx.x / n_qb;
  } else {
    bh = blockIdx.x % n_bh;
    qb = blockIdx.x / n_bh;
  }
  const int batch = bh / n_heads, head = bh % n_heads;
  const long long base = batch * st.b + head * st.h;
  q += base;
  k += base;
  v += base;
  o += base;
  const int q0 = qb * R;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;

  for (int i = threadIdx.x; i < R; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // QK phase: this warp's row group and share of each K tile's n-tiles
  const int qk_rg = warp / L::kQKSplit;
  const int qk_cs = warp % L::kQKSplit;
  constexpr int kNT = (kKTile / 8) / L::kQKSplit;
  const int qk_lo = qk_rg * 16 + g;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tg * 2;
    qf[kk][0] = load_u32(q + (q0 + qk_lo) * st.t + c);
    qf[kk][1] = load_u32(q + (q0 + qk_lo + 8) * st.t + c);
    qf[kk][2] = load_u32(q + (q0 + qk_lo) * st.t + c + 8);
    qf[kk][3] = load_u32(q + (q0 + qk_lo + 8) * st.t + c + 8);
  }

  // PV phase: this warp's sub-tile, rows and head-dim columns
  const int sub = warp / L::kWS;
  const int wi = warp % L::kWS;
  const int pv_row0 = sub * L::kSR + (wi / L::kPVSplit) * L::kRW;
  const int d0 = (wi % L::kPVSplit) * L::kND;
  const int r_lo = pv_row0 + g;
  const bool has_hi = L::kRW == 16;
  const int r_hi = r_lo + 8;
  auto v_s = reinterpret_cast<__nv_bfloat16(*)[kD + kPad]>(
      tiles + sub * kVTile * (kD + kPad) * 2);
  const int grp_threads = L::kWS * 32;
  const int grp_tid = threadIdx.x - sub * grp_threads;

  float acc[L::kND / 8][4];
#pragma unroll
  for (int nd = 0; nd < L::kND / 8; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  __syncthreads();

  for (int cb = 0; cb < n_kb; ++cb) {
    const int kb0 = cb * kb;
    // 1. scores of all R rows over this column block
    for (int j = 0; j < kb / kKTile; ++j) {
      load_tile<kKTile>(k_s, k, st.t, kb0 + j * kKTile, threadIdx.x, kThreads);
      __syncthreads();
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int nt = qk_cs * kNT + n;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const __nv_bfloat16* kr = &k_s[nt * 8 + g][kk * 16 + tg * 2];
          mma_16816(c, qf[kk], load_u32(kr), load_u32(kr + 8));
        }
        const int col = j * kKTile + nt * 8 + tg * 2;  // within the block
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[e] *= scale;
          if (MODE != NOMASK && kb0 + col + (e & 1) >= t_valid) c[e] = kNegInf;
        }
        *reinterpret_cast<float2*>(&s_buf[qk_lo * pitch + col]) =
            make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(&s_buf[(qk_lo + 8) * pitch + col]) =
            make_float2(c[2], c[3]);
      }
      __syncthreads();
    }

    // 2. softmax of this sub-tile's rows over the block
    for (int i = wi; i < L::kSR; i += L::kWS) {
      const int r = sub * L::kSR + i;
      float* row = s_buf + r * pitch;
      float mx = kNegInf;
      for (int c = lane; c < kb; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kb; c += 32) {
        const float p = prob<MODE>(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float corr = exp2f((m_old - m_new) * kLog2e);
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
        m_s[r] = m_new;
      }
    }
    group_sync(1 + sub, grp_threads);

    // 3. acc = acc * corr + bf16(p) V for this warp's rows and columns
    const float corr_lo = c_s[r_lo];
    const float corr_hi = has_hi ? c_s[r_hi] : 0.f;
#pragma unroll
    for (int nd = 0; nd < L::kND / 8; ++nd) {
      acc[nd][0] *= corr_lo;
      acc[nd][1] *= corr_lo;
      acc[nd][2] *= corr_hi;
      acc[nd][3] *= corr_hi;
    }
    const float* p_lo = s_buf + r_lo * pitch;
    const float* p_hi = s_buf + (has_hi ? r_hi : r_lo) * pitch;
    for (int j = 0; j < kb / kVTile; ++j) {
      load_tile<kVTile>(v_s, v, st.t, kb0 + j * kVTile, grp_tid, grp_threads);
      group_sync(1 + sub, grp_threads);
#pragma unroll
      for (int kk = 0; kk < kVTile / 16; ++kk) {
        const int c = j * kVTile + kk * 16 + tg * 2;
        const float2 lo0 = *reinterpret_cast<const float2*>(p_lo + c);
        const float2 lo1 = *reinterpret_cast<const float2*>(p_lo + c + 8);
        const float2 hi0 = *reinterpret_cast<const float2*>(p_hi + c);
        const float2 hi1 = *reinterpret_cast<const float2*>(p_hi + c + 8);
        const uint32_t a[4] = {
            pack_f32x2(lo0.x, lo0.y),
            has_hi ? pack_f32x2(hi0.x, hi0.y) : 0u,
            pack_f32x2(lo1.x, lo1.y),
            has_hi ? pack_f32x2(hi1.x, hi1.y) : 0u,
        };
        const int r = kk * 16 + tg * 2;
#pragma unroll
        for (int nd = 0; nd < L::kND / 8; ++nd) {
          const int cc = d0 + nd * 8 + g;
          const uint32_t b0 = pack_bf16x2(v_s[r][cc], v_s[r + 1][cc]);
          const uint32_t b1 = pack_bf16x2(v_s[r + 8][cc], v_s[r + 9][cc]);
          mma_16816(acc[nd], a, b0, b1);
        }
      }
      group_sync(1 + sub, grp_threads);
    }
    __syncthreads();  // the next block's scores and K tiles reuse the buffers
  }

  const float l_lo = l_s[r_lo];
  const float l_hi = has_hi ? l_s[r_hi] : 1.f;
#pragma unroll
  for (int nd = 0; nd < L::kND / 8; ++nd) {
    const int c = d0 + nd * 8 + tg * 2;
    *reinterpret_cast<uint32_t*>(o + (q0 + r_lo) * st.t + c) =
        pack_f32x2(acc[nd][0] / l_lo, acc[nd][1] / l_lo);
    if (has_hi) {
      *reinterpret_cast<uint32_t*>(o + (q0 + r_hi) * st.t + c) =
          pack_f32x2(acc[nd][2] / l_hi, acc[nd][3] / l_hi);
    }
  }
  if (lse != nullptr && d0 == 0 && tg == 0) {
    float* lse_row = lse + static_cast<long long>(bh) * tk + q0;
    lse_row[r_lo] = m_s[r_lo] + logf(l_lo);
    if (has_hi) lse_row[r_hi] = m_s[r_hi] + logf(l_hi);
  }
}

template <int MODE, int R, int NSUB>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int n_bh, int n_heads, int tk, int t_valid, int n_kb, int order,
           Strides st, float scale, cudaStream_t stream) {
  auto kern = probe_fwd_kernel<MODE, R, NSUB>;
  const size_t bytes = smem_bytes<R, NSUB>(tk / n_kb);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<n_bh * (tk / R), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n_bh, n_heads, tk, t_valid, n_kb, order, st,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (batch * heads) x tk rows of 64 bf16, row r of head (b, h) at
// b * s_b + h * s_h + r * s_t (elements; rows 16-byte aligned). lse: null or
// [batch * heads, tk] f32. The built instances: every mode at (rows, n_sub)
// = (16, 1) and (32, 1); BASE also at (32, 2) and (32, 4). The
// caller checks tk % rows == 0, tk % (64 * n_kb) == 0 and the shared memory
// (ops/probe_fwd.py::smem_bytes, the same sum as smem_bytes above).
extern "C" int nsp_probe_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int n_bh, int n_heads,
                                  int tk, int t_valid, int mode, int rows,
                                  int n_sub, int n_kb, int order,
                                  long long s_b, long long s_h, long long s_t,
                                  float scale, void* stream) {
  const Strides st{s_b, s_h, s_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NSP_ARGS q, k, v, o, lse, n_bh, n_heads, tk, t_valid, n_kb, order, st, scale, s
  if (n_sub == 1 && (rows == 16 || rows == 32)) {
    switch (mode * 2 + (rows == 32)) {
      case BASE * 2: return launch<BASE, 16, 1>(NSP_ARGS);
      case BASE * 2 + 1: return launch<BASE, 32, 1>(NSP_ARGS);
      case NOMASK * 2: return launch<NOMASK, 16, 1>(NSP_ARGS);
      case NOMASK * 2 + 1: return launch<NOMASK, 32, 1>(NSP_ARGS);
      case NOEXP * 2: return launch<NOEXP, 16, 1>(NSP_ARGS);
      case NOEXP * 2 + 1: return launch<NOEXP, 32, 1>(NSP_ARGS);
      case BF16EXP * 2: return launch<BF16EXP, 16, 1>(NSP_ARGS);
      case BF16EXP * 2 + 1: return launch<BF16EXP, 32, 1>(NSP_ARGS);
      default: break;
    }
  } else if (mode == BASE) {
    if (rows == 32 && n_sub == 2) return launch<BASE, 32, 2>(NSP_ARGS);
    if (rows == 32 && n_sub == 4) return launch<BASE, 32, 4>(NSP_ARGS);
  }
#undef NSP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
