// Matrix product with a fused epilogue for Hopper, sm_90a.
//
// Replaces the TPU kernel `_mm_epi_kernel` / `matmul_epilogue` of
// src/repro/kernels/matmul_epilogue.py (epilogue `_epilogue_f32`).  Same
// function:
//   x [M,K], w [K,N] (bias [N]) -> out [M,N] = epilogue(x @ w) in out's type,
//   the product accumulated in fp32 over K, the epilogue applied in fp32 to
//   the accumulator before the single write:
//     none; bias (acc + bias); silu (acc * sigmoid(acc)); gelu, the tanh
//     form; layernorm over the full row, affine-free, eps 1e-6, the mean
//     first and then the variance of the centred values.
//   Cast sinking rides the same write: out may be fp32 for bf16 inputs (the
//   serving head's fp32 logits) or bf16 for fp32 inputs.
//
// The TPU kernel walks a sequential K axis of the grid with an fp32 VMEM
// accumulator.  Here every body keeps its accumulator in registers and loops
// over K inside the block (or, in the small-M body, over a share of K); any
// M, N and K, the ragged edges masked or zero-filled (the TPU kernel asserts
// exact tiling); x and w read through their strides, never copied.  Five
// bodies; the wrapper picks one (`matmul_body` in matmul_epilogue.py) and
// passes its code:
//
//   * wgmma (2): bf16, M > 64, x K-major and w either way round, both and
//     the output describable by TMA tensor maps.  The prefill gates:
//     zamba2 [16384,2560]x[2560,10240] is 8.6e11 flop against 0.47 GB, bound
//     by operations (0.87 ms at 989 TFLOP/s); qwen [16384,1024]x[1024,2816]
//     likewise (0.096 ms).  Persistent blocks, one an SM, walk output tiles
//     of 128 x 256 (128 x 128 for fp32 out) in grouped order so that the
//     blocks in flight share slabs of x and w in L2.  One producer thread
//     keeps a ring of 64-deep K stages full by TMA (128-byte swizzle; three
//     stages at 128 x 256, five at 128 x 128); two consumer warpgroups of 64
//     rows each issue wgmma.m64nBNk16 straight from shared memory (w
//     row-major is an MN-major B, a transposed w a K-major B), apply the
//     epilogue to the fp32 registers (silu and gelu through __expf and
//     __fdividef: with the accurate forms the epilogue took longer than the
//     products) and write the tile into a swizzled staging tile, which a
//     TMA store writes while the next tile's loads and products run.  The
//     epilogue itself does not overlap the products.  TMA's zero fill gives
//     ragged M, N and K (x and w both zero past K, so the sum stays exact)
//     and its clipped store the ragged output.  The K loop has no branch
//     around its products: ptxas serializes every wgmma otherwise.
//   * small_m (3): bf16, M <= 64: the decode-step gates and the heads, bound
//     by the bytes of w (zamba2's decode gate 52 MB, 0.016 ms at 3.35 TB/s).
//     A work unit is a slab of w, 64 columns (128 at M <= 8 where 64-column
//     slabs outnumber the blocks the card holds at once), and a share of K;
//     persistent blocks take units in turn, so that at any time they read
//     the same rows of neighbouring slabs, and stream them through a ring
//     of stages that runs on from unit to unit: TMA boxes of 64 rows x 128
//     bytes for a row-major w with 16-byte rows (cp.async by every thread, into
//     the same swizzled layout, for any other w; element-wise only at
//     unaligned edges), x's rows riding along by cp.async.  A TMA box takes
//     one instruction where cp.async takes one a thread; on an H100 it is
//     faster at the heads and equal at the decode gates
//     (tools/matmul_variants.py --small-m).  The products run on the tensor
//     cores with the operands swapped, out^T = w^T x^T (mma.sync.m16n8k16,
//     w^T the 16-row operand, x^T the 8-column one), so no lane multiplies
//     zero rows.  K is split where the slabs alone would leave SMs idle:
//     each unit writes its fp32 sum to a workspace, an arrival counter per
//     slab finds the last unit, which adds the sums in split order (so every
//     run gives the same bits) and applies the epilogue.  No allocation per
//     call (the workspace is the wrapper's, made once per device and
//     stream), and a weight's tensor map is made at its first call and
//     kept.
//   * mma_sync (1): bf16, M > 64 that TMA cannot describe (odd strides,
//     unaligned rows).  mma.sync.m16n8k16 on 128 x 128 tiles, a ring of four
//     cp.async stages of 32, grouped tile order.
//   * layernorm (4): the normalisation needs the whole row: one block takes
//     16 rows and every column, keeps the fp32 rows in shared memory (64
//     bytes a column), and normalises them there.  N <= LN_MAX_N = 3072.
//   * fma (0): fp32, full-fp32 FMA on 16 x 16 threads, an 8 x 8 micro-tile
//     each, no TF32: the reference holds fp32 to rtol 2e-5.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int EPI_NONE = 0, EPI_BIAS = 1, EPI_SILU = 2, EPI_GELU = 3,
              EPI_LAYERNORM = 4;
constexpr float LN_EPS = 1e-6f;
constexpr int LN_MAX_N = 3072;
constexpr int LN_ROWS = 16;

struct Params {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int M, N, K;
  long long x_sm, x_sk;  // strides of x, in elements
  long long w_sk, w_sn;  // strides of w, in elements
  int epilogue;
  int out_f32;    // 1: out is fp32, 0: bf16
  int bias_f32;   // 1: bias is fp32, 0: bf16
  int vec_x;      // x may be read in 16-byte chunks along K
  int vec_w;      // w may be read in 16-byte chunks along N
};

// ---------------------------------------------------------------------------
// epilogue and store
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bias_at(const Params& p, int col) {
  return p.bias_f32 ? static_cast<const float*>(p.bias)[col]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p.bias)[col]);
}

__device__ __forceinline__ float silu(float v, bool fast) {
  return fast ? __fdividef(v, 1.f + __expf(-v)) : v / (1.f + expf(-v));
}

__device__ __forceinline__ float gelu(float v, bool fast) {
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  // tanh u = 1 - 2 / (1 + e^2u): two roundings near u = 0, and 1 or -1
  // where e^2u overflows or vanishes
  const float t = fast ? 1.f - __fdividef(2.f, 1.f + __expf(2.f * u))
                       : tanhf(u);
  return 0.5f * v * (1.f + t);
}

// The elementwise epilogues (not layernorm), in fp32.  FAST, for the bf16
// bodies: silu and gelu through __expf and __fdividef, within a few fp32
// ulps of the accurate forms (the fp32 body keeps those: the reference
// holds fp32 to rtol 2e-5 and the serve check compares fp32 streams).
template <bool FAST = false>
__device__ __forceinline__ float apply_epilogue(const Params& p, float v,
                                                int col) {
  switch (p.epilogue) {
    case EPI_BIAS:
      return v + bias_at(p, col);
    case EPI_SILU:
      return silu(v, FAST);
    case EPI_GELU:
      return gelu(v, FAST);
    default:
      return v;
  }
}

// Writes columns col, col + 1 of one row (v1 only where col + 1 < N).
__device__ __forceinline__ void store_pair(const Params& p, int row, int col,
                                           float v0, float v1) {
  if (row >= p.M || col >= p.N) return;
  const long long at = (long long)row * p.N + col;
  const bool pair = col + 1 < p.N && (p.N % 2 == 0);  // 4/8-byte aligned
  if (p.out_f32) {
    float* o = static_cast<float*>(p.out) + at;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (col + 1 < p.N) o[1] = v1;
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + at;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (col + 1 < p.N) o[1] = __float2bfloat16_rn(v1);
    }
  }
}

__device__ __forceinline__ void store_one(const Params& p, int row, int col,
                                          float v) {
  const long long at = (long long)row * p.N + col;
  if (p.out_f32)
    static_cast<float*>(p.out)[at] = v;
  else
    static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Layernorm of the LN_ROWS fp32 rows in sRow [LN_ROWS][N] and the write.
__device__ void layernorm_rows(const Params& p, const float* sRow, int m0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < LN_ROWS; r += n_warps) {
    const int row = m0 + r;
    if (row >= p.M) continue;  // warp-uniform
    const float* v = sRow + r * p.N;
    float s = 0.f;
    for (int c = lane; c < p.N; c += 32) s += v[c];
    const float mu = warp_sum(s) / p.N;
    float q = 0.f;
    for (int c = lane; c < p.N; c += 32) {
      const float d = v[c] - mu;
      q += d * d;
    }
    const float inv = 1.f / sqrtf(warp_sum(q) / p.N + LN_EPS);
    for (int c = lane; c < p.N; c += 32) store_one(p, row, c, (v[c] - mu) * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stages rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) of a bf16
// matrix with strides (s_row, s_col) into dst[ROWS][LD]; what lies outside
// [0, n_rows) x [0, n_cols) becomes zero.  `vec`: s_col == 1 and every row
// 16-byte aligned, so a chunk of 8 columns wholly inside goes by cp.async.
// SWIZZLE (rows of 64, LD == 64): 16-byte chunk c of row r sits at chunk
// c ^ (r % 8), so that ldmatrix over 8 rows is free of bank conflicts
// without padding.  The caller commits and waits.
template <int ROWS, int COLS, int LD, bool SWIZZLE = false>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long s_row,
    long long s_col, int row0, int n_rows, int col0, int n_cols, bool vec) {
  constexpr int CH = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = row0 + r, col = col0 + c;
    __nv_bfloat16* d =
        dst + r * LD + (SWIZZLE ? ((c >> 3) ^ (r & 7)) << 3 : c);
    const bool outside = row >= n_rows || col >= n_cols;
    if (vec && (outside || col + 8 <= n_cols)) {
      const __nv_bfloat16* g = outside ? src : src + row * s_row + col;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(d)),
                   "l"(g), "r"(outside ? 0 : 16));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (row < n_rows && col + e < n_cols)
                   ? src[row * s_row + (long long)(col + e) * s_col]
                   : __float2bfloat16_rn(0.f);
    }
  }
}

// A block tile of BM x BN over 16-deep k-steps of mma.sync, WM x WN warps,
// STAGES K tiles of 32 in flight through cp.async.
template <int BM, int BN, int WM, int WN, int STAGES>
struct MmaTile {
  static constexpr int BK = 32;
  static constexpr int LDA = BK + 8;  // padded rows: ldmatrix is conflict-free
  static constexpr int LDB = BN + 8;
  static constexpr int MT = BM / WM / 16;  // 16-row tiles of a warp
  static constexpr int NT = BN / WN / 8;   // 8-column tiles of a warp
  static constexpr int A_STAGE = BM * LDA;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr size_t SMEM = STAGES * (A_STAGE + B_STAGE) * 2;  // bytes
  static_assert(NT % 2 == 0, "B fragments are loaded two n-tiles at a time");
  static_assert(STAGES >= 2, "at least one tile in flight");

  static __device__ __forceinline__ void load_stage(const Params& p, int m0,
                                                    int n0, int kt,
                                                    __nv_bfloat16* smem) {
    const int stage = kt % STAGES, k0 = kt * BK;
    load_tile_bf16<BM, BK, LDA>(smem + stage * A_STAGE,
                                static_cast<const __nv_bfloat16*>(p.x),
                                p.x_sm, p.x_sk, m0, p.M, k0, p.K, p.vec_x);
    load_tile_bf16<BK, BN, LDB>(smem + STAGES * A_STAGE + stage * B_STAGE,
                                static_cast<const __nv_bfloat16*>(p.w),
                                p.w_sk, p.w_sn, k0, p.K, n0, p.N, p.vec_w);
  }

  // acc <- x[m0:m0+BM, :] @ w[:, n0:n0+BN] over all of K.
  static __device__ __forceinline__ void run(const Params& p, int m0, int n0,
                                             __nv_bfloat16* smem,
                                             float (&acc)[MT][NT][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp / WN, wn = warp % WN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
            0.f;

    // One commit group per K tile, empty ones past the end, so that
    // "all but the newest STAGES - 2 groups done" always means tile kt is in.
    const int nk = (p.K + BK - 1) / BK;
#pragma unroll
    for (int kt = 0; kt < STAGES - 1; ++kt) {
      if (kt < nk) load_stage(p, m0, n0, kt, smem);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();
      // tile kt has landed for everyone, and everyone is done with tile
      // kt - 1, whose stage the next load refills
      __syncthreads();
      if (kt + STAGES - 1 < nk) load_stage(p, m0, n0, kt + STAGES - 1, smem);
      cp_async_commit();
      const int stage = kt % STAGES;
      const __nv_bfloat16* tA = smem + stage * A_STAGE;
      const __nv_bfloat16* tB = smem + STAGES * A_STAGE + stage * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], tA + (wm * MT * 16 + mt * 16 + (lane & 15)) * LDA +
                                  kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bf[4];  // b0, b1 of n-tile nt, then of n-tile nt + 1
          ldmatrix_x4_trans(bf, tB + (kk * 16 + (lane & 15)) * LDB +
                                    wn * NT * 8 + nt * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[mt][nt], af[mt], bf[0], bf[1]);
            mma_16816(acc[mt][nt + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the caller may refill the stages
  }

  // Fragment element e of (mt, nt): row and column within the block tile.
  static __device__ __forceinline__ int row_of(int mt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / WN) * MT * 16 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
  }
  static __device__ __forceinline__ int col_of(int nt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % WN) * NT * 8 + nt * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// Output tiles in groups of GROUP_M tile rows, walked column by column
// inside a group: the blocks in flight at one time share a few row slabs of
// x and column slabs of w, which then stay in the 50 MB L2.
constexpr int GROUP_M = 16;

__device__ __forceinline__ void tile_of(int bid, int n_mt, int n_nt, int& mi,
                                        int& ni) {
  const int per_group = GROUP_M * n_nt;
  const int first = (bid / per_group) * GROUP_M;
  const int rows = min(n_mt - first, GROUP_M);
  mi = first + (bid % per_group) % rows;
  ni = (bid % per_group) / rows;
}

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
mm_epi_bf16(const Params p) {
  using T = MmaTile<BM, BN, WM, WN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int mi, ni;
  tile_of(blockIdx.x, (p.M + BM - 1) / BM, (p.N + BN - 1) / BN, mi, ni);
  const int m0 = mi * BM, n0 = ni * BN;
  float acc[T::MT][T::NT][4];
  T::run(p, m0, n0, reinterpret_cast<__nv_bfloat16*>(smem_raw), acc);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = m0 + T::row_of(mt, 2 * h);
        const int col = n0 + T::col_of(nt, 0);
        const float v0 = apply_epilogue<true>(p, acc[mt][nt][2 * h], col);
        const float v1 =
            col + 1 < p.N
                ? apply_epilogue<true>(p, acc[mt][nt][2 * h + 1], col + 1)
                : 0.f;
        store_pair(p, row, col, v0, v1);
      }
}

// Layernorm: LN_ROWS rows and every column in one block.
__global__ void __launch_bounds__(128) mm_ln_bf16(const Params p) {
  using T = MmaTile<LN_ROWS, 128, 1, 4, 2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sRow = reinterpret_cast<float*>(smem_raw + T::SMEM);
  const int m0 = blockIdx.x * LN_ROWS;
  for (int n0 = 0; n0 < p.N; n0 += 128) {
    float acc[T::MT][T::NT][4];
    T::run(p, m0, n0, tiles, acc);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + T::col_of(nt, e);
        if (col < p.N) sRow[T::row_of(0, e) * p.N + col] = acc[0][nt][e];
      }
  }
  __syncthreads();
  layernorm_rows(p, sRow, m0);
}

// ---------------------------------------------------------------------------
// bf16 body for M <= 64: weight streaming, mma.sync with swapped operands
// ---------------------------------------------------------------------------

constexpr int SM_BK = 64;      // rows of w a stage holds
constexpr int SM_LDX = 64 + 8;  // x's padded rows: conflict-free loads
// Shared memory a block; the ring is as deep as it allows.  At MT = 1, 45
// KB gives four stages and five blocks an SM; PERF.md has the budgets
// tried (tools/matmul_variants.py --small-m).
constexpr int SM_BUDGET = 45 * 1024;
constexpr int SM_MAX_STAGES = 24;

// MT tiles of 8 rows of x (M <= 8 MT), slabs of BN = 64 NT columns of w,
// four warps of 128 threads, each with NT tiles of 16 columns.  w's stages
// sit at 1024-byte boundaries, as the 128-byte swizzle of a TMA box wants;
// a stage holds NT boxes of 64 columns.
template <int MT, int NT>
struct SmallM {
  static constexpr int BN = 64 * NT;
  static constexpr int ROWS = 8 * MT;
  static constexpr int W_BYTES = SM_BK * BN * 2;     // [k][n], swizzled
  static constexpr int X_BYTES = ROWS * SM_LDX * 2;   // [m][k], padded
  static constexpr int FIT =
      (SM_BUDGET - 1024) / (W_BYTES + X_BYTES + 8);
  static constexpr int STAGES =
      FIT < 3 ? 3 : FIT < SM_MAX_STAGES ? FIT : SM_MAX_STAGES;
  static constexpr size_t SMEM = 1024 + STAGES * (W_BYTES + X_BYTES + 8);
};

// Work unit u = slab * splits + split: columns [BN slab, BN (slab + 1)) of w
// over K tiles [split * per, (split + 1) * per).  Block b takes units
// b, b + G, b + 2 G, ...: at any time the blocks read the same rows of
// neighbouring slabs, and the ring of stages runs on from one unit into
// the next.  TMA: thread 0 loads each stage of w as NT boxes of a tensor
// map (64 rows x 128 bytes, 128-byte swizzle, zeros past N and K) that
// complete on the stage's mbarrier; else every thread loads w by cp.async
// into the same swizzled layout.  x's rows ride along in each stage by cp.async.
// Warp v owns columns [16 NT v, 16 NT (v + 1)) of the slab: C[n][m] +=
// A[n][k] B[k][m] with A = w^T (ldmatrix.trans of the [k][n] stage) and
// B = x^T (x's rows as stored), four k16 steps a stage.  With one split a
// unit writes its slab; with more it writes its fp32 sum to
// ws[split][M][N], and the slab's last unit (by the arrival counter) adds
// the splits in order (so every run gives the same bits), applies the
// epilogue, writes out and resets the counter to 0 for the next call.
template <int MT, int NT, bool TMA>
__global__ void __launch_bounds__(128) mm_small_m(
    const __grid_constant__ CUtensorMap wmap, const Params p, int splits,
    float* ws, int* counters) {
  using S = SmallM<MT, NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sW = base;                              // [stage]
  const uint32_t sX = sW + S::STAGES * S::W_BYTES;       // [stage]
  const uint32_t bars = sX + S::STAGES * S::X_BYTES;     // [stage]
  const int nk = (p.K + SM_BK - 1) / SM_BK;
  const int per = (nk + splits - 1) / splits;
  const int units = (p.N + S::BN - 1) / S::BN * splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  if (TMA) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S::STAGES; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // A cursor over this block's steps: unit u, K tile kt.
  struct Cursor {
    int u, kt;
  };
  auto first_kt = [&](int u) { return u % splits * per; };
  auto end_kt = [&](int u) { return min(nk, (u % splits + 1) * per); };
  auto advance = [&](Cursor& c) {
    if (++c.kt == end_kt(c.u)) {
      c.u += gridDim.x;
      c.kt = first_kt(c.u);
    }
  };
  Cursor ld{(int)blockIdx.x, first_kt(blockIdx.x)};  // the next stage to load
  int ld_stage = 0;
  auto load_next = [&]() {
    if (ld.u < units) {
      const int k0 = ld.kt * SM_BK, n0 = ld.u / splits * S::BN;
      if constexpr (TMA) {
        if (threadIdx.x == 0) {
          mbar_expect_tx(bars + 8 * ld_stage, S::W_BYTES);
#pragma unroll
          for (int c = 0; c < NT; ++c)
            tma_load_2d(sW + ld_stage * S::W_BYTES + c * 8192, &wmap,
                        bars + 8 * ld_stage, n0 + 64 * c, k0);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NT; ++c)
          load_tile_bf16<SM_BK, 64, 64, true>(
              reinterpret_cast<__nv_bfloat16*>(sbase + ld_stage * S::W_BYTES +
                                               c * 8192),
              w, p.w_sk, p.w_sn, k0, p.K, n0 + 64 * c, p.N, p.vec_w);
      }
      load_tile_bf16<S::ROWS, SM_BK, SM_LDX>(
          reinterpret_cast<__nv_bfloat16*>(sbase + (sX - sW) +
                                           ld_stage * S::X_BYTES),
          x, p.x_sm, p.x_sk, 0, p.M, k0, p.K, p.vec_x);
      advance(ld);
      ld_stage = (ld_stage + 1) % S::STAGES;
    }
    cp_async_commit();  // one group a stage, empty ones past the end
  };
#pragma unroll 1
  for (int j = 0; j < S::STAGES - 1; ++j) load_next();

  float acc[NT][MT][4];
  int stage = 0, it = 0;
  for (Cursor c{(int)blockIdx.x, first_kt(blockIdx.x)}; c.u < units;
       advance(c), stage = (stage + 1) % S::STAGES, ++it) {
    if (c.kt == first_kt(c.u)) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          acc[t][mt][0] = acc[t][mt][1] = acc[t][mt][2] = acc[t][mt][3] = 0.f;
    }
    cp_async_wait<S::STAGES - 2>();
    if (TMA) mbar_wait(bars + 8 * stage, (it / S::STAGES) & 1);
    __syncthreads();
    load_next();
    const unsigned char* tW = sbase + stage * S::W_BYTES;
    const __nv_bfloat16* tX = reinterpret_cast<const __nv_bfloat16*>(
        sbase + (sX - sW) + stage * S::X_BYTES);
#pragma unroll
    for (int kk = 0; kk < SM_BK / 16; ++kk) {
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* r = tX + (8 * mt + g) * SM_LDX + 16 * kk + 2 * q;
        b[mt][0] = *reinterpret_cast<const uint32_t*>(r);
        b[mt][1] = *reinterpret_cast<const uint32_t*>(r + 8);
      }
      const int kr = 16 * kk + (lane >> 4) * 8 + (lane & 7);  // kr % 8: lane
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // 16-byte chunk of the row within its 64-column box, swizzled
        const int col = 16 * (NT * warp + t) + ((lane >> 3) & 1) * 8;
        uint32_t a[4];  // (n 0-7, k 0-7), (n 8-15, k 0-7), then k 8-15
        ldmatrix_x4_trans(a, tW + (col >> 6) * 8192 + kr * 128 +
                                 ((((col & 63) >> 3) ^ (lane & 7)) << 4));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_16816(acc[t][mt], a, b[mt][0], b[mt][1]);
      }
    }
    if (c.kt + 1 != end_kt(c.u)) continue;

    // the unit's last K tile: write out, or hand the sum on
    const int slab = c.u / splits, split = c.u % splits;
    const int n0 = slab * S::BN;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * mt + 2 * q + (e & 1);
          const int col = n0 + 16 * (NT * warp + t) + g + 8 * (e >> 1);
          if (m >= p.M || col >= p.N) continue;
          if (splits == 1)
            store_one(p, m, col, apply_epilogue<true>(p, acc[t][mt][e], col));
          else
            ws[((long long)split * p.M + m) * p.N + col] = acc[t][mt][e];
        }
    if (splits == 1) continue;
    __threadfence();  // the sum is visible before it counts
    __syncthreads();
    if (threadIdx.x == 0)
      is_last = atomicAdd(counters + slab, 1) == splits - 1;
    __syncthreads();
    if (!is_last) continue;
    __threadfence();
    for (int idx = threadIdx.x; idx < p.M * S::BN; idx += blockDim.x) {
      const int m = idx / S::BN, col = n0 + idx % S::BN;
      if (col >= p.N) continue;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        v += __ldcg(ws + ((long long)sp * p.M + m) * p.N + col);
      store_one(p, m, col, apply_epilogue<true>(p, v, col));
    }
    if (threadIdx.x == 0) counters[slab] = 0;
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 body for M > 64: wgmma + TMA, persistent, warp-specialised
// ---------------------------------------------------------------------------
//
// 384 threads: warpgroups 0 and 1 consume, 64 rows of the 128-row tile
// each; warpgroup 2 produces, one thread issuing every TMA load and giving
// its registers to the consumers (setmaxnreg).  Stage s of the ring holds
// x's [128 rows][64 k] (one box) and w's 64 k-rows of the tile's columns:
// four [64 k][64 n] boxes for a row-major w (an MN-major B operand: leading
// offset 8 KB between the boxes, stride offset 1 KB between groups of 8
// k-rows), one [BN n][64 k] box for a transposed w (K-major, as x).  Each
// stage has a "full" mbarrier (the loads' bytes) and an "empty" one (one
// arrival from each consumer warp once its products have read the stage).
// Each consumer warpgroup stages its 64 x BN output in four swizzled boxes
// of 64 rows x 128 bytes; the swizzle makes the writes from the accumulator
// layout free of bank conflicts.

constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384;

struct WgMaps {
  CUtensorMap x, w, out;
};

// As many stages as the 227 KB of shared memory hold beside the two
// staging tiles, at most eight.
template <int BN, bool OUT_F32>
struct WgTile {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = BN * WG_BK * 2;
  static constexpr int OSIZE = OUT_F32 ? 4 : 2;
  static constexpr int BOX_COLS = 128 / OSIZE;     // of a store box
  static constexpr int BOXES = BN / BOX_COLS;      // of 8 KB a warpgroup
  static constexpr int C_BYTES = 64 * BN * OSIZE;  // a warpgroup's
  static constexpr int FIT =
      (232448 - 1024 - 2 * C_BYTES) / (A_BYTES + B_BYTES + 16);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + 2 * C_BYTES + 16 * STAGES;
  static_assert(STAGES >= 2 && SMEM <= 232448, "shared memory");
};

// A box from shared memory out through a 2-D tensor map.
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
// the shared memory of every committed store has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// named barrier 1 + wg over one consumer warpgroup
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both in shared memory; A
// K-major, B K-major (TB = 0) or MN-major (TB = 1).  scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[32][4], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both in shared memory; A
// K-major, B K-major (TB = 0) or MN-major (TB = 1).  scale_d = 0 overwrites D.
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (BN == 256)
    wgmma_n256<TB>(d, da, db, scale_d);
  else
    wgmma_n128<TB>(d, da, db, scale_d);
}

// The epilogue on a warpgroup's accumulator fragment, in place: element
// (j, e) is column col0 + 8 j + (e & 1).  A column past N reads no bias.
template <int R>
__device__ __forceinline__ void epilogue_regs(const Params& p,
                                              float (&d)[R][4], int col0) {
  switch (p.epilogue) {
    case EPI_BIAS:
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = col0 + 8 * j;
        const float b0 = c < p.N ? bias_at(p, c) : 0.f;
        const float b1 = c + 1 < p.N ? bias_at(p, c + 1) : 0.f;
        d[j][0] += b0;
        d[j][1] += b1;
        d[j][2] += b0;
        d[j][3] += b1;
      }
      break;
    case EPI_SILU:
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = silu(d[j][e], true);
      break;
    case EPI_GELU:
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][e] = gelu(d[j][e], true);
      break;
    default:
      break;
  }
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... in the
// grouped order of `tile_of`; producer and consumers walk the same list, and
// the ring's stages and phases run on across tiles, so the producer loads
// the next tile while the consumers finish this one.
template <int BN, bool B_KMAJOR, bool OUT_F32>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mm_epi_wgmma(const __grid_constant__ WgMaps maps, const Params p) {
  using T = WgTile<BN, OUT_F32>;
  constexpr int ST = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // boxes at 1024-byte boundaries, as the 128-byte swizzle wants
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sA = base;                       // [stage]
  const uint32_t sB = sA + ST * T::A_BYTES;       // [stage]
  const uint32_t sC = sB + ST * T::B_BYTES;       // [consumer warpgroup]
  const uint32_t bars = sC + 2 * T::C_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST + s); };
  const int n_mt = (p.M + WG_BM - 1) / WG_BM, n_nt = (p.N + BN - 1) / BN;
  const int n_tiles = n_mt * n_nt;
  const int nk = (p.K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int it = 0;  // stages loaded so far, over all tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int mi, ni;
        tile_of(t, n_mt, n_nt, mi, ni);
        const int m0 = mi * WG_BM, n0 = ni * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(empty(s), (it / ST - 1) & 1);
          mbar_expect_tx(full(s), T::A_BYTES + T::B_BYTES);
          tma_load_2d(sA + s * T::A_BYTES, &maps.x, full(s), kt * WG_BK, m0);
          if constexpr (B_KMAJOR) {
            tma_load_2d(sB + s * T::B_BYTES, &maps.w, full(s), kt * WG_BK,
                        n0);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(sB + s * T::B_BYTES + c * 8192, &maps.w, full(s),
                          n0 + 64 * c, kt * WG_BK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool issuer = (threadIdx.x & 127) == 0;
    const uint32_t a_off = wg * 64 * 128;  // this warpgroup's 64 rows of x
    const uint32_t stage_c = sC + wg * T::C_BYTES;
    unsigned char* stage = smem_raw + (stage_c - smem_addr(smem_raw));
    float acc[BN / 8][4];
    int it = 0;  // stages consumed so far, over all tiles

    // the products of stage `it`; scale_d = 0 on the tile's first
    auto issue = [&](int first) {
      const int s = it % ST;
      mbar_wait(full(s), (it / ST) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < WG_BK / 16; ++ks) {
        const uint64_t da =
            wg_desc(sA + s * T::A_BYTES + a_off + ks * 32, 16, 1024, SW128);
        const uint64_t db =
            B_KMAJOR ? wg_desc(sB + s * T::B_BYTES + ks * 32, 16, 1024, SW128)
                     : wg_desc(sB + s * T::B_BYTES + ks * 2048, 8192, 1024,
                               SW128);
        wgmma_tile<BN, B_KMAJOR ? 0 : 1>(acc, da, db, first ? ks : 1);
      }
      wgmma_commit();
    };

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int mi, ni;
      tile_of(t, n_mt, n_nt, mi, ni);
      const int m0 = mi * WG_BM, n0 = ni * BN;
      // Stage kt's products are issued before stage kt - 1's are waited
      // for; the loop has no branch around them.
      issue(1);
      ++it;
      for (int kt = 1; kt < nk; ++kt) {
        issue(0);
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty((it - 1) % ST));
        ++it;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty((it - 1) % ST));

      // epilogue: fp32 registers -> epilogue -> out's type -> staging
      epilogue_regs(p, acc, n0 + 2 * q);
      if (issuer) bulk_wait_read();  // the last tile's store has left
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + g + 8 * h;  // r % 8 == g
          if constexpr (OUT_F32) {
            // box j / 4 of 32 columns; 16-byte unit 2 (j % 4) + q / 2
            *reinterpret_cast<float2*>(
                stage + (j / 4) * 8192 + r * 128 +
                (((2 * (j % 4) + (q >> 1)) ^ g) << 4) + (q & 1) * 8) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          } else {
            // box j / 8 of 64 columns; 16-byte unit j % 8
            *reinterpret_cast<__nv_bfloat162*>(
                stage + (j / 8) * 8192 + r * 128 + (((j % 8) ^ g) << 4) +
                q * 4) = __floats2bfloat162_rn(acc[j][2 * h],
                                               acc[j][2 * h + 1]);
          }
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if (issuer) {
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c)
          tma_store_2d(&maps.out, stage_c + c * 8192, n0 + c * T::BOX_COLS,
                       m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait_read();
  }
}

// ---------------------------------------------------------------------------
// fp32 body: full-fp32 FMA
// ---------------------------------------------------------------------------

// 16 x 16 threads; thread (ty, tx) owns rows ty + 16 i (i < RM) and columns
// tx + 16 j (j < RN) of a (16 RM) x (16 RN) tile.
template <int RM, int RN>
struct FmaTile {
  static constexpr int BM = 16 * RM, BN = 16 * RN, BK = 16;
  static constexpr size_t SMEM = (BK * BM + BK * BN) * sizeof(float);

  static __device__ __forceinline__ void run(const Params& p, int m0, int n0,
                                             float* smem,
                                             float (&acc)[RM][RN]) {
    const float* x = static_cast<const float*>(p.x);
    const float* w = static_cast<const float*>(p.w);
    float* sAT = smem;            // [BK][BM]: x transposed
    float* sB = smem + BK * BM;   // [BK][BN]
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < p.K; k0 += BK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < BM * BK; idx += blockDim.x) {
        const int r = idx / BK, c = idx % BK;  // k fastest: along x's rows
        const int row = m0 + r, k = k0 + c;
        sAT[c * BM + r] =
            (row < p.M && k < p.K) ? x[row * p.x_sm + k * p.x_sk] : 0.f;
      }
      for (int idx = threadIdx.x; idx < BK * BN; idx += blockDim.x) {
        const int r = idx / BN, c = idx % BN;
        const int k = k0 + r, col = n0 + c;
        sB[r * BN + c] =
            (k < p.K && col < p.N) ? w[k * p.w_sk + col * p.w_sn] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = sAT[kk * BM + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = sB[kk * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(256) mm_epi_f32(const Params p) {
  using T = FmaTile<8, 8>;
  __shared__ __align__(16) float smem[T::SMEM / sizeof(float)];
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
  T::run(p, m0, n0, smem, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.N) store_one(p, row, col, apply_epilogue(p, acc[i][j], col));
    }
  }
}

__global__ void __launch_bounds__(256) mm_ln_f32(const Params p) {
  using T = FmaTile<1, 8>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tiles = reinterpret_cast<float*>(smem_raw);
  float* sRow = reinterpret_cast<float*>(smem_raw + T::SMEM);
  const int m0 = blockIdx.x * LN_ROWS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int n0 = 0; n0 < p.N; n0 += T::BN) {
    float acc[1][8];
    T::run(p, m0, n0, tiles, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.N) sRow[ty * p.N + col] = acc[0][j];
    }
  }
  __syncthreads();
  layernorm_rows(p, sRow, m0);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int BODY_FMA = 0, BODY_MMA_SYNC = 1, BODY_WGMMA = 2,
              BODY_SMALL_M = 3, BODY_LAYERNORM = 4;

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_mma_sync(const Params& p, cudaStream_t stream) {
  using T = MmaTile<128, 128, 2, 4, 4>;
  const long long blocks =
      (long long)((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return launch(mm_epi_bf16<128, 128, 2, 4, 4>, dim3((unsigned)blocks), 256,
                T::SMEM, stream, p);
}

// Once a device (a decode step makes hundreds of these calls): as many
// blocks an SM as shared memory allows, for more bytes in flight.
template <int MT, int NT, bool TMA>
cudaError_t small_m_attributes() {
  static unsigned long long done = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(mm_small_m<MT, NT, TMA>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && SmallM<MT, NT>::SMEM > 48 * 1024)
    err = cudaFuncSetAttribute(mm_small_m<MT, NT, TMA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SmallM<MT, NT>::SMEM);
  if (err == cudaSuccess && dev < 64) done |= 1ULL << dev;
  return err;
}

// The current device's SM count, asked once a device.
cudaError_t device_sms(int& sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64)
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0)
    err = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
  sms = cached[dev];
  return err;
}

// Blocks of the small-M body the current device holds at once, asked once
// a device.
template <int MT, int NT>
cudaError_t small_m_resident(int& resident) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] != 0) {
    resident = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = small_m_attributes<MT, NT, true>();
  if (err == cudaSuccess) err = small_m_attributes<MT, NT, false>();
  if (err == cudaSuccess) err = device_sms(sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mm_small_m<MT, NT, true>, 128, SmallM<MT, NT>::SMEM);
  if (err != cudaSuccess) return err;
  resident = sms * per_sm;
  if (dev < 64) cached[dev] = resident;
  return cudaSuccess;
}

// The slab width, the split of K and the blocks for an M x N x K product.
// At M <= 8, slabs of 128 columns where 64-column slabs alone outnumber the
// blocks the card holds at once (the wide heads), else of 64.  With R
// blocks resident: no split while the slabs number R / 2 or more; else the
// fewest splits (at most one a two K tiles) that give 0.9 R units.  Then as
// few blocks as take the units in ceil(units / R) rounds, so that the
// blocks end together.
constexpr int SM_WIDE_NT = 2;

cudaError_t small_m_plan(int M, int N, int K, int& nt, int& splits,
                         int& blocks) {
  int resident = 0;
  cudaError_t err =
      M <= 8    ? small_m_resident<1, 1>(resident)
      : M <= 16 ? small_m_resident<2, 1>(resident)
      : M <= 32 ? small_m_resident<4, 1>(resident)
                : small_m_resident<8, 1>(resident);
  if (err != cudaSuccess) return err;
  nt = 1;
  if (M <= 8 && (N + 63) / 64 >= resident && SM_WIDE_NT > 1) {
    nt = SM_WIDE_NT;
    err = small_m_resident<1, SM_WIDE_NT>(resident);
    if (err != cudaSuccess) return err;
  }
  const long long slabs = (N + 64 * nt - 1) / (64 * nt);
  const int nk = (K + SM_BK - 1) / SM_BK;
  const int cap = nk / 2 > 1 ? nk / 2 : 1;
  splits = 1;
  if (2 * slabs < resident)
    while (splits < cap && 10 * slabs * splits < 9LL * resident) ++splits;
  const int per = (nk + splits - 1) / splits;
  splits = (nk + per - 1) / per;  // no split left empty
  const long long units = slabs * splits;
  if (units > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long rounds = (units + resident - 1) / resident;
  blocks = (int)((units + rounds - 1) / rounds);
  return cudaSuccess;
}

// The tensor map of a row-major w for the small-M body.  The maps made are
// kept by address and layout: the weights of a decode step are the same
// every step, so a weight's map is made once, not once a call.
int small_m_wmap(const Params& p, CUtensorMap& map) {
  struct Entry {
    CUtensorMap map;
    const void* w;
    long long n, k, stride;
  };
  static Entry cache[64];
  static int next = 0;
  for (const Entry& e : cache)
    if (e.w == p.w && e.n == p.N && e.k == p.K && e.stride == p.w_sk) {
      map = e.map;
      return 0;
    }
  Entry& e = cache[next];
  next = (next + 1) % 64;
  e.w = nullptr;
  const int err = tensor_map_2d(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                p.w, p.N, p.K, p.w_sk * 2, 64, SM_BK);
  if (err != 0) return err;
  e.w = p.w;
  e.n = p.N;
  e.k = p.K;
  e.stride = p.w_sk;
  map = e.map;
  return 0;
}

// w by TMA where it is row-major with 16-byte rows, else by cp.async.
template <int MT, int NT>
int launch_small_m(const Params& p, int splits, int blocks, float* ws,
                   int* counters, cudaStream_t stream) {
  CUtensorMap map{};
  const bool tma = p.vec_w;
  if (tma) {
    const int err = small_m_wmap(p, map);
    if (err != 0) return err;
  }
  cudaError_t err = tma ? small_m_attributes<MT, NT, true>()
                        : small_m_attributes<MT, NT, false>();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = SmallM<MT, NT>::SMEM;
  if (tma)
    mm_small_m<MT, NT, true><<<blocks, 128, smem, stream>>>(map, p, splits,
                                                            ws, counters);
  else
    mm_small_m<MT, NT, false><<<blocks, 128, smem, stream>>>(map, p, splits,
                                                             ws, counters);
  return (int)cudaGetLastError();
}

template <int BN, bool B_KMAJOR, bool OUT_F32>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using T = WgTile<BN, OUT_F32>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  WgMaps maps;
  int err = tensor_map_2d(&maps.x, BF16, p.x, p.K, p.M, p.x_sm * 2, WG_BK,
                          WG_BM);
  if (err == 0)
    err = B_KMAJOR ? tensor_map_2d(&maps.w, BF16, p.w, p.K, p.N, p.w_sn * 2,
                                   WG_BK, BN)
                   : tensor_map_2d(&maps.w, BF16, p.w, p.N, p.K, p.w_sk * 2,
                                   64, WG_BK);
  if (err == 0)
    err = tensor_map_2d(&maps.out,
                        OUT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : BF16,
                        p.out, p.N, p.M, (long long)p.N * T::OSIZE,
                        T::BOX_COLS, 64);
  if (err != 0) return err;
  int sms = 0;  // one block an SM
  const cudaError_t e = device_sms(sms);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((p.M + WG_BM - 1) / WG_BM) * ((p.N + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  return (int)launch(mm_epi_wgmma<BN, B_KMAJOR, OUT_F32>,
                     dim3((unsigned)(tiles < sms ? tiles : sms)), WG_THREADS,
                     T::SMEM, stream, maps, p);
}

}  // namespace

// body: 0 fma (float32 x and w), 1 mma_sync, 2 wgmma + TMA, 3 small_m
// (M <= 64), all three bf16; 4 layernorm (either type, N <= 3072, and the
// only body that takes the layernorm epilogue).  The wrapper chooses it
// (`matmul_body`).  in_dtype: 0 = float32, 1 = bfloat16 (x and w alike);
// out_dtype and bias_dtype likewise.  epilogue: 0 none, 1 bias, 2 silu,
// 3 gelu (tanh), 4 layernorm.  Strides in elements, not negative.  out:
// [M, N] contiguous.  wgmma: x with unit stride along K and w along either
// axis, 16-byte-aligned bases, the other strides and out's rows multiples
// of 16 bytes.  small_m: `slab_tiles` (slabs of 64 slab_tiles columns),
// `splits` and `blocks` as repro_matmul_epilogue_small_m_plan gives them
// for the shape; with more than one split, `workspace` holds
// splits * M * N floats and `counters` one int per slab, all 0 (the
// kernel leaves them 0).
// Returns a cudaError_t, -1 for an unsupported argument or -2 if a tensor
// map cannot be made; never synchronises.
extern "C" int repro_matmul_epilogue(const void* x, const void* w,
                                     const void* bias, void* out, int M,
                                     int N, int K, long long x_sm,
                                     long long x_sk, long long w_sk,
                                     long long w_sn, int epilogue,
                                     int in_dtype, int out_dtype,
                                     int bias_dtype, int body,
                                     int slab_tiles, int splits, int blocks,
                                     void* workspace,
                                     void* counters,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epilogue < EPI_NONE ||
      epilogue > EPI_LAYERNORM)
    return -1;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return -1;
  if (epilogue == EPI_BIAS && (bias == nullptr ||
                               (bias_dtype != 0 && bias_dtype != 1)))
    return -1;
  if ((epilogue == EPI_LAYERNORM) != (body == BODY_LAYERNORM)) return -1;
  if (epilogue == EPI_LAYERNORM && N > LN_MAX_N) return -1;
  const bool bf16_body =
      body == BODY_MMA_SYNC || body == BODY_WGMMA || body == BODY_SMALL_M;
  if ((body == BODY_FMA && in_dtype != 0) || (bf16_body && in_dtype != 1))
    return -1;
  const int esize = in_dtype == 0 ? 4 : 2;
  const long long per16 = 16 / esize;
  Params p{x, w, bias, out, M, N, K, x_sm, x_sk, w_sk, w_sn, epilogue,
           out_dtype == 0 ? 1 : 0, bias_dtype == 0 ? 1 : 0,
           x_sk == 1 && x_sm % per16 == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0,
           w_sn == 1 && w_sk % per16 == 0 &&
               reinterpret_cast<uintptr_t>(w) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case BODY_LAYERNORM: {
      const dim3 grid((M + LN_ROWS - 1) / LN_ROWS);
      const size_t rows = sizeof(float) * LN_ROWS * (size_t)N;
      if (in_dtype == 1)
        return (int)launch(mm_ln_bf16, grid, 128,
                           MmaTile<LN_ROWS, 128, 1, 4, 2>::SMEM + rows, s, p);
      return (int)launch(mm_ln_f32, grid, 256, FmaTile<1, 8>::SMEM + rows, s,
                         p);
    }
    case BODY_FMA: {
      const dim3 grid((M + 127) / 128, (N + 127) / 128);
      if (grid.y > 65535) return -1;
      return (int)launch(mm_epi_f32, grid, 256, 0, s, p);
    }
    case BODY_MMA_SYNC:
      return (int)launch_mma_sync(p, s);
    case BODY_WGMMA: {
      const bool out_f32 = out_dtype == 0;
      const bool w_mn = p.vec_w;  // unit stride along N, rows aligned
      const bool w_k = w_sk == 1 && w_sn % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
      if (!p.vec_x || !(w_mn || w_k) ||
          (long long)N * (out_f32 ? 4 : 2) % 16 != 0)
        return -1;
      if (out_f32)
        return w_mn ? launch_wgmma<128, false, true>(p, s)
                    : launch_wgmma<128, true, true>(p, s);
      return w_mn ? launch_wgmma<256, false, false>(p, s)
                  : launch_wgmma<256, true, false>(p, s);
    }
    case BODY_SMALL_M: {
      const int nk = (K + SM_BK - 1) / SM_BK;
      const int bn = 64 * slab_tiles;
      const long long units = (long long)((N + bn - 1) / bn) * splits;
      if (M > 64 || splits < 1 || splits > nk || blocks < 1 ||
          blocks > units || (slab_tiles != 1 && slab_tiles != SM_WIDE_NT) ||
          (slab_tiles != 1 && M > 8) ||
          (splits > 1 && (workspace == nullptr || counters == nullptr)))
        return -1;
      float* ws = static_cast<float*>(workspace);
      int* cnt = static_cast<int*>(counters);
      if (M <= 8)
        return slab_tiles == 1
                   ? launch_small_m<1, 1>(p, splits, blocks, ws, cnt, s)
                   : launch_small_m<1, SM_WIDE_NT>(p, splits, blocks, ws,
                                                   cnt, s);
      if (M <= 16) return launch_small_m<2, 1>(p, splits, blocks, ws, cnt, s);
      if (M <= 32) return launch_small_m<4, 1>(p, splits, blocks, ws, cnt, s);
      return launch_small_m<8, 1>(p, splits, blocks, ws, cnt, s);
    }
    default:
      return -1;
  }
}

// The small-M body's slab width (in tiles of 64 columns), split of K and
// block count for an M x N x K product (M <= 64) on the current device.
// Returns a cudaError_t or -1.
extern "C" int repro_matmul_epilogue_small_m_plan(int M, int N, int K,
                                                  int* slab_tiles,
                                                  int* splits, int* blocks) {
  if (M <= 0 || M > 64 || N <= 0 || K <= 0) return -1;
  return (int)small_m_plan(M, N, K, *slab_tiles, *splits, *blocks);
}

extern "C" const char* repro_matmul_epilogue_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
