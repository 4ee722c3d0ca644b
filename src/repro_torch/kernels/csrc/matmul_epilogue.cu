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
// Design for this card, and how it differs from the TPU kernel:
//   * The TPU kernel walks a sequential K axis of the grid with an fp32 VMEM
//     accumulator.  Here one block owns an output tile and loops over K
//     inside itself with the accumulator in registers; blocks run in no
//     order and nothing carries between them.
//   * bf16 body: tensor cores through `mma.sync.m16n8k16` (fp32 accumulate),
//     A fragments from `ldmatrix`, B fragments from `ldmatrix.trans` of a
//     row-major [BK][BN] tile of w, 32-deep K tiles in a ring of four
//     `cp.async` stages (three in flight while one is multiplied); output
//     tiles walked in groups of 16 tile rows so that the blocks in flight
//     share their slabs of x and w in L2.  Tiles of 128 x 128 (8 warps of
//     64 x 32); 64 x 64
//     (4 warps of 32 x 32) when M <= 64, as in a decode step, where the
//     product is bound by the bytes of w and more blocks keep more of the
//     card reading.
//   * fp32 body: full-fp32 FMA on 16 x 16 threads, an 8 x 8 micro-tile each,
//     no TF32: the reference holds fp32 to rtol 2e-5.
//   * Layernorm needs the whole row: one block takes 16 rows and every
//     column, keeps the fp32 rows in shared memory (64 bytes a column), and
//     normalises them there.  N is limited to LN_MAX_N = 3072.
//   * Any M, N and K: the ragged edges are masked in the kernel (rows and
//     columns outside are read as zero and never written).  The TPU kernel
//     asserts exact tiling.
//   * x and w are read through their strides.  A 16-byte chunk goes through
//     `cp.async` when the operand has unit stride along its row, 16-byte
//     aligned rows and the chunk lies wholly inside; otherwise (an edge, a
//     transposed w such as a tied embedding) it is read element by element.
//     No operand is ever copied.
//
// What bounds it on this card: the gate of zamba2's MLP at M = 16384,
// K = 2560, N = 10240 in bf16 is 8.6e11 flop against 0.47 GB, bound by
// operations (0.87 ms at 989 TFLOP/s); the serving head at M = 8 is bound by
// the bytes of w.  This first body uses `mma.sync`, not `wgmma` and TMA, so
// it cannot reach the tensor cores' full rate; that is later work.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// The elementwise epilogues (not layernorm), in fp32.
__device__ __forceinline__ float apply_epilogue(const Params& p, float v,
                                                int col) {
  switch (p.epilogue) {
    case EPI_BIAS:
      return v + (p.bias_f32
                      ? static_cast<const float*>(p.bias)[col]
                      : __bfloat162float(
                            static_cast<const __nv_bfloat16*>(p.bias)[col]));
    case EPI_SILU:
      return v / (1.f + expf(-v));
    case EPI_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
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
// The caller commits and waits.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* src, long long s_row,
    long long s_col, int row0, int n_rows, int col0, int n_cols, bool vec) {
  constexpr int CH = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int row = row0 + r, col = col0 + c;
    __nv_bfloat16* d = dst + r * LD + c;
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
        const float v0 = apply_epilogue(p, acc[mt][nt][2 * h], col);
        const float v1 = col + 1 < p.N
                             ? apply_epilogue(p, acc[mt][nt][2 * h + 1], col + 1)
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int threads,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using T = MmaTile<BM, BN, WM, WN, STAGES>;
  const long long blocks =
      (long long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return launch(mm_epi_bf16<BM, BN, WM, WN, STAGES>, p, dim3((unsigned)blocks),
                WM * WN * 32, T::SMEM, stream);
}

}  // namespace

// in_dtype: 0 = float32, 1 = bfloat16 (x and w alike); out_dtype and
// bias_dtype likewise.  epilogue: 0 none, 1 bias, 2 silu, 3 gelu (tanh),
// 4 layernorm (N <= 3072).  Strides in elements, not negative.
// out: [M, N] contiguous.  Returns a cudaError_t, or -1 for an unsupported
// argument; never synchronises.
extern "C" int repro_matmul_epilogue(const void* x, const void* w,
                                     const void* bias, void* out, int M,
                                     int N, int K, long long x_sm,
                                     long long x_sk, long long w_sk,
                                     long long w_sn, int epilogue,
                                     int in_dtype, int out_dtype,
                                     int bias_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epilogue < EPI_NONE ||
      epilogue > EPI_LAYERNORM)
    return -1;
  if ((in_dtype != 0 && in_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return -1;
  if (epilogue == EPI_BIAS && (bias == nullptr ||
                               (bias_dtype != 0 && bias_dtype != 1)))
    return -1;
  if (epilogue == EPI_LAYERNORM && N > LN_MAX_N) return -1;
  const int esize = in_dtype == 0 ? 4 : 2;
  const long long per16 = 16 / esize;
  Params p{x, w, bias, out, M, N, K, x_sm, x_sk, w_sk, w_sn, epilogue,
           out_dtype == 0 ? 1 : 0, bias_dtype == 0 ? 1 : 0,
           x_sk == 1 && x_sm % per16 == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0,
           w_sn == 1 && w_sk % per16 == 0 &&
               reinterpret_cast<uintptr_t>(w) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue == EPI_LAYERNORM) {
    const dim3 grid((M + LN_ROWS - 1) / LN_ROWS);
    const size_t rows = sizeof(float) * LN_ROWS * (size_t)N;
    if (in_dtype == 1)
      return (int)launch(mm_ln_bf16, p, grid, 128,
                         MmaTile<LN_ROWS, 128, 1, 4, 2>::SMEM + rows, s);
    return (int)launch(mm_ln_f32, p, grid, 256, FmaTile<1, 8>::SMEM + rows, s);
  }
  if (in_dtype == 1) {
    if (M <= 64) return (int)launch_bf16<64, 64, 2, 2, 4>(p, s);
    return (int)launch_bf16<128, 128, 2, 4, 4>(p, s);
  }
  const dim3 grid((M + 127) / 128, (N + 127) / 128);
  if (grid.y > 65535) return -1;
  return (int)launch(mm_epi_f32, p, grid, 256, 0, s);
}

extern "C" const char* repro_matmul_epilogue_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
