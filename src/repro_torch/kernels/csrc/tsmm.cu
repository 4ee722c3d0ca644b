// tsmm: upper-triangular tiles of G = X^T X + reg * I for Hopper, sm_90a.
//
// Replaces the TPU kernel `_tsmm_kernel` / `tsmm_upper` of
// src/repro/kernels/tsmm.py.  Same function: x [m, n] -> out [n, n] in the
// type of x, where only the 128 x 128 tiles (i, j) with i <= j are written
// (the caller allocates zeros, so the lower-left tiles stay zero), products
// are accumulated over m in fp32, and `reg` is added on the diagonal of the
// i == j tiles before the single write.
//
// Bound: operations, m n (n + 1) flop against m n elements read.  The fp32
// FMA units cap that at 67 TFLOP/s; only the tensor cores go past it, and
// they take tf32 (10 bits of mantissa), too coarse for the reference's fp32
// rtol of 2e-5.  So fp32 runs as 3xTF32: each value is split as
// v = hi + lo, hi = tf32(v), lo = tf32(v - hi) (the subtraction is exact),
// and each tile sums lo.hi + hi.lo + hi.hi with fp32 accumulation; the
// dropped lo.lo is near 2^-22 relative.  A bf16 value is a tf32 value, so
// bf16 runs the same body with one product (P = 1).
//
// Design.  A 1-D grid over the T = nb (nb + 1) / 2 upper tiles times
// `splits` slices of m; one block on each SM: two consumer warpgroups, 64
// rows of the tile's 128 each, and a producer warp.  X is row-major, so the
// operands of X_i^T X_j are row slabs of X: A = X_i^T is M-major and B = X_j
// is N-major.  wgmma takes tf32 only K-major from shared memory (the
// transpose bit is for 16-bit types), so:
//   * the producer keeps a ring of STAGES slabs full by TMA: 32 rows of the
//     two column blocks (one for a diagonal tile), boxes of 32 rows x 128
//     bytes with the 128-byte swizzle;
//   * B: each of the 8 consumer warps splits its eighth of the slab of
//     block j into K-major hi and lo tiles in the 128-byte swizzle (32 tf32
//     along K are one 128-byte row), in a ring of SB, while the products of
//     the slab before run;
//   * A: each thread loads its wgmma register fragment straight from the
//     staging tile and splits it in registers.  The fragment's row r reads
//     column pi(r) of the block (`a_row`), a permutation under which the
//     loads of a warp hit 32 distinct banks; the epilogue writes row pi(r);
//   * a slab is 4 k-steps of wgmma.m64n128k8 (x 3 products for fp32), A from
//     registers, B by descriptor.  The products of slab s + 1 start
//     before those of slab s are waited for.
// mbarriers pace it all (a stage landed / read; a split tile written /
// read), so the two warpgroups may drift apart by up to SB - 1 slabs and
// never wait for each other at a block-wide barrier.  The tensor cores add into their
// fp32 accumulator with truncation, which over a long sum biases it; so the
// products of PROMOTE slabs are summed on the tensor cores and then added
// into a second accumulator with fp32 FADD (round to nearest).
//
// X is tall and skinny, so T alone is far fewer blocks than the card has SMs
// (n = 1024 gives 36).  The wrapper therefore splits m into `splits` slices
// (grid T x splits): each block then writes its fp32 partial tile to a
// workspace and a second small kernel sums the slices in a fixed order, adds
// `reg`, casts and writes each output element once.  The result does not
// depend on the order in which blocks run (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int TN = 128;       // output tile edge
constexpr int TK = 32;        // rows of X a slab
constexpr int STAGES = 4;     // slabs in the ring
constexpr int PROMOTE = 2;    // slabs summed on the tensor cores before FADD
constexpr int SB = 3;         // split B tiles in their ring
constexpr int THREADS = 384;  // two consumer warpgroups, a producer warp
constexpr int BOX = TK * 128;             // bytes of a TMA box
constexpr int STAGE = 2 * TN * TK * 4;    // two column blocks of fp32
constexpr int SPLIT = 2 * TN * TK * 4;    // hi and lo tiles of B
constexpr size_t SMEM =
    1024 + STAGES * STAGE + SB * SPLIT + 16 * (STAGES + SB);
static_assert(SMEM <= 232448, "shared memory");

__device__ __forceinline__ void tile_pair(int t, int nb, int& i, int& j) {
  int row = 0, rem = t;
  while (rem >= nb - row) {
    rem -= nb - row;
    ++row;
  }
  i = row;
  j = row + rem;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo in tf32, both rounded to nearest with ties away from zero.
// hi by the integer add and mask that cvt.rna compiles to, without the
// select that keeps inf and NaN out of the add: a NaN v may give any hi,
// but then lo is NaN and carries it into the products.  A bf16 v is its
// own hi (its low 16 bits are zero), so one product needs no lo.
template <int P>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = P == 3 ? tf32(v - __uint_as_float(hi)) : 0u;
}

// Element (k, n) of a column block's slab in the staging ring: boxes of 128
// bytes along n, 128-byte swizzle (16-byte unit u of row k at u ^ (k % 8)).
template <typename T>
__device__ __forceinline__ float staged(const unsigned char* blk, int k,
                                        int n) {
  constexpr int EPB = 128 / sizeof(T);
  const int byte = (n % EPB) * (int)sizeof(T);
  return to_float(*reinterpret_cast<const T*>(
      blk + (n / EPB) * BOX + k * 128 + (((byte >> 4) ^ (k & 7)) << 4) +
      (byte & 15)));
}

// Column of the block that row 16 w + 8 h + g of a warpgroup's A fragment
// reads: rows g = 0..7 of one register spread over both halves of a box and
// over 4 of its 16-byte units, so that with the swizzle the 32 lanes (g and
// k = t or t + 4) hit 32 distinct banks.
__device__ __forceinline__ int a_row(int w, int h, int g) {
  return 32 * (w >> 1) + 16 * (g >> 2) + 4 * (2 * (w & 1) + h) + (g & 3);
}

// This warp's eighth of B of one slab: K-major hi and lo tiles
// [128 n][32 k] in the 128-byte swizzle.  Warp `warp` takes the 16-byte
// unit kc = warp of every row: staging reads of 32 consecutive n, and 8 rows
// a store phase, free of bank conflicts.
template <typename T, int P>
__device__ __forceinline__ void split_b(const unsigned char* blk,
                                        unsigned char* hi, unsigned char* lo,
                                        int warp, int lane) {
  const int kc = warp;
#pragma unroll
  for (int c = 0; c < TN / 32; ++c) {
    const int n = 32 * c + lane;
    uint4 h, l;
    split<P>(staged<T>(blk, 4 * kc, n), h.x, l.x);
    split<P>(staged<T>(blk, 4 * kc + 1, n), h.y, l.y);
    split<P>(staged<T>(blk, 4 * kc + 2, n), h.z, l.z);
    split<P>(staged<T>(blk, 4 * kc + 3, n), h.w, l.w);
    const int off = n * 128 + ((kc ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    if (P == 3) *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// A of one slab for this thread: k-step ks, register e = (row g or g + 8,
// k = 8 ks + t or + 4), as wgmma's tf32 register fragment lays them out.
template <typename T, int P>
__device__ __forceinline__ void load_a(const unsigned char* blk, int col0,
                                       int w, int g, int t,
                                       uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4]) {
  const int c0 = col0 + a_row(w, 0, g), c1 = col0 + a_row(w, 1, g);
#pragma unroll
  for (int ks = 0; ks < TK / 8; ++ks) {
    const int k = 8 * ks + t;
    split<P>(staged<T>(blk, k, c0), hi[ks][0], lo[ks][0]);
    split<P>(staged<T>(blk, k, c1), hi[ks][1], lo[ks][1]);
    split<P>(staged<T>(blk, k + 4, c0), hi[ks][2], lo[ks][2]);
    split<P>(staged<T>(blk, k + 4, c1), hi[ks][3], lo[ks][3]);
  }
}

#define D4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in tf32: A from registers, B
// K-major in shared memory.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %69, p, 1, "
      "1;\n}\n"
      : D4(0), D4(1), D4(2), D4(3), D4(4), D4(5), D4(6), D4(7), D4(8), D4(9),
        D4(10), D4(11), D4(12), D4(13), D4(14), D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(db));
}

#undef D4

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
    tsmm_tc(const __grid_constant__ CUtensorMap map, T* __restrict__ out,
            float* __restrict__ partial, int m, int n, float reg,
            int rows_per_split) {
  constexpr int BLK = TN * TK * sizeof(T);  // a column block's slab
  constexpr int EPB = 128 / sizeof(T);      // elements of a box row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // boxes and tiles at 1024-byte boundaries, as the 128-byte swizzle wants
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t s_split = base + STAGES * STAGE;  // [SB][hi, lo]
  const uint32_t bars = s_split + SB * SPLIT;
  // Each with one arrival from each of the 8 consumer warps, but `full`:
  // slab landed (TMA bytes); slab read (its A fragments and its B split);
  // B split; B read by the products
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto sfull = [&](int b) { return bars + 8 * (2 * STAGES + b); };
  auto sempty = [&](int b) { return bars + 8 * (2 * STAGES + SB + b); };

  const int nb = (n + TN - 1) / TN;
  int ti, tj;
  tile_pair(blockIdx.x, nb, ti, tj);
  const bool diag = ti == tj;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  const int nslab = r_end > r_begin ? (r_end - r_begin + TK - 1) / TK : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    for (int b = 0; b < SB; ++b) {
      mbar_init(sfull(b), 8);
      mbar_init(sempty(b), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: slab `it` into stage it % STAGES once the stage is read;
    // rows past m read as zero.  Rows past the slice's end are never asked
    // for: slices are whole slabs.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int it = 0; it < nslab; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), (it / STAGES - 1) & 1);
        const uint32_t dst = base + s * STAGE;
        const int r0 = r_begin + it * TK;
        mbar_expect_tx(full(s), (diag ? 1 : 2) * BLK);
#pragma unroll
        for (int b = 0; b < BLK / BOX; ++b) {
          tma_load_2d(dst + b * BOX, &map, full(s), ti * TN + b * EPB, r0);
          if (!diag)
            tma_load_2d(dst + BLK + b * BOX, &map, full(s), tj * TN + b * EPB,
                        r0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[16][4], d[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = d[j][e] = 0.f;
  uint32_t ah[2][4][4], al[2][4][4];  // A of this slab and of the next

  // This warp's share of slab `it`: its part of B into split tile it % SB
  // (once both warpgroups' products have read the slab that used it last),
  // and its A fragment.
  auto prepare = [&](int it, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) {
    const int s = it % STAGES, b = it % SB;
    mbar_wait(full(s), (it / STAGES) & 1);
    if (it >= SB) mbar_wait(sempty(b), (it / SB - 1) & 1);
    const unsigned char* st = sbase + s * STAGE;
    unsigned char* sp = sbase + (s_split - base) + b * SPLIT;
    split_b<T, P>(st + (diag ? 0 : BLK), sp, sp + SPLIT / 2, warp, lane);
    // the split tile to the async proxy of the products
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(sfull(b));
    load_a<T, P>(st, 64 * wg, w, g, t, hi, lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };

  // The products so far, out of the tensor cores' accumulator into acc.
  auto promote = [&]() {
    wgmma_wait<0>();
    fence_acc(d);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += d[j][e];
  };

  // One slab of this warpgroup: its products, then this warp's share of
  // the next slab while they run.  PAR = it % 2 names this slab's A.
  auto step = [&](auto par, int it) {
    constexpr int PAR = decltype(par)::value;
    const int b = it % SB;
    const uint32_t bh = s_split + b * SPLIT;  // hi; lo after it
    mbar_wait(sfull(b), (it / SB) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      const int fresh = ks == 0 && it % PROMOTE == 0;
      const uint64_t dh = wg_desc(bh + 32 * ks, 16, 1024, SW128);
      if constexpr (P == 3) {
        wgmma_tf32(d, al[PAR][ks], dh, !fresh);
        wgmma_tf32(d, ah[PAR][ks],
                   wg_desc(bh + SPLIT / 2 + 32 * ks, 16, 1024, SW128), 1);
        wgmma_tf32(d, ah[PAR][ks], dh, 1);
      } else {
        wgmma_tf32(d, ah[PAR][ks], dh, !fresh);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // slab it - 1's products: its B tile and A are free
    if (it > 0 && lane == 0) mbar_arrive(sempty((it - 1) % SB));
    if (it + 1 < nslab) prepare(it + 1, ah[PAR ^ 1], al[PAR ^ 1]);
    if ((it + 1) % PROMOTE == 0) promote();
  };

  if (nslab > 0) prepare(0, ah[0], al[0]);
  for (int it = 0; it < nslab; it += 2) {
    step(std::integral_constant<int, 0>(), it);
    if (it + 1 < nslab) step(std::integral_constant<int, 1>(), it + 1);
  }
  if (nslab % PROMOTE != 0) promote();  // the products since the last one

  // acc[j][e]: fragment row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2
  const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = 64 * wg + a_row(w, h, g);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int lc = 8 * j + 2 * t;
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (partial != nullptr) {
        // [split][tile][TN][TN] fp32; edge tiles hold zeros beyond n
        *reinterpret_cast<float2*>(partial + tile * (TN * TN) + lr * TN +
                                   lc) = make_float2(v0, v1);
      } else {
        const int gr = ti * TN + lr, gc = tj * TN + lc;
        if (gr < n && gc < n) {  // n % 4 == 0: gc + 1 < n as well
          store1(out + (size_t)gr * n + gc, v0 + (gr == gc ? reg : 0.f));
          store1(out + (size_t)gr * n + gc + 1,
                 v1 + (gr == gc + 1 ? reg : 0.f));
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
tsmm_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                   int n, int n_tiles, int splits, float reg) {
  const int nb = (n + TN - 1) / TN;
  int ti, tj;
  tile_pair(blockIdx.x, nb, ti, tj);
  for (int e = threadIdx.x; e < TN * TN; e += blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s)
      sum += partial[((size_t)s * n_tiles + blockIdx.x) * (TN * TN) + e];
    const int gr = ti * TN + e / TN, gc = tj * TN + e % TN;
    if (gr < n && gc < n)
      store1(out + (size_t)gr * n + gc, sum + ((gr == gc) ? reg : 0.f));
  }
}

template <typename T, int P>
int run(const void* x, void* out, float* workspace, int m, int n,
        long long ldx, float reg, int splits, cudaStream_t stream) {
  const int nb = (n + TN - 1) / TN;
  const int n_tiles = nb * (nb + 1) / 2;
  const int rows_per_split =
      ((m + splits - 1) / splits + TK - 1) / TK * TK;  // whole slabs
  CUtensorMap map;
  const int mapped = tensor_map_2d(
      &map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      x, n, m, ldx * (long long)sizeof(T), 128 / sizeof(T), TK);
  if (mapped != 0) return mapped;
  cudaError_t err = cudaFuncSetAttribute(
      tsmm_tc<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  tsmm_tc<T, P><<<dim3(n_tiles, splits), THREADS, SMEM, stream>>>(
      map, static_cast<T*>(out), splits > 1 ? workspace : nullptr, m, n, reg,
      rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  tsmm_reduce_kernel<T><<<n_tiles, 256, 0, stream>>>(
      workspace, static_cast<T*>(out), n, n_tiles, splits, reg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (products must be 3), 1 = bfloat16 (products 1).
// x: [m, n] with row stride ldx (elements, 16-byte multiple) and unit
// column stride, 16-byte aligned, n % 4 == 0.  out: [n, n] contiguous,
// zero-filled by the caller.  workspace: splits * T * 128 * 128 floats when
// splits > 1, else unused.  Returns a cudaError_t, -1 for an unsupported
// argument or -2 when the tensor map cannot be made; never synchronises.
extern "C" int repro_tsmm_upper(const void* x, void* out, void* workspace,
                                int m, int n, long long ldx, float reg,
                                int splits, int dtype, int products,
                                void* stream) {
  if (m <= 0 || n <= 0 || n % 4 != 0 || splits < 1 || splits > 65535)
    return -1;
  if (splits > 1 && workspace == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0 && products == 3)
    return run<float, 3>(x, out, ws, m, n, ldx, reg, splits, s);
  if (dtype == 1 && products == 1)
    return run<__nv_bfloat16, 1>(x, out, ws, m, n, ldx, reg, splits, s);
  return -1;
}

extern "C" const char* repro_tsmm_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP) return "tensor map could not be made";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
