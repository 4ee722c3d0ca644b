// tsmm: upper-triangular tiles of G = X^T X + reg * I for Hopper, sm_90a.
//
// Replaces the TPU kernel `_tsmm_kernel` / `tsmm_upper` of
// src/repro/kernels/tsmm.py.  Same function: x [m, n] -> out [n, n] in the
// type of x, where only the 128 x 128 tiles (i, j) with i <= j are written
// (the caller allocates zeros, so the lower-left tiles stay zero), products
// are accumulated over m in fp32, and `reg` is added on the diagonal of the
// i == j tiles before the single write.
//
// Design for this card: a 1-D grid over the T = nb (nb + 1) / 2 upper tiles;
// each block finds its own (i, j) from the linear index, and the loop over m
// runs inside the block.  X is row-major, so both operands of X_i^T X_j are
// row slabs of X that go to shared memory as they are: no transpose anywhere.
// 16 x 16 threads, an 8 x 8 micro-tile each, split in 4-wide halves so that
// the float4 loads from shared memory hit distinct banks.  fp32 inputs
// multiply in full fp32 (FMA, no TF32): the reference holds fp32 to rtol 2e-5.
// bf16 inputs are widened when they are staged.
//
// X is tall and skinny, so T alone is far fewer blocks than the card has SMs
// (n = 1024 gives 36).  The wrapper therefore may split m into `splits`
// slices (grid T x splits): each block then writes its fp32 partial tile to a
// workspace and a second small kernel sums the slices in a fixed order, adds
// `reg`, casts and writes each output element once.  The result does not
// depend on the order in which blocks run (no atomics).
//
// The half product is operation-bound: m * n * (n + 1) flop against
// m * n * sizeof(x) bytes read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;  // output tile edge
constexpr int TK = 32;   // rows of X staged per step

__device__ __forceinline__ void tile_pair(int t, int nb, int& i, int& j) {
  int row = 0, rem = t;
  while (rem >= nb - row) {
    rem -= nb - row;
    ++row;
  }
  i = row;
  j = row + rem;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Stages rows [r0, r0 + TK) x columns [c0, c0 + TN) of x into dst[TK][TN],
// zero outside [0, r_end) x [0, n).  n % 4 == 0, so a 4-wide chunk is all in
// or all out.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* x, long long ldx,
                                      int r0, int r_end, int c0, int n) {
  for (int idx = threadIdx.x; idx < TK * (TN / 4); idx += blockDim.x) {
    const int r = idx / (TN / 4), c = (idx % (TN / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_end && c0 + c < n) val = load4(x + (r0 + r) * ldx + c0 + c);
    *reinterpret_cast<float4*>(dst + r * TN + c) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
tsmm_upper_kernel(const T* __restrict__ x, T* __restrict__ out,
                  float* __restrict__ partial, int m, int n, long long ldx,
                  float reg, int rows_per_split) {
  __shared__ __align__(16) float sA[TK * TN];
  __shared__ __align__(16) float sB[TK * TN];

  const int nb = (n + TN - 1) / TN;
  int ti, tj;
  tile_pair(blockIdx.x, nb, ti, tj);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool diag = ti == tj;
  const float* sBj = diag ? sA : sB;

  // rows {ty*4 + a, 64 + ty*4 + a}, columns {tx*4 + b, 64 + tx*4 + b}
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += TK) {
    __syncthreads();
    stage<T>(sA, x, ldx, r0, r_end, ti * TN, n);
    if (!diag) stage<T>(sB, x, ldx, r0, r_end, tj * TN, n);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sA + kk * TN + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sA + kk * TN + 64 + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(sBj + kk * TN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sBj + kk * TN + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int lr = (a < 4 ? 0 : 64) + ty * 4 + (a & 3);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int lc = (b < 4 ? 0 : 64) + tx * 4 + (b & 3);
      if (partial != nullptr) {
        // [split][tile][TN][TN] fp32; edge tiles hold zeros beyond n
        partial[((size_t)split * gridDim.x + blockIdx.x) * (TN * TN) +
                lr * TN + lc] = acc[a][b];
      } else {
        const int gr = ti * TN + lr, gc = tj * TN + lc;
        if (gr < n && gc < n)
          store1(out + (size_t)gr * n + gc,
                 acc[a][b] + ((gr == gc) ? reg : 0.f));
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

template <typename T>
cudaError_t run(const void* x, void* out, float* workspace, int m, int n,
                long long ldx, float reg, int splits, cudaStream_t stream) {
  const int nb = (n + TN - 1) / TN;
  const int n_tiles = nb * (nb + 1) / 2;
  const int rows_per_split =
      ((m + splits - 1) / splits + TK - 1) / TK * TK;  // whole stages
  dim3 grid(n_tiles, splits);
  tsmm_upper_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      splits > 1 ? workspace : nullptr, m, n, ldx, reg, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  tsmm_reduce_kernel<T><<<n_tiles, 256, 0, stream>>>(
      workspace, static_cast<T*>(out), n, n_tiles, splits, reg);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x: [m, n] with row stride ldx (elements)
// and unit column stride, n % 4 == 0, rows 16-byte (fp32) / 8-byte (bf16)
// aligned.  out: [n, n] contiguous, zero-filled by the caller.  workspace:
// splits * T * 128 * 128 floats when splits > 1, else unused.  Returns a
// cudaError_t, or -1 for an unsupported argument; never synchronises.
extern "C" int repro_tsmm_upper(const void* x, void* out, void* workspace,
                                int m, int n, long long ldx, float reg,
                                int splits, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || n % 4 != 0 || splits < 1 || splits > 65535)
    return -1;
  if (splits > 1 && workspace == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) return (int)run<float>(x, out, ws, m, n, ldx, reg, splits, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, out, ws, m, n, ldx, reg, splits, s);
  return -1;
}

extern "C" const char* repro_tsmm_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
