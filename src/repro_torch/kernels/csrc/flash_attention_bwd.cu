// Flash attention backward for Hopper, sm_90a: the gradients of
// o = softmax(q k^T * scale + mask) v with respect to q, k and v.
//
// The TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py has no backward of its own: the
// reference trains through its plain attention and lets XLA differentiate
// it.  This is the port's counterpart of that gradient, for the forward of
// csrc/flash_attention.cu, which leaves each row's log-sum-exp `lse` behind:
//   P  = exp(S * scale - lse)  on the causal / window band, 0 off it
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// with dK and dV summed over the query heads of each GQA group.
//
// Design (simple first, for both types): three CUDA kernels a call.
//   * `delta`: one warp a row, rowsum(dO o O) in fp32, O and dO read through
//     their strides (the forward's O is a transposed view).
//   * `main`: one block of 256 threads per (b, kv head, tile of 64 keys).
//     K and V of the tile stay in shared memory; the block walks the query
//     heads of its group and, for each, the 64-row query tiles of the band
//     (tiles outside the causal / window band are skipped, as the forward
//     skips them; ragged Sq and Skv are masked), recomputes S and P from
//     lse, and accumulates dK and dV in registers over all of them.  dQ of
//     each (query tile, key tile) pair is added into an fp32 buffer with
//     atomics (another block owns the other key tiles of the same rows).
//     Every product is fp32 FMA on fp32 copies of the operands in shared
//     memory: a bf16 x bf16 product is exact in fp32, so bf16 inputs lose
//     nothing before the sums.  Each thread owns a 4 x (64 / 16) tile of S
//     and dP and a 4 x (D / 16) tile of dK, dV and dQ; rows of K, V, Q and
//     dO are padded to an odd length, so reads along a column are free of
//     bank conflicts.
//   * `cast`: the fp32 dQ buffer to bf16 (for bf16 calls only; an fp32 call
//     accumulates into its output).
//
// What bounds it on this card: the five products, about 5 x 2 x D flop for
// every visible (query, key) pair (172 GFLOP at B 8, H 16, S 2048, D 64,
// causal), against a few hundred MB of traffic: operations.  FMA from shared
// memory reaches a small share of the tensor cores' bf16 rate; a tensor-core
// design (mma / wgmma on bf16 P and dS) is later work.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BT = 64;        // rows of a query tile, keys of a key tile
constexpr int THREADS = 256;  // 16 x 16 threads, each with 4 rows
constexpr int LP = BT + 1;    // padded row of P and dS in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B,Hq,Sq]
  float* delta;      // [B,Hq,Sq]
  float* dq;         // [B,Hq,Sq,D] fp32, zero at launch
  void* dk;          // [B,Hkv,Skv,D] contiguous, in the input type
  void* dv;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  float scale;
  int causal;
  int window;  // <= 0: none
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the forward's band: key j is visible to query i when j <= i (causal) and
// j > i - window (window)
__device__ __forceinline__ bool in_band(const Params& p, int q_pos,
                                        int k_pos) {
  bool ok = q_pos < p.Sq && k_pos < p.Skv;
  if (p.causal) ok = ok && (k_pos <= q_pos);
  if (p.window > 0) ok = ok && (k_pos > q_pos - p.window);
  return ok;
}

// rows [row0, row0 + BT) x D of a matrix with row stride `stride` into
// shared memory as fp32 with row stride LD; rows >= n_rows are zeros
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < BT * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < n_rows ? to_f(src[row * stride + c]) : 0.f;
  }
}

// delta[b, h, i] = sum_d dO[i, d] O[i, d]; one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.Sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh +
               row * p.o_ss;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb +
                  h * p.do_sh + row * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f(o[c]) * to_f(dout[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.Sq + row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_main(const Params p) {
  constexpr int LD = D + 1;    // odd: column reads are conflict-free
  constexpr int DC = D / 16;   // columns of D a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;    // dO
  float* sP = sO + BT * LD;
  float* sS = sP + BT * LP;    // dS
  float* sL = sS + BT * LP;    // lse of the tile's rows
  float* sD = sL + BT;         // delta of the tile's rows

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k_lo = kt * BT;
  const int k_hi = min(k_lo + BT, p.Skv) - 1;

  load_rows<T, D, LD>(sK, static_cast<const T*>(p.k) + b * p.k_sb +
                              kvh * p.k_sh, p.k_ss, k_lo, p.Skv);
  load_rows<T, D, LD>(sV, static_cast<const T*>(p.v) + b * p.v_sb +
                              kvh * p.v_sh, p.v_ss, k_lo, p.Skv);

  // the query tiles whose rows can see a key of this tile
  const int nqt = (p.Sq + BT - 1) / BT;
  int qt_lo = 0, qt_hi = nqt - 1;
  if (p.causal) qt_lo = k_lo / BT;
  if (p.window > 0) qt_hi = min(qt_hi, (k_hi + p.window - 1) / BT);

  // thread (ty, tx): S / dP rows ty * 4 + i, key columns tx + 16 j; dK / dV
  // key rows ty * 4 + i, D columns tx + 16 c; dQ rows ty * 4 + i, the same
  // D columns
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int h = kvh * group; h < (kvh + 1) * group; ++h) {
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dop =
        static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q_lo = qt * BT;
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D, LD>(sQ, qp, p.q_ss, q_lo, p.Sq);
      load_rows<T, D, LD>(sO, dop, p.do_ss, q_lo, p.Sq);
      if (threadIdx.x < BT) {
        const int row = q_lo + threadIdx.x;
        sL[threadIdx.x] = row < p.Sq ? p.lse[row_base + row] : 0.f;
        sD[threadIdx.x] = row < p.Sq ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float aq[4], ao[4], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = sQ[(ty * 4 + i) * LD + d];
          ao[i] = sO[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = sK[(tx + 16 * j) * LD + d];
          bv[j] = sV[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
            dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
          }
      }
      // P and dS, into shared memory
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float pv = in_band(p, q_lo + r, k_lo + c)
                               ? expf(s[i][j] * p.scale - sL[r])
                               : 0.f;
          sP[r * LP + c] = pv;
          sS[r * LP + c] = pv * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q, and this pair's dQ = dS K
      float dq[4][DC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
#pragma unroll 2
      for (int t = 0; t < BT; ++t) {
        float pt[4], st[4], sr[4], o_[DC], q_[DC], k_[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[i] = sP[t * LP + ty * 4 + i];    // P[t, key row]
          st[i] = sS[t * LP + ty * 4 + i];    // dS[t, key row]
          sr[i] = sS[(ty * 4 + i) * LP + t];  // dS[q row, key t]
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          o_[c] = sO[t * LD + tx + 16 * c];
          q_[c] = sQ[t * LD + tx + 16 * c];
          k_[c] = sK[t * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] = fmaf(pt[i], o_[c], dv[i][c]);
            dk[i][c] = fmaf(st[i], q_[c], dk[i][c]);
            dq[i][c] = fmaf(sr[i], k_[c], dq[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q_lo + ty * 4 + i;
        if (row < p.Sq) {
          float* dst = p.dq + (row_base + row) * D;
#pragma unroll
          for (int c = 0; c < DC; ++c)
            atomicAdd(dst + tx + 16 * c, dq[i][c] * p.scale);
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + (((long long)b * p.Hkv + kvh) * p.Skv) * D;
  T* dvp = static_cast<T*>(p.dv) + (((long long)b * p.Hkv + kvh) * p.Skv) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_lo + ty * 4 + i;
    if (row < p.Skv) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dkp[(long long)row * D + tx + 16 * c] = from_f<T>(dk[i][c] * p.scale);
        dvp[(long long)row * D + tx + 16 * c] = from_f<T>(dv[i][c]);
      }
    }
  }
}

__global__ void cast_bf16(const float* src, __nv_bfloat16* dst, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

template <typename T, int D>
int launch(const Params& p, void* dq_out, cudaStream_t stream) {
  const dim3 dgrid((p.Sq + 7) / 8, p.Hq, p.B);
  flash_bwd_delta<T, D><<<dgrid, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (4 * BT * (D + 1) + 2 * BT * LP + 2 * BT);
  auto kernel = flash_bwd_main<T, D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Skv + BT - 1) / BT, p.Hkv, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dq_out != nullptr) {
    const long long n = (long long)p.B * p.Hq * p.Sq * D;
    cast_bf16<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        p.dq, static_cast<__nv_bfloat16*>(dq_out), n);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int dispatch_d(const Params& p, int D, void* dq_out, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(p, dq_out, stream);
  if (D == 80) return launch<T, 80>(p, dq_out, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dk, dv all of it);
// D = 64 or 80.  lse [B,Hq,Sq] fp32 from the forward; delta [B,Hq,Sq] fp32
// scratch; dq_acc [B,Hq,Sq,D] fp32, zero at launch: the dQ of an fp32 call,
// for a bf16 call a scratch that is cast into dq_out [B,Hq,Sq,D] bf16
// (dq_out is null for fp32).  dk, dv [B,Hkv,Skv,D] contiguous.  q, k, v, o
// and dout are read through (batch, head, row) strides in elements with a
// unit stride along D.  window <= 0 means no window.  Returns a cudaError_t,
// or -1 for an unsupported argument; never synchronises.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq_acc,
    void* dq_out, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
    int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, float scale,
    int causal, int window, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return -1;
  if (Hq % Hkv != 0 || Hq > 65535 || B > 65535) return -1;
  if ((dtype == 1) != (dq_out != nullptr) || dtype < 0 || dtype > 1)
    return -1;
  Params p{q,    k,    v,     o,     dout,  lse,   delta, dq_acc, dk,
           dv,   B,    Hq,    Hkv,   Sq,    Skv,   q_sb,  q_sh,   q_ss,
           k_sb, k_sh, k_ss,  v_sb,  v_sh,  v_ss,  o_sb,  o_sh,   o_ss,
           do_sb, do_sh, do_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, D, nullptr, s);
  return dispatch_d<__nv_bfloat16>(p, D, dq_out, s);
}

extern "C" const char* repro_flash_attention_bwd_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
