// Mamba2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_kernel` of
// src/repro/kernels/ssd_scan.py.  Same function, on pre-scaled inputs:
//   xbar [B,S,H,P] (= x * dt), log_a [B,S,H] fp32 (= dt * A),
//   B/C [B,S,G,N], optional init_state [B,H,P,N] fp32
//   -> y [B,S,H,P] in the type of xbar, final_state [B,H,P,N] fp32.
// Per chunk of `chunk` rows: cum = inclusive cumsum of log_a;
//   Y_diag = ((C B^T) o L) Xbar with L[i,j] = exp(cum_i - cum_j), j <= i;
//   Y_off  = exp(cum) o (C S^T)  with S the state entering the chunk;
//   S      <- exp(cum_last) S + (exp(cum_last - cum) o Xbar)^T B.
// The D residual is added by the caller, as in the reference.
//
// What bounds it on this card: at the serve path's shape (B=8, S=2048,
// H=64, P=64, N=128, chunk 256, G=1) the scan does about 8.6e10 flop
// (lower-triangle pairs only) against about 0.30 GB moved, so the roofline
// bound (about 0.09 ms) is set by bytes.  This body multiplies in fp32 FMA on
// the CUDA cores, not on the tensor cores, so in practice the FMA rate bounds
// it: it is a first, simple kernel, and an `mma.sync` / `wgmma` bf16 body is
// later work.
//
// Design for this card, and how it differs from the TPU kernel:
//   * One block per (b, h), 256 threads, looping over the chunks inside the
//     block.  The fp32 state lives in shared memory for the whole scan,
//     transposed as St [N][P], where the TPU kernel carried it in VMEM
//     scratch across a sequential third grid axis.  B*H = 512 blocks at the
//     serve shape; each uses about 135 KB of shared memory, one block per SM.
//   * A 256-row chunk of fp32 B and C does not fit an SM, so the chunk is cut
//     into 64-row tiles: for each query tile of C, the off-diagonal term from
//     the state, then the key tiles j <= i of B and Xbar, like causal
//     attention with a decay mask in place of softmax.  Tiles above the
//     diagonal are never visited; only the mask arithmetic of the diagonal
//     tile matters, the others keep every pair.
//   * The state update of the chunk is accumulated in registers while each
//     key tile is in shared memory for its diagonal pass, and applied once
//     every query tile of the chunk has read the old state.
//   * The cumsum is a block-level prefix sum with warp shuffles in fp32, not
//     the TPU's triangular-ones matmul: the order of the sums differs.
//   * B and C are read by group index (g = h / (H / G)) through batch and
//     row strides, so the groups are never repeated to heads in device
//     memory, and the model's views of its projection need no copy.
//   * Ragged S: rows >= S are read as xbar = log_a = B = C = 0 and never
//     written, which leaves y and the state exactly as they are; the TPU
//     kernel asserts S % chunk == 0.
//   * bf16 inputs are widened to fp32 when a tile is loaded; every sum is an
//     fp32 FMA, with no TF32 anywhere.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 64;         // rows of a query tile and of a key tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_CHUNK = 1024;

struct Params {
  const void* xbar;
  const float* log_a;
  const void* bm;
  const void* cm;
  const float* init;  // may be null: zero initial state
  void* y;
  float* state_out;
  int B, S, H, G, chunk;
  long long b_sb, b_ss;  // strides (elements) of B over batch and row
  long long c_sb, c_ss;  // strides (elements) of C over batch and row
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// V consecutive floats of shared memory, with the widest aligned loads.
template <int V>
__device__ __forceinline__ void ld(float (&v)[V], const float* p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// Rows [0, RT) x W of a matrix with row stride `stride` into shared memory
// as fp32 with row stride LD; rows >= n_valid are written as zeros.
template <typename T, int W, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int n_valid) {
  for (int idx = threadIdx.x; idx < RT * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * LD + c] = r < n_valid ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// s_cum[i] = log_a[0] + ... + log_a[i] for i < len, reading log_a[i] as 0 for
// i >= l (so the tail repeats the last real sum).  Ends with __syncthreads.
__device__ void chunk_cumsum(float* s_cum, float* s_warp, const float* la,
                             long long stride, int l, int len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < len; base += THREADS) {
    const int i = base + threadIdx.x;
    float v = i < l ? la[i * stride] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      constexpr int NW = THREADS / 32;
      float w = lane < NW ? s_warp[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NW; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      if (lane < NW) s_warp[lane] = w;
    }
    __syncthreads();
    if (i < len) s_cum[i] = carry + (warp > 0 ? s_warp[warp - 1] : 0.f) + v;
    carry += s_warp[THREADS / 32 - 1];
    __syncthreads();  // s_warp is rewritten in the next round
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_scan_fwd(const Params p) {
  constexpr int LDP = P + 4;   // padded rows: float4 reads of 8 neighbouring
  constexpr int LDN = N + 4;   // rows fall in distinct banks
  constexpr int LDT = RT + 4;
  constexpr int CPT = P / 16;  // columns of y (and of St) per thread
  constexpr int RPT = N / 16;  // rows of St per thread
  extern __shared__ __align__(16) float smem[];
  float* sSt = smem;              // [N][LDP]   state, transposed
  float* sC = sSt + N * LDP;      // [RT][LDN]  query tile of C
  float* sB = sC + RT * LDN;      // [RT][LDN]  key tile of B
  float* sX = sB + RT * LDN;      // [RT][LDP]  key tile of Xbar
  float* sP = sX + RT * LDP;      // [RT][LDT]  decayed scores
  float* sWarp = sP + RT * LDT;   // [8]
  float* sCum = sWarp + 8;        // [chunk rounded up to RT]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const long long x_ss = (long long)p.H * P;  // row stride of xbar and y
  const long long x_off = ((long long)b * p.S * p.H + h) * P;
  const T* xp = static_cast<const T*>(p.xbar) + x_off;
  T* yp = static_cast<T*>(p.y) + x_off;
  const float* la = p.log_a + (long long)b * p.S * p.H + h;
  const T* bp = static_cast<const T*>(p.bm) + b * p.b_sb + g * N;
  const T* cp = static_cast<const T*>(p.cm) + b * p.c_sb + g * N;

  const long long st_off = ((long long)b * p.H + h) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS) {
    const int pp = idx / N, n = idx % N;
    sSt[n * LDP + pp] = p.init != nullptr ? p.init[st_off + idx] : 0.f;
  }

  const int nc = (p.S + p.chunk - 1) / p.chunk;
  for (int c = 0; c < nc; ++c) {
    const int r0 = c * p.chunk;
    const int l = min(p.chunk, p.S - r0);
    const int nt = (l + RT - 1) / RT;
    chunk_cumsum(sCum, sWarp, la + (long long)r0 * p.H, p.H, l, nt * RT);
    const float total = sCum[l - 1];

    float dS[RPT][CPT];  // this chunk's (exp(total - cum) Xbar)^T B, transposed
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) dS[r][cc] = 0.f;

    for (int qi = 0; qi < nt; ++qi) {
      const int q0 = qi * RT;
      __syncthreads();  // the previous tile's readers of sC / sB / sX / sP
      load_rows<T, N, LDN>(sC, cp + (long long)(r0 + q0) * p.c_ss, p.c_ss,
                           l - q0);
      __syncthreads();

      // thread (ty, tx): rows ty*4 + ii of the tile, columns tx*CPT + cc
      float acc[4][CPT];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] = 0.f;

      // Y_off = exp(cum) o (C St): the state entering the chunk
#pragma unroll 2
      for (int k = 0; k < N; k += 4) {
        float cv[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) ld(cv[ii], sC + (ty * 4 + ii) * LDN + k);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float sv[CPT];
          ld(sv, sSt + (k + u) * LDP + tx * CPT);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
              acc[ii][cc] = fmaf(cv[ii][u], sv[cc], acc[ii][cc]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float e = expf(sCum[q0 + ty * 4 + ii]);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[ii][cc] *= e;
      }

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * RT;
        if (kj > 0) __syncthreads();  // readers of sB / sX / sP are done
        load_rows<T, N, LDN>(sB, bp + (long long)(r0 + k0) * p.b_ss, p.b_ss,
                             l - k0);
        load_rows<T, P, LDP>(sX, xp + (long long)(r0 + k0) * x_ss, x_ss,
                             l - k0);
        __syncthreads();

        // scores C B^T: rows ty*4 + ii, columns tx + 16*jj of the tile pair
        float s[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 2
        for (int k = 0; k < N; k += 4) {
          float cv[4][4], bv[4][4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            ld(cv[ii], sC + (ty * 4 + ii) * LDN + k);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            ld(bv[jj], sB + (tx + 16 * jj) * LDN + k);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s[ii][jj] = fmaf(cv[ii][0], bv[jj][0], s[ii][jj]);
              s[ii][jj] = fmaf(cv[ii][1], bv[jj][1], s[ii][jj]);
              s[ii][jj] = fmaf(cv[ii][2], bv[jj][2], s[ii][jj]);
              s[ii][jj] = fmaf(cv[ii][3], bv[jj][3], s[ii][jj]);
            }
        }
        // decay and causal mask: L[i,j] = exp(cum_i - cum_j) for j <= i
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = q0 + ty * 4 + ii;
          const float ci = sCum[i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = k0 + tx + 16 * jj;
            sP[(ty * 4 + ii) * LDT + tx + 16 * jj] =
                j <= i ? s[ii][jj] * expf(ci - sCum[j]) : 0.f;
          }
        }

        if (kj == qi) {
          // each key tile is on the diagonal once: its share of the update
#pragma unroll 2
          for (int j = 0; j < RT; ++j) {
            const float w = expf(total - sCum[k0 + j]);
            float xv[CPT], bv[RPT];
            ld(xv, sX + j * LDP + tx * CPT);
            ld(bv, sB + j * LDN + ty * RPT);
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) xv[cc] *= w;
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
              for (int cc = 0; cc < CPT; ++cc)
                dS[r][cc] = fmaf(bv[r], xv[cc], dS[r][cc]);
          }
        }
        __syncthreads();  // sP is complete

        // Y_diag += P Xbar
#pragma unroll 2
        for (int j = 0; j < RT; j += 4) {
          float pv[4][4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
            ld(pv[ii], sP + (ty * 4 + ii) * LDT + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float xv[CPT];
            ld(xv, sX + (j + u) * LDP + tx * CPT);
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
              for (int cc = 0; cc < CPT; ++cc)
                acc[ii][cc] = fmaf(pv[ii][u], xv[cc], acc[ii][cc]);
          }
        }
      }

#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = q0 + ty * 4 + ii;
        if (row < l) {
          T* out = yp + (long long)(r0 + row) * x_ss + tx * CPT;
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) store_as(out + cc, acc[ii][cc]);
        }
      }
    }

    __syncthreads();  // every reader of the old state in this chunk is done
    const float decay = expf(total);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        float* e = sSt + (ty * RPT + r) * LDP + tx * CPT + cc;
        *e = fmaf(*e, decay, dS[r][cc]);
      }
  }

  __syncthreads();
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS) {
    const int pp = idx / N, n = idx % N;
    p.state_out[st_off + idx] = sSt[n * LDP + pp];
  }
}

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  const int cum = (p.chunk + RT - 1) / RT * RT;
  const size_t smem =
      sizeof(float) * ((size_t)N * (P + 4) + 2 * RT * (N + 4) +
                       RT * (P + 4) + RT * (RT + 4) + 8 + cum);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.H, p.B);
  ssd_scan_fwd<T, P, N><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const Params& p, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(p, stream);
    case 32:
      return launch<T, P, 32>(p, stream);
    case 64:
      return launch<T, P, 64>(p, stream);
    case 128:
      return launch<T, P, 128>(p, stream);
    default:
      return -1;
  }
}

template <typename T>
int dispatch_p(const Params& p, int P, int N, cudaStream_t stream) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(p, N, stream);
    case 32:
      return dispatch_n<T, 32>(p, N, stream);
    case 64:
      return dispatch_n<T, 64>(p, N, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xbar, B, C and y; log_a, init_state and
// final_state are float32).  xbar, y, log_a, init_state and final_state are
// contiguous; B and C have unit stride along N and stride N between groups,
// with the given batch and row strides (elements).  init_state may be null.
// P in {16, 32, 64}, N in {16, 32, 64, 128}, 1 <= chunk <= 1024.  Returns a
// cudaError_t, or -1 for an unsupported argument; never synchronises.
extern "C" int repro_ssd_scan_fwd(const void* xbar, const void* log_a,
                                  const void* bm, const void* cm,
                                  const void* init, void* y, void* state_out,
                                  int B, int S, int H, int G, int P, int N,
                                  int chunk, long long b_sb, long long b_ss,
                                  long long c_sb, long long c_ss, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (chunk <= 0 || chunk > MAX_CHUNK || B > 65535) return -1;
  Params p{xbar, static_cast<const float*>(log_a), bm, cm,
           static_cast<const float*>(init), y, static_cast<float*>(state_out),
           B, S, H, G, chunk, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_p<float>(p, P, N, s);
  if (dtype == 1) return dispatch_p<__nv_bfloat16>(p, P, N, s);
  return -1;
}

extern "C" const char* repro_ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
