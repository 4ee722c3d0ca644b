// Mamba2 SSD chunked scan, backward, for Hopper, sm_90a: the gradients of
// y [B,S,H,P] and final_state [B,H,P,N] with respect to xbar, log_a, B, C
// and init_state, for the forward of csrc/ssd_scan.cu.
//
// The TPU kernel `_ssd_kernel` / `ssd_scan_kernel` of
// src/repro/kernels/ssd_scan.py has no backward of its own: the reference
// trains through its plain `ssd_chunked` and lets XLA differentiate it.
// This is the port's counterpart of that gradient.  Per chunk of L rows
// (cum = inclusive cumsum of log_a in the chunk, total = cum of its last
// row, S_in the state entering it, dS_out the gradient of the state leaving
// it, Lmask[t,s] = exp(cum_t - cum_s) for s <= t):
//   M = (C B^T) o Lmask,  W = dY Xbar^T,  Wd = W o Lmask
//   dXbar = M^T dY + exp(total - cum) o (B dS_out^T)
//   dB    = Wd^T C + exp(total - cum) o (Xbar dS_out)   (summed over the
//   dC    = Wd B   + exp(cum) o (dY S_in)                heads of a group)
//   dcum_t = rowsum(M o W)_t - colsum(M o W)_t + C_t . (exp(cum_t) dY_t S_in)
//            - Xbar_t . (exp(total - cum_t) dS_out B_t),
//   plus, on the last row, dtotal = exp(total) sum(dS_out o S_in)
//            + sum_t Xbar_t . (exp(total - cum_t) dS_out B_t)
//   dlog_a = the reverse cumsum of dcum over the chunk
//   dS_in  = exp(total) dS_out + (exp(cum) o dY)^T C   (the transpose of the
//            forward's S <- exp(total) S + ..., run over the chunks in
//            reverse; dS_in of the first chunk is d init_state).
//
// Design (simple first, one design for both types, every product an fp32
// FMA: bf16 inputs are widened on load, so nothing is rounded before the
// sums):
//   * `states`: one block per (b, h), serial over the chunks.  The chunk
//     states are recomputed here, not saved by the forward: the forward
//     pass writes S_in of every chunk, the reverse pass dS_out of every
//     chunk and d init_state, each [B,H,nc,P,N] fp32 (134 MB each at
//     mamba2-1.3b's B 8, S 2048, H 64, P 64, N 128, chunk 256).  Each thread
//     owns P N / 256 elements of the state.
//   * `chunk`: one block per (b, h, chunk), 256 threads (16 x 16, each with
//     4 rows), the chunk cut into 64-row tiles as the fp32 forward cuts it:
//     for each key tile j, the state terms, then the query tiles i >= j
//     (pairs above the diagonal are never visited).  dXbar of a key tile is
//     summed in registers and written once; dB and dC go into fp32 buffers
//     [B,S,G,N] with atomics (the heads of a group, and the tiles of a
//     chunk, add into the same rows); dcum is summed in shared memory with
//     shared-memory atomics.  Rows past L or S are zeros and never written.
//   * `cast`: the fp32 dB and dC buffers to bf16 (bf16 calls only).
//
// What bounds it on this card: the products, about 2 x 64 x 64 x (3N + 2P)
// flop for each pair of 64-row tiles of a chunk and head, plus the state
// terms (about 1.9e11 flop at mamba2-1.3b's shape), on the FMA units:
// operations.
// A tensor-core design (the forward's hi + lo split) is later work.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 64;         // rows of a tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_CHUNK = 1024;
constexpr int LM = RT + 1;     // padded row of M and Wd in shared memory

struct Params {
  const void* xbar;     // [B,S,H,P]
  const float* log_a;   // [B,S,H]
  const void* bm;       // [B,S,G,N]
  const void* cm;       // [B,S,G,N]
  const void* dy;       // [B,S,H,P]
  const float* dfinal;  // [B,H,P,N] or null (zero)
  const float* init;    // [B,H,P,N] or null (zero)
  void* dxbar;          // [B,S,H,P]
  float* dlog_a;        // [B,S,H]
  float* db;            // [B,S,G,N] fp32, zero at launch
  float* dc;            // [B,S,G,N] fp32, zero at launch
  float* dinit;         // [B,H,P,N] or null
  float* s_in;          // [B,H,nc,P,N] scratch
  float* ds_out;        // [B,H,nc,P,N] scratch
  int B, S, H, G, L, nc;
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

// cum[r] for the chunk's rows r < L (rows past S read log_a = 0), by one
// thread after a parallel load; returns nothing, the caller syncs
__device__ void chunk_cumsum(const Params& p, int b, int h, int c0,
                             float* cum) {
  for (int r = threadIdx.x; r < p.L; r += THREADS) {
    const int pos = c0 + r;
    cum[r] = pos < p.S ? p.log_a[((long long)b * p.S + pos) * p.H + h] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < p.L; ++r) {
      acc += cum[r];
      cum[r] = acc;
    }
  }
  __syncthreads();
}

// rows [r0, r0 + RT) of the chunk starting at c0, W columns of a [B,S,X,W]
// tensor at index `x` of its third axis, into shared memory as fp32 with row
// stride LD; rows past L or S are zeros
template <typename T, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int X,
                                          int x, const Params& p, int b,
                                          int c0, int r0) {
  for (int idx = threadIdx.x; idx < RT * W; idx += THREADS) {
    const int r = idx / W, col = idx % W;
    const int lr = r0 + r, pos = c0 + lr;
    dst[r * LD + col] =
        (lr < p.L && pos < p.S)
            ? to_f(src[(((long long)b * p.S + pos) * X + x) * W + col])
            : 0.f;
  }
}

// One block per (b, h): S_in of every chunk (forward), then dS_out of every
// chunk and d init_state (reverse).
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_states(const Params p) {
  constexpr int E = P * N / THREADS;  // state elements a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [L]
  float* sA = cum + MAX_CHUNK;                      // [RT][P]
  float* sB = sA + RT * P;                          // [RT][N]
  float* sw = sB + RT * N;                          // [RT]
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const long long bh = (long long)b * p.H + h;

  float st[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    st[e] = p.init != nullptr ? p.init[bh * P * N + idx] : 0.f;
  }
  // forward: S_out = exp(total) S_in + sum_s exp(total - cum_s) xbar_s B_s
  for (int c = 0; c < p.nc; ++c) {
    const int c0 = c * p.L;
    float* dst = p.s_in + (bh * p.nc + c) * P * N;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[threadIdx.x + e * THREADS] = st[e];
    chunk_cumsum(p, b, h, c0, cum);
    const float total = cum[p.L - 1];
    const float decay = expf(total);
#pragma unroll
    for (int e = 0; e < E; ++e) st[e] *= decay;
    for (int r0 = 0; r0 < p.L; r0 += RT) {
      load_tile<T, P, P>(sA, static_cast<const T*>(p.xbar), p.H, h, p, b, c0,
                         r0);
      load_tile<T, N, N>(sB, static_cast<const T*>(p.bm), p.G, g, p, b, c0,
                         r0);
      if (threadIdx.x < RT) {
        const int lr = r0 + threadIdx.x;
        sw[threadIdx.x] = lr < p.L ? expf(total - cum[lr]) : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < RT; ++s) {
        const float w = sw[s];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int idx = threadIdx.x + e * THREADS;
          st[e] = fmaf(w * sA[s * P + idx / N], sB[s * N + idx % N], st[e]);
        }
      }
      __syncthreads();
    }
  }
  // reverse: dS_in = exp(total) dS_out + sum_t exp(cum_t) dy_t C_t
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * THREADS;
    st[e] = p.dfinal != nullptr ? p.dfinal[bh * P * N + idx] : 0.f;
  }
  for (int c = p.nc - 1; c >= 0; --c) {
    const int c0 = c * p.L;
    float* dst = p.ds_out + (bh * p.nc + c) * P * N;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[threadIdx.x + e * THREADS] = st[e];
    chunk_cumsum(p, b, h, c0, cum);
    const float decay = expf(cum[p.L - 1]);
#pragma unroll
    for (int e = 0; e < E; ++e) st[e] *= decay;
    for (int r0 = 0; r0 < p.L; r0 += RT) {
      load_tile<T, P, P>(sA, static_cast<const T*>(p.dy), p.H, h, p, b, c0,
                         r0);
      load_tile<T, N, N>(sB, static_cast<const T*>(p.cm), p.G, g, p, b, c0,
                         r0);
      if (threadIdx.x < RT) {
        const int lr = r0 + threadIdx.x;
        sw[threadIdx.x] = lr < p.L ? expf(cum[lr]) : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < RT; ++s) {
        const float w = sw[s];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int idx = threadIdx.x + e * THREADS;
          st[e] = fmaf(w * sA[s * P + idx / N], sB[s * N + idx % N], st[e]);
        }
      }
      __syncthreads();
    }
  }
  if (p.dinit != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      p.dinit[bh * P * N + threadIdx.x + e * THREADS] = st[e];
  }
}

// the sum over the 16 threads of a row group (one half-warp)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per (b, h, chunk): every gradient of the chunk's rows.
template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk(const Params p) {
  constexpr int LP = P + 1, LN = N + 1;  // odd: column reads conflict-free
  constexpr int PC = P / 16, NC = N / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sSt = reinterpret_cast<float*>(smem_raw);  // [P][LN]: dS_out, S_in
  float* sBj = sSt + P * LN;                        // [RT][LN]
  float* sCi = sBj + RT * LN;                       // [RT][LN]
  float* sXj = sCi + RT * LN;                       // [RT][LP]
  float* sYi = sXj + RT * LP;                       // [RT][LP]  dY
  float* sM = sYi + RT * LP;                        // [RT][LM]  M[t][s]
  float* sW = sM + RT * LM;                         // [RT][LM]  Wd[t][s]
  float* cum = sW + RT * LM;                        // [L]
  float* dcum = cum + p.L;                          // [L]
  float* sTot = dcum + p.L;                         // dtotal

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int c0 = c * p.L;
  const long long bh = (long long)b * p.H + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nb = (p.L + RT - 1) / RT;
  const T* xbar = static_cast<const T*>(p.xbar);
  const T* dy = static_cast<const T*>(p.dy);
  const T* bm = static_cast<const T*>(p.bm);
  const T* cm = static_cast<const T*>(p.cm);

  for (int r = threadIdx.x; r < p.L; r += THREADS) dcum[r] = 0.f;
  if (threadIdx.x == 0) *sTot = 0.f;
  chunk_cumsum(p, b, h, c0, cum);
  const float total = cum[p.L - 1];
  const float* ds_out = p.ds_out + (bh * p.nc + c) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS)
    sSt[(idx / N) * LN + idx % N] = ds_out[idx];
  float dtot = 0.f;  // this thread's share of dtotal

  for (int j = 0; j < nb; ++j) {
    const int s0 = j * RT;
    __syncthreads();
    load_tile<T, N, LN>(sBj, bm, p.G, g, p, b, c0, s0);
    load_tile<T, P, LP>(sXj, xbar, p.H, h, p, b, c0, s0);
    __syncthreads();
    // state terms of the key rows s: dx = w_s B_s dS_out^T, db = w_s Xbar_s
    // dS_out, w_s = exp(total - cum_s); E_s = Xbar_s . dx_s
    float dx[4][PC], db[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int q = 0; q < PC; ++q) dx[i][q] = 0.f;
#pragma unroll
      for (int q = 0; q < NC; ++q) db[i][q] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float a[4], bb[PC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sBj[(ty * 4 + i) * LN + n];
#pragma unroll
      for (int q = 0; q < PC; ++q) bb[q] = sSt[(tx + 16 * q) * LN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < PC; ++q) dx[i][q] = fmaf(a[i], bb[q], dx[i][q]);
    }
    for (int pp = 0; pp < P; ++pp) {
      float a[4], bb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sXj[(ty * 4 + i) * LP + pp];
#pragma unroll
      for (int q = 0; q < NC; ++q) bb[q] = sSt[pp * LN + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < NC; ++q) db[i][q] = fmaf(a[i], bb[q], db[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ls = s0 + ty * 4 + i;
      const float w = ls < p.L ? expf(total - cum[ls]) : 0.f;
      float e = 0.f;
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        dx[i][q] *= w;
        e = fmaf(dx[i][q], sXj[(ty * 4 + i) * LP + tx + 16 * q], e);
      }
#pragma unroll
      for (int q = 0; q < NC; ++q) db[i][q] *= w;
      e = row_sum16(e);
      if (tx == 0 && ls < p.L) {
        atomicAdd(&dcum[ls], -e);
        dtot += e;
      }
    }

    for (int i = j; i < nb; ++i) {
      const int t0 = i * RT;
      __syncthreads();
      load_tile<T, N, LN>(sCi, cm, p.G, g, p, b, c0, t0);
      load_tile<T, P, LP>(sYi, dy, p.H, h, p, b, c0, t0);
      __syncthreads();
      // G = C_i B_j^T and W = dY_i Xbar_j^T: rows t = ty * 4 + ii, columns
      // s = tx + 16 jj
      float gg[4][4], ww[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) gg[ii][jj] = ww[ii][jj] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], bb[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a[ii] = sCi[(ty * 4 + ii) * LN + n];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bb[jj] = sBj[(tx + 16 * jj) * LN + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            gg[ii][jj] = fmaf(a[ii], bb[jj], gg[ii][jj]);
      }
      for (int pp = 0; pp < P; ++pp) {
        float a[4], bb[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a[ii] = sYi[(ty * 4 + ii) * LP + pp];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bb[jj] = sXj[(tx + 16 * jj) * LP + pp];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            ww[ii][jj] = fmaf(a[ii], bb[jj], ww[ii][jj]);
      }
      // the decay mask; M, Wd into shared memory; rowsum and colsum of M o W
      float colpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int lt = t0 + ty * 4 + ii;
        float rowpart = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int ls = s0 + tx + 16 * jj;
          const float d = (lt < p.L && ls <= lt) ? expf(cum[lt] - cum[ls])
                                                 : 0.f;
          const float m = gg[ii][jj] * d, wd = ww[ii][jj] * d;
          const float mw = m * ww[ii][jj];
          rowpart += mw;
          colpart[jj] += mw;
          sM[(ty * 4 + ii) * LM + tx + 16 * jj] = m;
          sW[(ty * 4 + ii) * LM + tx + 16 * jj] = wd;
        }
        rowpart = row_sum16(rowpart);
        if (tx == 0 && lt < p.L) atomicAdd(&dcum[lt], rowpart);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ls = s0 + tx + 16 * jj;
        if (ls < p.L) atomicAdd(&dcum[ls], -colpart[jj]);
      }
      __syncthreads();
      // dx_j += M^T dY_i, db_j += Wd^T C_i (rows s = ty * 4 + i); dC_i = Wd B_j
      // (rows t = ty * 4 + i), added into the group's buffer
      float dci[4][NC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int q = 0; q < NC; ++q) dci[ii][q] = 0.f;
      for (int t = 0; t < RT; ++t) {
        float mt[4], wt[4], wr[4], yv[PC], cv[NC], bv[NC];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          mt[ii] = sM[t * LM + ty * 4 + ii];
          wt[ii] = sW[t * LM + ty * 4 + ii];
          wr[ii] = sW[(ty * 4 + ii) * LM + t];
        }
#pragma unroll
        for (int q = 0; q < PC; ++q) yv[q] = sYi[t * LP + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          cv[q] = sCi[t * LN + tx + 16 * q];
          bv[q] = sBj[t * LN + tx + 16 * q];
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
          for (int q = 0; q < PC; ++q)
            dx[ii][q] = fmaf(mt[ii], yv[q], dx[ii][q]);
#pragma unroll
          for (int q = 0; q < NC; ++q) {
            db[ii][q] = fmaf(wt[ii], cv[q], db[ii][q]);
            dci[ii][q] = fmaf(wr[ii], bv[q], dci[ii][q]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int lt = t0 + ty * 4 + ii, pos = c0 + lt;
        if (lt < p.L && pos < p.S) {
          float* dst = p.dc + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
          for (int q = 0; q < NC; ++q) atomicAdd(dst + tx + 16 * q, dci[ii][q]);
        }
      }
    }
    // the key tile's dXbar and its share of dB
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ls = s0 + ty * 4 + i, pos = c0 + ls;
      if (ls < p.L && pos < p.S) {
        T* dst = static_cast<T*>(p.dxbar) +
                 (((long long)b * p.S + pos) * p.H + h) * P;
#pragma unroll
        for (int q = 0; q < PC; ++q) dst[tx + 16 * q] = from_f<T>(dx[i][q]);
        float* dbd = p.db + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
        for (int q = 0; q < NC; ++q) atomicAdd(dbd + tx + 16 * q, db[i][q]);
      }
    }
  }

  // the state entering the chunk: dC += exp(cum_t) dY_t S_in, dcum_t +=
  // C_t . that, dtotal += exp(total) sum(dS_out o S_in)
  __syncthreads();
  const float* s_in = p.s_in + (bh * p.nc + c) * P * N;
  const float decay = expf(total);
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS) {
    const float sv = s_in[idx];
    dtot = fmaf(decay * ds_out[idx], sv, dtot);
    sSt[(idx / N) * LN + idx % N] = sv;
  }
  for (int i = 0; i < nb; ++i) {
    const int t0 = i * RT;
    __syncthreads();
    load_tile<T, N, LN>(sCi, cm, p.G, g, p, b, c0, t0);
    load_tile<T, P, LP>(sYi, dy, p.H, h, p, b, c0, t0);
    __syncthreads();
    float dco[4][NC];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int q = 0; q < NC; ++q) dco[ii][q] = 0.f;
    for (int pp = 0; pp < P; ++pp) {
      float a[4], bb[NC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a[ii] = sYi[(ty * 4 + ii) * LP + pp];
#pragma unroll
      for (int q = 0; q < NC; ++q) bb[q] = sSt[pp * LN + tx + 16 * q];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int q = 0; q < NC; ++q) dco[ii][q] = fmaf(a[ii], bb[q], dco[ii][q]);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int lt = t0 + ty * 4 + ii, pos = c0 + lt;
      const float w = lt < p.L ? expf(cum[lt]) : 0.f;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        dco[ii][q] *= w;
        o = fmaf(dco[ii][q], sCi[(ty * 4 + ii) * LN + tx + 16 * q], o);
      }
      o = row_sum16(o);
      if (tx == 0 && lt < p.L) atomicAdd(&dcum[lt], o);
      if (lt < p.L && pos < p.S) {
        float* dst = p.dc + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
        for (int q = 0; q < NC; ++q) atomicAdd(dst + tx + 16 * q, dco[ii][q]);
      }
    }
  }
  // dtotal onto the last row, then dlog_a = the reverse cumsum of dcum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dtot += __shfl_xor_sync(0xffffffffu, dtot, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(sTot, dtot);
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = *sTot;
    for (int r = p.L - 1; r >= 0; --r) {
      acc += dcum[r];
      dcum[r] = acc;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < p.L; r += THREADS) {
    const int pos = c0 + r;
    if (pos < p.S) p.dlog_a[((long long)b * p.S + pos) * p.H + h] = dcum[r];
  }
}

__global__ void cast_bf16(const float* src, __nv_bfloat16* dst, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

template <typename T, int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  {
    auto kernel = ssd_bwd_states<T, P, N>;
    const size_t smem = sizeof(float) * (MAX_CHUNK + RT * (P + N) + RT);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(p.H, p.B), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = ssd_bwd_chunk<T, P, N>;
  const size_t smem =
      sizeof(float) * ((P + 2 * RT) * (N + 1) + 2 * RT * (P + 1) +
                       2 * RT * LM + 2 * p.L + 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.nc, p.H, p.B), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, P, 16>(p, s);
    case 32:
      return launch<T, P, 32>(p, s);
    case 64:
      return launch<T, P, 64>(p, s);
    case 128:
      return launch<T, P, 128>(p, s);
    default:
      return -1;
  }
}

template <typename T>
int dispatch_p(const Params& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_n<T, 16>(p, N, s);
    case 32:
      return dispatch_n<T, 32>(p, N, s);
    case 64:
      return dispatch_n<T, 64>(p, N, s);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xbar, B, C, dy, dxbar, and db_out /
// dc_out, all of it).  Every tensor contiguous.  db_acc, dc_acc [B,S,G,N]
// fp32, zero at launch: dB and dC of an fp32 call, for a bf16 call a scratch
// cast into db_out / dc_out (null for fp32).  dfinal, init and dinit may be
// null (zero; not written).  s_in, ds_out [B,H,nc,P,N] fp32 scratch with
// L = min(chunk, S) rows a chunk and nc = ceil(S / L) chunks.  P in (16, 32,
// 64), N in (16, 32, 64, 128).  Returns a cudaError_t, or -1 for an
// unsupported argument; never synchronises.
extern "C" int repro_ssd_scan_bwd(
    const void* xbar, const float* log_a, const void* bm, const void* cm,
    const void* dy, const float* dfinal, const float* init, void* dxbar,
    float* dlog_a, float* db_acc, float* dc_acc, void* db_out, void* dc_out,
    float* dinit, float* s_in, float* ds_out, int B, int S, int H, int G,
    int P, int N, int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (chunk <= 0 || chunk > MAX_CHUNK || B > 65535 || H > 65535) return -1;
  if (dtype < 0 || dtype > 1 || (dtype == 1) != (db_out != nullptr) ||
      (db_out == nullptr) != (dc_out == nullptr))
    return -1;
  const int L = chunk < S ? chunk : S;
  const int nc = (S + L - 1) / L;
  Params p{xbar,   log_a, bm,     cm,   dy, dfinal, init, dxbar, dlog_a,
           db_acc, dc_acc, dinit, s_in, ds_out, B,  S,    H,    G,
           L,      nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = dtype == 0 ? dispatch_p<float>(p, P, N, s)
                       : dispatch_p<__nv_bfloat16>(p, P, N, s);
  if (err != 0 || dtype == 0) return err;
  const long long n = (long long)B * S * G * N;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cast_bf16<<<blocks, 256, 0, s>>>(db_acc, static_cast<__nv_bfloat16*>(db_out),
                                   n);
  cast_bf16<<<blocks, 256, 0, s>>>(dc_acc, static_cast<__nv_bfloat16*>(dc_out),
                                   n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_ssd_scan_bwd_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
