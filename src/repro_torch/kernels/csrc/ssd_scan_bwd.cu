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
// What bounds it on this card: the products, about 2 x 64 x 64 x (3N + 2P)
// flop for each pair of 64-row tiles of a chunk and head, plus the state
// terms (about 1.9e11 flop at mamba2-1.3b's B 8, S 2048, H 64, P 64, N 128,
// chunk 256): operations, at the tensor cores' bf16 rate.
//
// Two bodies, chosen by the wrapper from the type (`ssd_bwd_body`):
//   * bf16: chunk-parallel on the tensor cores, five kernels a call, every
//     fp32 operand of a product split hi + lo; see its section below.
//   * fp32: every product an fp32 FMA, four kernels a call; see its section
//     below.
// Both sum in a fixed order, so a call repeats bit for bit.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"

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
  float* db;            // [H/G,B,S,G,N] fp32: one [B,S,G,N] a head of a group
  float* dc;            // the same, zero at launch
  float* dinit;         // [B,H,P,N] or null
  float* s_in;          // [B,H,nc,P,N] scratch
  float* ds_out;        // [B,H,nc,P,N] scratch
  int B, S, H, G, L, nc;
};

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
template <int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int X,
                                          int x, const Params& p, int b,
                                          int c0, int r0) {
  for (int idx = threadIdx.x; idx < RT * W; idx += THREADS) {
    const int r = idx / W, col = idx % W;
    const int lr = r0 + r, pos = c0 + lr;
    dst[r * LD + col] =
        (lr < p.L && pos < p.S)
            ? src[(((long long)b * p.S + pos) * X + x) * W + col]
            : 0.f;
  }
}

// ---------------------------------------------------------------------------
// fp32 body: FMA
// ---------------------------------------------------------------------------
//
//   * `states`: one block per (b, h), serial over the chunks.  The chunk
//     states are recomputed here, not saved by the forward: the forward
//     pass writes S_in of every chunk, the reverse pass dS_out of every
//     chunk and d init_state, each [B,H,nc,P,N] fp32.  Each thread owns
//     P N / 256 elements of the state.
//   * `chunk`: one block per (b, h, chunk), 256 threads (16 x 16, each with
//     4 rows), the chunk cut into 64-row tiles as the fp32 forward cuts it:
//     for each key tile j, the state terms, then the query tiles i >= j
//     (pairs above the diagonal are never visited).  dXbar of a key tile is
//     summed in registers and written once.  dB and dC go into the head's
//     own slice of fp32 scratch [H/G,B,S,G,N]: dB of a key row once, dC of
//     a query row added by the one thread that owns it, the key tiles in
//     order, then the state term.  Each row of dcum is owned by one thread
//     (the one with tx 0 whose four rows hold it), which adds its terms in
//     program order; the column sums of M o W, spread over the 16 row
//     groups, reach it through shared memory and are added in row-group
//     order; dtotal is summed per warp, then over the warps in order.  Rows
//     past L or S are zeros and never written.
//   * `sum_slices_f32`: dB and dC, the heads' slices summed in head order
//     into [B,S,G,N]: no block adds into memory another block adds into.

// One block per (b, h): S_in of every chunk (forward), then dS_out of every
// chunk and d init_state (reverse).
template <int P, int N>
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
      load_tile<P, P>(sA, static_cast<const float*>(p.xbar), p.H, h, p, b, c0,
                         r0);
      load_tile<N, N>(sB, static_cast<const float*>(p.bm), p.G, g, p, b, c0,
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
      load_tile<P, P>(sA, static_cast<const float*>(p.dy), p.H, h, p, b, c0,
                         r0);
      load_tile<N, N>(sB, static_cast<const float*>(p.cm), p.G, g, p, b, c0,
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
template <int P, int N>
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
  float* sCol = sW + RT * LM;                       // [16][RT] column sums
  float* cum = sCol + 16 * RT;                      // [L]
  float* dcum = cum + p.L;                          // [L]
  float* sTot = dcum + p.L;                         // [THREADS / 32] dtotal

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int c0 = c * p.L;
  const long long bh = (long long)b * p.H + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // this head's slices of dB and dC
  const long long slice = (long long)p.B * p.S * p.G * N;
  float* db_h = p.db + (h % (p.H / p.G)) * slice;
  float* dc_h = p.dc + (h % (p.H / p.G)) * slice;
  const int nb = (p.L + RT - 1) / RT;
  const float* xbar = static_cast<const float*>(p.xbar);
  const float* dy = static_cast<const float*>(p.dy);
  const float* bm = static_cast<const float*>(p.bm);
  const float* cm = static_cast<const float*>(p.cm);

  for (int r = threadIdx.x; r < p.L; r += THREADS) dcum[r] = 0.f;
  chunk_cumsum(p, b, h, c0, cum);
  const float total = cum[p.L - 1];
  const float* ds_out = p.ds_out + (bh * p.nc + c) * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += THREADS)
    sSt[(idx / N) * LN + idx % N] = ds_out[idx];
  float dtot = 0.f;  // this thread's share of dtotal

  for (int j = 0; j < nb; ++j) {
    const int s0 = j * RT;
    __syncthreads();
    load_tile<N, LN>(sBj, bm, p.G, g, p, b, c0, s0);
    load_tile<P, LP>(sXj, xbar, p.H, h, p, b, c0, s0);
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
        dcum[ls] -= e;
        dtot += e;
      }
    }

    for (int i = j; i < nb; ++i) {
      const int t0 = i * RT;
      __syncthreads();
      load_tile<N, LN>(sCi, cm, p.G, g, p, b, c0, t0);
      load_tile<P, LP>(sYi, dy, p.H, h, p, b, c0, t0);
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
        if (tx == 0 && lt < p.L) dcum[lt] += rowpart;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sCol[ty * RT + tx + 16 * jj] = colpart[jj];
      __syncthreads();
      // the column sums, over the row groups in order, by the owners of the
      // key rows
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          if (s0 + r < p.L) {
            float col = 0.f;
            for (int y = 0; y < 16; ++y) col += sCol[y * RT + r];
            dcum[s0 + r] -= col;
          }
        }
      }
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
          float* dst = dc_h + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
          for (int q = 0; q < NC; ++q) dst[tx + 16 * q] += dci[ii][q];
        }
      }
    }
    // the key tile's dXbar and its share of dB
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ls = s0 + ty * 4 + i, pos = c0 + ls;
      if (ls < p.L && pos < p.S) {
        float* dst = static_cast<float*>(p.dxbar) +
                 (((long long)b * p.S + pos) * p.H + h) * P;
#pragma unroll
        for (int q = 0; q < PC; ++q) dst[tx + 16 * q] = dx[i][q];
        float* dbd = db_h + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
        for (int q = 0; q < NC; ++q) dbd[tx + 16 * q] = db[i][q];
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
    load_tile<N, LN>(sCi, cm, p.G, g, p, b, c0, t0);
    load_tile<P, LP>(sYi, dy, p.H, h, p, b, c0, t0);
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
      if (tx == 0 && lt < p.L) dcum[lt] += o;
      if (lt < p.L && pos < p.S) {
        float* dst = dc_h + (((long long)b * p.S + pos) * p.G + g) * N;
#pragma unroll
        for (int q = 0; q < NC; ++q) dst[tx + 16 * q] += dco[ii][q];
      }
    }
  }
  // dtotal onto the last row, then dlog_a = the reverse cumsum of dcum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dtot += __shfl_xor_sync(0xffffffffu, dtot, off);
  if ((threadIdx.x & 31) == 0) sTot[threadIdx.x >> 5] = dtot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) acc += sTot[w];
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

// dst = the sum of `slices` fp32 arrays of n elements, n apart, in order
// (the fp32 body's dB and dC).
__global__ void sum_slices_f32(const float* src, int slices, float* dst,
                               long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = src[i];
  for (int z = 1; z < slices; ++z) acc += src[z * n + i];
  dst[i] = acc;
}

// dst = the sum of `slices` fp32 arrays of n elements, n apart, in order,
// cast to bf16.
__global__ void sum_cast_bf16(const float* src, int slices,
                              __nv_bfloat16* dst, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = src[i];
  for (int z = 1; z < slices; ++z) acc += src[z * n + i];
  dst[i] = __float2bfloat16(acc);
}

template <int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  {
    auto kernel = ssd_bwd_states<P, N>;
    const size_t smem = sizeof(float) * (MAX_CHUNK + RT * (P + N) + RT);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(p.H, p.B), THREADS, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = ssd_bwd_chunk<P, N>;
  const size_t smem =
      sizeof(float) * ((P + 2 * RT) * (N + 1) + 2 * RT * (P + 1) +
                       2 * RT * LM + 16 * RT + 2 * p.L + THREADS / 32);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.nc, p.H, p.B), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(const Params& p, int N, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<P, 16>(p, s);
    case 32:
      return launch<P, 32>(p, s);
    case 64:
      return launch<P, 64>(p, s);
    case 128:
      return launch<P, 128>(p, s);
    default:
      return -1;
  }
}

int dispatch_p(const Params& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_n<16>(p, N, s);
    case 32:
      return dispatch_n<32>(p, N, s);
    case 64:
      return dispatch_n<64>(p, N, s);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores, chunk-parallel
// ---------------------------------------------------------------------------
//
// Five kernels a call, in this order on the caller's stream, on chunks of L
// = min(chunk, 256, S) rows (the gradient does not depend on the chunk; at
// most four 64-row tiles keep a tile's work in shared memory):
//   ssd_cb               C B^T once per (b, chunk, group), the tiles on or
//                        below the diagonal: the forward's kernel;
//   ssd_bwd_emit         per (b, chunk, head): the cumsum (sequential, in
//                        torch.cumsum's order) into `cum`, then
//                        emit = (exp(total - cum) o Xbar)^T B into `s_in` and
//                        demit = (exp(cum) o dY)^T C into `ds_out`, each
//                        [P][N] fp32, the decayed Xbar / dY split hi + lo
//                        (the forward's `chunk_state_tc`);
//   ssd_bwd_pass         per (b, head), elementwise over the chunks: S_in in
//                        the forward's order, written over emit as a bf16 hi
//                        and lo matrix; dS_out in reverse from d final_state,
//                        written over demit the same way; d init_state; and
//                        dtotal's state part exp(total) sum(dS_out o S_in);
//   ssd_bwd_tile         per (b, chunk, group, 64-row tile r, slice of the
//                        group's heads), looping over the heads: for each, W
//                        = dY Xbar^T of the tile pairs (r, j <= r) and, as
//                        W^T, (i >= r, r); M = (C B^T) o Lmask and Wd = W o
//                        Lmask in fp32 registers; rowsum and colsum of M o W
//                        into dcum; dXbar_r = M^T dY + exp(total - cum) o
//                        (B_r dS_out^T); the state terms of dB_r, dC_r and
//                        dcum.  Wd is summed over the slice's heads in shared
//                        memory, so dB_r = Wd^T C and dC_r = Wd B run once a
//                        slice; each slice writes its own dB and dC, and the
//                        tile's part of dtotal;
//   ssd_bwd_finish       per (b, chunk, head), sequential: dlog_a = the
//                        reverse cumsum of dcum, dtotal (the state part, then
//                        the tiles' parts in order) added on the chunk's last
//                        row;
//   sum_cast_bf16        dB and dC: the slices summed in order, cast.
// Every sum runs in a fixed order, so a call repeats bit for bit: no block
// adds into memory another block adds into, and the warps of a block that
// share a row of dcum keep a part each, summed in warp order.
// Every product runs on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate).  An
// fp32 operand (the decayed Xbar and dY, S_in, dS_out, M, the summed Wd) is
// split hi + lo and multiplied twice into one accumulator, as the forward
// does: one bf16 rounding of the state path breaks dlog_a's fp32 tolerance.
// Xbar, dY, B and C enter exactly, and W = dY Xbar^T is exact in fp32.

// rows a chunk of this body, at most, as shared memory is laid out: the
// wrapper chooses L (ssd_scan.py's TC_BWD_CHUNK) and the entry refuses more
constexpr int TC_CHUNK = 256;
constexpr int TL_THREADS = 256;

struct BwdTc {
  const __nv_bfloat16* xbar;  // [B,S,H,P]
  const float* log_a;         // [B,S,H]
  const __nv_bfloat16* bm;    // [B,S,G,N]
  const __nv_bfloat16* cm;
  const __nv_bfloat16* dy;    // [B,S,H,P]
  const float* dfinal;        // [B,H,P,N] or null
  const float* init;          // [B,H,P,N] or null
  __nv_bfloat16* dxbar;
  float* dlog_a;              // [B,S,H]
  float* db;                  // [B,S,G,N] fp32, zero at launch
  float* dc;
  float* dinit;               // [B,H,P,N] or null
  float* cum;                 // [B,H,nc,L]
  float* cb;                  // [B,nc,G,LT,LT]
  float* s_in;                // [B,H,nc,P,N]: emit, then S_in (bf16 hi, lo)
  float* ds_out;              // [B,H,nc,P,N]: demit, then dS_out
  float* dcum;                // [B,H,nc,L]
  float* dtot;                // [B,H,nc,1 + LT / 64]: the state part, then
                              // each 64-row tile's
  int B, S, H, G, L, nc, LT;
  int hs;                     // heads a slice of ssd_bwd_tile; db and dc
                              // hold one [B,S,G,N] a slice
};

// Per (b, chunk, head): the cumsum, emit and demit.
template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_bwd_emit(const BwdTc p) {
  constexpr int LDX = P + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sCum = reinterpret_cast<float*>(smem_raw);  // [TC_CHUNK]
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(sCum + TC_CHUNK);
  __nv_bfloat16* sXl = sX + 2 * TT * LDX;
  __nv_bfloat16* sB = sXl + TT * LDX;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const long long x_ss = (long long)p.H * P, b_ss = (long long)p.G * N;
  const long long xo = ((long long)b * p.S + r0) * x_ss + h * P;
  const long long bo = ((long long)b * p.S + r0) * b_ss + g * N;
  chunk_state_prefetch<P, N>(p.xbar + xo, x_ss, p.bm + bo, b_ss, l, sX, sB);

  // the cumsum in the order of a sequential scan, torch.cumsum's along a
  // dimension that is not the innermost: at the serve path's |cum| of about
  // 2000 a block scan moves each decay by about eps * |cum|, and dlog_a
  // with it, by several 1e-5 of its largest value
  const float* la = p.log_a + ((long long)b * p.S + r0) * p.H + h;
  for (int i = threadIdx.x; i < p.L; i += TC_THREADS)
    sCum[i] = i < l ? la[(long long)i * p.H] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 1; i < p.L; ++i) sCum[i] += sCum[i - 1];
  __syncthreads();
  const long long bhc = ((long long)b * p.H + h) * p.nc + c;
  for (int i = threadIdx.x; i < p.L; i += TC_THREADS)
    p.cum[bhc * p.L + i] = sCum[i];
  const float total = sCum[p.L - 1];
  chunk_state_tc<P, N>(p.xbar + xo, x_ss, p.bm + bo, b_ss, l, sCum, total,
                       true, sX, sXl, sB, p.s_in + bhc * P * N);
  chunk_state_prefetch<P, N>(p.dy + xo, x_ss, p.cm + bo, b_ss, l, sX, sB);
  chunk_state_tc<P, N>(p.dy + xo, x_ss, p.cm + bo, b_ss, l, sCum, total,
                       false, sX, sXl, sB, p.ds_out + bhc * P * N);
}

// v as a bf16 hi and lo, at element i of a [2][PN] bf16 slab
__device__ __forceinline__ void store_split(__nv_bfloat16* slab, long long pn,
                                            int i, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  slab[i] = hi;
  slab[pn + i] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Per (b, head): the state entering each chunk (over emit) and the gradient
// of the one leaving it (over demit), P N / 256 elements a thread; a slot is
// overwritten only after every thread has read it.
template <int P, int N>
__global__ void __launch_bounds__(256) ssd_bwd_pass(const BwdTc p) {
  constexpr int PN = P * N, EPT = PN / 256;
  __shared__ float sRed[8];
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const long long bh = (long long)b * p.H + h;
  const float* cum = p.cum + bh * p.nc * p.L;
  float s[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.init != nullptr ? p.init[bh * PN + threadIdx.x + e * 256] : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    float* slot = p.s_in + (bh * p.nc + c) * PN;
    float emit[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) emit[e] = slot[threadIdx.x + e * 256];
    const float decay = expf(cum[(long long)c * p.L + p.L - 1]);
    __syncthreads();  // every thread has read emit[c]
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      store_split(reinterpret_cast<__nv_bfloat16*>(slot), PN,
                  threadIdx.x + e * 256, s[e]);
      s[e] = fmaf(s[e], decay, emit[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.dfinal != nullptr ? p.dfinal[bh * PN + threadIdx.x + e * 256]
                               : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    float* slot = p.ds_out + (bh * p.nc + c) * PN;
    const __nv_bfloat16* sin =
        reinterpret_cast<const __nv_bfloat16*>(p.s_in + (bh * p.nc + c) * PN);
    float demit[EPT], part = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * 256;
      demit[e] = slot[i];
      const float sv = __bfloat162float(sin[i]) + __bfloat162float(sin[PN + i]);
      part = fmaf(s[e], sv, part);
    }
    const float total = cum[(long long)c * p.L + p.L - 1];
    const float decay = expf(total);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((threadIdx.x & 31) == 0) sRed[threadIdx.x >> 5] = part;
    __syncthreads();  // every thread has read demit[c]; sRed is complete
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < 8; ++w) sum += sRed[w];
      p.dtot[(bh * p.nc + c) * (1 + p.LT / TT)] = decay * sum;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      store_split(reinterpret_cast<__nv_bfloat16*>(slot), PN,
                  threadIdx.x + e * 256, s[e]);
      s[e] = fmaf(s[e], decay, demit[e]);
    }
    __syncthreads();  // sRed is read before it is written again
  }
  if (p.dinit != nullptr) {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      p.dinit[bh * PN + threadIdx.x + e * 256] = s[e];
  }
}

// acc[nt] (16 rows x 8 NT columns) += sum over a of A[a] B for one 16-deep
// step, B read from shared memory at `b` = (k 0, n 0): stored [k][n] (KN) or
// [n][k], pitch ld.
template <bool KN, int NT, int NA>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4],
                                        const uint32_t (&a)[NA][4],
                                        const __nv_bfloat16* b, int ld,
                                        int lane) {
#pragma unroll
  for (int nt = 0; nt + 1 < NT; nt += 2) {
    uint32_t f[4];
    if constexpr (KN)
      frag_b2_kn(f, b + nt * 8, ld, lane);
    else
      frag_b2_nk(f, b + nt * 8 * ld, ld, lane);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      mma_16816(acc[nt], a[i], f[0], f[1]);
      mma_16816(acc[nt + 1], a[i], f[2], f[3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    uint32_t f[2];
    if constexpr (KN)
      frag_b1_kn(f, b + (NT - 1) * 8, ld, lane);
    else
      frag_b1_nk(f, b + (NT - 1) * 8 * ld, ld, lane);
#pragma unroll
    for (int i = 0; i < NA; ++i) mma_16816(acc[NT - 1], a[i], f[0], f[1]);
  }
}

// The A fragment (16 x 16) of an fp32 matrix in shared memory, split: a[0]
// hi, a[1] lo.  Stored [m][k] or, with KM, [k][m]; pitch ld floats.
template <bool KM>
__device__ __forceinline__ void frag_a_f32(uint32_t (&a)[2][4],
                                           const float* base, int ld,
                                           int lane) {
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = g8 + (q & 1) * 8, k = t2 + (q >> 1) * 8;
    float x, y;
    if constexpr (KM) {
      x = base[k * ld + m];
      y = base[(k + 1) * ld + m];
    } else {
      const float2 v = *reinterpret_cast<const float2*>(base + m * ld + k);
      x = v.x;
      y = v.y;
    }
    __nv_bfloat162 hi, lo;
    split2(x, y, hi, lo);
    a[0][q] = bf16x2_bits(hi);
    a[1][q] = bf16x2_bits(lo);
  }
}

// The A fragments of a 16 x 32 fp32 accumulator (four n-tiles) as two
// 16-deep steps, split: a[kk][0] hi, a[kk][1] lo.
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[2][2][4],
                                           const float (&v)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = v[2 * kk + (q >> 1)] + (q & 1) * 2;
      __nv_bfloat162 hi, lo;
      split2(src[0], src[1], hi, lo);
      a[kk][0][q] = bf16x2_bits(hi);
      a[kk][1][q] = bf16x2_bits(lo);
    }
}

// the sum over the four threads of a fragment row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int P, int N>
constexpr int tile_smem_bytes(int T) {
  return 4 * (T * TT * (TT + 4) + TC_CHUNK + 2 * TT + 8) +
         2 * (2 * TT * (N + 8) +
              ((T + 1) * TT * (P + 8) > TT * (N + 8) ? (T + 1) * TT * (P + 8)
                                                     : TT * (N + 8)) +
              4 * P * (N + 8));
}

// Per (b, chunk, group, 64-row tile r, slice of the group's heads): every
// gradient of the tile's rows but dlog_a's reverse cumsum.  8 warps; warp w
// owns rows 16 (w % 4) of a 64-row product and one half (w / 4) of its
// columns, or of the depth of the dXbar products, whose halves are summed
// in shared memory at the end of each head.
template <int P, int N>
__global__ void __launch_bounds__(TL_THREADS, 1) ssd_bwd_tile(const BwdTc p) {
  constexpr int LDX = P + 8, LDN = N + 8, LDW = TT + 4;
  constexpr int NTX = P / 8;   // n-tiles of dXbar, all of P
  constexpr int NTP = P / 16;  // n-tiles of half of P
  constexpr int NTN = N / 16;  // n-tiles of half of N
  const int T = p.LT / TT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sWd = reinterpret_cast<float*>(smem_raw);  // [T][TT][LDW]
  float* sCum = sWd + T * TT * LDW;                 // [TC_CHUNK]
  // dcum of the tile's rows, one part for each half wn of the warps
  float* sDcum = sCum + TC_CHUNK;                   // [2][TT]
  float* sEsum = sDcum + 2 * TT;                    // [8]: dtotal by warp
  __nv_bfloat16* sBr = reinterpret_cast<__nv_bfloat16*>(sEsum + 8);
  __nv_bfloat16* sCr = sBr + TT * LDN;
  // Xbar tile j <= r at slot j, dY tile i >= r at slot i + 1; at the end, one
  // tile of B or C
  __nv_bfloat16* sXY = sCr + TT * LDN;
  __nv_bfloat16* sSt =  // [4][P][LDN]: dS_out hi, lo, S_in hi, lo
      sXY + ((T + 1) * TT * LDX > TT * LDN ? (T + 1) * TT * LDX : TT * LDN);

  const int r = blockIdx.x;
  const int g = blockIdx.y % p.G, c = (blockIdx.y / p.G) % p.nc;
  const int b = blockIdx.y / (p.G * p.nc);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  if (r * TT >= l) return;  // rows past the chunk's end: all zero
  const int rep = p.H / p.G;
  const int h0 = g * rep + blockIdx.z * p.hs;
  const int h1 = min(h0 + p.hs, (g + 1) * rep);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const long long x_ss = (long long)p.H * P, b_ss = (long long)p.G * N;
  const long long bo = ((long long)b * p.S + r0) * b_ss + g * N;
  const float* cbp = p.cb + (((long long)b * p.nc + c) * p.G + g) *
                                (long long)p.LT * p.LT;
  const __nv_bfloat16* sXr = sXY + r * TT * LDX;
  const __nv_bfloat16* sYr = sXY + (r + 1) * TT * LDX;

  load_bf16_rows_async<N, LDN, TT, TL_THREADS>(sBr, p.bm + bo, b_ss, r * TT,
                                               l);
  load_bf16_rows_async<N, LDN, TT, TL_THREADS>(sCr, p.cm + bo, b_ss, r * TT,
                                               l);
  cp_async_commit();
  for (int i = threadIdx.x; i < T * TT * LDW; i += TL_THREADS) sWd[i] = 0.f;

  // dB and dC of the tile's rows 16 wm + g8 (+ 8), columns N / 2 wn + 8 nt
  // + t2 (+ 1), summed over the slice's heads
  float dbr[NTN][4], dcr[NTN][4];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbr[nt][e] = dcr[nt][e] = 0.f;

  for (int h = h0; h < h1; ++h) {
    const long long bhc = ((long long)b * p.H + h) * p.nc + c;
    const long long xo = ((long long)b * p.S + r0) * x_ss + h * P;
    for (int j = 0; j <= r; ++j)
      load_bf16_rows_async<P, LDX, TT, TL_THREADS>(
          sXY + j * TT * LDX, p.xbar + xo, x_ss, j * TT, l);
    for (int i = r; i < T; ++i)
      load_bf16_rows_async<P, LDX, TT, TL_THREADS>(
          sXY + (i + 1) * TT * LDX, p.dy + xo, x_ss, i * TT, l);
    const __nv_bfloat16* dso =
        reinterpret_cast<const __nv_bfloat16*>(p.ds_out + bhc * P * N);
    const __nv_bfloat16* sin =
        reinterpret_cast<const __nv_bfloat16*>(p.s_in + bhc * P * N);
    load_bf16_rows_async<N, LDN, P, TL_THREADS>(sSt, dso, N, 0, P);
    load_bf16_rows_async<N, LDN, P, TL_THREADS>(sSt + P * LDN, dso + P * N, N,
                                                0, P);
    load_bf16_rows_async<N, LDN, P, TL_THREADS>(sSt + 2 * P * LDN, sin, N, 0,
                                                P);
    load_bf16_rows_async<N, LDN, P, TL_THREADS>(sSt + 3 * P * LDN,
                                                sin + P * N, N, 0, P);
    cp_async_commit();
    for (int i = threadIdx.x; i < p.L; i += TL_THREADS)
      sCum[i] = p.cum[bhc * p.L + i];
    if (threadIdx.x < 2 * TT) sDcum[threadIdx.x] = 0.f;
    // one lane of a warp owns each row of its half's part: no atomics
    float* dcum_w = sDcum + wn * TT + wm * 16 + g8;
    cp_async_wait<0>();
    __syncthreads();
    const float total = sCum[p.L - 1];

    // this warp's share of dXbar of the tile: rows 16 wm + g8 (+ 8), all P
    // columns, over half of each product's depth
    float dx[NTX][4];
#pragma unroll
    for (int nt = 0; nt < NTX; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dx[nt][e] = 0.f;

    // the pairs (r, j < r): W = dY_r Xbar_j^T, rows t of tile r, columns s
    // of tile j: rowsum(M o W) into dcum, Wd into its sum ([t][s])
    for (int j = 0; j <= r; ++j) {
      float w[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[1][4];
        frag_a(a[0], sYr + wm * 16 * LDX + ks * 16, LDX, lane);
        mma_row<false, 4, 1>(w, a, sXY + j * TT * LDX + wn * 32 * LDX + ks * 16,
                             LDX, lane);
      }
      float rows[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = wm * 16 + g8 + (e >> 1) * 8;
          const int sl = wn * 32 + nt * 8 + t2 + (e & 1);
          const int t = r * TT + tl, s = j * TT + sl;
          const bool ok = s <= t && t < l;
          const float lm = ok ? expf(sCum[t] - sCum[s]) : 0.f;
          const float m = ok ? cbp[(long long)t * p.LT + s] * lm : 0.f;
          rows[e >> 1] += m * w[nt][e];
          if (j < r) sWd[(j * TT + tl) * LDW + sl] += w[nt][e] * lm;
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(rows[q]);
        if ((lane & 3) == 0) dcum_w[q * 8] += v;
      }
    }

    // the pairs (i >= r, r): W^T = Xbar_r dY_i^T, rows s of tile r, columns
    // t of tile i: colsum(M o W) into dcum, Wd into its sum ([s][t]), and
    // dXbar_r += M^T dY_i over this warp's 32 t
    for (int i = r; i < T; ++i) {
      const __nv_bfloat16* sYi = sXY + (i + 1) * TT * LDX;
      float w[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[1][4];
        frag_a(a[0], sXr + wm * 16 * LDX + ks * 16, LDX, lane);
        mma_row<false, 4, 1>(w, a, sYi + wn * 32 * LDX + ks * 16, LDX, lane);
      }
      float cols[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = wm * 16 + g8 + (e >> 1) * 8;
          const int tl = wn * 32 + nt * 8 + t2 + (e & 1);
          const int s = r * TT + sl, t = i * TT + tl;
          const bool ok = s <= t && t < l;
          const float lm = ok ? expf(sCum[t] - sCum[s]) : 0.f;
          const float m = ok ? cbp[(long long)t * p.LT + s] * lm : 0.f;
          cols[e >> 1] += m * w[nt][e];
          sWd[(i * TT + sl) * LDW + tl] += w[nt][e] * lm;
          w[nt][e] = m;  // M^T from here on
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(cols[q]);
        if ((lane & 3) == 0) dcum_w[q * 8] -= v;
      }
      uint32_t a[2][2][4];
      frag_a_acc(a, w);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_row<true, NTX, 2>(dx, a[kk], sYi + (wn * 32 + kk * 16) * LDX, LDX,
                              lane);
    }

    // the state terms of the tile's rows
    float wend[2], wcum[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = r * TT + wm * 16 + g8 + q * 8;
      wend[q] = row < l ? expf(total - sCum[row]) : 0.f;
      wcum[q] = row < l ? expf(sCum[row]) : 0.f;
    }
    float e_sum = 0.f;
    {  // dXbar += exp(total - cum) o (B_r dS_out^T), columns P / 2 wn ..
      float xo_[NTP][4];
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xo_[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t a[1][4];
        frag_a(a[0], sBr + wm * 16 * LDN + ks * 16, LDN, lane);
        mma_row<false, NTP, 1>(xo_, a, sSt + wn * (P / 2) * LDN + ks * 16, LDN,
                               lane);
        mma_row<false, NTP, 1>(
            xo_, a, sSt + P * LDN + wn * (P / 2) * LDN + ks * 16, LDN, lane);
      }
      float ex[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sl = wm * 16 + g8 + (e >> 1) * 8;
          const int col = wn * (P / 2) + nt * 8 + t2 + (e & 1);
          const float v = xo_[nt][e] * wend[e >> 1];
          dx[wn * NTP + nt][e] += v;
          ex[e >> 1] += __bfloat162float(sXr[sl * LDX + col]) * v;
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(ex[q]);
        if ((lane & 3) == 0) {
          dcum_w[q * 8] -= v;
          e_sum += v;
        }
      }
    }
    {  // dB += exp(total - cum) o (Xbar_r dS_out), columns N / 2 wn ..
      float bo_[NTN][4];
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) bo_[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[1][4];
        frag_a(a[0], sXr + wm * 16 * LDX + ks * 16, LDX, lane);
        mma_row<true, NTN, 1>(bo_, a, sSt + ks * 16 * LDN + wn * (N / 2), LDN,
                              lane);
        mma_row<true, NTN, 1>(
            bo_, a, sSt + P * LDN + ks * 16 * LDN + wn * (N / 2), LDN, lane);
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dbr[nt][e] += bo_[nt][e] * wend[e >> 1];
    }
    {  // dC += exp(cum) o (dY_r S_in), and C_r . that into dcum
      float co[NTN][4];
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) co[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[1][4];
        frag_a(a[0], sYr + wm * 16 * LDX + ks * 16, LDX, lane);
        mma_row<true, NTN, 1>(
            co, a, sSt + 2 * P * LDN + ks * 16 * LDN + wn * (N / 2), LDN,
            lane);
        mma_row<true, NTN, 1>(
            co, a, sSt + 3 * P * LDN + ks * 16 * LDN + wn * (N / 2), LDN,
            lane);
      }
      float cd[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = wm * 16 + g8 + (e >> 1) * 8;
          const int col = wn * (N / 2) + nt * 8 + t2 + (e & 1);
          const float v = co[nt][e] * wcum[e >> 1];
          dcr[nt][e] += v;
          cd[e >> 1] += __bfloat162float(sCr[tl * LDN + col]) * v;
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float v = quad_sum(cd[q]);
        if ((lane & 3) == 0) dcum_w[q * 8] += v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e_sum += __shfl_xor_sync(0xffffffffu, e_sum, off);
    if (lane == 0) sEsum[warp] = e_sum;
    __syncthreads();  // the head's products are done; sDcum is complete
    if (threadIdx.x == 0) {  // this tile's part of dtotal, in warp order
      float e = 0.f;
      for (int w = 0; w < 8; ++w) e += sEsum[w];
      p.dtot[bhc * (1 + T) + 1 + r] = e;
    }

    // dXbar of the tile: the two halves of the depth summed
    float* sEx = reinterpret_cast<float*>(sXY);  // [TT][P + 4]
    if (wn == 1) {
#pragma unroll
      for (int nt = 0; nt < NTX; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<float2*>(
              sEx + (wm * 16 + g8 + q * 8) * (P + 4) + nt * 8 + t2) =
              make_float2(dx[nt][2 * q], dx[nt][2 * q + 1]);
    }
    if (threadIdx.x < TT && r * TT + threadIdx.x < p.L)
      p.dcum[bhc * p.L + r * TT + threadIdx.x] =
          sDcum[threadIdx.x] + sDcum[TT + threadIdx.x];
    __syncthreads();
    if (wn == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int sl = wm * 16 + g8 + q * 8;
        if (r * TT + sl >= l) continue;
        __nv_bfloat16* dst = p.dxbar + xo + (long long)(r * TT + sl) * x_ss;
#pragma unroll
        for (int nt = 0; nt < NTX; ++nt) {
          const float2 o = *reinterpret_cast<const float2*>(
              sEx + sl * (P + 4) + nt * 8 + t2);
          *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + t2) =
              __floats2bfloat162_rn(dx[nt][2 * q] + o.x,
                                    dx[nt][2 * q + 1] + o.y);
        }
      }
    }
    __syncthreads();  // sXY, sSt, sCum and sDcum are free for the next head
  }

  // dB_r += sum_{i >= r} Wd[i, r]^T C_i and dC_r += sum_{j <= r} Wd[r, j] B_j,
  // Wd summed over the slice's heads and split hi + lo; one tile of B or C
  // at a time in sXY
  for (int q = 0; q < T; ++q) {
    const __nv_bfloat16* tile = q == r ? nullptr : sXY;
    if (q != r) {
      load_bf16_rows_async<N, LDN, TT, TL_THREADS>(
          sXY, (q > r ? p.cm : p.bm) + bo, b_ss, q * TT, l);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wd = sWd + q * TT * LDW;
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk) {
      uint32_t a[2][4];
      if (q >= r) {  // [s][t]: dB_r, A = Wd^T rows s
        frag_a_f32<false>(a, wd + wm * 16 * LDW + kk * 16, LDW, lane);
        mma_row<true, NTN, 2>(dbr, a,
                              (q > r ? tile : sCr) + kk * 16 * LDN +
                                  wn * (N / 2),
                              LDN, lane);
      }
      if (q < r) {  // [t][s]: dC_r, A = Wd rows t
        frag_a_f32<false>(a, wd + wm * 16 * LDW + kk * 16, LDW, lane);
        mma_row<true, NTN, 2>(dcr, a, tile + kk * 16 * LDN + wn * (N / 2),
                              LDN, lane);
      }
      if (q == r) {  // the diagonal, stored [s][t]: dC_r reads it transposed
        frag_a_f32<true>(a, wd + kk * 16 * LDW + wm * 16, LDW, lane);
        mma_row<true, NTN, 2>(dcr, a, sBr + kk * 16 * LDN + wn * (N / 2), LDN,
                              lane);
      }
    }
    __syncthreads();  // the tile's readers are done before the next load
  }

  // this slice's dB and dC of the tile's rows, summed over the slices by
  // sum_cast_bf16
  const long long slice = (long long)blockIdx.z * p.B * p.S * p.G * N;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = r * TT + wm * 16 + g8 + q * 8;
    if (row >= l) continue;
    float* db = p.db + slice + bo + row * b_ss;
    float* dc = p.dc + slice + bo + row * b_ss;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (N / 2) + nt * 8 + t2;
      *reinterpret_cast<float2*>(db + col) =
          make_float2(dbr[nt][2 * q], dbr[nt][2 * q + 1]);
      *reinterpret_cast<float2*>(dc + col) =
          make_float2(dcr[nt][2 * q], dcr[nt][2 * q + 1]);
    }
  }
}

// One thread per (b, head, chunk): dlog_a = the reverse cumsum of dcum over
// the chunk's rows, dtotal added on its last row, in the order of a
// sequential scan (as the cumsum, torch.cumsum's); dtotal is the state part
// and then each 64-row tile's part that ssd_bwd_tile wrote (rows past l have
// none).
__global__ void __launch_bounds__(128) ssd_bwd_finish(const BwdTc p) {
  const long long idx = blockIdx.x * 128LL + threadIdx.x;  // heads fastest
  if (idx >= (long long)p.B * p.H * p.nc) return;
  const int h = (int)(idx % p.H), c = (int)(idx / p.H % p.nc);
  const int b = (int)(idx / ((long long)p.H * p.nc));
  const long long bhc = ((long long)b * p.H + h) * p.nc + c;
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const float* dcum = p.dcum + bhc * p.L;
  float* out = p.dlog_a + ((long long)b * p.S + r0) * p.H + h;
  const int T = p.LT / TT;
  const float* dtot = p.dtot + bhc * (1 + T);
  float acc = dtot[0];
  for (int r = 0; r < T && r * TT < l; ++r) acc += dtot[1 + r];
  for (int i = l - 1; i >= 0; --i) {
    acc += dcum[i];
    out[(long long)i * p.H] = acc;
  }
}

template <int P, int N>
int launch_tc(const BwdTc& p, cudaStream_t stream) {
  const int T = p.LT / TT;
  const CbArgs cb{p.bm, p.cm, (long long)p.S * p.G * N, (long long)p.G * N,
                  (long long)p.S * p.G * N, (long long)p.G * N, p.S, p.L,
                  p.nc, p.G, p.LT, p.cb};
  ssd_cb<N><<<dim3(T * (T + 1) / 2, p.nc, p.B * p.G), TC_THREADS, 0,
              stream>>>(cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_emit = sizeof(float) * TC_CHUNK +
                        2 * TT * (3 * (P + 8) + 2 * (N + 8));
  err = cudaFuncSetAttribute(ssd_bwd_emit<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_emit);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_emit<P, N><<<dim3(p.nc, p.H, p.B), TC_THREADS, smem_emit,
                       stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_bwd_pass<P, N><<<p.B * p.H, 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_tile = tile_smem_bytes<P, N>(T);
  err = cudaFuncSetAttribute(ssd_bwd_tile<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_tile);
  if (err != cudaSuccess) return (int)err;
  // the tiles of a chunk next to each other: they read the same heads'
  // states and tiles, which then come from L2
  ssd_bwd_tile<P, N><<<dim3(T, p.B * p.nc * p.G, (p.H / p.G + p.hs - 1) /
                                                     p.hs),
                       TL_THREADS, smem_tile, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_bhc = (long long)p.B * p.H * p.nc;
  ssd_bwd_finish<<<(unsigned)((n_bhc + 127) / 128), 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_tc_n(const BwdTc& p, int N, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_tc<P, 16>(p, s);
    case 32:
      return launch_tc<P, 32>(p, s);
    case 64:
      return launch_tc<P, 64>(p, s);
    case 128:
      return launch_tc<P, 128>(p, s);
    default:
      return -1;
  }
}

int dispatch_tc(const BwdTc& p, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_tc_n<16>(p, N, s);
    case 32:
      return dispatch_tc_n<32>(p, N, s);
    case 64:
      return dispatch_tc_n<64>(p, N, s);
    default:
      return -1;
  }
}

}  // namespace

// body: 0 = the fp32 FMA body (float32 tensors), 1 = the bf16 tensor-core
// body (bfloat16 tensors); the wrapper chooses it by type.  Every tensor
// contiguous; xbar, B, C, dy, dxbar and db_out / dc_out in the body's type,
// the rest fp32.  db_acc, dc_acc fp32 [ceil(H / G / hs),B,S,G,N], one
// [B,S,G,N] for each slice of hs heads of a group (the fp32 body takes hs =
// 1 and dc_acc zero at launch), summed in order into db_out / dc_out
// [B,S,G,N] (cast for bf16).
// dfinal, init and dinit may be null (zero; not written).  Chunks of L rows,
// nc = ceil(S / L), L chosen by the wrapper (which sizes the scratch from
// it): at most S, MAX_CHUNK and, for the tensor-core body, TC_CHUNK, else -1.
// s_in, ds_out [B,H,nc,P,N] fp32 scratch; the tensor-core body also takes
// cum and dcum [B,H,nc,L], cb [B,nc,G,LT,LT] (LT: L rounded up to a multiple
// of 64) and dtot [B,H,nc,1 + LT / 64], fp32 scratch (null for the FMA
// body), and hs, the heads a slice of its tile kernel takes (1 <= hs <=
// H / G; the wrapper chooses it so that the tiles and slices make about two
// blocks an SM).  P in (16, 32, 64), N in (16, 32, 64, 128).  Returns a
// cudaError_t, or -1 for an unsupported argument; never synchronises.
extern "C" int repro_ssd_scan_bwd(
    const void* xbar, const float* log_a, const void* bm, const void* cm,
    const void* dy, const float* dfinal, const float* init, void* dxbar,
    float* dlog_a, float* db_acc, float* dc_acc, void* db_out, void* dc_out,
    float* dinit, float* s_in, float* ds_out, float* cum, float* cb,
    float* dcum, float* dtot, int B, int S, int H, int G, int P, int N,
    int L, int hs, int body, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (L <= 0 || L > S || L > MAX_CHUNK || B > 65535 || H > 65535) return -1;
  if (body < 0 || body > 1 || db_out == nullptr || dc_out == nullptr ||
      (body == 0 && hs != 1))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    const int nc = (S + L - 1) / L;
    Params p{xbar,   log_a, bm,     cm,   dy, dfinal, init, dxbar, dlog_a,
             db_acc, dc_acc, dinit, s_in, ds_out, B,  S,    H,    G,
             L,      nc};
    int err = dispatch_p(p, P, N, s);
    if (err != 0) return err;
    const long long n = (long long)B * S * G * N;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    sum_slices_f32<<<blocks, 256, 0, s>>>(db_acc, H / G,
                                          static_cast<float*>(db_out), n);
    sum_slices_f32<<<blocks, 256, 0, s>>>(dc_acc, H / G,
                                          static_cast<float*>(dc_out), n);
    return (int)cudaGetLastError();
  }
  const int rep = H / G;
  if (cum == nullptr || cb == nullptr || dcum == nullptr || dtot == nullptr ||
      L > TC_CHUNK || hs < 1 || hs > rep)
    return -1;
  const int nc = (S + L - 1) / L;
  const int LT = (L + TT - 1) / TT * TT;
  if (nc > 65535 || (long long)B * nc * G > 65535) return -1;
  const BwdTc p{static_cast<const __nv_bfloat16*>(xbar),
                log_a,
                static_cast<const __nv_bfloat16*>(bm),
                static_cast<const __nv_bfloat16*>(cm),
                static_cast<const __nv_bfloat16*>(dy),
                dfinal,
                init,
                static_cast<__nv_bfloat16*>(dxbar),
                dlog_a,
                db_acc,
                dc_acc,
                dinit,
                cum,
                cb,
                s_in,
                ds_out,
                dcum,
                dtot,
                B, S, H, G, L, nc, LT, hs};
  int err = dispatch_tc(p, P, N, s);
  if (err != 0) return err;
  const long long n = (long long)B * S * G * N;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const int slices = (rep + hs - 1) / hs;
  sum_cast_bf16<<<blocks, 256, 0, s>>>(
      db_acc, slices, static_cast<__nv_bfloat16*>(db_out), n);
  sum_cast_bf16<<<blocks, 256, 0, s>>>(
      dc_acc, slices, static_cast<__nv_bfloat16*>(dc_out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_ssd_scan_bwd_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
