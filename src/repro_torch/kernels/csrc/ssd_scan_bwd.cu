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
//   * bf16: chunk-parallel on wgmma with TMA, four kernels and two sums a
//     call, every fp32 operand of a product split hi + lo; see its section
//     below.
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
// bf16 body: wgmma + TMA, chunk-parallel
// ---------------------------------------------------------------------------
//
// Four kernels a call and the two sums, in this order on the caller's
// stream, on chunks of L = min(chunk, 256, S) rows (the gradient does not
// depend on the chunk; at most four 64-row tiles keep a tile's work in
// shared memory):
//   ssd_emit             (ssd_tc.cuh) per (chunk, head, b): the cumsum
//                        (sequential, in torch.cumsum's order) into `cum`,
//                        then emit = (exp(total - cum) o Xbar)^T B into
//                        `s_in` and demit = (exp(cum) o dY)^T C into
//                        `ds_out`, each [P][N] fp32, the decayed Xbar / dY
//                        split hi + lo;
//   ssd_bwd_pass         per (b, head), elementwise over the chunks: S_in in
//                        the forward's order, written over emit as a bf16 hi
//                        and lo matrix; dS_out in reverse from d final_state,
//                        written over demit the same way; d init_state; and
//                        dtotal's state part exp(total) sum(dS_out o S_in);
//   ssd_bwd_tile         per (64-row tile r, (b, chunk, group), slice of the
//                        group's heads), looping over the heads: every
//                        gradient of the tile's rows but dlog_a's reverse
//                        cumsum (below);
//   ssd_bwd_finish       per (b, chunk, head), sequential: dlog_a = the
//                        reverse cumsum of dcum (its two parts added row by
//                        row), dtotal (the state part, then the tiles' parts
//                        in order) added on the chunk's last row;
//   sum_cast_bf16        dB and dC: the slices summed in order, cast.
// Every sum runs in a fixed order, so a call repeats bit for bit: no block
// adds into memory another block adds into, a thread sums its own elements
// in a fixed order, and a row's parts are summed within its warp or in warp
// order.  Every product runs on wgmma (bf16 in, fp32 accumulate), on the
// tiles of ssd_tc.cuh brought in by TMA.  An fp32 operand (the decayed
// Xbar and dY, S_in, dS_out, M, the summed Wd) is split hi + lo and
// multiplied twice into one accumulator, as the forward does: one bf16
// rounding of the state path breaks dlog_a's fp32 tolerance.  Xbar, dY, B
// and C enter exactly, and W = dY Xbar^T is exact in fp32.
// `ssd_scan_bwd_split_plain` (kernels/ssd_scan.py) is the same plan in
// plain PyTorch.
//
// ssd_bwd_tile.  384 threads: warpgroup 0 takes the tile's rows as t (the
// pairs (r, j <= r)), warpgroup 1 as s (the pairs (i >= r, r)), warpgroup 2
// produces (it gives its registers to the consumers, `setmaxnreg`).  For
// each head of the slice:
//   warpgroup 0, for j <= r: W = dY_r Xbar_j^T and C_r B_j^T by wgmma; M =
//     (C B^T) o Lmask and Wd = W o Lmask in registers; rowsum(M o W) into
//     dcum; Wd added into its sum over the slice's heads; then dC_r +=
//     exp(cum) o (dY_r S_in), and C_r . that into dcum;
//   warpgroup 1: first dXbar_r = exp(total - cum) o (B_r dS_out^T), Xbar_r
//     . that out of dcum and into the tile's part of dtotal, dB_r +=
//     exp(total - cum) o (Xbar_r dS_out); then for i >= r: W^T = Xbar_r
//     dY_i^T and B_r C_i^T; colsum(M o W) out of dcum; Wd^T into its sum
//     (i > r); dXbar_r += M^T dY_i with M^T split hi + lo as wgmma's
//     register A operand (as flash_attention_bwd.cu takes P and dS);
//     dXbar_r is written.
// The decays exp(cum_t - cum_s) run on the special-function unit (ex2):
// against ssd_scan_bwd_split_plain, dlog_a reads 5.2e-7 of its largest
// value at mamba2-1.3b's shape (chip_smoke.py; 4.2e-7 for the earlier
// kernel with expf), and SSD_BWD_SPLIT_LIMIT is 1e-5.
// After the last head: dC_r += sum_j Wd[r, j] B_j (warpgroup 0) and dB_r +=
// sum_i Wd[i, r]^T C_i (warpgroup 1; the diagonal's sum is warpgroup 0's,
// handed over as a bf16 hi and lo tile and read MN-major), each Wd sum
// split hi + lo: once a slice, not once a head; each slice writes its own
// dB and dC.
// What held the earlier tile kernel (warp-level m16n8k16 products, cp.async
// loads) back, and what this one does about it:
//   * C B^T was read element by element from an fp32 scratch in L2: here it
//     is formed by wgmma from B and C tiles that stay in shared memory for
//     the whole slice (the tiles B_j, j <= r, and C_i, i >= r);
//   * each head's loads waited for the last head's products: here a
//     producer keeps them in flight, Xbar_r, dY_r and the head's cumsum in
//     two buffers (the next head's while this head runs) and each
//     warpgroup's own tiles and states (a part of N at a time) in a ring of
//     its own;
//   * the Wd sums lived in padded shared memory that all threads read and
//     wrote: here each thread keeps its own elements, in register order (no
//     bank conflicts, no barriers);
//   * the two halves of the warps met at barriers every head: here the two
//     warpgroups run apart, each its own pairs, and meet only at the buffers
//     of Xbar_r and dY_r.
// What bounds it now, measured on an H100 (tools/ssd_bwd_variants.py and
// PERF.md): each warpgroup runs its steps one after the other (products,
// then the decays and sums in registers, then the next products), two
// consumer warpgroups an SM, so latency sets the time, not a unit's rate:
// of 1.39-1.40 ms at mamba2-1.3b's shape, forming C B^T again for every
// head takes 0.23 and the Wd sums' shared-memory traffic 0.22; no other
// part taken out alone saves as much (tools/ssd_bwd_variants.py).  A branch
// on the warpgroup that ptxas takes for divergent serializes every wgmma
// (C7520): the warpgroup index is made warp-uniform with a shuffle.
// Shared memory at N = 128, four tiles a chunk: 80 KB of B and C tiles,
// 64 KB of Wd sums, 34 KB for Xbar_r, dY_r and the cumsum, two 8 KB ring
// slots a warpgroup: 216 KB, one block an SM.

// rows a chunk of this body, at most, as shared memory is laid out: the
// wrapper chooses L (ssd_scan.py's TC_BWD_CHUNK) and the entry refuses more
constexpr int TC_CHUNK = 256;
constexpr int TL_T = TC_CHUNK / TT;  // tiles a chunk, at most
constexpr int TL_THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdTc {
  const float* dfinal;        // [B,H,P,N] or null
  const float* init;          // [B,H,P,N] or null
  __nv_bfloat16* dxbar;       // [B,S,H,P]
  float* dlog_a;              // [B,S,H]
  float* db;                  // [slices,B,S,G,N] fp32: dB of each slice
  float* dc;
  float* dinit;               // [B,H,P,N] or null
  float* cum;                 // [B,H,nc,LT]: the last value repeated past L
  float* s_in;                // [B,H,nc,P,N]: emit, then S_in (bf16 hi, lo)
  float* ds_out;              // [B,H,nc,P,N]: demit, then dS_out
  float* dcum;                // [2,B,H,nc,L]: warpgroup 0's part, then 1's
  float* dtot;                // [B,H,nc,1 + LT / 64]: the state part, then
                              // each 64-row tile's
  int B, S, H, G, L, nc, LT;
  int hs;                     // heads a slice of ssd_bwd_tile
};

struct TileMaps {
  CUtensorMap x, dy, b, c, s_in, ds_out;
};

// Shared memory of ssd_bwd_tile, and the slots of each consumer's ring (a
// tile each): as many as fit beside the rest at four tiles a chunk, at most
// four, at least two (the diagonal's Wd sum is handed over in ring 0).
template <int N>
struct TilePlan {
  static constexpr int NP = parts(N);
  static constexpr int SLOT = NP * TILE;  // a B or C tile
  static constexpr int WD = TT * TT * 4;  // one Wd sum, fp32
  static constexpr int XY = 2 * TILE;     // Xbar_r, dY_r; and the cumsum:
  static constexpr int CUM = TC_CHUNK * 4;
  static constexpr int MISC = 256;        // barriers and dtotal's parts
  static constexpr int FIXED =
      1024 + (TL_T + 1) * SLOT + TL_T * WD + 2 * (XY + CUM);
  static constexpr int FIT = (232448 - FIXED - MISC) / (2 * TILE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "ssd_bwd_tile does not fit shared memory");
  static constexpr int smem(int T) {
    return 1024 + (T + 1) * SLOT + T * WD + 2 * (XY + CUM) +
           2 * STAGES * TILE + MISC;
  }
};

// Per (b, head): the state entering each chunk (over emit) and the
// gradient of the one leaving it (over demit), P N / 256 elements a thread,
// each row written as a bf16 hi and a bf16 lo row; a slot is overwritten
// only after every thread has read it.  (Split by rows as the forward's
// pass is, it ran slower on an H100 at mamba2-1.3b's shape.)
template <int P, int N>
__global__ void __launch_bounds__(256) ssd_bwd_pass(const BwdTc p) {
  constexpr int PN = P * N, EPT = PN / 256;
  constexpr int row0 = 0, off = 0;
  __shared__ float sRed[8];
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const long long bh = (long long)b * p.H + h;
  const float* cum = p.cum + bh * p.nc * p.LT;
  const int T = p.LT / TT;
  const int at = split_row_at<N>(row0);
  float s[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.init != nullptr ? p.init[bh * PN + off + threadIdx.x + e * 256]
                             : 0.f;
  for (int c = 0; c < p.nc; ++c) {
    float* slot = p.s_in + (bh * p.nc + c) * PN;
    float emit[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) emit[e] = slot[off + threadIdx.x + e * 256];
    const float decay = expf(cum[(long long)c * p.LT + p.L - 1]);
    __syncthreads();  // every thread has read emit[c]
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      store_split_at(reinterpret_cast<__nv_bfloat16*>(slot), at + 512 * e, N,
                     s[e]);
      s[e] = fmaf(s[e], decay, emit[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.dfinal != nullptr
               ? p.dfinal[bh * PN + off + threadIdx.x + e * 256]
               : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    float* slot = p.ds_out + (bh * p.nc + c) * PN;
    const __nv_bfloat16* sin =
        reinterpret_cast<const __nv_bfloat16*>(p.s_in + (bh * p.nc + c) * PN);
    float demit[EPT], sum = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = threadIdx.x + e * 256;
      demit[e] = slot[off + i];
      const float sv = __bfloat162float(sin[at + 512 * e]) +
                       __bfloat162float(sin[at + 512 * e + N]);
      sum = fmaf(s[e], sv, sum);
    }
    const float total = cum[(long long)c * p.LT + p.L - 1];
    const float decay = expf(total);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((threadIdx.x & 31) == 0) sRed[threadIdx.x >> 5] = sum;
    __syncthreads();  // every thread has read demit[c]; sRed is complete
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += sRed[w];
      p.dtot[(bh * p.nc + c) * (1 + T)] = decay * t;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      store_split_at(reinterpret_cast<__nv_bfloat16*>(slot), at + 512 * e, N,
                     s[e]);
      s[e] = fmaf(s[e], decay, demit[e]);
    }
    __syncthreads();  // sRed is read before it is written again
  }
  if (p.dinit != nullptr) {
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      p.dinit[bh * PN + off + threadIdx.x + e * 256] = s[e];
  }
}

// the sum over the four threads of a fragment row (lanes 4g .. 4g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Per (64-row tile r, (b, chunk, group), slice of the group's heads); see
// the section's note.  Resident slot q of shared memory holds B_q for q <= r
// and C_(q - 1) beyond; the Wd sum of warpgroup 0's pair (r, j) is at Wd
// slot j ([t][s]), warpgroup 1's (i, r), i > r, at Wd slot i ([s][t]), each
// thread's 32 elements in register order.  The diagonal pair's is warpgroup
// 0's alone: warpgroup 1 reads it transposed, as a bf16 hi and lo tile that
// warpgroup 0 writes at the end.
template <int P, int N>
__global__ void __launch_bounds__(TL_THREADS, 1)
    ssd_bwd_tile(const __grid_constant__ TileMaps maps, const BwdTc p) {
  using TP = TilePlan<N>;
  constexpr int NP = TP::NP, SLOT = TP::SLOT, ST = TP::STAGES;
  const int T = p.LT / TT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t sRes = base;                     // [T + 1] slots
  const uint32_t sXY = sRes + (T + 1) * SLOT;     // [2][Xbar_r, dY_r]
  const uint32_t sCumA = sXY + 2 * TP::XY;        // [2][TC_CHUNK] fp32
  const uint32_t sR0 = sCumA + 2 * TP::CUM, sR1 = sR0 + ST * TILE;
  const uint32_t sWdA = sR1 + ST * TILE;          // [T] Wd sums
  const uint32_t bars = sWdA + T * TP::WD;
  const uint32_t res_full = bars;
  const Ring ring0{sR0, bars + 40, ST, TILE};
  const Ring ring1{sR1, bars + 40 + 16 * ST, ST, TILE};
  float* sEsum = reinterpret_cast<float*>(gen + (bars + 40 + 32 * ST - base));
  float4* sWd = reinterpret_cast<float4*>(gen + (sWdA - base));
  auto xy_full = [&](int i) { return bars + 8 + 8 * i; };
  auto xy_empty = [&](int i) { return bars + 24 + 8 * i; };

  const int r = blockIdx.x;
  const int g = blockIdx.y % p.G, c = (blockIdx.y / p.G) % p.nc;
  const int b = blockIdx.y / (p.G * p.nc);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  if (r * TT >= l) return;  // rows past the chunk's end: all zero
  const int Tl = (l + TT - 1) / TT;  // tiles with rows in the chunk
  const int rep = p.H / p.G;
  const int h0 = g * rep + blockIdx.z * p.hs;
  const int nh = min(h0 + p.hs, (g + 1) * rep) - h0;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(xy_full(i), 1);
      mbar_init(xy_empty(i), 8);  // every consumer warp
    }
    ring0.init(4);
    ring1.init(4);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, as a value the compiler knows to be the same across a
  // warp: a branch on threadIdx.x / 128 alone is divergent to ptxas, which
  // then serializes every wgmma behind it (C7520)
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
  if (wg == 2) {  // the producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int row_r = r0 + r * TT;
    if (threadIdx.x == 256) {  // B and C, Xbar_r and dY_r, ring 0
      mbar_expect_tx(res_full, (Tl + 1) * SLOT);
      for (int q = 0; q <= Tl; ++q) {
        const bool is_b = q <= r;
        for (int f = 0; f < NP; ++f)
          tma_load_4d(sRes + q * SLOT + f * TILE, is_b ? &maps.b : &maps.c,
                      res_full, 64 * f, r0 + (is_b ? q : q - 1) * TT, g, b);
      }
      int k = 0;
      for (int n = 0; n < nh; ++n) {
        const int h = h0 + n, xb = n & 1;
        if (n >= 2) mbar_wait(xy_empty(xb), ((n >> 1) - 1) & 1);
        mbar_expect_tx(xy_full(xb), 2 * TILE + p.LT * 4);
        bulk_load(sCumA + xb * TP::CUM,
                  p.cum + (((long long)b * p.H + h) * p.nc + c) * p.LT,
                  p.LT * 4, xy_full(xb));
        tma_load_4d(sXY + xb * 2 * TILE, &maps.x, xy_full(xb), 0, row_r, h,
                    b);
        tma_load_4d(sXY + xb * 2 * TILE + TILE, &maps.dy, xy_full(xb), 0,
                    row_r, h, b);
        for (int j = 0; j <= r; ++j, ++k) {  // Xbar_j
          ring0.acquire(k, TILE);
          tma_load_4d(ring0.slot(k), &maps.x, ring0.full(k), 0, r0 + j * TT,
                      h, b);
        }
        const int slab = (b * p.H + h) * p.nc + c;
        for (int f = 0; f < NP; ++f)
          for (int hl = 0; hl < 2; ++hl, ++k) {  // S_in part f, hi and lo
            ring0.acquire(k, TILE);
            tma_load_4d(ring0.slot(k), &maps.s_in, ring0.full(k), 64 * f, 0,
                        hl, slab);
          }
      }
    } else if (threadIdx.x == 288) {  // ring 1
      int k = 0;
      for (int n = 0; n < nh; ++n) {
        const int h = h0 + n;
        const int slab = (b * p.H + h) * p.nc + c;
        for (int f = 0; f < NP; ++f)
          for (int hl = 0; hl < 2; ++hl, ++k) {  // dS_out part f, hi, lo
            ring1.acquire(k, TILE);
            tma_load_4d(ring1.slot(k), &maps.ds_out, ring1.full(k), 64 * f,
                        0, hl, slab);
          }
        for (int i = r; i < Tl; ++i, ++k) {  // dY_i
          ring1.acquire(k, TILE);
          tma_load_4d(ring1.slot(k), &maps.dy, ring1.full(k), 0, r0 + i * TT,
                      h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ct = threadIdx.x & 127;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const int rr = r * TT + warp * 16 + g8;  // this thread's rows rr, rr + 8
  const long long x_ss = (long long)p.H * P, b_ss = (long long)p.G * N;
  const Ring& ring = wg == 0 ? ring0 : ring1;
  // this warpgroup's Wd sums
  const int q_lo = wg == 0 ? 0 : r + 1, q_hi = wg == 0 ? r + 1 : Tl;
  for (int q = q_lo; q < q_hi; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sWd[(q * 8 + i) * 128 + ct] = make_float4(0.f, 0.f, 0.f, 0.f);
  // dC_r (warpgroup 0) or dB_r (warpgroup 1), over the slice's heads
  float acc_bc[NP][8][4];
#pragma unroll
  for (int f = 0; f < NP; ++f) zero_acc(acc_bc[f]);
  const uint32_t sBr = sRes + r * SLOT, sCr = sRes + (r + 1) * SLOT;
  mbar_wait(res_full, 0);

  int k = 0;  // this warpgroup's ring items
  for (int n = 0; n < nh; ++n) {
    const int h = h0 + n, xb = n & 1;
    const long long bhc = ((long long)b * p.H + h) * p.nc + c;
    mbar_wait(xy_full(xb), (n >> 1) & 1);
    // the head's cumsum, LT values (the last repeated past L)
    const float* cum =
        reinterpret_cast<const float*>(gen + (sCumA + xb * TP::CUM - base));
    float cr[2];  // cum of this thread's rows
#pragma unroll
    for (int q = 0; q < 2; ++q) cr[q] = cum[rr + 8 * q];
    const uint32_t sX = sXY + xb * 2 * TILE, sY = sX + TILE;
    float part[2] = {0.f, 0.f};  // this thread's share of dcum of its rows

    if (wg == 0) {
      // the pairs (r, j <= r): rows t of tile r, columns s of tile j
      for (int j = 0; j <= r; ++j, ++k) {
        ring.wait(k);
        const uint32_t xj = ring.slot(k);
        float w[8][4], cb[8][4];
        zero_acc(w);
        zero_acc(cb);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n64<0, 0>(w, desc_k(sY, ks), desc_k(xj, ks), 1);
#pragma unroll
        for (int f = 0; f < NP; ++f)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64<0, 0>(cb, desc_k(sCr + f * TILE, ks),
                               desc_k(sRes + j * SLOT + f * TILE, ks), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(w);
        fence_acc(cb);
        ring.release(k);
        float4* wd = sWd + (j * 8) * 128 + ct;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e >> 1, t = rr + 8 * q;
            const int s = j * TT + 8 * i + t2 + (e & 1);
            const bool ok = s <= t && t < l;
            const float lm =
                ex2(ok ? (cr[q] - cum[s]) * LOG2E : -INFINITY);
            const float m = cb[i][e] * lm;
            part[q] += m * w[i][e];
            w[i][e] *= lm;
          }
          float4 v = wd[i * 128];
          v.x += w[i][0];
          v.y += w[i][1];
          v.z += w[i][2];
          v.w += w[i][3];
          wd[i * 128] = v;
        }
      }
      // dC_r += exp(cum) o (dY_r S_in), a part of N at a time, S_in hi
      // then lo; C_r . that into dcum
      const unsigned char* cR = gen + (sCr - base);
      float wc[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) wc[q] = rr + 8 * q < l ? expf(cr[q]) : 0.f;
#pragma unroll
      for (int f = 0; f < NP; ++f) {
        float co[8][4];
        zero_acc(co);
#pragma unroll
        for (int hl = 0; hl < 2; ++hl, ++k) {
          ring.wait(k);
          const uint32_t st = ring.slot(k);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64<0, 1>(co, desc_k(sY, kk), desc_mn(st, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(co);
          ring.release(k);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v0 = co[i][2 * q] * wc[q], v1 = co[i][2 * q + 1] * wc[q];
            acc_bc[f][i][2 * q] += v0;
            acc_bc[f][i][2 * q + 1] += v1;
            const float2 cv = tile_pair(cR + f * TILE, rr + 8 * q - r * TT,
                                        8 * i + t2);
            part[q] += cv.x * v0 + cv.y * v1;
          }
      }
    } else {
      // the state terms first, a part of N at a time, dS_out hi then lo:
      // dXbar_r = exp(total - cum) o (B_r dS_out^T), Xbar_r . that out of
      // dcum and into dtotal, dB_r += exp(total - cum) o (Xbar_r dS_out)
      float we[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        we[q] = rr + 8 * q < l ? expf(cum[p.L - 1] - cr[q]) : 0.f;
      float dx[8][4];
      zero_acc(dx);
#pragma unroll
      for (int f = 0; f < NP; ++f) {
        float bo[8][4];
        zero_acc(bo);
#pragma unroll
        for (int hl = 0; hl < 2; ++hl, ++k) {
          ring.wait(k);
          const uint32_t st = ring.slot(k);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64<0, 0>(dx, desc_k(sBr + f * TILE, ks),
                               desc_k(st, ks), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64<0, 1>(bo, desc_k(sX, kk), desc_mn(st, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dx);
          fence_acc(bo);
          ring.release(k);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_bc[f][i][2 * q] += bo[i][2 * q] * we[q];
            acc_bc[f][i][2 * q + 1] += bo[i][2 * q + 1] * we[q];
          }
      }
      const unsigned char* xR = gen + (sX - base);
      float e_sum = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float ev = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dx[i][2 * q] *= we[q];
          dx[i][2 * q + 1] *= we[q];
          const float2 xv = tile_pair(xR, rr + 8 * q - r * TT, 8 * i + t2);
          ev += xv.x * dx[i][2 * q] + xv.y * dx[i][2 * q + 1];
        }
        part[q] -= ev;
        e_sum += ev;
      }

      // the pairs (i >= r, r): rows s of tile r, columns t of tile i
      for (int i = r; i < Tl; ++i, ++k) {
        ring.wait(k);
        const uint32_t yi = ring.slot(k);
        float w[8][4], cb[8][4];
        zero_acc(w);
        zero_acc(cb);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n64<0, 0>(w, desc_k(sX, ks), desc_k(yi, ks), 1);
#pragma unroll
        for (int f = 0; f < NP; ++f)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64<0, 0>(cb, desc_k(sBr + f * TILE, ks),
                               desc_k(sRes + (i + 1) * SLOT + f * TILE, ks),
                               1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(w);
        fence_acc(cb);
        float4* wd = sWd + (i * 8) * 128 + ct;
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e >> 1, s = rr + 8 * q;
            const int t = i * TT + 8 * i8 + t2 + (e & 1);
            const bool ok = s <= t && t < l;
            const float lm =
                ex2(ok ? (cum[t] - cr[q]) * LOG2E : -INFINITY);
            const float m = cb[i8][e] * lm;
            part[q] -= m * w[i8][e];
            w[i8][e] *= lm;
            cb[i8][e] = m;  // M^T from here on
          }
          if (i > r) {  // the diagonal's sum is warpgroup 0's
            float4 v = wd[i8 * 128];
            v.x += w[i8][0];
            v.y += w[i8][1];
            v.z += w[i8][2];
            v.w += w[i8][3];
            wd[i8 * 128] = v;
          }
        }
        // dXbar_r += M^T dY_i
        uint32_t fh[4][4], fl[4][4];
        split_frags(cb, fh, fl);
        wgmma_fence();
        rs_split(dx, fh, fl, yi);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dx);
        ring.release(k);
      }
      __nv_bfloat16* dxp = p.dxbar + ((long long)b * p.S + r0) * x_ss +
                           (long long)h * P;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int s = rr + 8 * q;
        if (s < l) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (8 * i + t2 < P)
              *reinterpret_cast<__nv_bfloat162*>(dxp + s * x_ss + 8 * i +
                                                 t2) =
                  __floats2bfloat162_rn(dx[i][2 * q], dx[i][2 * q + 1]);
        }
      }
      // this tile's part of dtotal: the warps' sums in warp order
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        e_sum += __shfl_xor_sync(0xffffffffu, e_sum, off);
      if (lane == 0) sEsum[xb * 4 + warp] = e_sum;
      bar_sync(2, 128);
      if (ct == 0)
        p.dtot[bhc * (1 + T) + 1 + r] =
            ((sEsum[xb * 4] + sEsum[xb * 4 + 1]) +
                                         sEsum[xb * 4 + 2]) +
                                        sEsum[xb * 4 + 3];
    }

    // this warpgroup's part of dcum of the tile's rows
    float* dcum = p.dcum + (long long)wg * p.B * p.H * p.nc * p.L +
                  bhc * p.L;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float v = quad_sum(part[q]);
      if ((lane & 3) == 0 && rr + 8 * q < l) dcum[rr + 8 * q] = v;
    }
    if (lane == 0) mbar_arrive(xy_empty(xb));
  }

  // dC_r += sum_j Wd[r, j] B_j (warpgroup 0), dB_r += sum_i Wd[i, r]^T C_i
  // (warpgroup 1): the Wd sums split hi + lo, B_j and C_i read MN-major.
  // The diagonal's: warpgroup 0 writes its sum as a bf16 hi and lo tile
  // into ring 0 (free now), and warpgroup 1 reads them MN-major: Wd^T.
  const uint32_t sDh = sR0, sDl = sR0 + TILE;
  if (wg == 1) {
    bar_sync(3, 256);
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < NP; ++f) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(acc_bc[f], desc_mn(sDh, kk),
                           desc_mn(sCr + f * TILE, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(acc_bc[f], desc_mn(sDl, kk),
                           desc_mn(sCr + f * TILE, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < NP; ++f) fence_acc(acc_bc[f]);
  }
  for (int q = q_lo; q < q_hi; ++q) {
    float v[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 t = sWd[(q * 8 + i) * 128 + ct];
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    }
    uint32_t fh[4][4], fl[4][4];
    split_frags(v, fh, fl);
    if (wg == 0 && q == r) {  // the diagonal, for warpgroup 1
      unsigned char* dh = gen + (sDh - base);
      unsigned char* dl = gen + (sDl - base);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = warp * 16 + g8 + (e & 1) * 8;
          const int col = 16 * kk + (e >> 1) * 8 + t2;
          *reinterpret_cast<uint32_t*>(dh + swz(row, col)) = fh[kk][e];
          *reinterpret_cast<uint32_t*>(dl + swz(row, col)) = fl[kk][e];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive(3, 256);
    }
    // slot q holds B_q for q <= r, C_(q - 1) beyond
    const uint32_t bt = sRes + (wg == 0 ? q : q + 1) * SLOT;
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < NP; ++f) rs_split(acc_bc[f], fh, fl, bt + f * TILE);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < NP; ++f) fence_acc(acc_bc[f]);
  }

  // this slice's dC (warpgroup 0) or dB (warpgroup 1) of the tile's rows,
  // summed over the slices by sum_cast_bf16
  float* out = (wg == 0 ? p.dc : p.db) +
               (long long)blockIdx.z * p.B * p.S * p.G * N +
               ((long long)b * p.S + r0) * b_ss + (long long)g * N;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = rr + 8 * q;
    if (row >= l) continue;
#pragma unroll
    for (int f = 0; f < NP; ++f)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * f + 8 * i + t2;
        if (col < N)
          *reinterpret_cast<float2*>(out + row * b_ss + col) =
              make_float2(acc_bc[f][i][2 * q], acc_bc[f][i][2 * q + 1]);
      }
  }
}

// One thread per (b, head, chunk): dlog_a = the reverse cumsum of dcum over
// the chunk's rows (its two parts added row by row), dtotal added on its
// last row, in the order of a sequential scan (as the cumsum,
// torch.cumsum's); dtotal is the state part and then each 64-row tile's
// part that ssd_bwd_tile wrote (rows past l have none).
__global__ void __launch_bounds__(128) ssd_bwd_finish(const BwdTc p) {
  const long long idx = blockIdx.x * 128LL + threadIdx.x;  // heads fastest
  if (idx >= (long long)p.B * p.H * p.nc) return;
  const int h = (int)(idx % p.H), c = (int)(idx / p.H % p.nc);
  const int b = (int)(idx / ((long long)p.H * p.nc));
  const long long bhc = ((long long)b * p.H + h) * p.nc + c;
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const float* dcum0 = p.dcum + bhc * p.L;
  const float* dcum1 = dcum0 + (long long)p.B * p.H * p.nc * p.L;
  float* out = p.dlog_a + ((long long)b * p.S + r0) * p.H + h;
  const int T = p.LT / TT;
  const float* dtot = p.dtot + bhc * (1 + T);
  float acc = dtot[0];
  for (int r = 0; r < T && r * TT < l; ++r) acc += dtot[1 + r];
  for (int i = l - 1; i >= 0; --i) {
    acc += dcum0[i] + dcum1[i];
    out[(long long)i * p.H] = acc;
  }
}

template <int P, int N>
int launch_tc(const BwdTc& p, const EmitMaps& em, const EmitArgs& ea,
              const TileMaps& tm, cudaStream_t stream) {
  const int T = p.LT / TT;
  const int smem_emit = emit_smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_emit<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_emit);
  if (err != cudaSuccess) return (int)err;
  ssd_emit<P, N><<<dim3(p.nc, p.H, p.B), EMIT_THREADS, smem_emit, stream>>>(
      em, ea);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_bwd_pass<P, N><<<p.B * p.H, 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_tile = TilePlan<N>::smem(T);
  err = cudaFuncSetAttribute(ssd_bwd_tile<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_tile);
  if (err != cudaSuccess) return (int)err;
  // the tiles of a chunk next to each other: they read the same heads'
  // states and tiles, which then come from L2
  ssd_bwd_tile<P, N><<<dim3(T, p.B * p.nc * p.G, (p.H / p.G + p.hs - 1) /
                                                     p.hs),
                       TL_THREADS, smem_tile, stream>>>(tm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_bhc = (long long)p.B * p.H * p.nc;
  ssd_bwd_finish<<<(unsigned)((n_bhc + 127) / 128), 128, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_tc_n(const BwdTc& p, const EmitMaps& em, const EmitArgs& ea,
                  const TileMaps& tm, int N, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch_tc<P, 16>(p, em, ea, tm, s);
    case 32:
      return launch_tc<P, 32>(p, em, ea, tm, s);
    case 64:
      return launch_tc<P, 64>(p, em, ea, tm, s);
    case 128:
      return launch_tc<P, 128>(p, em, ea, tm, s);
    default:
      return -1;
  }
}

int dispatch_tc(const BwdTc& p, const EmitMaps& em, const EmitArgs& ea,
                const TileMaps& tm, int P, int N, cudaStream_t s) {
  switch (P) {
    case 16:
      return dispatch_tc_n<16>(p, em, ea, tm, N, s);
    case 32:
      return dispatch_tc_n<32>(p, em, ea, tm, N, s);
    case 64:
      return dispatch_tc_n<64>(p, em, ea, tm, N, s);
    default:
      return -1;
  }
}

}  // namespace

// body: 0 = the fp32 FMA body (float32 tensors), 1 = the bf16 wgmma body
// (bfloat16 tensors); the wrapper chooses it by type.  Every tensor
// contiguous; xbar, B, C, dy, dxbar and db_out / dc_out in the body's type,
// the rest fp32.  db_acc, dc_acc fp32 [ceil(H / G / hs),B,S,G,N], one
// [B,S,G,N] for each slice of hs heads of a group (the fp32 body takes hs =
// 1 and dc_acc zero at launch), summed in order into db_out / dc_out
// [B,S,G,N] (cast for bf16).
// dfinal, init and dinit may be null (zero; not written).  Chunks of L rows,
// nc = ceil(S / L), L chosen by the wrapper (which sizes the scratch from
// it): at most S, MAX_CHUNK and, for the wgmma body, TC_CHUNK, else -1.
// s_in, ds_out [B,H,nc,P,N] fp32 scratch; the wgmma body also takes cum
// [B,H,nc,LT] (LT: L rounded up to a multiple of 64), dcum [2,B,H,nc,L]
// and dtot [B,H,nc,1 + LT / 64], fp32 scratch (null for the FMA body),
// and hs, the heads a slice of its tile kernel takes (1 <= hs <= H / G; the
// wrapper chooses it so that the tiles and slices make about four blocks an
// SM).  P in (16, 32, 64), N in (16, 32, 64, 128).  Returns a cudaError_t,
// -1 for an unsupported argument or -2 when a tensor map cannot be
// encoded; never synchronises.
extern "C" int repro_ssd_scan_bwd(
    const void* xbar, const float* log_a, const void* bm, const void* cm,
    const void* dy, const float* dfinal, const float* init, void* dxbar,
    float* dlog_a, float* db_acc, float* dc_acc, void* db_out, void* dc_out,
    float* dinit, float* s_in, float* ds_out, float* cum, float* dcum,
    float* dtot, int B, int S, int H, int G, int P, int N, int L, int hs,
    int body, void* stream) {
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
  if (cum == nullptr || dcum == nullptr || dtot == nullptr || L > TC_CHUNK ||
      hs < 1 || hs > rep)
    return -1;
  const int nc = (S + L - 1) / L;
  const int LT = (L + TT - 1) / TT * TT;
  if (nc > 65535 || (long long)B * nc * G > 65535) return -1;
  const BwdTc p{dfinal, init,   static_cast<__nv_bfloat16*>(dxbar),
                dlog_a, db_acc, dc_acc, dinit, cum, s_in, ds_out, dcum, dtot,
                B,      S,      H,      G,     L,   nc,   LT,     hs};
  const EmitArgs ea{log_a, cum, s_in, ds_out, S, H, G, L, nc, LT};
  const long long x_ss = (long long)H * P, b_ss = (long long)G * N;
  TileMaps tm;
  if (rows_map(&tm.x, xbar, P, S, H, B, x_ss, P, S * x_ss) != 0 ||
      rows_map(&tm.dy, dy, P, S, H, B, x_ss, P, S * x_ss) != 0 ||
      rows_map(&tm.b, bm, N, S, G, B, b_ss, N, S * b_ss) != 0 ||
      rows_map(&tm.c, cm, N, S, G, B, b_ss, N, S * b_ss) != 0 ||
      state_map(&tm.s_in, s_in, P, N, (long long)B * H * nc) != 0 ||
      state_map(&tm.ds_out, ds_out, P, N, (long long)B * H * nc) != 0)
    return ERR_TENSOR_MAP;
  const EmitMaps em{tm.x, tm.b, tm.dy, tm.c};
  int err = dispatch_tc(p, em, ea, tm, P, N, s);
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
  if (code == ERR_TENSOR_MAP) return "a tensor map could not be encoded";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
