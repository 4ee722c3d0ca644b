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
// H=64, P=64, N=128, chunk 256, G=1) the scan does about 5.2e10 flop (lower-
// triangle pairs only, C B^T once per group) against about 0.30 GB moved, so
// the roofline bound (about 0.09 ms) is set by bytes.
//
// Two bodies, chosen by the type of xbar, B and C:
//   * bf16 (every served call): chunk-parallel on the tensor cores, four
//     kernels a call; see "bf16 body" below.
//   * fp32: the full-fp32 FMA body that follows, which the fp32 comparisons
//     of the serve paths hold to fp32 precision.
//
// The fp32 body, and how it differs from the TPU kernel:
//   * One block per (b, h), 256 threads, looping over the chunks inside the
//     block.  The fp32 state lives in shared memory for the whole scan,
//     transposed as St [N][P], where the TPU kernel carried it in VMEM
//     scratch across a sequential third grid axis.
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
//   * Every sum is an fp32 FMA, with no TF32 anywhere.
// Both bodies read B and C by group index (g = h / (H / G)) through batch
// and row strides, so the groups are never repeated to heads in device
// memory, and the model's views of its projection need no copy.  Both take
// a ragged S: rows >= S are read as xbar = log_a = B = C = 0 and never
// written, which leaves y and the state exactly as they are; the TPU kernel
// asserts S % chunk == 0.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"

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
template <int W, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int n_valid) {
  for (int idx = threadIdx.x; idx < RT * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    dst[r * LD + c] = r < n_valid ? src[r * stride + c] : 0.f;
  }
}

template <int P, int N>
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
  const float* xp = static_cast<const float*>(p.xbar) + x_off;
  float* yp = static_cast<float*>(p.y) + x_off;
  const float* la = p.log_a + (long long)b * p.S * p.H + h;
  const float* bp = static_cast<const float*>(p.bm) + b * p.b_sb + g * N;
  const float* cp = static_cast<const float*>(p.cm) + b * p.c_sb + g * N;

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
    chunk_cumsum<THREADS>(sCum, sWarp, la + (long long)r0 * p.H, p.H, l,
                          nt * RT);
    const float total = sCum[l - 1];

    float dS[RPT][CPT];  // this chunk's (exp(total - cum) Xbar)^T B, transposed
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) dS[r][cc] = 0.f;

    for (int qi = 0; qi < nt; ++qi) {
      const int q0 = qi * RT;
      __syncthreads();  // the previous tile's readers of sC / sB / sX / sP
      load_rows<N, LDN>(sC, cp + (long long)(r0 + q0) * p.c_ss, p.c_ss,
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
        load_rows<N, LDN>(sB, bp + (long long)(r0 + k0) * p.b_ss, p.b_ss,
                             l - k0);
        load_rows<P, LDP>(sX, xp + (long long)(r0 + k0) * x_ss, x_ss,
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
          float* out = yp + (long long)(r0 + row) * x_ss + tx * CPT;
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) out[cc] = acc[ii][cc];
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

template <int P, int N>
int launch(const Params& p, cudaStream_t stream) {
  const int cum = (p.chunk + RT - 1) / RT * RT;
  const size_t smem =
      sizeof(float) * ((size_t)N * (P + 4) + 2 * RT * (N + 4) +
                       RT * (P + 4) + RT * (RT + 4) + 8 + cum);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fwd<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.H, p.B);
  ssd_scan_fwd<P, N><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_n(const Params& p, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(p, stream);
    case 32:
      return launch<P, 32>(p, stream);
    case 64:
      return launch<P, 64>(p, stream);
    case 128:
      return launch<P, 128>(p, stream);
    default:
      return -1;
  }
}

int dispatch_p(const Params& p, int P, int N, cudaStream_t stream) {
  switch (P) {
    case 16:
      return dispatch_n<16>(p, N, stream);
    case 32:
      return dispatch_n<32>(p, N, stream);
    case 64:
      return dispatch_n<64>(p, N, stream);
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores, chunk-parallel
// ---------------------------------------------------------------------------
//
// Four kernels a call, in this order on the caller's stream:
//   ssd_cb           C_c B_c^T once per (b, chunk, group), the 64 x 64 tiles
//                    on or below the diagonal, into `cb` [B,nc,G,LT,LT] fp32
//                    (LT: L rounded up to whole tiles);
//   ssd_chunk_states per (b, chunk, head): the cumsum of log_a into `cum`
//                    [B,H,nc,L], and the chunk's own state contribution
//                    emit = (exp(total - cum) o Xbar)^T B into `st`
//                    [B,nc,H,P,N] fp32;
//   ssd_state_pass   one block per (b, head): over the chunks,
//                    S_in[c] = S; S <- exp(total_c) S + emit[c].  S_in
//                    overwrites emit in place as a bf16 hi and a bf16 lo
//                    matrix; the last S is the final state;
//   ssd_chunk_out    per (b, chunk, head, 64-row tile of the chunk):
//                    Y = exp(cum) o (C S_in^T) + ((C B^T) o L) Xbar.
// Every product runs on `mma.sync.m16n8k16` (bf16 in, fp32 accumulate).  An
// fp32 operand (the decayed Xbar of emit, (C B^T) o L, S_in) is split as
// hi = bf16(v), lo = bf16(v - hi) and multiplied twice into one accumulator,
// so it keeps about 16 bits of mantissa: one bf16 rounding of the decayed
// Xbar breaks the state's fp32 tolerance, and one of (C B^T) o L or S_in
// breaks y's at the reference's decays.  Xbar, B and C are bf16 inputs and
// enter the products exactly.

struct TcParams {
  const __nv_bfloat16* xbar;
  const float* log_a;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  const float* init;  // may be null: zero initial state
  __nv_bfloat16* y;
  float* state_out;
  float* cum;  // [B,H,nc,L]
  float* cb;   // [B,nc,G,LT,LT]
  float* st;   // [B,nc,H,P,N]
  int B, S, H, G, L, nc;
  int LT;  // row pitch of cb: L rounded up to whole tiles
  long long b_sb, b_ss, c_sb, c_ss;
};

// The cumsum of the chunk and its state contribution emit [P][N] for one
// (b, chunk, head): `chunk_state_tc` with the decay to the chunk's end.
template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_states(
    const TcParams p) {
  constexpr int LDX = P + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sCum = reinterpret_cast<float*>(smem_raw);  // [MAX_CHUNK]
  float* sWarp = sCum + MAX_CHUNK;                    // [32]
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(sWarp + 32);
  __nv_bfloat16* sXl = sX + 2 * TT * LDX;  // [2][l][p] Xbar, then hi; lo
  __nv_bfloat16* sB = sXl + TT * LDX;      // [2][l][n]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const long long x_ss = (long long)p.H * P;
  const __nv_bfloat16* xp = p.xbar + ((long long)b * p.S + r0) * x_ss + h * P;
  const __nv_bfloat16* bp = p.bm + b * p.b_sb + (long long)r0 * p.b_ss + g * N;
  chunk_state_prefetch<P, N>(xp, x_ss, bp, p.b_ss, l, sX, sB);

  const float* la = p.log_a + ((long long)b * p.S + r0) * p.H + h;
  chunk_cumsum<TC_THREADS>(sCum, sWarp, la, p.H, l, p.L);
  float* cum_out = p.cum + (((long long)b * p.H + h) * p.nc + c) * p.L;
  for (int i = threadIdx.x; i < p.L; i += TC_THREADS) cum_out[i] = sCum[i];
  chunk_state_tc<P, N>(xp, x_ss, bp, p.b_ss, l, sCum, sCum[p.L - 1], true,
                       sX, sXl, sB,
                       p.st + (((long long)b * p.nc + c) * p.H + h) * P * N);
}

// The state recurrence over the chunks for one (b, head), P N / 256
// elements of [P][N] a thread.  S_in[c] is written over emit[c] as two bf16
// matrices, hi then lo, once every thread has read emit[c]; the next
// chunk's emit is loaded before that, so the loads stay in flight.
template <int P, int N>
__global__ void __launch_bounds__(256) ssd_state_pass(const TcParams p) {
  constexpr int PN = P * N, EPT = PN / 256;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const long long bh = (long long)b * p.H + h;
  float s[EPT], next[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.init != nullptr ? p.init[bh * PN + threadIdx.x + e * 256] : 0.f;
  const float* cum = p.cum + bh * p.nc * p.L;
  float* slab = p.st + ((long long)b * p.nc * p.H + h) * PN;  // chunk 0
  const long long c_stride = (long long)p.H * PN;
#pragma unroll
  for (int e = 0; e < EPT; ++e) next[e] = slab[threadIdx.x + e * 256];
  for (int c = 0; c < p.nc; ++c, slab += c_stride) {
    float emit[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      emit[e] = next[e];
      if (c + 1 < p.nc) next[e] = slab[c_stride + threadIdx.x + e * 256];
    }
    const float decay = expf(cum[(long long)c * p.L + p.L - 1]);
    __syncthreads();  // every thread has read emit[c]
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(slab);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(s[e]);
      out[threadIdx.x + e * 256] = hi;
      out[PN + threadIdx.x + e * 256] =
          __float2bfloat16_rn(s[e] - __bfloat162float(hi));
      s[e] = fmaf(s[e], decay, emit[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    p.state_out[bh * PN + threadIdx.x + e * 256] = s[e];
}

// y for one 64-row tile of one (b, chunk, head).  Warp w owns rows 16w..
// of the tile and all P columns.  Key tiles of Xbar are double-buffered
// with cp.async, and a warp loads its C B^T fragments of a key tile before
// it waits for that tile.
template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_out(const TcParams p) {
  constexpr int LDC = N + 8, LDX = P + 8;
  constexpr int PT = P / 8;  // n-tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sCum = reinterpret_cast<float*>(smem_raw);  // [MAX_CHUNK]
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(sCum + MAX_CHUNK);
  __nv_bfloat16* sSh = sC + TT * LDC;  // S_in, hi and lo: [p][n]
  __nv_bfloat16* sSl = sSh + P * LDC;
  __nv_bfloat16* sX = sSl + P * LDC;   // [2][l][p] key tiles of Xbar

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int c = blockIdx.y;
  const int b = blockIdx.z / p.H, h = blockIdx.z % p.H;
  const int g = h / (p.H / p.G);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const int q0 = qi * TT;
  if (q0 >= l) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;

  const long long x_ss = (long long)p.H * P;
  const __nv_bfloat16* xp = p.xbar + ((long long)b * p.S + r0) * x_ss + h * P;
  const __nv_bfloat16* cp = p.cm + b * p.c_sb + (long long)r0 * p.c_ss + g * N;
  const __nv_bfloat16* sin = reinterpret_cast<const __nv_bfloat16*>(
      p.st + (((long long)b * p.nc + c) * p.H + h) * P * N);  // hi, lo
  load_bf16_rows_async<N, LDC>(sC, cp, p.c_ss, q0, l);
  load_bf16_rows_async<N, LDC, P>(sSh, sin, N, 0, P);
  load_bf16_rows_async<N, LDC, P>(sSl, sin + P * N, N, 0, P);
  load_bf16_rows_async<P, LDX>(sX, xp, x_ss, 0, l);
  cp_async_commit();

  const float* cum = p.cum + (((long long)b * p.H + h) * p.nc + c) * p.L;
  for (int i = threadIdx.x; i < p.L; i += TC_THREADS) sCum[i] = cum[i];
  cp_async_wait<0>();
  __syncthreads();

  float acc[PT][4];
#pragma unroll
  for (int i = 0; i < PT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // Y_off = C S_in^T, then scaled by exp(cum) of the row
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    frag_a(a, sC + warp * 16 * LDC + ks * 16, LDC, lane);
#pragma unroll
    for (int nt = 0; nt < PT; nt += 2) {
      uint32_t bh[4], bl[4];
      frag_b2_nk(bh, sSh + nt * 8 * LDC + ks * 16, LDC, lane);
      frag_b2_nk(bl, sSl + nt * 8 * LDC + ks * 16, LDC, lane);
      mma_16816(acc[nt], a, bh[0], bh[1]);
      mma_16816(acc[nt], a, bl[0], bl[1]);
      mma_16816(acc[nt + 1], a, bh[2], bh[3]);
      mma_16816(acc[nt + 1], a, bl[2], bl[3]);
    }
  }
  int row[2];
  float crow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + g8 + r * 8;
    crow[r] = sCum[min(row[r], p.L - 1)];
    const float e = expf(crow[r]);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      acc[i][2 * r] *= e;
      acc[i][2 * r + 1] *= e;
    }
  }

  // Y_diag = ((C B^T) o L) Xbar over the key tiles kj <= qi
  const float* cbp =
      p.cb + (((long long)b * p.nc + c) * p.G + g) * p.LT * p.LT;
  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * TT;
    const __nv_bfloat16* tX = sX + (kj & 1) * TT * LDX;
    if (kj < qi) {  // the next key tile into the other buffer
      load_bf16_rows_async<P, LDX>(sX + ((kj + 1) & 1) * TT * LDX, xp, x_ss,
                                   k0 + TT, l);
      cp_async_commit();
    }
    // on the diagonal tile, key steps past this warp's last row are empty
    const int n_ks = kj == qi ? warp + 1 : TT / 16;
    float2 cbv[TT / 16][2][2];  // [key step][half][row]
#pragma unroll
    for (int ks = 0; ks < TT / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = row[r], j = k0 + ks * 16 + half * 8 + t2;
          cbv[ks][half][r] = make_float2(0.f, 0.f);
          if (ks < n_ks && i < l && j <= i)
            cbv[ks][half][r] = *reinterpret_cast<const float2*>(
                cbp + (long long)i * p.LT + j);
        }
    if (kj < qi)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // key tile kj has landed
#pragma unroll
    for (int ks = 0; ks < TT / 16; ++ks) {
      if (ks >= n_ks) break;  // warp-uniform
      uint32_t ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = k0 + ks * 16 + half * 8 + t2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = row[r];
          float v0 = 0.f, v1 = 0.f;
          if (i < l && j <= i) {
            v0 = cbv[ks][half][r].x * expf(crow[r] - sCum[j]);
            if (j + 1 <= i)
              v1 = cbv[ks][half][r].y * expf(crow[r] - sCum[j + 1]);
          }
          __nv_bfloat162 hi, lo;
          split2(v0, v1, hi, lo);
          ah[half * 2 + r] = bf16x2_bits(hi);
          al[half * 2 + r] = bf16x2_bits(lo);
        }
      }
#pragma unroll
      for (int nt = 0; nt < PT; nt += 2) {
        uint32_t bf[4];
        frag_b2_kn(bf, tX + ks * 16 * LDX + nt * 8, LDX, lane);
        mma_16816(acc[nt], ah, bf[0], bf[1]);
        mma_16816(acc[nt], al, bf[0], bf[1]);
        mma_16816(acc[nt + 1], ah, bf[2], bf[3]);
        mma_16816(acc[nt + 1], al, bf[2], bf[3]);
      }
    }
    __syncthreads();  // readers of this buffer are done before its refill
  }

  __nv_bfloat16* yp = p.y + ((long long)b * p.S + r0) * x_ss + h * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= l) continue;
#pragma unroll
    for (int i = 0; i < PT; ++i)
      *reinterpret_cast<__nv_bfloat162*>(yp + row[r] * x_ss + i * 8 + t2) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int P, int N>
int launch_tc(const TcParams& p, cudaStream_t stream) {
  const int T = (p.L + TT - 1) / TT;
  const CbArgs cb{p.bm,   p.cm, p.b_sb, p.b_ss, p.c_sb, p.c_ss,
                  p.S,    p.L,  p.nc,   p.G,    p.LT,   p.cb};
  ssd_cb<N><<<dim3(T * (T + 1) / 2, p.nc, p.B * p.G), TC_THREADS, 0,
              stream>>>(cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_states =
      sizeof(float) * (MAX_CHUNK + 32) +
      sizeof(__nv_bfloat16) * TT * (3 * (P + 8) + 2 * (N + 8));
  err = allow_smem(ssd_chunk_states<P, N>, smem_states);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_states<P, N><<<dim3(p.nc, p.H, p.B), TC_THREADS, smem_states,
                           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_state_pass<P, N><<<p.B * p.H, 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_out =
      sizeof(float) * MAX_CHUNK +
      sizeof(__nv_bfloat16) * ((TT + 2 * P) * (N + 8) + 2 * TT * (P + 8));
  err = allow_smem(ssd_chunk_out<P, N>, smem_out);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<P, N><<<dim3(T, p.nc, p.B * p.H), TC_THREADS, smem_out,
                        stream>>>(p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_tc_n(const TcParams& p, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_tc<P, 16>(p, stream);
    case 32:
      return launch_tc<P, 32>(p, stream);
    case 64:
      return launch_tc<P, 64>(p, stream);
    case 128:
      return launch_tc<P, 128>(p, stream);
    default:
      return -1;
  }
}

int dispatch_tc(const TcParams& p, int P, int N, cudaStream_t stream) {
  switch (P) {
    case 16:
      return dispatch_tc_n<16>(p, N, stream);
    case 32:
      return dispatch_tc_n<32>(p, N, stream);
    case 64:
      return dispatch_tc_n<64>(p, N, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xbar, B, C and y; log_a, init_state and
// final_state are float32).  xbar, y, log_a, init_state and final_state are
// contiguous; B and C have unit stride along N and stride N between groups,
// with the given batch and row strides (elements).  init_state may be null.
// P in {16, 32, 64}, N in {16, 32, 64, 128}, 1 <= chunk <= 1024.
// bf16 only: the rows of B and C are 16-byte aligned, and the caller gives
// the scratch buffers, with L = min(chunk, S), nc = ceil(S / L) and LT = L
// rounded up to a multiple of 64: cum [B,H,nc,L], cb [B,nc,G,LT,LT] and
// st [B,nc,H,P,N], all fp32 (null for fp32 inputs).  Returns a cudaError_t,
// or -1 for an unsupported argument; never synchronises.
extern "C" int repro_ssd_scan_fwd(const void* xbar, const void* log_a,
                                  const void* bm, const void* cm,
                                  const void* init, void* y, void* state_out,
                                  void* cum, void* cb, void* st, int B, int S,
                                  int H, int G, int P, int N, int chunk,
                                  long long b_sb, long long b_ss,
                                  long long c_sb, long long c_ss, int dtype,
                                  void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0) return -1;
  if (chunk <= 0 || chunk > MAX_CHUNK || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p{xbar, static_cast<const float*>(log_a), bm, cm,
             static_cast<const float*>(init), y,
             static_cast<float*>(state_out), B, S, H, G, chunk, b_sb, b_ss,
             c_sb, c_ss};
    return dispatch_p(p, P, N, s);
  }
  if (dtype != 1 || cum == nullptr || cb == nullptr || st == nullptr)
    return -1;
  const int L = chunk < S ? chunk : S;
  const int nc = (S + L - 1) / L;
  if (nc > 65535 || (long long)B * H > 65535) return -1;
  TcParams p{static_cast<const __nv_bfloat16*>(xbar),
             static_cast<const float*>(log_a),
             static_cast<const __nv_bfloat16*>(bm),
             static_cast<const __nv_bfloat16*>(cm),
             static_cast<const float*>(init),
             static_cast<__nv_bfloat16*>(y),
             static_cast<float*>(state_out),
             static_cast<float*>(cum),
             static_cast<float*>(cb),
             static_cast<float*>(st),
             B, S, H, G, L, nc, (L + TT - 1) / TT * TT,
             b_sb, b_ss, c_sb, c_ss};
  return dispatch_tc(p, P, N, s);
}

extern "C" const char* repro_ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
