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
//   * bf16 (every served call): chunk-parallel on wgmma with TMA, three
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
// bf16 body: wgmma + TMA, chunk-parallel
// ---------------------------------------------------------------------------
//
// Three kernels a call, in this order on the caller's stream:
//   ssd_emit         (ssd_tc.cuh) per (chunk, head, b): the cumsum of log_a
//                    into `cum` [B,H,nc,LT], and the chunk's own state
//                    contribution emit = (exp(total - cum) o Xbar)^T B into
//                    `st` [B,H,nc,P,N] fp32;
//   ssd_state_pass   one block per (b, head, part of the rows of
//                    [P][N]): over the chunks, S_in[c] = S; S <-
//                    exp(total_c) S + emit[c].  S_in overwrites emit in
//                    place, each row as a bf16 hi row and a bf16 lo row;
//                    the last S is the final state;
//   ssd_chunk_out    per (64-row tile, chunk, b and head):
//                    Y = exp(cum) o (C S_in^T) + ((C B^T) o L) Xbar.
// Every product runs on wgmma (bf16 in, fp32 accumulate), its operands in
// the tiles of ssd_tc.cuh brought in by TMA.  An fp32 operand (the decayed
// Xbar of emit, (C B^T) o L, S_in) is split as hi = bf16(v), lo = bf16(v -
// hi) and multiplied twice into one accumulator, so it keeps about 16 bits
// of mantissa: one bf16 rounding of the decayed Xbar breaks the state's fp32
// tolerance, and one of (C B^T) o L or S_in breaks y's at the reference's
// decays.  Xbar, B and C are bf16 inputs and enter the products exactly.
// `ssd_scan_split_plain` (kernels/ssd_scan.py) is the same plan in plain
// PyTorch.
//
// ssd_chunk_out is causal attention with the decay mask in place of the
// softmax, and takes the shape of flash_attention.cu's wgmma body: warps
// 0-3 are one consumer warpgroup, warp 4 a producer that brings in the
// query tile's C once and, through a ring, S_in (hi, then lo) and each key
// tile's B and Xbar.  Y_off = C S_in^T by wgmma, both K-major; then for
// each key tile kj <= qi: C B^T by wgmma from shared memory (formed again
// for every head: no fp32 scratch of it, and no loads of it from L2),
// decayed and masked in registers (the exponential on the special-function
// unit: y is rounded to bf16), split hi + lo into wgmma's register A layout,
// then accumulated against the Xbar tile read MN-major, as flash reads V.
// Blocks run the longest query tiles first.
//
// What bounds them, measured on an H100 (PERF.md; tools/ssd_bwd_variants.py
// --fwd): the
// bound of the whole scan is bytes (0.30 GB against 5.2e10 flop at mamba2's
// shape, 0.089 ms), but each kernel runs its steps one after the other
// (load, product, decay, product) with four or eight consumer warps an SM,
// so latency, not a unit's rate, sets the time: of ssd_chunk_out's 0.30 ms
// at mamba2-1.3b's shape, the products with Xbar (A in registers) take
// 0.07, the decays 0.03, C B^T and C S_in^T 0.02 each.
// Against that: the ring keeps the next key tile in flight, S_in comes
// through the ring so that three blocks fit an SM at N = 128 (69 KB), and
// ssd_emit and the pass are at two and about four blocks an SM.

struct TcParams {
  const float* log_a;
  const float* init;  // may be null: zero initial state
  __nv_bfloat16* y;
  float* state_out;
  float* cum;  // [B,H,nc,LT]: the last value repeated past L
  float* st;   // [B,H,nc,P,N]
  int B, S, H, G, L, nc;
  int LT;  // L rounded up to whole 64-row tiles
};

// The state recurrence over the chunks for one (b, head, part of the rows
// of [P][N]), ROWS N / 256 elements a thread.  S_in[c] is written over
// emit[c], each row as a bf16 hi row and a bf16 lo row, once every thread
// has read emit[c]; the next chunk's emit is loaded before that, so the
// loads stay in flight.
// The forward's state pass runs one block per (b, head, part of the rows of
// [P][N]), 256 threads and at most 2048 elements a block.
__host__ __device__ constexpr int pass_parts(int p, int n) {
  return p * n > 2048 ? p * n / 2048 : 1;
}

template <int P, int N>
__global__ void __launch_bounds__(256) ssd_state_pass(const TcParams p) {
  constexpr int PN = P * N, PARTS = pass_parts(P, N);
  constexpr int PE = PN / PARTS, EPT = PE / 256;
  const int part = blockIdx.x % PARTS, bhx = blockIdx.x / PARTS;
  const int h = bhx % p.H, b = bhx / p.H;
  const int row0 = part * (P / PARTS), off = row0 * N;
  const long long bh = (long long)b * p.H + h;
  float s[EPT], next[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    s[e] = p.init != nullptr ? p.init[bh * PN + off + threadIdx.x + e * 256]
                             : 0.f;
  const float* cum = p.cum + bh * p.nc * p.LT;
  float* slab = p.st + bh * p.nc * PN;  // chunk 0
  const long long c_stride = PN;
  const int at = split_row_at<N>(row0);
#pragma unroll
  for (int e = 0; e < EPT; ++e) next[e] = slab[off + threadIdx.x + e * 256];
  for (int c = 0; c < p.nc; ++c, slab += c_stride) {
    float emit[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      emit[e] = next[e];
      if (c + 1 < p.nc)
        next[e] = slab[c_stride + off + threadIdx.x + e * 256];
    }
    const float decay = expf(cum[(long long)c * p.LT + p.L - 1]);
    __syncthreads();  // every thread has read emit[c]
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      store_split_at(reinterpret_cast<__nv_bfloat16*>(slab), at + 512 * e, N,
                     s[e]);
      s[e] = fmaf(s[e], decay, emit[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    p.state_out[bh * PN + off + threadIdx.x + e * 256] = s[e];
}

constexpr int OUT_THREADS = 160;
constexpr float LOG2E = 1.4426950408889634f;
// ring slots of ssd_chunk_out: two of 24 KB at N = 128 (three blocks an
// SM), three of 16 KB below
__host__ __device__ constexpr int out_stages(int n) { return n > 64 ? 2 : 3; }

struct OutMaps {
  CUtensorMap x, b, c, st;
};

template <int N>
constexpr int out_smem_bytes(int lt) {
  return 1024 + parts(N) * TILE + out_stages(N) * (parts(N) + 1) * TILE +
         8 * (1 + 2 * out_stages(N)) + 4 * lt;
}

// y for one 64-row tile qi of one (b, chunk, head).  C of the tile stays;
// the ring brings S_in hi, S_in lo, then each key tile's B and Xbar, so
// that three blocks fit an SM (69 KB of shared memory at N = 128).
template <int P, int N>
__global__ void __launch_bounds__(OUT_THREADS, 3)
    ssd_chunk_out(const __grid_constant__ OutMaps maps, const TcParams p) {
  constexpr int NP = parts(N), ST = out_stages(N);
  constexpr int STAGE = (NP + 1) * TILE;  // B_kj's parts, then Xbar_kj
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t sC = base;
  const Ring ring{sC + NP * TILE, sC + NP * TILE + ST * STAGE, ST, STAGE};
  const uint32_t head = ring.bars + 16 * ST;  // C landed
  float* sCum = reinterpret_cast<float*>(gen + (head + 8 - base));

  const int qi = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int c = blockIdx.y;
  const int b = blockIdx.z / p.H, h = blockIdx.z % p.H;
  const int g = h / (p.H / p.G);
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const int q0 = qi * TT;
  if (q0 >= l) return;
  if (threadIdx.x == 0) {
    ring.init(4);
    mbar_init(head, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer
    if (threadIdx.x == 128) {
      const int slab = (b * p.H + h) * p.nc + c;
      mbar_expect_tx(head, NP * TILE);
      for (int f = 0; f < NP; ++f)
        tma_load_4d(sC + f * TILE, &maps.c, head, 64 * f, r0 + q0, g, b);
      for (int hl = 0; hl < 2; ++hl) {  // items 0, 1: S_in hi, lo
        ring.acquire(hl, NP * TILE);
        for (int f = 0; f < NP; ++f)
          tma_load_4d(ring.slot(hl) + f * TILE, &maps.st, ring.full(hl),
                      64 * f, 0, hl, slab);
      }
      for (int kj = 0; kj <= qi; ++kj) {  // item 2 + kj: B_kj, Xbar_kj
        const int k = 2 + kj;
        const uint32_t s = ring.slot(k);
        ring.acquire(k, STAGE);
        for (int f = 0; f < NP; ++f)
          tma_load_4d(s + f * TILE, &maps.b, ring.full(k), 64 * f,
                      r0 + kj * TT, g, b);
        tma_load_4d(s + NP * TILE, &maps.x, ring.full(k), 0, r0 + kj * TT,
                    h, b);
      }
    }
    return;
  }

  const float* cum = p.cum + (((long long)b * p.H + h) * p.nc + c) * p.LT;
  for (int i = threadIdx.x; i < p.L; i += 128) sCum[i] = cum[i];
  bar_sync(1, 128);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;

  // Y_off = C S_in^T, S_in hi then lo, then scaled by exp(cum) of the row
  float y[8][4];
  zero_acc(y);
  mbar_wait(head, 0);
  for (int hl = 0; hl < 2; ++hl) {
    ring.wait(hl);
    const uint32_t st = ring.slot(hl);
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < NP; ++f)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64<0, 0>(y, desc_k(sC + f * TILE, ks),
                           desc_k(st + f * TILE, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(y);
    ring.release(hl);
  }
  int row[2];
  float crow[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    row[k] = q0 + warp * 16 + g8 + k * 8;
    crow[k] = sCum[min(row[k], p.L - 1)];
    const float e = expf(crow[k]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      y[i][2 * k] *= e;
      y[i][2 * k + 1] *= e;
    }
  }

  // Y_diag = ((C B^T) o L) Xbar over the key tiles kj <= qi
  for (int kj = 0; kj <= qi; ++kj) {
    const int k0 = kj * TT;
    ring.wait(2 + kj);
    const uint32_t s = ring.slot(2 + kj);
    float sc[8][4];
    zero_acc(sc);
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < NP; ++f)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64<0, 0>(sc, desc_k(sC + f * TILE, ks),
                           desc_k(s + f * TILE, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = e >> 1, j = k0 + 8 * i + t2 + (e & 1);
        const bool ok = j <= row[k] && row[k] < l;
        // 2^(x log2 e) on the special-function unit: y is rounded to bf16,
        // a few fp32 ulps of the decay do not reach it
        sc[i][e] *=
            ex2(ok ? (crow[k] - sCum[min(j, p.L - 1)]) * LOG2E : -INFINITY);
      }
    uint32_t fh[4][4], fl[4][4];
    split_frags(sc, fh, fl);
    wgmma_fence();
    rs_split(y, fh, fl, s + NP * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(y);
    ring.release(2 + kj);
  }

  __nv_bfloat16* yp =
      p.y + (((long long)b * p.S + r0) * p.H + h) * P;
  const long long x_ss = (long long)p.H * P;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (row[k] >= l) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * i + t2 < P)
        *reinterpret_cast<__nv_bfloat162*>(yp + row[k] * x_ss + 8 * i + t2) =
            __floats2bfloat162_rn(y[i][2 * k], y[i][2 * k + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int P, int N>
int launch_tc(const TcParams& p, const EmitMaps& em, const OutMaps& om,
              cudaStream_t stream) {
  const int T = (p.L + TT - 1) / TT;
  const EmitArgs ea{p.log_a, p.cum, p.st, nullptr, p.S,
                    p.H,     p.G,   p.L,  p.nc,    p.LT};
  const size_t smem_emit = emit_smem_bytes<P, N>();
  cudaError_t err = allow_smem(ssd_emit<P, N>, smem_emit);
  if (err != cudaSuccess) return (int)err;
  ssd_emit<P, N><<<dim3(p.nc, p.H, p.B), EMIT_THREADS, smem_emit, stream>>>(
      em, ea);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ssd_state_pass<P, N><<<p.B * p.H * pass_parts(P, N), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_out = out_smem_bytes<N>(T * TT);
  err = allow_smem(ssd_chunk_out<P, N>, smem_out);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<P, N><<<dim3(T, p.nc, p.B * p.H), OUT_THREADS, smem_out,
                        stream>>>(om, p);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_tc_n(const TcParams& p, const EmitMaps& em, const OutMaps& om,
                  int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_tc<P, 16>(p, em, om, stream);
    case 32:
      return launch_tc<P, 32>(p, em, om, stream);
    case 64:
      return launch_tc<P, 64>(p, em, om, stream);
    case 128:
      return launch_tc<P, 128>(p, em, om, stream);
    default:
      return -1;
  }
}

int dispatch_tc(const TcParams& p, const EmitMaps& em, const OutMaps& om,
                int P, int N, cudaStream_t stream) {
  switch (P) {
    case 16:
      return dispatch_tc_n<16>(p, em, om, N, stream);
    case 32:
      return dispatch_tc_n<32>(p, em, om, N, stream);
    case 64:
      return dispatch_tc_n<64>(p, em, om, N, stream);
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
// bf16 only: the base and the strides of B and C are 16-byte aligned (TMA
// reads them in place), and the caller gives the scratch buffers, with L =
// min(chunk, S), nc = ceil(S / L) and LT = L rounded up to a multiple of 64:
// cum [B,H,nc,LT] and st [B,H,nc,P,N], fp32 (null for fp32 inputs).
// Returns a cudaError_t, -1 for an unsupported
// argument or -2 when a tensor map cannot be encoded; never synchronises.
extern "C" int repro_ssd_scan_fwd(const void* xbar, const void* log_a,
                                  const void* bm, const void* cm,
                                  const void* init, void* y, void* state_out,
                                  void* cum, void* st, int B, int S, int H,
                                  int G, int P, int N, int chunk,
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
  if (dtype != 1 || cum == nullptr || st == nullptr) return -1;
  const int L = chunk < S ? chunk : S;
  const int nc = (S + L - 1) / L;
  if (nc > 65535 || (long long)B * H > 65535) return -1;
  const TcParams p{static_cast<const float*>(log_a),
                   static_cast<const float*>(init),
                   static_cast<__nv_bfloat16*>(y),
                   static_cast<float*>(state_out),
                   static_cast<float*>(cum),
                   static_cast<float*>(st),
                   B, S, H, G, L, nc, (L + TT - 1) / TT * TT};
  const long long x_ss = (long long)H * P;
  EmitMaps em;
  OutMaps om;
  if (rows_map(&om.x, xbar, P, S, H, B, x_ss, P, S * x_ss) != 0 ||
      rows_map(&om.b, bm, N, S, G, B, b_ss, N, b_sb) != 0 ||
      rows_map(&om.c, cm, N, S, G, B, c_ss, N, c_sb) != 0 ||
      state_map(&om.st, st, P, N, (long long)B * nc * H) != 0)
    return ERR_TENSOR_MAP;
  em.x = em.dy = om.x;  // the forward has one product: dy and c unused
  em.b = em.c = om.b;
  return dispatch_tc(p, em, om, P, N, s);
}

extern "C" const char* repro_ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP) return "a tensor map could not be encoded";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
