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
// What bounds it on this card: the five products, about 5 x 2 x D flop for
// every visible (query, key) pair (172 GFLOP at B 8, H 16, S 2048, D 64,
// causal), against a few hundred MB of traffic: operations, at the tensor
// cores' bf16 rate.
//
// Two bodies, chosen by the wrapper from the type (`flash_bwd_body`); both
// start with `delta` (one warp a row, rowsum(dO o O) in fp32, O and dO read
// through their strides) and sum dQ over the key tiles in an fp32 buffer in
// device memory, which a bf16 call casts once at the end (`cast`).
//   * bf16, D = 64 and 80: wgmma + TMA, warp-specialised; see its section
//     below.  P and dS are rounded once to bf16 for the products that take
//     them, as the forward rounds P.
//   * fp32: FMA from shared memory, every product in full fp32; see its
//     section below.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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
template <int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int n_rows) {
  for (int idx = threadIdx.x; idx < BT * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < n_rows ? src[row * stride + c] : 0.f;
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

// ---------------------------------------------------------------------------
// fp32 body: FMA from shared memory
// ---------------------------------------------------------------------------
//
// One block of 256 threads per (b, kv head, tile of 64 keys).  K and V of the
// tile stay in shared memory; the block walks the query heads of its group
// and, for each, the 64-row query tiles of the band (tiles outside the causal
// / window band are skipped, as the forward skips them; ragged Sq and Skv are
// masked), recomputes S and P from lse, and accumulates dK and dV in
// registers over all of them.  dQ of each (query tile, key tile) pair is
// added into the fp32 buffer with atomics (another block owns the other key
// tiles of the same rows).  Every product is fp32 FMA on fp32 copies of the
// operands in shared memory.  Each thread owns a 4 x (64 / 16) tile of S and
// dP and a 4 x (D / 16) tile of dK, dV and dQ; rows of K, V, Q and dO are
// padded to an odd length, so reads along a column are free of bank
// conflicts.

template <int D>
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

  load_rows<D, LD>(sK, static_cast<const float*>(p.k) + b * p.k_sb +
                              kvh * p.k_sh, p.k_ss, k_lo, p.Skv);
  load_rows<D, LD>(sV, static_cast<const float*>(p.v) + b * p.v_sb +
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
    const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dop =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q_lo = qt * BT;
      __syncthreads();  // the previous tile's readers are done
      load_rows<D, LD>(sQ, qp, p.q_ss, q_lo, p.Sq);
      load_rows<D, LD>(sO, dop, p.do_ss, q_lo, p.Sq);
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

  float* dkp =
      static_cast<float*>(p.dk) + (((long long)b * p.Hkv + kvh) * p.Skv) * D;
  float* dvp =
      static_cast<float*>(p.dv) + (((long long)b * p.Hkv + kvh) * p.Skv) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k_lo + ty * 4 + i;
    if (row < p.Skv) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dkp[(long long)row * D + tx + 16 * c] = dk[i][c] * p.scale;
        dvp[(long long)row * D + tx + 16 * c] = dv[i][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 body for D = 64 and 80: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
//
// One block of 384 threads per (b, kv head, tile of 128 keys), the blocks
// of a head next to each other, so that the dQ and the Q and dO tiles that
// the blocks in flight share stay in L2, and within a head the tiles of keys
// that see the most query tiles first (causal: the first keys).
// Warpgroups 0 and 1 consume, 64 keys each; warpgroup 2 produces: one thread
// brings K and V of the tile in once by TMA, then streams the Q and dO tiles
// (64 rows each) of every query head of the group and every query tile of
// the band through a ring of four stages, with an mbarrier for "full" and one
// for "empty" per stage.  Tiles outside the band are never loaded.  The
// scores are computed transposed, keys along the rows, so that dK and dV
// stay in registers along the keys for the whole block (FlashAttention-2/3's
// order), and no atomics are needed for them:
//   S^T  = K Q^T,  dP^T = V dO^T          wgmma, both operands in shared memory
//   P^T  = exp(S^T scale - lse), dS^T = P^T o (dP^T - delta)   in fp32
//                                          registers; the mask only on tiles
//                                          that the band, Skv or Sq cut
//   dV  += P^T dO,  dK += dS^T Q           wgmma, A = P^T / dS^T from registers
//                                          (rounded once to bf16), B = dO / Q
//                                          in shared memory, MN-major
//   dQ   = dS K (this warpgroup's keys)    wgmma, A = dS^T written to shared
//                                          memory in bf16 with the 128-byte
//                                          swizzle and read MN-major, B = K
// The two warpgroups' dQ of a tile are summed in shared memory, and one of
// them, in turns, adds the sum into the fp32 buffer with one bulk reduce-add
// (`cp.reduce.async.bulk`), the buffer laid out in the warpgroup's register
// order so that the shared-memory side has no bank conflicts; `cast` puts the
// rows back in order.  Measured on an H100 (tools/flash_variants.py --bwd):
// with each warpgroup adding its own share with 8-byte atomics the atomics
// took 0.46 of 1.57 ms at D = 64 and 1.13 of 3.26 ms at D = 80, and 0.22 of
// 1.24 and 0.53 of 2.74 with the sum added by 16-byte atomics, the blocks in
// the order
// of their key tiles over all heads: the dQ being summed (67 and 168 MB) did
// not fit L2.  Head by head, the reduce-add takes 0.01 and 0.03 ms of 0.93 and
// 2.04.  D = 80 splits every operand along D as the forward does: columns 0-63
// with the 128-byte swizzle, columns 64-79 with the 32-byte swizzle, each with
// its own tensor maps and descriptors.  The dS^T tiles are double-buffered, so
// that the next tile's writes never meet a dQ product still reading.  Each
// tile's accumulators S^T, dP^T and dQ are fresh arrays and no branch reads an
// accumulator between a commit and its wait: otherwise ptxas serializes every
// wgmma (C7514).

constexpr int BW_BK = 128;  // keys a block, 64 per consumer warpgroup
constexpr int BW_BQ = 64;   // query rows a tile
constexpr int BW_STAGES = 4;
constexpr int BW_THREADS = 384;
constexpr int BW_SMEM_FIXED = 1024 + 8 * (1 + 2 * BW_STAGES);

struct BwdMaps {  // [0]: columns 0-63; [1]: columns 64-79 (D = 80 only)
  CUtensorMap q[2], k[2], v[2], dout[2];
};

template <int D>
constexpr int bw_smem_bytes() {
  return BW_SMEM_FIXED + 2 * BW_BK * D * 2 + 2 * BW_STAGES * BW_BQ * D * 2 +
         4 * 64 * BW_BQ * 2 + 2 * BW_BQ * D * 4;
}

__device__ __forceinline__ void wg_sync(int id) {  // one warpgroup, 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// Named barriers over both consumer warpgroups, 256 threads.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ BwdMaps maps, const Params p) {
  constexpr bool SPLIT = D == 80;
  constexpr int DB = D - 64;  // narrow part: 0 or 16 columns
  constexpr int KA = BW_BK * 64 * 2, KB = BW_BK * DB * 2;  // bytes
  constexpr int QA = BW_BQ * 64 * 2, QB = BW_BQ * DB * 2;
  constexpr int DS = 64 * BW_BQ * 2;  // one warpgroup's dS^T tile
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles at 1024-byte boundaries, as the 128-byte swizzle wants
  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (smem_base + 1023) & ~1023u;
  const uint32_t sKA = base, sVA = sKA + KA;
  const uint32_t sQA = sVA + KA;                 // [stage]
  const uint32_t sOA = sQA + BW_STAGES * QA;     // [stage] dO
  const uint32_t sDS = sOA + BW_STAGES * QA;     // [warpgroup][buffer]
  const uint32_t sKB = sDS + 4 * DS, sVB = sKB + KB;
  const uint32_t sQB = sVB + KB;                 // [stage]
  const uint32_t sOB = sQB + BW_STAGES * QB;     // [stage]
  const uint32_t sDQ = sOB + BW_STAGES * QB;     // [buffer] dQ, fp32
  const uint32_t bars = sDQ + 2 * BW_BQ * D * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + BW_STAGES + s); };

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k_lo = kt * BW_BK;
  const int k_hi = min(k_lo + BW_BK, p.Skv) - 1;
  // the query tiles whose rows can see a key of this tile
  const int nqt = (p.Sq + BW_BQ - 1) / BW_BQ;
  const int qt_lo = p.causal ? k_lo / BW_BQ : 0;
  int qt_hi = nqt - 1;
  if (p.window > 0) qt_hi = min(qt_hi, (k_hi + p.window - 1) / BW_BQ);
  const int n_qt = max(0, qt_hi - qt_lo + 1);
  const int n_tiles = group * n_qt;  // over the group's heads

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * (KA + KB));
      tma_load_4d(sKA, &maps.k[0], kv_full, 0, k_lo, kvh, b);
      tma_load_4d(sVA, &maps.v[0], kv_full, 0, k_lo, kvh, b);
      if constexpr (SPLIT) {
        tma_load_4d(sKB, &maps.k[1], kv_full, 0, k_lo, kvh, b);
        tma_load_4d(sVB, &maps.v[1], kv_full, 0, k_lo, kvh, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % BW_STAGES;
        const int h = kvh * group + it / n_qt;
        const int q_lo = (qt_lo + it % n_qt) * BW_BQ;
        if (it >= BW_STAGES) mbar_wait(empty(s), (it / BW_STAGES - 1) & 1);
        mbar_expect_tx(full(s), 2 * (QA + QB));
        tma_load_4d(sQA + s * QA, &maps.q[0], full(s), 0, q_lo, h, b);
        tma_load_4d(sOA + s * QA, &maps.dout[0], full(s), 0, q_lo, h, b);
        if constexpr (SPLIT) {
          tma_load_4d(sQB + s * QB, &maps.q[1], full(s), 0, q_lo, h, b);
          tma_load_4d(sOB + s * QB, &maps.dout[1], full(s), 0, q_lo, h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const float scale2 = p.scale * LOG2E;  // P in base 2
  const int kw_lo = k_lo + wg * 64;      // this warpgroup's keys
  const int key0 = kw_lo + warp * 16 + g8;  // this thread's rows: key0, +8
  const uint32_t ka = sKA + wg * 64 * 128, va = sVA + wg * 64 * 128;
  const uint32_t kb = sKB + wg * 64 * 32, vb = sVB + wg * 64 * 32;

  float dk[8][4], dv[8][4], dkb[SPLIT ? 2 : 1][4], dvb[SPLIT ? 2 : 1][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < (SPLIT ? 2 : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkb[j][e] = dvb[j][e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % BW_STAGES;
    const int h = kvh * group + it / n_qt;
    const int q_lo = (qt_lo + it % n_qt) * BW_BQ;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    // lse (base 2) and delta of this thread's query columns; columns past
    // Sq read 0 and are masked
    float l2[16], dl[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int q = q_lo + (c >> 1) * 8 + t2 + (c & 1);
      l2[c] = q < p.Sq ? __ldg(p.lse + row_base + q) * LOG2E : 0.f;
      dl[c] = q < p.Sq ? __ldg(p.delta + row_base + q) : 0.f;
    }
    const uint32_t sq = sQA + s * QA, so = sOA + s * QA;
    const uint32_t sqb = sQB + s * QB, sob = sOB + s * QB;
    mbar_wait(full(s), (it / BW_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T
    float st[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(st, wg_desc(ka + ks * 32, 16, 1024, SW128),
                         wg_desc(sq + ks * 32, 16, 1024, SW128), ks);
    if constexpr (SPLIT)
      wgmma_ss_n64<0, 0>(st, wg_desc(kb, 16, 256, SW32),
                         wg_desc(sqb, 16, 256, SW32), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(dp, wg_desc(va + ks * 32, 16, 1024, SW128),
                         wg_desc(so + ks * 32, 16, 1024, SW128), ks);
    if constexpr (SPLIT)
      wgmma_ss_n64<0, 0>(dp, wg_desc(vb, 16, 256, SW32),
                         wg_desc(sob, 16, 256, SW32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dp);

    // P^T and dS^T in place of S^T and dP^T
    bool need_mask = kw_lo + 64 > p.Skv || q_lo + BW_BQ > p.Sq;
    if (p.causal) need_mask = need_mask || (kw_lo + 63 > q_lo);
    if (p.window > 0)
      need_mask = need_mask || (kw_lo <= q_lo + BW_BQ - 1 - p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e >> 1) * 8;
          const int q = q_lo + j * 8 + t2 + (e & 1);
          bool ok = q < p.Sq && key < p.Skv;
          if (p.causal) ok = ok && key <= q;
          if (p.window > 0) ok = ok && key > q - p.window;
          const int c = 2 * j + (e & 1);
          const float pv = ok ? ex2(fmaf(st[j][e], scale2, -l2[c])) : 0.f;
          st[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dl[c]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * j + (e & 1);
          const float pv = ex2(fmaf(st[j][e], scale2, -l2[c]));
          st[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dl[c]);
        }
    }
    // P^T and dS^T in wgmma's register A layout (key step kk: query columns
    // 16kk .. 16kk + 15), and dS^T in bf16 into this warpgroup's buffer:
    // row r (key) at r * 128 bytes, 16-byte chunk j at (j ^ (r & 7)) * 16
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pf[kk][1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pf[kk][2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pf[kk][3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      df[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      df[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      df[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      df[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    const uint32_t sds = sDS + (wg * 2 + (it & 1)) * DS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g8 + r * 8, j = 2 * kk + half;
          const uint32_t addr =
              sds + row * 128 + ((j ^ (row & 7)) << 4) + (lane & 3) * 4;
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr),
                       "r"(df[kk][half * 2 + r])
                       : "memory");
        }
    // the generic-proxy writes become visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + wg);

    // dV += P^T dO, dK += dS^T Q, dQ = dS K
    float dq[8][4], dqb[SPLIT ? 2 : 1][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dv, pf[kk], wg_desc(so + kk * 2048, 16, 1024, SW128));
      wgmma_rs_n64(dk, df[kk], wg_desc(sq + kk * 2048, 16, 1024, SW128));
      if constexpr (SPLIT) {
        wgmma_rs_n16(dvb, pf[kk], wg_desc(sob + kk * 512, 16, 256, SW32));
        wgmma_rs_n16(dkb, df[kk], wg_desc(sqb + kk * 512, 16, 256, SW32));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_n64<1, 1>(dq, wg_desc(sds + kk * 2048, 16, 1024, SW128),
                         wg_desc(ka + kk * 2048, 16, 1024, SW128), kk);
      if constexpr (SPLIT)
        wgmma_ss_n16<1, 1>(dqb, wg_desc(sds + kk * 2048, 16, 1024, SW128),
                           wg_desc(kb + kk * 512, 16, 256, SW32), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_acc(dq);
    if constexpr (SPLIT) {
      fence_acc(dvb);
      fence_acc(dkb);
      fence_acc(dqb);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(pf[kk][e]), "+r"(df[kk][e]));
    if (lane == 0) mbar_arrive(empty(s));  // Q and dO of this stage are read

    // The two warpgroups' dQ summed in shared memory, in this thread's order
    // ([register][thread], so neither side has bank conflicts): warpgroup
    // it % 2 adds its own share to the other's, and one of its threads adds
    // the tile into the fp32 buffer, laid out in the same order, with one
    // bulk reduce-add.  Barriers 3 + buf: buffer buf full; 5 + buf: read,
    // free again.
    constexpr int NQ = (8 + (SPLIT ? 2 : 0)) * 4;  // dQ registers a thread
    const int buf = it & 1;
    const uint32_t xq_addr = sDQ + buf * NQ * 128 * 4;
    float4* xq = reinterpret_cast<float4*>(smem_raw + (xq_addr - smem_base)) +
                 (threadIdx.x & 127);
    if (wg != buf) {
      if (it >= 2) pair_sync(5 + buf);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xq[j * 128] = make_float4(dq[j][0], dq[j][1], dq[j][2], dq[j][3]);
      if constexpr (SPLIT) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          xq[(8 + j) * 128] =
              make_float4(dqb[j][0], dqb[j][1], dqb[j][2], dqb[j][3]);
      }
      pair_arrive(3 + buf);
    } else {
      pair_sync(3 + buf);
      auto add = [&](float4* x, const float (&v)[4]) {
        const float4 o = *x;
        *x = make_float4((o.x + v[0]) * p.scale, (o.y + v[1]) * p.scale,
                         (o.z + v[2]) * p.scale, (o.w + v[3]) * p.scale);
      };
#pragma unroll
      for (int j = 0; j < 8; ++j) add(xq + j * 128, dq[j]);
      if constexpr (SPLIT) {
#pragma unroll
        for (int j = 0; j < 2; ++j) add(xq + (8 + j) * 128, dqb[j]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if ((threadIdx.x & 127) == 0) {
        float* dst = p.dq + ((long long)b * p.Hq + h) * nqt * (BW_BQ * D) +
                     (long long)(q_lo / BW_BQ) * (BW_BQ * D);
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
            "[%0], [%1], %2;\n" ::"l"(dst),
            "r"(xq_addr), "r"(NQ * 128 * 4)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      wg_sync(1 + wg);  // the reduce-add has read the buffer
      pair_arrive(5 + buf);
    }
  }
  // the last tile of the parity this warpgroup hands over left its buffer's
  // "free" barrier one arrival ahead: take it
  if (n_tiles > 1 - wg) pair_sync(5 + (1 - wg));

  // dK (scaled) and dV of this thread's keys, in bf16
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= p.Skv) continue;
    const long long off = (long long)key * D + t2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * r] * p.scale,
                                dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
    if constexpr (SPLIT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + off + 64 + j * 8) =
            __floats2bfloat162_rn(dkb[j][2 * r] * p.scale,
                                  dkb[j][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + off + 64 + j * 8) =
            __floats2bfloat162_rn(dvb[j][2 * r], dvb[j][2 * r + 1]);
      }
    }
  }
}

// dQ [B,Hq,Sq,D] in bf16 from the wgmma body's fp32 buffer [B,Hq,nqt,64 D],
// each 64-row tile in the register order of the warpgroup that adds it:
// element (r, d) of a tile is register 4 (d / 8) + 2 ((r % 16) / 8) + d % 2
// of thread 32 (r / 16) + 4 (r % 8) + (d % 8) / 2, at float offset
// 4 (128 register / 4 + thread) + register % 4.  One thread a pair of
// columns.
template <int D>
__global__ void cast_dq_bf16(const float* src, __nv_bfloat16* dst, int Sq,
                             long long n_pairs) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int d = (int)(i % (D / 2)) * 2;
  const long long row = i / (D / 2);  // over B Hq Sq
  const long long bh = row / Sq;
  const int q = (int)(row % Sq);
  const int nqt = (Sq + BW_BQ - 1) / BW_BQ, r = q % BW_BQ;
  const int reg = 4 * (d / 8) + 2 * ((r % 16) / 8);
  const int tid = 32 * (r / 16) + 4 * (r % 8) + (d % 8) / 2;
  const float* tile = src + (bh * nqt + q / BW_BQ) * (BW_BQ * D);
  const float2 v = *reinterpret_cast<const float2*>(
      tile + 4 * ((reg / 4) * 128 + tid) + reg % 4);
  *reinterpret_cast<__nv_bfloat162*>(dst + row * D + d) =
      __floats2bfloat162_rn(v.x, v.y);
}

template <typename T, int D>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  const dim3 dgrid((p.Sq + 7) / 8, p.Hq, p.B);
  flash_bwd_delta<T, D><<<dgrid, 256, 0, stream>>>(p);
  return cudaGetLastError();
}


template <int D>
int launch_fma(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(p, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (4 * BT * (D + 1) + 2 * BT * LP + 2 * BT);
  auto kernel = flash_bwd_main<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Skv + BT - 1) / BT, p.Hkv, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const Params& p, void* dq_out, cudaStream_t stream) {
  BwdMaps maps;
  const void* src[4] = {p.q, p.k, p.v, p.dout};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.dout};
  const int S[4] = {p.Sq, p.Skv, p.Skv, p.Sq};
  const int H[4] = {p.Hq, p.Hkv, p.Hkv, p.Hq};
  const int rows[4] = {BW_BQ, BW_BK, BW_BK, BW_BQ};
  const long long ss[4] = {p.q_ss, p.k_ss, p.v_ss, p.do_ss};
  const long long sh[4] = {p.q_sh, p.k_sh, p.v_sh, p.do_sh};
  const long long sb[4] = {p.q_sb, p.k_sb, p.v_sb, p.do_sb};
  for (int t = 0; t < 4; ++t) {
    int err = tensor_map_4d(&dst[t][0], src[t], 64, S[t], H[t], p.B, ss[t],
                            sh[t], sb[t], rows[t],
                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0 && D > 64)
      err = tensor_map_4d(&dst[t][1],
                          static_cast<const __nv_bfloat16*>(src[t]) + 64,
                          D - 64, S[t], H[t], p.B, ss[t], sh[t], sb[t],
                          rows[t], CU_TENSOR_MAP_SWIZZLE_32B);
    if (err != 0) return err;
  }
  cudaError_t err = launch_delta<__nv_bfloat16, D>(p, stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int smem = bw_smem_bytes<D>();
  auto kernel = flash_bwd_wgmma<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Skv + BW_BK - 1) / BW_BK, p.Hkv, p.B);
  kernel<<<grid, BW_THREADS, smem, stream>>>(maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)p.B * p.Hq * p.Sq * (D / 2);
  cast_dq_bf16<D><<<(unsigned)((n_pairs + 255) / 256), 256, 0, stream>>>(
      p.dq, static_cast<__nv_bfloat16*>(dq_out), p.Sq, n_pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0 = the fp32 FMA body (float32 tensors), 2 = the bf16 wgmma + TMA body
// (bfloat16 tensors); the wrapper chooses it by type.  D = 64 or 80.  lse
// [B,Hq,Sq] fp32 from the forward; delta [B,Hq,Sq] fp32 scratch; dq_acc fp32,
// zero at launch: for an fp32 call [B,Hq,Sq,D], its dQ; for a bf16 call
// [B,Hq,ceil(Sq / 64),64 D], a scratch in the body's register order that is
// cast into dq_out [B,Hq,Sq,D] bf16 (dq_out is null for fp32).  dk, dv
// [B,Hkv,Skv,D] contiguous.  q, k, v, o and dout are read through (batch, head,
// row) strides in elements with a unit stride along D; for bf16 every row of q,
// k, v and dout is 16-byte aligned (TMA's rule).  window <= 0 means no
// window.  Returns a cudaError_t, -1 for an unsupported argument or -2 if a
// tensor map cannot be made; never synchronises.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq_acc,
    void* dq_out, void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
    int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, float scale,
    int causal, int window, int body, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return -1;
  if (Hq % Hkv != 0 || Hq > 65535 || B > 65535) return -1;
  if ((body == 2) != (dq_out != nullptr) || (body != 0 && body != 2))
    return -1;
  if (D != 64 && D != 80) return -1;
  Params p{q,    k,    v,     o,     dout,  lse,   delta, dq_acc, dk,
           dv,   B,    Hq,    Hkv,   Sq,    Skv,   q_sb,  q_sh,   q_ss,
           k_sb, k_sh, k_ss,  v_sb,  v_sh,  v_ss,  o_sb,  o_sh,   o_ss,
           do_sb, do_sh, do_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return D == 64 ? launch_fma<64>(p, s) : launch_fma<80>(p, s);
  return D == 64 ? launch_wgmma<64>(p, dq_out, s)
                 : launch_wgmma<80>(p, dq_out, s);
}

extern "C" const char* repro_flash_attention_bwd_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
