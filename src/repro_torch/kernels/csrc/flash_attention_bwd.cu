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
// Two bodies, chosen by the wrapper from the type (`flash_bwd_body`), at
// D = 64, 80, 128, 160 and 256; both start with `delta` (one warp a row,
// rowsum(dO o O) in fp32, O and dO read through their strides) and sum dQ
// over the key tiles in fp32 in device memory, in a fixed order, the last
// key tile first: a call repeats bit for bit.
//   * bf16: wgmma + TMA, warp-specialised, in three layouts, each forming
//     S^T and dP^T once for every (key, query) pair, 5 products a tile:
//     `flash_bwd_wgmma` for D = 64 and 80, `flash_bwd_wide` with
//     `halves_consume` for 128 (128 keys a block, one warpgroup a 64-key
//     half) and with `shared_consume` for 160 and 256 (64 keys a block, the
//     scores split by query columns and handed over through shared memory);
//     see their section below.  P and dS are rounded once to bf16 for the
//     products that take them, as the forward rounds P; dQ is reduce-added
//     into one buffer, the key tiles taking turns, and cast once at the end.
//   * fp32: FMA from shared memory, every product in full fp32; each key
//     tile writes its own dQ partials and `sum_dq_tiles` adds them in order,
//     a run of key tiles at a time; see its section below.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

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
  float* dq;         // fp32 scratch: the bodies' dQ partials (see the entry)
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
  int kt0;     // fp32 body: the first key tile of the launch's run of tiles
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
// One block of 256 threads per (b, kv head, tile of 64 keys) and, at D = 256,
// per half of the head's columns (`fma_cols`: each block owns DH = 128 of
// them).  K and V of the tile stay in shared memory (at D = 256 they are
// brought in again for each query tile, a half at a time); the block walks
// the query heads of its group
// and, for each, the 64-row query tiles of the band (tiles outside the causal
// / window band are skipped, as the forward skips them; ragged Sq and Skv are
// masked), recomputes S and P from lse, and accumulates dK and dV in
// registers over all of them.  dQ of each (query tile, key tile) pair goes
// into the key tile's own slice of an fp32 scratch [G, B, Hq, Sq, D]
// (another block owns the other key tiles of the same rows).  The key tiles
// run in runs of G, the last run first: after each run `sum_dq_tiles` adds
// the slices of the pairs the band visits into dQ, the last key tile first,
// as the bf16 bodies order their sums: no atomics, a call repeats bit for
// bit, and G (the wrapper's choice) only bounds the scratch.  Every product is fp32 FMA on fp32 copies of the
// operands in shared memory.  Each thread owns a 4 x (64 / 16) tile of S and
// dP and a 4 x (DH / 16) tile of dK, dV and dQ; rows of K, V, Q and dO are
// padded to an odd length, so reads along a column are free of bank
// conflicts.
//
// D = 256: four 64 x 257 fp32 tiles alone would take 263 KB, and dK, dV and
// dQ of all 256 columns 192 registers a thread.  So each block owns one half
// of the columns (grid.y = 2 Hkv): S and dP are summed over both halves of
// D, the halves brought in one after the other in column order (both blocks
// of a key tile sum in the same order, so they form the same P and dS), and
// then its own half of Q, dO and K (brought in again if it was not the last)
// gives its columns of dV, dK and dQ.  Shared memory: four 64 x 129 fp32
// tiles, P and dS, lse and delta: 165,888 bytes; registers: dK, dV, dQ 96
// a thread, S and dP 32.

// columns of D a block of the fp32 body owns: all of them up to D = 160,
// half of them at 256
__host__ __device__ constexpr int fma_cols(int d) { return d > 160 ? 128 : d; }

// the query tiles [x, y] whose rows can see a key of key tile kt (empty
// when x > y); the main kernel visits them, `sum_dq_tiles` sums them
__device__ __forceinline__ int2 fma_query_tiles(const Params& p, int kt) {
  const int k_lo = kt * BT, k_hi = min(k_lo + BT, p.Skv) - 1;
  int lo = 0, hi = (p.Sq + BT - 1) / BT - 1;
  if (p.causal) lo = k_lo / BT;
  if (p.window > 0) hi = min(hi, (k_hi + p.window - 1) / BT);
  return make_int2(lo, hi);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_main(const Params p) {
  constexpr int DH = fma_cols(D);  // columns of D this block owns
  constexpr int NH = D / DH;       // blocks a key tile: 1, or 2 at D = 256
  constexpr int LD = DH + 1;   // odd: column reads are conflict-free
  constexpr int DC = DH / 16;  // columns of DH a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;    // dO
  float* sP = sO + BT * LD;
  float* sS = sP + BT * LP;    // dS
  float* sL = sS + BT * LP;    // lse of the tile's rows
  float* sD = sL + BT;         // delta of the tile's rows

  const int kt = p.kt0 + blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / NH, c0 = blockIdx.y % NH * DH;  // own columns
  const int group = p.Hq / p.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k_lo = kt * BT;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  if (NH == 1) {
    load_rows<DH, LD>(sK, kp, p.k_ss, k_lo, p.Skv);
    load_rows<DH, LD>(sV, vp, p.v_ss, k_lo, p.Skv);
  }

  // the query tiles whose rows can see a key of this tile
  const int2 qts = fma_query_tiles(p, kt);
  const int qt_lo = qts.x, qt_hi = qts.y;
  // this key tile's slice of the dQ partials
  float* dq_part = p.dq + (long long)blockIdx.x * p.B * p.Hq * p.Sq * D;

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
      if (threadIdx.x < BT) {
        const int row = q_lo + threadIdx.x;
        sL[threadIdx.x] = row < p.Sq ? p.lse[row_base + row] : 0.f;
        sD[threadIdx.x] = row < p.Sq ? p.delta[row_base + row] : 0.f;
      }

      // S = Q K^T and dP = dO V^T, over the column parts in order
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < NH; ++c) {
        __syncthreads();  // the previous part's or tile's readers are done
        if (NH > 1) {
          load_rows<DH, LD>(sK, kp + c * DH, p.k_ss, k_lo, p.Skv);
          load_rows<DH, LD>(sV, vp + c * DH, p.v_ss, k_lo, p.Skv);
        }
        load_rows<DH, LD>(sQ, qp + c * DH, p.q_ss, q_lo, p.Sq);
        load_rows<DH, LD>(sO, dop + c * DH, p.do_ss, q_lo, p.Sq);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
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
      }  // part c
      if (NH > 1 && c0 + DH < D) {  // this block's part again, but for V
        __syncthreads();
        load_rows<DH, LD>(sK, kp + c0, p.k_ss, k_lo, p.Skv);
        load_rows<DH, LD>(sQ, qp + c0, p.q_ss, q_lo, p.Sq);
        load_rows<DH, LD>(sO, dop + c0, p.do_ss, q_lo, p.Sq);
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
          float* dst = dq_part + (row_base + row) * D + c0;
#pragma unroll
          for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = dq[i][c] * p.scale;
        }
      }
    }
  }

  float* dkp =
      static_cast<float*>(p.dk) + (((long long)b * p.Hkv + kvh) * p.Skv) * D +
      c0;
  float* dvp =
      static_cast<float*>(p.dv) + (((long long)b * p.Hkv + kvh) * p.Skv) * D +
      c0;
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

// dq[i] += the partials of element i (over B Hq Sq D) of key tiles [kt0,
// kt1) in fp32, the last key tile first, over the tiles whose pair with the
// row's query tile the main kernel visited (the others hold no partial); the
// run that holds the last key tile starts from 0 instead of dq[i].  Over the
// runs, last first, that is one sum in key-tile order, whatever the runs.
template <int D>
__global__ void sum_dq_tiles(const Params p, float* dq, long long n, int kt1,
                             int first) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int qt = (int)((i / D) % p.Sq) / BT;
  float acc = first ? 0.f : dq[i];
  for (int kt = kt1 - 1; kt >= p.kt0; --kt) {
    const int2 qts = fma_query_tiles(p, kt);
    if (qt >= qts.x && qt <= qts.y) acc += p.dq[(kt - p.kt0) * n + i];
  }
  dq[i] = acc;
}

// ---------------------------------------------------------------------------
// bf16 bodies: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
//
// Two kernels share the plan below: `flash_bwd_wgmma` for D = 64 and 80 and
// `flash_bwd_wide` for D = 128, 160 and 256.  One block of 384 threads per
// (b, kv head, tile of keys), the blocks of a head next to each other, so
// that the dQ and the Q and dO tiles that the blocks in flight share stay in
// L2.  Warpgroups 0 and 1 consume; warpgroup 2 produces: one thread brings K
// and V of the tile in once by TMA, then streams the Q and dO tiles (64 rows
// each) of every query head of the group and every query tile of the band
// through a ring of stages, with an mbarrier for "full" and one for "empty"
// per stage.  Tiles outside the band are never loaded.  The scores are
// computed transposed, keys along the rows, so that dK and dV stay in
// registers along the keys for the whole block (FlashAttention-2/3's order),
// and no atomics are needed for them:
//   S^T  = K Q^T,  dP^T = V dO^T          wgmma, both operands in shared memory
//   P^T  = exp(S^T scale - lse), dS^T = P^T o (dP^T - delta)   in fp32
//                                          registers; the mask only on tiles
//                                          that the band, Skv or Sq cut
//   dV  += P^T dO,  dK += dS^T Q           wgmma, A = P^T / dS^T (rounded
//                                          once to bf16) from registers or
//                                          shared memory, B = dO / Q in shared
//                                          memory, MN-major
//   dQ   = dS K                            wgmma, A = dS^T written to shared
//                                          memory in bf16 with the 128-byte
//                                          swizzle and read MN-major, B = K
// Every operand is split along D as the forward splits it (`ColSplit`).  Each
// body forms S^T and dP^T once for every (key, query) pair: 5 products of
// D x 64 x 64 for every 64 keys and 64 queries.
//
// dQ is summed over the key tiles in a fixed order, so that a step repeats
// bit for bit: each 64-row dQ tile is added into an fp32 buffer in device
// memory with one bulk reduce-add (`cp.reduce.async.bulk`) a block, the
// buffer laid out in the warpgroups' register order so that the shared-memory
// side has no bank conflicts (`cast` puts the rows back in order), and the
// blocks that add to one tile take turns in the order of their key tiles,
// the last keys first: a counter per dQ tile in device memory (zero at
// launch) says how many have added, and a block waits for its turn before it
// adds.  The waiting and adding is a writer thread's of the producer
// warpgroup (`dq_write`): the consumers stage a tile's dQ in shared memory
// and go on, and wait only for the writer to have read the buffer before
// they stage into it again.  The blocks run in that order too
// (blockIdx.x 0 is the last key tile), so a block waits only on blocks that
// were launched before it, and under a causal mask a key tile reaches a
// query tile after the later key tiles, which start nearer the diagonal,
// have passed it.  Head by head, the summed dQ of the blocks in flight stays
// in L2: measured on an H100 with unordered adds, 0.01 and 0.03 ms of 0.93
// and 2.04 ms at D = 64 and 80 (tools/flash_variants.py --bwd); other
// orders took 0.22-1.13 ms.
//
// D = 64 and 80 (`flash_bwd_wgmma`): 128 keys a block, 64 per consumer
// warpgroup, each holding dK and dV of its keys (64 + 64 registers at D =
// 64); the two warpgroups' dQ of a tile are summed in shared memory, in
// one of two buffers by the tile's parity, for the writer to add.  The dS^T
// tiles are double-buffered, so that the next tile's writes never meet a dQ
// product still reading.
//
// D = 128 (`flash_bwd_wide` with `halves_consume`): 128 keys a block, 64
// per consumer warpgroup, as at 64 and 80.  But dK and dV of a warpgroup's
// 64 keys over all 128 columns take 128 registers a thread and S^T and dP^T
// 64 more, so a warpgroup cannot also form its keys' dQ over all 128
// columns (64) as the D = 64 body does.  The warpgroups split dQ's columns
// instead: warpgroup W forms S^T and dP^T of its own 64 keys (m64n64), P^T
// and dS^T in registers, dV and dK of its keys over all 128 columns (A from
// registers), and writes its dS^T in bf16 with the 128-byte swizzle into
// the tile's buffer; after a barrier over both warpgroups it forms its own
// 64 columns of dQ = dS K over all 128 keys (A MN-major from shared memory,
// B = K), 32 registers once S^T and dP^T are spent, and stages them for a
// writer and a counter of its own.  lse and delta of a tile come from
// shared memory: a warp of the producer (`stats_produce`) brings them in
// with the stage, the stage's second arrival, so that no thread holds them
// in registers.  Against 64 keys a block, every Q / dO tile of the band
// streams through the ring, and every dQ tile is reduce-added, half as
// often.  dS^T is double-buffered by the tile's parity, so the barrier of
// each tile also guards the buffer of the one before.  Shared memory: 1 KB
// of alignment, K and V 64 KB, three stages of Q and dO 96 KB and of their
// lse and delta 1.5 KB, the two warpgroups' dS^T in two buffers 32 KB, the
// dQ staging 32 KB, the barriers: 232,024 bytes of 232,448.
//
// D = 160 and 256 (`flash_bwd_wide` with `shared_consume`): 64 keys a
// block.  dK and dV of 128 keys would take 160 or 256 registers a thread,
// so a warpgroup cannot hold its own keys' gradients over all of D, and the
// warpgroups split D for the gradients instead; to form each score once,
// they split the tile's query columns for the scores.  Each warpgroup
// computes S^T and dP^T of the 64 keys against its own 32 query columns of
// the tile (m64n32, 16 + 16 registers), forms its half of P^T and dS^T and
// writes both in bf16 into shared memory with the 128-byte swizzle; after a
// barrier over both warpgroups each reads all of P^T and dS^T as A from
// shared memory: dV += P^T dO and dK += dS^T Q (A K-major) and dQ = dS K (A
// MN-major) for its own columns, NF / 2 64-column parts from part W NF / 2,
// and at D = 160 warpgroup 1 the narrow part too: columns 0-63 and 64-159
// at 160 (dK and dV 64 or 96 registers), 0-127 and 128-255 at 256 (128).
// dQ is formed after S^T and dP^T are spent (32, 48 or 64 registers).  P^T
// and dS^T are double-buffered by the tile's parity.  Shared memory at 160:
// K and V 40 KB, two stages of Q and dO 80 KB, P^T and dS^T twice 32 KB,
// the dQ staging 40 KB: 197,720 bytes; at 256: K and V 64 KB, one stage of
// Q and dO 64 KB, the rest as at 160 with 64 KB of staging: 230,456 bytes,
// so at 256 the next tile's load waits for this one's products.  dQ is
// summed over the key tiles in the same fixed order, a writer and a counter
// a warpgroup.
//
// Each tile's accumulators S^T, dP^T and dQ are fresh arrays and no branch
// reads an accumulator between a commit and its wait: otherwise ptxas
// serializes every wgmma (C7514).  At D = 128, S^T and dP^T of the next tile
// issued before this tile's dQ is staged put a wgmma under a branch (C7518)
// or, peeled out of the loop, spilled (C7520 too); dQ formed a tile behind,
// the warpgroups half a tile apart, gained nothing on an H100: the body
// keeps its tiles in series.

constexpr int BW_BQ = 64;   // query rows a tile
constexpr int BW_THREADS = 384;

struct BwdMaps {  // [0]: the 64-column parts; [1]: the narrow part
  CUtensorMap q[2], k[2], v[2], dout[2];
};

// keys a block, stages of the Q / dO ring and shared memory of each body
template <int D>
struct BwdPlan {
  static constexpr bool WIDE = D > 80;        // flash_bwd_wide
  static constexpr bool HALVES = D == 128;    // halves_consume
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int STAGES = D <= 80 ? 4 : D <= 128 ? 3 : D <= 160 ? 2 : 1;
  static constexpr int KT = BK * D * 2, QT = BW_BQ * D * 2;  // tile bytes
  static constexpr int DS = 64 * BW_BQ * 2;  // one dS^T tile
  static constexpr int ST = HALVES ? 2 * BW_BQ * 4 : 0;  // lse, delta a stage
  static constexpr int SMEM = 1024 + 2 * KT + 2 * STAGES * QT + 4 * DS +
                              (WIDE ? 1 : 2) * BW_BQ * D * 4 + STAGES * ST +
                              8 * (1 + 2 * STAGES + 4);
  static_assert(SMEM <= 232448, "shared memory of one block");
};

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

// The key tile a block takes: the last first (see the plan above).
__device__ __forceinline__ int block_key_tile() {
  return gridDim.x - 1 - blockIdx.x;
}

// The query tiles [qt_lo, qt_hi] whose rows can see a key of key tile kt
// (`bk` keys a tile), and the last key tile that adds to query tile qt:
// every key tile from the first that sees qt to this one adds to it.
struct Band {
  int qt_lo, qt_hi, nkt, ratio;  // ratio: key tile / query tile rows
  __device__ Band(const Params& p, int kt, int bk) {
    const int k_lo = kt * bk, k_hi = min(k_lo + bk, p.Skv) - 1;
    nkt = (p.Skv + bk - 1) / bk;
    ratio = bk / BW_BQ;
    qt_lo = p.causal ? k_lo / BW_BQ : 0;
    qt_hi = (p.Sq + BW_BQ - 1) / BW_BQ - 1;
    if (p.window > 0) qt_hi = min(qt_hi, (k_hi + p.window - 1) / BW_BQ);
  }
  __device__ int last_key_tile(const Params& p, int qt) const {
    return p.causal ? min(nkt - 1, qt / ratio) : nkt - 1;
  }
};

// The dQ writer: one thread of the producer warpgroup adds the staged dQ
// tiles of the block into the fp32 buffer in device memory, in order, each
// in its turn.  For tile it of the block (buffer it % NBUF of the staging
// ring at `stage`, `bytes` of fp32, for query head h and query tile qt): it
// waits until the consumers have staged it (`full`), until the counter of
// the tile (zero at launch) reads the number of blocks before this one in
// the fixed order, adds it with one bulk reduce-add, frees the buffer once
// read (`empty`), and counts its add once written.  The consumers never wait
// for another block: only this thread does, while they go on to the next
// tile.
template <int NBUF>
__device__ __forceinline__ void dq_write(const Params& p, int* counters,
                                         int slot, int dst_offset, int bytes,
                                         uint32_t stage, int stage_bytes,
                                         uint32_t full, uint32_t empty,
                                         int kt, int kvh, int b,
                                         const Band& band, int n_qt,
                                         int n_tiles, int tile_floats) {
  const int group = p.Hq / p.Hkv;
  const int nqt = (p.Sq + BW_BQ - 1) / BW_BQ;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % NBUF, use = it / NBUF;
    const int h = kvh * group + it / n_qt;
    const int qt = band.qt_lo + it % n_qt;
    const long long tile = ((long long)b * p.Hq + h) * nqt + qt;
    int* counter = counters + 2 * tile + slot;
    const int turn = band.last_key_tile(p, qt) - kt;
    mbar_wait(full + 8 * buf, use & 1);
    if (turn > 0) {
      int seen = 0;
      do {
        asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                     : "=r"(seen)
                     : "l"(counter)
                     : "memory");
      } while (seen < turn);
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(p.dq + tile * tile_floats + dst_offset),
        "r"(stage + buf * stage_bytes), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    mbar_arrive(empty + 8 * buf);  // the buffer is read
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // written
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
  }
}

// The producer of both bodies: K and V of the block's key tile once, then
// the Q and dO tiles of every query head of the group and every query tile
// of the band through the ring, each tile's parts side by side.
template <int D>
__device__ __forceinline__ void bwd_produce(const BwdMaps& maps,
                                            const Params& p, uint32_t sK,
                                            uint32_t sV, uint32_t sQ,
                                            uint32_t sO, uint32_t kv_full,
                                            uint32_t bars_full,
                                            uint32_t bars_empty, int k_lo,
                                            int kvh, int b, int qt_lo,
                                            int n_qt, int n_tiles) {
  using CS = ColSplit<D>;
  using PL = BwdPlan<D>;
  auto load = [&](uint32_t dst, const CUtensorMap* m, uint32_t bar, int rows,
                  int row, int h) {
    for (int f = 0; f < CS::NF; ++f)
      tma_load_4d(dst + f * rows * 128, &m[0], bar, 64 * f, row, h, b);
    if constexpr (CS::DB > 0)
      tma_load_4d(dst + CS::narrow_at(rows), &m[1], bar, 0, row, h, b);
  };
  const int group = p.Hq / p.Hkv;
  mbar_expect_tx(kv_full, 2 * PL::KT);
  load(sK, maps.k, kv_full, PL::BK, k_lo, kvh);
  load(sV, maps.v, kv_full, PL::BK, k_lo, kvh);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % PL::STAGES;
    const int h = kvh * group + it / n_qt;
    const int q_lo = (qt_lo + it % n_qt) * BW_BQ;
    if (it >= PL::STAGES)
      mbar_wait(bars_empty + 8 * s, (it / PL::STAGES - 1) & 1);
    mbar_expect_tx(bars_full + 8 * s, 2 * PL::QT);
    load(sQ + s * PL::QT, maps.q, bars_full + 8 * s, BW_BQ, q_lo, h);
    load(sO + s * PL::QT, maps.dout, bars_full + 8 * s, BW_BQ, q_lo, h);
  }
}

// The stats warp of the D = 128 body: lse (base 2) and delta of every tile's
// 64 query rows (0 past Sq) into the stage's `stats` beside its Q and dO,
// the second of the two arrivals that fill the stage.
template <int D>
__device__ __forceinline__ void stats_produce(const Params& p, float* stats,
                                              uint32_t bars_full,
                                              uint32_t bars_empty, int kvh,
                                              int b, int qt_lo, int n_qt,
                                              int n_tiles, int lane) {
  using PL = BwdPlan<D>;
  constexpr float LOG2E = 1.4426950408889634f;
  const int group = p.Hq / p.Hkv;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % PL::STAGES;
    const int h = kvh * group + it / n_qt;
    const int q_lo = (qt_lo + it % n_qt) * BW_BQ;
    const long long row = ((long long)b * p.Hq + h) * p.Sq + q_lo;
    if (it >= PL::STAGES)
      mbar_wait(bars_empty + 8 * s, (it / PL::STAGES - 1) & 1);
    float* st = stats + s * 2 * BW_BQ;
#pragma unroll
    for (int i = 0; i < BW_BQ / 32; ++i) {
      const int r = lane + 32 * i;
      const bool in = q_lo + r < p.Sq;
      st[r] = in ? __ldg(p.lse + row + r) * LOG2E : 0.f;
      st[BW_BQ + r] = in ? __ldg(p.delta + row + r) : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars_full + 8 * s);
  }
}

// lse (base 2) and delta of this thread's query columns of a tile, in the
// column order of an accumulator of NJ n-blocks (8 NJ columns from q_lo);
// columns past Sq read 0 and are masked.
template <int NJ>
__device__ __forceinline__ void load_rows_stats(const Params& p,
                                                long long row_base, int q_lo,
                                                int t2, float (&l2)[2 * NJ],
                                                float (&dl)[2 * NJ]) {
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int c = 0; c < 2 * NJ; ++c) {
    const int q = q_lo + (c >> 1) * 8 + t2 + (c & 1);
    l2[c] = q < p.Sq ? __ldg(p.lse + row_base + q) * LOG2E : 0.f;
    dl[c] = q < p.Sq ? __ldg(p.delta + row_base + q) : 0.f;
  }
}

// P^T and dS^T in place of S^T and dP^T for keys key0 (+ 8) of this thread
// and the 8 NJ query columns from q_lo; stats(c) gives lse (base 2) and
// delta of the thread's query column c (0 <= c < 2 NJ, in the order of
// `load_rows_stats`).
template <int NJ, typename Stats>
__device__ __forceinline__ void scores_to_grads(const Params& p,
                                                float (&st)[NJ][4],
                                                float (&dp)[NJ][4],
                                                Stats stats, bool need_mask,
                                                int key0, int q_lo, int t2,
                                                float scale2) {
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + (e >> 1) * 8;
        const int q = q_lo + j * 8 + t2 + (e & 1);
        bool ok = q < p.Sq && key < p.Skv;
        if (p.causal) ok = ok && key <= q;
        if (p.window > 0) ok = ok && key > q - p.window;
        const float2 ld = stats(2 * j + (e & 1));
        const float pv = ok ? ex2(fmaf(st[j][e], scale2, -ld.x)) : 0.f;
        st[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - ld.y);
      }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 ld = stats(2 * j + (e & 1));
        const float pv = ex2(fmaf(st[j][e], scale2, -ld.x));
        st[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - ld.y);
      }
  }
}

// stats() of `scores_to_grads` from the arrays of `load_rows_stats`
template <int NJ>
struct RegStats {
  const float (&l2)[2 * NJ];
  const float (&dl)[2 * NJ];
  __device__ __forceinline__ float2 operator()(int c) const {
    return make_float2(l2[c], dl[c]);
  }
};

// P^T and dS^T in wgmma's register A layout (key step kk: query columns
// 16kk .. 16kk + 15), and dS^T in bf16 into the buffer `sds`: row r (key) at
// r * 128 bytes, 16-byte chunk j at (j ^ (r & 7)) * 16.
__device__ __forceinline__ void pack_grads(const float (&st)[8][4],
                                           const float (&dp)[8][4],
                                           uint32_t (&pf)[4][4],
                                           uint32_t (&df)[4][4], uint32_t sds,
                                           int warp, int g8, int lane) {
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
}

// S^T = K Q^T and dP^T = V dO^T over all of D for 64 keys at k (keys of
// `krows` rows a tile, this warpgroup's 64 at row offset kofs) and the
// tile's Q and dO at q, o; committed and waited for.
template <int D>
__device__ __forceinline__ void score_products(float (&st)[8][4],
                                               float (&dp)[8][4], uint32_t k,
                                               uint32_t v, uint32_t q,
                                               uint32_t o, int krows,
                                               int kofs) {
  using CS = ColSplit<D>;
  wgmma_fence();
#pragma unroll
  for (int f = 0; f < CS::NF; ++f)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(
          st, wg_desc(k + f * krows * 128 + kofs * 128 + ks * 32, 16, 1024,
                      SW128),
          wg_desc(q + f * BW_BQ * 128 + ks * 32, 16, 1024, SW128), f + ks);
  if constexpr (CS::DB > 0) {
#pragma unroll
    for (int ks = 0; ks < CS::DB / 16; ++ks)
      wgmma_ss_n64<0, 0>(
          st,
          wg_desc(k + CS::narrow_at(krows) + kofs * CS::RB + ks * 32, 16,
                  CS::SBO, CS::LAYOUT),
          wg_desc(q + CS::narrow_at(BW_BQ) + ks * 32, 16, CS::SBO,
                  CS::LAYOUT),
          CS::NF + ks);
  }
#pragma unroll
  for (int f = 0; f < CS::NF; ++f)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64<0, 0>(
          dp, wg_desc(v + f * krows * 128 + kofs * 128 + ks * 32, 16, 1024,
                      SW128),
          wg_desc(o + f * BW_BQ * 128 + ks * 32, 16, 1024, SW128), f + ks);
  if constexpr (CS::DB > 0) {
#pragma unroll
    for (int ks = 0; ks < CS::DB / 16; ++ks)
      wgmma_ss_n64<0, 0>(
          dp,
          wg_desc(v + CS::narrow_at(krows) + kofs * CS::RB + ks * 32, 16,
                  CS::SBO, CS::LAYOUT),
          wg_desc(o + CS::narrow_at(BW_BQ) + ks * 32, 16, CS::SBO,
                  CS::LAYOUT),
          CS::NF + ks);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(st);
  fence_acc(dp);
}

// dK (scaled) and dV of keys key0 (+ 8) in bf16, columns col0 + 8 j + t2 of
// an accumulator of NJ n-blocks.
template <int NJ>
__device__ __forceinline__ void store_dkv(const Params& p,
                                          const float (&dk)[NJ][4],
                                          const float (&dv)[NJ][4],
                                          __nv_bfloat16* dkp,
                                          __nv_bfloat16* dvp, int D, int key0,
                                          int col0, int t2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= p.Skv) continue;
    const long long off = (long long)key * D + col0 + t2;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * r] * p.scale,
                                dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ BwdMaps maps, const Params p,
                    int* counters) {
  using CS = ColSplit<D>;
  using PL = BwdPlan<D>;
  constexpr bool SPLIT = CS::DB > 0;
  constexpr int DB = CS::DB;  // narrow part: 0 or 16 columns
  constexpr int STAGES = PL::STAGES, BK = PL::BK, KT = PL::KT, QT = PL::QT;
  constexpr int DS = PL::DS;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles at 1024-byte boundaries, as the 128-byte swizzle wants
  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (smem_base + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + KT;
  const uint32_t sQ = sV + KT;                   // [stage]
  const uint32_t sO = sQ + STAGES * QT;          // [stage] dO
  const uint32_t sDS = sO + STAGES * QT;         // [warpgroup][buffer]
  const uint32_t sDQ = sDS + 4 * DS;             // [buffer] dQ, fp32
  const uint32_t bars = sDQ + 2 * BW_BQ * D * 4;
  const uint32_t kv_full = bars;
  const uint32_t bars_full = bars + 8, bars_empty = bars + 8 * (1 + STAGES);
  // the dQ staging buffers: staged [buf], read by the writer [buf]
  const uint32_t dq_full = bars + 8 * (1 + 2 * STAGES);
  const uint32_t dq_empty = dq_full + 16;

  const int kt = block_key_tile(), kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k_lo = kt * BK;
  const Band band(p, kt, BK);
  const int qt_lo = band.qt_lo;
  const int n_qt = max(0, band.qt_hi - qt_lo + 1);
  const int n_tiles = group * n_qt;  // over the group's heads

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars_full + 8 * s, 1);
      mbar_init(bars_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(dq_full + 8 * i, 1);
      mbar_init(dq_empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load, another writes dQ
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256)
      bwd_produce<D>(maps, p, sK, sV, sQ, sO, kv_full, bars_full, bars_empty,
                     k_lo, kvh, b, qt_lo, n_qt, n_tiles);
    if (threadIdx.x == 288)
      dq_write<2>(p, counters, 0, 0, D / 2 * 128 * 4, sDQ, D / 2 * 128 * 4,
                  dq_full, dq_empty, kt, kvh, b, band, n_qt, n_tiles,
                  BW_BQ * D);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const float scale2 = p.scale * LOG2E;  // P in base 2
  const int kw_lo = k_lo + wg * 64;      // this warpgroup's keys
  const int key0 = kw_lo + warp * 16 + g8;  // this thread's rows: key0, +8
  const uint32_t ka = sK + wg * 64 * 128;
  const uint32_t kb = sK + CS::narrow_at(BK) + wg * 64 * CS::RB;

  float dk[8][4], dv[8][4], dkb[SPLIT ? DB / 8 : 1][4],
      dvb[SPLIT ? DB / 8 : 1][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < (SPLIT ? DB / 8 : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkb[j][e] = dvb[j][e] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int h = kvh * group + it / n_qt;
    const int qt = qt_lo + it % n_qt;
    const int q_lo = qt * BW_BQ;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    float l2[16], dl[16];
    load_rows_stats<8>(p, row_base, q_lo, t2, l2, dl);
    const uint32_t sq = sQ + s * QT, so = sO + s * QT;
    const uint32_t sqb = sq + CS::narrow_at(BW_BQ);
    const uint32_t sob = so + CS::narrow_at(BW_BQ);
    mbar_wait(bars_full + 8 * s, (it / STAGES) & 1);

    float st[8][4], dp[8][4];
    score_products<D>(st, dp, sK, sV, sq, so, BK, wg * 64);

    bool need_mask = kw_lo + 64 > p.Skv || q_lo + BW_BQ > p.Sq;
    if (p.causal) need_mask = need_mask || (kw_lo + 63 > q_lo);
    if (p.window > 0)
      need_mask = need_mask || (kw_lo <= q_lo + BW_BQ - 1 - p.window);
    scores_to_grads<8>(p, st, dp, RegStats<8>{l2, dl}, need_mask, key0,
                       q_lo, t2, scale2);
    uint32_t pf[4][4], df[4][4];
    const uint32_t sds = sDS + (wg * 2 + (it & 1)) * DS;
    pack_grads(st, dp, pf, df, sds, warp, g8, lane);
    wg_sync(1 + wg);

    // dV += P^T dO, dK += dS^T Q, dQ = dS K
    float dq[8][4], dqb[SPLIT ? DB / 8 : 1][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64(dv, pf[kk], wg_desc(so + kk * 2048, 16, 1024, SW128));
      wgmma_rs_n64(dk, df[kk], wg_desc(sq + kk * 2048, 16, 1024, SW128));
      if constexpr (SPLIT) {
        wgmma_rs_narrow<DB>(dvb, pf[kk],
                            wg_desc(sob + kk * 16 * CS::RB, 16, CS::SBO,
                                    CS::LAYOUT));
        wgmma_rs_narrow<DB>(dkb, df[kk],
                            wg_desc(sqb + kk * 16 * CS::RB, 16, CS::SBO,
                                    CS::LAYOUT));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_n64<1, 1>(dq, wg_desc(sds + kk * 2048, 16, 1024, SW128),
                         wg_desc(ka + kk * 2048, 16, 1024, SW128), kk);
      if constexpr (SPLIT)
        wgmma_ss_narrow<DB, 1, 1>(dqb,
                                  wg_desc(sds + kk * 2048, 16, 1024, SW128),
                                  wg_desc(kb + kk * 16 * CS::RB, 16, CS::SBO,
                                          CS::LAYOUT),
                                  kk);
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
    if (lane == 0) mbar_arrive(bars_empty + 8 * s);  // Q and dO are read

    // The two warpgroups' dQ summed in shared memory, in this thread's order
    // ([register][thread], so neither side has bank conflicts): warpgroup
    // it % 2 adds its own share to the other's, and the dQ writer adds the
    // tile into the fp32 buffer, laid out in the same order, in its turn.
    // Barriers 3 + buf: the other's share of buffer buf is in; dq_full /
    // dq_empty: the tile is staged / the writer has read it.
    constexpr int NQ = D / 2;  // dQ registers a thread
    const int buf = it & 1;
    const uint32_t xq_addr = sDQ + buf * NQ * 128 * 4;
    float4* xq = reinterpret_cast<float4*>(smem_raw + (xq_addr - smem_base)) +
                 (threadIdx.x & 127);
    if (wg != buf) {
      if (it >= 2) mbar_wait(dq_empty + 8 * buf, ((it >> 1) - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xq[j * 128] = make_float4(dq[j][0], dq[j][1], dq[j][2], dq[j][3]);
      if constexpr (SPLIT) {
#pragma unroll
        for (int j = 0; j < DB / 8; ++j)
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
        for (int j = 0; j < DB / 8; ++j) add(xq + (8 + j) * 128, dqb[j]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1 + wg);
      if ((threadIdx.x & 127) == 0) mbar_arrive(dq_full + 8 * buf);
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
  store_dkv<8>(p, dk, dv, dkp, dvp, D, key0, 0, t2);
  if constexpr (SPLIT) store_dkv<DB / 8>(p, dkb, dvb, dkp, dvp, D, key0, 64, t2);
}

// Consumer warpgroup W of `flash_bwd_wide` at D = 128: keys 64 W .. 64 W +
// 63 of the block's 128.  S^T and dP^T of its keys, P^T and dS^T in
// registers, dV and dK of its keys over all 128 columns, its dS^T into the
// tile's shared buffer; then, with both halves in, its 64 columns of dQ over
// all 128 keys.
template <int W>
__device__ __forceinline__ void halves_consume(const Params& p,
                                               unsigned char* smem_raw,
                                               uint32_t smem_base,
                                               uint32_t sK, uint32_t sV,
                                               uint32_t sQ, uint32_t sO,
                                               uint32_t sDS, uint32_t sDQ,
                                               uint32_t sST,
                                               uint32_t bars_full,
                                               uint32_t bars_empty,
                                               uint32_t dq_full,
                                               uint32_t dq_empty, int kt,
                                               int kvh, int b,
                                               const Band& band, int n_qt,
                                               int n_tiles) {
  constexpr int D = 128;
  using PL = BwdPlan<D>;
  constexpr int STAGES = PL::STAGES, QT = PL::QT, DS = PL::DS, BK = PL::BK;
  constexpr float LOG2E = 1.4426950408889634f;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const float scale2 = p.scale * LOG2E;  // P in base 2
  const int kw_lo = kt * BK + 64 * W;    // this warpgroup's keys
  const int key0 = kw_lo + warp * 16 + g8;  // this thread's rows: key0, +8

  float dk[2][8][4], dv[2][8][4];  // columns 0-63, 64-127
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[f][j][e] = dv[f][j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int q_lo = (band.qt_lo + it % n_qt) * BW_BQ;
    const uint32_t sq = sQ + s * QT, so = sO + s * QT;
    const uint32_t sds = sDS + (it & 1) * 2 * DS;  // [warpgroup] dS^T
    const float* stat = reinterpret_cast<const float*>(
        smem_raw + (sST + s * PL::ST - smem_base));
    mbar_wait(bars_full + 8 * s, (it / STAGES) & 1);

    float st[8][4], dp[8][4];
    score_products<D>(st, dp, sK, sV, sq, so, BK, 64 * W);

    bool need_mask = kw_lo + 64 > p.Skv || q_lo + BW_BQ > p.Sq;
    if (p.causal) need_mask = need_mask || (kw_lo + 63 > q_lo);
    if (p.window > 0)
      need_mask = need_mask || (kw_lo <= q_lo + BW_BQ - 1 - p.window);
    // lse and delta read from the stage as they are needed
    const auto stats = [&](int c) {
      const int col = (c >> 1) * 8 + t2 + (c & 1);
      return make_float2(stat[col], stat[BW_BQ + col]);
    };
    scores_to_grads<8>(p, st, dp, stats, need_mask, key0, q_lo, t2, scale2);
    uint32_t pf[4][4], df[4][4];
    pack_grads(st, dp, pf, df, sds + W * DS, warp, g8, lane);

    // dV += P^T dO, dK += dS^T Q, all 128 columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int part = f * BW_BQ * 128 + kk * 2048;
        wgmma_rs_n64(dv[f], pf[kk], wg_desc(so + part, 16, 1024, SW128));
        wgmma_rs_n64(dk[f], df[kk], wg_desc(sq + part, 16, 1024, SW128));
      }
    wgmma_commit();
    // both halves of dS^T are in: dQ = dS K, this warpgroup's columns over
    // the block's 128 keys (A MN-major: dS^T rows are keys)
    pair_sync(3 + (it & 1));
    float dq[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64<1, 1>(dq, wg_desc(sds + kk * 2048, 16, 1024, SW128),
                         wg_desc(sK + W * BK * 128 + kk * 2048, 16, 1024,
                                 SW128),
                         kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      fence_acc(dv[f]);
      fence_acc(dk[f]);
    }
    fence_acc(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(pf[kk][e]), "+r"(df[kk][e]));
    if (lane == 0) mbar_arrive(bars_empty + 8 * s);  // Q, dO, stats read

    // this warpgroup's columns of dQ (scaled) into its buffer in register
    // order, once the writer has read the previous tile's; the writer adds
    // them into the tile's fp32 sum at register block 8 W, in turn
    const uint32_t xq_addr = sDQ + W * 8 * 128 * 16;
    float4* xq = reinterpret_cast<float4*>(smem_raw + (xq_addr - smem_base)) +
                 (threadIdx.x & 127);
    if (it >= 1) mbar_wait(dq_empty, (it - 1) & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xq[j * 128] = make_float4(dq[j][0] * p.scale, dq[j][1] * p.scale,
                                dq[j][2] * p.scale, dq[j][3] * p.scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + W);
    if ((threadIdx.x & 127) == 0) mbar_arrive(dq_full);
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
#pragma unroll
  for (int f = 0; f < 2; ++f)
    store_dkv<8>(p, dk[f], dv[f], dkp, dvp, D, key0, 64 * f, t2);
}

// Consumer warpgroup W of `flash_bwd_wide` at D = 160 and 256, 64 keys a
// block: S^T and dP^T of the 64 keys against its 32 query columns, its half
// of P^T and dS^T into the shared buffers, then, with both halves in, its
// own columns of dK, dV and dQ, A read from shared memory: NP = NF / 2
// 64-column parts from part W NP (columns 0-63 and 64-127 at D = 160,
// 0-127 and 128-255 at 256), and warpgroup 1 the narrow part too (columns
// 128-159 at D = 160).
template <int D, int W>
__device__ __forceinline__ void shared_consume(const Params& p,
                                               unsigned char* smem_raw,
                                               uint32_t smem_base,
                                               uint32_t sK, uint32_t sV,
                                               uint32_t sQ, uint32_t sO,
                                               uint32_t sDS, uint32_t sDQ,
                                               uint32_t bars_full,
                                               uint32_t bars_empty,
                                               uint32_t dq_full,
                                               uint32_t dq_empty, int kt,
                                               int kvh, int b,
                                               const Band& band, int n_qt,
                                               int n_tiles) {
  using CS = ColSplit<D>;
  using PL = BwdPlan<D>;
  constexpr int NP = CS::NF / 2;  // 64-column parts of this warpgroup
  constexpr bool NARROW = W == 1 && CS::DB > 0;
  constexpr int NB = NARROW ? CS::DB / 8 : 1;  // narrow n-blocks
  constexpr int STAGES = PL::STAGES, QT = PL::QT, DS = PL::DS;
  constexpr int BK = PL::BK;  // 64 keys
  constexpr float LOG2E = 1.4426950408889634f;
  const int group = p.Hq / p.Hkv;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  const float scale2 = p.scale * LOG2E;  // P in base 2
  const int k_lo = kt * BK;
  const int key0 = k_lo + warp * 16 + g8;  // this thread's rows: key0, +8
  const uint32_t kn = sK + CS::narrow_at(BK);

  float dk[NP][8][4], dv[NP][8][4], dkn[NB][4], dvn[NB][4];
#pragma unroll
  for (int f = 0; f < NP; ++f)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[f][j][e] = dv[f][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkn[j][e] = dvn[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int h = kvh * group + it / n_qt;
    const int qt = band.qt_lo + it % n_qt;
    const int q_lo = qt * BW_BQ;
    const int qw_lo = q_lo + 32 * W;  // this warpgroup's query columns
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    float l2[8], dl[8];
    load_rows_stats<4>(p, row_base, qw_lo, t2, l2, dl);
    const uint32_t sq = sQ + s * QT, so = sO + s * QT;
    const uint32_t sqn = sq + CS::narrow_at(BW_BQ);
    const uint32_t son = so + CS::narrow_at(BW_BQ);
    const uint32_t sp = sDS + (it & 1) * DS;         // P^T
    const uint32_t sds = sDS + (2 + (it & 1)) * DS;  // dS^T
    mbar_wait(bars_full + 8 * s, (it / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 32 query columns
    float st[4][4], dp[4][4];
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < CS::NF; ++f)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32<0, 0>(
            st, wg_desc(sK + f * BK * 128 + ks * 32, 16, 1024, SW128),
            wg_desc(sq + f * BW_BQ * 128 + W * 32 * 128 + ks * 32, 16, 1024,
                    SW128),
            f + ks);
    if constexpr (CS::DB > 0) {
#pragma unroll
      for (int ks = 0; ks < CS::DB / 16; ++ks)
        wgmma_ss_n32<0, 0>(
            st, wg_desc(kn + ks * 32, 16, CS::SBO, CS::LAYOUT),
            wg_desc(sqn + W * 32 * CS::RB + ks * 32, 16, CS::SBO, CS::LAYOUT),
            1);
    }
#pragma unroll
    for (int f = 0; f < CS::NF; ++f)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32<0, 0>(
            dp, wg_desc(sV + f * BK * 128 + ks * 32, 16, 1024, SW128),
            wg_desc(so + f * BW_BQ * 128 + W * 32 * 128 + ks * 32, 16, 1024,
                    SW128),
            f + ks);
    if constexpr (CS::DB > 0) {
#pragma unroll
      for (int ks = 0; ks < CS::DB / 16; ++ks)
        wgmma_ss_n32<0, 0>(
            dp,
            wg_desc(sV + CS::narrow_at(BK) + ks * 32, 16, CS::SBO,
                    CS::LAYOUT),
            wg_desc(son + W * 32 * CS::RB + ks * 32, 16, CS::SBO, CS::LAYOUT),
            1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dp);

    bool need_mask = k_lo + 64 > p.Skv || q_lo + BW_BQ > p.Sq;
    if (p.causal) need_mask = need_mask || (k_lo + 63 > q_lo);
    if (p.window > 0)
      need_mask = need_mask || (k_lo <= q_lo + BW_BQ - 1 - p.window);
    scores_to_grads<4>(p, st, dp, RegStats<4>{l2, dl}, need_mask, key0,
                       qw_lo, t2, scale2);
    // this half of P^T and dS^T in bf16: row r (key) at r * 128 bytes,
    // 16-byte chunk j (query columns 8 j ..) at (j ^ (r & 7)) * 16
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g8 + r * 8, chunk = 4 * W + j;
        const uint32_t off =
            row * 128 + ((chunk ^ (row & 7)) << 4) + (lane & 3) * 4;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sp + off),
                     "r"(pack_bf16(st[j][2 * r], st[j][2 * r + 1]))
                     : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sds + off),
                     "r"(pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]))
                     : "memory");
      }
    // the generic-proxy writes become visible to wgmma's reads, and both
    // warpgroups' halves are in
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    pair_sync(3 + (it & 1));

    // dV += P^T dO, dK += dS^T Q, dQ = dS K, this warpgroup's columns
    float dq[NP][8][4], dqn[NB][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < NP; ++f) {
        const int part = (NP * W + f) * BW_BQ * 128;
        wgmma_ss_n64<0, 1>(dv[f], wg_desc(sp + kk * 32, 16, 1024, SW128),
                           wg_desc(so + part + kk * 2048, 16, 1024, SW128),
                           1);
        wgmma_ss_n64<0, 1>(dk[f], wg_desc(sds + kk * 32, 16, 1024, SW128),
                           wg_desc(sq + part + kk * 2048, 16, 1024, SW128),
                           1);
      }
      if constexpr (NARROW) {
        wgmma_ss_narrow<CS::DB, 0, 1>(
            dvn, wg_desc(sp + kk * 32, 16, 1024, SW128),
            wg_desc(son + kk * 16 * CS::RB, 16, CS::SBO, CS::LAYOUT), 1);
        wgmma_ss_narrow<CS::DB, 0, 1>(
            dkn, wg_desc(sds + kk * 32, 16, 1024, SW128),
            wg_desc(sqn + kk * 16 * CS::RB, 16, CS::SBO, CS::LAYOUT), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int f = 0; f < NP; ++f)
        wgmma_ss_n64<1, 1>(
            dq[f], wg_desc(sds + kk * 2048, 16, 1024, SW128),
            wg_desc(sK + (NP * W + f) * BK * 128 + kk * 2048, 16, 1024,
                    SW128),
            kk);
      if constexpr (NARROW)
        wgmma_ss_narrow<CS::DB, 1, 1>(
            dqn, wg_desc(sds + kk * 2048, 16, 1024, SW128),
            wg_desc(kn + kk * 16 * CS::RB, 16, CS::SBO, CS::LAYOUT), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < NP; ++f) {
      fence_acc(dv[f]);
      fence_acc(dk[f]);
      fence_acc(dq[f]);
    }
    if constexpr (NARROW) {
      fence_acc(dvn);
      fence_acc(dkn);
      fence_acc(dqn);
    }
    if (lane == 0) mbar_arrive(bars_empty + 8 * s);  // Q and dO are read

    // this warpgroup's columns of dQ (scaled) into its buffer in register
    // order, once the writer has read the previous tile's; the writer adds
    // them into the tile's fp32 sum at register block 8 NP W, in turn
    const uint32_t xq_addr = sDQ + W * 8 * NP * 128 * 16;
    float4* xq = reinterpret_cast<float4*>(smem_raw + (xq_addr - smem_base)) +
                 (threadIdx.x & 127);
    if (it >= 1) mbar_wait(dq_empty, (it - 1) & 1);
#pragma unroll
    for (int f = 0; f < NP; ++f)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xq[(8 * f + j) * 128] =
            make_float4(dq[f][j][0] * p.scale, dq[f][j][1] * p.scale,
                        dq[f][j][2] * p.scale, dq[f][j][3] * p.scale);
    if constexpr (NARROW) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        xq[(8 * NP + j) * 128] =
            make_float4(dqn[j][0] * p.scale, dqn[j][1] * p.scale,
                        dqn[j][2] * p.scale, dqn[j][3] * p.scale);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + W);
    if ((threadIdx.x & 127) == 0) mbar_arrive(dq_full);
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) +
                       ((long long)b * p.Hkv + kvh) * p.Skv * D;
#pragma unroll
  for (int f = 0; f < NP; ++f)
    store_dkv<8>(p, dk[f], dv[f], dkp, dvp, D, key0, 64 * (NP * W + f), t2);
  if constexpr (NARROW)
    store_dkv<NB>(p, dkn, dvn, dkp, dvp, D, key0, 64 * CS::NF, t2);
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1)
    flash_bwd_wide(const __grid_constant__ BwdMaps maps, const Params p,
                   int* counters) {
  using CS = ColSplit<D>;
  using PL = BwdPlan<D>;
  static_assert(CS::NF % 2 == 0, "the 64-column parts split evenly");
  constexpr int C0 = 64 * (CS::NF / 2);  // columns of warpgroup 0
  constexpr int STAGES = PL::STAGES, KT = PL::KT, QT = PL::QT, DS = PL::DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (smem_base + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + KT;
  const uint32_t sQ = sV + KT;                   // [stage]
  const uint32_t sO = sQ + STAGES * QT;          // [stage] dO
  const uint32_t sDS = sO + STAGES * QT;         // [buffer][warpgroup]
  const uint32_t sDQ = sDS + 4 * DS;             // [warpgroup] dQ, fp32
  const uint32_t sST = sDQ + BW_BQ * D * 4;      // [stage] lse, delta
  const uint32_t bars = sST + STAGES * PL::ST;
  const uint32_t kv_full = bars;
  const uint32_t bars_full = bars + 8, bars_empty = bars + 8 * (1 + STAGES);
  // each warpgroup's dQ buffer: staged [W], read by its writer [W]
  const uint32_t dq_full = bars + 8 * (1 + 2 * STAGES);
  const uint32_t dq_empty = dq_full + 16;

  const int kt = block_key_tile(), kvh = blockIdx.y, b = blockIdx.z;
  const Band band(p, kt, PL::BK);
  const int n_qt = max(0, band.qt_hi - band.qt_lo + 1);
  const int n_tiles = (p.Hq / p.Hkv) * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the loads' thread, and at D = 128 the stats warp
      mbar_init(bars_full + 8 * s, PL::HALVES ? 2 : 1);
      mbar_init(bars_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(dq_full + 8 * i, 1);
      mbar_init(dq_empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load, one writer a warpgroup's dQ
    // (columns 0 to C0 - 1 at register block 0, the rest at block C0 / 8),
    // and at D = 128 one warp brings in lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256)
      bwd_produce<D>(maps, p, sK, sV, sQ, sO, kv_full, bars_full, bars_empty,
                     kt * PL::BK, kvh, b, band.qt_lo, n_qt, n_tiles);
    if (threadIdx.x == 288 || threadIdx.x == 320) {
      const int w = (threadIdx.x - 288) / 32;
      const int bytes = (w == 0 ? C0 : D - C0) * 64 * 4;
      dq_write<1>(p, counters, w, w * C0 / 8 * 128 * 4, bytes,
                  sDQ + w * C0 / 8 * 128 * 16, 0, dq_full + 8 * w,
                  dq_empty + 8 * w, kt, kvh, b, band, n_qt, n_tiles,
                  BW_BQ * D);
    }
    if constexpr (PL::HALVES) {
      if (threadIdx.x >= 352)
        stats_produce<D>(p,
                         reinterpret_cast<float*>(smem_raw +
                                                  (sST - smem_base)),
                         bars_full, bars_empty, kvh, b, band.qt_lo, n_qt,
                         n_tiles, threadIdx.x & 31);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  mbar_wait(kv_full, 0);
  if constexpr (PL::HALVES) {
    if (wg == 0)
      halves_consume<0>(p, smem_raw, smem_base, sK, sV, sQ, sO, sDS, sDQ, sST,
                        bars_full, bars_empty, dq_full, dq_empty, kt, kvh,
                        b, band, n_qt, n_tiles);
    else
      halves_consume<1>(p, smem_raw, smem_base, sK, sV, sQ, sO, sDS, sDQ, sST,
                        bars_full, bars_empty, dq_full + 8, dq_empty + 8, kt,
                        kvh, b, band, n_qt, n_tiles);
  } else if (wg == 0) {
    shared_consume<D, 0>(p, smem_raw, smem_base, sK, sV, sQ, sO, sDS, sDQ,
                         bars_full, bars_empty, dq_full, dq_empty, kt, kvh, b,
                         band, n_qt, n_tiles);
  } else {
    shared_consume<D, 1>(p, smem_raw, smem_base, sK, sV, sQ, sO, sDS, sDQ,
                         bars_full, bars_empty, dq_full + 8, dq_empty + 8, kt,
                         kvh, b, band, n_qt, n_tiles);
  }
}

// dQ [B,Hq,Sq,D] in bf16 from the bf16 bodies' fp32 buffer [B,Hq,nqt,64 D],
// each 64-row tile in the register order of the warpgroups that add it:
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


// the key tiles in runs of `run` (the scratch's slices), the last run first
template <int D>
int launch_fma(const Params& p, float* dq_out, int run, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(p, stream);
  if (err != cudaSuccess) return (int)err;
  constexpr int DH = fma_cols(D);
  const size_t smem =
      sizeof(float) * (4 * BT * (DH + 1) + 2 * BT * LP + 2 * BT);
  auto kernel = flash_bwd_main<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (p.Skv + BT - 1) / BT;
  const long long n = (long long)p.B * p.Hq * p.Sq * D;
  for (int kt0 = (n_kt - 1) / run * run; kt0 >= 0; kt0 -= run) {
    Params pr = p;
    pr.kt0 = kt0;
    const int kt1 = min(kt0 + run, n_kt);
    kernel<<<dim3(kt1 - kt0, p.Hkv * (D / DH), p.B), THREADS, smem,
             stream>>>(pr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_dq_tiles<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        pr, dq_out, n, kt1, kt1 == n_kt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <int D>
int launch_wgmma(const Params& p, void* dq_out, int* counters,
                 cudaStream_t stream) {
  using CS = ColSplit<D>;
  using PL = BwdPlan<D>;
  BwdMaps maps;
  const void* src[4] = {p.q, p.k, p.v, p.dout};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.dout};
  const int S[4] = {p.Sq, p.Skv, p.Skv, p.Sq};
  const int H[4] = {p.Hq, p.Hkv, p.Hkv, p.Hq};
  const int rows[4] = {BW_BQ, PL::BK, PL::BK, BW_BQ};
  const long long ss[4] = {p.q_ss, p.k_ss, p.v_ss, p.do_ss};
  const long long sh[4] = {p.q_sh, p.k_sh, p.v_sh, p.do_sh};
  const long long sb[4] = {p.q_sb, p.k_sb, p.v_sb, p.do_sb};
  for (int t = 0; t < 4; ++t) {
    int err = tensor_map_4d(&dst[t][0], src[t], 64 * CS::NF, 64, S[t], H[t],
                            p.B, ss[t], sh[t], sb[t], rows[t],
                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0 && CS::DB > 0)
      err = tensor_map_4d(&dst[t][1],
                          static_cast<const __nv_bfloat16*>(src[t]) +
                              64 * CS::NF,
                          CS::DB, CS::DB, S[t], H[t], p.B, ss[t], sh[t],
                          sb[t], rows[t], CS::TMA_SWIZZLE);
    if (err != 0) return err;
  }
  cudaError_t err = launch_delta<__nv_bfloat16, D>(p, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Skv + PL::BK - 1) / PL::BK, p.Hkv, p.B);
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PL::SMEM);
    if (e != cudaSuccess) return e;
    kernel<<<grid, BW_THREADS, PL::SMEM, stream>>>(maps, p, counters);
    return cudaGetLastError();
  };
  if constexpr (PL::WIDE)
    err = run(flash_bwd_wide<D>);
  else
    err = run(flash_bwd_wgmma<D>);
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)p.B * p.Hq * p.Sq * (D / 2);
  cast_dq_bf16<D><<<(unsigned)((n_pairs + 255) / 256), 256, 0, stream>>>(
      p.dq, static_cast<__nv_bfloat16*>(dq_out), p.Sq, n_pairs);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_d(const Params& p, int body, void* dq_out, int* counters,
               int fma_run, cudaStream_t stream) {
  return body == 0
             ? launch_fma<D>(p, static_cast<float*>(dq_out), fma_run, stream)
             : launch_wgmma<D>(p, dq_out, counters, stream);
}

}  // namespace

// body: 0 = the fp32 FMA body (float32 tensors), 2 = the bf16 wgmma + TMA
// bodies (bfloat16 tensors); the wrapper chooses it by type.  D = 64, 80,
// 128, 160 or 256.  lse [B,Hq,Sq] fp32 from the forward; delta [B,Hq,Sq] fp32 scratch;
// dq_acc fp32 scratch: for an fp32 call [fma_run,B,Hq,Sq,D], the dQ partials
// of a run of fma_run key tiles (1 <= fma_run; not zeroed: only the pairs the
// band visits are written and read), summed in order into dq_out [B,Hq,Sq,D]
// fp32 after each run, the last run first; for a bf16 call
// [B,Hq,ceil(Sq / 64),64 D], zero at launch, a scratch in the body's
// register order that is cast into dq_out [B,Hq,Sq,D] bf16; counters
// [B,Hq,ceil(Sq / 64),2] int32, zero at launch, the turns of the bf16
// bodies' ordered dQ sums (null for fp32).  dk, dv [B,Hkv,Skv,D]
// contiguous.  q, k, v, o and dout are read through (batch, head, row)
// strides in elements with a unit stride along D; for bf16 every row of q, k,
// v and dout is 16-byte aligned (TMA's rule).  window <= 0 means no window.
// Returns a cudaError_t, -1 for an unsupported argument or -2 if a tensor map
// cannot be made; never synchronises.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, float* dq_acc,
    void* dq_out, int* counters, void* dk, void* dv, int B, int Hq, int Hkv,
    int Sq, int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    float scale, int causal, int window, int body, int fma_run,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return -1;
  if (body == 0 && fma_run < 1) return -1;
  if (Hq % Hkv != 0 || Hq > 65535 || B > 65535) return -1;
  if (dq_out == nullptr || (body == 2) != (counters != nullptr) ||
      (body != 0 && body != 2))
    return -1;
  Params p{q,    k,    v,     o,     dout,  lse,   delta, dq_acc, dk,
           dv,   B,    Hq,    Hkv,   Sq,    Skv,   q_sb,  q_sh,   q_ss,
           k_sb, k_sh, k_ss,  v_sb,  v_sh,  v_ss,  o_sb,  o_sh,   o_ss,
           do_sb, do_sh, do_ss, scale, causal, window, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_d<64>(p, body, dq_out, counters, fma_run, s);
    case 80:
      return dispatch_d<80>(p, body, dq_out, counters, fma_run, s);
    case 128:
      return dispatch_d<128>(p, body, dq_out, counters, fma_run, s);
    case 160:
      return dispatch_d<160>(p, body, dq_out, counters, fma_run, s);
    case 256:
      return dispatch_d<256>(p, body, dq_out, counters, fma_run, s);
    default:
      return -1;
  }
}

extern "C" const char* repro_flash_attention_bwd_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
