// Blockwise online-softmax attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  Same function:
//   q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> o [B,Hq,Sq,D]
//   kv head = h / (Hq / Hkv)  (GQA by index, no K/V replication)
//   mask: causal (k_pos <= q_pos) and/or sliding window (k_pos > q_pos - window)
//   fp32 running max / normaliser / accumulator, NEG_INF = -1e30,
//   p = exp(s - m) * mask, l clamped at 1e-30, output in the input type.
//
// Design for this card: one thread block per (b, h, q-tile).  The KV loop
// runs inside the block over exactly the tiles the band can touch, where the
// TPU kernel used a sequential fourth grid axis and skipped blocks, and the
// longest q-tiles start first.  The kernel reads q/k/v through (batch, head,
// row) strides with a unit stride along D, and masks the ragged edge
// itself: Sq and Skv are arbitrary.
//
// Two bodies, chosen by the wrapper from the type:
//   * bf16, every head dim (32, 64, 80, 128, 160, 256): wgmma + TMA,
//     warp-specialised, 128 query rows and KV tiles of 128 keys (64 at D =
//     256), the operands split along D into 64-column parts and one narrow
//     part; see its section below.
//   * fp32: fp32 FMA on shared-memory tiles, 16x16 threads with a 4x4
//     micro-tile of S each.  Full fp32 products, no TF32: the reference holds
//     fp32 to rtol 2e-5.
//
// Causal attention is operation-bound on this card (about S/2 * 4 * D flop for
// every q row against 4 * D bytes); what the design does about it is to skip
// the tiles outside the band and to start the longest q-tiles first.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;  // <= 0: none
  float* lse;  // [B,Hq,Sq] fp32 row log-sum-exp, or null: not written
};

// The row's natural log-sum-exp of its scaled scores, from the running max
// `m` (in the units `scale_to_e` turns into natural ones) and the row sum
// `l` of exp(s - m); NEG_INF for a row that sees no key (l = 0: a row with
// a visible key has l >= 1).  The backward recomputes P = exp(s - lse).
__device__ __forceinline__ float row_lse(float m, float l, float scale_to_e) {
  return l > 0.f ? m * scale_to_e + logf(l) : NEG_INF;
}

// Tile range [kt_lo, kt_hi) of KV tiles of `bk` keys that the band of q rows
// [q_lo, q_hi] can touch: k_lo <= q_hi (causal), k_hi > q_lo - window
// (window).  Empty (kt_lo == kt_hi) when the window starts past the last
// key, as it does for rows beyond Skv + window when Sq > Skv.
__device__ __forceinline__ void band_tiles(const Params& p, int q_lo, int q_hi,
                                           int bk, int& kt_lo, int& kt_hi) {
  const int nkt = (p.Skv + bk - 1) / bk;
  kt_lo = 0;
  kt_hi = nkt;
  if (p.causal) kt_hi = min(nkt, q_hi / bk + 1);
  if (p.window > 0) {
    const int first = q_lo - p.window + 1;  // lowest key any row may see
    if (first > 0) kt_lo = min(first / bk, kt_hi);
  }
}

__device__ __forceinline__ bool in_band(const Params& p, int q_pos, int k_pos) {
  bool ok = k_pos < p.Skv;
  if (p.causal) ok = ok && (k_pos <= q_pos);
  if (p.window > 0) ok = ok && (k_pos > q_pos - p.window);
  return ok;
}

__device__ __forceinline__ uint32_t smem_addr(const void* smem_ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
}

// One online-softmax step on a warp's 16 x (8 * NT) score fragment: rows g and
// g + 8 of the m-tile, this thread's columns nt * 8 + tig * 2 + {0, 1}.
// Turns raw scores into p = exp2(s * scale2 - m) * mask in place, updates the
// running max m and this thread's share l of the row sum, and returns the
// factor alpha that rescales what was accumulated so far.  MASKED = false is
// for tiles wholly inside the band (and needs scale2 > 0).
template <bool MASKED, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2],
                                             const Params& p, float scale2,
                                             int q_pos0, int k_pos0) {
  // four independent max and sum chains a row: two warps a scheduler leave
  // little else to hide their latency
  constexpr int C = NT >= 2 ? 4 : 2;
  float mx[2][C];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) mx[r][c] = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        s[nt][e] = in_band(p, q_pos0 + (e >> 1) * 8, k_pos0 + nt * 8 + (e & 1))
                       ? s[nt][e] * scale2
                       : NEG_INF;
      }
      float& m = mx[e >> 1][(nt * 2 + (e & 1)) % C];
      m = fmaxf(m, s[nt][e]);
    }
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r][0];
#pragma unroll
    for (int c = 1; c < C; ++c) m = fmaxf(m, mx[r][c]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    // unmasked scores are still raw: the max commutes with scale2 > 0
    m_new[r] = fmaxf(m_run[r], MASKED ? m : m * scale2);
    alpha[r] = ex2(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
  }
  float psum[2][C];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) psum[r][c] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv;
      if (MASKED)  // a masked score is exactly NEG_INF: p = exp(s - m) * mask
        pv = s[nt][e] == NEG_INF ? 0.f : ex2(s[nt][e] - m_new[e >> 1]);
      else
        pv = ex2(fmaf(s[nt][e], scale2, -m_new[e >> 1]));
      s[nt][e] = pv;
      psum[e >> 1][(nt * 2 + (e & 1)) % C] += pv;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = psum[r][0];
#pragma unroll
    for (int c = 1; c < C; ++c) sum += psum[r][c];
    l_run[r] = l_run[r] * alpha[r] + sum;
  }
}

// ---------------------------------------------------------------------------
// bf16 body: wgmma + TMA, warp-specialised, every head dim
// ---------------------------------------------------------------------------
//
// 384 threads: warpgroups 0 and 1 consume, 64 query rows each (128 a
// block); warpgroup 2 produces, one thread issuing TMA loads of K and V
// tiles of BK keys (`fwd_bk`: 128, 64 at D = 256) into a ring of stages
// (`fwd_stages`: four up to D = 80, three at 128, two at 160 and 256, as
// many as 227 KB of shared memory hold), with an mbarrier for "full" (K and
// V apart, so Q.K^T starts before V has landed) and one for "empty" per
// stage.  The producer gives its registers to the consumers (`setmaxnreg`).
// S = Q.K^T is one wgmma.m64n{BK}k16 per 16-deep step, both operands in
// shared memory; P (the fp32 S accumulator
// rounded to bf16) stays in registers, where it has the layout of wgmma's
// register A operand, and O += P.V takes V as an MN-major B operand (the
// transpose bit).  Every operand is split along D (`ColSplit`): parts of 64
// columns with the 128-byte swizzle (D = 64 one, 128 two, 160 two) and one
// narrow part of 16 columns with the 32-byte swizzle (D = 80) or of 32 with
// the 64-byte swizzle (D = 32, 160), each with its own descriptors: a part
// of 64 columns is four k-steps of Q.K^T and an n64 product of P.V, the
// narrow part one or two k-steps and an n16 or n32 product.  O is 64 x D
// fp32 a warpgroup (D / 2 registers a thread).  TMA fills rows past the end
// with zeros; keys >= Skv are masked, rows >= Sq are not stored.  Every D
// writes the row log-sum-exp when asked.
//
// D = 256: with 128-key tiles one stage alone would take 197.6 KB and O,
// S and P 128 + 64 + 32 registers a thread.  So the KV tiles hold 64 keys:
// registers a consumer thread, O 128 (four 64-column parts, no narrow part),
// S of the next tile 32, P of the current one 16, the softmax state 6, of
// the 240 that `setmaxnreg` gives; shared memory 1 KB of alignment + Q 64 KB
// + two stages of K and V at 32 KB each (128 KB) + barriers: 197,704 bytes
// of 232,448.
//
// What bounds it, measured on the H100 (PERF.md): the exponentials and the
// other softmax work of two warps a scheduler, and at D = 80 the K/V bytes
// that 128-row q-tiles read again from L2.  Against that:
//   * the blocks are persistent, one an SM, and take q-tiles from a counter
//     in bands of (batch, head) pairs, longest first, so that the next
//     tile's Q and K/V load while the current one finishes and the K/V in
//     flight stay in L2;
//   * inside a warpgroup, tile i + 1's Q.K^T and softmax run while tile i's
//     P.V is in flight; the two warpgroups take turns to issue (named
//     barriers), so that one's softmax runs beside the other's products;
//   * the loop has no branch around its products and each tile's S is a
//     fresh array: otherwise ptxas serializes every wgmma (C7514).

constexpr int WG_BQ = 128;  // query rows a block
constexpr int WG_THREADS = 384;

// keys a KV tile: 128, and 64 at D = 256, where O takes 128 registers
__host__ __device__ constexpr int fwd_bk(int d) { return d > 160 ? 64 : 128; }

// stages of the K/V ring: as many as fit beside Q in 227 KB
__host__ __device__ constexpr int fwd_stages(int d) {
  return d <= 80 ? 4 : d <= 128 ? 3 : 2;
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + 2 * (WG_BQ + 2 * fwd_stages(D) * fwd_bk(D)) * D +
         8 * (2 + 3 * fwd_stages(D)) + 8;
}

struct TmaMaps {  // [0]: the 64-column parts; [1]: the narrow part
  CUtensorMap q[2], k[2], v[2];
};

// Named barriers 1 and 2 (0 is __syncthreads') over both consumer
// warpgroups, 256 threads.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B in shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= Q K^T of a KV tile of BK keys: one wgmma.m64n{BK}k16, both
// operands in shared memory (K-major).
template <int BK>
__device__ __forceinline__ void wgmma_s(float (&d)[BK / 8][4], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (BK == 128)
    wgmma_ss_n128(d, da, db, accumulate);
  else
    wgmma_ss_n64<0, 0>(d, da, db, accumulate);
}

// Work item j of a call.  The (batch, head) pairs are taken in bands of
// `band`, about one wave of q-tiles, so that the K and V the blocks in
// flight read stay in L2; within a band the longest causal q-tiles come
// first.
struct WorkItem {
  int q_lo, h, b, kt_lo, kt_hi;
};

__device__ __forceinline__ WorkItem work_item(const Params& p, int j,
                                              int band, int bk) {
  const int nqt = (p.Sq + WG_BQ - 1) / WG_BQ;
  const int first = j / (band * nqt) * band;  // first pair of j's band
  const int pairs = min(band, p.Hq * p.B - first);
  const int jj = j - first * nqt;
  const int hb = first + jj % pairs;
  WorkItem w;
  w.q_lo = (nqt - 1 - jj / pairs) * WG_BQ;
  w.h = hb % p.Hq;
  w.b = hb / p.Hq;
  band_tiles(p, w.q_lo, min(w.q_lo + WG_BQ, p.Sq) - 1, bk, w.kt_lo,
             w.kt_hi);
  return w;
}

// Persistent: gridDim.x blocks (one an SM) take work items in order from
// the counter `next_item` (zero at launch); the producer takes each and
// hands it to the consumers with Q.  The ring's stages and phases run on
// across items, so the producer loads the next item's Q and first K/V tiles
// while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_bf16_wgmma(const __grid_constant__ TmaMaps maps,
                         const Params p, int* next_item) {
  using CS = ColSplit<D>;
  constexpr int NF = CS::NF, DB = CS::DB;
  constexpr int STAGES = fwd_stages(D), BK = fwd_bk(D);
  constexpr int NT = BK / 8, KK = BK / 16;  // n-blocks of S, key steps of P
  constexpr int QT = WG_BQ * D * 2, KT = BK * D * 2;  // tile bytes
  constexpr int QN = CS::narrow_at(WG_BQ), KN = CS::narrow_at(BK);
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles at 1024-byte boundaries, as the 128-byte swizzle wants
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + QT;                // [stage]
  const uint32_t sV = sK + STAGES * KT;       // [stage]
  const uint32_t bars = sV + STAGES * KT;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + STAGES + s); };
  auto kv_empty = [&](int s) { return bars + 8 * (2 + 2 * STAGES + s); };
  // the item of the n-th round in slot n % 2, -1 when there is none
  volatile int* s_item = reinterpret_cast<volatile int*>(
      smem_raw + (bars + 8 * (2 + 3 * STAGES) - smem_addr(smem_raw)));
  const int nqt = (p.Sq + WG_BQ - 1) / WG_BQ;
  const int n_items = nqt * p.Hq * p.B;
  const int band = max(1, (int)gridDim.x / nqt);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(kv_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load; a tile's parts side by side
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      auto load = [&](uint32_t dst, const CUtensorMap* m, uint32_t bar,
                      int rows, int row, int h, int b) {
        for (int f = 0; f < NF; ++f)
          tma_load_4d(dst + f * rows * 128, &m[0], bar, 64 * f, row, h, b);
        if constexpr (DB > 0)
          tma_load_4d(dst + CS::narrow_at(rows), &m[1], bar, 0, row, h, b);
      };
      int it = 0;  // tiles loaded so far, over all items
      for (int n = 0;; ++n) {
        const int j = atomicAdd(next_item, 1);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        s_item[n & 1] = j < n_items ? j : -1;
        if (j >= n_items) {
          mbar_arrive(q_full);  // no more work: the consumers stop
          break;
        }
        const WorkItem w = work_item(p, j, band, BK);
        const int kvh = w.h / (p.Hq / p.Hkv);
        mbar_expect_tx(q_full, QT);
        load(sQ, maps.q, q_full, WG_BQ, w.q_lo, w.h, w.b);
        for (int kt = w.kt_lo; kt < w.kt_hi; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(kv_empty(s), (it / STAGES - 1) & 1);
          const int k_lo = kt * BK;
          mbar_expect_tx(k_full(s), KT);
          load(sK + s * KT, maps.k, k_full(s), BK, k_lo, kvh, w.b);
          mbar_expect_tx(v_full(s), KT);
          load(sV + s * KT, maps.v, v_full(s), BK, k_lo, kvh, w.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int t2 = (lane & 3) * 2;
    const float scale2 = p.scale * LOG2E;  // softmax in base 2
    // this warpgroup's 64 rows of Q: part f, and the narrow part
    const uint32_t qa = sQ + wg * 64 * 128;
    const uint32_t qb = sQ + QN + wg * 64 * CS::RB;
    // The two warpgroups take turns to issue their products (barrier 1 + wg
    // is this one's turn), so that one's softmax runs beside the other's
    // products.  Warpgroup 0 goes first.
    if (wg == 1) named_arrive(1);
    float oa[NF > 0 ? NF : 1][8][4], ob[DB > 0 ? DB / 8 : 1][4];
    float m_run[2], l_run[2];
    uint32_t pf[KK][4];
    // every O accumulator, for the fences around the products
    auto fence_o = [&]() {
#pragma unroll
      for (int f = 0; f < NF; ++f) fence_acc(oa[f]);
      if constexpr (DB > 0) fence_acc(ob);
    };

    int it = 0;  // tiles consumed so far, over all items
    for (int n = 0;; ++n) {
      mbar_wait(q_full, n & 1);
      const int j = s_item[n & 1];
      if (j < 0) break;
      const WorkItem w = work_item(p, j, band, BK);
      const int wq_lo = w.q_lo + wg * 64;  // this warpgroup's rows
      const int wq_hi = wq_lo + 63;
      const int row0 = wq_lo + warp * 16 + (lane >> 2);  // and row0 + 8
      const int n_tiles = w.kt_hi - w.kt_lo;
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          oa[f][i][0] = oa[f][i][1] = oa[f][i][2] = oa[f][i][3] = 0.f;
#pragma unroll
      for (int i = 0; i < (DB > 0 ? DB / 8 : 1); ++i)
        ob[i][0] = ob[i][1] = ob[i][2] = ob[i][3] = 0.f;
      m_run[0] = m_run[1] = NEG_INF;
      l_run[0] = l_run[1] = 0.f;

      // S = Q K^T of tile i of the item (issued, not waited for).  Each tile
      // has an accumulator of its own, declared where it is issued: one
      // array reused across tiles makes ptxas serialize every wgmma.
      auto issue_s = [&](float (&sacc)[NT][4], int i) {
        const int s = (it + i) % STAGES;
        const uint32_t k = sK + s * KT;
        mbar_wait(k_full(s), ((it + i) / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_s<BK>(
                sacc, wg_desc(qa + f * WG_BQ * 128 + ks * 32, 16, 1024, SW128),
                wg_desc(k + f * BK * 128 + ks * 32, 16, 1024, SW128),
                f + ks);
        if constexpr (DB > 0) {
#pragma unroll
          for (int ks = 0; ks < DB / 16; ++ks)
            wgmma_s<BK>(sacc,
                        wg_desc(qb + ks * 32, 16, CS::SBO, CS::LAYOUT),
                        wg_desc(k + KN + ks * 32, 16, CS::SBO, CS::LAYOUT),
                        NF + ks);
        }
        wgmma_commit();
      };
      // the online softmax of tile i on its S; returns the rescale factors
      auto softmax = [&](float (&sacc)[NT][4], int i, float (&alpha)[2]) {
        const int k_lo = (w.kt_lo + i) * BK;
        bool need_mask = k_lo + BK > p.Skv || scale2 <= 0.f;
        if (p.causal) need_mask = need_mask || (k_lo + BK - 1 > wq_lo);
        if (p.window > 0)
          need_mask = need_mask || (k_lo <= wq_hi - p.window);
        if (need_mask)
          softmax_tile<true, NT>(sacc, m_run, l_run, alpha, p, scale2, row0,
                                 k_lo + t2);
        else
          softmax_tile<false, NT>(sacc, m_run, l_run, alpha, p, scale2, 0,
                                  0);
      };
      // P in wgmma's register A layout: key step kk is S columns
      // 16kk .. 16kk + 15, the n-blocks 2kk and 2kk + 1
      auto pack_p = [&](const float (&sacc)[NT][4]) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          pf[kk][0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
          pf[kk][1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
          pf[kk][2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
          pf[kk][3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
        }
      };
      // Q is free for the next item once the last tile's Q.K^T is done
      auto release_q = [&]() {
        if (lane == 0) mbar_arrive(q_empty);
      };

      // Every tile of the item's band is processed; one outside this
      // warpgroup's rows is masked whole.  Tile i + 1's Q.K^T and softmax
      // run while tile i's P.V is in flight.
      if (n_tiles == 0) release_q();
      if (n_tiles > 0) {
        float alpha[2], sacc[NT][4];
        named_sync(1 + wg);
        issue_s(sacc, 0);
        named_arrive(2 - wg);
        wgmma_wait<0>();
        fence_acc(sacc);
        if (n_tiles == 1) release_q();
        softmax(sacc, 0, alpha);
        pack_p(sacc);
      }
      // O += P V of tile i, P from pf (issued and committed)
      auto issue_pv = [&](int i) {
        const int s = (it + i) % STAGES;
        const uint32_t v = sV + s * KT;
        mbar_wait(v_full(s), ((it + i) / STAGES) & 1);
        fence_o();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
            wgmma_rs_n64(oa[f], pf[kk],
                         wg_desc(v + f * BK * 128 + kk * 16 * 128, 16,
                                 1024, SW128));
          if constexpr (DB > 0)
            wgmma_rs_narrow<DB>(ob, pf[kk],
                                wg_desc(v + KN + kk * 16 * CS::RB, 16,
                                        CS::SBO, CS::LAYOUT));
        }
        wgmma_commit();
      };
      // after tile i's P.V: release its stage
      auto finish_pv = [&](int i) {
        wgmma_wait<0>();
        fence_o();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pf[kk][e]));
        if (lane == 0) mbar_arrive(kv_empty((it + i) % STAGES));
      };
      // The loop body has no branch around its products: ptxas serializes
      // every wgmma when it cannot match a wait to what it retires.
      for (int i = 0; i + 1 < n_tiles; ++i) {
        float alpha[2], sacc[NT][4];  // S of tile i + 1
        named_sync(1 + wg);
        issue_s(sacc, i + 1);
        issue_pv(i);
        named_arrive(2 - wg);
        wgmma_wait<1>();  // Q.K^T of tile i + 1 is done, P.V of tile i not
        fence_acc(sacc);
        if (i + 2 == n_tiles) release_q();
        softmax(sacc, i + 1, alpha);
        finish_pv(i);
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int d = 0; d < 8; ++d) {
            oa[f][d][0] *= alpha[0];
            oa[f][d][1] *= alpha[0];
            oa[f][d][2] *= alpha[1];
            oa[f][d][3] *= alpha[1];
          }
        if constexpr (DB > 0) {
#pragma unroll
          for (int d = 0; d < DB / 8; ++d) {
            ob[d][0] *= alpha[0];
            ob[d][1] *= alpha[0];
            ob[d][2] *= alpha[1];
            ob[d][3] *= alpha[1];
          }
        }
        pack_p(sacc);
      }
      if (n_tiles > 0) {  // the last tile's P.V
        named_sync(1 + wg);
        issue_pv(n_tiles - 1);
        named_arrive(2 - wg);
        finish_pv(n_tiles - 1);
      }
      it += n_tiles;

      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + w.b * p.o_sb +
                          w.h * p.o_sh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int row = row0 + r * 8;
        if (row < p.Sq && p.lse != nullptr && t2 == 0)
          p.lse[((long long)w.b * p.Hq + w.h) * p.Sq + row] =
              row_lse(m_run[r], l, 1.f / LOG2E);
        if (row < p.Sq) {
          __nv_bfloat16* orow = op + row * p.o_ss + t2;
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int d = 0; d < 8; ++d)
              *reinterpret_cast<__nv_bfloat162*>(orow + 64 * f + d * 8) =
                  __floats2bfloat162_rn(oa[f][d][2 * r] * inv,
                                        oa[f][d][2 * r + 1] * inv);
          if constexpr (DB > 0) {
#pragma unroll
            for (int d = 0; d < DB / 8; ++d)
              *reinterpret_cast<__nv_bfloat162*>(orow + 64 * NF + d * 8) =
                  __floats2bfloat162_rn(ob[d][2 * r] * inv,
                                        ob[d][2 * r + 1] * inv);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA body
// ---------------------------------------------------------------------------
//
// Shared memory: Q, K and V 64 x (D + 4) fp32 and P 64 x 68, 217,088 bytes
// at D = 256 of 232,448; registers: a 4 x D / 16 slice of O a thread (64
// at D = 256) beside a 4 x 4 tile of S.

template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int n_rows) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < n_rows ? src[row * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(256) flash_fwd_fma(const Params p) {
  constexpr int LD = D + 4;   // rows stay 16-byte aligned, float4 loads
  constexpr int LP = BK + 4;  // are conflict-free with this padding
  constexpr int CPT = D / 16; // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int q_lo = qt * BQ;
  const int q_hi = min(q_lo + BQ, p.Sq) - 1;
  int kt_lo, kt_hi;
  band_tiles(p, q_lo, q_hi, BK, kt_lo, kt_hi);

  load_tile_f32<D, LD>(sQ, qp, p.q_ss, q_lo, p.Sq);

  // thread (ty, tx): S rows ty*4 + i, S columns tx + 16*j; O rows ty*4 + i,
  // O columns tx*CPT + c.  The 16 threads of a row group sit in one half-warp.
  float oacc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) oacc[i][c] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();
    load_tile_f32<D, LD>(sK, kp, p.k_ss, k_lo, p.Skv);
    load_tile_f32<D, LD>(sV, vp, p.v_ss, k_lo, p.Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + ty * 4 + i;
      float mk[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = in_band(p, q_pos, k_lo + tx + 16 * j);
        mk[j] = ok ? 1.f : 0.f;
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new) * mk[j];
        psum += pv;
        sP[(ty * 4 + i) * LP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[i] = l_run[i] * alpha + psum;
#pragma unroll
      for (int c = 0; c < CPT; ++c) oacc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty * 4 + i) * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = sV[(kk + u) * LD + tx * CPT + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                         : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) oacc[i][c] = fmaf(pe, vv[c], oacc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row < p.Sq) {
      const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        op[row * p.o_ss + tx * CPT + c] = oacc[i][c] * inv;
      if (p.lse != nullptr && tx == 0)
        p.lse[((long long)b * p.Hq + h) * p.Sq + row] =
            row_lse(m_run[i], l_run[i], 1.f);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int block_rows,
                   int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq + block_rows - 1) / block_rows, p.Hq, p.B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_wgmma(const Params& p, void* next_item, cudaStream_t stream) {
  using CS = ColSplit<D>;
  TmaMaps maps;
  const __nv_bfloat16* src[3] = {static_cast<const __nv_bfloat16*>(p.q),
                                 static_cast<const __nv_bfloat16*>(p.k),
                                 static_cast<const __nv_bfloat16*>(p.v)};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  const int S[3] = {p.Sq, p.Skv, p.Skv}, H[3] = {p.Hq, p.Hkv, p.Hkv};
  const int rows[3] = {WG_BQ, fwd_bk(D), fwd_bk(D)};
  const long long ss[3] = {p.q_ss, p.k_ss, p.v_ss};
  const long long sh[3] = {p.q_sh, p.k_sh, p.v_sh};
  const long long sb[3] = {p.q_sb, p.k_sb, p.v_sb};
  for (int t = 0; t < 3; ++t) {
    int err = 0;
    if (CS::NF > 0)
      err = tensor_map_4d(&dst[t][0], src[t], 64 * CS::NF, 64, S[t], H[t],
                          p.B, ss[t], sh[t], sb[t], rows[t],
                          CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0 && CS::DB > 0)
      err = tensor_map_4d(&dst[t][1], src[t] + 64 * CS::NF, CS::DB, CS::DB,
                          S[t], H[t], p.B, ss[t], sh[t], sb[t], rows[t],
                          CS::TMA_SWIZZLE);
    if (err != 0) return err;
  }
  constexpr int smem = fwd_smem_bytes<D>();
  static_assert(smem <= 232448, "shared memory of one block");
  static int sms = 0;  // one block an SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = flash_fwd_bf16_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_items = (p.Sq + WG_BQ - 1) / WG_BQ * p.Hq * p.B;
  kernel<<<n_items < sms ? n_items : sms, WG_THREADS, smem, stream>>>(
      maps, p, static_cast<int*>(next_item));
  return (int)cudaGetLastError();
}

// body: 0 = fp32 FMA, 2 = bf16 wgmma + TMA
template <int D>
int dispatch_d(const Params& p, int body, void* next_item,
               cudaStream_t stream) {
  if (body == 0) {
    const size_t smem = sizeof(float) * (3 * 64 * (D + 4) + 64 * (BK + 4));
    return (int)launch(flash_fwd_fma<D>, p, BQ, 256, smem, stream);
  }
  if (body == 2 && next_item != nullptr)
    return launch_wgmma<D>(p, next_item, stream);
  return -1;
}

}  // namespace

// body: 0 = the fp32 FMA body (float32 tensors), 2 = the bf16 wgmma + TMA
// body (bfloat16 tensors); the wrapper chooses it by type.  D = 32, 64, 80,
// 128, 160 or 256.  Body 2 takes its work items from `next_item`, one int32 in
// device memory that is 0 at launch.  Both write each row's log-sum-exp to
// `lse` ([B,Hq,Sq] fp32) unless it is null, for the backward.  window <= 0
// means no window.  Strides are in elements; the stride along D is 1.  bf16 pointers
// and strides must keep every row 16-byte aligned (TMA's rule too).  Returns a cudaError_t, -1
// for an unsupported argument or -2 if a tensor map cannot be made; never
// synchronises.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    int body, void* next_item, float* lse, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return -1;
  if (Hq % Hkv != 0 || (body != 0 && body != 2)) return -1;
  if (Hq > 65535 || B > 65535) return -1;
  Params p{q,    k,    v,    o,    B,    Hq,   Hkv,  Sq,   Skv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal, window, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch_d<32>(p, body, next_item, s);
    case 64:
      return dispatch_d<64>(p, body, next_item, s);
    case 80:
      return dispatch_d<80>(p, body, next_item, s);
    case 128:
      return dispatch_d<128>(p, body, next_item, s);
    case 160:
      return dispatch_d<160>(p, body, next_item, s);
    case 256:
      return dispatch_d<256>(p, body, next_item, s);
    default:
      return -1;
  }
}

extern "C" const char* repro_flash_attention_error_string(int code) {
  if (code == -1) return "unsupported argument";
  if (code == ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled is missing or refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
