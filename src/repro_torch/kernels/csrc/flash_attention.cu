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
// Design for this card: one thread block per (b, h, q-tile of 64 rows).  The
// KV loop runs inside the block over exactly the tiles the band can touch,
// where the TPU kernel used a sequential fourth grid axis and skipped blocks.
// KV tiles hold 64 keys; a block owns 64 query rows (128 in the bf16 body for
// D <= 64).  D is 32, 64, 80 (zamba2's heads: five 16-deep k-steps, the last
// one through `ldmatrix.x2`) or 128.  Q, K, V tiles sit in shared memory with padded rows, so that
// fragment loads hit distinct banks; the running state lives in registers.
// The kernel reads q/k/v through (batch, head, row) strides with a unit
// stride along D, and masks the ragged edge itself: Sq and Skv are arbitrary.
//
// Two bodies:
//   * bf16: tensor cores through `mma.sync.m16n8k16`, 4 warps with 16 or 32
//     query rows each (every K/V fragment read from shared memory then feeds
//     two instructions: with 16 rows a warp the shared-memory reads, not the
//     tensor cores, set the pace).  K/V tiles are double-buffered with
//     `cp.async`.  The S accumulator fragments are re-packed in registers as
//     the A operand of P.V; K and V fragments come from `ldmatrix`.  A warp
//     skips a tile that lies outside the band of its own rows and drops the
//     mask arithmetic on a tile that lies wholly inside it: at D = 64 the
//     softmax's ALU work, not the products, is most of a tile's instructions.
//   * fp32: fp32 FMA on shared-memory tiles, 16x16 threads with a 4x4
//     micro-tile of S each.  Full fp32 products, no TF32: the reference holds
//     fp32 to rtol 2e-5.
//
// Causal attention is operation-bound on this card (about S/2 * 4 * D flop for
// every q row against 4 * D bytes); what the design does about it is to skip
// the tiles outside the band and to start the longest q-tiles first.
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
};

// Tile range [kt_lo, kt_hi) of KV tiles that the band of q rows [q_lo, q_hi]
// can touch: k_lo <= q_hi (causal), k_hi > q_lo - window (window).
__device__ __forceinline__ void band_tiles(const Params& p, int q_lo, int q_hi,
                                           int& kt_lo, int& kt_hi) {
  const int nkt = (p.Skv + BK - 1) / BK;
  kt_lo = 0;
  kt_hi = nkt;
  if (p.causal) kt_hi = min(nkt, q_hi / BK + 1);
  if (p.window > 0) {
    const int first = q_lo - p.window + 1;  // lowest key any row may see
    if (first > 0) kt_lo = first / BK;
  }
}

__device__ __forceinline__ bool in_band(const Params& p, int q_pos, int k_pos) {
  bool ok = k_pos < p.Skv;
  if (p.causal) ok = ok && (k_pos <= q_pos);
  if (p.window > 0) ok = ok && (k_pos > q_pos - p.window);
  return ok;
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* smem_ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives elements (l % 4) * 2, +1 of row l / 4 of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem_ptr)));
}

// Two 8x8 bf16 matrices, from the addresses of lanes 0-15.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* smem_ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(smem_ptr)));
}

// The same with each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem_ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&t);
}

// Starts the asynchronous copy of rows [row0, row0 + ROWS) x D of a bf16
// matrix with row stride `stride` into shared memory with row stride LD;
// rows beyond `n_rows` are filled with zeros.  The caller commits and waits.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int n_rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* g = src + (ok ? row : 0) * stride + c * 8;
    const int bytes = ok ? 16 : 0;  // 0: nothing is read, 16 zeros are written
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * LD + c * 8)),
                 "l"(g), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        s[nt][e] = in_band(p, q_pos0 + (e >> 1) * 8, k_pos0 + nt * 8 + (e & 1))
                       ? s[nt][e] * scale2
                       : NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // unmasked scores are still raw: the max commutes with scale2 > 0
    m_new[r] = fmaxf(m_run[r], MASKED ? mx[r] : mx[r] * scale2);
    alpha[r] = exp2f(m_run[r] - m_new[r]);
    m_run[r] = m_new[r];
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv;
      if (MASKED)  // a masked score is exactly NEG_INF: p = exp(s - m) * mask
        pv = s[nt][e] == NEG_INF ? 0.f : exp2f(s[nt][e] - m_new[e >> 1]);
      else
        pv = exp2f(fmaf(s[nt][e], scale2, -m_new[e >> 1]));
      s[nt][e] = pv;
      psum[e >> 1] += pv;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
}

// 4 warps; warp w owns the MT 16-row tiles [w * 16 * MT, (w + 1) * 16 * MT) of
// the block's 64 * MT query rows, so that a K or V fragment read from shared
// memory feeds MT tensor-core instructions.  K/V tiles are double-buffered
// with cp.async: tile kt + 1 is in flight while tile kt is multiplied.
template <int D, int MT>
__global__ void __launch_bounds__(128) flash_fwd_bf16_mma(const Params p) {
  constexpr int BQM = 64 * MT;
  constexpr int LD = D + 8;   // padded row: fragment loads are conflict-free
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NT = BK / 8;  // n-tiles of S
  constexpr int DT = D / 8;   // n-tiles of O
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQM * LD;      // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * BK * LD;   // [2][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int q_lo = qt * BQM;
  const int q_hi = min(q_lo + BQM, p.Sq) - 1;
  int kt_lo, kt_hi;
  band_tiles(p, q_lo, q_hi, kt_lo, kt_hi);
  // this warp's rows, for skipping tiles that lie outside its own band
  const int wq_lo = q_lo + warp * 16 * MT;
  const int wq_hi = wq_lo + 16 * MT - 1;

  float oacc[MT][DT][4];
  float m_run[MT][2], l_run[MT][2];  // rows g and g + 8 of each m-tile;
#pragma unroll                       // l: this thread's share of the row sum
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = NEG_INF;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      oacc[mt][dt][0] = oacc[mt][dt][1] = oacc[mt][dt][2] = oacc[mt][dt][3] =
          0.f;
  }

  load_tile_async<D, LD, BQM>(sQ, qp, p.q_ss, q_lo, p.Sq);
  if (kt_lo < kt_hi) {
    load_tile_async<D, LD, BK>(sK, kp, p.k_ss, kt_lo * BK, p.Skv);
    load_tile_async<D, LD, BK>(sV, vp, p.v_ss, kt_lo * BK, p.Skv);
  }
  cp_async_commit();

  uint32_t qf[MT][KS][4];
  const float scale2 = p.scale * LOG2E;  // softmax in base 2: exp2(s2 - m2)

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k_lo = kt * BK;
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_tile_async<D, LD, BK>(sK + (stage ^ 1) * BK * LD, kp, p.k_ss,
                                 k_lo + BK, p.Skv);
      load_tile_async<D, LD, BK>(sV + (stage ^ 1) * BK * LD, vp, p.v_ss,
                                 k_lo + BK, p.Skv);
      cp_async_commit();
      cp_async_wait<1>();  // tile kt (and Q) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kt == kt_lo) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* base =
            sQ + (warp * 16 * MT + mt * 16 + g) * LD + tig * 2;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          qf[mt][ks][0] = *reinterpret_cast<const uint32_t*>(base + ks * 16);
          qf[mt][ks][1] =
              *reinterpret_cast<const uint32_t*>(base + 8 * LD + ks * 16);
          qf[mt][ks][2] =
              *reinterpret_cast<const uint32_t*>(base + ks * 16 + 8);
          qf[mt][ks][3] =
              *reinterpret_cast<const uint32_t*>(base + 8 * LD + ks * 16 + 8);
        }
      }
    }

    bool live = wq_lo < p.Sq;
    if (p.causal) live = live && (k_lo <= wq_hi);
    if (p.window > 0) live = live && (k_lo + BK - 1 > wq_lo - p.window);
    if (live) {  // warp-uniform
      const __nv_bfloat16* tK = sK + stage * BK * LD;
      const __nv_bfloat16* tV = sV + stage * BK * LD;

      float sacc[MT][NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          sacc[mt][nt][0] = sacc[mt][nt][1] = sacc[mt][nt][2] =
              sacc[mt][nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks + 1 < KS; ks += 2) {
          uint32_t kf[4];  // b0, b1 of k-step ks, then of k-step ks + 1
          ldmatrix_x4(kf, tK + (nt * 8 + (lane & 7)) * LD + ks * 16 +
                              (lane >> 3) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(sacc[mt][nt], qf[mt][ks], kf[0], kf[1]);
            mma_16816(sacc[mt][nt], qf[mt][ks + 1], kf[2], kf[3]);
          }
        }
        if (KS % 2) {  // D = 80: five k-steps, the last one alone
          uint32_t kf[2];
          ldmatrix_x2(kf, tK + (nt * 8 + (lane & 7)) * LD + (KS - 1) * 16 +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_16816(sacc[mt][nt], qf[mt][KS - 1], kf[0], kf[1]);
        }
      }

      // Tiles wholly inside the band of this warp's rows skip the mask.
      bool need_mask = k_lo + BK > p.Skv || scale2 <= 0.f;
      if (p.causal) need_mask = need_mask || (k_lo + BK - 1 > wq_lo);
      if (p.window > 0) need_mask = need_mask || (k_lo <= wq_hi - p.window);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float alpha[2];
        if (need_mask)
          softmax_tile<true, NT>(sacc[mt], m_run[mt], l_run[mt], alpha, p,
                                 scale2, wq_lo + mt * 16 + g,
                                 k_lo + tig * 2);
        else
          softmax_tile<false, NT>(sacc[mt], m_run[mt], l_run[mt], alpha, p,
                                  scale2, 0, 0);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          oacc[mt][dt][0] *= alpha[0];
          oacc[mt][dt][1] *= alpha[0];
          oacc[mt][dt][2] *= alpha[1];
          oacc[mt][dt][3] *= alpha[1];
        }
      }

      // O += P.V : the S fragments of two neighbouring n-tiles are the A
      // fragment of one 16-key step.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pf[mt][0] = pack_bf16(sacc[mt][2 * kk][0], sacc[mt][2 * kk][1]);
          pf[mt][1] = pack_bf16(sacc[mt][2 * kk][2], sacc[mt][2 * kk][3]);
          pf[mt][2] =
              pack_bf16(sacc[mt][2 * kk + 1][0], sacc[mt][2 * kk + 1][1]);
          pf[mt][3] =
              pack_bf16(sacc[mt][2 * kk + 1][2], sacc[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t vf[4];  // b0, b1 of n-tile dt, then of n-tile dt + 1
          ldmatrix_x4_trans(vf, tV + (kk * 16 + (lane & 15)) * LD + dt * 8 +
                                    (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(oacc[mt][dt], pf[mt], vf[0], vf[1]);
            mma_16816(oacc[mt][dt + 1], pf[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // everyone is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // (no KV tile at all: the Q copy is still in flight)

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int row = wq_lo + mt * 16 + g + r * 8;
      if (row < p.Sq) {
        __nv_bfloat16* orow = op + row * p.o_ss + tig * 2;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
              __floats2bfloat162_rn(oacc[mt][dt][2 * r] * inv,
                                    oacc[mt][dt][2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 FMA body
// ---------------------------------------------------------------------------

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
  band_tiles(p, q_lo, q_hi, kt_lo, kt_hi);

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
cudaError_t dispatch_d(const Params& p, int dtype, cudaStream_t stream) {
  const size_t fma_smem = sizeof(float) * (3 * 64 * (D + 4) + 64 * (BK + 4));
  if (dtype == 0)
    return launch(flash_fwd_fma<D>, p, BQ, 256, fma_smem, stream);
  // two 16-row tiles per warp while the accumulators fit the register file
  // (D = 80 with two would hold 184 accumulator and Q registers a thread)
  constexpr int MT = D <= 64 ? 2 : 1;
  const size_t mma_smem =
      sizeof(__nv_bfloat16) * (64 * MT + 4 * BK) * (D + 8);
  return launch(flash_fwd_bf16_mma<D, MT>, p, 64 * MT, 128, mma_smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.  Strides are
// in elements;
// the stride along D is 1.  bf16 pointers and strides must keep 16-byte
// alignment of every row.  Returns a cudaError_t, or -1 for an unsupported
// argument; never synchronises.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Skv <= 0) return -1;
  if (Hq % Hkv != 0 || (dtype != 0 && dtype != 1)) return -1;
  if (Hq > 65535 || B > 65535) return -1;
  Params p{q,    k,    v,    o,    B,    Hq,   Hkv,  Sq,   Skv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)dispatch_d<32>(p, dtype, s);
    case 64:
      return (int)dispatch_d<64>(p, dtype, s);
    case 80:
      return (int)dispatch_d<80>(p, dtype, s);
    case 128:
      return (int)dispatch_d<128>(p, dtype, s);
    default:
      return -1;
  }
}

extern "C" const char* repro_flash_attention_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
