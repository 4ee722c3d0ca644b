// The tensor-core pieces of the Mamba2 SSD scan shared by its forward
// (ssd_scan.cu) and its backward (ssd_scan_bwd.cu), sm_90a: `mma.sync.m16n8k16`
// (bf16 in, fp32 accumulate) and its fragment loaders, the hi + lo split of an
// fp32 operand, bf16 tile loads, the chunk's cumsum, C B^T of a chunk once
// per group (`ssd_cb`), and a chunk's state product (`chunk_state_tc`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 64;  // rows of a tile
constexpr int TC_THREADS = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives elements (l % 4) * 2, +1 of row l / 4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(ptr)));
}

// A fragment (16 x 16, m x k) of a matrix stored [m][k] with row pitch ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int lane) {
  ldsm_x4(a, base + (lane & 15) * ld + (lane >> 4) * 8);
}
// A fragment (16 x 16, m x k) of a matrix stored [k][m] with row pitch ld.
__device__ __forceinline__ void frag_a_km(uint32_t (&a)[4],
                                          const __nv_bfloat16* base, int ld,
                                          int lane) {
  ldsm_x4_t(a, base + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                   ((lane >> 3) & 1) * 8);
}
// B fragments of two neighbouring n-tiles (16 x 16, k x n) of a matrix
// stored [n][k]: b[0], b[1] for n-tile 0, b[2], b[3] for n-tile 1.
__device__ __forceinline__ void frag_b2_nk(uint32_t (&b)[4],
                                           const __nv_bfloat16* base, int ld,
                                           int lane) {
  ldsm_x4(b, base + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                 ((lane >> 3) & 1) * 8);
}
// The same for a matrix stored [k][n].
__device__ __forceinline__ void frag_b2_kn(uint32_t (&b)[4],
                                           const __nv_bfloat16* base, int ld,
                                           int lane) {
  ldsm_x4_t(b, base + (lane & 15) * ld + (lane >> 4) * 8);
}
// One n-tile (16 x 8, k x n) of a matrix stored [k][n].
__device__ __forceinline__ void frag_b1_kn(uint32_t (&b)[2],
                                           const __nv_bfloat16* base, int ld,
                                           int lane) {
  ldsm_x2_t(b, base + (lane & 15) * ld);
}
// The same for a matrix stored [n][k].
__device__ __forceinline__ void frag_b1_nk(uint32_t (&b)[2],
                                           const __nv_bfloat16* base, int ld,
                                           int lane) {
  ldsm_x2(b, base + (lane & 7) * ld + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// v = hi + lo with hi = bf16(v) and lo = bf16(v - hi), for two values.
__device__ __forceinline__ void split2(float x, float y, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x - h.x, y - h.y);
}

// Rows [row0, row0 + TT) x W of a bf16 matrix (row stride `stride`, rows
// 16-byte aligned) into shared memory with row pitch LD; rows >= n_valid
// are written as zeros.  NTH threads.
template <int W, int LD, int NTH = TC_THREADS>
__device__ __forceinline__ void load_bf16_rows(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int row0,
                                               int n_valid) {
  constexpr int CH = W / 8;
  for (int idx = threadIdx.x; idx < TT * CH; idx += NTH) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// The same (ROWS rows) with 16-byte `cp.async` copies (rows >= n_valid
// become zeros); the caller commits and waits.
template <int W, int LD, int ROWS = TT, int NTH = TC_THREADS>
__device__ __forceinline__ void load_bf16_rows_async(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src,
                                                     long long stride,
                                                     int row0, int n_valid) {
  constexpr int CH = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTH) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < n_valid;
    const __nv_bfloat16* g = src + (ok ? row0 + r : 0) * stride + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LD + c)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// s_cum[i] = log_a[0] + ... + log_a[i] for i < len, reading log_a[i] as 0 for
// i >= l (so the tail repeats the last real sum), with NTH threads.  Ends
// with __syncthreads.
template <int NTH>
__device__ void chunk_cumsum(float* s_cum, float* s_warp, const float* la,
                             long long stride, int l, int len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < len; base += NTH) {
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
      constexpr int NW = NTH / 32;
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
    carry += s_warp[NTH / 32 - 1];
    __syncthreads();  // s_warp is rewritten in the next round
  }
}

// C B^T of one tile pair (qi, kj), kj <= qi, of one (b, chunk, group).
// Warp w: rows 16w.. of the query tile, the 64 keys as 8 n-tiles.
struct CbArgs {
  const __nv_bfloat16* bm;  // [B,S,G,N], batch and row strides below
  const __nv_bfloat16* cm;
  long long b_sb, b_ss, c_sb, c_ss;
  int S, L, nc, G, LT;  // L rows a chunk, LT: L rounded up to whole tiles
  float* cb;            // [B,nc,G,LT,LT]
};

template <int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_cb(const CbArgs p) {
  constexpr int LD = N + 8;  // padded rows: ldmatrix is conflict-free
  __shared__ __align__(16) __nv_bfloat16 sC[TT * LD];
  __shared__ __align__(16) __nv_bfloat16 sB[TT * LD];
  int t = blockIdx.x, qi = 0;
  while (t > qi) {
    t -= qi + 1;
    ++qi;
  }
  const int kj = t, c = blockIdx.y;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  const int r0 = c * p.L, l = min(p.L, p.S - r0);
  const int q0 = qi * TT, k0 = kj * TT;
  if (q0 >= l) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* cp = p.cm + b * p.c_sb + (long long)r0 * p.c_ss + g * N;
  const __nv_bfloat16* bp = p.bm + b * p.b_sb + (long long)r0 * p.b_ss + g * N;
  load_bf16_rows<N, LD>(sC, cp, p.c_ss, q0, l);
  load_bf16_rows<N, LD>(sB, bp, p.b_ss, k0, l);
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    frag_a(a, sC + warp * 16 * LD + ks * 16, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bf[4];
      frag_b2_nk(bf, sB + nt * 8 * LD + ks * 16, LD, lane);
      mma_16816(acc[nt], a, bf[0], bf[1]);
      mma_16816(acc[nt + 1], a, bf[2], bf[3]);
    }
  }
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  float* out = p.cb + (((long long)b * p.nc + c) * p.G + g) * p.LT * p.LT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + g8 + r * 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(out + (long long)i * p.LT + k0 + nt * 8 +
                                 t2) =
          make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

// The first tile of `chunk_state_tc`'s X and Bm into its buffers, committed.
template <int P, int N>
__device__ __forceinline__ void chunk_state_prefetch(
    const __nv_bfloat16* xp, long long x_ss, const __nv_bfloat16* bp,
    long long b_ss, int l, __nv_bfloat16* sX, __nv_bfloat16* sB) {
  load_bf16_rows_async<P, P + 8>(sX, xp, x_ss, 0, l);
  load_bf16_rows_async<N, N + 8>(sB, bp, b_ss, 0, l);
  cp_async_commit();
}

// One (b, chunk, head)'s state product on the tensor cores, with TC_THREADS
// threads: out [P][N] fp32 = (w o X)^T Bm over the chunk's l rows of X [l][P]
// and Bm [l][N] (row strides x_ss, b_ss), w_r = exp(total - cum_r) when
// `to_end` (the forward's emit), else exp(cum_r) (the backward's demit, from
// dY and C).  Warps split the [P][N] output: WM along P (one 16-row tile
// each), WN along N.  Tiles of 64 rows are double-buffered with cp.async
// (tile 0 must be in flight: `chunk_state_prefetch`); each X tile is then
// decayed and split in place (hi) and into sXl (lo), so w o X keeps about 16
// bits of mantissa.  sX [2][TT][P + 8], sXl [TT][P + 8], sB [2][TT][N + 8]
// bf16; sCum the chunk's cumsum.  Every thread is past its last read of the
// buffers on return.
template <int P, int N>
__device__ void chunk_state_tc(const __nv_bfloat16* xp, long long x_ss,
                               const __nv_bfloat16* bp, long long b_ss, int l,
                               const float* sCum, float total, bool to_end,
                               __nv_bfloat16* sX, __nv_bfloat16* sXl,
                               __nv_bfloat16* sB, float* out) {
  constexpr int LDX = P + 8, LDB = N + 8;
  constexpr int PM = P / 16, NN = N / 8;
  constexpr int WM = PM < 4 ? PM : 4, WN = 4 / WM;
  constexpr int NTW = (NN + WN - 1) / WN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp % WM) * 16, nt0 = (warp / WM) * NTW;

  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nkt = (l + TT - 1) / TT;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * TT;
    __nv_bfloat16* tX = sX + (t & 1) * TT * LDX;
    const __nv_bfloat16* tB = sB + (t & 1) * TT * LDB;
    if (t + 1 < nkt) {  // the next tile into the other buffer
      load_bf16_rows_async<P, LDX>(sX + ((t + 1) & 1) * TT * LDX, xp, x_ss,
                                   k0 + TT, l);
      load_bf16_rows_async<N, LDB>(sB + ((t + 1) & 1) * TT * LDB, bp, b_ss,
                                   k0 + TT, l);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed
    for (int idx = threadIdx.x; idx < TT * P / 8; idx += TC_THREADS) {
      const int r = idx / (P / 8), pp = (idx % (P / 8)) * 8;
      const float w =
          k0 + r < l ? expf(to_end ? total - sCum[k0 + r] : sCum[k0 + r])
                     : 0.f;
      uint4* px = reinterpret_cast<uint4*>(tX + r * LDX + pp);
      const uint4 raw = *px;
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        __nv_bfloat162 h2, l2;
        split2(v.x * w, v.y * w, h2, l2);
        hi[e] = bf16x2_bits(h2);
        lo[e] = bf16x2_bits(l2);
      }
      *px = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sXl + r * LDX + pp) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TT / 16; ++ks) {
      uint32_t ah[4], al[4];
      frag_a_km(ah, tX + ks * 16 * LDX + m0, LDX, lane);
      frag_a_km(al, sXl + ks * 16 * LDX + m0, LDX, lane);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (nt0 + i < NN) {  // warp-uniform
          uint32_t bf[2];
          frag_b1_kn(bf, tB + ks * 16 * LDB + (nt0 + i) * 8, LDB, lane);
          mma_16816(acc[i], ah, bf[0], bf[1]);
          mma_16816(acc[i], al, bf[0], bf[1]);
        }
      }
    }
    __syncthreads();  // readers of this buffer and of sXl are done
  }

  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    if (nt0 + i >= NN) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (m0 + g8 + r * 8) * N + (nt0 + i) * 8 +
                                 t2) =
          make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

}  // namespace
