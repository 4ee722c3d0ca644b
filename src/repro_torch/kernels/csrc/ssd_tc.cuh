// The Hopper pieces of the Mamba2 SSD scan shared by its forward
// (ssd_scan.cu) and its backward (ssd_scan_bwd.cu), sm_90a: the tile layout
// every wgmma operand of the two bf16 bodies uses, the tensor maps that
// bring those tiles in by TMA, a ring of shared-memory slots guarded by
// mbarriers, the hi + lo split of an fp32 operand, the chunk's cumsum, and
// the chunk-state kernel (`ssd_emit`) that both bodies run.
//
// The tile: 64 rows of 64 bf16 columns, 128 bytes a row with the 128-byte
// swizzle, 8 KB at a 1024-byte boundary.  An operand of N = 128 columns is
// two tiles side by side ("parts"); one of 16 or 32 columns (P or N) is read
// into a whole tile, TMA filling the columns past the tensor's with zeros,
// so every product of both bodies is wgmma.m64n64k16 on these tiles, and
// the zero columns add nothing.  Rows past S arrive as zeros too; rows of
// the next chunk inside a tile are masked by the kernels' decays.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int TT = 64;          // rows of a tile
constexpr int TILE = 8192;      // bytes of a 64 x 64 bf16 tile
constexpr int MAX_CHUNK = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// parts of 64 columns of an operand of W columns
__host__ __device__ constexpr int parts(int w) { return (w + 63) / 64; }

// K-major operand: the 16 columns from k-step ks of a tile (A or B of
// wgmma, transpose bit 0).  MN-major: the 16 rows from k-step kk (transpose
// bit 1).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return wg_desc(tile + ks * 32, 16, 1024, SW128);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return wg_desc(tile + kk * 2048, 16, 1024, SW128);
}

// Byte offset of element (row, col) of a tile: the 16-byte chunk of the
// column, XOR the row within its group of 8.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}
// Two neighbouring bf16 values (col even) of a tile as floats.
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile,
                                            int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + swz(row, col)));
}

// Named barrier `id` (1..15) over the `n` threads of the warps that call it.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void zero_acc(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
}

// v = hi + lo with hi = bf16(v) and lo = bf16(v - hi), for two values.
__device__ __forceinline__ void split2(float x, float y, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(x, y);
  const float2 h = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(x - h.x, y - h.y);
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator as wgmma's register A operand, split: hi[kk]
// and lo[kk] are k-step kk (columns 16 kk .. 16 kk + 15).
__device__ __forceinline__ void split_frags(const float (&v)[8][4],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = v[2 * kk + (q >> 1)] + (q & 1) * 2;
      __nv_bfloat162 h, l;
      split2(src[0], src[1], h, l);
      hi[kk][q] = bf16x2_bits(h);
      lo[kk][q] = bf16x2_bits(l);
    }
}

// D (+)= A B for a 64-column tile of each, A in registers (both k-steps of
// hi, then of lo), B MN-major in shared memory: the product of a split fp32
// operand with a bf16 one.
__device__ __forceinline__ void rs_split(float (&d)[8][4],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(d, hi[kk], desc_mn(b, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(d, lo[kk], desc_mn(b, kk));
}

// A ring of `stages` slots of `bytes` each, a "full" mbarrier (one arrival:
// the producer's, with the bytes of the TMA loads) and an "empty" one (one
// arrival per consumer warp) a slot.  Item k goes into slot k % stages.
struct Ring {
  uint32_t slots, bars;
  int stages, bytes;
  __device__ uint32_t slot(int k) const {
    return slots + (k % stages) * bytes;
  }
  __device__ uint32_t full(int k) const { return bars + 8 * (k % stages); }
  __device__ uint32_t empty(int k) const {
    return bars + 8 * (stages + k % stages);
  }
  __device__ void init(int consumer_warps) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), consumer_warps);
    }
  }
  // producer: slot of item k free, then `tx` bytes expected on it
  __device__ void acquire(int k, int tx) const {
    if (k >= stages) mbar_wait(empty(k), (k / stages - 1) & 1);
    mbar_expect_tx(full(k), tx);
  }
  // consumer: item k has landed
  __device__ void wait(int k) const {
    mbar_wait(full(k), (k / stages) & 1);
  }
  // consumer: this warp is done with item k
  __device__ void release(int k) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(k));
  }
};

// `bytes` (a multiple of 16) from global memory at `src` (16-byte aligned)
// into shared memory at `dst`, completing on `bar`: TMA's one-dimensional
// bulk copy, for a head's cumsum (a tensor map would describe one row).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The map of a bf16 [B,S,H,W] operand (X, dY, y; or B and C with H the
// groups), read through its strides (elements) in tiles of 64 rows by 64
// columns with the 128-byte swizzle; a tile at column 64 f is part f.
inline int rows_map(CUtensorMap* map, const void* base, int w, int S, int H,
                    int B, long long ss, long long sh, long long sb) {
  return tensor_map_4d(map, base, w, 64, S, H, B, ss, sh, sb, TT,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map of the chunk states as the state passes leave them: `count`
// slabs of P N fp32, each holding, row by row, the bf16 hi and then the
// bf16 lo of each row of [P][N] (each fp32 row becomes its own two bf16
// rows, so that a pass writes in place the rows it has read); a tile is 64
// rows of P (rows >= P read as zero) by 64 of N, hi or lo, at coordinates
// (64 f, 0, 0 hi / 1 lo, slab).
inline int state_map(CUtensorMap* map, const void* base, int P, int N,
                     long long count) {
  return tensor_map_4d(map, base, N, 64, P, 2, (int)count, 2LL * N, N,
                       2LL * P * N, TT, CU_TENSOR_MAP_SWIZZLE_128B);
}


// Where element threadIdx.x + 256 e of rows [row0, ...) of [P][N] goes in
// a state slab of hi and lo rows: the thread's offset (bf16 elements), then
// 512 e more (N divides 256).
template <int N>
__device__ __forceinline__ int split_row_at(int row0) {
  static_assert(256 % N == 0, "N divides the 256 threads of a pass");
  return (row0 + threadIdx.x / N) * 2 * N + threadIdx.x % N;
}
// v as a bf16 hi at slab[at] and a bf16 lo N further, in its lo row
__device__ __forceinline__ void store_split_at(__nv_bfloat16* slab, int at,
                                               int n, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  slab[at] = hi;
  slab[at + n] = __float2bfloat16_rn(v - __bfloat162float(hi));
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

// ---------------------------------------------------------------------------
// Chunk states on wgmma: emit = (exp(total - cum) o Xbar)^T B, and in the
// backward also demit = (exp(cum) o dY)^T C
// ---------------------------------------------------------------------------
//
// One block per (chunk, head, batch): warps 0-3 consume (one warpgroup),
// warp 4 produces.  The producer brings each 64-row tile of Xbar (then dY)
// and of B (then C) into a ring of EMIT_STAGES slots by TMA.  The consumers
// decay each row of the Xbar tile, split it hi + lo into two tiles of their
// own (the same swizzled layout: a row's decay does not care where its
// columns sit), and run out^T (+)= hi^T B + lo^T B as wgmma with both
// operands MN-major in shared memory: out is 64 rows of P (zero rows past
// P) by N, 32 registers a 64-column part.  The decayed operand keeps about
// 16 bits of mantissa, as the plans (ssd_scan_split_plain,
// ssd_scan_bwd_split_plain) split it.
//
// What bounds it: bytes.  Xbar and B are read once a (chunk, head), and B
// again for every head of its group (from L2); the products are 4 L P N
// flop a (chunk, head).  log_a (fp32, H apart from row to row, 1/64 of the
// bytes) is read with plain loads, not TMA.

constexpr int EMIT_THREADS = 160;
constexpr int EMIT_STAGES = 2;

struct EmitMaps {
  CUtensorMap x, b, dy, c;  // dy, c: the backward's second product
};

struct EmitArgs {
  const float* log_a;  // [B,S,H]
  float* cum;          // [B,H,nc,LT]: the chunk's cumsum, the last value
                       // repeated past L (LT: L rounded up to whole tiles)
  float* emit;         // [B,H,nc,P,N] fp32
  float* demit;        // the same; null: the forward
  int S, H, G, L, nc, LT;
};

template <int P, int N>
constexpr int emit_smem_bytes() {
  return 1024 + EMIT_STAGES * (TILE + parts(N) * TILE) + 2 * TILE +
         16 * EMIT_STAGES + 4 * MAX_CHUNK;
}

template <int P, int N>
__global__ void __launch_bounds__(EMIT_THREADS)
    ssd_emit(const __grid_constant__ EmitMaps maps, const EmitArgs a) {
  constexpr int NP = parts(N);
  constexpr int STAGE = TILE + NP * TILE;  // the X (or dY) tile, then B (C)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);  // generic view of `base`
  const Ring ring{base, base + EMIT_STAGES * STAGE + 2 * TILE, EMIT_STAGES,
                  STAGE};
  const uint32_t sHi = base + EMIT_STAGES * STAGE, sLo = sHi + TILE;
  float* sCum = reinterpret_cast<float*>(gen + EMIT_STAGES * STAGE +
                                         2 * TILE + 16 * EMIT_STAGES);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int r0 = c * a.L, l = min(a.L, a.S - r0);
  const int nkt = (l + TT - 1) / TT;
  const int nprod = a.demit != nullptr ? 2 : 1;
  if (threadIdx.x == 0) {
    ring.init(4);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer
    if (threadIdx.x == 128) {
      for (int k = 0; k < nprod * nkt; ++k) {
        const int prod = k / nkt, row = r0 + (k % nkt) * TT;
        const uint32_t s = ring.slot(k);
        ring.acquire(k, STAGE);
        tma_load_4d(s, prod == 0 ? &maps.x : &maps.dy, ring.full(k), 0, row,
                    h, b);
        for (int f = 0; f < NP; ++f)
          tma_load_4d(s + TILE + f * TILE, prod == 0 ? &maps.b : &maps.c,
                      ring.full(k), 64 * f, row, g, b);
      }
    }
    return;
  }

  // the cumsum, a sequential scan in torch.cumsum's order along a dimension
  // that is not the innermost: at the serve path's |cum| of about 2000 a
  // block scan moves each decay by about eps * |cum|, and dlog_a with it
  const float* la = a.log_a + ((long long)b * a.S + r0) * a.H + h;
  for (int i = threadIdx.x; i < a.L; i += 128)
    sCum[i] = i < l ? la[(long long)i * a.H] : 0.f;
  bar_sync(1, 128);
  if (threadIdx.x == 0)
    for (int i = 1; i < a.L; ++i) sCum[i] += sCum[i - 1];
  bar_sync(1, 128);
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const float total = sCum[a.L - 1];
  for (int i = threadIdx.x; i < a.LT; i += 128)
    a.cum[bhc * a.LT + i] = i < a.L ? sCum[i] : total;
  const long long slab = bhc * P * N;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
  for (int prod = 0; prod < nprod; ++prod) {
    float acc[NP][8][4];
#pragma unroll
    for (int f = 0; f < NP; ++f) zero_acc(acc[f]);
    for (int kt = 0; kt < nkt; ++kt) {
      const int k = prod * nkt + kt;
      ring.wait(k);
      const uint32_t s = ring.slot(k);
      // every warp is past the previous tile's products: hi and lo are free
      bar_sync(1, 128);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int q = threadIdx.x + 128 * q4;  // 16-byte chunk of the tile
        const int row = kt * TT + (q >> 3);
        const float w =
            row < l ? expf(prod == 0 ? total - sCum[row] : sCum[row]) : 0.f;
        const uint4 raw4 = *reinterpret_cast<const uint4*>(gen + (s - base) +
                                                           q * 16);
        const uint32_t in[4] = {raw4.x, raw4.y, raw4.z, raw4.w};
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
        *reinterpret_cast<uint4*>(gen + (sHi - base) + q * 16) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(gen + (sLo - base) + q * 16) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 128);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < NP; ++f) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<1, 1>(acc[f], desc_mn(sHi, kk),
                             desc_mn(s + TILE + f * TILE, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<1, 1>(acc[f], desc_mn(sLo, kk),
                             desc_mn(s + TILE + f * TILE, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int f = 0; f < NP; ++f) fence_acc(acc[f]);
      ring.release(k);
    }
    float* out = (prod == 0 ? a.emit : a.demit) + slab;
#pragma unroll
    for (int f = 0; f < NP; ++f)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = warp * 16 + g8 + q * 8, col = 64 * f + 8 * i + t2;
          if (row < P && col < N)
            *reinterpret_cast<float2*>(out + row * N + col) =
                make_float2(acc[f][i][2 * q], acc[f][i][2 * q + 1]);
        }
  }
}

}  // namespace
