// The Mamba2 block's depthwise causal conv, its bias and its SiLU, forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs `_causal_conv`
// (src/repro/models/mamba.py) as array ops, which XLA fuses.  Eagerly in
// PyTorch the same function is a concatenation with the conv state, four
// shifted products, three adds, the bias and the SiLU, each a pass over
// [B, S, C] in device memory.  Same function here, in one pass:
//   x [B,S,C] (a strided view: the in-projection's conv columns), w [W,C],
//   b [C], optional state [B,W-1,C] (zeros if absent)
//   -> out = silu(b + sum_i w[i] * xpad[t + i]) [B,S,C] contiguous, with
//      xpad = [state | x] along time, and new_state = the last W-1 rows of
//      xpad [B,W-1,C].
// The sum and the SiLU are taken in fp32 and rounded once to the type of x.
//
// What bounds it on this card: bytes.  A position reads C inputs and writes
// C outputs, about 2 x 4352 x 2 B at mamba2-1.3b's widths in bf16, and does
// some 15 operations an element; the card moves 3.35 TB/s.  The design
// moves each byte once:
//   * a thread takes one 16-byte vector of channels (8 bf16 or 4 fp32) over
//     a tile of rows, walking along time with the last W-1 inputs of its
//     channels in registers, so an input row crosses device memory once (a
//     tile's first W-1 rows of halo come from the rows before it or from the
//     state);
//   * neighbouring threads take neighbouring vectors of one row, so a warp
//     reads 512 contiguous bytes of a row, and a thread keeps RB rows of
//     16-byte loads in flight;
//   * the input is read in place through its batch and row strides (no copy
//     of the in-projection's slice), the output written contiguous.
// Where C or a stride is no multiple of the vector, or a pointer is not
// 16-byte aligned, the same code loads and stores element by element.
//
// Backward, from the saved x, w, b and state and the output's gradient:
//   g = dout * silu'(pre), pre recomputed in registers;
//   dx[t] = sum_i w[i] g[t + W-1 - i] (g = 0 past the end), written once;
//   dstate[j] = sum_{i <= j} w[i] g[j - i], only where it is asked for;
//   dw[i] = sum_{b,t} g[t] xpad[t + i], db = sum_{b,t} g[t]: each tile
//   writes its fp32 partials to scratch, and a second kernel sums the tiles
//   in a fixed order.  No atomics: a gradient repeats bit for bit.
// A thread walks its tile's rows and W-1 rows past it (their g is the
// next tile's, recomputed here for dx of the tile's last rows).
//
// Plain C interface; the Python wrapper passes data_ptr()s and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 128;
constexpr int FWD_RB = 8;        // rows a thread loads before it computes
constexpr int BWD_RB = 4;
constexpr int SUM_COLS = 32;     // the tile sum: columns a block
constexpr int SUM_SLICES = 8;    //   and slices of the tiles it sums apart

struct Bf16 {
  using Bits = unsigned short;
  static constexpr int N = 8;
  __device__ static float f(Bits v) {
    return __uint_as_float(static_cast<unsigned int>(v) << 16);
  }
  __device__ static Bits bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F32 {
  using Bits = unsigned int;
  static constexpr int N = 4;
  __device__ static float f(Bits v) { return __uint_as_float(v); }
  __device__ static Bits bits(float v) { return __float_as_uint(v); }
};

template <class Ty>
union Pack {
  uint4 u;
  typename Ty::Bits e[Ty::N];
};

// N channels from p: one 16-byte load where `vec`, else the first n, the
// rest zero.
template <class Ty>
__device__ __forceinline__ uint4 load_pack(const typename Ty::Bits* p, int n,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  Pack<Ty> r;
  r.u = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < Ty::N; ++i)
    if (i < n) r.e[i] = p[i];
  return r.u;
}

template <class Ty>
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[Ty::N]) {
  Pack<Ty> r;
  r.u = raw;
#pragma unroll
  for (int i = 0; i < Ty::N; ++i) f[i] = Ty::f(r.e[i]);
}

template <class Ty>
__device__ __forceinline__ void store(typename Ty::Bits* p,
                                      const float (&f)[Ty::N], int n,
                                      bool vec) {
  Pack<Ty> r;
#pragma unroll
  for (int i = 0; i < Ty::N; ++i) r.e[i] = Ty::bits(f[i]);
  if (vec) {
    *reinterpret_cast<uint4*>(p) = r.u;
    return;
  }
#pragma unroll
  for (int i = 0; i < Ty::N; ++i)
    if (i < n) p[i] = r.e[i];
}

// N fp32 values: N / 4 16-byte stores where `vec`, else the first n.
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N],
                                          int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) p[j] = v[j];
}

template <class Ty>
__device__ __forceinline__ void load_row(const typename Ty::Bits* p, int n,
                                         bool vec, float (&f)[Ty::N]) {
  unpack<Ty>(load_pack<Ty>(p, n, vec), f);
}

struct Args {
  const void* x;        // [B,S,C] through x_sb, x_ss
  const void* w;        // [W,C]
  const void* b;        // [C]
  const void* state;    // [B,W-1,C] or null (zeros)
  const void* dout;     // backward: [B,S,C]
  void* out;            // forward: [B,S,C]; backward: dx [B,S,C]
  void* new_state;      // forward: [B,W-1,C]; backward: dstate or null
  float* part;          // backward: [B * ntiles, W+1, C] fp32
  int B, S, C, rows, ntiles, nvec;
  long long x_sb, x_ss;
  bool vec;
};

// The thread's channel vector, tile and batch row; false past the end.
struct Place {
  int c0, n, t0, t1, bi, tile;
};

template <class Ty>
__device__ __forceinline__ bool place(const Args& a, Place& pl) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rest = gid / a.nvec;
  pl.tile = static_cast<int>(rest % a.ntiles);
  pl.bi = static_cast<int>(rest / a.ntiles);
  if (pl.bi >= a.B) return false;
  pl.c0 = static_cast<int>(gid % a.nvec) * Ty::N;
  pl.n = min(Ty::N, a.C - pl.c0);
  pl.t0 = pl.tile * a.rows;
  pl.t1 = min(pl.t0 + a.rows, a.S);
  return true;
}

// w, b and the window of the W-1 rows before t0 (from x, the state or 0).
template <class Ty, int W>
__device__ __forceinline__ void prologue(const Args& a, const Place& pl,
                                         float (&w)[W][Ty::N],
                                         float (&bias)[Ty::N],
                                         float (&win)[W - 1][Ty::N]) {
  using Bits = typename Ty::Bits;
  constexpr int N = Ty::N;
#pragma unroll
  for (int i = 0; i < W; ++i)
    load_row<Ty>(static_cast<const Bits*>(a.w) + (long long)i * a.C + pl.c0,
                 pl.n, a.vec, w[i]);
  load_row<Ty>(static_cast<const Bits*>(a.b) + pl.c0, pl.n, a.vec, bias);
  const Bits* x = static_cast<const Bits*>(a.x) + pl.bi * a.x_sb + pl.c0;
  const Bits* st = a.state == nullptr ? nullptr
      : static_cast<const Bits*>(a.state)
        + (long long)pl.bi * (W - 1) * a.C + pl.c0;
#pragma unroll
  for (int k = 0; k < W - 1; ++k) {
    const int pos = pl.t0 - (W - 1) + k;
    if (pos >= 0) {
      load_row<Ty>(x + pos * a.x_ss, pl.n, a.vec, win[k]);
    } else if (st != nullptr) {
      load_row<Ty>(st + (long long)(pos + W - 1) * a.C, pl.n, a.vec, win[k]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) win[k][j] = 0.f;
    }
  }
}

// b + sum_i w[i] xpad[t + i]: the window (rows t .. t+W-2 of xpad) and x_t.
template <class Ty, int W>
__device__ __forceinline__ float pre_act(const float (&w)[W][Ty::N],
                                         const float (&bias)[Ty::N],
                                         const float (&win)[W - 1][Ty::N],
                                         const float (&xv)[Ty::N], int j) {
  float acc = w[0][j] * win[0][j];
#pragma unroll
  for (int i = 1; i < W - 1; ++i) acc = fmaf(w[i][j], win[i][j], acc);
  acc = fmaf(w[W - 1][j], xv[j], acc);
  return acc + bias[j];
}

template <class Ty, int W>
__global__ void __launch_bounds__(FWD_THREADS) causal_conv_fwd(Args a) {
  using Bits = typename Ty::Bits;
  constexpr int N = Ty::N;
  Place pl;
  if (!place<Ty>(a, pl)) return;
  float w[W][N], bias[N], win[W - 1][N];
  prologue<Ty, W>(a, pl, w, bias, win);
  const Bits* x = static_cast<const Bits*>(a.x) + pl.bi * a.x_sb + pl.c0;
  Bits* out = static_cast<Bits*>(a.out) + (long long)pl.bi * a.S * a.C
      + pl.c0;
  for (int t = pl.t0; t < pl.t1; t += FWD_RB) {
    uint4 raw[FWD_RB];
#pragma unroll
    for (int r = 0; r < FWD_RB; ++r)
      if (t + r < pl.t1)
        raw[r] = load_pack<Ty>(x + (t + r) * a.x_ss, pl.n, a.vec);
#pragma unroll
    for (int r = 0; r < FWD_RB; ++r) {
      if (t + r >= pl.t1) break;
      float xv[N], o[N];
      unpack<Ty>(raw[r], xv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = pre_act<Ty, W>(w, bias, win, xv, j);
        o[j] = __fdividef(p, 1.f + __expf(-p));
      }
      store<Ty>(out + (long long)(t + r) * a.C, o, pl.n, a.vec);
#pragma unroll
      for (int k = 0; k < W - 2; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j) win[k][j] = win[k + 1][j];
#pragma unroll
      for (int j = 0; j < N; ++j) win[W - 2][j] = xv[j];
    }
  }
  if (pl.t1 == a.S && a.new_state != nullptr) {
    Bits* ns = static_cast<Bits*>(a.new_state)
        + (long long)pl.bi * (W - 1) * a.C + pl.c0;
#pragma unroll
    for (int k = 0; k < W - 1; ++k)
      store<Ty>(ns + (long long)k * a.C, win[k], pl.n, a.vec);
  }
}

template <class Ty, int W>
__global__ void __launch_bounds__(BWD_THREADS) causal_conv_bwd(Args a) {
  using Bits = typename Ty::Bits;
  constexpr int N = Ty::N;
  Place pl;
  if (!place<Ty>(a, pl)) return;
  float w[W][N], bias[N], xw[W - 1][N];
  prologue<Ty, W>(a, pl, w, bias, xw);
  float gw[W - 1][N], dw[W][N], db[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < W - 1; ++k) gw[k][j] = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) dw[i][j] = 0.f;
  }
  const Bits* x = static_cast<const Bits*>(a.x) + pl.bi * a.x_sb + pl.c0;
  const long long row0 = (long long)pl.bi * a.S * a.C + pl.c0;
  const Bits* dout = static_cast<const Bits*>(a.dout) + row0;
  Bits* dx = static_cast<Bits*>(a.out) + row0;
  const bool first = pl.t0 == 0 && a.new_state != nullptr;
  const int end = pl.t1 + W - 1;  // rows q of g: the tile's and W-1 more
  for (int p = pl.t0; p < end; p += BWD_RB) {
    uint4 rx[BWD_RB], rd[BWD_RB];
#pragma unroll
    for (int r = 0; r < BWD_RB; ++r)
      if (p + r < end && p + r < a.S) {
        rx[r] = load_pack<Ty>(x + (p + r) * a.x_ss, pl.n, a.vec);
        rd[r] = load_pack<Ty>(dout + (long long)(p + r) * a.C, pl.n, a.vec);
      }
#pragma unroll
    for (int r = 0; r < BWD_RB; ++r) {
      const int q = p + r;
      if (q >= end) break;
      float g[N];
      if (q < a.S) {
        float xv[N], dv[N];
        unpack<Ty>(rx[r], xv);
        unpack<Ty>(rd[r], dv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float pre = pre_act<Ty, W>(w, bias, xw, xv, j);
          const float sg = __fdividef(1.f, 1.f + __expf(-pre));
          g[j] = dv[j] * (sg * fmaf(pre, 1.f - sg, 1.f));
        }
        if (q < pl.t1) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
#pragma unroll
            for (int i = 0; i < W - 1; ++i)
              dw[i][j] = fmaf(g[j], xw[i][j], dw[i][j]);
            dw[W - 1][j] = fmaf(g[j], xv[j], dw[W - 1][j]);
            db[j] += g[j];
          }
        }
#pragma unroll
        for (int k = 0; k < W - 2; ++k)
#pragma unroll
          for (int j = 0; j < N; ++j) xw[k][j] = xw[k + 1][j];
#pragma unroll
        for (int j = 0; j < N; ++j) xw[W - 2][j] = xv[j];
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) g[j] = 0.f;
      }
      if (q - (W - 1) >= pl.t0) {  // dx of row q - (W-1): g[q-W+1 .. q]
        float d[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float acc = w[0][j] * g[j];
#pragma unroll
          for (int i = 1; i < W; ++i)
            acc = fmaf(w[i][j], gw[W - 1 - i][j], acc);
          d[j] = acc;
        }
        store<Ty>(dx + (long long)(q - (W - 1)) * a.C, d, pl.n, a.vec);
      }
#pragma unroll
      for (int k = 0; k < W - 2; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j) gw[k][j] = gw[k + 1][j];
#pragma unroll
      for (int j = 0; j < N; ++j) gw[W - 2][j] = g[j];
      if (first && q == W - 2) {  // gw holds g[0 .. W-2]
        Bits* ds = static_cast<Bits*>(a.new_state)
            + (long long)pl.bi * (W - 1) * a.C + pl.c0;
#pragma unroll
        for (int jj = 0; jj < W - 1; ++jj) {
          float d[N];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            float acc = w[jj][j] * gw[0][j];
#pragma unroll
            for (int k = 1; k <= jj; ++k)
              acc = fmaf(w[jj - k][j], gw[k][j], acc);
            d[j] = acc;
          }
          store<Ty>(ds + (long long)jj * a.C, d, pl.n, a.vec);
        }
      }
    }
  }
  // this tile's partial dw (rows 0 .. W-1) and db (row W)
  float* part = a.part
      + ((long long)(pl.bi * a.ntiles + pl.tile) * (W + 1)) * a.C + pl.c0;
#pragma unroll
  for (int i = 0; i < W; ++i)
    store_f32<N>(part + (long long)i * a.C, dw[i], pl.n, a.vec);
  store_f32<N>(part + (long long)W * a.C, db, pl.n, a.vec);
}

// dw [W,C] and db [C] from the tiles' partials [T, W+1, C]: a column each of
// SUM_COLS threads; SUM_SLICES slices of the tiles summed apart (slice y
// takes tiles y, y + SUM_SLICES, ... in order), then the slices in order.
template <class Ty>
__global__ void __launch_bounds__(SUM_COLS * SUM_SLICES) causal_conv_wsum(
    const float* part, int tiles, int W, int C, void* dw, void* db) {
  __shared__ float sums[SUM_SLICES][SUM_COLS + 1];
  const int cols = (W + 1) * C;
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int t = threadIdx.y; t < tiles; t += SUM_SLICES)
      s += part[(long long)t * cols + col];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= cols) return;
  float tot = sums[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < SUM_SLICES; ++y) tot += sums[y][threadIdx.x];
  using Bits = typename Ty::Bits;
  if (col < W * C)
    static_cast<Bits*>(dw)[col] = Ty::bits(tot);
  else
    static_cast<Bits*>(db)[col - W * C] = Ty::bits(tot);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Ty>
int fill(Args& a, int B, int S, int C, int rows, long long x_sb,
         long long x_ss) {
  if (B <= 0 || S <= 0 || C <= 0 || rows <= 0) return -1;
  a.B = B;
  a.S = S;
  a.C = C;
  a.rows = rows;
  a.ntiles = (S + rows - 1) / rows;
  a.nvec = (C + Ty::N - 1) / Ty::N;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  const int n = Ty::N;
  a.vec = C % n == 0 && x_sb % n == 0 && x_ss % n == 0 && aligned(a.x)
      && aligned(a.w) && aligned(a.b) && aligned(a.out)
      && (a.state == nullptr || aligned(a.state))
      && (a.dout == nullptr || aligned(a.dout))
      && (a.new_state == nullptr || aligned(a.new_state))
      && (a.part == nullptr || aligned(a.part));
  return 0;
}

template <class Ty, int W>
int launch_fwd(Args a, cudaStream_t s) {
  const long long threads = (long long)a.B * a.ntiles * a.nvec;
  const long long blocks = (threads + FWD_THREADS - 1) / FWD_THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  causal_conv_fwd<Ty, W><<<static_cast<unsigned>(blocks), FWD_THREADS, 0,
                           s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Ty, int W>
int launch_bwd(Args a, void* dw, void* db, cudaStream_t s) {
  const long long threads = (long long)a.B * a.ntiles * a.nvec;
  const long long blocks = (threads + BWD_THREADS - 1) / BWD_THREADS;
  if (blocks > 0x7fffffffLL) return -1;
  causal_conv_bwd<Ty, W><<<static_cast<unsigned>(blocks), BWD_THREADS, 0,
                           s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = (W + 1) * a.C;
  causal_conv_wsum<Ty><<<(cols + SUM_COLS - 1) / SUM_COLS,
                         dim3(SUM_COLS, SUM_SLICES), 0, s>>>(
      a.part, a.B * a.ntiles, W, a.C, dw, db);
  return static_cast<int>(cudaGetLastError());
}

template <class Ty>
int fwd_width(const Args& a, int W, cudaStream_t s) {
  switch (W) {
    case 2: return launch_fwd<Ty, 2>(a, s);
    case 3: return launch_fwd<Ty, 3>(a, s);
    case 4: return launch_fwd<Ty, 4>(a, s);
    default: return -1;
  }
}

template <class Ty>
int bwd_width(const Args& a, int W, void* dw, void* db, cudaStream_t s) {
  switch (W) {
    case 2: return launch_bwd<Ty, 2>(a, dw, db, s);
    case 3: return launch_bwd<Ty, 3>(a, dw, db, s);
    case 4: return launch_bwd<Ty, 4>(a, dw, db, s);
    default: return -1;
  }
}

}  // namespace

// dtype 0: fp32, 1: bf16 (x, w, b, state, out and new_state of one type).
// Strides in elements; rows: rows of a tile (the wrapper's choice).
extern "C" int repro_causal_conv_fwd(const void* x, const void* w,
                                     const void* b, const void* state,
                                     void* out, void* new_state, int B, int S,
                                     int C, int W, long long x_sb,
                                     long long x_ss, int rows, int dtype,
                                     void* stream) {
  Args a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.state = state;
  a.out = out;
  a.new_state = new_state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (fill<F32>(a, B, S, C, rows, x_sb, x_ss) != 0) return -1;
    return fwd_width<F32>(a, W, s);
  }
  if (dtype != 1 || fill<Bf16>(a, B, S, C, rows, x_sb, x_ss) != 0) return -1;
  return fwd_width<Bf16>(a, W, s);
}

// dx [B,S,C] and, where dstate is not null, dstate [B,W-1,C] in the type of
// x; dw [W,C] and db [C] in the same type, through part, fp32 scratch of
// [B * ceil(S / rows), W+1, C].
extern "C" int repro_causal_conv_bwd(const void* x, const void* w,
                                     const void* b, const void* state,
                                     const void* dout, void* dx,
                                     void* dstate, void* part, void* dw,
                                     void* db, int B, int S, int C, int W,
                                     long long x_sb, long long x_ss, int rows,
                                     int dtype, void* stream) {
  if (part == nullptr || dw == nullptr || db == nullptr || dout == nullptr)
    return -1;
  Args a{};
  a.x = x;
  a.w = w;
  a.b = b;
  a.state = state;
  a.dout = dout;
  a.out = dx;
  a.new_state = dstate;
  a.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (fill<F32>(a, B, S, C, rows, x_sb, x_ss) != 0) return -1;
    return bwd_width<F32>(a, W, dw, db, s);
  }
  if (dtype != 1 || fill<Bf16>(a, B, S, C, rows, x_sb, x_ss) != 0) return -1;
  return bwd_width<Bf16>(a, W, dw, db, s);
}

extern "C" const char* repro_causal_conv_error_string(int code) {
  if (code == -1) return "unsupported argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
