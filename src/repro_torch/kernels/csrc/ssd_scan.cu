// Mamba2 SSD chunked scan, forward and backward, for sm_90a.
//
// Forward: replaces src/repro/kernels/ssd_scan.py:ssd_pallas (_kernel).
// Backward: has no TPU counterpart (jax.grad through ssd_pallas fails); it
// is the gradient of ref.ssd_chunked_jnp, which the plain version
// (autograd through kernels/ref.py:ssd_chunked) computes.
//
// Per (batch b, head h), with x (b, s, h, p), dt (b, s, h) f32, A (h,) f32,
// B/C (b, s, g, n) (head h reads group h / (h / g)), the sequence cut into
// chunks of L steps, and within a chunk (l, s local indices):
//   xdt[l]  = f32(x[l]) * dt[l]
//   cs[l]   = cumsum_{k <= l} dt[k] A              (f32, within the chunk)
//   W[l, s] = (C[l] . B[s]) exp(cs[l] - cs[s])     for s <= l, else 0
//   y[l]    = sum_s W[l, s] xdt[s] + exp(cs[l]) C[l] S_prev^T
//   S_new   = exp(cs[L-1]) S_prev + sum_s exp(cs[L-1] - cs[s]) xdt[s] B[s]^T
// with the state S (p, n) f32 carried from chunk to chunk, starting at 0.
// exp(cs[l] - cs[s]) is formed from the difference, as the reference does.
// Steps past the end of the sequence count as dt = 0, x = B = C = 0 (the
// reference pads to the chunk with those values).  The forward also writes
// the state at the start of every chunk, f32 (b, h, nc, p, n), which the
// backward reads; the forward's y is the reference's y.
//
// Bound: operations, on the f32 pipes (the reference computes in f32).  At
// the main path's shape (b 2, s 512, h 64, p 64, g 8, n 128, L 256) the
// forward needs 5.4 GFLOP (the causal half of each chunk's L x L products;
// 8.6 for the full squares) over 30 MB (x, B, C, dt, y and 8.4 MB of chunk
// states), the backward 12.9 GFLOP over 51 MB.  Design: one block of 256
// threads per (b, h) walks the chunks in order and keeps S in shared
// memory; within a chunk it works on 64-row tiles: for each row tile, the
// products with every earlier column tile (C B^T, the decay mask, W xdt),
// with the tiles of B, C, x dt and W staged in shared memory as f32.  Each
// thread owns a 4 x 4 (or 4 x 8) register tile of each product: rows
// ty + 16 i, columns tx + 16 j of the 16 x 16 thread grid.  Shared tiles
// have odd row strides, so a walk down a column touches 16 banks.  The
// 256 x 256 decay matrix is never stored: each 64 x 64 tile is formed from
// cs when it is used.  No tensor cores: the tiles are f32, and matching the
// reference's f32 arithmetic to 2e-5 rules out TF32 and bf16.
//
// The backward walks the chunks in reverse, carrying dS (p, n).  Per chunk,
// pass B runs over column tiles s (dx, dB and the state terms), pass A over
// row tiles l (dC and the next dS); dcs, the gradient of cs, gathers every
// term and a reverse cumsum turns it into d(dt A).  dB and dC are written
// per head (f32) and summed over each group's heads by a second kernel,
// which also sums dA over the batch: no atomics, so the result does not
// depend on the order blocks run in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;          // rows (or columns) of a tile of a chunk
constexpr int kPMax = 64;       // largest head dim p
constexpr int kNMax = 128;      // largest state dim n
constexpr int kLMax = 256;      // longest chunk
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kLdN = kNMax + 1; // odd row strides of the shared tiles
constexpr int kLdP = kPMax + 1;
constexpr int kLdT = kT + 1;

struct Dims {
  int b, s, h, p, g, n, L, nc;
};

// acc[i][j] += sum_{k < K} A[(r0 + 16 i) ar + k ak] (scale[k])
//                          Bm[k bk + (c0 + 16 j) bc]
template <int MR, int NR, bool kScale>
__device__ __forceinline__ void tile_mm(float (&acc)[MR][NR], const float* A,
                                        int ar, int ak, const float* Bm,
                                        int bk, int bc, int K,
                                        const float* scale, int r0, int c0) {
  for (int k = 0; k < K; ++k) {
    float a[MR], bv[NR];
#pragma unroll
    for (int i = 0; i < MR; ++i) a[i] = A[(r0 + 16 * i) * ar + k * ak];
    if (kScale) {
      const float sk = scale[k];
#pragma unroll
      for (int i = 0; i < MR; ++i) a[i] *= sk;
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) bv[j] = Bm[k * bk + (c0 + 16 * j) * bc];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

template <int MR, int NR>
__device__ __forceinline__ void zero(float (&acc)[MR][NR]) {
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.0f;
}

// Sum over the 16 threads of a half warp (the tx of one ty).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[r][c] = f32(src[r row_stride + c]) for r < rows, c < cols, else 0,
// over a kT x cols_max tile (row stride ld).  Neighbouring threads read
// neighbouring columns of one row: the loads coalesce.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int64_t row_stride,
                          int rows, int cols, int cols_max) {
  for (int idx = threadIdx.x; idx < kT * cols_max; idx += kThreads) {
    const int r = idx / cols_max, c = idx - r * cols_max;
    float v = 0.0f;
    if (r < rows && c < cols) v = to_f32(src[r * row_stride + c]);
    dst[r * ld + c] = v;
  }
}

// As load_tile for x, times dt of the row: x dt in f32, as the reference
// promotes x * dt (ssd_scan.py:103, ref.py:246).
template <typename T>
__device__ void load_xdt(float* dst, const T* src, int64_t row_stride,
                         const float* dts, int rows, int cols) {
  for (int idx = threadIdx.x; idx < kT * kPMax; idx += kThreads) {
    const int r = idx / kPMax, c = idx - r * kPMax;
    float v = 0.0f;
    if (r < rows && c < cols) v = __fmul_rn(to_f32(src[r * row_stride + c]),
                                            dts[r]);
    dst[r * kLdP + c] = v;
  }
}

// Inclusive scan over the block (256 threads, one value each).
__device__ float block_scan(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kThreads / 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    if (lane < kThreads / 32) red[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += red[warp - 1];
  __syncthreads();  // red is free again
  return v;
}

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The chunk's dt (0 past the sequence), cs = cumsum(dt A) (past the chunk:
// cs[L-1], since those steps add 0), and dec[l] = exp(cs[L-1] - cs[l]).
__device__ void chunk_setup(const float* dtb, const Dims& d, int t0,
                            float a_h, float* dts, float* cs, float* dec,
                            float* red) {
  const int tid = threadIdx.x;
  float dtv = 0.0f;
  if (tid < d.L && t0 + tid < d.s)
    dtv = dtb[static_cast<int64_t>(t0 + tid) * d.h];
  const float v = block_scan(__fmul_rn(dtv, a_h), red);
  dts[tid] = dtv;
  cs[tid] = v;
  __syncthreads();
  dec[tid] = expf(cs[d.L - 1] - v);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdSmemFloats =
    3 * kT * kLdN + 2 * kT * kLdP + 3 * kLMax + 32;  // S, Ci, Bj | Xj, Wt
static_assert(kPMax == kT, "S shares the kT x kLdN tile shape");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const T* x, const float* dt, const float* A, const T* B,
               const T* C, T* y, float* states, Dims d) {
  extern __shared__ float smem[];
  float* S = smem;              // [kPMax][kLdN] state
  float* Ci = S + kT * kLdN;    // [kT][kLdN] C of the row tile
  float* Bj = Ci + kT * kLdN;   // [kT][kLdN] B of the column tile
  float* Xj = Bj + kT * kLdN;   // [kT][kLdP] x dt of the column tile
  float* Wt = Xj + kT * kLdP;   // [kT][kLdT] W of the tile pair
  float* cs = Wt + kT * kLdT;
  float* dts = cs + kLMax;
  float* dec = dts + kLMax;
  float* red = dec + kLMax;

  const int bi = blockIdx.x / d.h, hi = blockIdx.x - bi * d.h;
  const int gi = hi / (d.h / d.g);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a_h = A[hi];
  const int64_t xrow = static_cast<int64_t>(d.h) * d.p;
  const int64_t brow = static_cast<int64_t>(d.g) * d.n;
  const T* xb = x + static_cast<int64_t>(bi) * d.s * xrow + hi * d.p;
  T* yb = y + static_cast<int64_t>(bi) * d.s * xrow + hi * d.p;
  const T* Bb = B + static_cast<int64_t>(bi) * d.s * brow + gi * d.n;
  const T* Cb = C + static_cast<int64_t>(bi) * d.s * brow + gi * d.n;
  const float* dtb = dt + static_cast<int64_t>(bi) * d.s * d.h + hi;
  float* st =
      states + (static_cast<int64_t>(bi) * d.h + hi) * d.nc * d.p * d.n;
  const int ntiles = (d.L + kT - 1) / kT;

  for (int i = tid; i < kT * kLdN; i += kThreads) S[i] = 0.0f;
  for (int c = 0; c < d.nc; ++c) {
    const int t0 = c * d.L;
    __syncthreads();
    for (int i = tid; i < d.p * d.n; i += kThreads) {
      const int pp = i / d.n;
      st[static_cast<int64_t>(c) * d.p * d.n + i] =
          S[pp * kLdN + i - pp * d.n];
    }
    chunk_setup(dtb, d, t0, a_h, dts, cs, dec, red);

    float accS[4][8];  // the chunk's new state terms, rows p, columns n
    zero(accS);
    for (int ti = 0; ti < ntiles; ++ti) {
      const int l0 = ti * kT;
      const int valid_i = max(0, min(min(kT, d.L - l0), d.s - (t0 + l0)));
      load_tile(Ci, kLdN, Cb + (t0 + l0) * brow, brow, valid_i, d.n, kNMax);
      __syncthreads();
      float acc[4][4];  // y of the row tile, rows l, columns p
      zero(acc);
      tile_mm<4, 4, false>(acc, Ci, kLdN, 1, S, 1, kLdN, d.n, nullptr, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = expf(cs[l0 + ty + 16 * a]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] *= e;
      }
      for (int tj = 0; tj <= ti; ++tj) {
        const int s0 = tj * kT;
        const int rows_j = min(kT, d.L - s0);
        const int valid_j = max(0, min(rows_j, d.s - (t0 + s0)));
        load_tile(Bj, kLdN, Bb + (t0 + s0) * brow, brow, valid_j, d.n, kNMax);
        load_xdt(Xj, xb + (t0 + s0) * xrow, xrow, dts + s0, valid_j, d.p);
        __syncthreads();
        float g[4][4];
        zero(g);
        tile_mm<4, 4, false>(g, Ci, kLdN, 1, Bj, 1, kLdN, d.n, nullptr, ty,
                             tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = l0 + ty + 16 * a, s = s0 + tx + 16 * q;
            Wt[(ty + 16 * a) * kLdT + tx + 16 * q] =
                (l < d.L && s <= l) ? g[a][q] * expf(cs[l] - cs[s]) : 0.0f;
          }
        __syncthreads();
        tile_mm<4, 4, false>(acc, Wt, kLdT, 1, Xj, kLdP, 1, rows_j, nullptr,
                             ty, tx);
        if (ti == ntiles - 1)  // every column tile passes here once
          tile_mm<4, 8, true>(accS, Xj, 1, kLdP, Bj, kLdN, 1, rows_j,
                              dec + s0, ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (r >= valid_i) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = tx + 16 * q;
          if (pp < d.p) yb[(t0 + l0 + r) * xrow + pp] = from_f32<T>(acc[a][q]);
        }
      }
    }
    const float E = expf(cs[d.L - 1]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float* sp = S + (ty + 16 * a) * kLdN + tx + 16 * q;
        *sp = __fadd_rn(__fmul_rn(E, *sp), accS[a][q]);
      }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdSmemFloats =
    4 * kT * kLdN + 4 * kT * kLdP + 16 * kT + 8 * kLMax + 32;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const T* dy, const T* x, const float* dt, const float* A,
               const T* B, const T* C, const float* states, T* dx,
               float* ddt, float* dA_part, float* dBh, float* dCh, Dims d) {
  extern __shared__ float smem[];
  float* dS = smem;             // [kPMax][kLdN] gradient of the carried state
  float* Sp = dS + kT * kLdN;   // [kPMax][kLdN] state at the chunk's start
  float* tA = Sp + kT * kLdN;   // [kT][kLdN] B (pass B) / C (pass A)
  float* tB = tA + kT * kLdN;   // [kT][kLdN] C (pass B) / B (pass A)
  float* Xa = tB + kT * kLdN;   // [kT][kLdP] x dt of the column tile
  float* Da = Xa + kT * kLdP;   // [kT][kLdP] dy of the row tile
  float* Wt = Da + kT * kLdP;   // [kT][kLdT] W
  float* Gt = Wt + kT * kLdT;   // [kT][kLdT] dG = dW o decay
  float* colp = Gt + kT * kLdT; // [16][kT] column partial sums
  float* cs = colp + 16 * kT;
  float* dts = cs + kLMax;
  float* dec = dts + kLMax;     // exp(cs[L-1] - cs[l])
  float* ein = dec + kLMax;     // exp(cs[l])
  float* dcs = ein + kLMax;     // gradient of cs
  float* ddx = dcs + kLMax;     // sum_p dxdt x, per row
  float* usum = ddx + kLMax;    // the state-decay terms u[s]
  float* dda = usum + kLMax;    // gradient of dt A
  float* red = dda + kLMax;

  const int bi = blockIdx.x / d.h, hi = blockIdx.x - bi * d.h;
  const int gi = hi / (d.h / d.g);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a_h = A[hi];
  const int64_t xrow = static_cast<int64_t>(d.h) * d.p;
  const int64_t brow = static_cast<int64_t>(d.g) * d.n;
  const int64_t hrow = static_cast<int64_t>(d.h) * d.n;  // dBh, dCh rows
  const int64_t xoff = static_cast<int64_t>(bi) * d.s * xrow + hi * d.p;
  const int64_t boff = static_cast<int64_t>(bi) * d.s * brow + gi * d.n;
  const int64_t hoff = static_cast<int64_t>(bi) * d.s * hrow + hi * d.n;
  const float* dtb = dt + static_cast<int64_t>(bi) * d.s * d.h + hi;
  const float* st =
      states + (static_cast<int64_t>(bi) * d.h + hi) * d.nc * d.p * d.n;
  const int ntiles = (d.L + kT - 1) / kT;
  float dA_acc = 0.0f;

  for (int i = tid; i < kT * kLdN; i += kThreads) dS[i] = 0.0f;
  for (int c = d.nc - 1; c >= 0; --c) {
    const int t0 = c * d.L;
    __syncthreads();
    for (int i = tid; i < kT * kNMax; i += kThreads) {
      const int pp = i / kNMax, nn = i - pp * kNMax;
      Sp[pp * kLdN + nn] =
          (pp < d.p && nn < d.n)
              ? st[static_cast<int64_t>(c) * d.p * d.n + pp * d.n + nn]
              : 0.0f;
    }
    chunk_setup(dtb, d, t0, a_h, dts, cs, dec, red);
    ein[tid] = expf(cs[tid]);
    dcs[tid] = 0.0f;
    ddx[tid] = 0.0f;
    usum[tid] = 0.0f;
    const float cs_last = cs[d.L - 1];
    __syncthreads();

    // ---- pass B: column tiles (s): dx, ddx, dB, usum; the Q terms of dcs
    for (int tj = 0; tj < ntiles; ++tj) {
      const int s0 = tj * kT;
      const int valid_j = max(0, min(min(kT, d.L - s0), d.s - (t0 + s0)));
      load_tile(tA, kLdN, B + boff + (t0 + s0) * brow, brow, valid_j, d.n,
                kNMax);
      load_xdt(Xa, x + xoff + (t0 + s0) * xrow, xrow, dts + s0, valid_j, d.p);
      __syncthreads();
      float adx[4][4], adB[4][8];  // rows s; columns p / n
      zero(adx);
      zero(adB);
      // S_new's terms: d_s B[s] dS^T and d_s xdt[s] dS
      tile_mm<4, 4, false>(adx, tA, kLdN, 1, dS, 1, kLdN, d.n, nullptr, ty,
                           tx);
      tile_mm<4, 8, false>(adB, Xa, kLdP, 1, dS, kLdN, 1, d.p, nullptr, ty,
                           tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const float dd = dec[s0 + r];
        float u = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          adx[a][q] *= dd;
          u = fmaf(Xa[r * kLdP + tx + 16 * q], adx[a][q], u);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) adB[a][q] *= dd;
        u = half_warp_sum(u);
        if (tx == 0 && s0 + r < d.L) usum[s0 + r] = u;
      }
      for (int ti = tj; ti < ntiles; ++ti) {
        const int l0 = ti * kT;
        const int rows_i = min(kT, d.L - l0);
        const int valid_i = max(0, min(rows_i, d.s - (t0 + l0)));
        load_tile(tB, kLdN, C + boff + (t0 + l0) * brow, brow, valid_i, d.n,
                  kNMax);
        load_tile(Da, kLdP, dy + xoff + (t0 + l0) * xrow, xrow, valid_i, d.p,
                  kPMax);
        __syncthreads();
        float g[4][4], w[4][4];  // rows l, columns s
        zero(g);
        zero(w);
        tile_mm<4, 4, false>(g, tB, kLdN, 1, tA, 1, kLdN, d.n, nullptr, ty,
                             tx);
        tile_mm<4, 4, false>(w, Da, kLdP, 1, Xa, 1, kLdP, d.p, nullptr, ty,
                             tx);
        float qcol[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float qrow = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = l0 + ty + 16 * a, s = s0 + tx + 16 * q;
            float Wv = 0.0f, dG = 0.0f, Q = 0.0f;
            if (l < d.L && s <= l) {
              const float Lm = expf(cs[l] - cs[s]);
              Wv = g[a][q] * Lm;
              dG = w[a][q] * Lm;
              Q = w[a][q] * Wv;
            }
            Wt[(ty + 16 * a) * kLdT + tx + 16 * q] = Wv;
            Gt[(ty + 16 * a) * kLdT + tx + 16 * q] = dG;
            qrow += Q;
            qcol[q] += Q;
          }
          qrow = half_warp_sum(qrow);
          if (tx == 0 && l0 + ty + 16 * a < d.L) dcs[l0 + ty + 16 * a] += qrow;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) colp[ty * kT + tx + 16 * q] = qcol[q];
        __syncthreads();
        if (tid < kT && s0 + tid < d.L) {
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < 16; ++r) v += colp[r * kT + tid];
          dcs[s0 + tid] -= v;
        }
        // dxdt += W^T dy, dB += dG^T C
        tile_mm<4, 4, false>(adx, Wt, 1, kLdT, Da, kLdP, 1, rows_i, nullptr,
                             ty, tx);
        tile_mm<4, 8, false>(adB, Gt, 1, kLdT, tB, kLdN, 1, rows_i, nullptr,
                             ty, tx);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const bool ok = r < valid_j;
        const int64_t t = t0 + s0 + r;
        float part = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = tx + 16 * q;
          if (ok && pp < d.p) {
            const int64_t at = xoff + t * xrow + pp;
            dx[at] = from_f32<T>(__fmul_rn(adx[a][q], dts[s0 + r]));
            part = fmaf(adx[a][q], to_f32(x[at]), part);
          }
        }
        part = half_warp_sum(part);
        if (tx == 0 && ok) ddx[s0 + r] = part;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int nn = tx + 16 * q;
          if (ok && nn < d.n) dBh[hoff + t * hrow + nn] = adB[a][q];
        }
      }
      __syncthreads();
    }

    // ---- pass A: row tiles (l): dC, the y_off term of dcs, the next dS
    const float E = expf(cs_last);
    float accS[4][8];  // rows p, columns n
    float part = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int at = (ty + 16 * a) * kLdN + tx + 16 * q;
        part = fmaf(dS[at], Sp[at], part);
        accS[a][q] = E * dS[at];
      }
    const float dsp = block_sum(part, red);  // sum dS_new o S_prev
    for (int ti = 0; ti < ntiles; ++ti) {
      const int l0 = ti * kT;
      const int valid_i = max(0, min(min(kT, d.L - l0), d.s - (t0 + l0)));
      load_tile(tA, kLdN, C + boff + (t0 + l0) * brow, brow, valid_i, d.n,
                kNMax);
      load_tile(Da, kLdP, dy + xoff + (t0 + l0) * xrow, xrow, valid_i, d.p,
                kPMax);
      __syncthreads();
      float adC[4][8];  // rows l, columns n
      zero(adC);
      tile_mm<4, 8, false>(adC, Da, kLdP, 1, Sp, kLdN, 1, d.p, nullptr, ty,
                           tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        const float e = ein[l0 + r];
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          adC[a][q] *= e;
          v = fmaf(tA[r * kLdN + tx + 16 * q], adC[a][q], v);
        }
        v = half_warp_sum(v);
        if (tx == 0 && l0 + r < d.L) dcs[l0 + r] += v;
      }
      tile_mm<4, 8, true>(accS, Da, 1, kLdP, tA, kLdN, 1, min(kT, d.L - l0),
                          ein + l0, ty, tx);
      for (int tj = 0; tj <= ti; ++tj) {
        const int s0 = tj * kT;
        const int rows_j = min(kT, d.L - s0);
        const int valid_j = max(0, min(rows_j, d.s - (t0 + s0)));
        __syncthreads();  // tB, Xa, Gt free
        load_tile(tB, kLdN, B + boff + (t0 + s0) * brow, brow, valid_j, d.n,
                  kNMax);
        load_xdt(Xa, x + xoff + (t0 + s0) * xrow, xrow, dts + s0, valid_j,
                 d.p);
        __syncthreads();
        float w[4][4];
        zero(w);
        tile_mm<4, 4, false>(w, Da, kLdP, 1, Xa, 1, kLdP, d.p, nullptr, ty,
                             tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = l0 + ty + 16 * a, s = s0 + tx + 16 * q;
            Gt[(ty + 16 * a) * kLdT + tx + 16 * q] =
                (l < d.L && s <= l) ? w[a][q] * expf(cs[l] - cs[s]) : 0.0f;
          }
        __syncthreads();
        tile_mm<4, 8, false>(adC, Gt, kLdT, 1, tB, kLdN, 1, rows_j, nullptr,
                             ty, tx);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (r >= valid_i) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int nn = tx + 16 * q;
          if (nn < d.n) dCh[hoff + (t0 + l0 + r) * hrow + nn] = adC[a][q];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dS[(ty + 16 * a) * kLdN + tx + 16 * q] = accS[a][q];

    // dcs: the u terms, then d cs[L-1] += E sum(dS_new o S_prev) + sum u
    const float utot = block_sum(tid < d.L ? usum[tid] : 0.0f, red);
    if (tid < d.L) {
      float v = dcs[tid] - usum[tid];
      if (tid == d.L - 1) v += E * dsp + utot;
      dcs[tid] = v;
    }
    __syncthreads();
    // d(dt A)[t] = sum_{t' >= t} dcs[t']: a scan of the reversed chunk
    const float sfx = block_scan(tid < d.L ? dcs[d.L - 1 - tid] : 0.0f, red);
    if (tid < d.L) dda[d.L - 1 - tid] = sfx;
    __syncthreads();
    float term = 0.0f;
    if (tid < d.L && t0 + tid < d.s) {
      ddt[(static_cast<int64_t>(bi) * d.s + t0 + tid) * d.h + hi] =
          fmaf(dda[tid], a_h, ddx[tid]);
      term = dda[tid] * dts[tid];
    }
    dA_acc += block_sum(term, red);
  }
  if (tid == 0) dA_part[bi * d.h + hi] = dA_acc;
}

// dB, dC: the per-head gradients summed over each group's heads, in B's
// type; dA: the per-(b, h) partials summed over the batch.
template <typename T>
__global__ void ssd_bwd_reduce(const float* dBh, const float* dCh,
                               const float* dA_part, T* dB, T* dC, float* dA,
                               Dims d) {
  const int rep = d.h / d.g;
  const int64_t total = static_cast<int64_t>(d.b) * d.s * d.g * d.n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t bt = i / (static_cast<int64_t>(d.g) * d.n);
    const int gn = static_cast<int>(i - bt * d.g * d.n);
    const int gi = gn / d.n, nn = gn - gi * d.n;
    const int64_t base = (bt * d.h + gi * rep) * d.n + nn;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += dBh[base + r * d.n];
      sc += dCh[base + r * d.n];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int hh = threadIdx.x; hh < d.h; hh += blockDim.x) {
      float v = 0.0f;
      for (int bb = 0; bb < d.b; ++bb) v += dA_part[bb * d.h + hh];
      dA[hh] = v;
    }
  }
}

bool bad_dims(int b, int s, int h, int p, int g, int n, int chunk) {
  return b < 1 || s < 1 || h < 1 || g < 1 || h % g || p < 1 || p > kPMax ||
         n < 1 || n > kNMax || chunk < 1 || chunk > kLMax;
}

Dims make_dims(int b, int s, int h, int p, int g, int n, int chunk) {
  return Dims{b, s, h, p, g, n, chunk, (s + chunk - 1) / chunk};
}

template <typename T>
cudaError_t fwd_typed(const void* x, const float* dt, const float* A,
                      const void* B, const void* C, void* y, float* states,
                      const Dims& d, cudaStream_t stream) {
  const size_t bytes = kFwdSmemFloats * sizeof(float);
  cudaError_t err = allow_smem(ssd_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<T><<<d.b * d.h, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), states, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_typed(const void* dy, const void* x, const float* dt,
                      const float* A, const void* B, const void* C,
                      const float* states, void* dx, float* ddt, float* dA,
                      void* dB, void* dC, float* dBh, float* dCh,
                      float* dA_part, const Dims& d, cudaStream_t stream) {
  const size_t bytes = kBwdSmemFloats * sizeof(float);
  cudaError_t err = allow_smem(ssd_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T><<<d.b * d.h, kThreads, bytes, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), dt, A,
      static_cast<const T*>(B), static_cast<const T*>(C), states,
      static_cast<T*>(dx), ddt, dA_part, dBh, dCh, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(d.b) * d.s * d.g * d.n;
  const int64_t need = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < 4096 ? need : 4096);
  ssd_bwd_reduce<T><<<blocks, kThreads, 0, stream>>>(
      dBh, dCh, dA_part, static_cast<T*>(dB), static_cast<T*>(dC), dA, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x (b, s, h, p), B/C (b, s, g, n) and y of one type (dtype 0: f32, 1:
// bf16); dt (b, s, h) and A (h,) f32; states (b, h, nc, p, n) f32 with nc =
// ceil(s / chunk).  All contiguous.  p <= 64, n <= 128, chunk <= 256, g
// divides h.  Returns a cudaError_t (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* states, int dtype, int b, int s, int h,
                             int p, int g, int n, int chunk, void* stream) {
  using namespace repro;
  if (bad_dims(b, s, h, p, g, n, chunk)) return cudaErrorInvalidValue;
  const Dims d = make_dims(b, s, h, p, g, n, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(states);
  if (dtype == kFloat32)
    return fwd_typed<float>(x, dtf, Af, B, C, y, sf, d, st);
  if (dtype == kBFloat16)
    return fwd_typed<__nv_bfloat16>(x, dtf, Af, B, C, y, sf, d, st);
  return cudaErrorInvalidValue;
}

// dy, dx like x; ddt like dt; dA like A; dB, dC like B; states as the
// forward wrote them; scratch: dBh, dCh (b, s, h, n) f32 and dA_part (b, h)
// f32.  Two launches on `stream`: the scan, then the group/batch sums.
extern "C" int repro_ssd_bwd(const void* dy, const void* x, const void* dt,
                             const void* A, const void* B, const void* C,
                             const void* states, void* dx, void* ddt,
                             void* dA, void* dB, void* dC, void* dBh,
                             void* dCh, void* dA_part, int dtype, int b,
                             int s, int h, int p, int g, int n, int chunk,
                             void* stream) {
  using namespace repro;
  if (bad_dims(b, s, h, p, g, n, chunk)) return cudaErrorInvalidValue;
  const Dims d = make_dims(b, s, h, p, g, n, chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* sf = static_cast<const float*>(states);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* bh = static_cast<float*>(dBh);
  float* ch = static_cast<float*>(dCh);
  float* ap = static_cast<float*>(dA_part);
  if (dtype == kFloat32)
    return bwd_typed<float>(dy, x, dtf, Af, B, C, sf, dx, ddtf, dAf, dB, dC,
                            bh, ch, ap, d, st);
  if (dtype == kBFloat16)
    return bwd_typed<__nv_bfloat16>(dy, x, dtf, Af, B, C, sf, dx, ddtf, dAf,
                                    dB, dC, bh, ch, ap, d, st);
  return cudaErrorInvalidValue;
}
