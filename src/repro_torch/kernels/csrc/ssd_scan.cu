// Mamba2 SSD chunked scan, forward and backward, for sm_90a.
//
// Forward: replaces src/repro/kernels/ssd_scan.py:77 ssd_pallas (its body
// `_kernel`).  Backward: has no TPU counterpart (jax.grad through
// ssd_pallas fails); it is the gradient of ref.ssd_chunked_jnp, which the
// plain version (autograd through kernels/ref.py:ssd_chunked) computes.
//
// Per (batch b, head h), with x (b, s, h, p), dt (b, s, h) f32, A (h,) f32,
// B/C (b, s, g, n) (head h reads group h / (h / g)), the sequence cut into
// chunks of L steps, and within a chunk (l, s local indices):
//   cs[l]   = cumsum_{k <= l} dt[k] A              (f32, within the chunk)
//   G[l, s] = C[l] . B[s]                          (per group)
//   W[l, s] = G[l, s] exp(cs[l] - cs[s]) dt[s]     for s <= l, else 0
//   y[l]    = sum_s W[l, s] x[s] + exp(cs[l]) C[l] S^T
//   S_next  = exp(cs[L-1]) S + sum_s exp(cs[L-1] - cs[s]) dt[s] x[s] B[s]^T
// with S (p, n) f32 the state at the chunk's start, 0 for the first chunk.
// Every decay is formed from a difference, exp(cs[l] - cs[s]), as the
// reference does: with mamba2's dt (about 0.7) a 256-step chunk reaches cs
// of about -180, and exp(-cs) would overflow f32.  Steps past the end of
// the sequence count as dt = 0, x = B = C = 0 (the reference pads to the
// chunk with those values).  The forward also writes the state at the
// start of every chunk, f32 (b, h, nc, p, n), which the backward reads.
//
// bf16 (the main path's type; p and n multiples of 8, at most 8 heads a
// group) runs on the tensor cores.  Bound: bytes.  At the main path's
// shape (b 2, s 512, h 64, p 64, g 8, n 128, L 256) the forward moves 29.6
// MB (x, B, C, dt, y and the chunk states) and does 3.5 GFLOP, the
// backward 50.8 MB and 7.0 GFLOP: on the tensor cores, even with every f32
// operand as a bf16 pair, the products take less time than the bytes.  The
// design splits the scan into stages that each fill the card:
//   ssd_chunk_state_tc  cs of every chunk, and (b) each chunk's own state
//                       terms, one CTA per (chunk, b, h, 32 columns of n):
//                       1024 CTAs at the main shape; in the backward the
//                       same kernel forms the gradient each chunk's y sends
//                       to its start state;
//   ssd_pass_fwd / _bwd (c) the pass over chunks, elementwise over (p, n);
//                       with at most two chunks (the main shape) there is
//                       nothing to pass and neither is launched;
//   ssd_fwd_y_tc        (a, d) y of one 64-row tile of one chunk and head:
//                       1024 CTAs.  G's 64 x 32 tiles stay in registers,
//                       become W there and feed W x as the A operand;
//   ssd_bwd_chunk_tc    per 64-row tile of a chunk and head, role 0 over
//                       the columns s (dx, dB and the column sums of dcs),
//                       role 1 over the rows l (dC and the row sums): 2048
//                       CTAs.  The heads of a group form a thread block
//                       cluster; each CTA leaves its head's dB or dC tile in
//                       shared memory and the cluster sums them in head
//                       order through distributed shared memory, so no
//                       per-head gradient goes to device memory;
//   ssd_bwd_dcs         ddt and dA from the per-step terms, a reverse scan
//                       per (chunk, b, h); the last block of a head sums its
//                       dA in a fixed order.
// So a call is 2 launches forward and 3 backward at the main shape (one
// more each with three chunks or more).
// No float atomics anywhere: the result does not depend on the order CTAs
// run in.  Products are mma.sync m16n8k16, bf16 in and f32 accumulation,
// operands by ldmatrix from shared memory filled by cp.async (the tiles of
// the inner loop double-buffered).  B, C, x and dy enter as they are, so
// their products are exact.  The f32 operands (W = G o decay o dt, the
// states S and dS, x or dy times a per-step decay, dG) enter as a bf16 hi
// + lo pair, two MMAs, about 16 mantissa bits: the model's decays need
// more than one bf16 rounding (tests/test_torch_ssd_stages.py).  Small
// shapes are zero-padded in shared memory to p 64 and n 128.
//
// f32 (and the shapes above that the tensor-core kernels do not take) runs
// the SIMT kernels: one block of 256 threads per (b, h) walks the chunks
// in order and keeps S in shared memory; products on the f32 pipes from
// 64-row f32 tiles in shared memory (each thread a 4 x 4 or 4 x 8 register
// tile), matching the reference's f32 arithmetic.  Their backward walks the
// chunks in reverse, carrying dS; dB and dC are written per head (f32) and
// summed over each group's heads by ssd_bwd_reduce, which also sums dA.
// repro_ssd_plan says which route a call takes, its launches and scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // four warps: 16 rows each of a 64-row tile
constexpr int kNq = 32;          // state columns of a chunk-state CTA
// bf16 row strides in shared memory: rows 16 B apart modulo 128 B, so the
// eight rows of an ldmatrix hit distinct banks
constexpr int kLdX = kPMax + 8;
constexpr int kLdB = kNMax + 8;
constexpr int kLdQ = kNq + 8;
constexpr int kLdR = kNMax + 4;  // f32 rows of a group sum
constexpr int kMaxRep = 8;       // heads a group: a portable cluster
constexpr int kStage = kT * (kLdB + kLdX);  // bf16 of one ring stage

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (v0, v1) as a bf16 hi + lo pair.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// The A operand of k-step kk from the accumulators of n8 tiles 2 kk and
// 2 kk + 1 (16 rows x 16 columns), as a pair.
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// acc[2 j], acc[2 j + 1] += a times the two n8 tiles of b.
__device__ __forceinline__ void mma2(float (&c0)[4], float (&c1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma16816(c0, a, b[0], b[1]);
  mma16816(c1, a, b[2], b[3]);
}

// ldmatrix addressing for m16n8k16 (lane l = threadIdx.x % 32).
// A, 16 x 16 at (m0, k0), from [m][k] storage (k contiguous).
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* s, int ld,
                                    int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(a, s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}
// A, 16 x 16 at (m0, k0), from [k][m] storage (m contiguous).
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* s,
                                      int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(a, s + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + m0 +
                           ((l >> 3) & 1) * 8);
}
// B of the n8 tiles n0 and n0 + 8 over k0 .. k0 + 15, from [n][k] storage
// (k contiguous): {b0, b1} of the first tile, then of the second.
__device__ __forceinline__ void ldb(uint32_t (&b)[4], const bf16* s, int ld,
                                    int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4(b, s + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 +
                     ((l >> 3) & 1) * 8);
}
// The same from [k][n] storage (n contiguous).
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* s,
                                      int ld, int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldmatrix_x4_trans(b, s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 +
                           (l >> 4) * 8);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows_total x cols_total bf16 into shared memory (row stride ld) by
// cp.async, 16 bytes a copy: rows r < rows and column chunks c < cols from
// src (row stride `stride`), the rest zeros (read from nowhere: `base` is
// any valid address).  cols is a multiple of 8.
__device__ __forceinline__ void load_async(bf16* dst, int ld, const bf16* src,
                                           int64_t stride, int rows, int cols,
                                           int rows_total, int cols_total,
                                           const bf16* base) {
  const int per_row = cols_total / 8;
  for (int i = threadIdx.x; i < rows_total * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * 8;
    const bool ok = r < rows && c < cols;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : base,
               ok ? 16 : 0);
  }
}

// cs and dt of chunk c of (bi, hi) into shared memory: css[l] for l <
// kLMax (past L: cs[L-1]), dts[l] (0 past the chunk or the sequence).
// Unrolled, so that each thread's loads are in flight together.
__device__ void chunk_vectors(float* css, float* dts, const float* cs,
                              const float* dt, int bi, int hi, int c,
                              const Dims& d) {
  const float* csc =
      cs + ((static_cast<int64_t>(bi) * d.h + hi) * d.nc + c) * d.L;
  const int t0 = c * d.L;
#pragma unroll
  for (int k = 0; k < kLMax / kTcThreads; ++k) {
    const int l = threadIdx.x + k * kTcThreads;
    css[l] = csc[min(l, d.L - 1)];
    dts[l] = (l < d.L && t0 + l < d.s)
                 ? dt[(static_cast<int64_t>(bi) * d.s + t0 + l) * d.h + hi]
                 : 0.0f;
  }
}

// A state (p, n) f32 as bf16 hi and lo, [kPMax][kLdB] each, zero past p, n.
// Each thread's 32 pairs of values are loaded in two batches of 16 loads
// in flight, then split.
__device__ void split_state(bf16* hi_s, const float* S, const Dims& d) {
  bf16* lo_s = hi_s + kPMax * kLdB;
  constexpr int kPairs = kPMax * kNMax / 2 / kTcThreads, kBatch = 16;
#pragma unroll
  for (int b0 = 0; b0 < kPairs; b0 += kBatch) {
    float2 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = threadIdx.x + (b0 + k) * kTcThreads;
      const int r = i / (kNMax / 2), c = 2 * (i % (kNMax / 2));
      v[k] = r < d.p && c < d.n
                 ? *reinterpret_cast<const float2*>(S + r * d.n + c)
                 : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = threadIdx.x + (b0 + k) * kTcThreads;
      const int r = i / (kNMax / 2), c = 2 * (i % (kNMax / 2));
      uint32_t h, l;
      split_pair(v[k].x, v[k].y, h, l);
      *reinterpret_cast<uint32_t*>(hi_s + r * kLdB + c) = h;
      *reinterpret_cast<uint32_t*>(lo_s + r * kLdB + c) = l;
    }
  }
}

// acc += A times a state pair: the n8 tiles 2 jp, 2 jp + 1 of the hi and the
// lo halves, the halves at s and s + kPMax kLdB.
template <bool kTrans>
__device__ __forceinline__ void mma_state(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&a)[4],
                                          const bf16* s, int n0, int k0) {
  uint32_t bh[4], bl[4];
  if (kTrans) {
    ldb_t(bh, s, kLdB, n0, k0);
    ldb_t(bl, s + kPMax * kLdB, kLdB, n0, k0);
  } else {
    ldb(bh, s, kLdB, n0, k0);
    ldb(bl, s + kPMax * kLdB, kLdB, n0, k0);
  }
  mma2(c0, c1, a, bh);
  mma2(c0, c1, a, bl);
}

// A pair times B: acc[2 jp], acc[2 jp + 1] += (hi + lo) b.
__device__ __forceinline__ void mma2_pair(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[4]) {
  mma2(c0, c1, hi, b);
  mma2(c0, c1, lo, b);
}

// cp.async.wait_group n for a count known only at run time (n <= 3).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// cs of one chunk: css[l] = cumsum_{k <= l} dt[k] A over 128 threads, two
// steps each (dt 0 past `rows`, so css[l] for l >= L is cs[L-1]); returns
// the thread's two dt values.
__device__ float2 chunk_scan(float* css, const float* dtb, int64_t stride,
                             float a_h, int rows, float* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, l0 = 2 * t;
  const float d0 = l0 < rows ? dtb[l0 * stride] : 0.0f;
  const float d1 = l0 + 1 < rows ? dtb[(l0 + 1) * stride] : 0.0f;
  const float v0 = __fmul_rn(d0, a_h), v1 = __fmul_rn(d1, a_h);
  float v = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) red[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += red[w];
  css[l0] = v - v1;
  css[l0 + 1] = v;
  __syncthreads();
  return make_float2(d0, d1);
}

// Stage (b) and its mirror, and cs.  Every CTA first forms cs of its
// chunk; those with blockIdx.x 0 write it (b, h, nc, L) for the kernels
// after.  Then kMode 0 (forward), for chunk c < nc - 1: out[b, h, c + 1] =
// sum_s (x[s] dt[s] exp(cs[L-1] - cs[s])) B[s]^T; kMode 1 (backward), for
// chunk c >= 1: out[b, h, c - 1] = sum_l (dy[l] exp(cs[l])) C[l]^T.  u is
// x or dy, v is B or C.  M = p (warp w: rows 16 w), N = the 32 columns n
// of blockIdx.x, K = the chunk's steps in pieces of 64 that arrive by
// cp.async one after the other; u scaled per step in f32 is the A
// operand, as a pair, the hi and lo products in separate accumulators.
// The backward's CTA (0, 0, 0) also zeroes the per-head tickets of
// ssd_bwd_dcs.  grid (ceil(n / 32), nc, b h).
constexpr int kStateSmem = kLMax * (kLdX + kLdQ) * 2 + 2 * kLMax * 4 + 128;

template <int kMode>
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_state_tc(const bf16* u, const bf16* v, const float* dt,
                       const float* A, float* cs, float* out, int* tickets,
                       Dims d) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Us = reinterpret_cast<bf16*>(tc_smem);  // [kLMax][kLdX]
  bf16* Vs = Us + kLMax * kLdX;                 // [kLMax][kLdQ]
  float* ws = reinterpret_cast<float*>(Vs + kLMax * kLdQ);
  float* css = ws + kLMax;
  float* red = css + kLMax;
  const int q = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int bi = bh / d.h, hi = bh - bi * d.h, gi = hi / (d.h / d.g);
  const int t0 = c * d.L, rows = min(d.L, d.s - t0);
  const bool terms = kMode == 0 ? c < d.nc - 1 : c > 0;
  const int npieces = (d.L + kT - 1) / kT;
  const int64_t urow = static_cast<int64_t>(d.h) * d.p;
  const int64_t vrow = static_cast<int64_t>(d.g) * d.n;
  if (terms) {  // the pieces' copies go out first, one group each
    const bf16* ub = u + (static_cast<int64_t>(bi) * d.s + t0) * urow +
                     hi * d.p;
    const bf16* vb = v + (static_cast<int64_t>(bi) * d.s + t0) * vrow +
                     gi * d.n + q * kNq;
    for (int pc = 0; pc < npieces; ++pc) {
      const int r0 = pc * kT, n_rows = min(kT, rows - r0);
      load_async(Us + r0 * kLdX, kLdX, ub + r0 * urow, urow, n_rows, d.p,
                 kT, kPMax, u);
      load_async(Vs + r0 * kLdQ, kLdQ, vb + r0 * vrow, vrow, n_rows,
                 d.n - q * kNq, kT, kNq, v);
      cp_async_commit();
    }
  }
  if (kMode == 1 && blockIdx.x + blockIdx.y + blockIdx.z == 0)
    for (int i = threadIdx.x; i < d.h; i += kTcThreads) tickets[i] = 0;
  const float* dtb = dt + (static_cast<int64_t>(bi) * d.s + t0) * d.h + hi;
  const float2 dtv = chunk_scan(css, dtb, d.h, A[hi], rows, red);
  if (q == 0)
    for (int l = threadIdx.x; l < d.L; l += kTcThreads)
      cs[(static_cast<int64_t>(bh) * d.nc + c) * d.L + l] = css[l];
  if (!terms) {  // zero the slot no chunk writes: S[0], or dS[nc - 1]
    float* o = out + (static_cast<int64_t>(bh) * d.nc +
                      (kMode == 0 ? 0 : d.nc - 1)) * d.p * d.n;
    const int cols = min(kNq, d.n - q * kNq);
    for (int i = threadIdx.x; i < d.p * cols; i += kTcThreads)
      o[(i / cols) * d.n + q * kNq + i % cols] = 0.0f;
    return;
  }
  {
    const int l0 = 2 * threadIdx.x;
    if (kMode == 0) {
      ws[l0] = dtv.x * expf(css[d.L - 1] - css[l0]);
      ws[l0 + 1] = dtv.y * expf(css[d.L - 1] - css[l0 + 1]);
    } else {
      ws[l0] = l0 < rows ? expf(css[l0]) : 0.0f;
      ws[l0 + 1] = l0 + 1 < rows ? expf(css[l0 + 1]) : 0.0f;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = lane >> 2, t2 = 2 * (lane & 3), m0 = 16 * warp;
  float acc_h[4][4] = {}, acc_l[4][4] = {};
  for (int pc = 0; pc < npieces; ++pc) {
    cp_async_wait_n(npieces - 1 - pc);
    __syncthreads();  // piece pc (and ws) visible to every thread
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const int k0 = pc * kT + 16 * kk;
      uint32_t a[4], hi_a[4], lo_a[4];
      lda_t(a, Us, kLdX, m0, k0);  // u^T: rows p, columns (steps) k0..
      const float2 w0 = *reinterpret_cast<const float2*>(ws + k0 + t2);
      const float2 w8 = *reinterpret_cast<const float2*>(ws + k0 + t2 + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack(a[i]), w = i < 2 ? w0 : w8;
        split_pair(f.x * w.x, f.y * w.y, hi_a[i], lo_a[i]);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ldb_t(b, Vs, kLdQ, 16 * jp, k0);
        mma2(acc_h[2 * jp], acc_h[2 * jp + 1], hi_a, b);
        mma2(acc_l[2 * jp], acc_l[2 * jp + 1], lo_a, b);
      }
    }
  }
  const int slot = kMode == 0 ? c + 1 : c - 1;
  float* o = out + (static_cast<int64_t>(bh) * d.nc + slot) * d.p * d.n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nn = q * kNq + 8 * j + t2;
    if (nn >= d.n) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pp = m0 + g0 + 8 * r;
      if (pp < d.p)
        *reinterpret_cast<float2*>(o + pp * d.n + nn) =
            make_float2(acc_h[j][2 * r] + acc_l[j][2 * r],
                        acc_h[j][2 * r + 1] + acc_l[j][2 * r + 1]);
    }
  }
}

// Stage (c): in order, states[c] = exp(cs[L-1] of c - 1) states[c - 1] +
// states[c] (which holds chunk c - 1's own terms), from states[0] = 0.
// Needed for nc > 2 only: states[1] is chunk 0's terms.  grid (ceil(p n /
// 256), b h).
__global__ void __launch_bounds__(kThreads)
    ssd_pass_fwd(float* states, const float* cs, Dims d) {
  const int pn = d.p * d.n;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const int64_t bh = blockIdx.y;
  float* st = states + bh * d.nc * pn + e;
  const float* csb = cs + bh * d.nc * d.L;
  float S = 0.0f;
  for (int c = 1; c < d.nc; ++c) {
    S = __fadd_rn(__fmul_rn(expf(csb[c * d.L - 1]), S), st[c * pn]);
    st[c * pn] = S;
  }
}

// The backward's pass: in reverse, dS[c] = exp(cs[L-1] of c + 1) dS[c + 1]
// + dS[c] (which holds the terms chunk c + 1's y sends its start state),
// from dS[nc - 1] = 0; dsp[b, h, c, blockIdx.x] = this block's part of
// sum(dS[c] o S[c]), S the start states.  Needed for nc > 2 only: dS[0] is
// chunk 1's terms, and S[0] = 0 and dS[nc - 1] = 0 make every dsp 0.
// kPassPer values a thread.  grid (ceil(p n / (256 kPassPer)), b h).
constexpr int kPassPer = 8;

__global__ void __launch_bounds__(kThreads)
    ssd_pass_bwd(float* dS, const float* states, const float* cs, float* dsp,
                 Dims d) {
  __shared__ float red[32];
  const int pn = d.p * d.n;
  const int64_t bh = blockIdx.y;
  const int e0 = blockIdx.x * kThreads * kPassPer + threadIdx.x;
  float* D = dS + bh * d.nc * pn;
  const float* S = states + bh * d.nc * pn;
  const float* csb = cs + bh * d.nc * d.L;
  float v[kPassPer] = {};
  for (int c = d.nc - 1; c >= 0; --c) {
    const float E = c < d.nc - 1 ? expf(csb[(c + 2) * d.L - 1]) : 0.0f;
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      const int e = e0 + k * kThreads;
      if (e < pn) {
        if (c < d.nc - 1) {
          v[k] = __fadd_rn(__fmul_rn(E, v[k]), D[c * pn + e]);
          D[c * pn + e] = v[k];
        }
        part += v[k] * S[c * pn + e];
      }
    }
    part = block_sum(part, red);
    if (threadIdx.x == 0) dsp[(bh * d.nc + c) * gridDim.x + blockIdx.x] = part;
  }
}

// Stages (a) and (d): y of one 64-row tile (rows l0 .. l0 + 63) of one
// chunk and head.  Warp w owns rows l0 + 16 w ..; C's A fragments stay in
// registers.  y_off first (C times the start state's pair, then exp(cs[l])
// per row), then for each column tile s0 <= l0, two halves of 32 columns:
// G = C B^T in registers, W = G o exp(cs[l] - cs[s]) o dt[s] masked s <= l,
// and y += W x with W as the A operand, a pair.  B and x tiles come through
// a two-stage ring.  grid (ceil(L / 64), nc, b h).
constexpr int kFwdTcSmem = 2 * kLMax * 4 + kT * kLdB * 2 + 2 * kStage * 2;
static_assert(2 * kStage >= 2 * kPMax * kLdB, "the ring holds a state pair");

__global__ void __launch_bounds__(kTcThreads)
    ssd_fwd_y_tc(const bf16* x, const float* dt, const bf16* B, const bf16* C,
                 const float* cs, const float* states, bf16* y, Dims d) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* css = reinterpret_cast<float*>(tc_smem);
  float* dts = css + kLMax;
  bf16* Cs = reinterpret_cast<bf16*>(dts + kLMax);  // [kT][kLdB]
  bf16* U = Cs + kT * kLdB;  // a state pair, then the ring [2][kStage]
  const int ti = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int bi = bh / d.h, hi = bh - bi * d.h, gi = hi / (d.h / d.g);
  const int t0 = c * d.L, l0 = ti * kT;
  const int valid = min(d.L, d.s - t0);  // steps of the chunk in the sequence
  const int rows = min(kT, valid - l0);
  if (rows <= 0) return;
  const int64_t xrow = static_cast<int64_t>(d.h) * d.p;
  const int64_t brow = static_cast<int64_t>(d.g) * d.n;
  const bf16* xb = x + (static_cast<int64_t>(bi) * d.s + t0) * xrow + hi * d.p;
  const bf16* Bb = B + (static_cast<int64_t>(bi) * d.s + t0) * brow + gi * d.n;
  const bf16* Cb = C + (static_cast<int64_t>(bi) * d.s + t0) * brow + gi * d.n;

  load_async(Cs, kLdB, Cb + l0 * brow, brow, rows, d.n, kT, kNMax, C);
  cp_async_commit();
  chunk_vectors(css, dts, cs, dt, bi, hi, c, d);
  if (c > 0)
    split_state(U, states + (static_cast<int64_t>(bh) * d.nc + c) * d.p * d.n,
                d);
  cp_async_wait0();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = lane >> 2, t2 = 2 * (lane & 3), m0 = 16 * warp;
  const int r0 = l0 + m0 + g0, r1 = r0 + 8;  // the thread's rows
  uint32_t ca[kNMax / 16][4];
#pragma unroll
  for (int kk = 0; kk < kNMax / 16; ++kk) lda(ca[kk], Cs, kLdB, m0, 16 * kk);
  float acc[kPMax / 8][4] = {};  // y: rows r0, r1; columns p
  if (c > 0) {  // exp(cs[l]) C[l] S^T
#pragma unroll
    for (int kk = 0; kk < kNMax / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < kPMax / 16; ++jp)
        mma_state<false>(acc[2 * jp], acc[2 * jp + 1], ca[kk], U, 16 * jp,
                         16 * kk);
    const float e0 = expf(css[r0]), e1 = expf(css[r1]);
#pragma unroll
    for (int j = 0; j < kPMax / 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }
  __syncthreads();  // the state pair's memory becomes the ring

  auto stage_load = [&](int tj, int st) {
    const int s0 = tj * kT, n_rows = min(kT, valid - s0);
    bf16* Bs = U + st * kStage;
    load_async(Bs, kLdB, Bb + s0 * brow, brow, n_rows, d.n, kT, kNMax, B);
    load_async(Bs + kT * kLdB, kLdX, xb + s0 * xrow, xrow, n_rows, d.p, kT,
               kPMax, x);
    cp_async_commit();
  };
  stage_load(0, 0);
  for (int tj = 0; tj <= ti; ++tj) {
    const int st = tj & 1;
    if (tj < ti) {
      stage_load(tj + 1, st ^ 1);
      cp_async_wait1();
    } else {
      cp_async_wait0();
    }
    __syncthreads();
    const bf16* Bs = U + st * kStage;
    const bf16* Xs = Bs + kT * kLdB;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = tj * kT + 32 * hh;  // first column of the half
      if (c0 > l0 + m0 + 15 || c0 >= valid) continue;  // the warp's rows
      float g[4][4] = {};                               // see no column
#pragma unroll
      for (int kk = 0; kk < kNMax / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldb(b, Bs, kLdB, 32 * hh + 16 * jp, 16 * kk);
          mma2(g[2 * jp], g[2 * jp + 1], ca[kk], b);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = e < 2 ? r0 : r1, s = c0 + 8 * j + t2 + (e & 1);
          g[j][e] = s <= l ? g[j][e] * expf(css[l] - css[s]) * dts[s] : 0.0f;
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ahi[4], alo[4];
        acc_to_a(g[2 * kk], g[2 * kk + 1], ahi, alo);
#pragma unroll
        for (int jp = 0; jp < kPMax / 16; ++jp) {
          uint32_t b[4];
          ldb_t(b, Xs, kLdX, 16 * jp, 32 * hh + 16 * kk);
          mma2_pair(acc[2 * jp], acc[2 * jp + 1], ahi, alo, b);
        }
      }
    }
    __syncthreads();  // stage st is free for the next refill
  }

  bf16* yb = y + (static_cast<int64_t>(bi) * d.s + t0) * xrow + hi * d.p;
#pragma unroll
  for (int j = 0; j < kPMax / 8; ++j) {
    const int pc = 8 * j + t2;
    if (pc >= d.p) continue;
    if (r0 - l0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(yb + r0 * xrow + pc) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r1 - l0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(yb + r1 * xrow + pc) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// A head's (64 x n) gradient tile, rows 16 w + (g0, g0 + 8) of warp w,
// summed over the heads of the cluster (a group) in head order and written
// in bf16: rows [0, rows) of out (row stride `stride`).  CTA `rank` sums
// rows rank, rank + size, ... from every CTA's shared memory.
__device__ void group_sum(const float (&acc)[kNMax / 8][4], float* red,
                          bf16* out, int64_t stride, int rows, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2), t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kNMax / 8; ++j) {
    *reinterpret_cast<float2*>(red + row * kLdR + 8 * j + t2) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(red + (row + 8) * kLdR + 8 * j + t2) =
        make_float2(acc[j][2], acc[j][3]);
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int rank = static_cast<int>(cl.block_rank());
  const int size = static_cast<int>(cl.num_blocks());
  const int per_row = n / 4;
  const int mine = rows > rank ? (rows - rank + size - 1) / size : 0;
  for (int i = threadIdx.x; i < mine * per_row; i += blockDim.x) {
    const int k = i / per_row, c4 = 4 * (i - k * per_row);
    const int r = rank + size * k;
    float4 v[kMaxRep];
#pragma unroll
    for (int q = 0; q < kMaxRep; ++q)
      if (q < size)
        v[q] = *reinterpret_cast<const float4*>(
            cl.map_shared_rank(red + r * kLdR + c4, q));
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxRep; ++q)
      if (q < size) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out + r * stride + c4);
    o[0] = __floats2bfloat162_rn(s.x, s.y);
    o[1] = __floats2bfloat162_rn(s.z, s.w);
  }
  cl.sync();  // no CTA leaves while another reads its shared memory
}

// The backward of one chunk, per 64-row tile and head; blockIdx.y = 2 c +
// role.  Role 0, the tile's steps as columns s: dx, ddx, u and the column
// sums of Q = dW o W, and dB.  Role 1, the tile's steps as rows l: the row
// sums of Q, the y_off term of dcs, and dC.  dB and dC are summed over the
// group's heads, which form the cluster (1, 1, h / g).  Per pair of tiles
// both roles form G and dy x^T in registers (16 rows x 32 columns a warp),
// the decay, W, dW, dG and Q there, and feed W or dG to the next product as
// the A operand, a pair; the other tile's rows come through a two-stage
// ring.  grid (ceil(L / 64), 2 nc, b h).
constexpr int kBwdTcSmem =
    2 * kLMax * 4 + kT * (kLdB + kLdX) * 2 + 2 * kStage * 2;
static_assert(2 * kStage * 2 >= kT * kLdR * 4, "the ring holds a group sum");

__global__ void __launch_bounds__(kTcThreads)
    ssd_bwd_chunk_tc(const bf16* dy, const bf16* x, const float* dt,
                     const bf16* B, const bf16* C, const float* cs,
                     const float* states, const float* dS, bf16* dx,
                     bf16* dB, bf16* dC, float* rq, float* cq, float* uu,
                     float* ddx, Dims d) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* css = reinterpret_cast<float*>(tc_smem);
  float* dts = css + kLMax;
  bf16* P0 = reinterpret_cast<bf16*>(dts + kLMax);  // [kT][kLdB] B or C
  bf16* P1 = P0 + kT * kLdB;                        // [kT][kLdX] x or dy
  bf16* U = P1 + kT * kLdX;  // a state pair, the ring, then a group sum
  const int ti = blockIdx.x, c = blockIdx.y >> 1, role = blockIdx.y & 1;
  const int bh = blockIdx.z;
  const int bi = bh / d.h, hi = bh - bi * d.h, gi = hi / (d.h / d.g);
  const int t0 = c * d.L, f0 = ti * kT;
  const int valid = min(d.L, d.s - t0);
  const int rows = min(kT, valid - f0);
  if (rows <= 0) return;  // so does every head of the cluster
  const int64_t xrow = static_cast<int64_t>(d.h) * d.p;
  const int64_t brow = static_cast<int64_t>(d.g) * d.n;
  const int64_t xoff = (static_cast<int64_t>(bi) * d.s + t0) * xrow + hi * d.p;
  const int64_t boff = (static_cast<int64_t>(bi) * d.s + t0) * brow + gi * d.n;
  // own tile: role 0 B and x, role 1 C and dy; the ring: the other two
  const bf16* own_g = role == 0 ? B : C;
  const bf16* own_h = role == 0 ? x : dy;
  const bf16* ring_g = role == 0 ? C : B;
  const bf16* ring_h = role == 0 ? dy : x;
  load_async(P0, kLdB, own_g + boff + f0 * brow, brow, rows, d.n, kT, kNMax,
             own_g);
  load_async(P1, kLdX, own_h + xoff + f0 * xrow, xrow, rows, d.p, kT, kPMax,
             own_h);
  cp_async_commit();
  chunk_vectors(css, dts, cs, dt, bi, hi, c, d);
  const bool with_state = role == 0 ? c < d.nc - 1 : c > 0;
  if (with_state)  // role 0: dS of this chunk; role 1: its start state
    split_state(U, (role == 0 ? dS : states) +
                       (static_cast<int64_t>(bh) * d.nc + c) * d.p * d.n,
                d);
  cp_async_wait0();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = lane >> 2, t2 = 2 * (lane & 3), m0 = 16 * warp;
  const int r0 = f0 + m0 + g0, r1 = r0 + 8;  // the thread's rows
  float acc[kNMax / 8][4] = {};  // role 0: dB; role 1: dC (rows r0, r1)
  float adx[kPMax / 8][4] = {};  // role 0: dx dt^-1
  float q0 = 0.0f, q1 = 0.0f;    // per row: the sums of dcs's terms
  float u0 = 0.0f, u1 = 0.0f;    // role 0: u
  if (with_state && role == 0) {
    // adx = dec B[s] dS^T (K = n); u = dt sum_p x adx
#pragma unroll
    for (int kk = 0; kk < kNMax / 16; ++kk) {
      uint32_t a[4];
      lda(a, P0, kLdB, m0, 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kPMax / 16; ++jp)
        mma_state<false>(adx[2 * jp], adx[2 * jp + 1], a, U, 16 * jp,
                         16 * kk);
    }
    const float e0 = expf(css[d.L - 1] - css[r0]);
    const float e1 = expf(css[d.L - 1] - css[r1]);
#pragma unroll
    for (int j = 0; j < kPMax / 8; ++j) {
      const float2 xa = unpack(*reinterpret_cast<const uint32_t*>(
          P1 + (m0 + g0) * kLdX + 8 * j + t2));
      const float2 xb = unpack(*reinterpret_cast<const uint32_t*>(
          P1 + (m0 + g0 + 8) * kLdX + 8 * j + t2));
      adx[j][0] *= e0;
      adx[j][1] *= e0;
      adx[j][2] *= e1;
      adx[j][3] *= e1;
      u0 += xa.x * adx[j][0] + xa.y * adx[j][1];
      u1 += xb.x * adx[j][2] + xb.y * adx[j][3];
    }
    // dB = dec dt (x[s] dS) (K = p)
#pragma unroll
    for (int kk = 0; kk < kPMax / 16; ++kk) {
      uint32_t a[4];
      lda(a, P1, kLdX, m0, 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kNMax / 16; ++jp)
        mma_state<true>(acc[2 * jp], acc[2 * jp + 1], a, U, 16 * jp,
                        16 * kk);
    }
    const float f0s = e0 * dts[r0], f1s = e1 * dts[r1];
#pragma unroll
    for (int j = 0; j < kNMax / 8; ++j) {
      acc[j][0] *= f0s;
      acc[j][1] *= f0s;
      acc[j][2] *= f1s;
      acc[j][3] *= f1s;
    }
  } else if (with_state) {
    // dC = exp(cs[l]) dy[l] S (K = p); the y_off term of dcs,
    // exp(cs[l]) sum_n C[l, n] (dy S)[l, n]
#pragma unroll
    for (int kk = 0; kk < kPMax / 16; ++kk) {
      uint32_t a[4];
      lda(a, P1, kLdX, m0, 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kNMax / 16; ++jp)
        mma_state<true>(acc[2 * jp], acc[2 * jp + 1], a, U, 16 * jp,
                        16 * kk);
    }
    const float e0 = expf(css[r0]), e1 = expf(css[r1]);
    float o0 = 0.0f, o1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kNMax / 8; ++j) {
      const float2 ca = unpack(*reinterpret_cast<const uint32_t*>(
          P0 + (m0 + g0) * kLdB + 8 * j + t2));
      const float2 cb = unpack(*reinterpret_cast<const uint32_t*>(
          P0 + (m0 + g0 + 8) * kLdB + 8 * j + t2));
      o0 += ca.x * acc[j][0] + ca.y * acc[j][1];
      o1 += cb.x * acc[j][2] + cb.y * acc[j][3];
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
    q0 = e0 * o0;
    q1 = e1 * o1;
  }
  __syncthreads();  // the state pair's memory becomes the ring

  // A fragments of the own tile's x (role 0) or dy (role 1), K = p
  uint32_t ha[kPMax / 16][4];
#pragma unroll
  for (int kk = 0; kk < kPMax / 16; ++kk) lda(ha[kk], P1, kLdX, m0, 16 * kk);
  // role 0: the l-tiles ti .. of the sequence; role 1: the s-tiles 0 .. ti
  const int first = role == 0 ? ti : 0;
  const int last = role == 0 ? (valid + kT - 1) / kT - 1 : ti;
  auto stage_load = [&](int tt, int st) {
    const int o0 = tt * kT, n_rows = min(kT, valid - o0);
    bf16* Rs = U + st * kStage;
    load_async(Rs, kLdB, ring_g + boff + o0 * brow, brow, n_rows, d.n, kT,
               kNMax, ring_g);
    load_async(Rs + kT * kLdB, kLdX, ring_h + xoff + o0 * xrow, xrow, n_rows,
               d.p, kT, kPMax, ring_h);
    cp_async_commit();
  };
  stage_load(first, 0);
  for (int tt = first; tt <= last; ++tt) {
    const int st = (tt - first) & 1;
    if (tt < last) {
      stage_load(tt + 1, st ^ 1);
      cp_async_wait1();
    } else {
      cp_async_wait0();
    }
    __syncthreads();
    const bf16* Rg = U + st * kStage;  // C (role 0) or B (role 1) rows
    const bf16* Rh = Rg + kT * kLdB;   // dy (role 0) or x (role 1) rows
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c0 = tt * kT + 32 * hh;  // first column of the half
      // skip a half that is past the sequence or, for the warp's rows,
      // wholly masked (role 0: l < s; role 1: s > l)
      if (c0 >= valid ||
          (role == 0 ? c0 + 31 < f0 + m0 : c0 > f0 + m0 + 15))
        continue;
      float gq[4][4] = {}, wq[4][4] = {};  // G and (own . ring)^T over p
#pragma unroll
      for (int kk = 0; kk < kNMax / 16; ++kk) {
        uint32_t a[4];
        lda(a, P0, kLdB, m0, 16 * kk);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldb(b, Rg, kLdB, 32 * hh + 16 * jp, 16 * kk);
          mma2(gq[2 * jp], gq[2 * jp + 1], a, b);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kPMax / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldb(b, Rh, kLdX, 32 * hh + 16 * jp, 16 * kk);
          mma2(wq[2 * jp], wq[2 * jp + 1], ha[kk], b);
        }
      // l, s of each element: role 0 rows s, columns l; role 1 the other
      // way.  W = G exp(cs[l] - cs[s]) (s <= l), dW = (dy . x) dt[s],
      // dG = dW exp(cs[l] - cs[s]), Q = dW W.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e < 2 ? r0 : r1, cc = c0 + 8 * j + t2 + (e & 1);
          const int l = role == 0 ? cc : rr, s = role == 0 ? rr : cc;
          const float lm = s <= l ? expf(css[l] - css[s]) : 0.0f;
          const float Wv = gq[j][e] * lm, dWv = wq[j][e] * dts[s];
          if (e < 2)
            q0 += dWv * Wv;
          else
            q1 += dWv * Wv;
          gq[j][e] = Wv;
          wq[j][e] = dWv * lm;
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ahi[4], alo[4];
        if (role == 0) {  // dx dt^-1 += W^T dy (K = l)
          acc_to_a(gq[2 * kk], gq[2 * kk + 1], ahi, alo);
#pragma unroll
          for (int jp = 0; jp < kPMax / 16; ++jp) {
            uint32_t b[4];
            ldb_t(b, Rh, kLdX, 16 * jp, 32 * hh + 16 * kk);
            mma2_pair(adx[2 * jp], adx[2 * jp + 1], ahi, alo, b);
          }
        }
        // role 0: dB += dG^T C (K = l); role 1: dC += dG B (K = s)
        acc_to_a(wq[2 * kk], wq[2 * kk + 1], ahi, alo);
#pragma unroll
        for (int jp = 0; jp < kNMax / 16; ++jp) {
          uint32_t b[4];
          ldb_t(b, Rg, kLdB, 16 * jp, 32 * hh + 16 * kk);
          mma2_pair(acc[2 * jp], acc[2 * jp + 1], ahi, alo, b);
        }
      }
    }
    __syncthreads();  // stage st is free for the next refill
  }

  // per-step terms of dcs: role 0 cq = -(column sums of Q) - u, uu = u,
  // ddx = sum_p dxdt x; role 1 rq = row sums of Q + the y_off term
  q0 = quad_sum(q0);
  q1 = quad_sum(q1);
  const int64_t sbase = (static_cast<int64_t>(bh) * d.nc + c) * d.L;
  if (role == 0) {
    u0 = quad_sum(u0) * dts[r0];
    u1 = quad_sum(u1) * dts[r1];
    float dd0 = 0.0f, dd1 = 0.0f;
    bf16* dxb = dx + xoff;
#pragma unroll
    for (int j = 0; j < kPMax / 8; ++j) {
      const int pc = 8 * j + t2;
      const float2 xa = unpack(*reinterpret_cast<const uint32_t*>(
          P1 + (m0 + g0) * kLdX + pc));
      const float2 xb = unpack(*reinterpret_cast<const uint32_t*>(
          P1 + (m0 + g0 + 8) * kLdX + pc));
      dd0 += adx[j][0] * xa.x + adx[j][1] * xa.y;
      dd1 += adx[j][2] * xb.x + adx[j][3] * xb.y;
      if (pc >= d.p) continue;
      if (r0 - f0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(dxb + r0 * xrow + pc) =
            __floats2bfloat162_rn(__fmul_rn(adx[j][0], dts[r0]),
                                  __fmul_rn(adx[j][1], dts[r0]));
      if (r1 - f0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(dxb + r1 * xrow + pc) =
            __floats2bfloat162_rn(__fmul_rn(adx[j][2], dts[r1]),
                                  __fmul_rn(adx[j][3], dts[r1]));
    }
    dd0 = quad_sum(dd0);
    dd1 = quad_sum(dd1);
    if ((lane & 3) == 0) {
      if (r0 - f0 < rows) {
        cq[sbase + r0] = -q0 - u0;
        uu[sbase + r0] = u0;
        ddx[sbase + r0] = dd0;
      }
      if (r1 - f0 < rows) {
        cq[sbase + r1] = -q1 - u1;
        uu[sbase + r1] = u1;
        ddx[sbase + r1] = dd1;
      }
    }
  } else if ((lane & 3) == 0) {
    if (r0 - f0 < rows) rq[sbase + r0] = q0;
    if (r1 - f0 < rows) rq[sbase + r1] = q1;
  }
  bf16* out = (role == 0 ? dB : dC) + boff + f0 * brow;
  group_sum(acc, reinterpret_cast<float*>(U), out, brow, rows, d.n);
}

// ddt and dA from the per-step terms of dcs, one block per (chunk, b, h):
// dcs = rq + cq (+ exp(cs[L-1]) sum(dS o S) + sum u at L - 1), d(dt A) its
// reverse cumsum; ddt = d(dt A) A + ddx, and the block's part of dA, sum
// d(dt A) dt, goes to dA_part.  The last block of a head to finish (a
// ticket, an integer atomic) sums the head's parts in (b, chunk) order, so
// dA does not depend on the order blocks run in.  grid (nc, b h), 256
// threads.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcs(const float* dt, const float* A, const float* cs,
                const float* rq, const float* cq, const float* uu,
                const float* ddx, const float* dsp, int nsp, float* ddt,
                float* dA_part, int* tickets, float* dA, Dims d) {
  __shared__ float red[32];
  __shared__ float buf[kLMax];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int bi = bh / d.h, hi = bh - bi * d.h, l = threadIdx.x;
  const int64_t bhc = static_cast<int64_t>(bh) * d.nc + c;
  const int t0 = c * d.L;
  const bool ok = l < d.L && t0 + l < d.s;
  const int64_t at = bhc * d.L + l;
  float v = ok ? rq[at] + cq[at] : 0.0f;
  const float ut = block_sum(ok ? uu[at] : 0.0f, red);
  if (l == d.L - 1) {
    float sp = 0.0f;
    for (int k = 0; k < nsp; ++k) sp += dsp[bhc * nsp + k];
    v += expf(cs[bhc * d.L + d.L - 1]) * sp + ut;
  }
  if (l < d.L) buf[l] = v;
  __syncthreads();
  const int idx = d.L - 1 - l;  // the reversed chunk's step
  const float sfx = block_scan(l < d.L ? buf[idx] : 0.0f, red);
  float term = 0.0f;
  if (l < d.L && t0 + idx < d.s) {
    const int64_t t = (static_cast<int64_t>(bi) * d.s + t0 + idx) * d.h + hi;
    ddt[t] = fmaf(sfx, A[hi], ddx[bhc * d.L + idx]);
    term = sfx * dt[t];
  }
  const float part = block_sum(term, red);
  if (l == 0) {
    dA_part[bhc] = part;
    __threadfence();
    if (atomicAdd(tickets + hi, 1) == d.b * d.nc - 1) {  // the head's last
      float s = 0.0f;
      for (int bb = 0; bb < d.b; ++bb)
        for (int cc = 0; cc < d.nc; ++cc)
          s += __ldcg(dA_part + (static_cast<int64_t>(bb) * d.h + hi) * d.nc +
                      cc);
      dA[hi] = s;
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

// What a call runs, by dtype and shape: the tensor-core kernels for bf16
// with p and n multiples of 8 (16-byte rows for cp.async) and at most
// kMaxRep heads a group (the cluster), else the SIMT kernels.
struct Plan {
  bool tc;
  int launches;
  int64_t scratch;  // f32 values
  // offsets into the scratch (tensor-core kernels): cs; the backward's dS,
  // dsp, the four per-step terms, dA_part and the tickets
  int64_t dS, dsp, terms, dA_part, tickets;
  int nsp;  // blocks a (b, h) of the backward's pass
};

Plan make_plan(int dtype, const Dims& d, bool backward) {
  Plan pl{};
  pl.tc = dtype == kBFloat16 && d.p % 8 == 0 && d.n % 8 == 0 &&
          d.h / d.g <= kMaxRep;
  const int64_t bh = static_cast<int64_t>(d.b) * d.h;
  const int64_t steps = bh * d.nc * d.L;  // one f32 a (b, h, chunk, step)
  if (!pl.tc) {
    pl.launches = backward ? 2 : 1;
    pl.scratch = backward ? 2 * static_cast<int64_t>(d.b) * d.s * d.h * d.n +
                                bh
                          : 0;
    return pl;
  }
  const bool pass = d.nc > 2;  // else the chunk-state kernel did its work
  pl.nsp = pass ? (d.p * d.n + kThreads * kPassPer - 1) /
                      (kThreads * kPassPer)
                : 0;
  pl.dS = steps;
  pl.dsp = pl.dS + bh * d.nc * d.p * d.n;
  pl.terms = pl.dsp + bh * d.nc * pl.nsp;  // rq, cq, uu, ddx
  pl.dA_part = pl.terms + 4 * steps;
  pl.tickets = pl.dA_part + bh * d.nc;
  pl.launches = (backward ? 3 : 2) + pass;
  pl.scratch = backward ? pl.tickets + d.h : steps;
  return pl;
}

template <typename T>
cudaError_t fwd_simt(const void* x, const float* dt, const float* A,
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
cudaError_t bwd_simt(const void* dy, const void* x, const float* dt,
                     const float* A, const void* B, const void* C,
                     const float* states, void* dx, float* ddt, float* dA,
                     void* dB, void* dC, float* scratch, const Dims& d,
                     cudaStream_t stream) {
  const int64_t per_head = static_cast<int64_t>(d.b) * d.s * d.h * d.n;
  float* dBh = scratch;
  float* dCh = dBh + per_head;
  float* dA_part = dCh + per_head;
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

template <int kMode>
cudaError_t chunk_states(const bf16* u, const bf16* v, const float* dt,
                         const float* A, float* cs, float* out, int* tickets,
                         const Dims& d, cudaStream_t stream) {
  cudaError_t err = allow_smem(ssd_chunk_state_tc<kMode>, kStateSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.n + kNq - 1) / kNq, d.nc, d.b * d.h);
  ssd_chunk_state_tc<kMode><<<grid, kTcThreads, kStateSmem, stream>>>(
      u, v, dt, A, cs, out, tickets, d);
  return cudaGetLastError();
}

cudaError_t fwd_tc(const bf16* x, const float* dt, const float* A,
                   const bf16* B, const bf16* C, bf16* y, float* states,
                   float* cs, const Dims& d, cudaStream_t stream) {
  cudaError_t err =
      chunk_states<0>(x, B, dt, A, cs, states, nullptr, d, stream);
  if (err != cudaSuccess) return err;
  if (d.nc > 2) {
    const int pn_blocks = (d.p * d.n + kThreads - 1) / kThreads;
    ssd_pass_fwd<<<dim3(pn_blocks, d.b * d.h), kThreads, 0, stream>>>(
        states, cs, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = allow_smem(ssd_fwd_y_tc, kFwdTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((d.L + kT - 1) / kT, d.nc, d.b * d.h);
  ssd_fwd_y_tc<<<grid, kTcThreads, kFwdTcSmem, stream>>>(x, dt, B, C, cs,
                                                         states, y, d);
  return cudaGetLastError();
}

cudaError_t bwd_tc(const bf16* dy, const bf16* x, const float* dt,
                   const float* A, const bf16* B, const bf16* C,
                   const float* states, bf16* dx, float* ddt, float* dA,
                   bf16* dB, bf16* dC, float* scratch, const Plan& pl,
                   const Dims& d, cudaStream_t stream) {
  float* cs = scratch;
  float* dS = scratch + pl.dS;
  float* dsp = scratch + pl.dsp;
  const int64_t steps = static_cast<int64_t>(d.b) * d.h * d.nc * d.L;
  float* rq = scratch + pl.terms;
  float* cq = rq + steps;
  float* uu = cq + steps;
  float* ddx = uu + steps;
  float* dA_part = scratch + pl.dA_part;
  int* tickets = reinterpret_cast<int*>(scratch + pl.tickets);
  cudaError_t err =
      chunk_states<1>(dy, C, dt, A, cs, dS, tickets, d, stream);
  if (err != cudaSuccess) return err;
  if (pl.nsp > 0) {
    ssd_pass_bwd<<<dim3(pl.nsp, d.b * d.h), kThreads, 0, stream>>>(
        dS, states, cs, dsp, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = allow_smem(ssd_bwd_chunk_tc, kBwdTcSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d.L + kT - 1) / kT, 2 * d.nc, d.b * d.h);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = kBwdTcSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = d.h / d.g;  // the heads of a group
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_tc, dy, x, dt, B, C,
                           static_cast<const float*>(cs), states,
                           static_cast<const float*>(dS), dx, dB, dC, rq, cq,
                           uu, ddx, d);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dcs<<<dim3(d.nc, d.b * d.h), kThreads, 0, stream>>>(
      dt, A, cs, rq, cq, uu, ddx, dsp, pl.nsp, ddt, dA_part, tickets, dA, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// The route, kernel launches and f32 scratch of a forward (backward 0) or
// backward (1) call: out[0] = 1 for the tensor-core kernels, 0 for the
// SIMT kernels; out[1] launches; out[2] scratch values.
extern "C" int repro_ssd_plan(int dtype, int b, int s, int h, int p, int g,
                              int n, int chunk, int backward,
                              long long* out) {
  using namespace repro;
  if (bad_dims(b, s, h, p, g, n, chunk) ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const Plan pl = make_plan(dtype, make_dims(b, s, h, p, g, n, chunk),
                            backward != 0);
  out[0] = pl.tc;
  out[1] = pl.launches;
  out[2] = pl.scratch;
  return cudaSuccess;
}

// x (b, s, h, p), B/C (b, s, g, n) and y of one type (dtype 0: f32, 1:
// bf16); dt (b, s, h) and A (h,) f32; states (b, h, nc, p, n) f32 with nc =
// ceil(s / chunk); scratch: scratch_len f32 values (repro_ssd_plan's).  All
// contiguous, 16-byte aligned.  p <= 64, n <= 128, chunk <= 256, g divides
// h.  Returns a cudaError_t (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, void* y,
                             void* states, void* scratch,
                             long long scratch_len, int dtype, int b, int s,
                             int h, int p, int g, int n, int chunk,
                             void* stream) {
  using namespace repro;
  if (bad_dims(b, s, h, p, g, n, chunk)) return cudaErrorInvalidValue;
  const Dims d = make_dims(b, s, h, p, g, n, chunk);
  const Plan pl = make_plan(dtype, d, false);
  if (scratch_len < pl.scratch) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* sf = static_cast<float*>(states);
  if (pl.tc)
    return fwd_tc(static_cast<const bf16*>(x), dtf, Af,
                  static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                  static_cast<bf16*>(y), sf, static_cast<float*>(scratch), d,
                  st);
  if (dtype == kFloat32)
    return fwd_simt<float>(x, dtf, Af, B, C, y, sf, d, st);
  if (dtype == kBFloat16)
    return fwd_simt<__nv_bfloat16>(x, dtf, Af, B, C, y, sf, d, st);
  return cudaErrorInvalidValue;
}

// dy, dx like x; ddt like dt; dA like A; dB, dC like B; states as the
// forward wrote them; scratch as repro_ssd_plan gives it for the backward.
extern "C" int repro_ssd_bwd(const void* dy, const void* x, const void* dt,
                             const void* A, const void* B, const void* C,
                             const void* states, void* dx, void* ddt,
                             void* dA, void* dB, void* dC, void* scratch,
                             long long scratch_len, int dtype, int b, int s,
                             int h, int p, int g, int n, int chunk,
                             void* stream) {
  using namespace repro;
  if (bad_dims(b, s, h, p, g, n, chunk)) return cudaErrorInvalidValue;
  const Dims d = make_dims(b, s, h, p, g, n, chunk);
  const Plan pl = make_plan(dtype, d, true);
  if (scratch_len < pl.scratch) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* sf = static_cast<const float*>(states);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA);
  float* scr = static_cast<float*>(scratch);
  if (pl.tc)
    return bwd_tc(static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
                  dtf, Af, static_cast<const bf16*>(B),
                  static_cast<const bf16*>(C), sf, static_cast<bf16*>(dx),
                  ddtf, dAf, static_cast<bf16*>(dB), static_cast<bf16*>(dC),
                  scr, pl, d, st);
  if (dtype == kFloat32)
    return bwd_simt<float>(dy, x, dtf, Af, B, C, sf, dx, ddtf, dAf, dB, dC,
                           scr, d, st);
  if (dtype == kBFloat16)
    return bwd_simt<__nv_bfloat16>(dy, x, dtf, Af, B, C, sf, dx, ddtf, dAf,
                                   dB, dC, scr, d, st);
  return cudaErrorInvalidValue;
}

