// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// No TPU kernel to replace: the JAX package's attention is forward only
// (repro/kernels/flash_attention.py:flash_attention_pallas), and jax.grad
// through it fails, so the training path of the reference differentiates
// its jnp route (ref.flash_attention_jnp).  These kernels are held to
// jax.grad of that route (tests/test_torch_attention_bwd.py through the
// plain version, chip_smoke.py phase 14 on the card).
//
// The function: q (B, Sq, H, Dh), k and v (B, Skv, KH, Dh) with GQA (query
// head h reads KV head h / G, G = H / KH), a causal mask and an optional
// sliding window (query offset 0), out and dout (B, Sq, H, Dh), and lse
// (B, H, Sq) f32, the forward's row log-sum-exp in natural-log units
// (flash_attention.cu writes it).  With S = scale Q K^T and P = exp(S -
// lse) on the live (query, key) pairs:
//   D = rowsum(dO o O),  dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the G query heads of a KV head.  Any Sq and Skv:
// rows past the sequence ends load as zeros and are masked.
//
// What bounds it: five products of Sq x Skv x Dh per (b, head), halved by
// a causal mask.  At smollm-135M's layer (B 2, S 2048, 9 heads of 64, 3
// KV heads, bf16, causal) that is 24.2 GFLOP, 0.0245 ms at 989 TFLOP/s,
// against about 25 MB of inputs and outputs (0.0075 ms at 3.35 TB/s): the
// operations.  The design is the simple deterministic one, with no
// atomics, so a gradient has the same bits from run to run; three
// launches a call:
//   flash_bwd_prep   D = rowsum(dO o O) in f32, a warp a row;
//   flash_bwd_dkdv   a CTA per (b, KV head, 64-key block) walks the G
//                    query heads of its group and the live 64-row query
//                    blocks (from the causal diagonal to the window's
//                    edge), recomputes S^T and P^T, adds P^T dO into dV,
//                    computes dP^T and dS^T, adds dS^T Q into dK; dK and
//                    dV stay in registers across the group, so the GQA sum
//                    needs no second pass; dK is scaled once at the store;
//   flash_bwd_dq     a CTA per (b, head, 64-row query block) walks the live
//                    key blocks, recomputes P and dS, adds dS K into dQ.
// S and P are recomputed in both passes.  Still to come: wgmma and a TMA
// ring as flash_fwd_tc has, and K/V (or Q/dO) tiles double-buffered.
//
// Two routes, chosen by the element type:
//   bf16: every product on the tensor cores, mma.sync m16n8k16 through
//     mma.cuh (tiles staged by cp.async, rows padded by 16 bytes so the
//     ldmatrix rows hit distinct banks); each of 4 warps owns 16 rows of
//     the CTA's 64 (keys in dkdv, queries in dq).  P and dS are rounded to
//     bf16 as the A operands of the second products, as flash_fwd_tc rounds
//     P before P V (flash_attention.cu); the reference differentiates in
//     f32, so chip_smoke.py holds this route to the plain version at bf16
//     2e-2 of each gradient's largest entry.
//   f32: exact SIMT kernels on the f32 pipes (TF32 would miss 2e-5), as
//     flash_fwd_simt: 256 threads in a 16 x 16 grid over 32 x 32 tiles,
//     the tiles staged in shared memory as f32 with rows padded by a word.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

constexpr float kLog2eBwd = 1.4426950408889634f;

__device__ __forceinline__ bool pair_live(int i, int j, int Sq, int Skv,
                                          int causal, int window) {
  return i < Sq && j < Skv && (!causal || j <= i) &&
         (!window || j > i - window);
}

// The live query rows of keys [k0, k0 + nk): [lo, hi] (empty if lo > hi).
__device__ __forceinline__ void live_rows(int k0, int nk, int Sq, int causal,
                                          int window, int& lo, int& hi) {
  lo = causal ? k0 : 0;
  hi = Sq - 1;
  if (window) hi = min(hi, k0 + nk - 1 + window - 1);
}

// The live keys of query rows [q0, q0 + nq): [lo, hi] (empty if lo > hi).
__device__ __forceinline__ void live_keys(int q0, int nq, int Skv, int causal,
                                          int window, int& lo, int& hi) {
  hi = causal ? min(Skv - 1, q0 + nq - 1) : Skv - 1;
  lo = window ? max(0, q0 - window + 1) : 0;
}

// ---------------------------------------------------------------------------
// flash_bwd_prep: D = rowsum(dO o O), one warp a (b, row, head) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_prep(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ dsum, long long rows, int Sq, int H,
                   int Dh) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * Dh;
  const T* g = dout + row * Dh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(to_f32(o[d]), to_f32(g[d]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) {  // rows run (b, i, h); D is (b, h, i)
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;
    const int i = static_cast<int>(bi % Sq);
    const long long b = bi / Sq;
    dsum[(b * H + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
namespace tcb {

using bf16 = __nv_bfloat16;
constexpr int kB = 64;        // query rows and keys of a tile
constexpr int kThreads = 128; // four warps, 16 rows of the tile each

template <int DH>
constexpr size_t smem_bytes() {
  // four bf16 tiles of 64 rows (padded by 8 elements), lse and D of 64 rows
  return sizeof(bf16) * 4 * kB * (DH + 8) + sizeof(float) * 2 * kB;
}

// Rows r0 .. r0 + 63 of head hh of x (B, S, NH, DH) into sX (row stride
// DH + 8) by cp.async, rows past S as zeros.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* sX, const bf16* x, int b,
                                          int r0, int S, int NH, int hh) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
  for (int e = threadIdx.x; e < kB * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks, s = r0 + r;
    const bool in = s < S;
    const bf16* src =
        x + (((size_t)b * S + (in ? s : 0)) * NH + hh) * DH + 8 * c;
    cp_async16(sX + r * (DH + 8) + 8 * c, src, in ? 16 : 0);
  }
}

// The A fragment of k-step kk from accumulator fragments c[8][4] of a 16 x
// 64 tile: n-tiles 2 kk and 2 kk + 1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Two 16 x 64 score-shaped products of one warp: x1 = A1 B1^T and x2 = A2
// B2^T over the head dim, A (rows a_row0 .. + 15 of sA1 / sA2) and B (the
// 64 rows of sB1 / sB2) both row-major over the head dim.
template <int DH>
__device__ __forceinline__ void scores2(float (&x1)[8][4], float (&x2)[8][4],
                                        const bf16* sA1, const bf16* sA2,
                                        const bf16* sB1, const bf16* sB2,
                                        int a_row0, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x1[nt][e] = x2[nt][e] = 0.f;
  const int ar = a_row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int br = (lane & 7) + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a1[4], a2[4];
    const int ac = 16 * kk + 8 * (lane >> 4);
    ldmatrix_x4(a1, sA1 + ar * LD + ac);
    ldmatrix_x4(a2, sA2 + ar * LD + ac);
    const int bc = 16 * kk + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b1[4], b2[4];
      ldmatrix_x4(b1, sB1 + (16 * np + br) * LD + bc);
      ldmatrix_x4(b2, sB2 + (16 * np + br) * LD + bc);
      mma16816(x1[2 * np], a1, b1[0], b1[1]);
      mma16816(x1[2 * np + 1], a1, b1[2], b1[3]);
      mma16816(x2[2 * np], a2, b2[0], b2[1]);
      mma16816(x2[2 * np + 1], a2, b2[2], b2[3]);
    }
  }
}

// acc (16 x DH) += A (16 x 64, fragments c) times sB (64 rows x DH,
// row-major: the k dim is sB's rows), B by ldmatrix.trans.
template <int DH>
__device__ __forceinline__ void acc_product(float (&acc)[DH / 8][4],
                                            float (&c)[8][4],
                                            const bf16* sB, int lane) {
  constexpr int LD = DH + 8;
  const int br = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, c, kk);
#pragma unroll
    for (int nd = 0; nd < DH / 16; ++nd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + (16 * kk + br) * LD + 16 * nd +
                               8 * (lane >> 4));
      mma16816(acc[2 * nd], a, b[0], b[1]);
      mma16816(acc[2 * nd + 1], a, b[2], b[3]);
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_rows(bf16* x,
                                           float (&acc)[DH / 8][4],
                                           float mul, int b, int r0, int S,
                                           int NH, int hh, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= S) continue;
    bf16* row = x + (((size_t)b * S + r) * NH + hh) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * half] * mul,
                                acc[n][2 * half + 1] * mul);
  }
}

// One CTA: 64 keys of KV head kh; warp w owns keys k0 + 16 w .. + 15.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Skv, int H, int KH,
                      int causal, int window, float scale,
                      float scale_log2) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kB * LD;
  bf16* sQ = sV + kB * LD;
  bf16* sO = sQ + kB * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + kB * LD);  // lse * log2 e
  float* sD = sL + kB;

  const int k0 = blockIdx.x * kB;  // key block 0, the longest causal run,
  const int kh = blockIdx.y;       // goes first
  const int b = blockIdx.z;
  const int G = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int key0 = k0 + 16 * warp + (lane >> 2);  // this thread's keys:
                                                   // key0 and key0 + 8
  load_tile<DH>(sK, k, b, k0, Skv, KH, kh);
  load_tile<DH>(sV, v, b, k0, Skv, KH, kh);
  cp_async_commit();

  int i_lo, i_hi;
  live_rows(k0, kB, Sq, causal, window, i_lo, i_hi);
  const int qb_lo = i_lo / kB;
  const int qb_hi = i_lo <= i_hi ? i_hi / kB : qb_lo - 1;

  float adk[DH / 8][4], adv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* drow = dsum + ((size_t)b * H + h) * Sq;
    for (int qb = qb_lo; qb <= qb_hi; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // the last tile's Q, dO, lse and D are consumed
      load_tile<DH>(sQ, q, b, q0, Sq, H, h);
      load_tile<DH>(sO, dout, b, q0, Sq, H, h);
      cp_async_commit();
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const bool in = q0 + r < Sq;
        sL[r] = in ? lrow[q0 + r] * kLog2eBwd : 0.f;
        sD[r] = in ? drow[q0 + r] : 0.f;
      }
      cp_async_wait0();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
      float s[8][4], dp[8][4];
      scores2<DH>(s, dp, sK, sV, sQ, sO, 16 * warp, lane);
      // fragment (nt, e): key key0 + 8 (e / 2), query q0 + 8 nt + 2 t +
      // e % 2; P^T into s, dS^T into dp
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + 2 * t + (e & 1);
          const bool ok = pair_live(q0 + c, key0 + 8 * (e >> 1), Sq, Skv,
                                    causal, window);
          const float p = ok ? exp2f(s[nt][e] * scale_log2 - sL[c]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - sD[c]);
        }
      // dV += P^T dO and dK += dS^T Q over this tile's 64 queries
      acc_product<DH>(adv, s, sO, lane);
      acc_product<DH>(adk, dp, sQ, lane);
    }
  }
  cp_async_wait0();  // the K/V copies, where no query block was live
  store_rows<DH>(dk, adk, scale, b, k0 + 16 * warp, Skv, KH, kh, lane);
  store_rows<DH>(dv, adv, 1.f, b, k0 + 16 * warp, Skv, KH, kh, lane);
}

// One CTA: 64 query rows of head h; warp w owns rows q0 + 16 w .. + 15.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, bf16* __restrict__ dq,
                    int Sq, int Skv, int H, int KH, int causal, int window,
                    float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kB * LD;
  bf16* sK = sO + kB * LD;
  bf16* sV = sK + kB * LD;

  // the longest causal rows first: the last query block gets block 0
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + (lane >> 2);  // rows row0, row0 + 8

  load_tile<DH>(sQ, q, b, q0, Sq, H, h);
  load_tile<DH>(sO, dout, b, q0, Sq, H, h);
  cp_async_commit();
  float L[2], Dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    const size_t at = ((size_t)b * H + h) * Sq + r;
    L[half] = r < Sq ? lse[at] * kLog2eBwd : 0.f;
    Dr[half] = r < Sq ? dsum[at] : 0.f;
  }

  int j_lo, j_hi;
  live_keys(q0, kB, Skv, causal, window, j_lo, j_hi);
  const int kb_lo = j_lo / kB;
  const int kb_hi = j_lo <= j_hi ? j_hi / kB : kb_lo - 1;

  float adq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the last tile's K and V are consumed
    load_tile<DH>(sK, k, b, k0, Skv, KH, kh);
    load_tile<DH>(sV, v, b, k0, Skv, KH, kh);
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
    scores2<DH>(s, dp, sQ, sO, sK, sV, 16 * warp, lane);
    // fragment (nt, e): row row0 + 8 (e / 2), key k0 + 8 nt + 2 t + e % 2;
    // dS into dp
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const bool ok = pair_live(row0 + 8 * half, k0 + 8 * nt + 2 * t +
                                  (e & 1), Sq, Skv, causal, window);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - L[half]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - Dr[half]);
      }
    // dQ += dS K over this tile's 64 keys
    acc_product<DH>(adq, dp, sK, lane);
  }
  cp_async_wait0();  // the Q/dO copies, where no key block was live
  store_rows<DH>(dq, adq, scale, b, q0 + 16 * warp, Sq, H, h, lane);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                   int H, int KH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  const float sl2 = scale * kLog2eBwd;
  if (Skv > 0) {
    auto kernel = flash_bwd_dkdv_tc<DH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Skv + kB - 1) / kB, KH, B), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        dsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H,
        KH, causal, window, scale, sl2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sq > 0) {
    auto kernel = flash_bwd_dq_tc<DH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Sq + kB - 1) / kB, H, B), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        dsum, static_cast<bf16*>(dq), Sq, Skv, H, KH, causal, window, scale,
        sl2);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace tcb

// ---------------------------------------------------------------------------
// f32 on the f32 pipes
// ---------------------------------------------------------------------------
namespace simtb {

constexpr int kB = 32;         // query rows and keys of a tile
constexpr int kThreads = 256;  // a 16 x 16 grid: (ty, tx)

template <int DH>
constexpr size_t smem_bytes() {
  // four f32 tiles of 32 rows (padded by a word), two 32 x 33 score tiles,
  // lse and D of 32 rows
  return sizeof(float) * (4 * kB * (DH + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// Rows r0 .. r0 + 31 of head hh of x (B, S, NH, DH) into sX (row stride
// DH + 1), rows past S as zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* sX, const float* x, int b,
                                          int r0, int S, int NH, int hh) {
  for (int e = threadIdx.x; e < kB * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, s = r0 + r;
    sX[r * (DH + 1) + d] =
        s < S ? x[(((size_t)b * S + s) * NH + hh) * DH + d] : 0.f;
  }
}

// x1[r][c] = A1[ty + 16 r] . B1[tx + 16 c] and x2 likewise over the head
// dim (rows of the padded tiles).
template <int DH>
__device__ __forceinline__ void dots2(float (&x1)[2][2], float (&x2)[2][2],
                                      const float* sA1, const float* sA2,
                                      const float* sB1, const float* sB2,
                                      int ty, int tx) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) x1[r][c] = x2[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a1[2], a2[2], b1[2], b2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a1[r] = sA1[(ty + 16 * r) * LD + d];
      a2[r] = sA2[(ty + 16 * r) * LD + d];
      b1[r] = sB1[(tx + 16 * r) * LD + d];
      b2[r] = sB2[(tx + 16 * r) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        x1[r][c] = fmaf(a1[r], b1[c], x1[r][c]);
        x2[r][c] = fmaf(a2[r], b2[c], x2[r][c]);
      }
  }
}

// acc[r][c] += sum_j sP[ty + 16 r][j] sX[j][tx + 16 c] over a tile's 32 j.
template <int DH>
__device__ __forceinline__ void acc_product(float (&acc)[2][DH / 16],
                                            const float* sP, const float* sX,
                                            int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < kB; ++j) {
    const float p0 = sP[ty * (kB + 1) + j];
    const float p1 = sP[(ty + 16) * (kB + 1) + j];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const float x = sX[j * (DH + 1) + tx + 16 * c];
      acc[0][c] = fmaf(p0, x, acc[0][c]);
      acc[1][c] = fmaf(p1, x, acc[1][c]);
    }
  }
}

template <int DH>
__device__ __forceinline__ void store_rows(float* x,
                                           float (&acc)[2][DH / 16],
                                           float mul, int b, int r0, int S,
                                           int NH, int hh, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r0 + ty + 16 * r;
    if (s >= S) continue;
    float* row = x + (((size_t)b * S + s) * NH + hh) * DH;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) row[tx + 16 * c] = acc[r][c] * mul;
  }
}

// One CTA: 32 keys of KV head kh; thread (ty, tx) owns keys ty + 16 r.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_simt(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int Sq, int Skv, int H, int KH, int causal,
                        int window, float scale) {
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sO = sQ + kB * LD;
  float* sP = sO + kB * LD;          // P^T [key][query]
  float* sS = sP + kB * (kB + 1);    // dS^T [key][query]
  float* sL = sS + kB * (kB + 1);
  float* sD = sL + kB;

  const int k0 = blockIdx.x * kB, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<DH>(sK, k, b, k0, Skv, KH, kh);
  load_tile<DH>(sV, v, b, k0, Skv, KH, kh);

  int i_lo, i_hi;
  live_rows(k0, kB, Sq, causal, window, i_lo, i_hi);
  const int qb_lo = i_lo / kB;
  const int qb_hi = i_lo <= i_hi ? i_hi / kB : qb_lo - 1;

  float adk[2][DH / 16], adv[2][DH / 16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) adk[r][c] = adv[r][c] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    for (int qb = qb_lo; qb <= qb_hi; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // the last tile is consumed
      load_tile<DH>(sQ, q, b, q0, Sq, H, h);
      load_tile<DH>(sO, dout, b, q0, Sq, H, h);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const size_t at = ((size_t)b * H + h) * Sq + q0 + r;
        sL[r] = q0 + r < Sq ? lse[at] : 0.f;
        sD[r] = q0 + r < Sq ? dsum[at] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots2<DH>(s, dp, sK, sV, sQ, sO, ty, tx);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kr = ty + 16 * r, qc = tx + 16 * c;
          const bool ok =
              pair_live(q0 + qc, k0 + kr, Sq, Skv, causal, window);
          const float p = ok ? expf(s[r][c] * scale - sL[qc]) : 0.f;
          sP[kr * (kB + 1) + qc] = p;
          sS[kr * (kB + 1) + qc] = p * (dp[r][c] - sD[qc]);
        }
      __syncthreads();
      acc_product<DH>(adv, sP, sO, ty, tx);
      acc_product<DH>(adk, sS, sQ, ty, tx);
    }
  }
  store_rows<DH>(dk, adk, scale, b, k0, Skv, KH, kh, ty, tx);
  store_rows<DH>(dv, adv, 1.f, b, k0, Skv, KH, kh, ty, tx);
}

// One CTA: 32 query rows of head h; thread (ty, tx) owns rows ty + 16 r.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      float* __restrict__ dq, int Sq, int Skv, int H, int KH,
                      int causal, int window, float scale) {
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kB * LD;
  float* sK = sO + kB * LD;
  float* sV = sK + kB * LD;
  float* sS = sV + kB * LD;  // dS [query][key]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_tile<DH>(sQ, q, b, q0, Sq, H, h);
  load_tile<DH>(sO, dout, b, q0, Sq, H, h);
  float L[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    const size_t at = ((size_t)b * H + h) * Sq + i;
    L[r] = i < Sq ? lse[at] : 0.f;
    Dr[r] = i < Sq ? dsum[at] : 0.f;
  }

  int j_lo, j_hi;
  live_keys(q0, kB, Skv, causal, window, j_lo, j_hi);
  const int kb_lo = j_lo / kB;
  const int kb_hi = j_lo <= j_hi ? j_hi / kB : kb_lo - 1;

  float adq[2][DH / 16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) adq[r][c] = 0.f;

  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the last tile is consumed (and Q, dO are staged)
    load_tile<DH>(sK, k, b, k0, Skv, KH, kh);
    load_tile<DH>(sV, v, b, k0, Skv, KH, kh);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots2<DH>(s, dp, sQ, sO, sK, sV, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qr = ty + 16 * r, kc = tx + 16 * c;
        const bool ok = pair_live(q0 + qr, k0 + kc, Sq, Skv, causal, window);
        const float p = ok ? expf(s[r][c] * scale - L[r]) : 0.f;
        sS[qr * (kB + 1) + kc] = p * (dp[r][c] - Dr[r]);
      }
    __syncthreads();
    acc_product<DH>(adq, sS, sK, ty, tx);
  }
  store_rows<DH>(dq, adq, scale, b, q0, Sq, H, h, ty, tx);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                   int H, int KH, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fo = static_cast<const float*>(dout);
  if (Skv > 0) {
    auto kernel = flash_bwd_dkdv_simt<DH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Skv + kB - 1) / kB, KH, B), kThreads, smem, stream>>>(
        fq, fk, fv, fo, lse, dsum, static_cast<float*>(dk),
        static_cast<float*>(dv), Sq, Skv, H, KH, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sq > 0) {
    auto kernel = flash_bwd_dq_simt<DH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Sq + kB - 1) / kB, H, B), kThreads, smem, stream>>>(
        fq, fk, fv, fo, lse, dsum, static_cast<float*>(dq), Sq, Skv, H, KH,
        causal, window, scale);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace simtb

template <typename T>
cudaError_t launch_prep(const void* out, const void* dout, float* dsum,
                        int B, int Sq, int H, int Dh, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  if (rows == 0) return cudaSuccess;
  flash_bwd_prep<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), dsum, rows,
      Sq, H, Dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dsum,
                      void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                      int H, int KH, int causal, int window, float scale,
                      cudaStream_t s) {
  if (dtype == kFloat32)
    return simtb::launch<DH>(q, k, v, dout, lse, dsum, dq, dk, dv, B, Sq,
                             Skv, H, KH, causal, window, scale, s);
  return tcb::launch<DH>(q, k, v, dout, lse, dsum, dq, dk, dv, B, Sq, Skv,
                         H, KH, causal, window, scale, s);
}

}  // namespace
}  // namespace repro

// q, out, dout, dq (B, Sq, H, Dh); k, v, dk, dv (B, Skv, KH, Dh); one
// element type (dtype: 0 = f32, 1 = bf16), contiguous, 16-byte aligned;
// lse (B, H, Sq) f32 in natural-log units (flash_attention.cu's); dsum
// (B, H, Sq) f32 scratch for D.  Three launches on `stream` (D, then dK
// and dV, then dQ); returns the first cudaGetLastError() that is not 0.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* out,
                                         const void* dout, const void* lse,
                                         void* dsum, void* dq, void* dk,
                                         void* dv, int dtype, int B, int Sq,
                                         int Skv, int H, int KH, int Dh,
                                         int causal, int window, float scale,
                                         void* stream) {
  using namespace repro;
  if (B == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0) return cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* D = static_cast<float*>(dsum);
  const float* L = static_cast<const float*>(lse);
  cudaError_t err =
      dtype == kFloat32
          ? launch_prep<float>(out, dout, D, B, Sq, H, Dh, s)
          : launch_prep<__nv_bfloat16>(out, dout, D, B, Sq, H, Dh, s);
  if (err != cudaSuccess) return err;
  switch (Dh) {
    case 16:
      return launch_dh<16>(dtype, q, k, v, dout, L, D, dq, dk, dv, B, Sq, Skv,
                           H, KH, causal, window, scale, s);
    case 32:
      return launch_dh<32>(dtype, q, k, v, dout, L, D, dq, dk, dv, B, Sq, Skv,
                           H, KH, causal, window, scale, s);
    case 64:
      return launch_dh<64>(dtype, q, k, v, dout, L, D, dq, dk, dv, B, Sq, Skv,
                           H, KH, causal, window, scale, s);
    case 128:
      return launch_dh<128>(dtype, q, k, v, dout, L, D, dq, dk, dv, B, Sq,
                            Skv, H, KH, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
