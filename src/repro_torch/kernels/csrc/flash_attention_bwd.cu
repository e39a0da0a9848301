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
// a causal mask, seven with S and dP recomputed for dQ.  At smollm-135M's
// layer (B 2, S 2048, 9 heads of 64, 3 KV heads, bf16, causal) the five
// are 24.2 GFLOP, 0.0245 ms at 989 TFLOP/s, against about 25 MB of inputs
// and outputs (0.0075 ms at 3.35 TB/s): the operations.  No atomics, so a
// gradient has the same bits from run to run.
//
// First flash_bwd_prep, D = rowsum(dO o O) in f32, a warp a row; then two
// routes, chosen by the element type:
//   bf16: one launch, flash_bwd_wgmma, of two kinds of CTA, each in its
//     own longest-first order (key block 0, the last query block), the
//     dK/dV CTAs before the dQ CTAs, which so fill the SMs that the short
//     dK/dV CTAs leave idle:
//     - a dK/dV CTA per (b, KV head, 64-key block) keeps K and V and walks
//       the (query head, 64-row query block) items of its group that hold
//       live rows (from the causal diagonal to the window's edge); its two
//       consumer warpgroups take the items in turn and sum their dK and dV
//       once at the end, in a fixed order (the GQA sum stays on chip);
//     - a dQ CTA per two (query head, 64-row query block) units of a (b,
//       KV head) keeps their Q, dO, lse and D, one consumer warpgroup a
//       unit, and streams the K/V tiles of their live key blocks.
//     Every product is wgmma on tiles that TMA brings into shared memory
//     behind mbarriers, with the pieces flash_fwd_tc is built from
//     (hopper.cuh): swizzled 64-row tiles, K-major and MN-major
//     descriptors, a ring of stages that a producer fills.  A CTA has
//     three warpgroups, two consumers and a producer whose first warp
//     loads, and setmaxnreg gives the producer's registers to the
//     consumers (240 each: at Dh 128 dK and dV alone take 64 + 64 f32 a
//     thread).  S (S^T) and dP (dP^T) are SS wgmma; P and dS are rounded
//     to bf16 and are the register A operands of the second products (RS
//     wgmma, dO, Q and K MN-major), as flash_fwd_tc rounds P before P V.
//     Within a warpgroup a tile's products run while it works on the
//     tile before, and P = 2^x comes from ex2.approx.ftz.  The reference
//     differentiates in f32, so chip_smoke.py holds this route to the
//     plain version at bf16 2e-2 of each gradient's largest entry.
//     Head dim 256 (recurrentgemma-9b: 16 query heads over one KV head,
//     a 2048-token window) splits the head dim between the consumers:
//     a 64-row tile is 32 KB, and one warpgroup's f32 dK and dV of a key
//     block would be 256 registers a thread against its 240.  So both
//     consumer warpgroups take every item (dK/dV) or tile (dQ), each
//     computes S^T and dP^T (S and dP) over the whole head dim, and each
//     owns 128 of the 256 output columns: 64 + 64 accumulator registers
//     for dK and dV, as at head dim 128, 64 for dQ, and no sum between
//     the warpgroups.  The rings keep two stages: a dK/dV CTA holds K, V
//     and two (Q, dO) stages, 198,696 bytes of shared memory with lse, D,
//     barriers and alignment slack; a dQ CTA holds one unit's Q and dO
//     and two (K, V) stages, 197,672 bytes.  Computing S and dP in both
//     warpgroups makes 6 products of 64 x 64 x 256 a dK/dV item where 4
//     would do, and 5 a dQ tile where 3 would do.  With one KV
//     head at B 1 and S 4096 there are only 64 dK/dV CTAs, each walking
//     the 16 heads' items, beside 1024 dQ CTAs.
//   f32: exact SIMT kernels on the f32 pipes (TF32 would miss 2e-5), as
//     flash_fwd_simt, in two launches: a dK/dV CTA per (b, KV head,
//     32-key block), a dQ CTA per (b, head, 32-row query block); 256
//     threads in a 16 x 16 grid over 32 x 32 tiles, the tiles staged in
//     shared memory as f32 with rows padded by a word.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
// bf16: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------
namespace tcb {

using namespace hopper;

constexpr int kB = 64;             // keys and query rows of a tile
// depth of each role's ring: four stages, two at head dim 256 (32 KB
// tiles)
__host__ __device__ constexpr int stages(int dh) {
  return dh == 256 ? 2 : 4;
}
// Whether the two consumer warpgroups split the head dim: at 256 each
// takes every item and owns 128 columns of the outputs (split), below
// that each takes every other item (or unit) with all the columns.
__host__ __device__ constexpr bool split_dh(int dh) { return dh == 256; }
constexpr int kLse = kB * 4;       // bytes of a tile's lse (or D) rows
constexpr int kConsumerRegs = 240; // registers of a consumer's thread
constexpr int kProducerRegs = 24;  // ... and of the producer's

// 2^x on the special-function unit, subnormal results flushed to zero
// (such a P is under 2^-126, far below what its bf16 rounding keeps).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes from global to shared memory at `dst` (zeros unless `in`).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// An arrival on `bar` once this thread's earlier cp.async copies are done
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Whether any (query, key) pair of the 64 x 64 tile at (q0, k0) is dead:
// past an end, above the causal diagonal or beyond the window.
__device__ __forceinline__ bool tile_masked(int q0, int k0, int Sq, int Skv,
                                            int causal, int window) {
  return k0 + kB > Skv || q0 + kB > Sq || (causal && k0 + kB - 1 > q0) ||
         (window && k0 <= q0 + kB - 1 - window);
}

template <int DH>
__host__ __device__ constexpr size_t dkdv_smem_bytes() {
  // K and V, Q and dO of each stage, lse and D of each stage, two
  // mbarriers a stage and one, and slack to align the tiles to 1024 bytes
  constexpr int kStages = stages(DH);
  return static_cast<size_t>(Tile<DH>::kBytes) * (2 + 2 * kStages) +
         2 * kLse * kStages + 8 * (2 * kStages + 1) + 1024;
}

template <int DH>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  // Q and dO of each unit (two units, one when split), K and V of each
  // stage, two mbarriers a stage and one, and slack to align the tiles to
  // 1024 bytes
  constexpr int kStages = stages(DH);
  constexpr int kUnits = split_dh(DH) ? 1 : 2;
  return static_cast<size_t>(Tile<DH>::kBytes) *
             (2 * kUnits + 2 * kStages) +
         8 * (2 * kStages + 1) + 1024;
}

// The dK/dV CTA `cta`: dK and dV of 64 keys of KV head kh.  Its two
// consumer warpgroups take its (query head, 64-row query block) items in
// turn, item it going to warpgroup it % 2, over the G heads of the group
// and the live query blocks; each keeps its own f32 dK and dV, and at the
// end warpgroup 0 stores dV = dV_0 + dV_1 and warpgroup 1 dK = dK_0 + dK_1
// (one f32 add, the same order every run).  The producer warpgroup's
// first warp loads K and V once by TMA, then fills a ring of kStages
// stages with each item's Q and dO tiles (TMA) and its 64 rows' lse and D
// (its 32 lanes, by cp.async: a row of (B, H, Sq) f32 may start at any
// 4-byte boundary, which TMA does not take).  Per item: S^T = K Q^T and
// dP^T = V dO^T (SS wgmma), then P^T = exp2(S^T scale log2 e - lse log2
// e) and dS^T = P^T o (dP^T - D) on the fragments, then dV += P^T dO and
// dK += dS^T Q (RS wgmma, P^T and dS^T rounded to bf16, dO and Q
// MN-major).  Split (head dim 256): both warpgroups take every item, each
// computes S^T and dP^T over the whole head dim and owns head-dim columns
// [128 w, 128 w + 128) of dK and dV, which it stores itself: dK and dV of
// 64 keys x 256 columns would be 256 f32 registers a thread in one
// warpgroup, and are 128 this way, as at head dim 128.
template <int DH>
__device__ __forceinline__ void dkdv_cta(
    int cta, const CUtensorMap& tq, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tdo,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int Sq, int Skv,
    int H, int KH, int causal, int window, float scale, float scale_log2) {
  static_assert(DH % 16 == 0 && DH <= 256,
                "head_dim in {16, 32, 64, 128, 256}");
  using T = Tile<DH>;
  constexpr int kStages = stages(DH);
  constexpr bool kSplit = split_dh(DH);
  constexpr int DO = kSplit ? DH / 2 : DH;  // output columns a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // base, as a pointer
  const uint32_t sK = base;
  const uint32_t sV = sK + T::kBytes;
  const uint32_t sQ = sV + T::kBytes;               // + st * T::kBytes
  const uint32_t sO = sQ + kStages * T::kBytes;     // + st * T::kBytes
  const uint32_t sL = sO + kStages * T::kBytes;     // + st * kLse
  const uint32_t sD = sL + kStages * kLse;          // + st * kLse
  const uint32_t full = sD + kStages * kLse;        // + 8 st
  const uint32_t empty = full + 8 * kStages;        // + 8 st
  const uint32_t kvbar = empty + 8 * kStages;

  // key block 0, the longest causal run, first over the whole grid
  const int b = cta % B;
  const int kh = (cta / B) % KH;
  const int k0 = cta / (B * KH) * kB;
  const int G = H / KH;
  int i_lo, i_hi;
  live_rows(k0, min(kB, Skv - k0), Sq, causal, window, i_lo, i_hi);
  const int qb_lo = i_lo / kB;
  const int n_qb = i_lo <= i_hi ? i_hi / kB - qb_lo + 1 : 0;
  const int n_items = G * n_qb;  // item it: head kh G + it / n_qb, query
                                 // block qb_lo + it % n_qb
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);  // the TMA's, and each lane's
      // the four warps of the item's warpgroup, or of both when split
      mbar_init(empty + 8 * st, kSplit ? 8 : 4);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 8 && n_items > 0) {
      if (lane == 0) {
        mbar_arrive_tx(kvbar, 2 * T::kBytes);
        for (int r = 0; r < DH / T::kBox; ++r) {
          tma_load(sK + r * T::kRegion, &tk, r * T::kBox, kh, k0, b, kvbar);
          tma_load(sV + r * T::kRegion, &tv, r * T::kBox, kh, k0, b, kvbar);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, (it / kStages - 1) & 1);
        const int h = kh * G + it / n_qb;
        const int q0 = (qb_lo + it % n_qb) * kB;
        const uint32_t bar = full + 8 * st;
        if (lane == 0) {
          mbar_arrive_tx(bar, 2 * T::kBytes);
          for (int r = 0; r < DH / T::kBox; ++r) {
            tma_load(sQ + st * T::kBytes + r * T::kRegion, &tq, r * T::kBox,
                     h, q0, b, bar);
            tma_load(sO + st * T::kBytes + r * T::kRegion, &tdo,
                     r * T::kBox, h, q0, b, bar);
          }
        }
        // the rows' lse and D by cp.async, rows past Sq as zeros: each
        // lane copies two of each, and the barrier counts its copies done
        const size_t at = ((size_t)b * H + h) * Sq + q0;
        for (int r = lane; r < kB; r += 32) {
          const bool in = q0 + r < Sq;
          cp_async4(sL + st * kLse + 4 * r, lse + at + (in ? r : 0), in);
          cp_async4(sD + st * kLse + 4 * r, dsum + at + (in ? r : 0), in);
        }
        cp_async_mbar_arrive(bar);
      }
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = warp >> 2;
    // this thread's two keys (rows of every accumulator fragment) and its
    // query columns 8 j + col + {0, 1}
    const int row0 = (warp & 3) * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
    const int key0 = k0 + row0, key1 = key0 + 8;
    // this warpgroup's head-dim columns of dO and Q (split: its half)
    const uint32_t cols = kSplit ? w * (DO / T::kBox) * T::kRegion : 0;

    float adk[DO / 2], adv[DO / 2];
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) adk[i] = adv[i] = 0.f;

    // Each item's products run while this warpgroup works on the one
    // before: S^T and dP^T go out together, P^T is computed while dP^T
    // runs, dS^T while dV's product runs, and the dK product is still
    // running when the next item's S^T and dP^T go out.  P^T and dS^T are
    // the second products' A operands in registers (through shared
    // memory, with the stores, a proxy fence and a barrier, the pass ran
    // slower).  A stage is handed back once the products that read it are
    // done (at the next item's first wait, or at the end).
    uint32_t pa[4][4] = {}, da[4][4] = {};  // P^T, dS^T as A fragments
    int prev_st = -1;
    if ((kSplit ? 0 : w) < n_items) mbar_wait(kvbar, 0);
    for (int it = kSplit ? 0 : w; it < n_items; it += kSplit ? 1 : 2) {
      const int st = it % kStages;
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      const uint32_t tQ = sQ + st * T::kBytes;
      const uint32_t tO = sO + st * T::kBytes;
      const float* ls = reinterpret_cast<const float*>(gbase + (sL - base) +
                                                       st * kLse);
      const float* ds = reinterpret_cast<const float*>(gbase + (sD - base) +
                                                       st * kLse);
      const int q0 = (qb_lo + it % n_qb) * kB;

      // S^T = K Q^T and dP^T = V dO^T over the head dim, two groups
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_m64n64(s, desc_kmajor<DH>(sK, kk), desc_kmajor<DH>(tQ, kk),
                        kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss_m64n64(dp, desc_kmajor<DH>(sV, kk), desc_kmajor<DH>(tO, kk),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T, and the last item's dV and dK, are done
      fence_regs(s);
      fence_regs(adv);
      fence_regs(adk);
      fence_regs(pa);
      fence_regs(da);
      if (prev_st >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev_st);
      }

      // fragment j of s: keys key0 / key1, queries q0 + 8 j + col + {0, 1};
      // P^T into s
      const bool masked = tile_masked(q0, k0, Sq, Skv, causal, window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + col);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float lc = (c ? l2.y : l2.x) * kLog2eBwd;
          float p0 = exp2_ftz(s[4 * j + c] * scale_log2 - lc);
          float p1 = exp2_ftz(s[4 * j + 2 + c] * scale_log2 - lc);
          if (masked) {
            const int qpos = q0 + 8 * j + col + c;
            if (!pair_live(qpos, key0, Sq, Skv, causal, window)) p0 = 0.f;
            if (!pair_live(qpos, key1, Sq, Skv, causal, window)) p1 = 0.f;
          }
          s[4 * j + c] = p0;
          s[4 * j + 2 + c] = p1;
        }
      }
      acc_to_a(pa, s);

      // dV += P^T dO over the tile's 64 queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DO>(adv, pa[kk], desc_mnmajor<DH>(tO + cols, kk));
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done
      fence_regs(dp);

      // dS^T = P^T o (dP^T - D) into dp
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + col);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dc = c ? d2.y : d2.x;
          dp[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - dc);
          dp[4 * j + 2 + c] = s[4 * j + 2 + c] * (dp[4 * j + 2 + c] - dc);
        }
      }
      acc_to_a(da, dp);

      // dK += dS^T Q over the tile's 64 queries
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DO>(adk, da[kk], desc_mnmajor<DH>(tQ + cols, kk));
      wgmma_commit();
      prev_st = st;
    }
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(da);
    if (prev_st >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev_st);
    }

    if constexpr (kSplit) {  // each warpgroup stores its own columns
      const size_t r0 = (((size_t)b * Skv + key0) * KH + kh) * DH + w * DO +
                        col;
      const size_t r1 = r0 + (size_t)8 * KH * DH;  // key1's row
#pragma unroll
      for (int j = 0; j < DO / 8; ++j) {
        if (key0 < Skv) {
          *reinterpret_cast<__nv_bfloat162*>(dv + r0 + 8 * j) =
              __floats2bfloat162_rn(adv[4 * j], adv[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + r0 + 8 * j) =
              __floats2bfloat162_rn(adk[4 * j] * scale,
                                    adk[4 * j + 1] * scale);
        }
        if (key1 < Skv) {
          *reinterpret_cast<__nv_bfloat162*>(dv + r1 + 8 * j) =
              __floats2bfloat162_rn(adv[4 * j + 2], adv[4 * j + 3]);
          *reinterpret_cast<__nv_bfloat162*>(dk + r1 + 8 * j) =
              __floats2bfloat162_rn(adk[4 * j + 2] * scale,
                                    adk[4 * j + 3] * scale);
        }
      }
    } else {
      // The fixed-order sum: each warpgroup hands the other the half it
      // does not store, in its fragment order, through the drained ring.
      const int tid = threadIdx.x & 127;
      float* xfer = reinterpret_cast<float*>(gbase + (sQ - base));
      // the ring is drained
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < DH / 2; ++i)
        xfer[(w * (DH / 2) + i) * 128 + tid] = w == 0 ? adk[i] : adv[i];
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      bf16* out = w == 0 ? dv : dk;
      const float mul = w == 0 ? 1.f : scale;
      float acc[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i)
        acc[i] = ((w == 0 ? adv[i] : adk[i]) +
                  xfer[((1 - w) * (DH / 2) + i) * 128 + tid]) * mul;
      bf16* o0 = out + (((size_t)b * Skv + key0) * KH + kh) * DH + col;
      bf16* o1 = out + (((size_t)b * Skv + key1) * KH + kh) * DH + col;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        if (key0 < Skv)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (key1 < Skv)
          *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// Unit u of a KV head in the dQ pass: query block n_qb - 1 - u / G (the
// longest causal runs first) of query head h_in_group = u % G, and the
// key blocks [t_lo, t_hi] that hold its rows' live keys (empty if t_lo >
// t_hi).
__device__ __forceinline__ void dq_unit(int u, int G, int Sq, int Skv,
                                        int causal, int window, int& q0,
                                        int& hg, int& t_lo, int& t_hi) {
  q0 = ((Sq + kB - 1) / kB - 1 - u / G) * kB;
  hg = u % G;
  int j_lo, j_hi;
  live_keys(q0, min(kB, Sq - q0), Skv, causal, window, j_lo, j_hi);
  t_lo = j_lo / kB;
  t_hi = j_lo <= j_hi ? j_hi / kB : t_lo - 1;
}

// The dQ CTA `cta`: dQ of two units of one KV head (two 64-row query
// blocks, of two query heads or of one), one consumer warpgroup each, as
// flash_fwd_tc lays out the forward: the producer warpgroup's first lane
// loads each unit's Q and dO once, then fills a ring of kStages stages
// with the K/V tiles of the two units' live key blocks, which both
// warpgroups share (a warpgroup passes over a tile outside its own).
// Pairing units, not heads, keeps both warpgroups busy where G is odd.
// Per tile: S = Q K^T and dP = dO V^T (SS wgmma), P and dS = P o (dP - D)
// on the fragments, dQ += dS K (RS wgmma, dS rounded to bf16, K
// MN-major).  Split (head dim 256): one unit a CTA, whose Q and dO (64
// KB) and two K/V stages (128 KB) fill the shared memory; both
// warpgroups take every tile, each computes S and dP over the whole head
// dim and owns dQ's head-dim columns [128 w, 128 w + 128).
template <int DH>
__device__ __forceinline__ void dq_cta(
    int cta, const CUtensorMap& tq, const CUtensorMap& tk,
    const CUtensorMap& tv, const CUtensorMap& tdo,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    bf16* __restrict__ dq, int B, int Sq, int Skv, int H, int KH,
    int causal, int window, float scale, float scale_log2) {
  static_assert(DH % 16 == 0 && DH <= 256,
                "head_dim in {16, 32, 64, 128, 256}");
  using T = Tile<DH>;
  constexpr int kStages = stages(DH);
  constexpr bool kSplit = split_dh(DH);
  constexpr int DO = kSplit ? DH / 2 : DH;  // dQ columns a warpgroup
  constexpr int kUnits = kSplit ? 1 : 2;    // units a CTA
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                        // + w * T::kBytes
  const uint32_t sO = sQ + kUnits * T::kBytes;     // + w * T::kBytes
  const uint32_t sK = sO + kUnits * T::kBytes;     // + st * T::kBytes
  const uint32_t sV = sK + kStages * T::kBytes;    // + st * T::kBytes
  const uint32_t full = sV + kStages * T::kBytes;  // + 8 st
  const uint32_t empty = full + 8 * kStages;       // + 8 st
  const uint32_t qbar = empty + 8 * kStages;

  // units 2 c and 2 c + 1 (split: unit c) of (b, kh); c = 0, the
  // longest, first
  const int G = H / KH;
  const int b = cta % B;
  const int kh = (cta / B) % KH;
  const int u0 = kUnits * (cta / (B * KH));
  const int n_act = min(kUnits, (Sq + kB - 1) / kB * G - u0);
  int kb_lo = 1 << 30, kb_hi = -1;  // the hull of the units' key blocks
  for (int w = 0; w < n_act; ++w) {
    int q0, hg, t_lo, t_hi;
    dq_unit(u0 + w, G, Sq, Skv, causal, window, q0, hg, t_lo, t_hi);
    if (t_lo <= t_hi) {
      kb_lo = min(kb_lo, t_lo);
      kb_hi = max(kb_hi, t_hi);
    }
  }
  const int n_tiles = kb_hi >= kb_lo ? kb_hi - kb_lo + 1 : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      // one arrival a consumer warp (split: both warpgroups)
      mbar_init(empty + 8 * st, 4 * (kSplit ? 2 : n_act));
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: its first lane loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 8 && lane == 0 && n_tiles > 0) {
      mbar_arrive_tx(qbar, 2 * n_act * T::kBytes);
      for (int w = 0; w < n_act; ++w) {
        int q0, hg, t_lo, t_hi;
        dq_unit(u0 + w, G, Sq, Skv, causal, window, q0, hg, t_lo, t_hi);
        for (int r = 0; r < DH / T::kBox; ++r) {
          tma_load(sQ + w * T::kBytes + r * T::kRegion, &tq, r * T::kBox,
                   kh * G + hg, q0, b, qbar);
          tma_load(sO + w * T::kBytes + r * T::kRegion, &tdo, r * T::kBox,
                   kh * G + hg, q0, b, qbar);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, (it / kStages - 1) & 1);
        mbar_arrive_tx(full + 8 * st, 2 * T::kBytes);
        const int k0 = (kb_lo + it) * kB;
        for (int r = 0; r < DH / T::kBox; ++r) {
          tma_load(sK + st * T::kBytes + r * T::kRegion, &tk, r * T::kBox,
                   kh, k0, b, full + 8 * st);
          tma_load(sV + st * T::kBytes + r * T::kRegion, &tv, r * T::kBox,
                   kh, k0, b, full + 8 * st);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int w = warp >> 2;  // this consumer warpgroup
  const int unit = kSplit ? 0 : w;  // its unit of the CTA's
  if (unit >= n_act) return;  // the KV head has no unit left for it
  int qb0, hg, my_lo, my_hi;  // this warpgroup's unit
  dq_unit(u0 + unit, G, Sq, Skv, causal, window, qb0, hg, my_lo, my_hi);
  const int h = kh * G + hg;
  // this thread's two rows of every accumulator fragment, and its columns
  const int row0 = (warp & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const int qpos0 = qb0 + row0, qpos1 = qpos0 + 8;
  const uint32_t sQw = sQ + unit * T::kBytes;
  const uint32_t sOw = sO + unit * T::kBytes;
  // this warpgroup's head-dim columns of K (split: its half)
  const uint32_t cols = kSplit ? w * (DO / T::kBox) * T::kRegion : 0;
  const size_t at = ((size_t)b * H + h) * Sq;
  const float L0 = qpos0 < Sq ? lse[at + qpos0] * kLog2eBwd : 0.f;
  const float L1 = qpos1 < Sq ? lse[at + qpos1] * kLog2eBwd : 0.f;
  const float D0 = qpos0 < Sq ? dsum[at + qpos0] : 0.f;
  const float D1 = qpos1 < Sq ? dsum[at + qpos1] : 0.f;

  float adq[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) adq[i] = 0.f;

  // As in the dK/dV pass, a tile's products run while this warpgroup
  // works: P is computed while dP's product runs, and the dQ product is
  // still running when the next tile's S and dP go out; a stage is
  // handed back once the products that read it are done.
  uint32_t da[4][4] = {};  // dS as register A fragments
  int prev_st = -1;
  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int kb = kb_lo + it;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    if (kb < my_lo || kb > my_hi) {  // the other unit's tile: hand it back
      if (prev_st >= 0) {
        wgmma_wait<0>();
        fence_regs(adq);
        fence_regs(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev_st);
        prev_st = -1;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      continue;
    }
    const uint32_t tK = sK + st * T::kBytes;
    const uint32_t tV = sV + st * T::kBytes;
    const int k0 = kb * kB;

    // S = Q K^T and dP = dO V^T over the head dim, two groups
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(s, desc_kmajor<DH>(sQw, kk), desc_kmajor<DH>(tK, kk),
                      kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(dp, desc_kmajor<DH>(sOw, kk), desc_kmajor<DH>(tV, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last tile's dQ product, are done
    fence_regs(s);
    fence_regs(adq);
    fence_regs(da);
    if (prev_st >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev_st);
    }

    // fragment j of s: rows qpos0 / qpos1, keys k0 + 8 j + col + {0, 1};
    // P into s
    const bool masked = tile_masked(qb0, k0, Sq, Skv, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float p0 = exp2_ftz(s[4 * j + c] * scale_log2 - L0);
        float p1 = exp2_ftz(s[4 * j + 2 + c] * scale_log2 - L1);
        if (masked) {
          const int kpos = k0 + 8 * j + col + c;
          if (!pair_live(qpos0, kpos, Sq, Skv, causal, window)) p0 = 0.f;
          if (!pair_live(qpos1, kpos, Sq, Skv, causal, window)) p1 = 0.f;
        }
        s[4 * j + c] = p0;
        s[4 * j + 2 + c] = p1;
      }
    }
    wgmma_wait<0>();  // dP is done
    fence_regs(dp);
    // dS = P o (dP - D) into dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dp[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - D0);
        dp[4 * j + 2 + c] = s[4 * j + 2 + c] * (dp[4 * j + 2 + c] - D1);
      }
    }
    acc_to_a(da, dp);

    // dQ += dS K over the tile's 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DO>(adq, da[kk], desc_mnmajor<DH>(tK + cols, kk));
    wgmma_commit();
    prev_st = st;
  }
  wgmma_wait<0>();
  fence_regs(adq);
  fence_regs(da);
  if (prev_st >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev_st);
  }

  const int c0 = (kSplit ? w * DO : 0) + col;
  bf16* o0 = dq + (((size_t)b * Sq + qpos0) * H + h) * DH + c0;
  bf16* o1 = dq + (((size_t)b * Sq + qpos1) * H + h) * DH + c0;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    if (qpos0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(
          adq[4 * j] * scale, adq[4 * j + 1] * scale);
    if (qpos1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) = __floats2bfloat162_rn(
          adq[4 * j + 2] * scale, adq[4 * j + 3] * scale);
  }
}

// Both passes in one launch: CTAs 0 .. n_dkdv - 1 run the dK/dV pass,
// the rest the dQ pass, each in its own longest-first order, so dQ CTAs
// fill the SMs that the dK/dV pass's short CTAs leave idle.  Three
// warpgroups a CTA in both: two consumers and a producer whose first warp
// loads; setmaxnreg moves the producer's registers to the consumers.
template <int DH>
__global__ void __launch_bounds__(3 * 128, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                    int Sq, int Skv, int H, int KH, int causal, int window,
                    float scale, float scale_log2, int n_dkdv) {
  const int cta = static_cast<int>(blockIdx.x);
  if (cta < n_dkdv)
    dkdv_cta<DH>(cta, tq, tk, tv, tdo, lse, dsum, dk, dv, B, Sq, Skv, H, KH,
                 causal, window, scale, scale_log2);
  else
    dq_cta<DH>(cta - n_dkdv, tq, tk, tv, tdo, lse, dsum, dq, B, Sq, Skv, H,
               KH, causal, window, scale, scale_log2);
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dsum,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                   int H, int KH, int causal, int window, float scale,
                   cudaStream_t stream) {
  if (Sq == 0 || Skv == 0) {  // nothing live: every gradient is zero
    const size_t nq = (size_t)B * Sq * H * DH * 2;
    const size_t nk = (size_t)B * Skv * KH * DH * 2;
    cudaError_t err = cudaMemsetAsync(dq, 0, nq, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, nk, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, nk, stream);
    return err;
  }
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!encode<DH>(enc, &mq, q, B, Sq, H) ||
      !encode<DH>(enc, &mk, k, B, Skv, KH) ||
      !encode<DH>(enc, &mv, v, B, Skv, KH) ||
      !encode<DH>(enc, &mo, dout, B, Sq, H))
    return cudaErrorInvalidValue;
  const long long n_dkdv = (long long)((Skv + kB - 1) / kB) * KH * B;
  const long long units = (long long)(Sq + kB - 1) / kB * (H / KH);
  const long long n_dq =
      (split_dh(DH) ? units : (units + 1) / 2) * KH * B;
  if (n_dkdv + n_dq >= (1LL << 31)) return cudaErrorInvalidValue;
  const size_t smem = dkdv_smem_bytes<DH>() > dq_smem_bytes<DH>()
                          ? dkdv_smem_bytes<DH>()
                          : dq_smem_bytes<DH>();
  auto kernel = flash_bwd_wgmma<DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(n_dkdv + n_dq), 3 * 128, smem, stream>>>(
      mq, mk, mv, mo, lse, dsum, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Skv, H, KH,
      causal, window, scale, scale * kLog2eBwd, (int)n_dkdv);
  return cudaGetLastError();
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
// (B, H, Sq) f32 scratch for D.  Launches on `stream` D, then bf16's one
// launch of dK, dV and dQ or f32's two (dK and dV, then dQ); returns the
// first cudaGetLastError() that is not 0.
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
    case 256:
      return launch_dh<256>(dtype, q, k, v, dout, L, D, dq, dk, dv, B, Sq,
                            Skv, H, KH, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
