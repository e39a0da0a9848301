// Flash-attention prefill forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body `_kernel`): blockwise attention over
// q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh) with GQA (query head h reads
// KV head h / G), a causal mask, an optional sliding window and a query
// offset; online softmax with m, l and acc in f32; KV tiles that the
// causal/window mask excludes entirely are skipped, as `pl.when(live)` does.
// Unlike the TPU kernel it takes any Sq and Skv: the ragged last tile is
// masked here, so a prefill padded only to the page size (S = 144) works.
//
// Two kernels sit behind the one C entry, chosen by the element type.  The
// Hopper pieces of the first (tiles, descriptors, mbarriers, TMA, the
// wgmma wrappers, the TMA maps) are in hopper.cuh, shared with the
// backward (flash_attention_bwd.cu):
//
// flash_fwd_tc (bf16).  What bounds it: at the serve's prompt lengths
// (S ~ 500, qwen2-7b's 28 heads of 128) the bytes of q, k, v and out
// (8.4 MB, 2.4 us at 3.35 TB/s) against 1.9 GFLOP of masked work (1.9 us
// at 989 TFLOP/s); from S ~ 1000 on the operations, which grow as S^2
// (30 GFLOP at S = 2048).  On the card the first limit met is neither: it
// is moving K/V tiles from L2 into shared memory, which every query block
// of every head repeats.  The design puts both products on the tensor
// cores and cuts and hides that traffic.  One CTA owns a 64-row query
// block of two query heads of one KV group, one consumer warpgroup a head
// (one warpgroup where a KV group has one head; an odd group's last CTA
// leaves its second warpgroup idle), so each K/V tile serves 128 query
// rows; a producer warp fills a ring of four stages by TMA (128B swizzle
// for head dims >= 64, 64B and 32B below; rows past the sequence end read
// as zeros), full and empty mbarriers a stage, so up to three tiles are in
// flight behind the one in use; Q goes in by TMA once.  S = Q K^T is wgmma
// m64n64k16 with Q and K read from shared memory by descriptor, f32
// accumulators in registers; the online softmax runs on the accumulator
// fragments (row max and sum over the four threads of a row by shuffles,
// exp2f with the scale folded into log2 e, the row sum kept per thread and
// reduced once at the end); P is rounded to bf16 in registers and is the
// register A operand of the second wgmma, with V read from shared memory
// as a transposed (MN-major) B; O stays in f32 registers.  Only tiles that
// cross the causal diagonal, the window's edge or a ragged Skv edge compute
// a mask; the epilogue divides by l and stores bf16.  Still to come: the
// overlap of one tile's softmax with the next tile's products (two score
// buffers, or two warpgroups taking turns).
//
// flash_fwd_simt (f32).  TF32 tensor cores would miss the f32 tolerance of
// 2e-5, so f32 keeps the exact kernel on the f32 pipes: one block of 256
// threads owns 64 query rows of one head; each 32-key K/V tile is staged
// once in shared memory (as f32, rows padded by one word so column reads
// hit distinct banks) and used by all 64 rows; each thread holds a 4 x 2
// tile of scores and a 4 x Dh/16 tile of the output in registers.
//
// The row log-sum-exp.  Where the caller passes an `lse` buffer (f32,
// (B, H, Sq)), both kernels also write, for every query row below Sq,
// lse = log(sum_j exp(scale * q . k_j)) over the row's live keys, in
// natural-log units (flash_fwd_tc keeps its running max in log2 units and
// converts at the store: (m + log2 l) * ln 2).  The backward
// (flash_attention_bwd.cu) recomputes P = exp(scale * q . k - lse) from
// it.  A row with no live key stores about -6.9e29 (the finite minus
// infinity plus log 1e-20); the backward masks such a row's keys anyway.
// The serve path passes a null `lse`, and nothing is written.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// flash_fwd_tc: bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kBQ = 64;      // query rows of a consumer warpgroup: wgmma's M
constexpr int kBKV = 64;     // keys per K/V tile
constexpr int kStages = 4;   // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH, int NWG>
__host__ __device__ constexpr size_t smem_bytes() {
  // Q of each warpgroup, K and V of each stage, 2 kStages + 1 mbarriers,
  // and slack to align the tiles to 1024 bytes (the 128B swizzle's period)
  return static_cast<size_t>(Tile<DH>::kBytes) * (NWG + 2 * kStages) +
         8 * (2 * kStages + 1) + 1024;
}

// One CTA: a 64-row query block of NWG heads of one KV group (one consumer
// warpgroup a head, sharing every K/V tile), plus one producer warp whose
// lane 0 fills the K/V ring by TMA.  Tiles t_lo .. t_hi (the live run) go
// through kStages stages: full[st] completes when a tile has landed,
// empty[st] when every consumer warp is done with it.
template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ out, float* __restrict__ lse, int Sq,
                 int Skv, int H, int KH, int causal, int window,
                 int q_offset, float scale_log2) {
  static_assert(DH % 16 == 0 && DH <= 128, "head_dim in {16, 32, 64, 128}");
  using T = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                        // + w * T::kBytes
  const uint32_t sK = base + NWG * T::kBytes;      // + st * T::kBytes
  const uint32_t sV = sK + kStages * T::kBytes;    // + st * T::kBytes
  const uint32_t full = sV + kStages * T::kBytes;  // + 8 st
  const uint32_t empty = full + 8 * kStages;       // + 8 st
  const uint32_t qbar = empty + 8 * kStages;

  // the longest causal rows first: the last query block gets block 0
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int G = H / KH;
  const int groups = (G + NWG - 1) / NWG;  // CTAs a KV head's query heads
  const int kh = blockIdx.y / groups;
  const int h0 = kh * G + (blockIdx.y % groups) * NWG;
  const int n_act = min(NWG, kh * G + G - h0);  // heads this CTA owns
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int qfirst = q_offset + q0;
  const int qlast = qfirst + kBQ - 1;
  // live tiles are one contiguous run [t_lo, t_hi]
  int t_hi = (Skv + kBKV - 1) / kBKV - 1;
  if (causal) t_hi = min(t_hi, qlast >= 0 ? qlast / kBKV : -1);
  int t_lo = 0;
  if (window)
    while (t_lo <= t_hi && t_lo * kBKV + kBKV - 1 <= qfirst - window) ++t_lo;
  const int n_tiles = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * n_act);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_tx(qbar, n_act * T::kBytes);
      for (int w = 0; w < n_act; ++w)
        for (int r = 0; r < DH / T::kBox; ++r)
          tma_load(sQ + w * T::kBytes + r * T::kRegion, &tq, r * T::kBox,
                   h0 + w, q0, b, qbar);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * st, (it / kStages - 1) & 1);
        mbar_arrive_tx(full + 8 * st, 2 * T::kBytes);
        const int k0 = (t_lo + it) * kBKV;
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

  const int w = warp >> 2;  // this consumer warpgroup
  if (w >= n_act) return;   // the group has no head left for it
  const int h = h0 + w;
  // this thread's two rows of every accumulator fragment, and its columns
  const int row0 = (warp & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const int qpos0 = qfirst + row0;
  const int qpos1 = qpos0 + 8;
  const uint32_t sQw = sQ + w * T::kBytes;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    mbar_wait(full + 8 * st, (it / kStages) & 1);
    const uint32_t tK = sK + st * T::kBytes;
    const uint32_t tV = sV + st * T::kBytes;

    // S = Q K^T over the head dim, 16 columns a step
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_m64n64(s, desc_kmajor<DH>(sQw, kk), desc_kmajor<DH>(tK, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // fragment j of s: rows row0 / row0 + 8, keys k0 + 8 j + col + {0, 1}
    const int k0 = (t_lo + it) * kBKV;
    const bool masked = k0 + kBKV > Skv ||
                        (causal && k0 + kBKV - 1 > qfirst) ||
                        (window && k0 <= qlast - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& s0 = s[4 * j + c];
        float& s1 = s[4 * j + 2 + c];
        s0 *= scale_log2;
        s1 *= scale_log2;
        if (masked) {
          const int kpos = k0 + 8 * j + col + c;
          const bool in = kpos < Skv;
          if (!(in && (!causal || kpos <= qpos0) &&
                (!window || kpos > qpos0 - window)))
            s0 = -INFINITY;
          if (!(in && (!causal || kpos <= qpos1) &&
                (!window || kpos > qpos1 - window)))
            s1 = -INFINITY;
        }
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // m starts at the finite -1e30, so a row with nothing live yet keeps
    // corr = 1 and p = exp2(-inf) = 0, never NaN
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = exp2f(s[4 * j + c] - mn0);
        s[4 * j + 2 + c] = exp2f(s[4 * j + 2 + c] - mn1);
        rs0 += s[4 * j + c];
        rs1 += s[4 * j + 2 + c];
      }
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    // P in bf16: the accumulator fragments of keys 16 kk .. 16 kk + 15 are
    // the A fragment of k-step kk
    uint32_t pa[4][4];
    acc_to_a(pa, s);

    // O += P V over the keys, 16 keys a step
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DH>(o, pa[kk], desc_mnmajor<DH>(tV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with st
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  const int sr0 = q0 + row0, sr1 = sr0 + 8;
  bf16* o0 = out + ((size_t)(b * Sq + sr0) * H + h) * DH + col;
  bf16* o1 = out + ((size_t)(b * Sq + sr1) * H + h) * DH + col;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    if (sr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (sr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  // the four threads of a row hold the same m and l: one of them stores
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + ((size_t)b * H + h) * Sq;
    if (sr0 < Sq) lrow[sr0] = (m0 + log2f(fmaxf(l0, 1e-20f))) * kLn2;
    if (sr1 < Sq) lrow[sr1] = (m1 + log2f(fmaxf(l1, 1e-20f))) * kLn2;
  }
}

template <int DH, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int KH,
                   int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode<DH>(enc, &mq, q, B, Sq, H) ||
      !encode<DH>(enc, &mk, k, B, Skv, KH) ||
      !encode<DH>(enc, &mv, v, B, Skv, KH))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<DH, NWG>();
  auto kernel = flash_fwd_tc<DH, NWG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  const dim3 grid((Sq + kBQ - 1) / kBQ, KH * ((G + NWG - 1) / NWG), B);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, Sq, Skv, H, KH, causal,
      window, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

// Two consumer warpgroups (two query heads on every K/V tile) where the
// KV group has two heads or more, else one.
template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Skv, int H, int KH,
                      int causal, int window, int q_offset, float scale,
                      cudaStream_t stream) {
  if (H / KH >= 2)
    return launch<DH, 2>(q, k, v, out, lse, B, Sq, Skv, H, KH, causal,
                         window, q_offset, scale, stream);
  return launch<DH, 1>(q, k, v, out, lse, B, Sq, Skv, H, KH, causal, window,
                       q_offset, scale, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// flash_fwd_simt: f32 on the f32 pipes
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBKV = 32;         // keys per K/V tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kKeys = kBKV / 16; // keys per thread in the score tile

template <int DH>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBKV * (DH + 1) + kBKV * DH +
                          kBQ * (kBKV + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Skv, int H, int KH,
                   int causal, int window, int q_offset, float scale) {
  static_assert(DH % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = DH + 1;    // padded row strides
  constexpr int KS = DH + 1;
  constexpr int PS = kBKV + 1;
  constexpr int NC = DH / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][QS]   q * scale
  float* Ks = Qs + kBQ * QS;    // [kBKV][KS]
  float* Vs = Ks + kBKV * KS;   // [kBKV][DH]
  float* Ps = Vs + kBKV * DH;   // [kBQ][PS]   probabilities of this tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // key / output-column lane
  const int ty = tid / 16;      // query-row lane

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, s = q0 + r;
    float x = 0.f;
    if (s < Sq) x = to_f32(q[((size_t)(b * Sq + s) * H + h) * DH + d]) * scale;
    Qs[r * QS + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // Global positions of the block's first and last query row.
  const int qfirst = q_offset + q0;
  const int qlast = qfirst + kBQ - 1;
  const int ntiles = (Skv + kBKV - 1) / kBKV;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBKV;
    bool live = true;
    if (causal) live = live && k0 <= qlast;
    if (window) live = live && k0 + kBKV - 1 > qfirst - window;
    if (!live) continue;  // uniform over the block

    __syncthreads();  // last tile's Ks/Vs/Ps are consumed; Qs is staged
    for (int e = tid; e < kBKV * DH; e += kThreads) {
      const int r = e / DH, d = e % DH, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < Skv) {
        const size_t off = ((size_t)(b * Skv + s) * KH + kh) * DH + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * KS + d] = kx;
      Vs[r * DH + d] = vx;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = Qs[(ty + 16 * r) * QS + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kv[c] = Ks[(tx + 16 * c) * KS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

    // Online softmax.  The 16 threads of one query row are the 16 lanes of
    // one half-warp, so row reductions are width-16 shuffles.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = qfirst + ty + 16 * r;
      bool ok[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kpos = k0 + tx + 16 * c;
        ok[c] = kpos < Skv && (!causal || kpos <= qpos) &&
                (!window || kpos > qpos - window);
        if (!ok[c]) sc[r][c] = kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
        Ps[(ty + 16 * r) * PS + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o, 16);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = Ps[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vx = Vs[j * DH + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pv[r], vx, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    T* o = out + ((size_t)(b * Sq + s) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f32<T>(acc[r][c] / lc);
    // the 16 threads of a row hold the same m and l: one of them stores
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + s] = m[r] + logf(lc);
  }
}


cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int H, int KH, int Dh,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  auto go = [&](auto kernel, size_t smem) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv,
        H, KH, causal, window, q_offset, scale);
    return cudaGetLastError();
  };
  switch (Dh) {
    case 16: return go(flash_fwd_simt<float, 16>, flash_smem_bytes<16>());
    case 32: return go(flash_fwd_simt<float, 32>, flash_smem_bytes<32>());
    case 64: return go(flash_fwd_simt<float, 64>, flash_smem_bytes<64>());
    case 128: return go(flash_fwd_simt<float, 128>, flash_smem_bytes<128>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt
}  // namespace
}  // namespace repro

// q (B, Sq, H, Dh), k and v (B, Skv, KH, Dh), out (B, Sq, H, Dh): contiguous,
// one element type (dtype: 0 = f32, 1 = bf16), 16-byte aligned for bf16.
// lse: null, or f32 (B, H, Sq) for the row log-sum-exp (natural log).
// bf16 runs flash_fwd_tc, f32 flash_fwd_simt.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int dtype, int B, int Sq, int Skv,
                                         int H, int KH, int Dh, int causal,
                                         int window, int q_offset,
                                         float scale, void* stream) {
  using namespace repro;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kFloat32)
    return simt::launch(q, k, v, out, l, B, Sq, Skv, H, KH, Dh, causal,
                        window, q_offset, scale, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (Dh) {
    case 16:
      return tc::launch_tc<16>(q, k, v, out, l, B, Sq, Skv, H, KH, causal,
                                 window, q_offset, scale, s);
    case 32:
      return tc::launch_tc<32>(q, k, v, out, l, B, Sq, Skv, H, KH, causal,
                                 window, q_offset, scale, s);
    case 64:
      return tc::launch_tc<64>(q, k, v, out, l, B, Sq, Skv, H, KH, causal,
                                 window, q_offset, scale, s);
    case 128:
      return tc::launch_tc<128>(q, k, v, out, l, B, Sq, Skv, H, KH, causal,
                                 window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
