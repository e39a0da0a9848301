// One-token decode attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// paged_decode_attention_pallas (body `_paged_kernel`).  For each request b
// and KV head it attends the G query heads that share that KV head over the
// first kv_len[b] positions, read page by page through page_table[b, :]
// (position t lives in page page_table[b, t / ps] at offset t % ps), and
// writes the normalised output with its softmax statistics (out, m, l) in
// the contract of flash_attention.py:146-147, so the caller folds the
// current token in with decode_attention_combine.  kv_len = 0 gives
// m = -1e30, l = 1e-20 and out = 0.
//
// What bounds it on the card: bytes.  Each K/V element read is used by only
// G query rows (G = 7 for qwen2-7b), about 2G operations per 2-byte element,
// far below the H100's ridge of about 295 operations per byte.
//
// What the design does about it: it reads only the pages that hold live
// positions (j < ceil(kv_len / ps)), each exactly once, and keeps scores,
// probabilities and the f32 accumulator in shared memory, never in device
// memory; the block reads its page-table entries itself, which is what the
// TPU kernel's scalar prefetch did.  The pages are walked in order by one
// block per (request, KV head), so at small batch few SMs are busy: a
// split over the KV length (flash decoding) is the next step for speed.
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;

inline size_t decode_smem_bytes(int G, int Dh, int ps) {
  // q, acc: [G][Dh]; k: [ps][Dh + 1]; v: [ps][Dh]; scores: [G][ps];
  // m, l, per-page correction: [G] each.
  return sizeof(float) * (2 * G * Dh + ps * (Dh + 1) + ps * Dh + G * ps +
                          3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int H, int KH, int Dh,
                        int ps, int P, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int KS = Dh + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* qs = smem;            // [G][Dh]  q * scale, in f32
  float* acc = qs + G * Dh;    // [G][Dh]
  float* ks = acc + G * Dh;    // [ps][KS]
  float* vs = ks + ps * KS;    // [ps][Dh]
  float* ss = vs + ps * Dh;    // [G][ps]  scores, then probabilities
  float* ms = ss + G * ps;     // [G]
  float* ls = ms + G;          // [G]
  float* cs = ls + G;          // [G]

  // q (B, 1, H, Dh): head kh * G + g is query row g of this KV head.
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * Dh;
  for (int e = tid; e < G * Dh; e += kThreads) {
    qs[e] = to_f32(qb[e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  const int len = kv_len[b];
  int npages = len > 0 ? (len + ps - 1) / ps : 0;
  if (npages > P) npages = P;  // the table holds P * ps positions at most
  for (int j = 0; j < npages; ++j) {
    const size_t phys = (size_t)page_table[(size_t)b * P + j];
    const int base = j * ps;
    __syncthreads();  // the last page is consumed; q, acc, m, l are set
    for (int e = tid; e < ps * Dh; e += kThreads) {
      const int t = e / Dh, d = e % Dh;
      const size_t off = ((phys * ps + t) * KH + kh) * Dh + d;
      ks[t * KS + d] = to_f32(kp[off]);
      vs[t * Dh + d] = to_f32(vp[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += kThreads) {
      const int g = e / ps, t = e % ps;
      float s = kNegInf;
      if (base + t < len) {
        s = 0.f;
        const float* qg = qs + g * Dh;
        const float* kt = ks + t * KS;
        for (int d = 0; d < Dh; ++d) s = fmaf(qg[d], kt[d], s);
      }
      ss[e] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float* sg = ss + g * ps;
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sg[t]);
      const float m_new = fmaxf(ms[g], mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = base + t < len ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
      const float corr = expf(ms[g] - m_new);
      ls[g] = ls[g] * corr + sum;
      ms[g] = m_new;
      cs[g] = corr;
    }
    __syncthreads();
    for (int e = tid; e < G * Dh; e += kThreads) {
      const int g = e / Dh, d = e % Dh;
      const float* pg = ss + g * ps;
      float a = acc[e] * cs[g];
      for (int t = 0; t < ps; ++t) a = fmaf(pg[t], vs[t * Dh + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kh * G) * Dh;
  for (int e = tid; e < G * Dh; e += kThreads)
    ob[e] = from_f32<T>(acc[e] / fmaxf(ls[e / Dh], 1e-20f));
  for (int g = tid; g < G; g += kThreads) {
    const size_t o = ((size_t)b * KH + kh) * G + g;
    m_out[o] = ms[g];
    l_out[o] = fmaxf(ls[g], 1e-20f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int32_t* page_table, const int32_t* kv_len,
                   void* out, float* m, float* l, int B, int H, int KH,
                   int Dh, int ps, int P, float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(H / KH, Dh, ps);
  auto kernel = paged_decode_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), page_table, kv_len, static_cast<T*>(out), m,
      l, H, KH, Dh, ps, P, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B, 1, H, Dh); k_pages, v_pages (NP, ps, KH, Dh); page_table (B, P) and
// kv_len (B,) int32; out (B, 1, H, Dh) in q's type; m, l (B, 1, KH, G) f32.
// All contiguous and on one device (dtype: 0 = f32, 1 = bf16).  Launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, void* m, void* l,
    int dtype, int B, int H, int KH, int Dh, int ps, int P, float scale,
    void* stream) {
  using namespace repro;
  if (B == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || ps <= 0 || Dh <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pt = static_cast<const int32_t*>(page_table);
  const int32_t* kl = static_cast<const int32_t*>(kv_len);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == kFloat32)
    return launch<float>(q, k_pages, v_pages, pt, kl, out, mf, lf, B, H, KH,
                         Dh, ps, P, scale, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pt, kl, out, mf, lf, B,
                                 H, KH, Dh, ps, P, scale, s);
  return cudaErrorInvalidValue;
}
