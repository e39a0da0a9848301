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
// What bounds it on the card: operations.  A causal prefill of S tokens does
// about 2 * S^2 * H * Dh multiply-adds against 2 * S * (2H + 2KH) * Dh bytes
// of q, k, v and out, hundreds of operations per byte, far above the H100's
// ridge of about 295 bf16 operations per byte.
//
// What the design does about it: one block owns 64 query rows of one head;
// each 32-key K/V tile is staged once in shared memory (as f32, rows padded
// by one word so column reads hit distinct banks) and used by all 64 rows;
// each thread holds a 4 x 2 tile of scores and a 4 x Dh/16 tile of the
// output in registers, so one shared-memory read feeds several multiply-adds;
// masked-out tiles issue no work.  The products run on the f32 pipes, not
// the tensor cores (no wgmma, no TMA yet): simple and exact first, so the
// kernel sits well below the bf16 tensor-core bound.
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

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
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int H, int KH, int causal, int window,
                     int q_offset, float scale) {
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
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KH, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<DH>();
  auto kernel = flash_fwd_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KH, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Skv, int H, int KH,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, KH, causal, window,
                           q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KH, causal, window,
                           q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KH, causal, window,
                           q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KH, causal, window,
                            q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q (B, Sq, H, Dh), k and v (B, Skv, KH, Dh), out (B, Sq, H, Dh): contiguous,
// one element type (dtype: 0 = f32, 1 = bf16).  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int dtype,
                                         int B, int Sq, int Skv, int H,
                                         int KH, int Dh, int causal,
                                         int window, int q_offset,
                                         float scale, void* stream) {
  using namespace repro;
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_dh<float>(Dh, q, k, v, out, B, Sq, Skv, H, KH, causal,
                              window, q_offset, scale, s);
  if (dtype == kBFloat16)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, out, B, Sq, Skv, H, KH,
                                      causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}
