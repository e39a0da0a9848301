// Block-local top-k compression with fused error feedback (the paper's Q,
// Eq. 7), for sm_90a.
//
// Replaces src/repro/kernels/topk_compress.py:topk_compress_pallas
// (_mask_tile, _kernel, _kernel_ef).  For each row r and each block of
// `block` consecutive entries of x (R, L):
//   v      = f32(x) [+ f32(ef)]
//   k      = clip(ceil(theta[r] * block), 1, block)           (f32)
//   lo, hi = 16 bisection steps on [0, max|v|] of the count of |v| > mid
//   keep   = |v| > lo, or |v| >= max|v| when max|v| == 0
//   masked = keep ? v : +0, cast to x's type
//   resid  = keep ? +0 : v, cast to ef's type (x's without ef)
// bit for bit as the reference computes it (ref.topk_mask_bisect_jnp).
//
// Bound: bytes.  Each entry is read once (x, ef) and written once (masked,
// resid); the 16 bisection passes touch registers only.  Design: one warp
// per (row, block).  Each lane holds block / 32 entries in registers,
// loaded lane-strided (entry j * 32 + lane) so that every load and store of
// the warp covers 32 consecutive entries.  The block maximum is a shuffle
// reduction; each bisection step counts per lane and sums the counts with
// __reduce_add_sync, so the counts are exact integers as in the reference.
// f32 arithmetic goes through the _rn intrinsics, so nothing is contracted
// into an FMA.  A warp reads its whole block before it writes it, so masked
// may be x and resid may be ef (the round compresses in place); the data
// pointers are therefore not __restrict__.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBisectIters = 16;  // topk_compress.py:30
constexpr int kWarpsPerBlock = 8;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return to_f32(*p);
}

// VPL: entries per lane, a power of two >= block / 32; lanes' slots past
// the block hold mag = -1, which no comparison below keeps or counts.
template <typename TX, typename TE, typename TR, bool kHasEf, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_compress_kernel(const TX* x, const TE* ef,
                     const float* __restrict__ theta, TX* masked, TR* resid,
                     int64_t R, int64_t L, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t nb = L / block;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= R * nb) return;  // whole warps exit together
  const int64_t r = pair / nb;
  const int64_t base = pair * block;  // rows are contiguous: r * L + b * block

  float v[VPL];
  float mag[VPL];
  float vmax = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * 32 + lane;
    if (i < block) {
      float a = load_f32(x + base + i);
      if (kHasEf) a = __fadd_rn(a, load_f32(ef + base + i));
      v[j] = a;
      mag[j] = fabsf(a);
      vmax = fmaxf(vmax, mag[j]);
    } else {
      v[j] = 0.0f;
      mag[j] = -1.0f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
  const float hi0 = vmax;

  const float fblock = static_cast<float>(block);
  const float k = fminf(fmaxf(ceilf(__fmul_rn(theta[r], fblock)), 1.0f),
                        fblock);
  float lo = 0.0f, hi = hi0;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
#pragma unroll
    for (int j = 0; j < VPL; ++j) c += mag[j] > mid;
    const float cnt = static_cast<float>(__reduce_add_sync(0xffffffffu, c));
    if (cnt > k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  const bool zero_block = hi0 == 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * 32 + lane;
    if (i < block) {
      const bool keep = mag[j] > lo || (zero_block && mag[j] >= hi0);
      masked[base + i] = from_f32<TX>(keep ? v[j] : 0.0f);
      resid[base + i] = from_f32<TR>(keep ? 0.0f : v[j]);
    }
  }
}

template <typename TX, typename TE, typename TR, bool kHasEf>
cudaError_t launch_typed(const void* x, const void* ef, const float* theta,
                         void* masked, void* resid, int64_t R, int64_t L,
                         int block, cudaStream_t stream) {
  const int64_t pairs = R * (L / block);
  const dim3 grid(static_cast<unsigned>(
      (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 threads(kWarpsPerBlock * 32);
  const int need = (block + 31) / 32;
#define REPRO_TOPK_LAUNCH(V)                                              \
  topk_compress_kernel<TX, TE, TR, kHasEf, V><<<grid, threads, 0, stream>>>( \
      static_cast<const TX*>(x), static_cast<const TE*>(ef), theta,       \
      static_cast<TX*>(masked), static_cast<TR*>(resid), R, L, block)
  if (need <= 1) {
    REPRO_TOPK_LAUNCH(1);
  } else if (need <= 2) {
    REPRO_TOPK_LAUNCH(2);
  } else if (need <= 4) {
    REPRO_TOPK_LAUNCH(4);
  } else if (need <= 8) {
    REPRO_TOPK_LAUNCH(8);
  } else if (need <= 16) {
    REPRO_TOPK_LAUNCH(16);
  } else {
    REPRO_TOPK_LAUNCH(32);
  }
#undef REPRO_TOPK_LAUNCH
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x, ef, masked, resid: (R, L) contiguous; theta: (R,) f32 on the device.
// x_dtype in {0: f32, 1: bf16}; ef_dtype -1 (no ef), or ef's type code,
// which must be x's or f32.  block: a multiple of 32 in [32, 1024] that
// divides L.  Returns a cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int repro_topk_compress(const void* x, const void* ef,
                                   const void* theta, void* masked,
                                   void* resid, int x_dtype, int ef_dtype,
                                   long long R, long long L, int block,
                                   void* stream) {
  using namespace repro;
  using bf16 = __nv_bfloat16;
  if (block < 32 || block > 1024 || block % 32 || L % block || R < 0)
    return cudaErrorInvalidValue;
  if (R == 0 || L == 0) return cudaSuccess;
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && ef_dtype < 0)
    return launch_typed<float, float, float, false>(x, ef, th, masked, resid,
                                                    R, L, block, s);
  if (x_dtype == kFloat32 && ef_dtype == kFloat32)
    return launch_typed<float, float, float, true>(x, ef, th, masked, resid,
                                                   R, L, block, s);
  if (x_dtype == kBFloat16 && ef_dtype < 0)
    return launch_typed<bf16, bf16, bf16, false>(x, ef, th, masked, resid, R,
                                                 L, block, s);
  if (x_dtype == kBFloat16 && ef_dtype == kBFloat16)
    return launch_typed<bf16, bf16, bf16, true>(x, ef, th, masked, resid, R,
                                                L, block, s);
  if (x_dtype == kBFloat16 && ef_dtype == kFloat32)
    return launch_typed<bf16, float, float, true>(x, ef, th, masked, resid,
                                                  R, L, block, s);
  return cudaErrorInvalidValue;
}
