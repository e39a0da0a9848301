// Block-local top-k compression with fused error feedback (the paper's Q,
// Eq. 7), for sm_90a, over a table of leaves in one launch.
//
// Replaces src/repro/kernels/topk_compress.py:topk_compress_pallas
// (_mask_tile, _kernel, _kernel_ef), which the reference's
// core/compression.py:compress_delta calls once per leaf.  For each leaf
// (R, L), each row r and each block of `block` consecutive entries:
//   v      = f32(x) [+ f32(ef)]
//   k      = clip(ceil(theta[r] * block), 1, block)           (f32)
//   lo, hi = 16 bisection steps on [0, max|v|] of the count of |v| > mid
//   keep   = |v| > lo, or |v| >= max|v| when max|v| == 0
//   masked = keep ? v : +0, cast to x's type
//   resid  = keep ? +0 : v, cast to ef's type (x's without ef)
// bit for bit as the reference computes it (ref.topk_mask_bisect_jnp).
// A leaf whose L is not a multiple of the block ends in a ragged block:
// its entries past L read as +0 and are never written, which is the
// reference's zero pad (compress_delta pads, compresses and slices): a
// zero never counts for mid >= 0, leaves max|v| as it is, and is kept
// only in an all-zero block, where the pad's kept zeros are sliced off.
//
// Bound: bytes.  Each entry is read once (x, ef) and written once (masked,
// resid); the 16 bisection passes touch registers only.  Design: one warp
// per (row, block) of every leaf of the table; a warp finds its leaf by a
// binary search over the leaves' first warp indices, which the launch
// takes as kernel parameters (TopkArgs), so a round's leaves of one type
// pair are one launch and nothing is copied to the device.  Each lane
// holds block / 32 entries in registers, loaded lane-strided (entry j * 32
// + lane) so that every load and store of the warp covers 32 consecutive
// entries.  The block maximum is a shuffle reduction; each bisection step
// counts per lane and sums the counts with __reduce_add_sync, so the
// counts are exact integers as in the reference.  f32 arithmetic goes
// through the _rn intrinsics, so nothing is contracted into an FMA.  A
// warp reads its whole block before it writes it, so masked may be x and
// resid may be ef (the round compresses in place); the data pointers are
// therefore not __restrict__.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBisectIters = 16;  // topk_compress.py:30
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLeaves = 64;    // kernels/topk_compress.py:MAX_LEAVES

// One leaf: (R, L) contiguous x, ef (or null), masked and resid; its
// (row, block) pairs are warps pair0 .. pair0 + R * nb - 1.
struct TopkLeaf {
  const void* x;
  const void* ef;
  void* masked;
  void* resid;
  long long L;
  int pair0;
  int nb;  // blocks a row, ceil(L / block)
};

// One launch (kernels/topk_compress.py:_TopkArgs): 3096 bytes of kernel
// parameters, under the 4 KB every CUDA version takes.  Warp indices are
// 32-bit (the entry refuses more pairs), so that the search and the
// division by nb cost 32-bit registers and instructions.
struct TopkArgs {
  const float* theta;  // (R,) f32
  int R;
  int pairs;  // warps of the launch: the last leaf's pair0 + R * its nb
  int block;
  int nleaves;
  TopkLeaf leaf[kMaxLeaves];
};

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  return to_f32(*p);
}

// Loads a lane's entries j * 32 + lane of the block at x + base (+ ef)
// into v and |v| into mag; returns the lane's largest |v|.  Slots past
// the block hold mag = -1, which no comparison keeps or counts; with
// kRagged, entries from n on read as +0 (the zero pad) and are not
// loaded.
template <typename TX, typename TE, bool kHasEf, int VPL, bool kRagged>
__device__ __forceinline__ float load_block(const TX* x, const TE* ef,
                                            int64_t base, int block, int n,
                                            int lane, float (&v)[VPL],
                                            float (&mag)[VPL]) {
  float vmax = 0.0f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * 32 + lane;
    if (i < block) {
      float e = 0.0f;
      if (!kRagged || i < n) {
        e = load_f32(x + base + i);
        if (kHasEf) e = __fadd_rn(e, load_f32(ef + base + i));
      }
      v[j] = e;
      mag[j] = fabsf(e);
      vmax = fmaxf(vmax, mag[j]);
    } else {
      v[j] = 0.0f;
      mag[j] = -1.0f;
    }
  }
  return vmax;
}

// VPL: entries per lane, a power of two >= block / 32.
template <typename TX, typename TE, typename TR, bool kHasEf, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_compress_kernel(const TopkArgs a) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= a.pairs) return;  // whole warps exit together
  // the leaf: the last one whose first warp is at or before this one
  int lo_l = 0, hi_l = a.nleaves - 1;
  while (lo_l < hi_l) {
    const int mid = (lo_l + hi_l + 1) >> 1;
    if (a.leaf[mid].pair0 <= pair) {
      lo_l = mid;
    } else {
      hi_l = mid - 1;
    }
  }
  const int block = a.block;
  const int64_t L = a.leaf[lo_l].L;
  const int nb = a.leaf[lo_l].nb;
  const int local = pair - a.leaf[lo_l].pair0;
  const int r = local / nb;
  const int b = local - r * nb;
  // rows are contiguous; n entries of the block lie in the row
  const int64_t base = static_cast<int64_t>(r) * L +
                       static_cast<int64_t>(b) * block;
  const int n = b < nb - 1 ? block
                           : static_cast<int>(L - static_cast<int64_t>(b) *
                                                      block);
  const TX* x = static_cast<const TX*>(a.leaf[lo_l].x);
  const TE* ef = static_cast<const TE*>(a.leaf[lo_l].ef);

  float v[VPL];
  float mag[VPL];
  // a whole block loads at fixed offsets from one address, which lets the
  // compiler issue all of a lane's loads at once; the ragged last block of
  // a row takes its own copy of the loop (one loop with the loads under
  // `if (i < n)`, or with clamped addresses, ran markedly slower)
  float vmax = n == block
                   ? load_block<TX, TE, kHasEf, VPL, false>(x, ef, base, block,
                                                            n, lane, v, mag)
                   : load_block<TX, TE, kHasEf, VPL, true>(x, ef, base, block,
                                                           n, lane, v, mag);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
  const float hi0 = vmax;

  const float fblock = static_cast<float>(block);
  const float k = fminf(fmaxf(ceilf(__fmul_rn(a.theta[r], fblock)), 1.0f),
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
  TX* masked = static_cast<TX*>(a.leaf[lo_l].masked);
  TR* resid = static_cast<TR*>(a.leaf[lo_l].resid);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * 32 + lane;
    if (i < n) {
      const bool keep = mag[j] > lo || (zero_block && mag[j] >= hi0);
      masked[base + i] = from_f32<TX>(keep ? v[j] : 0.0f);
      resid[base + i] = from_f32<TR>(keep ? 0.0f : v[j]);
    }
  }
}

template <typename TX, typename TE, typename TR, bool kHasEf>
cudaError_t launch_typed(const TopkArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(
      (a.pairs + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 threads(kWarpsPerBlock * 32);
  const int need = (a.block + 31) / 32;
#define REPRO_TOPK_LAUNCH(V)                                              \
  topk_compress_kernel<TX, TE, TR, kHasEf, V><<<grid, threads, 0, stream>>>(a)
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

// One launch over a table of leaves.  args: a host TopkArgs of args_bytes
// bytes (kernels/topk_compress.py:_TopkArgs), copied into the kernel's
// parameters at the launch; every leaf of it has x of x_dtype {0: f32,
// 1: bf16} and ef of ef_dtype (-1: no ef; else ef's type code, which must
// be x's or f32), all (R, L) contiguous on the device; theta: (R,) f32 on
// the device.  block: a multiple of 32 in [32, 1024]; L need not be a
// multiple of it.  A leaf's nb must be ceil(L / block), the leaves' pair0
// the prefix sums of R * nb, and their total below 2^31 - 8.  Returns a
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not
// take).
extern "C" int repro_topk_compress_leaves(const void* args, int args_bytes,
                                          int x_dtype, int ef_dtype,
                                          void* stream) {
  using namespace repro;
  using bf16 = __nv_bfloat16;
  if (args_bytes != static_cast<int>(sizeof(TopkArgs)))
    return cudaErrorInvalidValue;
  const TopkArgs& a = *static_cast<const TopkArgs*>(args);
  if (a.block < 32 || a.block > 1024 || a.block % 32 || a.R < 0 ||
      a.nleaves < 1 || a.nleaves > kMaxLeaves || a.theta == nullptr)
    return cudaErrorInvalidValue;
  long long pairs = 0;
  for (int l = 0; l < a.nleaves; ++l) {
    const TopkLeaf& f = a.leaf[l];
    if (f.L < 0 || f.pair0 != pairs || f.nb != (f.L + a.block - 1) / a.block ||
        f.x == nullptr || f.masked == nullptr || f.resid == nullptr ||
        (ef_dtype >= 0) != (f.ef != nullptr))
      return cudaErrorInvalidValue;
    pairs += static_cast<long long>(a.R) * f.nb;
    if (pairs > 0x7fffffffLL - kWarpsPerBlock) return cudaErrorInvalidValue;
  }
  if (pairs != a.pairs) return cudaErrorInvalidValue;
  if (pairs == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32 && ef_dtype < 0)
    return launch_typed<float, float, float, false>(a, s);
  if (x_dtype == kFloat32 && ef_dtype == kFloat32)
    return launch_typed<float, float, float, true>(a, s);
  if (x_dtype == kBFloat16 && ef_dtype < 0)
    return launch_typed<bf16, bf16, bf16, false>(a, s);
  if (x_dtype == kBFloat16 && ef_dtype == kBFloat16)
    return launch_typed<bf16, bf16, bf16, true>(a, s);
  if (x_dtype == kBFloat16 && ef_dtype == kFloat32)
    return launch_typed<bf16, float, float, true>(a, s);
  return cudaErrorInvalidValue;
}
