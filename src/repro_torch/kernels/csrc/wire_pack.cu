// The v2 gossip wire: the fused block encode, and the p4 offset pack and
// unpack, for sm_90a.
//
// Replaces src/repro/kernels/wire_pack.py:
//   encode_blocks_pallas (_encode_kernel)  -> encode_kernel
//   pack_offsets_pallas (_pack_p4_kernel)  -> pack_p4_kernel
//   unpack_offsets_pallas (_unpack_p4_kernel) -> unpack_p4_kernel
// bit for bit as kernels/wire_pack.py's plain versions compute them.
//
// encode_kernel, per wire block of wb f32 entries (one thread block each):
//   hi0    = max |x|;  lo, hi = 16 bisection steps on [0, hi0] of the
//            count of |x| > mid against k_b (mid = 0.5 * (lo + hi))
//   keep   = |x| > hi, then the band (|x| > lo, or lo == 0) filled in
//            index order up to exactly k_b kept
//   off    = the kept indices, ascending;  scale = hi0
//   vals   = x at off, as f32 / bf16 (round to nearest even), or of
//            r = x / max(scale, 1e-30): int8 rint(127 r), int4 rint(7 r)
//            as two's-complement nibbles (low nibble first), fp8 e4m3
//            (round to nearest even, saturating)
// pack_p4_kernel, per block of k_b ascending offsets: the low nibbles two
// per byte, then a bitmap with bit (off_i >> 4) + i set (bit b of byte j is
// position 8j + b).  unpack_p4_kernel inverts it: the i-th set bit at
// position p gives off_i = 16 (p - i) + lo_i; ranks past the set bits
// (an all-zero payload) decode to hi = 0, as the Pallas kernel clamps.
//
// Bound: bytes.  The encode reads each f32 entry once and writes k_b
// values, k_b offsets and a scale; pack and unpack read and write a few
// bytes per kept entry.  Design: the encode holds its block's entries in
// shared memory (dynamic, wb * 4 bytes), the bisection counts are exact
// integer block sums, and the fill and the compaction are two block-wide
// prefix sums over contiguous per-thread ranges, so the kept offsets come
// out in index order without a sort.  Each bisection step costs a block
// reduction (two barriers): simple first, to be made fast later.  Pack
// and unpack take one thread block per wire block: pack ORs the bitmap
// together in shared memory (bits never collide, bytes do), unpack ranks
// the set bits with a popcount prefix sum.  f32 arithmetic goes through
// the _rn intrinsics: no FMA contraction, IEEE division.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBisectIters = 16;  // wire_pack.py:43
constexpr int kEncodeThreads = 256;
constexpr int kPackThreads = 128;
constexpr int kMaxWarps = 32;

// Wire value types (kernels/wire_pack.py:WIRE_DTYPES order).
constexpr int kWireF32 = 0;
constexpr int kWireBF16 = 1;
constexpr int kWireInt8 = 2;
constexpr int kWireInt4 = 3;
constexpr int kWireFp8 = 4;

// Sum of one int per thread over the block; every thread gets the total.
__device__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  __syncthreads();  // red is reused by the next call
  return total;
}

// Exclusive prefix sum of one int per thread, in thread order; *total
// gets the block's sum.
__device__ int block_exclusive_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int s = red[w];
    if (w < warp) before += s;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return before + incl - v;
}

// A kept value as the reference's one-hot sum forms it: x + 0, so that a
// kept -0 becomes +0.
__device__ __forceinline__ float kept(const float* xs, int i) {
  return __fadd_rn(xs[i], 0.0f);
}

__device__ __forceinline__ int quant_int(float v, float s, float levels) {
  return static_cast<int>(rintf(__fmul_rn(__fdiv_rn(v, s), levels)));
}

template <int kDtype>
__global__ void __launch_bounds__(kEncodeThreads)
encode_kernel(const float* __restrict__ x, void* __restrict__ vals,
              int* __restrict__ off, float* __restrict__ scale, int wb,
              int k_b) {
  extern __shared__ float xs[];  // the block's wb entries
  __shared__ int red[kMaxWarps];
  __shared__ float redf[kMaxWarps];
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const float* xr = x + blk * wb;

  float vmax = 0.0f;
  for (int i = tid; i < wb; i += kEncodeThreads) {
    const float v = xr[i];
    xs[i] = v;
    vmax = fmaxf(vmax, fabsf(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  if ((tid & 31) == 0) redf[tid >> 5] = vmax;
  __syncthreads();  // also publishes xs
  float hi0 = 0.0f;
  for (int w = 0; w < kEncodeThreads / 32; ++w) hi0 = fmaxf(hi0, redf[w]);

  float lo = 0.0f, hi = hi0;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = tid; i < wb; i += kEncodeThreads) c += fabsf(xs[i]) > mid;
    if (block_sum(c, red) > k_b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  // Each thread walks a contiguous range of the block, so that the two
  // prefix sums below run in index order.
  const int per = (wb + kEncodeThreads - 1) / kEncodeThreads;
  const int i0 = min(tid * per, wb), i1 = min(i0 + per, wb);
  const bool open = lo == 0.0f;  // lo == 0 opens the whole block
  int nprim = 0, nband = 0;
  for (int i = i0; i < i1; ++i) {
    const float a = fabsf(xs[i]);
    const bool prim = a > hi;
    nprim += prim;
    nband += !prim && (a > lo || open);
  }
  const int room = k_b - block_sum(nprim, red);
  int band_total;
  const int band_before = block_exclusive_scan(nband, red, &band_total);
  int nkeep = 0, br = band_before;
  for (int i = i0; i < i1; ++i) {
    const float a = fabsf(xs[i]);
    const bool prim = a > hi;
    const bool band = !prim && (a > lo || open);
    br += band;
    nkeep += prim || (band && br <= room);
  }
  int keep_total;
  int kr = block_exclusive_scan(nkeep, red, &keep_total);
  int* orow = off + blk * k_b;
  br = band_before;
  for (int i = i0; i < i1; ++i) {
    const float a = fabsf(xs[i]);
    const bool prim = a > hi;
    const bool band = !prim && (a > lo || open);
    br += band;
    if ((prim || (band && br <= room)) && kr < k_b) orow[kr++] = i;
  }
  if (tid == 0) scale[blk] = hi0;
  __syncthreads();  // the offsets, written to global memory, are visible

  const float s = fmaxf(hi0, 1e-30f);
  if (kDtype == kWireInt4) {
    const int pairs = (k_b + 1) / 2;
    uint8_t* vr = static_cast<uint8_t*>(vals) + blk * pairs;
    for (int p = tid; p < pairs; p += kEncodeThreads) {
      const int q0 = quant_int(kept(xs, orow[2 * p]), s, 7.0f);
      const int q1 = 2 * p + 1 < k_b
                         ? quant_int(kept(xs, orow[2 * p + 1]), s, 7.0f)
                         : 0;
      vr[p] = static_cast<uint8_t>((q0 & 15) | ((q1 & 15) << 4));
    }
    return;
  }
  for (int j = tid; j < k_b; j += kEncodeThreads) {
    const float v = kept(xs, orow[j]);
    const int64_t o = blk * k_b + j;
    if (kDtype == kWireF32) {
      static_cast<float*>(vals)[o] = v;
    } else if (kDtype == kWireBF16) {
      static_cast<__nv_bfloat16*>(vals)[o] = __float2bfloat16(v);
    } else if (kDtype == kWireInt8) {
      static_cast<int8_t*>(vals)[o] =
          static_cast<int8_t>(quant_int(v, s, 127.0f));
    } else {  // fp8 e4m3, shipped as its bits
      static_cast<uint8_t*>(vals)[o] = static_cast<uint8_t>(
          __nv_cvt_float_to_fp8(__fdiv_rn(v, s), __NV_SATFINITE, __NV_E4M3));
    }
  }
}

__global__ void __launch_bounds__(kPackThreads)
pack_p4_kernel(const int* __restrict__ off, uint8_t* __restrict__ out,
               int k_b, int lo_bytes, int bm_bytes) {
  extern __shared__ unsigned int bm[];  // the bitmap, ceil(bm_bytes / 4)
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int* o = off + blk * k_b;
  uint8_t* dst = out + blk * (lo_bytes + bm_bytes);
  const int words = (bm_bytes + 3) / 4;
  for (int w = tid; w < words; w += kPackThreads) bm[w] = 0u;
  __syncthreads();
  for (int p = tid; p < lo_bytes; p += kPackThreads) {
    const int a = o[2 * p] & 15;
    const int b = 2 * p + 1 < k_b ? (o[2 * p + 1] & 15) : 0;
    dst[p] = static_cast<uint8_t>(a | (b << 4));
  }
  for (int i = tid; i < k_b; i += kPackThreads) {
    const int pos = (o[i] >> 4) + i;
    if (pos >= 0 && pos < 8 * bm_bytes)
      atomicOr(&bm[pos >> 5], 1u << (pos & 31));
  }
  __syncthreads();
  for (int j = tid; j < bm_bytes; j += kPackThreads)
    dst[lo_bytes + j] = static_cast<uint8_t>(bm[j >> 2] >> (8 * (j & 3)));
}

__device__ __forceinline__ int lo_nibble(const uint8_t* src, int i) {
  return (src[i >> 1] >> (4 * (i & 1))) & 15;
}

__global__ void __launch_bounds__(kPackThreads)
unpack_p4_kernel(const uint8_t* __restrict__ packed, int* __restrict__ off,
                 int k_b, int lo_bytes, int bm_bytes) {
  __shared__ int red[kMaxWarps];
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const uint8_t* src = packed + blk * (lo_bytes + bm_bytes);
  const uint8_t* bits = src + lo_bytes;
  int* o = off + blk * k_b;
  const int per = (bm_bytes + kPackThreads - 1) / kPackThreads;
  const int j0 = min(tid * per, bm_bytes), j1 = min(j0 + per, bm_bytes);
  int c = 0;
  for (int j = j0; j < j1; ++j) c += __popc(bits[j]);
  int total;
  int rank = block_exclusive_scan(c, red, &total);
  for (int j = j0; j < j1; ++j) {
    unsigned int b = bits[j];
    while (b) {
      const int pos = 8 * j + __ffs(b) - 1;
      b &= b - 1;
      if (rank < k_b) o[rank] = 16 * max(pos - rank, 0) + lo_nibble(src, rank);
      ++rank;
    }
  }
  for (int i = total + tid; i < k_b; i += kPackThreads)
    o[i] = lo_nibble(src, i);  // no set bit of this rank: hi = 0
}

void p4_sizes(int wb, int k_b, int* lo_bytes, int* bm_bytes) {
  *lo_bytes = (k_b + 1) / 2;
  *bm_bytes = (k_b + (wb + 15) / 16 + 7) / 8;
}

template <int kDtype>
cudaError_t launch_encode(const float* x, void* vals, int* off,
                          float* scale, long long blocks, int wb, int k_b,
                          cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(wb) * sizeof(float);
  cudaError_t err = allow_smem(encode_kernel<kDtype>, smem);
  if (err != cudaSuccess) return err;
  encode_kernel<kDtype><<<static_cast<unsigned>(blocks), kEncodeThreads,
                          smem, stream>>>(x, vals, off, scale, wb, k_b);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// x: (blocks, wb) f32; vals: (blocks, k_b), or (blocks, ceil(k_b / 2)) for
// int4, in the wire dtype's storage type; off: (blocks, k_b) int32; scale:
// (blocks,) f32.  wire_dtype: 0 f32, 1 bf16, 2 int8, 3 int4, 4 fp8.
// Returns a cudaError_t (cudaErrorInvalidValue for arguments the kernel
// does not take).
extern "C" int repro_wire_encode(const void* x, void* vals, void* off,
                                 void* scale, int wire_dtype,
                                 long long blocks, int wb, int k_b,
                                 void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || k_b > wb || blocks < 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  int* o = static_cast<int*>(off);
  float* s = static_cast<float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wire_dtype) {
    case kWireF32:
      return launch_encode<kWireF32>(xf, vals, o, s, blocks, wb, k_b, st);
    case kWireBF16:
      return launch_encode<kWireBF16>(xf, vals, o, s, blocks, wb, k_b, st);
    case kWireInt8:
      return launch_encode<kWireInt8>(xf, vals, o, s, blocks, wb, k_b, st);
    case kWireInt4:
      return launch_encode<kWireInt4>(xf, vals, o, s, blocks, wb, k_b, st);
    case kWireFp8:
      return launch_encode<kWireFp8>(xf, vals, o, s, blocks, wb, k_b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// off: (blocks, k_b) int32 ascending offsets below wb -> out: (blocks,
// ceil(k_b / 2) + ceil((k_b + ceil(wb / 16)) / 8)) uint8.
extern "C" int repro_wire_pack_p4(const void* off, void* out,
                                  long long blocks, int wb, int k_b,
                                  void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || blocks < 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  int lo_bytes, bm_bytes;
  p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
  const size_t smem = ((bm_bytes + 3) / 4) * sizeof(unsigned int);
  cudaError_t err = allow_smem(pack_p4_kernel, smem);
  if (err != cudaSuccess) return err;
  pack_p4_kernel<<<static_cast<unsigned>(blocks), kPackThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(off), static_cast<uint8_t*>(out), k_b,
      lo_bytes, bm_bytes);
  return cudaGetLastError();
}

// packed: (blocks, nbytes) uint8 as repro_wire_pack_p4 writes it -> off:
// (blocks, k_b) int32.
extern "C" int repro_wire_unpack_p4(const void* packed, void* off,
                                    long long blocks, int wb, int k_b,
                                    void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || blocks < 0 || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  int lo_bytes, bm_bytes;
  p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
  unpack_p4_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int*>(off), k_b,
      lo_bytes, bm_bytes);
  return cudaGetLastError();
}
