// The v2 gossip wire on sm_90a: the block encode, the p4 offset pack and
// unpack, and the gossip's decode-and-mix.
//
// Replaces src/repro/kernels/wire_pack.py:
//   encode_blocks_pallas (:343, _encode_kernel) -> encode_warp_kernel
//                                                   (wb <= 1024), encode_kernel
//   pack_offsets_pallas (:244, _pack_p4_kernel)  -> the encodes' p4 epilogue
//                                                   (on the gossip path), and
//                                                   pack_p4_warp_kernel
//                                                   (wb <= 1024), pack_p4_kernel
//   unpack_offsets_pallas (:264, _unpack_p4_kernel) -> unpack_p4_warp_kernel
//                                                   (wb <= 1024),
//                                                   unpack_p4_kernel
// bit for bit as kernels/wire_pack.py's plain versions compute them.
// decode_mix_kernel has no TPU counterpart: the reference decodes in jnp
// (dist/collectives.py:642 wire_decode, kernels/wire_pack.py:143
// dequantize_vals_jnp) and mixes with jnp adds.  It holds the p4 unpack's
// logic and is bit for bit kernels/wire_pack.py:decode_mix_plain.
//
// The encode, per wire block of wb f32 entries:
//   hi0    = max |x|;  lo, hi = 16 bisection steps on [0, hi0] of the
//            count of |x| > mid against k_b (mid = 0.5 * (lo + hi))
//   keep   = |x| > hi, then the band (|x| > lo, or lo == 0) filled in
//            index order up to exactly k_b kept
//   off    = the kept indices, ascending;  scale = hi0
//   vals   = x at off, as f32 / bf16 (round to nearest even), or of
//            r = x / max(scale, 1e-30): int8 rint(127 r), int4 rint(7 r)
//            as two's-complement nibbles (low nibble first), fp8 e4m3
//            (round to nearest even, saturating)
// It reads its sender rows where they lie (row indices by value); entries
// past the row's length L read as +0, as the zero pad of the plain version.
// It writes the offsets in one of three forms (kOff*): int32, uint8 (wb <=
// 256), or the p4 bytes the pack makes of them, with no int32 offsets in
// device memory (the CTA-per-block encode keeps them in a scratch row and
// packs them after its last barrier; it writes no u8).
// The p4 pack, per block of k_b ascending offsets: the low nibbles two per
// byte, then a bitmap with bit (off_i >> 4) + i set (bit b of byte j is
// position 8j + b).  The unpack inverts it: the i-th set bit at position p
// gives off_i = 16 (p - i) + lo_i; ranks past the set bits (an all-zero
// payload, or a bitmap with fewer than k_b set bits) decode to hi = 0, as
// the Pallas kernel clamps; set bits past the k_b-th are not read.
// decode_mix_kernel, per destination row c and wire block, for each step
// (a band offset o and one plan's payload) in order:
//   y_c <- y_c + coef_c * decode(payload row of cluster (c - o) mod C)
// over every entry of the block, y first diag_c * means_c where asked.
//
// Bound: bytes.  The encode reads each f32 entry once and writes k_b
// values, k_b offsets and a scale (at the main path's chunk, 16.8 MB read
// for 4096 blocks: 5 us at 3.35 TB/s).  The decode-and-mix reads y (or the
// means) once, the payloads once, and writes y once.  The unpack reads a
// block's p4 bytes and writes its k_b int32 offsets (at k_b 615, 393 bytes
// in and 2460 out), the pack the other way round.  Design: the encode
// gives each wire block one warp, eight blocks a CTA, with the block's
// entries in registers (lane l holds entries 32 r + l, so loads coalesce
// and the rounds run in index order); max |x| and the 16 bisection counts
// are warp shuffles and __reduce_add_sync (no barrier, no shared memory);
// the band fill and the compaction are __ballot_sync and popcounts over
// the rounds in ascending order, so the offsets come out ascending without
// a scan, and each kept value is quantized in the same pass (int4 pairs
// its nibbles through the warp's share of shared memory).  In p4 form the
// same pass puts each kept offset's low nibble into the warp's shared
// bytes and sets its bit (off >> 4) + pos of the warp's shared bitmap
// (the bits rise strictly, so none collide; a word's bits are ORed by
// shared atomics); after a __syncwarp the warp writes the block's p4
// bytes (p4_store): the pack costs no launch, and no int32 offset goes
// through device memory (at k_b 615 a block's 2460 offset bytes written
// and read again become its 393 p4 bytes written once).  Blocks beyond
// the registers (wb > 1024) keep the CTA-per-block encode_kernel, whose 16
// bisection steps are block reductions.  The standalone pack and unpack
// also give a wire block of wb <= 1024 one warp, eight blocks a CTA, and
// no CTA barrier.  The pack reads the block's int32 offsets coalesced,
// builds the nibbles and the bitmap in the warp's shared memory as the
// encode's epilogue does, and writes them with the same p4_store.  The
// unpack copies the block's p4 bytes into the warp's shared memory with
// the 16-byte loads that cover them (a block starts at any byte), gives
// each lane a contiguous run of the bitmap's 32-bit words, ranks the set
// bits by a popcount and a 5-step __shfl_up_sync scan, and lets each lane
// walk its own bits (__ffs), writing each rank's offset into a row in
// shared memory laid out at the output's 16-byte phase; after a
// __syncwarp the warp stores the row with 16-byte stores (scalar ones at
// its two ends).  Wider blocks keep one CTA a block: the pack ORs the
// bitmap together in shared memory, the unpack ranks the set bits with a
// block-wide popcount prefix sum.  The decode-and-mix replaces the
// chain of zero fills, rolls, unpack, dequantize, scatter and mix (about
// 30 launches and 7 dense passes a step): one CTA per (row, block) keeps
// y's tile in shared memory, scatters each step's decoded values into a
// zeroed tile (the p4 ranks by a popcount prefix sum) and adds coef * tile
// to every entry, as the dense add of the plain version does.  Its steps
// and coefficients are kernel parameters, so a chunk copies nothing from
// the host.  f32 arithmetic goes through the _rn intrinsics: no FMA
// contraction, IEEE division.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// The warp encode: a lane holds kWarpRounds entries of its block
// (kernels/wire_pack.py:WARP_ENCODE_MAX), kEncodeWarps blocks a CTA.
constexpr int kWarpRounds = 32;
constexpr int kWarpEncodeMax = 32 * kWarpRounds;
// words of a p4 bitmap at wb <= kWarpEncodeMax: k_b + ceil(wb / 16) bits
constexpr int kP4Words = (kWarpEncodeMax + kWarpEncodeMax / 16 + 31) / 32;
constexpr int kEncodeWarps = 8;
constexpr int kMaxEncodeRows = 32;  // sender rows a launch (wire_pack.py)

// The warp pack and unpack (wb <= kWarpEncodeMax): kP4Warps blocks a CTA.
constexpr int kP4Warps = 8;
// p4 bytes of a block at most, and the 16-byte chunks that cover them
// from any starting byte
constexpr int kP4MaxBytes =
    kWarpEncodeMax / 2 + (kWarpEncodeMax + kWarpEncodeMax / 16 + 7) / 8;
constexpr int kP4StageChunks = (kP4MaxBytes + 30) / 16 + 1;
// the unpack's row of k_b int32 offsets at any 16-byte phase, in chunks
constexpr int kP4RowChunks = (kWarpEncodeMax + 3 + 3) / 4;
// bitmap words a lane walks at most: a contiguous run of kP4Words / 32
constexpr int kP4LaneWords = (kP4Words + 31) / 32;

// The decode-and-mix (kernels/wire_pack.py:_MixArgs).
constexpr int kMixThreads = 128;
constexpr int kMixSteps = 8;
constexpr int kMixRows = 32;

// Wire value types (kernels/wire_pack.py:WIRE_DTYPES order), then the
// dense plans' row types.
constexpr int kWireF32 = 0;
constexpr int kWireBF16 = 1;
constexpr int kWireInt8 = 2;
constexpr int kWireInt4 = 3;
constexpr int kWireFp8 = 4;
constexpr int kDenseF32 = 5;
constexpr int kDenseBF16 = 6;
constexpr int kDenseF16 = 7;

// Offset encodings (kernels/wire_pack.py:_OFF_CODE).
constexpr int kOffI32 = 0;
constexpr int kOffI16 = 1;
constexpr int kOffU8 = 2;
constexpr int kOffP4 = 3;

// 227 KB a block, less room for the kernels' static shared memory
constexpr size_t kMaxSmem = 232448 - 1024;

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

// Bytes of a block's p4 offsets: the low nibbles, then the bitmap.
__host__ __device__ inline void p4_sizes(int wb, int k_b, int* lo_bytes,
                                         int* bm_bytes) {
  *lo_bytes = (k_b + 1) / 2;
  *bm_bytes = (k_b + (wb + 15) / 16 + 7) / 8;
}

// Writes a block's p4 bytes from the warp's shared nibbles (one byte an
// offset, k_b of them) and bitmap words: the whole warp calls it, after a
// __syncwarp.  Consecutive lanes write consecutive bytes.
__device__ __forceinline__ void p4_store(const uint8_t* onib,
                                         const unsigned int* bm, int k_b,
                                         int lo_bytes, int bm_bytes,
                                         uint8_t* dst, int lane) {
  for (int p = lane; p < lo_bytes; p += 32) {
    const int n0 = onib[2 * p];
    const int n1 = 2 * p + 1 < k_b ? onib[2 * p + 1] : 0;
    dst[p] = static_cast<uint8_t>(n0 | (n1 << 4));
  }
  for (int j = lane; j < bm_bytes; j += 32)
    dst[lo_bytes + j] = static_cast<uint8_t>(bm[j >> 2] >> (8 * (j & 3)));
}

__device__ __forceinline__ int quant_int(float v, float s, float levels) {
  return static_cast<int>(rintf(__fmul_rn(__fdiv_rn(v, s), levels)));
}

// Stores kept entry number pos of wire block g, value v (already x + 0,
// so that a kept -0 ships as +0 as the reference's one-hot sum gives it);
// int4 leaves its nibble in nib for the caller to pair.
template <int kDtype>
__device__ __forceinline__ void put_value(void* vals, int64_t g, int k_b,
                                          int pos, float v, float s,
                                          uint8_t* nib) {
  const int64_t o = g * k_b + pos;
  if (kDtype == kWireF32) {
    static_cast<float*>(vals)[o] = v;
  } else if (kDtype == kWireBF16) {
    static_cast<__nv_bfloat16*>(vals)[o] = __float2bfloat16(v);
  } else if (kDtype == kWireInt8) {
    static_cast<int8_t*>(vals)[o] = static_cast<int8_t>(quant_int(v, s, 127.0f));
  } else if (kDtype == kWireInt4) {
    nib[pos] = static_cast<uint8_t>(quant_int(v, s, 7.0f) & 15);
  } else {  // fp8 e4m3, shipped as its bits
    static_cast<uint8_t*>(vals)[o] = static_cast<uint8_t>(
        __nv_cvt_float_to_fp8(__fdiv_rn(v, s), __NV_SATFINITE, __NV_E4M3));
  }
}

// The rows an encode launch reads: row idx[i] of x starts idx[i] *
// row_stride floats in; a row has L entries and nb = ceil(L / wb) wire
// blocks.  Output block g = i * nb + b.
struct EncodeRows {
  long long L;
  long long row_stride;
  int nb;
  int n;
  int idx[kMaxEncodeRows];
};

// At most 64 registers a thread, so that 4 CTAs (32 warps) fit an SM and
// the main path's 4096 blocks run in one wave.  Offsets go to off (int32,
// kOffI32) or to packed (uint8 kOffU8, or the p4 bytes kOffP4).
template <int kDtype, int kOmode>
__global__ void __launch_bounds__(kEncodeWarps * 32, 4)
encode_warp_kernel(const float* __restrict__ x, const EncodeRows rows,
                   void* __restrict__ vals, int* __restrict__ off,
                   uint8_t* __restrict__ packed, float* __restrict__ scale,
                   int wb, int k_b) {
  // int4: the kept nibbles of each warp's block, paired after the fill
  __shared__ uint8_t nib_all[kDtype == kWireInt4 ? kEncodeWarps : 1]
                            [kWarpEncodeMax];
  // p4: the kept offsets' low nibbles and the bitmap of each warp's block
  __shared__ uint8_t onib_all[kOmode == kOffP4 ? kEncodeWarps : 1]
                             [kWarpEncodeMax];
  __shared__ unsigned int bm_all[kOmode == kOffP4 ? kEncodeWarps : 1]
                                [kP4Words];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kEncodeWarps + warp;
  if (g >= static_cast<int64_t>(rows.n) * rows.nb) return;  // whole warps
  const int i = static_cast<int>(g / rows.nb);
  const int64_t b = g - static_cast<int64_t>(i) * rows.nb;
  const float* xr = x + rows.idx[i] * rows.row_stride + b * wb;
  const int64_t left = rows.L - b * wb;  // entries of the block in the row

  // lane l holds entries 32 r + l; past wb nothing (never counted, never
  // kept), past the row's end +0 (counted as the zero pad is)
  float v[kWarpRounds];
  float vmax = 0.0f;
#pragma unroll
  for (int r = 0; r < kWarpRounds; ++r) {
    const int e = 32 * r + lane;
    v[r] = 0.0f;
    if (32 * r < wb && e < wb && e < left) v[r] = xr[e];
    vmax = fmaxf(vmax, fabsf(v[r]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  const float hi0 = vmax;
  if (lane == 0) scale[g] = hi0;  // written now: one pointer less live

  // mid >= 0 and hi >= 0, so the empty lanes' zeros never count: the
  // counts need no guard
  float lo = 0.0f, hi = hi0;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c[4] = {0, 0, 0, 0};  // four chains of adds, not one
#pragma unroll
    for (int r = 0; r < kWarpRounds; ++r) c[r & 3] += fabsf(v[r]) > mid;
    if (__reduce_add_sync(0xffffffffu, (c[0] + c[1]) + (c[2] + c[3])) >
        k_b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }

  int nprim = 0;
#pragma unroll
  for (int r = 0; r < kWarpRounds; ++r) nprim += fabsf(v[r]) > hi;
  const int room = k_b - __reduce_add_sync(0xffffffffu, nprim);
  const bool open = lo == 0.0f;  // lo == 0 opens the whole block
  const float s = fmaxf(hi0, 1e-30f);
  const unsigned int below = (1u << lane) - 1u;
  uint8_t* nib = nib_all[kDtype == kWireInt4 ? warp : 0];
  uint8_t* onib = onib_all[kOmode == kOffP4 ? warp : 0];
  unsigned int* bm = bm_all[kOmode == kOffP4 ? warp : 0];
  if (kOmode == kOffP4) {
    for (int w = lane; w < kP4Words; w += 32) bm[w] = 0u;
    __syncwarp();
  }
  int nband = 0, nkept = 0;  // band members and kept entries so far
#pragma unroll
  for (int r = 0; r < kWarpRounds; ++r) {
    if (32 * r >= wb) break;
    const int e = 32 * r + lane;
    const float a = fabsf(v[r]);
    const bool prim = a > hi;
    const bool band = e < wb && !prim && (a > lo || open);
    const unsigned int bmask = __ballot_sync(0xffffffffu, band);
    const bool keep =
        prim || (band && nband + __popc(bmask & below) + 1 <= room);
    const unsigned int kmask = __ballot_sync(0xffffffffu, keep);
    const int pos = nkept + __popc(kmask & below);
    if (keep && pos < k_b) {
      if (kOmode == kOffI32) {
        off[g * k_b + pos] = e;
      } else if (kOmode == kOffU8) {
        packed[g * k_b + pos] = static_cast<uint8_t>(e);
      } else {  // p4: e < wb and pos < k_b, so the bit is in the bitmap
        onib[pos] = static_cast<uint8_t>(e & 15);
        const int bit = (e >> 4) + pos;
        atomicOr(&bm[bit >> 5], 1u << (bit & 31));
      }
      put_value<kDtype>(vals, g, k_b, pos, __fadd_rn(v[r], 0.0f), s, nib);
    }
    nband += __popc(bmask);
    nkept += __popc(kmask);
  }
  if (kDtype == kWireInt4 || kOmode == kOffP4) __syncwarp();
  if (kDtype == kWireInt4) {
    const int pairs = (k_b + 1) / 2;
    uint8_t* vr = static_cast<uint8_t*>(vals) + g * pairs;
    for (int p = lane; p < pairs; p += 32) {
      const int q0 = nib[2 * p];
      const int q1 = 2 * p + 1 < k_b ? nib[2 * p + 1] : 0;
      vr[p] = static_cast<uint8_t>(q0 | (q1 << 4));
    }
  }
  if (kOmode == kOffP4) {
    int lo_bytes, bm_bytes;
    p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
    p4_store(onib, bm, k_b, lo_bytes, bm_bytes,
             packed + g * (lo_bytes + bm_bytes), lane);
  }
}

// The encode for blocks beyond a warp's registers: one CTA a block, the
// entries in shared memory, each bisection step a block reduction.  The
// int32 offsets always go to off (in p4 form a scratch row), and packed
// gets their p4 form after the last barrier.  Its blocks are wider than
// u8 offsets reach (wb <= 256), so it has no u8 form.
template <int kDtype, int kOmode>
__global__ void __launch_bounds__(kEncodeThreads)
encode_kernel(const float* __restrict__ x, const EncodeRows rows,
              void* __restrict__ vals, int* __restrict__ off,
              uint8_t* __restrict__ packed, float* __restrict__ scale, int wb,
              int k_b) {
  static_assert(kOmode == kOffI32 || kOmode == kOffP4,
                "the CTA-per-block encode writes int32 or p4 offsets");
  extern __shared__ float xs[];  // the block's wb entries
  __shared__ int red[kMaxWarps];
  __shared__ float redf[kMaxWarps];
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int row = static_cast<int>(blk / rows.nb);
  const int64_t b = blk - static_cast<int64_t>(row) * rows.nb;
  const float* xr = x + rows.idx[row] * rows.row_stride + b * wb;
  const int64_t left = rows.L - b * wb;

  float vmax = 0.0f;
  for (int i = tid; i < wb; i += kEncodeThreads) {
    const float v = i < left ? xr[i] : 0.0f;
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
      const int q0 = quant_int(__fadd_rn(xs[orow[2 * p]], 0.0f), s, 7.0f);
      const int q1 =
          2 * p + 1 < k_b
              ? quant_int(__fadd_rn(xs[orow[2 * p + 1]], 0.0f), s, 7.0f)
              : 0;
      vr[p] = static_cast<uint8_t>((q0 & 15) | ((q1 & 15) << 4));
    }
  } else {
    for (int j = tid; j < k_b; j += kEncodeThreads)
      put_value<kDtype>(vals, blk, k_b, j, __fadd_rn(xs[orow[j]], 0.0f), s,
                        nullptr);
  }
  if (kOmode != kOffP4) return;
  // p4: the bitmap goes into xs's first words, which nothing reads now
  // (ceil(bm_bytes / 4) <= wb)
  int lo_bytes, bm_bytes;
  p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
  unsigned int* bm = reinterpret_cast<unsigned int*>(xs);
  __syncthreads();  // every value is read out of xs
  for (int w = tid; w < (bm_bytes + 3) / 4; w += kEncodeThreads) bm[w] = 0u;
  __syncthreads();
  uint8_t* dst = packed + blk * (lo_bytes + bm_bytes);
  for (int p = tid; p < lo_bytes; p += kEncodeThreads) {
    const int n0 = orow[2 * p] & 15;
    const int n1 = 2 * p + 1 < k_b ? (orow[2 * p + 1] & 15) : 0;
    dst[p] = static_cast<uint8_t>(n0 | (n1 << 4));
  }
  for (int i = tid; i < k_b; i += kEncodeThreads) {
    const int bit = (orow[i] >> 4) + i;
    atomicOr(&bm[bit >> 5], 1u << (bit & 31));
  }
  __syncthreads();
  for (int j = tid; j < bm_bytes; j += kEncodeThreads)
    dst[lo_bytes + j] = static_cast<uint8_t>(bm[j >> 2] >> (8 * (j & 3)));
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

// The warp pack: one warp a block of k_b <= wb <= kWarpEncodeMax
// offsets, kP4Warps blocks a CTA, a round of 32 offsets at a time.  The
// lanes of a round whose bits fall in one bitmap word OR them together
// (__match_any_sync, __reduce_or_sync; a valid block's bits rise
// strictly, so a round's 32 bits fill two or three words) and the
// lowest of them ORs the result into the warp's shared word by one
// atomic; any input is ORed as the plain version's scatter of ones does,
// a position outside the bitmap is dropped, and p4_store writes the
// bytes.
__global__ void __launch_bounds__(kP4Warps * 32)
pack_p4_warp_kernel(const int* __restrict__ off, uint8_t* __restrict__ out,
                    int blocks, int k_b, int lo_bytes, int bm_bytes) {
  __shared__ uint8_t onib_all[kP4Warps][kWarpEncodeMax];
  __shared__ unsigned int bm_all[kP4Warps][kP4Words];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // blockIdx.x < 2^28, so the block index fits 32 bits
  const unsigned int blk = blockIdx.x * kP4Warps + warp;
  if (blk >= static_cast<unsigned int>(blocks)) return;  // whole warps
  const int* o = off + static_cast<int64_t>(blk) * k_b;
  uint8_t* onib = onib_all[warp];
  unsigned int* bm = bm_all[warp];
  for (int w = lane; w < kP4Words; w += 32) bm[w] = 0u;
  __syncwarp();
  const int nbits = 8 * bm_bytes;
  // every load first, so that they are in flight together: lane l holds
  // offsets 32 r + l, as the encode holds its entries
  int v[kWarpRounds];
#pragma unroll
  for (int r = 0; r < kWarpRounds; ++r)
    v[r] = 32 * r + lane < k_b ? o[32 * r + lane] : 0;
#pragma unroll
  for (int r = 0; r < kWarpRounds; ++r) {  // whole warps: the lanes vote
    if (32 * r >= k_b) break;
    const int i = 32 * r + lane;
    const int pos = (v[r] >> 4) + i;
    const bool in = i < k_b && pos >= 0 && pos < nbits;
    if (i < k_b) onib[i] = static_cast<uint8_t>(v[r] & 15);
    const int word = in ? pos >> 5 : -1;
    const unsigned int same = __match_any_sync(0xffffffffu, word);
    const unsigned int bits =
        __reduce_or_sync(same, in ? 1u << (pos & 31) : 0u);
    if (in && lane == __ffs(same) - 1) atomicOr(&bm[word], bits);
  }
  __syncwarp();
  p4_store(onib, bm, k_b, lo_bytes, bm_bytes,
           out + static_cast<int64_t>(blk) * (lo_bytes + bm_bytes), lane);
}

// Word w of a bitmap of bm_bytes bytes (little-endian; bytes past the end
// read 0).
__device__ __forceinline__ unsigned int bm_word(const uint8_t* bits,
                                                int bm_bytes, int w) {
  unsigned int v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * w + j < bm_bytes)
      v |= static_cast<unsigned int>(bits[4 * w + j]) << (8 * j);
  return v;
}

// The warp unpack: one warp a block of k_b <= wb <= kWarpEncodeMax,
// kP4Warps blocks a CTA.  The block's bytes start anywhere (blk * nbytes):
// the warp copies the 16-byte chunks that hold them into its stage, which
// reads at most 15 bytes either side of the block; a 16-byte aligned
// chunk never crosses a page, and the page holds the block's own bytes.
// Lane l walks the bitmap words [l nwords / 32, (l + 1) nwords / 32).  The
// warp's row holds entry i at int (a + i), a the output row's int32 phase
// in its 16 bytes, so that chunk q of the row is the aligned 16 bytes at
// out_row - a + 4 q.
__global__ void __launch_bounds__(kP4Warps * 32)
unpack_p4_warp_kernel(const uint8_t* __restrict__ packed,
                      int* __restrict__ off, int blocks, int k_b,
                      int lo_bytes, int bm_bytes) {
  __shared__ uint4 stage_all[kP4Warps][kP4StageChunks];
  __shared__ int4 row_all[kP4Warps][kP4RowChunks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned int blk = blockIdx.x * kP4Warps + warp;
  if (blk >= static_cast<unsigned int>(blocks)) return;  // whole warps
  const int nbytes = lo_bytes + bm_bytes;
  const uint8_t* src = packed + static_cast<int64_t>(blk) * nbytes;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const uint4* gsrc = reinterpret_cast<const uint4*>(sa & ~uintptr_t(15));
  const int head = static_cast<int>(sa & 15);
  uint4* stage = stage_all[warp];
  for (int q = lane; q < (head + nbytes + 15) >> 4; q += 32)
    stage[q] = __ldg(gsrc + q);
  int* out = off + static_cast<int64_t>(blk) * k_b;
  const int a = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  int* row = reinterpret_cast<int*>(row_all[warp]) + a;
  __syncwarp();

  const uint8_t* lo = reinterpret_cast<const uint8_t*>(stage) + head;
  const uint8_t* bits = lo + lo_bytes;
  const int nwords = (bm_bytes + 3) >> 2;  // <= kP4Words
  const int w0 = (lane * nwords) >> 5, nw = (((lane + 1) * nwords) >> 5) - w0;
  unsigned int words[kP4LaneWords];
  int c = 0;
#pragma unroll
  for (int j = 0; j < kP4LaneWords; ++j) {
    words[j] = j < nw ? bm_word(bits, bm_bytes, w0 + j) : 0u;
    c += __popc(words[j]);
  }
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int rank = incl - c;
#pragma unroll
  for (int j = 0; j < kP4LaneWords; ++j) {
    unsigned int b = words[j];
    while (b != 0u && rank < k_b) {
      const int pos = 32 * (w0 + j) + __ffs(b) - 1;
      b &= b - 1u;
      row[rank] = 16 * max(pos - rank, 0) + lo_nibble(lo, rank);
      ++rank;
    }
  }
  for (int i = total + lane; i < k_b; i += 32)
    row[i] = lo_nibble(lo, i);  // no set bit of this rank: hi = 0
  __syncwarp();

  const int4* rows = row_all[warp];
  int4* gout = reinterpret_cast<int4*>(out - a);
  for (int q = lane; q < (a + k_b + 3) >> 2; q += 32) {
    const int e0 = 4 * q - a;  // the entry of the chunk's first int
    if (e0 >= 0 && e0 + 4 <= k_b) {
      gout[q] = rows[q];
    } else {
      for (int e = max(e0, 0); e < min(e0 + 4, k_b); ++e) out[e] = row[e];
    }
  }
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

// One term of the mix: a plan's payload under one band offset.  For
// destination row c0 + i, row[i] is the payload row its source cluster
// sends (-1: none, a zero payload) and coef[i] its coefficient.
struct MixStep {
  const void* vals;    // wire values (m, nb, k_b | ceil(k_b / 2)), or the
                       // dense plan's rows (m, Lc)
  const void* off;     // (m, nb, k_b) int32 / int16, or (m, nb, off_bytes)
                       // uint8 (u8, p4)
  const float* scale;  // (m, nb) f32, or null (f32, bf16, dense)
  int vtype;           // kWire* or kDense*
  int omode;           // kOff*
  int k_b;
  int off_bytes;       // a block's packed offset bytes (u8, p4)
  float coef[kMixRows];
  int row[kMixRows];
};

struct MixArgs {
  float* y;            // (rows, Lc) f32 out, row stride y_stride
  const float* src;    // (rows, Lc) f32 in: y = src, or diag * src
  long long y_stride;
  long long src_stride;
  long long Lc;        // columns
  int nb;              // wire blocks a row, ceil(Lc / wb)
  int wb;
  int c0;              // first destination row of this launch
  int nrows;           // destination rows (blockIdx.y)
  int nsteps;
  int scaled;          // y = diag * src first
  int ys_shared;       // set by the entry: y's tile fits in shared memory
  int vec;             // set by the entry: y moves as float4
  float diag[kMixRows];
  MixStep step[kMixSteps];
};

// Dequantized value i of a wire block, as dequantize_vals forms it: f
// is the block's scale s (fp8), s / 127 (int8) or s / 7 (int4).
__device__ __forceinline__ float wire_value(const void* vals, int vtype,
                                            int64_t blk, int k_b, int i,
                                            float f) {
  if (vtype == kWireF32)
    return static_cast<const float*>(vals)[blk * k_b + i];
  if (vtype == kWireBF16)
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(vals)[blk * k_b + i]);
  if (vtype == kWireInt8)
    return __fmul_rn(
        static_cast<float>(static_cast<const int8_t*>(vals)[blk * k_b + i]),
        f);
  if (vtype == kWireInt4) {
    const uint8_t* vr = static_cast<const uint8_t*>(vals) + blk * ((k_b + 1) / 2);
    int q = lo_nibble(vr, i);
    q -= 16 * (q > 7);  // two's-complement nibble
    return __fmul_rn(static_cast<float>(q), f);
  }
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<const uint8_t*>(vals)[blk * k_b + i], __NV_E4M3);
  return __fmul_rn(__half2float(__half(h)), f);
}

__device__ __forceinline__ float dense_value(const void* rows, int vtype,
                                             int64_t i) {
  if (vtype == kDenseF32) return static_cast<const float*>(rows)[i];
  if (vtype == kDenseBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(rows)[i]);
  return __half2float(static_cast<const __half*>(rows)[i]);
}

__device__ __forceinline__ void put_tile(float* tile, int wb, int o,
                                         float v) {
  if (static_cast<unsigned int>(o) < static_cast<unsigned int>(wb))
    tile[o] = v;
}

// Bytes of one wire block's values.
__host__ __device__ inline int value_bytes(int vtype, int k_b) {
  if (vtype == kWireF32) return 4 * k_b;
  if (vtype == kWireBF16) return 2 * k_b;
  if (vtype == kWireInt4) return (k_b + 1) / 2;
  return k_b;
}

// Bytes a p4 step's block takes in the stage: its values and packed
// offsets, rounded up to 4.
__host__ __device__ inline int stage_bytes(int vtype, int k_b,
                                           int off_bytes) {
  return (value_bytes(vtype, k_b) + off_bytes + 3) & ~3;
}

// Scatters one wire block's decoded values into the zeroed tile; f is
// the block's dequantization factor.  The whole CTA calls it (the p4
// ranks are a block-wide prefix sum).  A p4 block comes from ``staged``
// in shared memory (its values, then its packed offsets), so that the
// walk over the set bits, one rank after the other, reads nothing from
// device memory; the other offset formats read each entry from device
// memory once, in parallel.
__device__ void scatter_block(const void* vals, const void* off, float f,
                              int vtype, int omode, int k_b, int off_bytes,
                              int64_t blk, float* tile, int wb, int* red,
                              const uint8_t* staged) {
  const int tid = threadIdx.x;
  if (omode == kOffP4) {
    const uint8_t* src = staged + value_bytes(vtype, k_b);
    const int lo_bytes = (k_b + 1) / 2, bm_bytes = off_bytes - lo_bytes;
    const uint8_t* bits = src + lo_bytes;
    const int per = (bm_bytes + kMixThreads - 1) / kMixThreads;
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
        if (rank < k_b)
          put_tile(tile, wb, 16 * max(pos - rank, 0) + lo_nibble(src, rank),
                   wire_value(staged, vtype, 0, k_b, rank, f));
        ++rank;
      }
    }
    for (int i = total + tid; i < k_b; i += kMixThreads)  // hi = 0
      put_tile(tile, wb, lo_nibble(src, i),
               wire_value(staged, vtype, 0, k_b, i, f));
    return;
  }
  for (int i = tid; i < k_b; i += kMixThreads) {
    int o;
    if (omode == kOffI32) {
      o = static_cast<const int*>(off)[blk * k_b + i];
    } else if (omode == kOffI16) {
      o = static_cast<const int16_t*>(off)[blk * k_b + i];
    } else {
      o = static_cast<const uint8_t*>(off)[blk * off_bytes + i];
    }
    put_tile(tile, wb, o, wire_value(vals, vtype, blk, k_b, i, f));
  }
}

// 40 registers at most, so that 12 CTAs fit an SM.
__global__ void __launch_bounds__(kMixThreads, 12)
decode_mix_kernel(const MixArgs a) {
  // the decode tile, y's tile (where it fits), the staged p4 payloads
  extern __shared__ float sm[];
  __shared__ int red[kMaxWarps];
  __shared__ float factor[kMixSteps];  // each step's dequantization factor
  const int tid = threadIdx.x;
  const int ci = blockIdx.y;
  const int64_t b = blockIdx.x;
  const int wb = a.wb;
  const long long j0 = b * wb;
  const int n = static_cast<int>(min(static_cast<long long>(wb), a.Lc - j0));
  const int64_t c = a.c0 + ci;
  float* tile = sm;
  float* yrow = a.y + c * a.y_stride + j0;
  const float* srow = a.src + c * a.src_stride + j0;
  // thread t owns the groups of four entries g = t + kMixThreads * k of
  // ys (and of the tile), in every phase: no barrier guards them; with
  // a.vec a whole group moves as one float4
  float* ys = a.ys_shared ? sm + wb : yrow;
  const int groups_y = (n + 3) / 4, groups_t = (wb + 3) / 4;
  uint8_t* stage = reinterpret_cast<uint8_t*>(sm + (a.ys_shared ? 2 : 1) * wb);

  // every read from device memory first, so that they overlap: the p4
  // payloads into the stage, the scales, y's tile
  int soff = 0;
  for (int s = 0; s < a.nsteps; ++s) {
    const int vtype = a.step[s].vtype, row = a.step[s].row[ci];
    if (vtype >= kDenseF32) continue;
    const int k_b = a.step[s].k_b, ob = a.step[s].off_bytes;
    const int64_t blk = static_cast<int64_t>(row) * a.nb + b;
    if (tid == s && row >= 0) {
      const float sc = a.step[s].scale != nullptr ? a.step[s].scale[blk]
                                                  : 0.0f;
      factor[s] = vtype == kWireInt8   ? __fdiv_rn(sc, 127.0f)
                  : vtype == kWireInt4 ? __fdiv_rn(sc, 7.0f)
                                       : sc;
    }
    if (a.step[s].omode != kOffP4) continue;
    const int vb = value_bytes(vtype, k_b);
    if (row >= 0) {
      const uint8_t* gv = static_cast<const uint8_t*>(a.step[s].vals) +
                          blk * vb;
      const uint8_t* go = static_cast<const uint8_t*>(a.step[s].off) +
                          blk * ob;
      for (int i = tid; i < vb + ob; i += kMixThreads)
        stage[soff + i] = i < vb ? gv[i] : go[i - vb];
    }
    soff += stage_bytes(vtype, k_b, ob);
  }
  const float d = a.diag[ci];
  for (int g = tid; g < groups_t; g += kMixThreads) {
    const int j = 4 * g;
    if (a.vec && j + 3 < n) {
      float4 v = reinterpret_cast<const float4*>(srow)[g];
      if (a.scaled) {
        v.x = __fmul_rn(d, v.x);
        v.y = __fmul_rn(d, v.y);
        v.z = __fmul_rn(d, v.z);
        v.w = __fmul_rn(d, v.w);
      }
      reinterpret_cast<float4*>(ys)[g] = v;
    } else {
      for (int q = j; q < min(j + 4, n); ++q)
        ys[q] = a.scaled ? __fmul_rn(d, srow[q]) : srow[q];
    }
    if (a.vec) {
      reinterpret_cast<float4*>(tile)[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int q = j; q < min(j + 4, wb); ++q) tile[q] = 0.0f;
    }
  }
  __syncthreads();

  soff = 0;
  for (int s = 0; s < a.nsteps; ++s) {
    const int row = a.step[s].row[ci];  // the same for the whole CTA
    const float coef = a.step[s].coef[ci];
    const int vtype = a.step[s].vtype;
    if (vtype >= kDenseF32) {
      const int64_t base = row * a.Lc + j0;
      for (int g = tid; g < groups_y; g += kMixThreads)
        for (int j = 4 * g; j < min(4 * g + 4, n); ++j) {
          const float v =
              row >= 0 ? dense_value(a.step[s].vals, vtype, base + j) : 0.0f;
          ys[j] = __fadd_rn(ys[j], __fmul_rn(coef, v));
        }
      continue;
    }
    const int k_b = a.step[s].k_b, ob = a.step[s].off_bytes;
    const int omode = a.step[s].omode;
    const uint8_t* staged = stage + soff;
    if (omode == kOffP4) soff += stage_bytes(vtype, k_b, ob);
    if (row < 0) {  // a zero payload decodes to +0 everywhere
      const float z = __fmul_rn(coef, 0.0f);
      for (int g = tid; g < groups_y; g += kMixThreads) {
        const int j = 4 * g;
        if (a.vec && j + 3 < n) {
          float4 v = reinterpret_cast<float4*>(ys)[g];
          v.x = __fadd_rn(v.x, z);
          v.y = __fadd_rn(v.y, z);
          v.z = __fadd_rn(v.z, z);
          v.w = __fadd_rn(v.w, z);
          reinterpret_cast<float4*>(ys)[g] = v;
        } else {
          for (int q = j; q < min(j + 4, n); ++q) ys[q] = __fadd_rn(ys[q], z);
        }
      }
      continue;
    }
    scatter_block(a.step[s].vals, a.step[s].off, factor[s], vtype, omode,
                  k_b, ob, static_cast<int64_t>(row) * a.nb + b, tile, wb,
                  red, staged);
    __syncthreads();
    for (int g = tid; g < groups_t; g += kMixThreads) {
      const int j = 4 * g;
      if (a.vec && j + 3 < n) {
        float4 t = reinterpret_cast<float4*>(tile)[g];
        float4 v = reinterpret_cast<float4*>(ys)[g];
        v.x = __fadd_rn(v.x, __fmul_rn(coef, t.x));
        v.y = __fadd_rn(v.y, __fmul_rn(coef, t.y));
        v.z = __fadd_rn(v.z, __fmul_rn(coef, t.z));
        v.w = __fadd_rn(v.w, __fmul_rn(coef, t.w));
        reinterpret_cast<float4*>(ys)[g] = v;
        reinterpret_cast<float4*>(tile)[g] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int q = j; q < min(j + 4, wb); ++q) {
          if (q < n) ys[q] = __fadd_rn(ys[q], __fmul_rn(coef, tile[q]));
          tile[q] = 0.0f;
        }
      }
    }
    __syncthreads();  // the tile is zero again before the next scatter
  }
  if (a.ys_shared) {
    for (int g = tid; g < groups_y; g += kMixThreads) {
      const int j = 4 * g;
      if (a.vec && j + 3 < n) {
        reinterpret_cast<float4*>(yrow)[g] =
            reinterpret_cast<const float4*>(ys)[g];
      } else {
        for (int q = j; q < min(j + 4, n); ++q) yrow[q] = ys[q];
      }
    }
  }
}

// Where one encode launch writes.
struct EncodeOut {
  void* vals;
  int* off;
  uint8_t* packed;
  float* scale;
};

template <int kDtype, int kOmode>
cudaError_t launch_encode(const float* x, const EncodeRows& rows,
                          const EncodeOut& o, int wb, int k_b, bool warp,
                          cudaStream_t stream) {
  const long long blocks = static_cast<long long>(rows.n) * rows.nb;
  if (warp) {
    const long long ctas = (blocks + kEncodeWarps - 1) / kEncodeWarps;
    encode_warp_kernel<kDtype, kOmode>
        <<<static_cast<unsigned>(ctas), kEncodeWarps * 32, 0, stream>>>(
            x, rows, o.vals, o.off, o.packed, o.scale, wb, k_b);
    return cudaGetLastError();
  }
  if constexpr (kOmode == kOffU8) {
    return cudaErrorInvalidValue;  // u8 takes the warp route only
  } else {
    const size_t smem = static_cast<size_t>(wb) * sizeof(float);
    cudaError_t err = allow_smem(encode_kernel<kDtype, kOmode>, smem);
    if (err != cudaSuccess) return err;
    encode_kernel<kDtype, kOmode>
        <<<static_cast<unsigned>(blocks), kEncodeThreads, smem, stream>>>(
            x, rows, o.vals, o.off, o.packed, o.scale, wb, k_b);
    return cudaGetLastError();
  }
}

template <int kOmode>
cudaError_t launch_encode_dtype(int wire_dtype, const float* x,
                                const EncodeRows& rows, const EncodeOut& o,
                                int wb, int k_b, bool warp,
                                cudaStream_t st) {
  switch (wire_dtype) {
    case kWireF32:
      return launch_encode<kWireF32, kOmode>(x, rows, o, wb, k_b, warp, st);
    case kWireBF16:
      return launch_encode<kWireBF16, kOmode>(x, rows, o, wb, k_b, warp, st);
    case kWireInt8:
      return launch_encode<kWireInt8, kOmode>(x, rows, o, wb, k_b, warp, st);
    case kWireInt4:
      return launch_encode<kWireInt4, kOmode>(x, rows, o, wb, k_b, warp, st);
    case kWireFp8:
      return launch_encode<kWireFp8, kOmode>(x, rows, o, wb, k_b, warp, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// The encode of n_rows sender rows read in place.  x: f32, row r at x +
// r * row_stride, unit column stride; rows: a host array of n_rows (at
// most 32) row indices; each row has L entries, encoded in nb = ceil(L /
// wb) wire blocks (the last one padded with +0).  vals: (n_rows, nb, k_b),
// or (n_rows, nb, ceil(k_b / 2)) for int4, in the wire dtype's storage
// type; scale: (n_rows, nb) f32.  The offsets, by omode: 0 (int32) off
// (n_rows, nb, k_b) int32; 2 (u8, wb <= 256, warp 1 only) packed
// (n_rows, nb, k_b) uint8; 3 (p4) packed (n_rows, nb, ceil(k_b / 2) +
// ceil((k_b + ceil(wb / 16)) / 8)) uint8.  The CTA-per-block kernel (warp
// 0) also needs off in p4 form, as scratch.  wire_dtype: 0 f32, 1 bf16, 2
// int8, 3 int4, 4 fp8.  warp: 1 runs the warp-per-block kernel (wb <=
// 1024), 0 the CTA-per-block one.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernels do not take).
extern "C" int repro_wire_encode_rows(const void* x, long long row_stride,
                                      const void* rows, int n_rows,
                                      long long L, void* vals, void* off,
                                      void* packed, void* scale,
                                      int wire_dtype, int omode, int wb,
                                      int k_b, int warp, void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || k_b > wb || n_rows < 1 ||
      n_rows > kMaxEncodeRows || L < 1 || row_stride < 0 ||
      (warp && wb > kWarpEncodeMax))
    return cudaErrorInvalidValue;
  if ((omode != kOffI32 && omode != kOffU8 && omode != kOffP4) ||
      (omode == kOffU8 && (wb > 256 || !warp)) ||
      ((omode == kOffI32 || !warp) && off == nullptr) ||
      (omode != kOffI32 && packed == nullptr))
    return cudaErrorInvalidValue;
  EncodeRows r;
  r.L = L;
  r.row_stride = row_stride;
  const long long nb = (L + wb - 1) / wb;
  if (nb * n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  r.nb = static_cast<int>(nb);
  r.n = n_rows;
  const int* idx = static_cast<const int*>(rows);
  for (int i = 0; i < kMaxEncodeRows; ++i) {
    r.idx[i] = i < n_rows ? idx[i] : 0;
    if (r.idx[i] < 0) return cudaErrorInvalidValue;
  }
  const float* xf = static_cast<const float*>(x);
  const EncodeOut o{vals, static_cast<int*>(off),
                    static_cast<uint8_t*>(packed),
                    static_cast<float*>(scale)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (omode == kOffU8)
    return launch_encode_dtype<kOffU8>(wire_dtype, xf, r, o, wb, k_b, warp,
                                       st);
  if (omode == kOffP4)
    return launch_encode_dtype<kOffP4>(wire_dtype, xf, r, o, wb, k_b, warp,
                                       st);
  return launch_encode_dtype<kOffI32>(wire_dtype, xf, r, o, wb, k_b, warp,
                                      st);
}

// off: (blocks, k_b) int32 ascending offsets below wb -> out: (blocks,
// ceil(k_b / 2) + ceil((k_b + ceil(wb / 16)) / 8)) uint8.  warp: 1 runs
// the warp-per-block kernel (wb <= 1024), 0 the CTA-per-block one.
extern "C" int repro_wire_pack_p4(const void* off, void* out,
                                  long long blocks, int wb, int k_b,
                                  int warp, void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || k_b > wb || blocks < 0 ||
      blocks > 0x7fffffffLL || (warp && wb > kWarpEncodeMax))
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  int lo_bytes, bm_bytes;
  p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    pack_p4_warp_kernel<<<static_cast<unsigned>(
                              (blocks + kP4Warps - 1) / kP4Warps),
                          kP4Warps * 32, 0, st>>>(
        static_cast<const int*>(off), static_cast<uint8_t*>(out),
        static_cast<int>(blocks), k_b, lo_bytes, bm_bytes);
    return cudaGetLastError();
  }
  const size_t smem = ((bm_bytes + 3) / 4) * sizeof(unsigned int);
  cudaError_t err = allow_smem(pack_p4_kernel, smem);
  if (err != cudaSuccess) return err;
  pack_p4_kernel<<<static_cast<unsigned>(blocks), kPackThreads, smem, st>>>(
      static_cast<const int*>(off), static_cast<uint8_t*>(out), k_b,
      lo_bytes, bm_bytes);
  return cudaGetLastError();
}

// packed: (blocks, nbytes) uint8 as repro_wire_pack_p4 writes it -> off:
// (blocks, k_b) int32 (4-byte aligned).  warp: as for the pack.
extern "C" int repro_wire_unpack_p4(const void* packed, void* off,
                                    long long blocks, int wb, int k_b,
                                    int warp, void* stream) {
  using namespace repro;
  if (wb < 1 || k_b < 1 || k_b > wb || blocks < 0 ||
      blocks > 0x7fffffffLL || (warp && wb > kWarpEncodeMax) ||
      (reinterpret_cast<uintptr_t>(off) & 3) != 0)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  int lo_bytes, bm_bytes;
  p4_sizes(wb, k_b, &lo_bytes, &bm_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp) {
    unpack_p4_warp_kernel<<<static_cast<unsigned>(
                                (blocks + kP4Warps - 1) / kP4Warps),
                            kP4Warps * 32, 0, st>>>(
        static_cast<const uint8_t*>(packed), static_cast<int*>(off),
        static_cast<int>(blocks), k_b, lo_bytes, bm_bytes);
    return cudaGetLastError();
  }
  unpack_p4_kernel<<<static_cast<unsigned>(blocks), kPackThreads, 0, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<int*>(off), k_b,
      lo_bytes, bm_bytes);
  return cudaGetLastError();
}

// One decode-and-mix launch.  args: a host MixArgs of args_bytes bytes
// (kernels/wire_pack.py:_MixArgs), copied into the kernel's parameters at
// the launch, so nothing is copied to the device.  Returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int repro_wire_decode_mix(const void* args, int args_bytes,
                                     void* stream) {
  using namespace repro;
  if (args_bytes != static_cast<int>(sizeof(MixArgs)))
    return cudaErrorInvalidValue;
  MixArgs a = *static_cast<const MixArgs*>(args);
  if (a.y == nullptr || a.src == nullptr || a.wb < 1 || a.nb < 0 ||
      a.Lc < 0 || static_cast<long long>(a.nb) * a.wb < a.Lc ||
      a.nrows < 1 || a.nrows > kMixRows || a.c0 < 0 || a.nsteps < 0 ||
      a.nsteps > kMixSteps)
    return cudaErrorInvalidValue;
  for (int s = 0; s < a.nsteps; ++s) {
    const MixStep& st = a.step[s];
    if (st.vtype < 0 || st.vtype > kDenseF16 || st.vals == nullptr)
      return cudaErrorInvalidValue;
    if (st.vtype >= kDenseF32) continue;
    if (st.off == nullptr || st.k_b < 1 || st.k_b > a.wb ||
        st.omode < kOffI32 || st.omode > kOffP4 ||
        (st.vtype >= kWireInt8 && st.scale == nullptr))
      return cudaErrorInvalidValue;
    int lo_bytes, bm_bytes;
    p4_sizes(a.wb, st.k_b, &lo_bytes, &bm_bytes);
    if ((st.omode == kOffP4 && st.off_bytes != lo_bytes + bm_bytes) ||
        (st.omode == kOffU8 && st.off_bytes != st.k_b))
      return cudaErrorInvalidValue;
  }
  if (a.nb == 0) return cudaSuccess;
  size_t stage = 0;  // the p4 blocks of every step
  for (int s = 0; s < a.nsteps; ++s)
    if (a.step[s].vtype < kDenseF32 && a.step[s].omode == kOffP4)
      stage += stage_bytes(a.step[s].vtype, a.step[s].k_b,
                           a.step[s].off_bytes);
  const size_t tile = static_cast<size_t>(a.wb) * sizeof(float);
  if (tile + stage > kMaxSmem) return cudaErrorInvalidValue;
  a.ys_shared = 2 * tile + stage <= kMaxSmem;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  a.vec = a.wb % 4 == 0 && a.y_stride % 4 == 0 && a.src_stride % 4 == 0 &&
          aligned(a.y) && aligned(a.src);
  const size_t smem = (a.ys_shared ? 2 * tile : tile) + stage;
  cudaError_t err = allow_smem(decode_mix_kernel, smem);
  if (err != cudaSuccess) return err;
  decode_mix_kernel<<<dim3(static_cast<unsigned>(a.nb),
                           static_cast<unsigned>(a.nrows)),
                      kMixThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}
