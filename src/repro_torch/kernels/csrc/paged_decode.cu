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
// far below the H100's ridge of about 295 operations per byte; at the
// serve's lengths the live KV is a few MB, so a launch's latency, not the
// bytes, is the floor, and the card needs many CTAs in flight to reach its
// memory rate on long contexts.
//
// What the design does about it (flash decoding): the grid is (KH, B,
// n_split) and each split owns a fixed run of positions (cps chunks of
// kChunk), so hundreds of CTAs share the work of a step rather than one per
// (request, KV head); n_split comes from the shapes alone, and a split that
// starts past kv_len[b] exits at once, so the host never reads kv_len.  A
// split streams its chunks through a two-stage ring in shared memory, 16
// bytes a thread by cp.async, the next chunk's copy in flight while this
// one is used; it reads only live positions, each once, and its block reads
// its own page-table entries (the TPU kernel's scalar prefetch).
//
// paged_decode_tc (bf16, head dim 16-128, G <= 16): each warp owns 16 keys
// of a chunk and runs them on the tensor cores with mma.sync m16n8k16: the
// scores are q (the G heads padded to 16 rows, in registers) times K rows
// read from shared memory, the online softmax runs on the accumulator
// fragments (row statistics by shuffles), and P, rounded to bf16 in
// registers, multiplies V fetched by ldmatrix.trans; the four warps' (acc,
// m, l) meet in shared memory at the end of the split.
// paged_decode_simt (f32, and any other shape): scores one (head, key) per
// thread over the K row, the softmax statistics of a head by warp
// shuffles, acc in shared memory.
//
// Both end the same way: a request whose live positions fit one split
// writes (out, m, l) from that split; else each live split writes its
// (unnormalised f32 acc, m, l) partial to scratch that the wrapper
// allocates and takes a ticket, and the last live split of the (request,
// KV head) folds the partials into (out, m, l), in split order (the same
// sums whichever split comes last), and resets its ticket for the next
// launch.  One launch a call.
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;   // positions of a chunk
constexpr int kMaxTcG = 16;  // query heads a KV head, tensor-core kernel

struct DecodeArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const int32_t* page_table;
  const int32_t* kv_len;
  void* out;
  float* m_out;
  float* l_out;
  float* part_acc;  // (B, KH, n_split, G, Dh)
  float* part_m;    // (B, KH, n_split, G)
  float* part_l;    // (B, KH, n_split, G)
  int* tickets;     // (B * KH,)
  int H, KH, Dh, ps, P, cps;
  float scale;
};

// Bytes of one K or V row in the ring: padded by 16 so that neighbouring
// threads reading neighbouring rows hit distinct banks.
__host__ __device__ inline int row_bytes(int Dh, int esz) {
  return Dh * esz + 16;
}

// The shared memory of either kernel: the ring [2 stages][K, V][kChunk
// rows], then f32 arrays.
struct Smem {
  unsigned char* ring;
  float* acc;  // [G][Dh]  the split's acc
  float* ms;   // [G]
  float* ls;   // [G]
  float* cs;   // [G]      the chunk's correction
  float* ss;   // [G][kChunk]  scores, or the warps' m, l and weights
  float* wm;   // [n_split][G]  the merge's m, then weights
  float* wl;   // [n_split][G]  the merge's l
  float* qs;   // [G][Dh]  q * scale, paged_decode_simt only
};

inline size_t smem_bytes(int G, int Dh, int esz, int n_split, bool with_q) {
  return 4 * static_cast<size_t>(kChunk) * row_bytes(Dh, esz) +
         sizeof(float) * ((1 + with_q) * G * Dh + 3 * G + G * kChunk +
                          2 * n_split * G + 3);  // + 3: qs 16-byte aligned
}

__device__ inline Smem carve(unsigned char* smem, int G, int Dh, int esz) {
  Smem s;
  s.ring = smem;
  s.acc = reinterpret_cast<float*>(smem + 4 * kChunk * row_bytes(Dh, esz));
  s.ms = s.acc + G * Dh;
  s.ls = s.ms + G;
  s.cs = s.ls + G;
  s.ss = s.cs + G;
  s.wm = s.ss + G * kChunk;
  s.wl = s.wm + gridDim.z * G;
  const size_t q_at = reinterpret_cast<size_t>(s.wl + gridDim.z * G);
  s.qs = reinterpret_cast<float*>((q_at + 15) & ~size_t(15));
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where a split stands: len live positions of the request (at most the
// table's), n_live splits hold some, this one owns [pos0, pos_end).
struct Range {
  int len, n_live, pos0, pos_end;
};

__device__ __forceinline__ Range split_range(const DecodeArgs& a, int b,
                                             int split) {
  Range r;
  r.len = min(a.kv_len[b], a.P * a.ps);
  const int span = a.cps * kChunk;
  r.n_live = (r.len + span - 1) / span;
  r.pos0 = split * span;
  r.pos_end = min(r.len, r.pos0 + span);
  return r;
}

// kv_len = 0: out 0, m -1e30, l 1e-20 exactly, written by split 0.
template <typename T>
__device__ void write_empty(const DecodeArgs& a, size_t bk, int G) {
  T* ob = static_cast<T*>(a.out) + bk * G * a.Dh;
  for (int e = threadIdx.x; e < G * a.Dh; e += kThreads)
    ob[e] = from_f32<T>(0.f);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    a.m_out[bk * G + g] = kNegInf;
    a.l_out[bk * G + g] = 1e-20f;
  }
}

// Copies of the K and V rows of positions [p0, p0 + kChunk) into stage st
// of the ring.  Rows at or past `end` are zeros when `zero`, else not
// copied.
template <typename T>
__device__ __forceinline__ void load_chunk(const DecodeArgs& a,
                                           unsigned char* ring, int b,
                                           int kh, int p0, int end, int st,
                                           bool zero) {
  const int RB = row_bytes(a.Dh, sizeof(T));
  const int CPR = a.Dh * static_cast<int>(sizeof(T)) / 16;  // 16B a row
  const int rows = zero ? kChunk : min(kChunk, end - p0);
  const int32_t* pt = a.page_table + (size_t)b * a.P;
  const unsigned char* kp = static_cast<const unsigned char*>(a.kp);
  const unsigned char* vp = static_cast<const unsigned char*>(a.vp);
  unsigned char* ks = ring + 2 * st * kChunk * RB;
  unsigned char* vs = ks + kChunk * RB;
  for (int e = threadIdx.x; e < rows * CPR; e += kThreads) {
    const int t = e / CPR, part = e % CPR;
    const int pos = p0 + t;
    size_t off = 0;  // the pool's start stands in for a zero-filled row
    int n = 0;
    if (pos < end) {
      const size_t phys = (size_t)pt[pos / a.ps];
      off = ((phys * a.ps + pos % a.ps) * a.KH + kh) * a.Dh * sizeof(T) +
            16 * part;
      n = 16;
    }
    cp_async16(ks + t * RB + 16 * part, kp + off, n);
    cp_async16(vs + t * RB + 16 * part, vp + off, n);
  }
}

// The end of a split, with its (acc not yet divided by l, m, l) in shared
// memory: the answer if it is the request's only live split, else its
// partial, a ticket, and for the last live split the fold of all of them.
template <typename T>
__device__ void finish_split(const DecodeArgs& a, const Range& r, size_t bk,
                             int split, int G, const Smem& s) {
  const int Dh = a.Dh;
  const int tid = threadIdx.x;
  T* ob = static_cast<T*>(a.out) + bk * G * Dh;  // heads kh * G ..
  if (r.n_live == 1) {  // the only live split: its result is the answer
    for (int e = tid; e < G * Dh; e += kThreads)
      ob[e] = from_f32<T>(s.acc[e] / s.ls[e / Dh]);  // l >= 1: a live max
    for (int g = tid; g < G; g += kThreads) {
      a.m_out[bk * G + g] = s.ms[g];
      a.l_out[bk * G + g] = s.ls[g];
    }
    return;
  }
  const size_t base = bk * gridDim.z;  // partial index of split 0
  float* pacc = a.part_acc + (base + split) * G * Dh;
  for (int e = tid; e < G * Dh; e += kThreads) pacc[e] = s.acc[e];
  for (int g = tid; g < G; g += kThreads) {
    a.part_m[(base + split) * G + g] = s.ms[g];
    a.part_l[(base + split) * G + g] = s.ls[g];
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(a.tickets + bk, 1) == r.n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last live split folds the n_live partials: M = max m_s,
  // L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) / L (L >= 1)
  const int nm = r.n_live * G;
  for (int i = tid; i < nm; i += kThreads) {
    s.wm[i] = __ldcg(a.part_m + base * G + i);
    s.wl[i] = __ldcg(a.part_l + base * G + i);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float M = kNegInf;
    for (int sp = 0; sp < r.n_live; ++sp) M = fmaxf(M, s.wm[sp * G + g]);
    float L = 0.f;
    for (int sp = 0; sp < r.n_live; ++sp)
      L = fmaf(s.wl[sp * G + g], expf(s.wm[sp * G + g] - M), L);
    s.ms[g] = M;
    s.ls[g] = L;
    a.m_out[bk * G + g] = M;
    a.l_out[bk * G + g] = L;
  }
  __syncthreads();
  for (int i = tid; i < nm; i += kThreads)
    s.wm[i] = expf(s.wm[i] - s.ms[i % G]);  // the weights
  __syncthreads();
  const float* src = a.part_acc + base * G * Dh;
  for (int e = tid; e < G * Dh; e += kThreads) {
    const int g = e / Dh;
    float x = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < r.n_live; ++sp)
      x = fmaf(__ldcg(src + (size_t)sp * G * Dh + e), s.wm[sp * G + g], x);
    ob[e] = from_f32<T>(x / s.ls[g]);
  }
  if (tid == 0) a.tickets[bk] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// paged_decode_tc: bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads)
    paged_decode_tc(const DecodeArgs a) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = a.H / a.KH;
  const size_t bk = (size_t)b * a.KH + kh;  // this (request, KV head)
  const Range r = split_range(a, b, split);
  if (r.len == 0) {
    if (split == 0) write_empty<bf16>(a, bk, G);
    return;
  }
  if (split >= r.n_live) return;
  const int nchunks = (r.pos_end - r.pos0 + kChunk - 1) / kChunk;

  constexpr int RB = DH * 2 + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, G, DH, 2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = lane >> 2;       // fragment rows g0 and g0 + 8
  const int t2 = 2 * (lane & 3);  // fragment columns t2 and t2 + 1

  load_chunk<bf16>(a, s.ring, b, kh, r.pos0, r.pos_end, 0, true);
  cp_async_commit();

  // q (B, 1, H, DH), head kh * G + g: the A fragments of every k-step, the
  // G heads padded to 16 rows.  As in the reference, q * scale is rounded
  // back to bf16.
  const bf16* qb = static_cast<const bf16*>(a.q) +
                   ((size_t)b * a.H + (size_t)kh * G) * DH;
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = g0 + 8 * (i & 1), c = kk * 16 + 8 * (i >> 1) + t2;
      float x0 = 0.f, x1 = 0.f;
      if (g < G) {
        x0 = __bfloat162float(qb[g * DH + c]) * a.scale;
        x1 = __bfloat162float(qb[g * DH + c + 1]) * a.scale;
      }
      qa[kk][i] = pack_bf16(x0, x1);
    }

  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int key0 = 16 * warp;  // this warp's keys of a chunk: key0 + 0..15
  for (int c = 0, st = 0; c < nchunks; ++c, st ^= 1) {
    const int p0 = r.pos0 + c * kChunk;
    if (c + 1 < nchunks)
      load_chunk<bf16>(a, s.ring, b, kh, p0 + kChunk, r.pos_end, st ^ 1,
                       true);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // chunk c has landed for every thread
    const int nv = min(kChunk, r.pos_end - p0);
    const unsigned char* ks = s.ring + 2 * st * kChunk * RB;
    const unsigned char* vs = ks + kChunk * RB;
    if (key0 < nv) {
      // scores: sc[nt][2 i + cc] is row g0 + 8 i, key key0 + 8 nt + t2 + cc
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const unsigned char* kr =
              ks + (key0 + 8 * nt + g0) * RB + 2 * (kk * 16 + t2);
          mma16816(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 16));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = sc[nt][2 * i + cc];
            if (key0 + 8 * nt + t2 + cc >= nv) x = -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);  // m starts finite: no NaN
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = sc[nt][2 * i + cc];
            x = expf(x - m_new);
            sum += x;
          }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[j][2 * i] *= corr;
          o[j][2 * i + 1] *= corr;
        }
      }
      // P (rows x the warp's 16 keys) in bf16 is the A fragment; V's 16 x
      // 16 blocks come by ldmatrix.trans, lane l giving row l % 8 of block
      // l / 8 (keys + 8 (l / 8 % 2), columns + 8 (l / 16))
      const uint32_t pa[4] = {
          pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
          pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
      const unsigned char* vr =
          vs + (key0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RB +
          16 * (lane >> 4);
#pragma unroll
      for (int j2 = 0; j2 < DH / 16; ++j2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + 32 * j2);
        mma16816(o[2 * j2], pa, vb[0], vb[1]);
        mma16816(o[2 * j2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage st is read: the next prefetch may refill it
  }

  // The four warps meet.  Warp w's m and l at ss[w G + g] and ss[4 G + w G
  // + g], its weight at ss[8 G + w G + g], its rows of o in the ring (free
  // now) as [w][G][DH] f32.  A warp that saw no key has m -1e30: weight 0.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* wo = reinterpret_cast<float*>(s.ring);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = g0 + 8 * i;
    if (g < G) {
      if ((lane & 3) == 0) {
        s.ss[warp * G + g] = m[i];
        s.ss[4 * G + warp * G + g] = l[i];
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        wo[(warp * G + g) * DH + 8 * j + t2] = o[j][2 * i];
        wo[(warp * G + g) * DH + 8 * j + t2 + 1] = o[j][2 * i + 1];
      }
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s.ss[w * G + g]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float x = expf(s.ss[w * G + g] - M);
      s.ss[8 * G + w * G + g] = x;
      L = fmaf(s.ss[4 * G + w * G + g], x, L);
    }
    s.ms[g] = M;
    s.ls[g] = L;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * DH; e += kThreads) {
    const int g = e / DH;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      x = fmaf(wo[w * G * DH + e], s.ss[8 * G + w * G + g], x);
    s.acc[e] = x;
  }
  __syncthreads();
  finish_split<bf16>(a, r, bk, split, G, s);
}

// ---------------------------------------------------------------------------
// paged_decode_simt: f32, and shapes the tensor-core kernel does not take
// ---------------------------------------------------------------------------

// Sum of the products of 16 bytes of a K row (8 bf16 or 4 f32) with the
// matching f32 values of q.
__device__ __forceinline__ float dot16(const bf16* k, const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  const float2 x = __bfloat1622float2(k2[0]), y = __bfloat1622float2(k2[1]);
  const float2 z = __bfloat1622float2(k2[2]), w = __bfloat1622float2(k2[3]);
  float s = x.x * qa.x;
  s = fmaf(x.y, qa.y, s);
  s = fmaf(y.x, qa.z, s);
  s = fmaf(y.y, qa.w, s);
  s = fmaf(z.x, qb.x, s);
  s = fmaf(z.y, qb.y, s);
  s = fmaf(w.x, qb.z, s);
  return fmaf(w.y, qb.w, s);
}
__device__ __forceinline__ float dot16(const float* k, const float* q) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  float s = kv.x * qv.x;
  s = fmaf(kv.y, qv.y, s);
  s = fmaf(kv.z, qv.z, s);
  return fmaf(kv.w, qv.w, s);
}

__device__ __forceinline__ float2 load2(const bf16* v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
}
__device__ __forceinline__ float2 load2(const float* v) {
  return *reinterpret_cast<const float2*>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_simt(const DecodeArgs a) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = a.H / a.KH;
  const int Dh = a.Dh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t bk = (size_t)b * a.KH + kh;  // this (request, KV head)
  const Range r = split_range(a, b, split);
  if (r.len == 0) {
    if (split == 0) write_empty<T>(a, bk, G);
    return;
  }
  if (split >= r.n_live) return;
  const int nchunks = (r.pos_end - r.pos0 + kChunk - 1) / kChunk;

  const int RB = row_bytes(Dh, sizeof(T));
  const int CPR = Dh * static_cast<int>(sizeof(T)) / 16;  // 16B a row
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, G, Dh, sizeof(T));
  auto row = [&](int st, int kv, int t) {  // K (kv 0) or V (kv 1) row t
    return reinterpret_cast<const T*>(s.ring +
                                      ((2 * st + kv) * kChunk + t) * RB);
  };

  load_chunk<T>(a, s.ring, b, kh, r.pos0, r.pos_end, 0, false);
  cp_async_commit();

  // q (B, 1, H, Dh): head kh * G + g is query row g of this KV head.  As in
  // the reference, q * scale is rounded back to q's type.
  const T* qb =
      static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)kh * G) * Dh;
  for (int e = tid; e < G * Dh; e += kThreads) {
    s.qs[e] = to_f32(from_f32<T>(to_f32(qb[e]) * a.scale));
    s.acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s.ms[g] = kNegInf;
    s.ls[g] = 0.f;
  }

  for (int c = 0, st = 0; c < nchunks; ++c, st ^= 1) {
    const int p0 = r.pos0 + c * kChunk;
    if (c + 1 < nchunks)
      load_chunk<T>(a, s.ring, b, kh, p0 + kChunk, r.pos_end, st ^ 1, false);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // chunk c has landed for every thread; q is set
    const int nv = min(kChunk, r.pos_end - p0);

    // scores: one (head, key) a thread, over the K row
    for (int e = tid; e < G * nv; e += kThreads) {
      const int g = e / nv, t = e % nv;
      const T* kr = row(st, 0, t);
      const float* qg = s.qs + g * Dh;
      float x = 0.f;
      for (int j = 0; j < CPR; ++j) x += dot16(kr + j * EPC, qg + j * EPC);
      s.ss[g * kChunk + t] = x;
    }
    __syncthreads();

    // softmax statistics: one head a warp, keys across the lanes; p is
    // kept rounded to v's type for the product, as in the reference
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s.ss + g * kChunk;
      float mx = kNegInf;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sg[t]);
      const float m_old = s.ms[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < nv; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = to_f32(from_f32<T>(p));
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s.ls[g] = s.ls[g] * corr + sum;
        s.ms[g] = m_new;
        s.cs[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V: two output columns a thread
    for (int e = tid; e < G * (Dh / 2); e += kThreads) {
      const int g = e / (Dh / 2), d = 2 * (e % (Dh / 2));
      const float* pg = s.ss + g * kChunk;
      float a0 = s.acc[g * Dh + d] * s.cs[g];
      float a1 = s.acc[g * Dh + d + 1] * s.cs[g];
      for (int t = 0; t < nv; ++t) {
        const float2 vv = load2(row(st, 1, t) + d);
        a0 = fmaf(pg[t], vv.x, a0);
        a1 = fmaf(pg[t], vv.y, a1);
      }
      s.acc[g * Dh + d] = a0;
      s.acc[g * Dh + d + 1] = a1;
    }
    __syncthreads();  // stage st is read: the next prefetch may refill it
  }
  finish_split<T>(a, r, bk, split, G, s);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const DecodeArgs& a, int B, int n_split,
                   int esz, bool with_q, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.H / a.KH, a.Dh, esz, n_split, with_q);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.KH, B, n_split), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q (B, 1, H, Dh); k_pages, v_pages (NP, ps, KH, Dh); page_table (B, P) and
// kv_len (B,) int32; out (B, 1, H, Dh) in q's type, m and l (B, 1, KH, G)
// f32; scratch part_acc (B, KH, n_split, G, Dh), part_m and part_l
// (B, KH, n_split, G) f32; tickets (B * KH,) int32, zero, and left zero.
// All contiguous and on one device (dtype: 0 = f32, 1 = bf16), rows of Dh
// elements a multiple of 16 bytes, 16-byte aligned.  Each split owns cps
// chunks of 64 positions: n_split * cps * 64 >= P * ps.  bf16 with Dh in
// {16, 32, 64, 128} and H / KH <= 16 runs paged_decode_tc, anything else
// paged_decode_simt.  Launches on `stream` and returns cudaGetLastError()
// of the launch (0 on success).
extern "C" int repro_paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, void* m, void* l,
    void* part_acc, void* part_m, void* part_l, void* tickets, int dtype,
    int B, int H, int KH, int Dh, int ps, int P, int cps, int n_split,
    float scale, void* stream) {
  using namespace repro;
  if (B == 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || ps <= 0 || Dh <= 0 || cps <= 0 ||
      n_split <= 0 || (long long)n_split * cps * kChunk < (long long)P * ps)
    return cudaErrorInvalidValue;
  const DecodeArgs a{q,
                     k_pages,
                     v_pages,
                     static_cast<const int32_t*>(page_table),
                     static_cast<const int32_t*>(kv_len),
                     out,
                     static_cast<float*>(m),
                     static_cast<float*>(l),
                     static_cast<float*>(part_acc),
                     static_cast<float*>(part_m),
                     static_cast<float*>(part_l),
                     static_cast<int*>(tickets),
                     H,
                     KH,
                     Dh,
                     ps,
                     P,
                     cps,
                     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && H / KH <= kMaxTcG) {
    switch (Dh) {
      case 16:
        return launch(paged_decode_tc<16>, a, B, n_split, 2, false, s);
      case 32:
        return launch(paged_decode_tc<32>, a, B, n_split, 2, false, s);
      case 64:
        return launch(paged_decode_tc<64>, a, B, n_split, 2, false, s);
      case 128:
        return launch(paged_decode_tc<128>, a, B, n_split, 2, false, s);
      default:
        break;
    }
  }
  if (dtype == kBFloat16 && Dh % 8 == 0)
    return launch(paged_decode_simt<bf16>, a, B, n_split, 2, true, s);
  if (dtype == kFloat32 && Dh % 4 == 0)
    return launch(paged_decode_simt<float>, a, B, n_split, 4, true, s);
  return cudaErrorInvalidValue;
}
