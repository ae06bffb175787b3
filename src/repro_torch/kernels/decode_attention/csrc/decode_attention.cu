// Single-token GQA decode attention over a (possibly ring) KV cache, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's decode is a plain einsum-softmax-
// einsum (repro/models/attention.py::decode_gqa_attention), and so was the
// port's.  On the card that plain form copied the whole cache in every
// layer: K cast to float32, then both einsums' transposed copies, about 24
// bytes moved per cached K/V element pair where 4 is the least.  This kernel
// reads the bf16 cache once, in place, in the cache's own layout:
//   q (B, 1, H, hd); cache_k, cache_v (B, cap, K, hd); kv_positions (B, cap)
//   int32, -1 for an empty slot; pos (B,) int32; query head h reads KV head
//   h / G, G = H / K;
//   valid(b, j) = kvpos >= 0 && kvpos <= pos[b]
//                 && (window == 0 || kvpos > pos[b] - window)
//   s[b, h, j] = valid ? sum_d qs[b, h, d] * k[b, j, h / G, d] : -1e30
//   p = exp(s - max_j s) / sum_j exp(s - max_j s), rounded to the dtype
//   out[b, h, :] = sum_j p[b, h, j] * v[b, j, h / G, :], rounded to the dtype
// with qs = q * scale computed in the dtype (the scale 1 / sqrt(hd) rounded
// to it first), the products, max, exp and sums in float32: the plain path's
// arithmetic (models/attention.py); only the order of the sums differs.
// Both instances (bf16 for serving, float32 for the parity checks) share
// the code.
//
// Bound: bytes.  Per cached slot a head row of K and of V (2 * hd elements)
// meets G query heads: 2 * G * hd flops per 2 * hd * 2 bytes, G / 2 flops
// a byte, far below the card's ridge (~295).  So the kernel only has to
// stream the cache at the memory's rate, read each row once for all G
// query heads of its KV head, and keep everything else out of memory.
//
// Exactness of p forces two passes: p is rounded after it is normalised by
// the row's sum over the whole cache, so no p.v term can be formed before
// every score of the row exists.  Three kernels, launched back to back by
// one entry point:
//   1. scores_kernel: one block per (b, KV head, group of up to 8 query
//      heads, split of the slots).  It reads its split's K rows and writes
//      the float32 scores s (B, H, cap) to scratch (3.7 MB for the olmoe
//      decode cell's step, against 235 MB of K: L2-resident).
//   2. pv_kernel: the same grid.  Each block takes the row max and sum of
//      its heads over all cap scores (a fixed-order reduction, so every
//      split of a row computes the same numbers), forms p for its split's
//      slots in shared memory, then streams its split's V rows.  With one
//      split it writes the output; with several, float32 partial sums.
//   3. combine_kernel (several splits only): adds the splits' partial sums
//      in split order and rounds.  No atomics: two calls are bitwise equal.
// The split count comes from the wrapper (ops.plan, from the shapes and the
// card's SM count): enough blocks to fill the card (the prefill cell's
// B * K = 128 blocks would leave SMs idle) and at most min(1024, 2048 / GT)
// slots a split, so p fits in shared memory.
//
// Streaming: each half-warp (16 lanes) takes one slot of a tile at a time,
// a lane one (or, past 256-byte rows, two) 16-byte chunk(s) of the row.  A
// block of 128 threads is 8 half-warps; a tile is 32 slots (16 with two
// chunks a lane).  Rows are brought in with cp.async into a 3-stage ring in
// shared memory that is private to each thread (each thread reads only the
// chunks it copied), so the ring needs no block barrier: two tiles (16 KB)
// are in flight while the third is consumed, and 24 KB of ring leave room
// for eight blocks an SM.  The first two tiles are issued as the block
// starts, under its reads of the flags (scores) or of the row statistics
// (p.v).  After them a slot that is masked (scores) or whose p is 0 for
// every head of the group (p.v: exp underflows for masked slots once the
// row has a valid one) is not loaded: its score is -1e30, its p.v term 0,
// as in the plain path.  A row
// with no valid slot keeps the plain path's answer (every p = 1 / cap: the
// mean of V over the cap slots).
//
// The q.k sums of a slot are reduced over its 16 lanes by a butterfly that
// halves the G values at each step (G / 2 + G / 4 + ... shuffles, not
// 4 * G), ending with one head's sum on each run of 16 / G lanes.
//
// Built without --use_fast_math: the float32 instance is held to 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Named (not anonymous), so profiler traces show the kernels as
// dattn::scores_kernel, dattn::pv_kernel and dattn::combine_kernel.
namespace dattn {

constexpr int kThreads = 128;     // 4 warps = 8 half-warps
constexpr int kHalfWarps = kThreads / 16;
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- dtypes
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerChunk = 4;  // elements of a 16-byte chunk
  __device__ static void load(const uint4& c, float* f) {
    f[0] = __uint_as_float(c.x);
    f[1] = __uint_as_float(c.y);
    f[2] = __uint_as_float(c.z);
    f[3] = __uint_as_float(c.w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static float cast(float x) { return x; }
  __device__ static float to_float(float x) { return x; }
  __device__ static void store(float* dst, const float* f) {
    *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ static void load(const uint4& c, float* f) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      float2 x = __bfloat1622float2(h);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static __nv_bfloat16 cast(float x) {
    return __float2bfloat16(x);
  }
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static void store(__nv_bfloat16* dst, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// -------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A call's tensors and sizes.  k_new and v_new (B, 1, K, hd) may be null:
// this token's K and V rows, written into the caches by the scores kernel.
template <typename T>
struct Args {
  const T* q;
  T* k;
  T* v;
  const T* k_new;
  const T* v_new;
  const int* kvpos;
  const int* pos;
  T* out;
  float* s;     // scores (B, H, cap)
  float* part;  // partial sums (B, H, n_split, hd)
  int B, cap, H, K, hd, window, split_len, n_split;
  float scale;
};

// One block's share of the work: (b, KV head, first query head of its
// group, heads in the group, slots [lo, hi)).
struct Work {
  int b, kh, h0, ng, lo, hi;
};

__device__ __forceinline__ Work work_of(int K, int G, int GT, int cap,
                                        int split_len) {
  const int groups = (G + GT - 1) / GT;
  const int bk = blockIdx.x / groups, grp = blockIdx.x % groups;
  Work w;
  w.b = bk / K;
  w.kh = bk % K;
  w.h0 = w.kh * G + grp * GT;
  w.ng = min(GT, G - grp * GT);
  w.lo = blockIdx.y * split_len;
  w.hi = min(cap, w.lo + split_len);
  return w;
}

// The ring of a block (uint4s): kStages tiles of U slots x NC chunks a
// thread; the p.v kernel also sums its 8 half-warps' outputs through it
// (at most 4 x GT x 16 lanes x NC x EPC floats).
template <int U, int NC, int GT, int EPC>
__host__ __device__ constexpr int ring_size() {
  return kStages * U * NC * kThreads > GT * 16 * NC * EPC
             ? kStages * U * NC * kThreads
             : GT * 16 * NC * EPC;
}

// Chunks of one thread's ring stage: U slots x NC chunks, one uint4 each,
// laid out [stage][u][chunk][thread] so a warp's chunks are consecutive.
template <int U, int NC>
__device__ __forceinline__ uint4* stage_chunk(uint4* ring, int st, int u,
                                              int i) {
  return ring + ((st * U + u) * NC + i) * kThreads + threadIdx.x;
}

// Sum of v[0..N) over the 16 lanes of a half-warp, reduce-scattered: at
// each of the first log2(N) steps a lane keeps half of its values and adds
// the partner's copy of that half, so after the four steps the lane holds
// the whole sum of value lane >> log2(16 / N).
template <int N, int OFF>
__device__ __forceinline__ float butterfly(const float (&v)[N], int lane) {
  if constexpr (OFF == 0) {
    static_assert(N == 1, "16 lanes halve at most 4 times");
    return v[0];
  } else if constexpr (N == 1) {
    const float w[1] = {v[0] + __shfl_xor_sync(kFull, v[0], OFF)};
    return butterfly<1, OFF / 2>(w, lane);
  } else {
    constexpr int H = N / 2;
    const bool up = (lane & OFF) != 0;
    float w[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      w[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    return butterfly<H, OFF / 2>(w, lane);
  }
}

// ---------------------------------------------------------------- scores
template <typename T, int GT, int NC>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const Args<T> a) {
  using E = Elem<T>;
  const T* q = a.q;
  const int *kvpos = a.kvpos, *pos = a.pos;
  float* s = a.s;
  const int cap = a.cap, H = a.H, K = a.K, hd = a.hd, window = a.window,
            split_len = a.split_len;
  constexpr int EPC = E::kPerChunk;
  constexpr int U = 4 / NC;                 // slots a half-warp per tile
  constexpr int TS = kHalfWarps * U;        // slots a tile
  __shared__ uint4 ring[ring_size<U, NC, 1, EPC>()];
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned char* valid = dyn;               // one flag a slot of the split

  const int G = H / K;
  const Work w = work_of(K, G, GT, cap, split_len);
  const int hw = threadIdx.x / 16, lane = threadIdx.x % 16;
  const int CH = hd / EPC;                  // chunks a row

  const size_t row_stride = (size_t)K * hd;  // elements between slots
  const size_t base = ((size_t)w.b * cap * K + w.kh) * hd;
  const T* kb = a.k + base;
  const int n_tiles = (w.hi - w.lo + TS - 1) / TS;

  // this token's K and V rows into their slot (pos % cap), by the blocks
  // whose split holds it, before any of their loads (the p.v kernel runs
  // after this one)
  if (a.k_new != nullptr) {
    const int js = pos[w.b] % cap;
    if (js >= w.lo && js < w.hi) {
      const size_t src = ((size_t)w.b * K + w.kh) * hd;
      const size_t dst = base + js * row_stride;
      for (int c = threadIdx.x; c < CH; c += kThreads) {
        *reinterpret_cast<uint4*>(a.k + dst + c * EPC) =
            *reinterpret_cast<const uint4*>(a.k_new + src + c * EPC);
        *reinterpret_cast<uint4*>(a.v + dst + c * EPC) =
            *reinterpret_cast<const uint4*>(a.v_new + src + c * EPC);
      }
      __threadfence_block();
      __syncthreads();
    }
  }

  // the first tiles are issued before the flags exist (every slot loaded);
  // later tiles skip the masked slots
  auto issue = [&](int t, bool every) {
    if (t < n_tiles) {
      const int st = t % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = w.lo + t * TS + hw + kHalfWarps * u;
        if (j < w.hi && (every || valid[j - w.lo])) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int c = lane + 16 * i;
            if (c < CH)
              cp_async16(stage_chunk<U, NC>(ring, st, u, i),
                         kb + j * row_stride + c * EPC);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t, true);

  const float sc = E::round(a.scale);
  const int pb = pos[w.b];
  for (int x = threadIdx.x; x < w.hi - w.lo; x += kThreads) {
    const int p = kvpos[(size_t)w.b * cap + w.lo + x];
    valid[x] = p >= 0 && p <= pb && (window == 0 || p > pb - window);
  }

  // this lane's chunks of q, scaled in the dtype; 0 past the group or row
  float qf[GT][NC][EPC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 16 * i;
      if (g < w.ng && c < CH) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            q + ((size_t)w.b * H + w.h0 + g) * hd + c * EPC);
        E::load(raw, qf[g][i]);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          qf[g][i][e] = E::round(qf[g][i][e] * sc);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) qf[g][i][e] = 0.f;
      }
    }
  __syncthreads();


  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    const int st = t % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = w.lo + t * TS + hw + kHalfWarps * u;
      // every lane runs the products and shuffles; a masked slot's stale
      // chunk is discarded below
      float dot[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) dot[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        if (lane + 16 * i < CH) {
          float kf[EPC];
          E::load(*stage_chunk<U, NC>(ring, st, u, i), kf);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              dot[g] = fmaf(qf[g][i][e], kf[e], dot[g]);
        }
      }
      const float sum = butterfly<GT, 8>(dot, lane);
      constexpr int kSpan = 16 / GT;         // lanes holding one head's sum
      const int g = lane / kSpan;
      if (j < w.hi && lane % kSpan == 0 && g < w.ng)
        s[((size_t)w.b * H + w.h0 + g) * cap + j] =
            valid[j - w.lo] ? sum : kNegInf;
    }
    issue(t + kStages - 1, false);
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------- p.v
template <typename T, int GT, int NC>
__global__ void __launch_bounds__(kThreads)
    pv_kernel(const Args<T> a) {
  using E = Elem<T>;
  const float* s = a.s;
  const int cap = a.cap, H = a.H, K = a.K, hd = a.hd,
            split_len = a.split_len, n_split = a.n_split;
  constexpr int EPC = E::kPerChunk;
  constexpr int U = 4 / NC;
  constexpr int TS = kHalfWarps * U;
  __shared__ uint4 ring[ring_size<U, NC, GT, EPC>()];
  __shared__ float red[kThreads / 32][GT];
  __shared__ float row_max[GT], row_sum[GT];
  extern __shared__ __align__(16) unsigned char dyn[];
  T* p_sh = reinterpret_cast<T*>(dyn);  // [GT][split_len]: p of the split

  const int G = H / K;
  const Work w = work_of(K, G, GT, cap, split_len);
  const int hw = threadIdx.x / 16, lane = threadIdx.x % 16;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int CH = hd / EPC;
  const float* srow = s + ((size_t)w.b * H + w.h0) * cap;
  const int n = w.hi - w.lo;

  auto needed = [&](int x) {
    bool any = false;
#pragma unroll
    for (int g = 0; g < GT; ++g)
      any |= E::to_float(p_sh[g * split_len + x]) != 0.f;
    return any;
  };
  const size_t row_stride = (size_t)K * hd;
  const T* vb = a.v + ((size_t)w.b * cap * K + w.kh) * hd;
  const int n_tiles = (n + TS - 1) / TS;

  // the first tiles are issued before p exists (every slot loaded; the
  // products still skip the slots whose p is 0), so their loads overlap
  // the row statistics below
  auto issue = [&](int t, bool every) {
    if (t < n_tiles) {
      const int st = t % kStages;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int x = t * TS + hw + kHalfWarps * u;
        if (x < n && (every || needed(x))) {
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int c = lane + 16 * i;
            if (c < CH)
              cp_async16(stage_chunk<U, NC>(ring, st, u, i),
                         vb + (size_t)(w.lo + x) * row_stride + c * EPC);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t, true);

  // the row max and sum of each head over all cap scores, in a fixed order
  // (thread strides, then the warp's xor tree, then warps in order)
  float m[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) m[g] = kNegInf;
  for (int j = threadIdx.x; j < cap; j += kThreads)
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < w.ng) m[g] = fmaxf(m[g], srow[(size_t)g * cap + j]);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      m[g] = fmaxf(m[g], __shfl_xor_sync(kFull, m[g], off));
    if (wl == 0) red[warp][g] = m[g];
  }
  __syncthreads();
  if (threadIdx.x < GT) {
    float x = red[0][threadIdx.x];
    for (int i = 1; i < kThreads / 32; ++i)
      x = fmaxf(x, red[i][threadIdx.x]);
    row_max[threadIdx.x] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) m[g] = row_max[g];
  float l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) l[g] = 0.f;
  for (int j = threadIdx.x; j < cap; j += kThreads)
#pragma unroll
    for (int g = 0; g < GT; ++g)
      if (g < w.ng) l[g] += expf(srow[(size_t)g * cap + j] - m[g]);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      l[g] += __shfl_xor_sync(kFull, l[g], off);
    if (wl == 0) red[warp][g] = l[g];
  }
  __syncthreads();
  if (threadIdx.x < GT) {
    float x = red[0][threadIdx.x];
    for (int i = 1; i < kThreads / 32; ++i) x += red[i][threadIdx.x];
    row_sum[threadIdx.x] = x;
  }
  __syncthreads();
  // p of this split's slots, rounded to the dtype as the plain path's
  // p.to(q.dtype); 0 past the group
  for (int x = threadIdx.x; x < n; x += kThreads)
#pragma unroll
    for (int g = 0; g < GT; ++g)
      p_sh[g * split_len + x] =
          E::cast(g < w.ng ? expf(srow[(size_t)g * cap + w.lo + x] -
                                  row_max[g]) / row_sum[g]
                           : 0.f);
  __syncthreads();


  float acc[GT][NC][EPC];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    const int st = t % kStages;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = t * TS + hw + kHalfWarps * u;
      if (x < n && needed(x)) {
        float pg[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g)
          pg[g] = E::to_float(p_sh[g * split_len + x]);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          if (lane + 16 * i < CH) {
            float vf[EPC];
            E::load(*stage_chunk<U, NC>(ring, st, u, i), vf);
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
              for (int e = 0; e < EPC; ++e)
                acc[g][i][e] = fmaf(pg[g], vf[e], acc[g][i][e]);
          }
        }
      }
    }
    issue(t + kStages - 1, false);
  }
  cp_async_wait<0>();

  // the 8 half-warps' sums, added in a fixed tree (4 + 4, 2 + 2, 1 + 1)
  // through the ring's shared memory: at most 4 x GT x 16 x NC x EPC floats
  float* buf = reinterpret_cast<float*>(ring);
  constexpr int kLaneFloats = NC * EPC;
#pragma unroll
  for (int half = kHalfWarps / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (hw >= half && hw < 2 * half) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            buf[(((hw - half) * GT + g) * 16 + lane) * kLaneFloats +
                i * EPC + e] = acc[g][i][e];
    }
    __syncthreads();
    if (hw < half) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int i = 0; i < NC; ++i)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[g][i][e] += buf[((hw * GT + g) * 16 + lane) * kLaneFloats +
                                i * EPC + e];
    }
  }
  if (hw != 0) return;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= w.ng) continue;
    const size_t bh = (size_t)w.b * H + w.h0 + g;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 16 * i;
      if (c >= CH) continue;
      if (n_split == 1) {
        E::store(a.out + bh * hd + c * EPC, acc[g][i]);
      } else {
        float* dst = a.part + (bh * n_split + blockIdx.y) * hd + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4)
          *reinterpret_cast<float4*>(dst + e) = make_float4(
              acc[g][i][e], acc[g][i][e + 1], acc[g][i][e + 2],
              acc[g][i][e + 3]);
      }
    }
  }
}

// --------------------------------------------------------------- combine
template <typename T>
__global__ void __launch_bounds__(256)
    combine_kernel(const Args<T> a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.B * a.H * a.hd) return;
  const int bh = idx / a.hd, d = idx % a.hd;
  const float* p = a.part + (size_t)bh * a.n_split * a.hd + d;
  float x = 0.f;
  for (int j = 0; j < a.n_split; ++j) x += p[(size_t)j * a.hd];
  a.out[idx] = Elem<T>::cast(x);
}

template <typename T, int GT, int NC>
int launch_gt(Args<T> a, cudaStream_t stream) {
  const int groups = (a.H / a.K + GT - 1) / GT;
  const dim3 grid(a.B * a.K * groups, a.n_split);
  scores_kernel<T, GT, NC><<<grid, kThreads, a.split_len, stream>>>(a);
  pv_kernel<T, GT, NC>
      <<<grid, kThreads, (size_t)GT * a.split_len * sizeof(T), stream>>>(a);
  if (a.n_split > 1) {
    const int n = a.B * a.H * a.hd;
    combine_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_nc(Args<T> a, cudaStream_t stream) {
  // the smallest power of two that holds G, at most 8 (ops.plan's rule)
  const int G = a.H / a.K;
  if (G > 4) return launch_gt<T, 8, NC>(a, stream);
  if (G > 2) return launch_gt<T, 4, NC>(a, stream);
  if (G == 2) return launch_gt<T, 2, NC>(a, stream);
  return launch_gt<T, 1, NC>(a, stream);
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* k_new,
           const void* v_new, const void* kvpos, const void* pos, void* out,
           void* scratch, int B, int cap, int H, int K, int hd, int window,
           int split_len, float scale, cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<T*>(k);
  a.v = static_cast<T*>(v);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.kvpos = static_cast<const int*>(kvpos);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<T*>(out);
  a.s = static_cast<float*>(scratch);
  // the partial sums start on a 256-byte boundary (float4 stores)
  a.part = a.s + ((size_t)B * H * cap + 63) / 64 * 64;
  a.B = B;
  a.cap = cap;
  a.H = H;
  a.K = K;
  a.hd = hd;
  a.window = window;
  a.split_len = split_len;
  a.n_split = (cap + split_len - 1) / split_len;
  a.scale = scale;
  // a lane takes one 16-byte chunk of a row up to 256-byte rows, two up to
  // 512 (the wrapper's limit)
  return hd * (int)sizeof(T) > 256 ? launch_nc<T, 2>(a, stream)
                                   : launch_nc<T, 1>(a, stream);
}

}  // namespace dattn

extern "C" {

// Returns cudaGetLastError() after the launches: nonzero means a launch was
// refused.  The wrapper (ops.py) checks shapes, dtypes, contiguity, K | H,
// hd % 8 == 0, rows of at most 512 bytes and 16-byte aligned pointers, and
// sizes `scratch` (float32) as ops.scratch_bytes: B * H * cap scores
// (rounded up to 64 floats), then B * H * n_split * hd partial sums when
// cap > split_len.  split_len is a multiple of 32 and at most
// min(1024, 2048 / GT) (ops.plan): p of a split, kept in the dtype, takes
// at most 4 KB of shared memory in bf16 (8 KB in float32) beside the
// ring's 24 KB.  window 0 = none.  k_new and v_new (B, 1, K, hd), both
// null or both set: written into slot pos % cap of k and v first.
int ksp_decode_attention_f32(const void* q, void* k, void* v,
                             const void* k_new, const void* v_new,
                             const void* kvpos, const void* pos, void* out,
                             void* scratch, int B, int cap, int H, int K,
                             int hd, int window, int split_len, float scale,
                             cudaStream_t stream) {
  hopper::enter();
  return dattn::launch<float>(q, k, v, k_new, v_new, kvpos, pos, out,
                              scratch, B, cap, H, K, hd, window, split_len,
                              scale, stream);
}

int ksp_decode_attention_bf16(const void* q, void* k, void* v,
                              const void* k_new, const void* v_new,
                              const void* kvpos, const void* pos, void* out,
                              void* scratch, int B, int cap, int H, int K,
                              int hd, int window, int split_len, float scale,
                              cudaStream_t stream) {
  hopper::enter();
  return dattn::launch<__nv_bfloat16>(q, k, v, k_new, v_new, kvpos, pos,
                                      out, scratch, B, cap, H, K, hd, window,
                                      split_len, scale, stream);
}

}  // extern "C"
