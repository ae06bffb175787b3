// Mamba2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::ssd_kernel.  In the
// model layout, x (B,S,H,P) pre-multiplied by dt, a (B,S,H) log-decays,
// b and c (B,S,G,N) with head h reading group h / (H/G).  Per chunk of rows,
// with the state (P,N) carried from the chunk before:
//   cum   = cumsum(a)
//   L     = exp(cum_i - cum_j) for i >= j, else 0
//   y     = ((C B^T) o L) x + (C o exp(cum)) state^T
//   state = state * exp(cum_last) + x^T (B o exp(cum_last - cum))
// Outputs y in x's dtype and the final state in float32 (B,H,P,N).  The
// result does not depend on the chunk size, so each instance picks its own.
//
// Bound: memory at the model's shapes.  Per row and head the scan reads x
// and writes y (P elements each; B, C and a are shared or small) and does
// at most 2*(64*(N + P) + 2*P*N) flops in the 64-row form: ~128 flops per
// bf16 byte at P = N = 64, under the card's ridge of ~295 (989 TFLOP/s over
// 3.35 TB/s).  Two instances, chosen by dtype in the wrapper:
//
// bf16 (the serving path; namespace ssd3): the chunked dual form in three
// kernels per call, with chunks of kT = 256 rows (the model's chunk, which
// keeps the state scratch smallest):
//   1. ssd_states, grid (chunks, H, B): the chunk's cumsum of a (float32)
//      and its own state s_c = x^T (B o exp(cum_last - cum)) as wgmmas over
//      the chunk's rows, which stream through a 2-stage TMA ring in 64-row
//      sub-tiles; s_c and cum go to float32 scratch;
//   2. ssd_pass, per (b, h) and state element: the states entering each
//      chunk, s_in[c] = s_in[c-1] exp(cum_last[c-1]) + s_{c-1}, sequential
//      over the chunks (8 at S = 2048), into bf16 scratch as a hi and lo
//      pair, and the final state in float32;
//   3. ssd_scan, grid (64-row tiles, H, B): y for 64 rows from wgmmas
//      C s_in^T and, over the chunk's 64-key sub-tiles up to the diagonal
//      (streamed through a 2-stage TMA ring), C B_j^T and ((C B_j^T) o L) x_j
//      with the masked scores as bf16 register operands (hi and lo).
// Every tile is loaded by a producer warp with TMA (64-column boxes,
// 128-byte swizzle, ragged tails of S, P and N zero-filled: nothing is
// padded or copied) and consumed by one warpgroup.  x, B and C are bf16
// inputs, so every product is exact but for the operands the kernel
// computes: B o exp(cum_last - cum), s_in and (C B^T) o L.  Each of those
// is split into a bf16 hi and lo pair (two wgmmas, ~16 bits kept): one
// bf16 rounding (2^-9 relative) carried errors of 0.035 into y where its
// terms cancel, past the 2e-2 that y is held to, and into every state,
// held to 5e-3.  The products are a small part of a byte-bound kernel, so
// the second wgmma is cheap.  Parallelism: 2,560 blocks in pass 1 and
// 10,240 in pass 3 at the serving batch of 4 x 2048 on zamba2 (80 heads),
// where the old design had 320.
//
// float32 (parity checks only: held to 5e-3, which TF32 could not hold):
// the CUDA-core body below, one block of 256 threads per (b, h),
// sequential over sub-chunks of kSub = 64 rows (at the model's chunk of 256
// the 256 x 256 float32 score tile alone is 256 KB, more than a block's
// 227 KB).  The state (P x N float32) lives in shared memory for the whole
// sequence; per sub-chunk the x, B and C rows are staged in shared memory
// as float32 (ragged tails read as zeros), warp 0 takes the cumulative sum
// of a with shuffles, and the three products run on the CUDA cores.
// Shared-memory rows of B, C and the state have an odd float stride
// (N + 1) so the threads of a warp read distinct banks.
//
// Both instances evaluate exp(cum_i - cum_j) on the lower triangle only:
// above it the exponent is positive and can overflow, and inf * 0 would be
// NaN.
//
// Built without --use_fast_math: the float32 path is held to 5e-3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kSub = 64;       // rows per sub-chunk
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int P, int N) {
  const size_t ldn = N + 1;
  return sizeof(float) * (P * ldn + (size_t)kSub * P + 2 * kSub * ldn +
                          (size_t)kSub * (kSub + 1) + 3 * kSub);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const T* __restrict__ x, const T* __restrict__ a,
            const T* __restrict__ bm, const T* __restrict__ cm,
            T* __restrict__ y,
            float* __restrict__ final_state, int S, int H, int P, int G,
            int N) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  const int ldg = kSub + 1;
  float* St = smem;               // P x ldn    the carried state (p, n)
  float* Xs = St + P * ldn;       // kSub x P   x rows
  float* Bs = Xs + kSub * P;      // kSub x ldn B rows (then B o decay)
  float* Cs = Bs + kSub * ldn;    // kSub x ldn C rows
  float* Gs = Cs + kSub * ldn;    // kSub x ldg (C B^T) o L
  float* cum = Gs + kSub * ldg;   // kSub
  float* dec = cum + kSub;        // kSub       exp(cum_last - cum_j)
  float* ecum = dec + kSub;       // kSub       exp(cum_i)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    St[p * ldn + n] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += kSub) {
    __syncthreads();  // the previous sub-chunk is done with every tile
    for (int i = tid; i < kSub * P; i += kThreads) {
      const int r = i / P, p = i % P, s = s0 + r;
      Xs[i] = s < S ? to_f32(x[(((size_t)b * S + s) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < kSub * N; i += kThreads) {
      const int r = i / N, n = i % N, s = s0 + r;
      float bv = 0.f, cv = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * G + g) * N + n;
        bv = to_f32(bm[off]);
        cv = to_f32(cm[off]);
      }
      Bs[r * ldn + n] = bv;
      Cs[r * ldn + n] = cv;
    }
    if (tid < 32) {  // inclusive cumsum of a: two rows per lane
      const int r0 = 2 * tid, r1 = r0 + 1;
      const size_t base = ((size_t)b * S + s0) * H + h;
      const float a0 = s0 + r0 < S ? to_f32(a[base + (size_t)r0 * H]) : 0.f;
      const float a1 = s0 + r1 < S ? to_f32(a[base + (size_t)r1 * H]) : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      cum[r0] = excl + a0;
      cum[r1] = (excl + a0) + a1;
    }
    __syncthreads();
    const float clast = cum[kSub - 1];
    if (tid < kSub) {
      dec[tid] = expf(clast - cum[tid]);
      ecum[tid] = expf(cum[tid]);
    }

    // (C B^T) o L for rows ty + 16 i and columns tx + 16 j
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float ci[4], bj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ci[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bj[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ci[i], bj[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float v = 0.f;
          if (r >= c) v = acc[i][j] * expf(cum[r] - cum[c]);
          Gs[r * ldg + c] = v;
        }
      }
    }
    __syncthreads();

    // y rows ty + 16 i, columns p = tx + 16 j:
    //   sum_c G[r][c] x[c][p] + exp(cum_r) * sum_n C[r][n] state[p][n]
    {
      float yd[4][kMaxP / 16], yo[4][kMaxP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j) yd[i][j] = yo[i][j] = 0.f;
      for (int c = 0; c < kSub; ++c) {
        float gi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gi[i] = Gs[(ty + 16 * i) * ldg + c];
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float xv = Xs[c * P + p];
#pragma unroll
            for (int i = 0; i < 4; ++i) yd[i][j] = fmaf(gi[i], xv, yd[i][j]);
          }
        }
      }
      for (int n = 0; n < N; ++n) {
        float ci[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ci[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j) {
          const int p = tx + 16 * j;
          if (p < P) {
            const float sv = St[p * ldn + n];
#pragma unroll
            for (int i = 0; i < 4; ++i) yo[i][j] = fmaf(ci[i], sv, yo[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, s = s0 + r;
        if (s >= S) continue;
        T* row = y + (((size_t)b * S + s) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kMaxP / 16; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(row + p, yd[i][j] + ecum[r] * yo[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    for (int i = tid; i < kSub * N; i += kThreads) {
      const int r = i / N, n = i % N;
      Bs[r * ldn + n] *= dec[r];
    }
    __syncthreads();

    // state[p][n] = state[p][n] * exp(cum_last) + sum_r x[r][p] B'[r][n]
    const float keep = expf(clast);
#pragma unroll
    for (int pi = 0; pi < kMaxP / 16; ++pi) {
      const int p = ty + 16 * pi;
      if (p >= P) break;
      float inc[kMaxN / 16];
#pragma unroll
      for (int j = 0; j < kMaxN / 16; ++j) inc[j] = 0.f;
      for (int r = 0; r < kSub; ++r) {
        const float xv = Xs[r * P + p];
#pragma unroll
        for (int j = 0; j < kMaxN / 16; ++j) {
          const int n = tx + 16 * j;
          if (n < N) inc[j] = fmaf(xv, Bs[r * ldn + n], inc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxN / 16; ++j) {
        const int n = tx + 16 * j;
        if (n < N) St[p * ldn + n] = St[p * ldn + n] * keep + inc[j];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    final_state[state_off + i] = St[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* final_state, int B, int S, int H, int P, int G,
           int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, P, G, N);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ bf16
namespace ssd3 {

using namespace hopper;

constexpr int kT = 256;                    // chunk rows (the model's chunk)
constexpr int kR = 64;                     // rows of a sub-tile
constexpr int kSubs = kT / kR;
constexpr int kStages = 2;                 // the ring of passes 1 and 3
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRegion = kR * kRowBytes;    // 64 columns x 64 rows: 8 KB

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + (((smem_u32(raw) + 1023) & ~1023u) - smem_u32(raw));
}

// Inclusive cumsum in float32 of a over the chunk's kT rows from index
// `base` (rows `H` apart), by the 128 consumer threads, two rows each;
// rows at or past `rows` read 0.
__device__ __forceinline__ void chunk_cumsum(const __nv_bfloat16* a,
                                             size_t base, int rows, int H,
                                             float* cum, float* warp_tot,
                                             int tid) {
  const int r0 = 2 * tid, lane = tid % 32;
  const float a0 = r0 < rows ? __bfloat162float(a[base + (size_t)r0 * H])
                             : 0.f;
  const float a1 = r0 + 1 < rows
                       ? __bfloat162float(a[base + (size_t)(r0 + 1) * H])
                       : 0.f;
  const float pair = a0 + a1;
  float incl = pair;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_tot[tid / 32] = incl;
  named_sync(1, kConsumers);
  float off = 0.f;
  for (int w = 0; w < tid / 32; ++w) off += warp_tot[w];
  const float excl = off + incl - pair;
  cum[r0] = excl + a0;
  cum[r0 + 1] = (excl + a0) + a1;
  named_sync(1, kConsumers);
}

// Pass 1, one block per (chunk, h, b): the chunk's own state
//   s_c = x^T (B o exp(cum_last - cum))     (P x N, float32)
// and its cumsum of a (into cum_out).  x and B stream
// through the ring in 64-row sub-tiles; B o decay is rewritten in shared
// memory as a bf16 hi part (in place) plus a bf16 lo part, so the product
// keeps ~16 bits of the decayed B (two wgmmas, x^T and B MN-major).  With
// OWN the decay is exp(cum) instead: fed dY and C, the block gives the
// backward's share of the chunk in the gradient of the state entering it,
// dY^T (C o exp(cum)) (the kernel ssd_bwd_own).  NP: N rounded up to 16;
// MT: 64-row tiles of P.
template <int NP, int MT, bool OWN>
__device__ __forceinline__ void chunk_states(
    const CUtensorMap& tx, const CUtensorMap& tb,
    const __nv_bfloat16* __restrict__ a, float* __restrict__ states,
    float* __restrict__ cum_out, int S, int H, int P, int G, int N, int nc) {
  constexpr int NR = (NP + kRegionCols - 1) / kRegionCols;
  constexpr int kX = MT * kRegion;
  constexpr int kStage = kX + NR * kRegion;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);            // kStages x (x, B)
  uint8_t* lo = ring + kStages * kStage;          // NR regions
  float* cum = reinterpret_cast<float*>(lo + NR * kRegion);  // kT
  float* dec = cum + kT;                                     // kT
  float* warp_tot = dec + kT;                                // 8
  uint64_t* full = reinterpret_cast<uint64_t*>(warp_tot + 8);
  uint64_t* empty = full + kStages;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int row0 = c * kT;
  const int rows = min(kT, S - row0);
  const int n_sub = (rows + kR - 1) / kR;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      for (int u = 0; u < n_sub; ++u) {
        const int s = u % kStages;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        uint8_t* st = ring + s * kStage;
        for (int r = 0; r < MT; ++r)
          tma_load_4d(st + r * kRegion, &tx, &full[s], r * kRegionCols, h,
                      row0 + u * kR, b);
        for (int r = 0; r < NR; ++r)
          tma_load_4d(st + kX + r * kRegion, &tb, &full[s], r * kRegionCols,
                      g, row0 + u * kR, b);
      }
    }
    return;
  }

  chunk_cumsum(a, ((size_t)b * S + row0) * H + h, rows, H, cum, warp_tot,
               tid);
  const float clast = cum[kT - 1];
  for (int r = tid; r < kT; r += kConsumers) {
    dec[r] = expf(OWN ? cum[r] : clast - cum[r]);
    if (!OWN) cum_out[(((size_t)b * H + h) * nc + c) * kT + r] = cum[r];
  }

  float acc[MT][NP / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[m][i] = 0.f;

  for (int u = 0; u < n_sub; ++u) {
    const int s = u % kStages;
    uint8_t* st = ring + s * kStage;
    uint8_t* bt = st + kX;
    // dec is written; the last sub-tile's wgmmas are done with `lo`
    named_sync(1, kConsumers);
    mbar_wait(&full[s], (u / kStages) & 1);
    // B o decay -> hi (in place) + lo; a 16-byte chunk is 8 columns of one
    // row (the swizzle permutes chunks within a row, never across rows)
    for (int ch = tid; ch < NR * kR * 8; ch += kConsumers) {
      const float d = dec[u * kR + (ch / 8) % kR];
      uint4 hv = reinterpret_cast<const uint4*>(bt)[ch];
      uint4 lv;
      __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&hv);
      __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(&lv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(ph[q]);
        const float fx = f.x * d, fy = f.y * d;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(fx, fy);
        const float2 fh = __bfloat1622float2(hi);
        pl[q] = __floats2bfloat162_rn(fx - fh.x, fy - fh.y);
        ph[q] = hi;
      }
      reinterpret_cast<uint4*>(bt)[ch] = hv;
      reinterpret_cast<uint4*>(lo)[ch] = lv;
    }
    fence_proxy_async();
    named_sync(1, kConsumers);

    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk) {
        const uint32_t row = kk * 16 * kRowBytes;
        const uint64_t da =
            desc_sw128(smem_u32(st) + m * kRegion + row, kRegion, 1024);
        wgmma_ss<NP, 1, 1>(acc[m], da,
                           desc_sw128(smem_u32(bt) + row, kRegion, 1024), 1);
        wgmma_ss<NP, 1, 1>(acc[m], da,
                           desc_sw128(smem_u32(lo) + row, kRegion, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    mbar_arrive(&empty[s]);
  }

  // states (B, nc, H, P, N): row p = 64 m + 16 w + lane / 4 (+ 8), column n
  const int w = tid / 32, lane = tid % 32;
  float* dst = states + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = m * 64 + w * 16 + lane / 4 + 8 * (e >> 1);
        const int n = 8 * j + 2 * (lane % 4) + (e & 1);
        if (p < P && n < N) dst[(size_t)p * N + n] = acc[m][4 * j + e];
      }
}

template <int NP, int MT>
__global__ void __launch_bounds__(kThreads)
    ssd_states(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tb,
               const __nv_bfloat16* __restrict__ a,
               float* __restrict__ states, float* __restrict__ cum_out,
               int S, int H, int P, int G, int N, int nc) {
  chunk_states<NP, MT, false>(tx, tb, a, states, cum_out, S, H, P, G, N, nc);
}

template <int NP, int MT>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_own(const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap tc,
                const __nv_bfloat16* __restrict__ a, float* __restrict__ own,
                int S, int H, int P, int G, int N, int nc) {
  chunk_states<NP, MT, true>(tdy, tc, a, own, nullptr, S, H, P, G, N, nc);
}

// Pass 2, per (b, h) and state element: the state entering each chunk,
//   s_in[0] = 0,  s_in[c] = s_in[c-1] exp(cum_last[c-1]) + s_{c-1},
// for pass 3 as a bf16 hi and lo pair (B, nc, H, 2, P, N), and the final
// state in float32.
__global__ void __launch_bounds__(256)
    ssd_pass(const float* __restrict__ states, const float* __restrict__ cum,
             __nv_bfloat16* __restrict__ s_in, float* __restrict__ final_state,
             int H, int PN, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t off = (((size_t)b * nc + c) * H + h) * PN + e;
    const float own = states[off];
    const __nv_bfloat16 hi = __float2bfloat16_rn(run);
    __nv_bfloat16* dst = s_in + (((size_t)b * nc + c) * H + h) * 2 * PN + e;
    dst[0] = hi;
    dst[PN] = __float2bfloat16_rn(run - __bfloat162float(hi));
    run = run * expf(cum[(((size_t)b * H + h) * nc + c) * kT + kT - 1]) + own;
  }
  final_state[((size_t)b * H + h) * PN + e] = run;
}

// Pass 3, one block per (64-row tile of the sequence, h, b):
//   y = diag(exp(cum)) (C s_in^T) + sum_{j <= i} ((C B_j^T) o L) x_j
// over the key sub-tiles j of the row tile's chunk up to its own (as causal
// flash walks keys), so the chunk's 256 x 256 score tile never has to fit.
// C B_j^T and C s_in^T are wgmmas with K-major operands; (C B_j^T) o L is
// split in registers into a bf16 hi and lo pair, the A operands of two
// products with x_j (MN-major), and s_in comes as a hi and lo pair too:
// one bf16 rounding of either would put errors of 2^-9 of the largest
// terms into y, past the 2e-2 that y is held to where terms cancel.
// exp(cum_i - cum_j) is evaluated on the lower triangle only.  (A block of
// two row tiles sharing one key stream ran slower on the card: each
// warpgroup waits on the other's ring slots.)  PP: P rounded up to 16.
template <int PP>
__global__ void __launch_bounds__(kThreads)
    ssd_scan(const __grid_constant__ CUtensorMap tc,
             const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap ts,
             const float* __restrict__ cum, __nv_bfloat16* __restrict__ y,
             int S, int H, int P, int G, int N, int nc) {
  constexpr int PR = (PP + kRegionCols - 1) / kRegionCols;
  constexpr int ld = PP / 2 + 4;  // 32-bit words of a staged row of y
  const int nr = (N + kRegionCols - 1) / kRegionCols;
  const int nk = round_up(N, 16) / 16;  // k-steps over the state dim
  const int s_region = PP * kRowBytes;  // a region of the s_in tile
  const int stage = (nr + PR) * kRegion;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* c_s = align1024(smem_raw);       // nr regions
  uint8_t* s_s = c_s + nr * kRegion;        // 2 x nr regions of PP rows
  uint8_t* ring = s_s + 2 * nr * s_region;  // kStages x (B_j, x_j)
  float* cum_s = reinterpret_cast<float*>(ring + kStages * stage);  // kT
  uint64_t* bar_c = reinterpret_cast<uint64_t*>(cum_s + kT);
  uint64_t* full = bar_c + 1;
  uint64_t* empty = full + kStages;
  static_assert(kR * ld * 4 <= kStages * (1 + PR) * kRegion, "ring size");

  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c = it / kSubs;      // the row tile's chunk
  const int j0 = c * kSubs;      // the chunk's first row tile
  const int n_kt = it - j0 + 1;  // key tiles j0 .. it
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_c, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(bar_c, nr * (kRegion + 2 * s_region));
      for (int r = 0; r < nr; ++r) {
        tma_load_4d(c_s + r * kRegion, &tc, bar_c, r * kRegionCols, g,
                    it * kR, b);
        for (int q = 0; q < 2; ++q)  // hi, lo
          tma_load_3d(s_s + (q * nr + r) * s_region, &ts, bar_c,
                      r * kRegionCols, 0, ((b * nc + c) * H + h) * 2 + q);
      }
      for (int u = 0; u < n_kt; ++u) {
        const int s = u % kStages;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], stage);
        uint8_t* st = ring + s * stage;
        for (int r = 0; r < nr; ++r)
          tma_load_4d(st + r * kRegion, &tb, &full[s], r * kRegionCols, g,
                      (j0 + u) * kR, b);
        for (int r = 0; r < PR; ++r)
          tma_load_4d(st + (nr + r) * kRegion, &tx, &full[s],
                      r * kRegionCols, h, (j0 + u) * kR, b);
      }
    }
    return;
  }

  const float* cum_src = cum + (((size_t)b * H + h) * nc + c) * kT;
  // the cumsum in the log2 domain: every exponential below is one ex2 on
  // the special-function unit (y is held to 2e-2; ex2.approx is good to
  // ~2^-22 relative)
  for (int r = tid; r < kT; r += kConsumers)
    cum_s[r] = cum_src[r] * 1.4426950408889634f;
  named_sync(1, kConsumers);

  const int w = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int rr0 = (it - j0) * kR + w * 16 + lane / 4;  // chunk-relative rows
  const uint32_t ca = smem_u32(c_s), sa = smem_u32(s_s);

  // y = sum_j ((C B_j^T) o L) x_j, then + exp(cum) o (C s_in^T).  No
  // accumulator is zeroed or scaled by hand between its products: the first
  // wgmma of each product does not add (scale_d = 0), and the state term is
  // added once all products are in.  (ptxas still serialises this kernel's
  // wgmmas, advisory C7515: it schedules the packing of the next A
  // fragment into registers an issued wgmma reads.)
  float acc[PP / 2];
  for (int u = 0; u < n_kt; ++u) {
    const int s = u % kStages;
    mbar_wait(&full[s], (u / kStages) & 1);
    const uint32_t bt = smem_u32(ring + s * stage);
    const uint32_t xt = bt + nr * kRegion;

    float gs[kR / 2];  // C B_j^T: 64 rows x 64 keys
    if (u == 0) mbar_wait(bar_c, 0);
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk) {
      const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
      wgmma_ss<kR, 0, 0>(gs, desc_sw128(ca + off, 16, 1024),
                         desc_sw128(bt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gs);

    // o L: row rr sees key kc <= rr with weight exp(cum_rr - cum_kc)
#pragma unroll
    for (int j = 0; j < kR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = u * kR + 8 * j + 2 * t4 + (e & 1);
        const int rr = rr0 + 8 * (e >> 1);
        gs[4 * j + e] =
            rr >= kc ? gs[4 * j + e] * exp2_ftz(cum_s[rr] - cum_s[kc])
                     : 0.f;
      }
    uint32_t ga[kR / 16][4], gl[kR / 16][4];
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) a_frag_split(gs, kk, ga[kk], gl[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      const uint64_t dx = desc_sw128(xt + kk * 16 * kRowBytes, kRegion, 1024);
      wgmma_rs<PP, 1>(acc, ga[kk], dx, u > 0 || kk > 0);
      wgmma_rs<PP, 1>(acc, gl[kk], dx, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  float ys[PP / 2];  // C (s_in hi + s_in lo)^T
  wgmma_fence();
  for (int q = 0; q < 2; ++q) {
    for (int kk = 0; kk < nk; ++kk) {
      const uint32_t k_off = (kk % 4) * 32;
      wgmma_ss<PP, 0, 0>(
          ys, desc_sw128(ca + (kk / 4) * kRegion + k_off, 16, 1024),
          desc_sw128(sa + (q * nr + kk / 4) * s_region + k_off, 16, 1024),
          q > 0 || kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ys);
  const float e0 = exp2_ftz(cum_s[rr0]), e1 = exp2_ftz(cum_s[rr0 + 8]);
#pragma unroll
  for (int j = 0; j < PP / 8; ++j) {
    acc[4 * j] += e0 * ys[4 * j];
    acc[4 * j + 1] += e0 * ys[4 * j + 1];
    acc[4 * j + 2] += e1 * ys[4 * j + 2];
    acc[4 * j + 3] += e1 * ys[4 * j + 3];
  }

  // y through shared memory (the ring is free now), so that each row of P
  // bf16 leaves in 16-byte pieces from neighbouring threads; rows are
  // padded by 16 bytes so the quad rows of a warp hit distinct banks
  uint32_t* stage_y = reinterpret_cast<uint32_t*>(ring);  // kR x ld
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < PP / 8; ++j)
      stage_y[row * ld + 4 * j + t4] =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
  named_sync(1, kConsumers);
  const int chunks = P / 8;  // 16-byte pieces of a row
  for (int i = tid; i < kR * chunks; i += kConsumers) {
    const int row = i / chunks, piece = i % chunks;
    const int s_row = it * kR + row;
    if (s_row < S)
      *reinterpret_cast<uint4*>(y + (((size_t)b * S + s_row) * H + h) * P +
                                8 * piece) =
          reinterpret_cast<const uint4*>(stage_y + row * ld)[piece];
  }
}

template <int NP, int MT>
int launch_states_np(const CUtensorMap& tx, const CUtensorMap& tb,
                     const void* a, float* states, float* cum, int B, int S,
                     int H, int P, int G, int N, int nc, int own_grad,
                     cudaStream_t stream) {
  constexpr int NR = (NP + kRegionCols - 1) / kRegionCols;
  const size_t smem = 1024 + (size_t)(kStages * (MT + NR) + NR) * kRegion +
                      (2 * kT + 8) * sizeof(float) + 64;
  const dim3 grid(nc, H, B);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);
  int err = own_grad ? set_smem(ssd_bwd_own<NP, MT>, smem)
                     : set_smem(ssd_states<NP, MT>, smem);
  if (err) return err;
  if (own_grad)
    ssd_bwd_own<NP, MT><<<grid, kThreads, smem, stream>>>(
        tx, tb, ab, states, S, H, P, G, N, nc);
  else
    ssd_states<NP, MT><<<grid, kThreads, smem, stream>>>(
        tx, tb, ab, states, cum, S, H, P, G, N, nc);
  return (int)cudaGetLastError();
}

// Pass 1 over tx (x, or dY) and tb (B, or C): the chunk states and cum
// (ssd_states), or with own_grad the chunks' shares of the state gradient
// (ssd_bwd_own), into `states`.
int launch_states(const CUtensorMap& tx, const CUtensorMap& tb,
                  const void* a, float* states, float* cum, int B, int S,
                  int H, int P, int G, int N, int nc, int own_grad,
                  cudaStream_t stream) {
#define KSP_STATES(np, mt)                                                 \
  case np * 4 + mt:                                                        \
    return launch_states_np<np, mt>(tx, tb, a, states, cum, B, S, H, P, G, \
                                    N, nc, own_grad, stream);
  switch (round_up(N, 16) * 4 + (P > 64 ? 2 : 1)) {
    KSP_STATES(16, 1) KSP_STATES(32, 1) KSP_STATES(48, 1) KSP_STATES(64, 1)
    KSP_STATES(80, 1) KSP_STATES(96, 1) KSP_STATES(112, 1)
    KSP_STATES(128, 1) KSP_STATES(16, 2) KSP_STATES(32, 2)
    KSP_STATES(48, 2) KSP_STATES(64, 2) KSP_STATES(80, 2) KSP_STATES(96, 2)
    KSP_STATES(112, 2) KSP_STATES(128, 2)
  }
#undef KSP_STATES
  return (int)cudaErrorInvalidValue;
}

template <int PP>
int launch_scan(const CUtensorMap& tc, const CUtensorMap& tb,
                const CUtensorMap& tx, const CUtensorMap& ts,
                const float* cum, void* y, int B, int S, int H, int P, int G,
                int N, int nc, cudaStream_t stream) {
  constexpr int PR = (PP + kRegionCols - 1) / kRegionCols;
  const int nr = (N + kRegionCols - 1) / kRegionCols;
  const size_t smem = 1024 + (size_t)nr * (kRegion + 2 * PP * kRowBytes) +
                      (size_t)kStages * (nr + PR) * kRegion +
                      kT * sizeof(float) + 64;
  int err = set_smem(ssd_scan<PP>, smem);
  if (err) return err;
  ssd_scan<PP><<<dim3((S + kR - 1) / kR, H, B), kThreads, smem, stream>>>(
      tc, tb, tx, ts, cum, static_cast<__nv_bfloat16*>(y), S, H, P, G, N,
      nc);
  return (int)cudaGetLastError();
}

// The tensor map of a (B, S, heads, width) bf16 tensor in 64-column x
// 64-row boxes (the model layout: a tile's rows heads * width apart).
int encode_rows(CUtensorMap* map, const void* base, int B, int S, int heads,
                int width) {
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint32_t box[4] = {kRegionCols, 1, kR, 1};
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t str[3] = {width * e, heads * width * e,
                             (cuuint64_t)S * heads * width * e};
  return encode_bf16_map(map, base, 4, dims, str, box);
}

// The tensor map of `count` (P, N) bf16 states (s_in and its hi / lo
// layout (B, nc, H, 2, P, N)), a box of 64 columns x `rows` rows (rows past
// P are zero-filled).
int encode_states(CUtensorMap* map, const void* base, int P, int N,
                  int count, int rows) {
  const cuuint64_t e = 2;
  const cuuint32_t box[3] = {kRegionCols, (cuuint32_t)rows, 1};
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)P,
                              (cuuint64_t)count};
  const cuuint64_t str[2] = {N * e, (cuuint64_t)P * N * e};
  return encode_bf16_map(map, base, 3, dims, str, box);
}

// Passes 1 and 2: s_in (B, nc, H, 2, P, N) bf16 (hi, lo), cum (B, H, nc, kT)
// float32 and the final state, with `states` (B, nc, H, P, N) float32 as
// scratch.
int states_pass(const CUtensorMap& tx, const CUtensorMap& tb, const void* a,
                float* states, void* s_in, float* cum, void* final_state,
                int B, int S, int H, int P, int G, int N, cudaStream_t stream) {
  const int nc = (S + kT - 1) / kT;
  int err =
      launch_states(tx, tb, a, states, cum, B, S, H, P, G, N, nc, 0, stream);
  if (err) return err;
  const int PN = P * N;
  ssd_pass<<<dim3((PN + 255) / 256, H, B), 256, 0, stream>>>(
      states, cum, static_cast<__nv_bfloat16*>(s_in),
      static_cast<float*>(final_state), H, PN, nc);
  return (int)cudaGetLastError();
}

// The three passes of one ssd() call, on `stream`.  Scratch from the
// wrapper: states (B, nc, H, P, N) float32, s_in (B, nc, H, 2, P, N) bf16
// (hi, lo), cum (B, H, nc, kT) float32, with nc = ceil(S / kT).
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* final_state, void* states, void* s_in, void* cum,
           int B, int S, int H, int P, int G, int N, cudaStream_t stream) {
  const int nc = (S + kT - 1) / kT;
  CUtensorMap tx, tb, tc, ts;
  int err = encode_rows(&tx, x, B, S, H, P);
  if (!err) err = encode_rows(&tb, b, B, S, G, N);
  if (!err) err = encode_rows(&tc, c, B, S, G, N);
  if (!err)
    err = encode_states(&ts, s_in, P, N, B * nc * H * 2, round_up(P, 16));
  if (err) return err;
  float* cm = static_cast<float*>(cum);
  err = states_pass(tx, tb, a, static_cast<float*>(states), s_in, cm,
                    final_state, B, S, H, P, G, N, stream);
  if (err) return err;
#define KSP_SCAN(pp)                                                       \
  case pp:                                                                 \
    return launch_scan<pp>(tc, tb, tx, ts, cm, y, B, S, H, P, G, N, nc,    \
                           stream);
  switch (round_up(P, 16)) {
    KSP_SCAN(16) KSP_SCAN(32) KSP_SCAN(48) KSP_SCAN(64)
    KSP_SCAN(80) KSP_SCAN(96) KSP_SCAN(112) KSP_SCAN(128)
  }
#undef KSP_SCAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd3

// --------------------------------------------------------------- backward
//
// The backward of both instances (no Pallas counterpart: the reference
// trains through the XLA form models/mamba2.py::ssd_chunked and JAX's
// autodiff).  From x, a, B, C and dy (and the final state's gradient, or
// zero) it gives dx, da, dB and dC in the inputs' dtype.  Per chunk, with
// cum = cumsum(a), e_j = exp(cum_last - cum_j), L = exp(cum_i - cum_j) on
// the lower triangle (evaluated there only: above it the exponent can
// overflow), the state entering the chunk s and the gradient of the state
// leaving it ds:
//   dx_j = sum_i ((C B^T) o L)_ij dy_i + e_j (ds B_j)
//   dC_i = sum_j (dy_i.x_j) L_ij B_j + exp(cum_i) s^T dy_i
//   dB_j = sum_i (dy_i.x_j) L_ij C_i + e_j ds^T x_j
//   dcum from L (both indices), exp(cum_i) against s and the decays into
//   the outgoing state; da = its reverse cumsum within the chunk;
//   ds of the chunk before = ds exp(cum_last) + sum_i exp(cum_i) dy_i (x) C_i.
// dB and dC are taken per head into float32 partials (B, S, H, N) and
// summed over each group's heads in a fixed order by ssd_bwd_group.  Every
// sum is taken by one thread or one block in a fixed order: no atomics, so
// the gradients do not depend on scheduling.
//
// Bound: memory, as the forward.  Two instances, chosen by dtype in the
// wrapper:
//
// bf16 (training; namespace sbwd3): the forward's chunks of kT = 256 rows in
// 64-row sub-tiles, and the forward's own entering states s_in (hi, lo) and
// cumsums, which _SSD saves (the wrapper runs the forward's passes 1 and 2
// for a call without them).  Per call:
//   1. ssd3::ssd_bwd_own (the forward's pass 1 with the decay exp(cum)),
//      fed dY and C: each chunk's share of the state gradient,
//      dY^T (C o exp(cum)), on wgmma;
//   2. ssd_bwd_dpass, per (b, h) and state element: ds of every chunk in
//      reverse from dfinal (or 0), as a bf16 hi and lo pair, and per block
//      the partial sums of <ds, s_in> that dcum_last takes;
//   3. ssd_bwd_rows, one block per (64-row sub-tile J, h, b), over the
//      chunk's sub-tiles I >= J streamed through a 2-stage TMA ring: dx_J
//      and the per-head dB_J from wgmmas B_J C_I^T and x_J dY_I^T (masked by
//      L in registers into bf16 hi / lo A operands) times dY_I and C_I,
//      with the ds terms B_J ds^T and x_J ds first; the column sums of
//      (dy x^T) o L o (C B^T) and B_j . dB_j's ds part for dcum;
//   4. ssd_bwd_cols, one block per (sub-tile I, h, b), over J <= I: the
//      per-head dC_I from dY_I x_J^T o L times B_J, after dY_I s_in; the
//      row sums and C_i . dC_i's s_in part for dcum;
//   5. ssd_bwd_da, per (chunk, h, b): dcum and its reverse cumsum over the
//      chunk's 256 rows;
//   6. sbwd::ssd_bwd_group.
// Every operand the kernels compute (the masked scores, ds, the decayed B
// and C of pass 1) is a bf16 hi and lo pair, as in the forward: one
// rounding carried 0.035 into y there.
//
// float32 (parity checks; namespace sbwd): the CUDA-core body, chunks of
// kBt = 32 rows (which keeps every tile of a chunk in shared memory up to
// P = N = 128), four kernels per call:
//   1. ssd_bwd_states, grid (chunks, H, B): each chunk's own outgoing state
//      x^T (B o e) and its own share of the incoming gradient
//      sum_i exp(cum_i) dy_i (x) C_i, and cum_last, into float32 scratch;
//   2. ssd_bwd_pass, a thread per (b, h, state element): the states
//      entering each chunk (forward over the chunks) and the gradient of
//      the state leaving each chunk (in reverse), in place;
//   3. ssd_bwd_chunk, grid (chunks, H, B): every gradient of the chunk's
//      rows; dB and dC per head;
//   4. ssd_bwd_group.
namespace sbwd {

constexpr int kBt = 32;        // rows per chunk
constexpr int kThreads = 256;  // 8 warps

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [s0, s0 + kBt) of a (B, S, heads, width) tensor at (b, head) into a
// kBt x ld float32 tile; rows past S read as zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int s0, int S, int heads, int head,
                                          int width) {
  for (int i = threadIdx.x; i < kBt * width; i += kThreads) {
    const int r = i / width, c = i % width, s = s0 + r;
    dst[r * ld + c] =
        s < S ? f32(src[(((size_t)b * S + s) * heads + head) * width + c])
              : 0.f;
  }
}

// warp 0: cum = inclusive cumsum of a over the chunk's rows (zeros past
// S), then exp(cum) and exp(cum_last - cum); returns cum_last in lane 31
template <typename T>
__device__ __forceinline__ void chunk_decays(const T* __restrict__ a, int b,
                                             int s0, int S, int H, int h,
                                             float* cum, float* ec,
                                             float* wd, float* clast) {
  const int lane = threadIdx.x;
  float c = s0 + lane < S ? f32(a[((size_t)b * S + s0 + lane) * H + h]) : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += up;
  }
  const float cl = __shfl_sync(0xffffffffu, c, 31);
  cum[lane] = c;
  ec[lane] = expf(c);
  wd[lane] = expf(cl - c);
  if (lane == 31) *clast = cl;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_states(const T* __restrict__ x, const T* __restrict__ a,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const T* __restrict__ dy, float* __restrict__ states,
                   float* __restrict__ dstates, float* __restrict__ clast,
                   int S, int H, int P, int G, int N) {
  extern __shared__ float smem[];
  float* Xs = smem;             // kBt x P
  float* dYs = Xs + kBt * P;    // kBt x P
  float* Bs = dYs + kBt * P;    // kBt x N
  float* Cs = Bs + kBt * N;     // kBt x N
  float* cum = Cs + kBt * N;    // kBt
  float* ec = cum + kBt;        // kBt  exp(cum_i)
  float* wd = ec + kBt;         // kBt  exp(cum_last - cum_j)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), s0 = c * kBt;
  load_rows(Xs, P, x, b, s0, S, H, h, P);
  load_rows(dYs, P, dy, b, s0, S, H, h, P);
  load_rows(Bs, N, bm, b, s0, S, G, g, N);
  load_rows(Cs, N, cm, b, s0, S, G, g, N);
  if (threadIdx.x < 32)
    chunk_decays(a, b, s0, S, H, h, cum, ec, wd,
                 clast + ((size_t)b * H + h) * nc + c);
  __syncthreads();
  const size_t off = (((size_t)b * nc + c) * H + h) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    float st = 0.f, gr = 0.f;
    for (int r = 0; r < kBt; ++r) {
      st = fmaf(wd[r] * Xs[r * P + p], Bs[r * N + n], st);
      gr = fmaf(ec[r] * dYs[r * P + p], Cs[r * N + n], gr);
    }
    states[off + e] = st;
    dstates[off + e] = gr;
  }
}

// In place: states[c] <- the state entering chunk c; dstates[c] <- the
// gradient of the state leaving chunk c (dfinal, or 0, for the last)
__global__ void ssd_bwd_pass(float* __restrict__ states,
                             float* __restrict__ dstates,
                             const float* __restrict__ clast,
                             const float* __restrict__ dfinal, int B, int H,
                             int PN, int nc) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * H * PN) return;
  const int e = t % PN, h = (t / PN) % H, b = t / ((size_t)PN * H);
  const float* cl = clast + ((size_t)b * H + h) * nc;
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t i = (((size_t)b * nc + c) * H + h) * PN + e;
    const float own = states[i];
    states[i] = run;
    run = fmaf(run, expf(cl[c]), own);
  }
  run = dfinal != nullptr ? dfinal[((size_t)b * H + h) * PN + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t i = (((size_t)b * nc + c) * H + h) * PN + e;
    const float own = dstates[i];
    dstates[i] = run;
    run = fmaf(run, expf(cl[c]), own);
  }
}

size_t chunk_smem(int P, int N) {
  const size_t lp = P + 1, ln = N + 1;
  return sizeof(float) * (2 * kBt * lp + 3 * kBt * ln + (size_t)P * ln +
                          3 * kBt * (kBt + 1) + 9 * kBt + 16);
}

// sum over a warp's lanes in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const T* __restrict__ dy, const float* __restrict__ states,
                  const float* __restrict__ dstates, T* __restrict__ dx,
                  T* __restrict__ da, float* __restrict__ dbh,
                  float* __restrict__ dch, int S, int H, int P, int G,
                  int N) {
  extern __shared__ float smem[];
  const int lp = P + 1, ln = N + 1, lt = kBt + 1;
  float* Xs = smem;                 // kBt x lp
  float* dYs = Xs + kBt * lp;       // kBt x lp
  float* Bs = dYs + kBt * lp;       // kBt x ln
  float* Cs = Bs + kBt * ln;        // kBt x ln
  float* Wk = Cs + kBt * ln;        // kBt x ln  the state parts of dC, dB
  float* Sb = Wk + kBt * ln;        // P x ln    entering state, then ds
  float* Gm = Sb + P * ln;          // kBt x lt  (C B^T) o L
  float* dGL = Gm + kBt * lt;       // kBt x lt  (dy x^T) o L
  float* Tt = dGL + kBt * lt;       // kBt x lt  dGL o (C B^T)
  float* cum = Tt + kBt * lt;
  float* ec = cum + kBt;
  float* wd = ec + kBt;
  float* tr = wd + kBt;             // row sums of Tt
  float* tc = tr + kBt;             // column sums of Tt
  float* u = tc + kBt;
  float* v = u + kBt;
  float* red = v + kBt;             // 8 warp partials of <ds, s>
  float* clast = red + 8;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), s0 = c * kBt;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t soff = (((size_t)b * nc + c) * H + h) * P * N;
  load_rows(Xs, lp, x, b, s0, S, H, h, P);
  load_rows(dYs, lp, dy, b, s0, S, H, h, P);
  load_rows(Bs, ln, bm, b, s0, S, G, g, N);
  load_rows(Cs, ln, cm, b, s0, S, G, g, N);
  for (int e = tid; e < P * N; e += kThreads)
    Sb[(e / N) * ln + e % N] = states[soff + e];
  if (tid < 32) chunk_decays(a, b, s0, S, H, h, cum, ec, wd, clast);
  __syncthreads();

  // phase 1 (Sb = the entering state s)
  {
    const int i = tid / 8;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tid % 8 + 8 * q;
      float cb = 0.f, dg = 0.f;
      for (int n = 0; n < N; ++n)
        cb = fmaf(Cs[i * ln + n], Bs[j * ln + n], cb);
      for (int p = 0; p < P; ++p)
        dg = fmaf(dYs[i * lp + p], Xs[j * lp + p], dg);
      const float L = i >= j ? expf(cum[i] - cum[j]) : 0.f;
      Gm[i * lt + j] = cb * L;
      dGL[i * lt + j] = dg * L;
      Tt[i * lt + j] = dg * L * cb;
    }
  }
  for (int e = tid; e < kBt * N; e += kThreads) {
    const int i = e / N, n = e % N;
    float acc = 0.f;
    for (int p = 0; p < P; ++p)
      acc = fmaf(Sb[p * ln + n], dYs[i * lp + p], acc);
    Wk[i * ln + n] = ec[i] * acc;
  }
  float wpart = 0.f;
  for (int e = tid; e < P * N; e += kThreads)
    wpart = fmaf(Sb[(e / N) * ln + e % N], dstates[soff + e], wpart);
  wpart = warp_sum(wpart);
  if (lane == 0) red[warp] = wpart;
  __syncthreads();

  if (tid < kBt) {
    float sr = 0.f;
    for (int j = 0; j < kBt; ++j) sr += Tt[tid * lt + j];
    tr[tid] = sr;
  } else if (tid < 2 * kBt) {
    const int j = tid - kBt;
    float sc = 0.f;
    for (int i = 0; i < kBt; ++i) sc += Tt[i * lt + j];
    tc[j] = sc;
  }
  for (int i = warp; i < kBt; i += 8) {
    float acc = 0.f;
    for (int n = lane; n < N; n += 32)
      acc = fmaf(Cs[i * ln + n], Wk[i * ln + n], acc);
    acc = warp_sum(acc);
    if (lane == 0) u[i] = acc;
  }
  for (int e = tid; e < kBt * N; e += kThreads) {
    const int i = e / N, n = e % N, s = s0 + i;
    float acc = Wk[i * ln + n];
    for (int j = 0; j <= i; ++j)
      acc = fmaf(dGL[i * lt + j], Bs[j * ln + n], acc);
    if (s < S) dch[(((size_t)b * S + s) * H + h) * N + n] = acc;
  }
  __syncthreads();

  // phase 2 (Sb = ds, the gradient of the state leaving the chunk)
  for (int e = tid; e < P * N; e += kThreads)
    Sb[(e / N) * ln + e % N] = dstates[soff + e];
  __syncthreads();
  for (int e = tid; e < kBt * N; e += kThreads) {
    const int j = e / N, n = e % N;
    float acc = 0.f;
    for (int p = 0; p < P; ++p)
      acc = fmaf(Sb[p * ln + n], Xs[j * lp + p], acc);
    Wk[j * ln + n] = wd[j] * acc;
  }
  for (int e = tid; e < kBt * P; e += kThreads) {
    const int j = e / P, p = e % P, s = s0 + j;
    float acc = 0.f, st = 0.f;
    for (int i = j; i < kBt; ++i)
      acc = fmaf(Gm[i * lt + j], dYs[i * lp + p], acc);
    for (int n = 0; n < N; ++n) st = fmaf(Sb[p * ln + n], Bs[j * ln + n], st);
    if (s < S) put(dx + (((size_t)b * S + s) * H + h) * P + p,
                   fmaf(wd[j], st, acc));
  }
  __syncthreads();
  for (int j = warp; j < kBt; j += 8) {
    float acc = 0.f;
    for (int n = lane; n < N; n += 32)
      acc = fmaf(Bs[j * ln + n], Wk[j * ln + n], acc);
    acc = warp_sum(acc);
    if (lane == 0) v[j] = acc;
  }
  for (int e = tid; e < kBt * N; e += kThreads) {
    const int j = e / N, n = e % N, s = s0 + j;
    float acc = Wk[j * ln + n];
    for (int i = j; i < kBt; ++i)
      acc = fmaf(dGL[i * lt + j], Cs[i * ln + n], acc);
    if (s < S) dbh[(((size_t)b * S + s) * H + h) * N + n] = acc;
  }
  __syncthreads();

  // dcum, then da = its reverse cumsum (warp 0, a row per lane)
  if (tid < 32) {
    float w = 0.f;
    for (int k = 0; k < 8; ++k) w += red[k];
    const float vsum = warp_sum(v[lane]);
    float d = tr[lane] - tc[lane] + u[lane] - v[lane];
    if (lane == kBt - 1) d += expf(*clast) * w + vsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float dn = __shfl_down_sync(0xffffffffu, d, o);
      if (lane + o < 32) d += dn;
    }
    if (s0 + lane < S) put(da + ((size_t)b * S + s0 + lane) * H + h, d);
  }
}

// dB, dC (B, S, G, N) = the per-head partials summed over each group's
// heads in order
template <typename T>
__global__ void ssd_bwd_group(const float* __restrict__ dbh,
                              const float* __restrict__ dch,
                              T* __restrict__ db, T* __restrict__ dc,
                              size_t total, int H, int G, int N) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int n = t % N, g = (t / N) % G;
  const size_t bs = t / ((size_t)N * G);
  const int rep = H / G;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    const size_t i = (bs * H + (size_t)g * rep + r) * N + n;
    sb += dbh[i];
    sc += dch[i];
  }
  put(db + t, sb);
  put(dc + t, sc);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const void* dfinal, void* dx, void* da, void* db,
           void* dc, float* states, float* dstates, float* clast,
           float* dbh, float* dch, int B, int S, int H, int P, int G, int N,
           cudaStream_t stream) {
  const T *tx = static_cast<const T*>(x), *ta = static_cast<const T*>(a),
          *tb = static_cast<const T*>(b), *tc = static_cast<const T*>(c),
          *tdy = static_cast<const T*>(dy);
  const int nc = (S + kBt - 1) / kBt;
  const dim3 grid(nc, H, B);
  size_t smem = sizeof(float) * (2 * kBt * (size_t)(P + N) + 3 * kBt);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_states<T><<<grid, kThreads, smem, stream>>>(
      tx, ta, tb, tc, tdy, states, dstates, clast, S, H, P, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t lanes = (size_t)B * H * P * N;
  ssd_bwd_pass<<<(lanes + 255) / 256, 256, 0, stream>>>(
      states, dstates, clast, static_cast<const float*>(dfinal), B, H, P * N,
      nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  smem = chunk_smem(P, N);
  err = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<T><<<grid, kThreads, smem, stream>>>(
      tx, ta, tb, tc, tdy, states, dstates, static_cast<T*>(dx),
      static_cast<T*>(da), dbh, dch, S, H, P, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * S * G * N;
  ssd_bwd_group<T><<<(total + 255) / 256, 256, 0, stream>>>(
      dbh, dch, static_cast<T*>(db), static_cast<T*>(dc), total, H, G, N);
  return (int)cudaGetLastError();
}

}  // namespace sbwd

// ----------------------------------------------------------- bf16 backward
namespace sbwd3 {

using namespace hopper;
using ssd3::align1024;
using ssd3::kConsumers;
using ssd3::kR;
using ssd3::kRegion;
using ssd3::kStages;
using ssd3::kSubs;
using ssd3::kT;
using ssd3::kThreads;

constexpr float kLog2e = 1.4426950408889634f;

// The sum of v over the block's threads, in every thread, in a fixed order
// (`red` holds a float per warp).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = sbwd::warp_sum(v);
  const int n = blockDim.x / 32;
  __syncthreads();  // the last call's reads of red are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < n; ++k) t += red[k];
  return t;
}

// Pass 2, per (b, h) and state element, in reverse over the chunks: the
// gradient of the state leaving chunk c, ds[nc-1] = dfinal (or 0) and
// ds[c-1] = ds[c] exp(cum_last[c]) + own[c] (own: pass 1's shares), as a
// bf16 hi and lo pair (B, nc, H, 2, P, N); and per block and chunk the
// partial sum of ds[c] o s_in[c] (B, H, nc, blocks).
__global__ void __launch_bounds__(256)
    ssd_bwd_dpass(const float* __restrict__ own,
                  const __nv_bfloat16* __restrict__ s_in,
                  const float* __restrict__ cum,
                  const float* __restrict__ dfinal,
                  __nv_bfloat16* __restrict__ ds, float* __restrict__ wpart,
                  int H, int PN, int nc) {
  __shared__ float red[8];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool in = e < PN;
  const size_t bh = (size_t)b * H + h;
  float run = in && dfinal != nullptr ? dfinal[bh * PN + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t st = ((size_t)b * nc + c) * H + h;
    float sv = 0.f;
    if (in) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(run);
      __nv_bfloat16* dst = ds + st * 2 * PN + e;
      dst[0] = hi;
      dst[PN] = __float2bfloat16_rn(run - __bfloat162float(hi));
      const __nv_bfloat16* src = s_in + st * 2 * PN + e;
      sv = __bfloat162float(src[0]) + __bfloat162float(src[PN]);
    }
    const float w = block_sum(run * sv, red);
    if (threadIdx.x == 0) wpart[(bh * nc + c) * gridDim.x + blockIdx.x] = w;
    if (in)
      run = run * expf(cum[(bh * nc + c) * kT + kT - 1]) + own[st * PN + e];
  }
}

// acc (64 x 64) = A B^T over W columns, both K-major tiles of 64 rows.
template <int W>
__device__ __forceinline__ void issue_nt(float (&acc)[kR / 2], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
    wgmma_ss<kR, 0, 0>(acc, desc_sw128(a + off, 16, 1024),
                       desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc (64 x W) += M B: M (64 x 64) in registers as bf16 hi / lo pairs, B the
// MN-major tile of 64 rows at b.
template <int W>
__device__ __forceinline__ void issue_pair(float (&acc)[W / 2],
                                           const uint32_t (&hi)[kR / 16][4],
                                           const uint32_t (&lo)[kR / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kR / 16; ++kk) {
    const uint64_t db = desc_sw128(b + kk * 16 * kRowBytes, kRegion, 1024);
    wgmma_rs<W, 1>(acc, hi[kk], db, 1);
    wgmma_rs<W, 1>(acc, lo[kk], db, 1);
  }
}

// acc (64 x W) = A T, A the K-major 64-row tile at a (over the state's W
// rows), T the hi + lo pair of a (W x W) state tile at t, MN-major.
template <int W>
__device__ __forceinline__ void issue_state_nn(float (&acc)[W / 2],
                                               uint32_t a, uint32_t t) {
  constexpr int kS = W * kRowBytes;  // a region of the state tile
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      wgmma_ss<W, 0, 1>(
          acc, desc_sw128(a + (kk / 4) * kRegion + (kk % 4) * 32, 16, 1024),
          desc_sw128(t + q * (W / kRegionCols) * kS + kk * 16 * kRowBytes,
                     kS, 1024),
          q > 0 || kk > 0);
}

// Row sums of a 64 x W accumulator times the same rows of a 64-row tile
// in shared memory (the thread's rows lr0 and lr0 + 8), over its quad.
template <int W>
__device__ __forceinline__ void row_dots(const float (&acc)[W / 2],
                                         const uint8_t* tile, int lr0,
                                         int t4, float& d0, float& d1) {
  d0 = d1 = 0.f;
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = swz_bf16(tile, kRegion, lr0 + 8 * (e >> 1),
                               8 * j + 2 * t4 + (e & 1)) *
                      acc[4 * j + e];
      if (e < 2) d0 += x;
      else d1 += x;
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, o);
    d1 += __shfl_xor_sync(0xffffffffu, d1, o);
  }
}

__device__ __forceinline__ void quad_sum(float& a, float& b) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// A 64 x W accumulator as float32 rows of a (B, S, H, N) tensor: the
// thread's rows row0 and row0 + 8, columns < N, rows < S.
template <int W>
__device__ __forceinline__ void store_f32(const float (&acc)[W / 2],
                                          float* __restrict__ dst, int b,
                                          int row0, int S, int H, int h,
                                          int N, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    float* row = dst + (((size_t)b * S + s) * H + h) * N;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < N)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// bars[0]: the resident tiles; then kStages full and kStages empty
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  mbar_init(&bars[0], 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&bars[1 + s], 1);
    mbar_init(&bars[1 + kStages + s], kConsumers);
  }
  fence_barrier_init();
}

size_t tiles_smem(int W) {
  const int R = W / kRegionCols;
  // two resident 64-row tiles, a state pair, the ring, cum, barriers
  return 1024 + (size_t)(2 * R + kStages * 2 * R) * kRegion +
         (size_t)2 * R * W * kRowBytes + kT * sizeof(float) + 64;
}

// The chunk's cumsum of a in the log2 domain, from the forward's cum.
__device__ __forceinline__ void load_cum(float* cum_s, const float* cum,
                                         int b, int H, int h, int nc, int c,
                                         int tid) {
  const float* src = cum + (((size_t)b * H + h) * nc + c) * kT;
  for (int r = tid; r < kT; r += kConsumers) cum_s[r] = src[r] * kLog2e;
  named_sync(1, kConsumers);
}

// Pass 3, one block per (64-row sub-tile J, h, b), over the sub-tiles I >= J
// of J's chunk: dx_J (bf16) and the per-head dB_J (float32, dbh), and per
// row j the part of dcum it owns, -(sum_i t_ij) - v_j (dcum_r), and v_j
// (vrow), where t = ((dY x^T) o L) o (C B^T) and v_j = B_j . e_j ds^T x_j.
// W: max(P, N) rounded up to 64 (narrower operands are zero-filled).
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_rows(const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tds,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap tdy,
                 const float* __restrict__ cum,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ dbh,
                 float* __restrict__ dcum_r, float* __restrict__ vrow, int S,
                 int H, int P, int G, int N, int nc) {
  constexpr int R = W / kRegionCols;
  constexpr int kS = W * kRowBytes;          // a region of the state tile
  constexpr int kStage = 2 * R * kRegion;    // C_I, dY_I
  extern __shared__ uint8_t smem_raw[];
  uint8_t* b_s = align1024(smem_raw);        // B_J
  uint8_t* x_s = b_s + R * kRegion;          // x_J
  uint8_t* d_s = x_s + R * kRegion;          // ds hi, lo
  uint8_t* ring = d_s + 2 * R * kS;
  float* cum_s = reinterpret_cast<float*>(ring + kStages * kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cum_s + kT);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c = it / kSubs, j0 = c * kSubs;
  const int n_i = min(j0 + kSubs, (int)gridDim.x) - it;  // I = it ..
  const int tid = threadIdx.x;

  if (tid == 0) init_bars(bars);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(bars, 2 * R * kRegion + 2 * R * kS);
      for (int r = 0; r < R; ++r) {
        tma_load_4d(b_s + r * kRegion, &tb, bars, r * kRegionCols, g, it * kR,
                    b);
        tma_load_4d(x_s + r * kRegion, &tx, bars, r * kRegionCols, h, it * kR,
                    b);
        for (int q = 0; q < 2; ++q)
          tma_load_3d(d_s + (q * R + r) * kS, &tds, bars, r * kRegionCols, 0,
                      ((b * nc + c) * H + h) * 2 + q);
      }
      for (int u = 0; u < n_i; ++u) {
        const int s = u % kStages;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        uint8_t* st = ring + s * kStage;
        for (int r = 0; r < R; ++r) {
          tma_load_4d(st + r * kRegion, &tc, &full[s], r * kRegionCols, g,
                      (it + u) * kR, b);
          tma_load_4d(st + (R + r) * kRegion, &tdy, &full[s],
                      r * kRegionCols, h, (it + u) * kR, b);
        }
      }
    }
    return;
  }

  load_cum(cum_s, cum, b, H, h, nc, c, tid);
  const int w = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int lr0 = w * 16 + lane / 4;       // tile rows lr0, lr0 + 8
  const int jr0 = (it - j0) * kR + lr0;    // the same in the chunk
  const float clast = cum_s[kT - 1];
  const float e0 = exp2_ftz(clast - cum_s[jr0]);
  const float e1 = exp2_ftz(clast - cum_s[jr0 + 8]);
  const uint32_t ba = smem_u32(b_s), xa = smem_u32(x_s);

  // the ds terms: dx_J = e_J o (B_J ds^T), dB_J = e_J o (x_J ds)
  float adx[W / 2], adb[W / 2];
  mbar_wait(bars, 0);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<W, 0, 0>(
          adx, desc_sw128(ba + (kk / 4) * kRegion + col, 16, 1024),
          desc_sw128(smem_u32(d_s) + (q * R + kk / 4) * kS + col, 16, 1024),
          q > 0 || kk > 0);
    }
  issue_state_nn<W>(adb, xa, smem_u32(d_s));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adx);
  fence_regs(adb);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float e = (i & 2) ? e1 : e0;
    adx[i] *= e;
    adb[i] *= e;
  }
  float v0, v1;
  row_dots<W>(adb, b_s, lr0, t4, v0, v1);

  float tc0 = 0.f, tc1 = 0.f;
  for (int u = 0; u < n_i; ++u) {
    const int s = u % kStages;
    mbar_wait(&full[s], (u / kStages) & 1);
    const uint32_t ct = smem_u32(ring + s * kStage), yt = ct + R * kRegion;
    float cb[kR / 2], dg[kR / 2];  // (C_I B_J^T)^T, (dY_I x_J^T)^T
    wgmma_fence();
    issue_nt<W>(cb, ba, ct);
    issue_nt<W>(dg, xa, yt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
    fence_regs(dg);
    const int ib = (it - j0 + u) * kR;  // I's first row in the chunk
#pragma unroll
    for (int jj = 0; jj < kR / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ir = ib + 8 * jj + 2 * t4 + (e & 1);
        const int jr = jr0 + 8 * (e >> 1);
        const float L =
            ir >= jr ? exp2_ftz(cum_s[ir] - cum_s[jr]) : 0.f;
        const float gl = cb[4 * jj + e] * L;
        const float t = gl * dg[4 * jj + e];
        if (e < 2) tc0 += t;
        else tc1 += t;
        cb[4 * jj + e] = gl;
        dg[4 * jj + e] *= L;
      }
    uint32_t gh[kR / 16][4], gl[kR / 16][4], hh[kR / 16][4], hl[kR / 16][4];
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      a_frag_split(cb, kk, gh[kk], gl[kk]);
      a_frag_split(dg, kk, hh[kk], hl[kk]);
    }
    fence_regs(adx);
    fence_regs(adb);
    wgmma_fence();
    issue_pair<W>(adx, gh, gl, yt);  // += ((C B^T) o L)^T dY_I
    issue_pair<W>(adb, hh, hl, ct);  // += ((dY x^T) o L)^T C_I
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adx);
    fence_regs(adb);
    mbar_arrive(&empty[s]);
  }
  quad_sum(tc0, tc1);

  const int row0 = it * kR + lr0;
  if (t4 == 0) {
    const size_t base = ((size_t)b * H + h) * nc * kT;
    const float tc[2] = {tc0, tc1}, v[2] = {v0, v1};
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S) {
        dcum_r[base + row0 + 8 * r] = -tc[r] - v[r];
        vrow[base + row0 + 8 * r] = v[r];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= S) continue;
    __nv_bfloat16* row = dx + (((size_t)b * S + s) * H + h) * P;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < P)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16(adx[4 * j + 2 * r], adx[4 * j + 2 * r + 1]);
    }
  }
  store_f32<W>(adb, dbh, b, row0, S, H, h, N, t4);
}

// Pass 4, one block per (64-row sub-tile I, h, b), over the sub-tiles
// J <= I of I's chunk: the per-head dC_I (float32, dch) and per row i the
// part of dcum it owns, sum_j t_ij + u_i (dcum_c), u_i = C_i . exp(cum_i)
// s_in^T dy_i.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_cols(const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tx,
                 const float* __restrict__ cum, float* __restrict__ dch,
                 float* __restrict__ dcum_c, int S, int H, int P, int G,
                 int N, int nc) {
  constexpr int R = W / kRegionCols;
  constexpr int kS = W * kRowBytes;
  constexpr int kStage = 2 * R * kRegion;    // B_J, x_J
  extern __shared__ uint8_t smem_raw[];
  uint8_t* c_s = align1024(smem_raw);        // C_I
  uint8_t* y_s = c_s + R * kRegion;          // dY_I
  uint8_t* s_s = y_s + R * kRegion;          // s_in hi, lo
  uint8_t* ring = s_s + 2 * R * kS;
  float* cum_s = reinterpret_cast<float*>(ring + kStages * kStage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cum_s + kT);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int it = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int c = it / kSubs, j0 = c * kSubs;
  const int n_j = it - j0 + 1;  // J = j0 .. it
  const int tid = threadIdx.x;

  if (tid == 0) init_bars(bars);
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(bars, 2 * R * kRegion + 2 * R * kS);
      for (int r = 0; r < R; ++r) {
        tma_load_4d(c_s + r * kRegion, &tc, bars, r * kRegionCols, g, it * kR,
                    b);
        tma_load_4d(y_s + r * kRegion, &tdy, bars, r * kRegionCols, h,
                    it * kR, b);
        for (int q = 0; q < 2; ++q)
          tma_load_3d(s_s + (q * R + r) * kS, &ts, bars, r * kRegionCols, 0,
                      ((b * nc + c) * H + h) * 2 + q);
      }
      for (int u = 0; u < n_j; ++u) {
        const int s = u % kStages;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        uint8_t* st = ring + s * kStage;
        for (int r = 0; r < R; ++r) {
          tma_load_4d(st + r * kRegion, &tb, &full[s], r * kRegionCols, g,
                      (j0 + u) * kR, b);
          tma_load_4d(st + (R + r) * kRegion, &tx, &full[s],
                      r * kRegionCols, h, (j0 + u) * kR, b);
        }
      }
    }
    return;
  }

  load_cum(cum_s, cum, b, H, h, nc, c, tid);
  const int w = tid / 32, lane = tid % 32, t4 = lane % 4;
  const int lr0 = w * 16 + lane / 4;
  const int ir0 = (it - j0) * kR + lr0;
  const float ec0 = exp2_ftz(cum_s[ir0]), ec1 = exp2_ftz(cum_s[ir0 + 8]);
  const uint32_t ca = smem_u32(c_s), ya = smem_u32(y_s);

  // the s_in term: dC_I = exp(cum_I) o (dY_I s_in)
  float adc[W / 2];
  mbar_wait(bars, 0);
  wgmma_fence();
  issue_state_nn<W>(adc, ya, smem_u32(s_s));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adc);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) adc[i] *= (i & 2) ? ec1 : ec0;
  float u0, u1;
  row_dots<W>(adc, c_s, lr0, t4, u0, u1);

  float tr0 = 0.f, tr1 = 0.f;
  for (int u = 0; u < n_j; ++u) {
    const int s = u % kStages;
    mbar_wait(&full[s], (u / kStages) & 1);
    const uint32_t bt = smem_u32(ring + s * kStage), xt = bt + R * kRegion;
    float cb[kR / 2], dg[kR / 2];  // C_I B_J^T, dY_I x_J^T
    wgmma_fence();
    issue_nt<W>(cb, ca, bt);
    issue_nt<W>(dg, ya, xt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cb);
    fence_regs(dg);
    const int jb = u * kR;  // J's first row in the chunk
#pragma unroll
    for (int jj = 0; jj < kR / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jr = jb + 8 * jj + 2 * t4 + (e & 1);
        const int ir = ir0 + 8 * (e >> 1);
        const float L =
            ir >= jr ? exp2_ftz(cum_s[ir] - cum_s[jr]) : 0.f;
        const float dl = dg[4 * jj + e] * L;
        const float t = dl * cb[4 * jj + e];
        if (e < 2) tr0 += t;
        else tr1 += t;
        dg[4 * jj + e] = dl;
      }
    uint32_t hh[kR / 16][4], hl[kR / 16][4];
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) a_frag_split(dg, kk, hh[kk], hl[kk]);
    fence_regs(adc);
    wgmma_fence();
    issue_pair<W>(adc, hh, hl, bt);  // += ((dY x^T) o L) B_J
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adc);
    mbar_arrive(&empty[s]);
  }
  quad_sum(tr0, tr1);

  const int row0 = it * kR + lr0;
  if (t4 == 0) {
    const size_t base = ((size_t)b * H + h) * nc * kT;
    if (row0 < S) dcum_c[base + row0] = tr0 + u0;
    if (row0 + 8 < S) dcum_c[base + row0 + 8] = tr1 + u1;
  }
  store_f32<W>(adc, dch, b, row0, S, H, h, N, t4);
}

// Pass 5, one block of kT threads per (chunk, h, b): dcum of the chunk's
// rows (the two passes' parts; the last row also takes exp(cum_last)
// <ds, s_in> and the chunk's sum of v), then da = its reverse cumsum.
__global__ void __launch_bounds__(kT)
    ssd_bwd_da(const float* __restrict__ dcum_r,
               const float* __restrict__ vrow,
               const float* __restrict__ dcum_c,
               const float* __restrict__ wpart, const float* __restrict__ cum,
               __nv_bfloat16* __restrict__ da, int S, int H, int nc,
               int nblk) {
  __shared__ float red[kT / 32];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int r = c * kT + tid;
  const size_t bh = (size_t)b * H + h, base = bh * nc * kT;
  const bool in = r < S;
  float d = in ? dcum_r[base + r] + dcum_c[base + r] : 0.f;
  const float vsum = block_sum(in ? vrow[base + r] : 0.f, red);
  if (tid == kT - 1) {
    float w = 0.f;
    for (int k = 0; k < nblk; ++k) w += wpart[(bh * nc + c) * nblk + k];
    d += expf(cum[(bh * nc + c) * kT + kT - 1]) * w + vsum;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float dn = __shfl_down_sync(0xffffffffu, d, o);
    if (lane + o < 32) d += dn;
  }
  __syncthreads();  // block_sum's reads of red are done
  if (lane == 0) red[wid] = d;
  __syncthreads();
  for (int k = wid + 1; k < kT / 32; ++k) d += red[k];
  if (in) da[((size_t)b * S + r) * H + h] = __float2bfloat16(d);
}

template <int W>
int launch_tiles(const CUtensorMap& tx, const CUtensorMap& tdy,
                 const CUtensorMap& tb, const CUtensorMap& tc,
                 const CUtensorMap& ts, const CUtensorMap& tds,
                 const float* cum, void* dx, float* dbh, float* dch,
                 float* dcum_r, float* vrow, float* dcum_c, int B, int S,
                 int H, int P, int G, int N, int nc, cudaStream_t stream) {
  const size_t smem = tiles_smem(W);
  const dim3 grid((S + kR - 1) / kR, H, B);
  int err = set_smem(ssd_bwd_rows<W>, smem);
  if (err) return err;
  ssd_bwd_rows<W><<<grid, kThreads, smem, stream>>>(
      tb, tx, tds, tc, tdy, cum, static_cast<__nv_bfloat16*>(dx), dbh,
      dcum_r, vrow, S, H, P, G, N, nc);
  if ((err = (int)cudaGetLastError())) return err;
  err = set_smem(ssd_bwd_cols<W>, smem);
  if (err) return err;
  ssd_bwd_cols<W><<<grid, kThreads, smem, stream>>>(
      tc, tdy, ts, tb, tx, cum, dch, dcum_c, S, H, P, G, N, nc);
  return (int)cudaGetLastError();
}

// One ssd_bwd() call on `stream`.  s_in (B, nc, H, 2, P, N) bf16 and cum
// (B, H, nc, kT) float32 are the forward's, or are computed here first
// (have_states 0, with final (B, H, P, N) float32 as scratch).  Scratch
// from the wrapper: own (B, nc, H, P, N) float32, ds like s_in, wpart
// (B, H, nc, ceil(P N / 256)), rows (3, B, H, nc kT) and dbh, dch
// (B, S, H, N), all float32.
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const void* dfinal, void* dx, void* da, void* db,
           void* dc, void* s_in, float* cum, int have_states, float* own,
           void* final_scratch, void* ds, float* wpart, float* rows,
           float* dbh, float* dch, int B, int S, int H, int P, int G, int N,
           cudaStream_t stream) {
  const int nc = (S + kT - 1) / kT;
  const int W = round_up(P > N ? P : N, kRegionCols);
  CUtensorMap tx, tdy, tb, tc, ts, tds;
  int err = ssd3::encode_rows(&tx, x, B, S, H, P);
  if (!err) err = ssd3::encode_rows(&tdy, dy, B, S, H, P);
  if (!err) err = ssd3::encode_rows(&tb, b, B, S, G, N);
  if (!err) err = ssd3::encode_rows(&tc, c, B, S, G, N);
  if (err) return err;
  if (!have_states) {
    err = ssd3::states_pass(tx, tb, a, own, s_in, cum, final_scratch, B, S,
                            H, P, G, N, stream);
    if (err) return err;
  }
  err = ssd3::encode_states(&ts, s_in, P, N, B * nc * H * 2, W);
  if (!err) err = ssd3::encode_states(&tds, ds, P, N, B * nc * H * 2, W);
  if (err) return err;
  err = ssd3::launch_states(tdy, tc, a, own, nullptr, B, S, H, P, G, N, nc,
                            1, stream);
  if (err) return err;
  const int PN = P * N, nblk = (PN + 255) / 256;
  ssd_bwd_dpass<<<dim3(nblk, H, B), 256, 0, stream>>>(
      own, static_cast<const __nv_bfloat16*>(s_in), cum,
      static_cast<const float*>(dfinal), static_cast<__nv_bfloat16*>(ds),
      wpart, H, PN, nc);
  if ((err = (int)cudaGetLastError())) return err;
  const size_t plane = (size_t)B * H * nc * kT;
  float *dcum_r = rows, *vrow = rows + plane, *dcum_c = rows + 2 * plane;
  if (W == 64)
    err = launch_tiles<64>(tx, tdy, tb, tc, ts, tds, cum, dx, dbh, dch,
                           dcum_r, vrow, dcum_c, B, S, H, P, G, N, nc, stream);
  else if (W == 128)
    err = launch_tiles<128>(tx, tdy, tb, tc, ts, tds, cum, dx, dbh, dch,
                            dcum_r, vrow, dcum_c, B, S, H, P, G, N, nc,
                            stream);
  else
    err = (int)cudaErrorInvalidValue;
  if (err) return err;
  ssd_bwd_da<<<dim3(nc, H, B), kT, 0, stream>>>(
      dcum_r, vrow, dcum_c, wpart, cum, static_cast<__nv_bfloat16*>(da), S,
      H, nc, nblk);
  if ((err = (int)cudaGetLastError())) return err;
  const size_t total = (size_t)B * S * G * N;
  sbwd::ssd_bwd_group<__nv_bfloat16><<<(total + 255) / 256, 256, 0, stream>>>(
      dbh, dch, static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), total, H, G, N);
  return (int)cudaGetLastError();
}

}  // namespace sbwd3

extern "C" {

// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused.  The wrapper (ops.py) checks shapes, dtypes, G | H and
// P, N <= 128.
int ksp_ssd_f32(const void* x, const void* a, const void* b, const void* c,
                void* y, void* final_state, int B, int S, int H, int P, int G,
                int N, cudaStream_t stream) {
  hopper::enter();
  return launch<float>(x, a, b, c, y, final_state, B, S, H, P, G, N, stream);
}

// The bf16 instance: three kernels on `stream`, with scratch allocated by
// the wrapper (see ssd3::launch); the wrapper checks P % 8 == 0,
// N % 8 == 0 and 16-byte aligned pointers (TMA's rules).
int ksp_ssd_bf16(const void* x, const void* a, const void* b, const void* c,
                 void* y, void* final_state, void* states, void* s_in,
                 void* cum, int B, int S, int H, int P, int G, int N,
                 cudaStream_t stream) {
  hopper::enter();
  return ssd3::launch(x, a, b, c, y, final_state, states, s_in, cum, B, S, H,
                      P, G, N, stream);
}

// The backward: dx, da, db, dc in the inputs' dtype from x, a, b, c, dy
// and dfinal (B, H, P, N) float32 or null (zero).  Scratch from the
// wrapper, all float32: states and dstates (B, ceil(S / 32), H, P, N),
// clast (B, H, ceil(S / 32)), dbh and dch (B, S, H, N).  The wrapper checks
// shapes, dtypes, G | H and P, N <= 128.  The bf16 instance takes the
// forward's s_in and cum (have_states 1) or computes them into the given
// buffers, and the scratch listed at sbwd3::launch; TMA's checks as the
// forward's.
int ksp_ssd_bwd_f32(const void* x, const void* a, const void* b,
                    const void* c, const void* dy, const void* dfinal,
                    void* dx, void* da, void* db, void* dc, void* states,
                    void* dstates, void* clast, void* dbh, void* dch, int B,
                    int S, int H, int P, int G, int N, cudaStream_t stream) {
  hopper::enter();
  return sbwd::launch<float>(
      x, a, b, c, dy, dfinal, dx, da, db, dc, static_cast<float*>(states),
      static_cast<float*>(dstates), static_cast<float*>(clast),
      static_cast<float*>(dbh), static_cast<float*>(dch), B, S, H, P, G, N,
      stream);
}

int ksp_ssd_bwd_bf16(const void* x, const void* a, const void* b,
                     const void* c, const void* dy, const void* dfinal,
                     void* dx, void* da, void* db, void* dc, void* s_in,
                     void* cum, int have_states, void* own,
                     void* final_scratch, void* ds, void* wpart, void* rows,
                     void* dbh, void* dch, int B, int S, int H, int P, int G,
                     int N, cudaStream_t stream) {
  hopper::enter();
  return sbwd3::launch(x, a, b, c, dy, dfinal, dx, da, db, dc, s_in,
                       static_cast<float*>(cum), have_states,
                       static_cast<float*>(own), final_scratch, ds,
                       static_cast<float*>(wpart), static_cast<float*>(rows),
                       static_cast<float*>(dbh), static_cast<float*>(dch), B,
                       S, H, P, G, N, stream);
}

}  // extern "C"
