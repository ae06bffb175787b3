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
// Outputs y in x's dtype and the final state in float32 (B,H,P,N).
//
// Bound: memory at the model's shapes.  Per row and head the scan reads x
// and writes y (P elements each; B, C and a are shared or small) and does
// at most 2*(kSub*(N + P) + 2*P*N) flops: ~128 flops per bf16 byte at
// P = N = 64, under the card's ridge of ~295 (989 TFLOP/s over 3.35 TB/s).
//
// Design (simple and right first; tensor cores, TMA and pipelining are
// later work): one block of 256 threads per (b, h), sequential over
// sub-chunks of kSub = 64 rows whatever the model's chunk (the scan's result
// does not depend on the chunk size; 64 rows keep the working set on chip:
// at the model's chunk of 256 the 256 x 256 float32 score tile alone is
// 256 KB, more than a block's 227 KB).  The state (P x N float32) lives in
// shared memory for the whole sequence.  Per sub-chunk the x, B and C rows
// are staged in shared memory as float32 (ragged tails read as zeros, which
// is the zero padding of the TPU wrapper), warp 0 takes the cumulative sum
// of a with shuffles, and the three products run on the CUDA cores in
// float32 with register tiles.  exp(cum_i - cum_j) is evaluated on the
// lower triangle only: above it the exponent is positive and can overflow,
// and inf * 0 would be NaN.  Shared-memory rows of B, C and the state have an
// odd float stride (N + 1) so the threads of a warp read distinct banks.
// Parallelism is B*H blocks: 320 at the serving batch of 4 on zamba2
// (80 heads), ~2.4 waves of 132 SMs; only 80 at batch 1.
//
// Built without --use_fast_math: the float32 path is held to 5e-3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kSub = 64;       // rows per sub-chunk
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxP = 128;
constexpr int kMaxN = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

extern "C" {

// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused.  The wrapper (ops.py) checks shapes, dtypes, G | H and
// P, N <= 128.
int ksp_ssd_f32(const void* x, const void* a, const void* b, const void* c,
                void* y, void* final_state, int B, int S, int H, int P, int G,
                int N, cudaStream_t stream) {
  return launch<float>(x, a, b, c, y, final_state, B, S, H, P, G, N, stream);
}

int ksp_ssd_bf16(const void* x, const void* a, const void* b, const void* c,
                 void* y, void* final_state, int B, int S, int H, int P,
                 int G, int N, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, a, b, c, y, final_state, B, S, H, P, G, N,
                               stream);
}

}  // extern "C"
