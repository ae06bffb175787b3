// Batched OOM probe and success wastage for the KS+ fleet engine, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels in repro/kernels/wastage/kernel.py:
//   PROBE = true  -> oom_probe_kernel (one OOM/retry attempt per lane)
//   PROBE = false -> wastage_kernel   (success wastage only)
//
// Per lane b, with alloc(t) the step function of (starts[b], peaks[b]) on the
// float32 grid t = float(i) * dt:
//   viol   = first i < len[b] with mem[b,i] > alloc(t_i), or -1
//   w_succ = dt * sum_{i < len[b]} (max(alloc, mem) - mem)
//   w_kill = dt * sum_{i <= viol} alloc, 0 when viol < 0
//
// Bound: memory.  Each attempt reads every valid sample of the float32 trace
// once (sum of lengths * 4 bytes; at most B*T*4) at 3.35 TB/s on an H100
// SXM; the select over K <= 32 slots is a handful of compares per sample.
//
// Design (simple and right first): one block per lane; the lane's K starts
// and peaks are staged in shared memory; threads stride over T with
// coalesced float32 loads, evaluating alloc with the same one-hot interval
// select as the plain version (kernels/wastage/ref.py) and in the same slot
// order, so viol agrees bitwise.  Each thread keeps a local first-bad index
// and a partial w_succ; a block reduction (warp shuffles, then shared
// memory) combines them.  w_kill is a second sweep over i <= viol that
// evaluates alloc only: alloc depends on t, not on the trace, so the trace
// is read once per attempt.  The TPU kernel's sequential (B, T/block_t)
// grid with scratch carried between steps is not carried over.
//
// Built without --use_fast_math: viol depends on IEEE float32 compares.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;

__device__ __forceinline__ float alloc_at(const float* st, const float* pk,
                                          int K, float t) {
  // Slot k is active on [st[k], st[k+1]); duplicate starts are empty, the
  // last start <= t wins, no active slot reads pk[0] (kernel.py:_alloc_block).
  float acc = 0.0f;
  bool hit = false;
  for (int k = 0; k < K; ++k) {
    bool in_seg = st[k] <= t && (k + 1 == K || t < st[k + 1]);
    if (in_seg) {
      acc = acc + pk[k];
      hit = true;
    }
  }
  return hit ? acc : pk[0];
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;  // meaningful in thread 0 only
}

__device__ __forceinline__ int block_min(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = red[0];
    for (int w = 1; w < kThreads / 32; ++w) m = min(m, red[w]);
    red[0] = m;
  }
  __syncthreads();
  return red[0];  // broadcast to every thread
}

template <bool PROBE>
__global__ void __launch_bounds__(kThreads)
wastage_kernel(const float* __restrict__ starts, const float* __restrict__ peaks,
               const float* __restrict__ mems, const int* __restrict__ lengths,
               int K, int T, float dt, int* __restrict__ viol,
               float* __restrict__ w_succ, float* __restrict__ w_kill) {
  __shared__ float st[kMaxK];
  __shared__ float pk[kMaxK];
  __shared__ float fred[kThreads / 32];
  __shared__ int ired[kThreads / 32];

  const int b = blockIdx.x;
  if (threadIdx.x < K) {
    st[threadIdx.x] = starts[(size_t)b * K + threadIdx.x];
    pk[threadIdx.x] = peaks[(size_t)b * K + threadIdx.x];
  }
  __syncthreads();

  const int len = min(lengths[b], T);
  const float* row = mems + (size_t)b * T;
  float succ = 0.0f;
  int first = T;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float t = (float)i * dt;
    const float a = alloc_at(st, pk, K, t);
    const float m = row[i];
    succ += fmaxf(a, m) - m;
    if (PROBE && m > a && i < first) first = i;
  }
  succ = block_sum(succ, fred);
  if (!PROBE) {
    if (threadIdx.x == 0) w_succ[b] = succ * dt;
    return;
  }

  first = block_min(first, ired);
  float kill = 0.0f;
  if (first < T) {  // uniform across the block
    for (int i = threadIdx.x; i <= first; i += kThreads)
      kill += alloc_at(st, pk, K, (float)i * dt);
  }
  kill = block_sum(kill, fred);
  if (threadIdx.x == 0) {
    const bool found = first < T;
    viol[b] = found ? first : -1;
    w_succ[b] = succ * dt;
    w_kill[b] = found ? kill * dt : 0.0f;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused.  The wrapper checks B, K <= 32, shapes and types beforehand.
int ksp_oom_probe(const float* starts, const float* peaks, const float* mems,
                  const int* lengths, int B, int K, int T, float dt, int* viol,
                  float* w_succ, float* w_kill, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || T <= 0) return (int)cudaErrorInvalidValue;
  wastage_kernel<true><<<B, kThreads, 0, stream>>>(
      starts, peaks, mems, lengths, K, T, dt, viol, w_succ, w_kill);
  return (int)cudaGetLastError();
}

int ksp_wastage_eval(const float* starts, const float* peaks, const float* mems,
                     const int* lengths, int B, int K, int T, float dt,
                     float* w_succ, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || T <= 0) return (int)cudaErrorInvalidValue;
  wastage_kernel<false><<<B, kThreads, 0, stream>>>(
      starts, peaks, mems, lengths, K, T, dt, nullptr, w_succ, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
