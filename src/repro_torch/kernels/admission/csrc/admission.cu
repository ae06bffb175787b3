// The admission programs of the KS+ cluster replay, for Hopper (sm_90a).
//
// Replaces the reference's jitted programs in repro/sched/admission.py
// (XLA programs, not Pallas):
//   ksp_admit_columns -> _fused_kernel (admission.py:100): fits and minimum
//                        residual of every requested (node, queued lane);
//   ksp_admit_drain   -> _drain_kernel (admission.py:166): a whole greedy
//                        drain, the lax.while_loop and the admit-time
//                        scatter, in one launch.
// Plain versions: repro_torch/kernels/admission/ref.py (plain_columns,
// plain_drain).
//
// Per node n, queued lane q and grid point g, with tabs = now + grid[q, g]:
//   resid[n, q, g] = caps[n] - sum_r alloc_r(tabs - t0[r])
//   fits[n, q]     = all_g need[q, g] <= resid[n, q, g] + tol
//   minresid[n, q] = min_g resid[n, q, g]
// where alloc_r is resident r's step function (K-step select chain), masked
// (use_dur) to [t0, t0 + dur + 1e-9).
//
// Bound.  By bytes the columns read the residents' plans and the queued
// lanes' need and grid once and write 16 bytes a pair; the drain reads the
// same and writes its placement vector: a few hundred KB at most, well
// under a microsecond at the card's memory rate.  In practice both are
// bound by latency: the drain is one block whose steps are separated by
// __syncthreads (about three a loop iteration), and the host waits for it.
// Making it fast (thread block clusters, a residual kept resident between
// drains) is later work; this design is the simple one that is right.
//
// Design.
//  * One __device__ residual function serves both entries: residents are
//    summed in order r = 0 ... R-1 from 0.0, then subtracted from caps[n].
//    The wide-backlog pre-filter (columns) and the drain therefore agree to
//    the bit, which the drain's continuation relies on.
//  * Columns: one warp per (node, lane) pair, its threads over g; fits is a
//    warp vote, minresid a shuffle minimum (exact in any order).
//  * Drain: one block of 1024 threads.  The base residual goes into an
//    N x Q x G float64 scratch in device memory (L2-resident at the
//    replay's sizes; the wrapper keeps it between launches), beside an
//    N x Q byte fit table and an int per node.  Each loop iteration then
//      1. for each active lane (one warp each) walks the nodes in order:
//         its fits into the table and its node, the first fitting one or
//         the largest min_g resid - peak, first on ties;
//      2. each fitting lane takes its node's first chooser (atomicMin over
//         the lanes that chose it); with one thread per lane (Q <= 1024),
//         a lane that fits a node whose first chooser comes before it
//         conflicts, and the first such lane is the cut (a shared
//         atomicMin); fitting lanes before it are placed, into slots from
//         an exclusive block scan.  A placed lane is its node's first
//         chooser, so at most one lane is placed a node;
//      3. subtracts each node's placed envelope from its rows and clears
//         the placed lanes' active bits,
//    until no lane fits.  Nothing bounds N but the scratch.  Each
//    iteration places at least the first fitting lane, so more than Q + 1
//    iterations is a fault: __trap().  Last, the admit-time scatter
//    admit_t[lanes[i]] = now for every slot i < Q (unused slots hold lane
//    B, the buffer's spare slot), in the launch.
//
// Rounding.  Everything is float64.  The math has no multiply, so no FMA
// contraction can arise; the operations are those of the plain version in
// the same order: tabs = now + grid, rel = tabs - t0, a placed lane's
// prel = tabs - now (not grid), need <= resid + tol.  The plain version
// sums residents through torch's reduction, so a residual can differ from
// it in the last ulp; decisions differ only where a need grazes the
// residual within that ulp of tol.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

typedef long long i64;

constexpr double kWindow = 1e-9;       // admission.py WINDOW
constexpr int kDrainThreads = 1024;    // one block; one thread per lane
constexpr int kDrainWarps = kDrainThreads / 32;
constexpr int kColumnsThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

// The resident lane state and one call's operands, as ops.py passes them.
struct Lanes {
  const double* starts;   // (B, K)
  const double* peaks;    // (B, K)
  const double* admit_t;  // (B + 1,)
  const double* dur;      // (B,)
  const double* need;     // (B, G)
  const double* grid;     // (B, G)
  int K, G;
};

struct Operands {
  const double* caps;     // (N,)
  const i64* run_idx;     // (N, R) resident lanes
  const i64* run_valid;   // (N, R) nonzero where a resident is real
  const i64* q_idx;       // (Q,) queued lanes, queue order
  const double* now;      // ()
  const double* tol;      // ()
  int N, R, Q;
};

// Step function of one plan at relc: the last slot with starts_k <= relc,
// slot 0 otherwise (ref._alloc_chain).
__device__ __forceinline__ double alloc_at(const double* s, const double* p,
                                           int K, double relc) {
  double a = p[0];
  for (int k = 1; k < K; ++k) a = s[k] <= relc ? p[k] : a;
  return a;
}

// A lane's allocation at rel (relative to its admission), windowed.
template <bool kMasked>
__device__ __forceinline__ double windowed(const Lanes& L, i64 lane,
                                           double rel) {
  const double relc = rel < 0.0 ? 0.0 : rel;  // clamp_min(0.0)
  double a = alloc_at(L.starts + lane * L.K, L.peaks + lane * L.K, L.K,
                      relc);
  if (kMasked && !(rel >= 0.0 && rel < L.dur[lane] + kWindow)) a = 0.0;
  return a;
}

// resid = caps[n] - sum_r alloc_r(tabs - t0[r]), residents in order from
// 0.0: the one residual of both entries.
template <bool kMasked>
__device__ __forceinline__ double residual(const Lanes& L, const Operands& op,
                                           int n, double tabs) {
  double usage = 0.0;
  const i64* run = op.run_idx + (size_t)n * op.R;
  const i64* valid = op.run_valid + (size_t)n * op.R;
  for (int r = 0; r < op.R; ++r) {
    const i64 lane = run[r];
    double a = windowed<kMasked>(L, lane, tabs - L.admit_t[lane]);
    if (valid[r] == 0) a = 0.0;
    usage = usage + a;
  }
  return op.caps[n] - usage;
}

__device__ __forceinline__ double warp_min(double x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmin(x, __shfl_xor_sync(kAll, x, off));
  return x;
}

// ------------------------------------------------------------- columns
template <bool kMasked>
__global__ void __launch_bounds__(kColumnsThreads)
columns_kernel(Lanes L, Operands op, double* out) {
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int k = threadIdx.x & 31;
  const int pairs = op.N * op.Q;
  if (pair >= pairs) return;  // the whole warp
  const int n = pair / op.Q, q = pair - n * op.Q;
  const i64 qi = op.q_idx[q];
  const double now = *op.now, tol = *op.tol;
  bool ok = true;
  double mn = INFINITY;
  for (int g = k; g < L.G; g += 32) {
    const size_t e = (size_t)qi * L.G + g;
    const double r = residual<kMasked>(L, op, n, now + L.grid[e]);
    ok = ok && L.need[e] <= r + tol;
    mn = fmin(mn, r);
  }
  ok = __all_sync(kAll, ok);
  mn = warp_min(mn);
  if (k == 0) {
    out[pair] = ok ? 1.0 : 0.0;
    out[pairs + pair] = mn;
  }
}

// --------------------------------------------------------------- drain
// Exclusive prefix sum over the block's 1024 threads in thread order;
// *total gets the sum of all.  Every thread must call it.
__device__ int block_exclusive_sum(int x, int* warp_tot, int* total) {
  const int k = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, off);
    if (k >= off) inc += y;
  }
  if (k == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    int t = warp_tot[k];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, t, off);
      if (k >= off) t += y;
    }
    warp_tot[k] = t;  // inclusive over warps
  }
  __syncthreads();
  int ex = __shfl_up_sync(kAll, inc, 1);
  if (k == 0) ex = 0;
  const int res = w == 0 ? ex : warp_tot[w - 1] + ex;
  *total = warp_tot[kDrainWarps - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return res;
}

// scratch: resid (N * Q * G float64), then chooser (N int), then the fit
// table (N * Q bytes, [n * Q + q]); ops.py sizes it.
template <bool kMasked, bool kHeadroom>
__global__ void __launch_bounds__(kDrainThreads, 1)
drain_kernel(Lanes L, Operands op, int B, double* resid, i64* vec,
             double* admit_t) {
  __shared__ int nodeq[kDrainThreads];     // lane q's chosen node
  __shared__ double peakq[kDrainThreads];  // max_k peaks (headroom)
  __shared__ unsigned char active[kDrainThreads];
  __shared__ unsigned char anyq[kDrainThreads];  // lane q fits somewhere
  __shared__ int sum_tot[kDrainWarps];
  __shared__ int first_conf;

  const int t = threadIdx.x, k = t & 31, w = t >> 5;
  const int N = op.N, Q = op.Q, G = L.G;
  const size_t QG = (size_t)Q * G, NQG = (size_t)N * QG;
  int* chooser = reinterpret_cast<int*>(resid + NQG);  // node -> first lane
  unsigned char* fit = reinterpret_cast<unsigned char*>(chooser + N);
  const double now = *op.now, tol = *op.tol;
  i64* lanes_out = vec + 2;
  i64* nodes_out = vec + 2 + Q;

  if (t < Q) {
    active[t] = 1;
    if (kHeadroom) {
      const double* p = L.peaks + op.q_idx[t] * L.K;
      double m = p[0];
      for (int j = 1; j < L.K; ++j) m = fmax(m, p[j]);
      peakq[t] = m;
    }
    lanes_out[t] = B;
    nodes_out[t] = B;
  }
  for (int n = t; n < N; n += kDrainThreads) chooser[n] = Q;
  if (t == 0) first_conf = Q;
  // base residuals from the current residents
  for (size_t e = t; e < NQG; e += kDrainThreads) {
    const int n = (int)(e / QG);
    const size_t rem = e - n * QG;
    const int q = (int)(rem / G), g = (int)(rem - (size_t)q * G);
    resid[e] = residual<kMasked>(
        L, op, n, now + L.grid[op.q_idx[q] * G + g]);
  }
  __syncthreads();

  int count = 0, iterations = 0;
  for (;;) {
    if (++iterations > Q + 1) __trap();  // each iteration places a lane
    // 1. fits and chosen nodes, one warp per active lane
    for (int q = w; q < Q; q += kDrainWarps) {
      bool any = false;
      int node = 0;
      double best = -INFINITY;
      if (active[q]) {
        const size_t qn = (size_t)op.q_idx[q] * G;
        for (int n = 0; n < N; ++n) {
          const double* rr = resid + (size_t)n * QG + (size_t)q * G;
          bool ok = true;
          double mn = INFINITY;
          for (int g = k; g < G; g += 32) {
            const double r = rr[g];
            ok = ok && L.need[qn + g] <= r + tol;
            if (kHeadroom) mn = fmin(mn, r);
          }
          ok = __all_sync(kAll, ok);
          if (k == 0) fit[(size_t)n * Q + q] = ok;
          if (!ok) continue;
          if (kHeadroom) {
            const double head = warp_min(mn) - peakq[q];
            if (!any || head > best) {
              best = head;
              node = n;
            }
          } else if (!any) {
            node = n;
          }
          any = true;
        }
      }
      if (k == 0) {
        anyq[q] = any;
        nodeq[q] = node;
      }
    }
    __syncthreads();
    // 2. the independent prefix: each node's first chooser, the conflict
    //    cut and the slots
    const bool anyfit = t < Q && anyq[t];
    if (anyfit) atomicMin(&chooser[nodeq[t]], t);
    const bool done = !__syncthreads_or(anyfit);
    if (anyfit) {
      for (int n = 0; n < N; ++n) {
        if (chooser[n] < t && fit[(size_t)n * Q + t]) {
          atomicMin(&first_conf, t);
          break;
        }
      }
    }
    __syncthreads();
    const bool place = anyfit && t < first_conf;
    int placed;
    const int slot = count + block_exclusive_sum(place ? 1 : 0, sum_tot,
                                                 &placed);
    if (done) break;  // uniform: nothing fits, nothing was placed
    if (place) {
      lanes_out[slot] = op.q_idx[t];
      nodes_out[slot] = nodeq[t];
      active[t] = 0;
    }
    count += placed;
    // 3. subtract the placed envelopes: node n's first chooser c, when
    //    placed (c < first_conf), admitted at now
    const int cut = first_conf;
    for (int n = 0; n < N; ++n) {
      const int c = chooser[n];  // uniform over the block
      if (c >= cut) continue;
      const i64 lane = op.q_idx[c];
      double* rn = resid + (size_t)n * QG;
      for (size_t e = t; e < QG; e += kDrainThreads) {
        const int q = (int)(e / G), g = (int)(e - (size_t)q * G);
        const double tabs = now + L.grid[op.q_idx[q] * G + g];
        rn[e] = rn[e] - windowed<kMasked>(L, lane, tabs - now);
      }
    }
    __syncthreads();
    for (int n = t; n < N; n += kDrainThreads) chooser[n] = Q;
    if (t == 0) first_conf = Q;
    // the next iteration's step 1 ends in a barrier before these are read
  }
  if (t == 0) {
    vec[0] = count;
    vec[1] = iterations;
  }
  __syncthreads();  // the placement list is written
  // the admit-time scatter, in the same launch
  for (int i = t; i < Q; i += kDrainThreads) admit_t[lanes_out[i]] = now;
}

template <bool kMasked>
void launch_drain(bool headroom, const Lanes& L, const Operands& op, int B,
                  double* scratch, i64* vec, double* admit_t,
                  cudaStream_t stream) {
  if (headroom)
    drain_kernel<kMasked, true><<<1, kDrainThreads, 0, stream>>>(
        L, op, B, scratch, vec, admit_t);
  else
    drain_kernel<kMasked, false><<<1, kDrainThreads, 0, stream>>>(
        L, op, B, scratch, vec, admit_t);
}

}  // namespace

extern "C" {

// Both entries return cudaGetLastError(): nonzero means the launch was
// refused.  Sizes are checked by the wrapper (ops.py).
int ksp_admit_columns(const double* starts, const double* peaks,
                      const double* admit_t, const double* dur,
                      const double* need, const double* grid,
                      const double* caps, const i64* run_idx,
                      const i64* run_valid, const i64* q_idx,
                      const double* now, const double* tol, int N, int R,
                      int Q, int K, int G, int masked, double* out,
                      cudaStream_t stream) {
  if (N <= 0 || R <= 0 || Q <= 0 || K <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  const Lanes L{starts, peaks, admit_t, dur, need, grid, K, G};
  const Operands op{caps, run_idx, run_valid, q_idx, now, tol, N, R, Q};
  const long long threads = (long long)N * Q * 32;
  const dim3 grid_dim((unsigned)((threads + kColumnsThreads - 1)
                                 / kColumnsThreads));
  if (masked)
    columns_kernel<true><<<grid_dim, kColumnsThreads, 0, stream>>>(L, op,
                                                                   out);
  else
    columns_kernel<false><<<grid_dim, kColumnsThreads, 0, stream>>>(L, op,
                                                                    out);
  return (int)cudaGetLastError();
}

// vec: (2 + 2Q,) int64 [count, iterations, lanes[Q], nodes[Q]]; scratch:
// N * Q * G float64, N int and N * Q bytes; admit_t is written at every
// placement slot.
int ksp_admit_drain(const double* starts, const double* peaks,
                    double* admit_t, const double* dur, const double* need,
                    const double* grid, const double* caps,
                    const i64* run_idx, const i64* run_valid,
                    const i64* q_idx, const double* now, const double* tol,
                    int N, int R, int Q, int K, int G, int masked, int B,
                    int select, double* scratch, i64* vec,
                    cudaStream_t stream) {
  if (N <= 0 || R <= 0 || Q <= 0 || Q > kDrainThreads
      || K <= 0 || G <= 0)
    return (int)cudaErrorInvalidValue;
  const Lanes L{starts, peaks, admit_t, dur, need, grid, K, G};
  const Operands op{caps, run_idx, run_valid, q_idx, now, tol, N, R, Q};
  if (masked)
    launch_drain<true>(select == 1, L, op, B, scratch, vec, admit_t, stream);
  else
    launch_drain<false>(select == 1, L, op, B, scratch, vec, admit_t,
                        stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
