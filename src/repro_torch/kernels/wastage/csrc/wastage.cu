// Batched OOM probe, success wastage and the whole OOM/retry engine of the
// KS+ fleet, for Hopper (sm_90a).
//
// Replaces the TPU kernels in repro/kernels/wastage/kernel.py:
//   ksp_oom_probe    -> oom_probe_kernel (one OOM/retry attempt per lane)
//   ksp_wastage_eval -> wastage_kernel   (success wastage only)
// and, on the same per-lane body, runs the reference engine's attempt loop
// (repro/core/fleet.py: _engine_loop under lax.while_loop) on the device:
//   ksp_fleet_engine -> every attempt of every lane of a fleet call, one
//                       launch (plain version: repro_torch/core/fleet.py,
//                       plain_engine).
//
// Per lane, with alloc(t) the step function of (starts, peaks) on the
// float32 grid t_i = float(i) * dt:
//   viol   = first i < len with mem_i > alloc(t_i), or -1
//   w_succ = dt * sum_{i < len} (max(alloc, mem) - mem)
//   w_kill = dt * sum_{i <= viol} alloc, 0 when viol < 0
//
// Bound: memory.  A probe reads each valid sample once (4 bytes) and does a
// compare, a max and an add on it; the plans are K <= 32 slots a lane.
//
// Design.  Every entry takes a group table (struct Group below): one record
// per (plan batch, trace bucket) group, ordered by the group's first lane.
// A single group is a table of one.
//  * A warp per lane, 8 lanes a block, no block barrier: each warp finds its
//    group with one ballot over the records' first lanes and runs on its
//    own, so a lane that retries 25 times holds back no other.  Warps take
//    lanes in table order; tables list their longest rows first, so the
//    longest lanes start first and the short ones fill in behind them.
//  * Slot k of the lane's plan lives in warp lane k.  Each slot's first
//    sample b_k (the first i with float(i) * dt >= starts_k, exactly, as
//    core/fleet.py:_seg_bounds finds it) is staged in shared memory with its
//    peak, and each thread maps its samples to their slot by walking those
//    bounds forward: O(K + samples) a thread instead of K compares a sample.
//    The walk needs non-decreasing starts.  Every plan of the engine has
//    them (pack_plans, apply_offsets' running max, the ksplus rule's
//    cummax) and ops.fleet_engine raises on any other, so the engine always
//    walks.  In the probes a lane whose starts decrease (one ballot finds
//    it) takes the TPU kernel's one-hot select (kernel.py:_alloc_block).
//  * Rows of a bucket are a power of two >= 128 floats, so they are read as
//    float4, 16 bytes a thread, 128 samples a warp step; other rows
//    (T % 4 != 0, unaligned) take scalar loads.  Each thread's first chunk
//    is loaded together with the lane's length and plan, and the engine
//    keeps it in registers across attempts.  The first violation is a
//    ballot over the samples in order; w_succ a per-thread partial sum and a
//    shuffle reduction; w_kill O(K) span arithmetic from the bounds
//    (core/fleet.py:_span_alloc_sum), no second sweep.
//  * The engine's attempt loop stops each sweep at its first violation,
//    settles success and kill wastage by span arithmetic, finds once per
//    lane whether any sample exceeds the machine (unsatisfiable), and
//    applies the retry rule slot-parallel (cummax as a warp scan).
//    The engine reads a trace once per job and attempt, mostly from L2; one
//    warp per (job, lane), not per trace lane.
//
// Rounding.  The engine must give the PyTorch engine's attempts exactly, so
// every product, quotient and sum that feeds a plan or a wastage term is a
// single IEEE float32 operation (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction), sums over slots are taken in slot order, and the retry
// rules' Python constants arrive already rounded to float32, as PyTorch
// rounds them.  Built without --use_fast_math.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;      // lanes (warps) per block
constexpr int kMaxK = 32;      // plan slots: one per warp lane
constexpr unsigned kAll = 0xffffffffu;
constexpr float kPadStart = 1e30f;  // core/fleet.py PAD_START

// Retry rules (core/fleet.py:_retry_transform), numbered as ops.RETRY_KINDS.
enum Kind { kNone = 0, kDouble, kMaxMachine, kSelective, kPartial, kKsplus };

// One (plan batch, trace bucket) group; layout mirrors ops.GROUP_DTYPE.
struct Group {
  const float* starts;   // (B, K)
  const float* peaks;    // (B, K)
  const int* nseg;       // (B,) real slots (engine)
  const float* bump;     // (B,) per-lane ksplus bump, or null (engine)
  const float* mems;     // (>= B, T) rows of the bucket
  const int* lengths;    // (>= B,) valid samples per row
  const float* summem;   // (>= B,) float32 sum of each row's samples (engine)
  int B, K, T, lane0;    // lanes, slots, row length, first lane of the group
  int kind;              // retry rule (engine)
  float margin;          // float32(1 + margin): the kseg rules
  float bump_mul;        // float32(1 + bump) where bump is null
  int vec;               // rows 16-byte aligned and T % 4 == 0: float4 loads
};
static_assert(sizeof(Group) == 88, "Group must match ops.GROUP_DTYPE");

struct Staged {  // one warp's staged plan
  int bound[kMaxK];
  float alloc[kMaxK];
  float start[kMaxK];
};

// The last group whose first lane is <= lane: the warp reads 32 records'
// first lanes at once, so a table of up to 32 groups costs one round trip.
__device__ __forceinline__ int find_group(const Group* table, int n, int lane) {
  const int k = threadIdx.x & 31;
  int count = 0;
  for (int c = 0; c < n; c += 32) {
    const unsigned le = __ballot_sync(
        kAll, c + k < n && __ldg(&table[c + k].lane0) <= lane);
    count += __popc(le);
    if (le != kAll) break;  // first lanes ascend
  }
  return count - 1;
}

// First sample i with float(i) * dt >= s.  ceil(s / dt) can be one off, so
// both neighbours are checked on the grid itself (core/fleet.py:_seg_bounds).
__device__ __forceinline__ int seg_bound(float s, float dt) {
  float c = fminf(fmaxf(ceilf(__fdiv_rn(s, dt)), 0.0f), 1.0e9f);
  if (__fmul_rn(c - 1.0f, dt) >= s) c -= 1.0f;
  if (__fmul_rn(fminf(fmaxf(c, 0.0f), 1.0e9f), dt) < s) c += 1.0f;
  return (int)fminf(fmaxf(c, 0.0f), 2.0e9f);
}

// Stage lane k's slot (start, peak, bound; slot 0 holds from sample 0) and
// return the bound in a register.
__device__ __forceinline__ int stage(float st, float pk, int K, float dt,
                                     int k, Staged& s) {
  const int bound = k == 0 ? 0 : seg_bound(st, dt);
  __syncwarp();  // the previous attempt's sweep has read s
  if (k < K) {
    s.bound[k] = bound;
    s.alloc[k] = pk;
    s.start[k] = st;
  }
  __syncwarp();
  return bound;
}

// Whether the lane's starts never decrease (warp-uniform; a NaN counts as a
// decrease).
__device__ __forceinline__ bool nondecreasing(float st, int K, int k) {
  const float prev = __shfl_up_sync(kAll, st, 1);
  return __all_sync(kAll, k == 0 || k >= K || prev <= st);
}

// The TPU kernel's select: slot k is active on [starts_k, starts_{k+1}),
// the active slots' peaks add up, no active slot reads peaks_0.
__device__ __forceinline__ float onehot(const Staged& s, int K, float t) {
  float acc = 0.0f;
  bool hit = false;
  for (int k = 0; k < K; ++k) {
    if (s.start[k] <= t && (k + 1 == K || t < s.start[k + 1])) {
      acc = acc + s.alloc[k];
      hit = true;
    }
  }
  return hit ? acc : s.alloc[0];
}

// Thread `lane`'s chunk `c` of a row: 4 samples (float4 rows) or 1, zeros
// past the row's end.  T % 4 == 0 on float4 rows: a chunk is all in or out.
__device__ __forceinline__ float4 chunk(const float* __restrict__ row, int T,
                                        bool vec, int c) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && 4 * c < T)
    v = __ldg(reinterpret_cast<const float4*>(row) + c);
  else if (!vec && c < T)
    v.x = __ldg(row + c);
  return v;
}

// One pass over a lane's valid samples in order, a warp step of 32 chunks
// (128 samples of a float4 row).  SUM: this thread's share of
// sum(max(alloc, mem) - mem).  FIRST: the first violating sample,
// warp-uniform, -1 when none; EARLY stops at the first step that holds
// one.  `head` is the thread's first chunk, loaded before the plan was
// staged (the engine keeps it in registers across attempts).
template <bool SUM, bool FIRST, bool EARLY>
__device__ __forceinline__ int sweep(const float* __restrict__ row, int len,
                                     int T, bool vec, float4 head, bool mono,
                                     int K, const Staged& s, float dt,
                                     float& sum) {
  const int lane = threadIdx.x & 31;
  const int width = vec ? 4 : 1;  // samples a thread loads at once
  int first = -1, seg = 0;
  auto visit = [&](int i, float m, int& bad) {
    float a;
    if (mono) {
      while (seg + 1 < K && s.bound[seg + 1] <= i) ++seg;
      a = s.alloc[seg];
    } else {
      a = onehot(s, K, __fmul_rn((float)i, dt));
    }
    if (SUM) sum += fmaxf(a, m) - m;
    if (FIRST && bad == INT_MAX && m > a) bad = i;
  };
  for (int base = 0; base < len; base += 32 * width) {
    // this thread's samples i0 .. i0 + width - 1
    const float4 v = base == 0 ? head : chunk(row, T, vec, base / width + lane);
    const int i0 = base + lane * width;
    int bad = INT_MAX;
    if (i0 < len) visit(i0, v.x, bad);
    if (vec && i0 + 1 < len) visit(i0 + 1, v.y, bad);
    if (vec && i0 + 2 < len) visit(i0 + 2, v.z, bad);
    if (vec && i0 + 3 < len) visit(i0 + 3, v.w, bad);
    if (FIRST) {
      const unsigned hit = __ballot_sync(kAll, bad != INT_MAX);
      if (hit) {
        if (first < 0) first = __shfl_sync(kAll, bad, __ffs(hit) - 1);
        if (EARLY) break;
      }
    }
  }
  return first;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

__device__ __forceinline__ float warp_cummax(float v, int k) {
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kAll, v, d);
    if (k >= d) v = fmaxf(v, o);
  }
  return v;
}

// sum_k peak_k * |[b_k, b_{k+1}) ∩ [0, upto)|, slot by slot in order, one
// rounding per product and per sum: the allocation integral over the first
// `upto` samples in O(K) (core/fleet.py:_span_alloc_sum).  Warp-uniform.
__device__ __forceinline__ float span_sum(float pk, int bound, int K, int upto,
                                          int k) {
  int hi = __shfl_down_sync(kAll, bound, 1);
  if (k + 1 >= K) hi = INT_MAX;
  const int span = max(min(hi, upto) - min(bound, upto), 0);
  const float term = __fmul_rn(pk, (float)span);
  float acc = __shfl_sync(kAll, term, 0);
  for (int j = 1; j < K; ++j) acc = __fadd_rn(acc, __shfl_sync(kAll, term, j));
  return acc;
}

// One retry rule, slot-parallel (core/fleet.py:_retry_transform): lane k
// rewrites slot k of (st, pk); pk holds the capped peaks.
__device__ __forceinline__ void retry(const Group& g, int k, int nseg,
                                      float t_fail, float used, float mm,
                                      float bump_mul, float& st, float& pk) {
  if (g.kind == kNone) return;
  if (g.kind == kDouble) {
    pk = fminf(pk * 2.0f, mm);
    return;
  }
  if (g.kind == kMaxMachine) {
    pk = mm;
    return;
  }
  // failed segment: the last real slot with start <= t_fail
  const bool real = k < nseg;
  const int j = min(max(__popc(__ballot_sync(kAll, real && st <= t_fail)) - 1,
                        0), nseg - 1);
  const float peak_j = __shfl_sync(kAll, pk, j);
  if (g.kind == kSelective || g.kind == kPartial) {
    const float target = fmaxf(__fmul_rn(peak_j, g.margin),
                               __fmul_rn(used, g.margin));
    if (g.kind == kSelective ? k == j : real && k >= j)
      pk = g.kind == kSelective ? target : fmaxf(pk, target);
    return;
  }
  // ksplus: re-time (the next segment starts at the failure, later ones
  // scale with it), or bump the last peak when the last segment failed
  const float nxt = __shfl_sync(kAll, st, min(j + 1, g.K - 1));
  const float factor = nxt > 0.0f ? __fdiv_rn(t_fail, fmaxf(nxt, 1e-30f))
                                  : 0.0f;
  float s = real && k > j + 1 ? __fmul_rn(st, factor) : st;
  if (k == j + 1) s = t_fail;
  s = warp_cummax(fmaxf(s, 0.0f), k);
  if (k == 0) s = 0.0f;
  if (!real) s = kPadStart;
  const float p = warp_cummax(k == nseg - 1 ? __fmul_rn(pk, bump_mul) : pk, k);
  if (j >= nseg - 1) pk = p; else st = s;
}

__device__ __forceinline__ bool any_above(const float* __restrict__ row,
                                          int from, int len, float mm) {
  bool hit = false;
  for (int i = from + (int)(threadIdx.x & 31); i < len; i += 32)
    hit |= __ldg(row + i) > mm;
  return __any_sync(kAll, hit);
}

enum Mode { kProbe, kEval, kEngine };

// out: three words per lane, laid out as (3, n_lanes) — probe: viol,
// w_succ, w_kill; eval: w_succ; engine: wastage, attempts, succeeded.
// At least 6 blocks (48 warps) an SM: a lane's work is a chain of
// dependent loads and shuffles, so lanes in flight matter more than the
// few bytes the probe then spills (ptxas: 40 registers; the engine spills
// none).
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32, 6)
wastage_groups(const Group* __restrict__ table, int n_groups, int n_lanes,
               float dt, float mm, int max_attempts, int* __restrict__ out) {
  __shared__ Staged staged[kWarps];
  const int k = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane >= n_lanes) return;  // the whole warp
  const Group& g = table[find_group(table, n_groups, lane)];
  const int l = lane - g.lane0;
  const int T = g.T;
  const bool vec = g.vec;
  const float* row = g.mems + (size_t)l * T;
  // everything that hangs on the record alone goes out at once
  const float4 head = chunk(row, T, vec, k);
  const int len = min(__ldg(g.lengths + l), T);
  float* w0 = reinterpret_cast<float*>(out);
  float* w1 = reinterpret_cast<float*>(out + n_lanes);
  float* w2 = reinterpret_cast<float*>(out + 2 * n_lanes);
  if (len <= 0) {  // an empty row: no violation, no wastage, one attempt
    if (k == 0) {
      if (MODE == kProbe) {
        out[lane] = -1;
        w1[lane] = 0.0f;
        w2[lane] = 0.0f;
      } else {
        w0[lane] = 0.0f;
      }
      if (MODE == kEngine) {
        out[n_lanes + lane] = 1;
        out[2 * n_lanes + lane] = 1;
      }
    }
    return;
  }
  Staged& s = staged[threadIdx.x >> 5];
  const int K = g.K;
  float st = k < K ? __ldg(g.starts + (size_t)l * K + k) : kPadStart;
  float pk = k < K ? __ldg(g.peaks + (size_t)l * K + k) : 0.0f;

  if (MODE != kEngine) {
    const int bound = stage(st, pk, K, dt, k, s);
    const bool mono = nondecreasing(st, K, k);
    float sum = 0.0f;
    const int viol = sweep<true, MODE == kProbe, false>(
        row, len, T, vec, head, mono, K, s, dt, sum);
    const float w_succ = warp_sum(sum) * dt;
    if (MODE == kEval) {
      if (k == 0) w0[lane] = w_succ;
      return;
    }
    float kill = 0.0f;
    if (viol >= 0 && mono) {
      kill = span_sum(pk, bound, K, viol + 1, k);
    } else if (viol >= 0) {  // one-hot lanes sum the allocation itself
      for (int i = k; i <= viol; i += 32)
        kill += onehot(s, K, __fmul_rn((float)i, dt));
      kill = warp_sum(kill);
    }
    if (k == 0) {
      out[lane] = viol;
      w1[lane] = w_succ;
      w2[lane] = kill * dt;
    }
    return;
  }

  const int nseg = __ldg(g.nseg + l);
  const float summem = __ldg(g.summem + l);
  const float bump_mul = g.bump ? __fadd_rn(1.0f, __ldg(g.bump + l))
                                : g.bump_mul;
  float w = 0.0f;
  int att = 0, unsat = -1;
  bool succ = false;
  for (;;) {
    ++att;
    const float cap = fminf(pk, mm);
    const int bound = stage(st, cap, K, dt, k, s);
    float unused = 0.0f;
    const int viol = sweep<false, true, true>(row, len, T, vec, head,
                                              /*mono=*/true, K, s, dt, unused);
    if (viol < 0) {
      const float total = span_sum(cap, bound, K, len, k);
      w = __fadd_rn(w, __fmul_rn(__fsub_rn(total, summem), dt));
      succ = true;
      break;
    }
    w = __fadd_rn(w, __fmul_rn(span_sum(cap, bound, K, viol + 1, k), dt));
    // samples before viol fit an allocation <= mm: look from viol on, once
    if (unsat < 0) unsat = any_above(row, viol, len, mm);
    if (unsat || att >= max_attempts) break;
    pk = cap;
    retry(g, k, nseg, __fmul_rn((float)viol, dt), __ldg(row + viol), mm,
          bump_mul, st, pk);
  }
  if (k == 0) {
    w0[lane] = w;
    out[n_lanes + lane] = att;
    out[2 * n_lanes + lane] = succ;
  }
}

int launch(int mode, const void* table, int n_groups, int n_lanes, float dt,
           float mm, int max_attempts, int* out, cudaStream_t stream) {
  if (n_groups <= 0 || n_lanes <= 0) return (int)cudaErrorInvalidValue;
  const Group* t = static_cast<const Group*>(table);
  const dim3 grid((n_lanes + kWarps - 1) / kWarps), block(kWarps * 32);
  if (mode == kProbe)
    wastage_groups<kProbe><<<grid, block, 0, stream>>>(t, n_groups, n_lanes,
                                                       dt, mm, 0, out);
  else if (mode == kEval)
    wastage_groups<kEval><<<grid, block, 0, stream>>>(t, n_groups, n_lanes,
                                                      dt, mm, 0, out);
  else
    wastage_groups<kEngine><<<grid, block, 0, stream>>>(
        t, n_groups, n_lanes, dt, mm, max_attempts, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches one kernel over a device group table of n_groups
// records (ordered by lane0, K <= 32, checked by the wrapper) and returns
// cudaGetLastError(): nonzero means the launch was refused.  out holds
// (3, n_lanes) 4-byte words.
int ksp_oom_probe(const void* table, int n_groups, int n_lanes, float dt,
                  int* out, cudaStream_t stream) {
  return launch(kProbe, table, n_groups, n_lanes, dt, 0.0f, 0, out, stream);
}

int ksp_wastage_eval(const void* table, int n_groups, int n_lanes, float dt,
                     int* out, cudaStream_t stream) {
  return launch(kEval, table, n_groups, n_lanes, dt, 0.0f, 0, out, stream);
}

int ksp_fleet_engine(const void* table, int n_groups, int n_lanes, float dt,
                     float mm, int max_attempts, int* out,
                     cudaStream_t stream) {
  return launch(kEngine, table, n_groups, n_lanes, dt, mm, max_attempts, out,
                stream);
}

}  // extern "C"
