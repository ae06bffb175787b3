// The Mamba2 prefill mixer's elementwise work on either side of the SSD
// scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's mixer is plain XLA
// (repro/models/mamba2.py::mamba2_mixer), and so was the port's.  On the card
// that plain form ran ~20 elementwise passes a layer over the in-projection's
// (B, S, 2 din + 2 G N + H) output: the causal conv tap by tap, SiLU,
// softplus, x * dt, Y + D x, y * silu(z), a float32 RMSNorm.  Two kernels
// take all of it, each reading its operands once in place:
//
//   in_kernel (before the scan) reads the bf16 row-major zxbcdt in place:
//     xBC = zxbcdt[..., din : 2 din + 2 G N], dt_raw = zxbcdt[..., -H:]
//     c   = b + sum_i w[:, i] * xBC[t - 3 + i]   (rows before 0 are 0)
//     xbc = bf16(silu(c))                         (float32 sums and SiLU)
//     dt  = softplus(dt_raw + dt_bias)            (float32, per head)
//     X   = bf16(x * dt), Adt = bf16(dt * A)      x = xbc[:din] by head
//     Bm, Cm = xbc[din : din + G N], xbc[din + G N :]
//   and writes X (B, S, H, P), Adt (B, S, H), Bm and Cm (B, S, G, N), the
//   layouts the scan takes.
//
//   out_kernel (after the scan) reads Y (B, S, H, P), z = zxbcdt[..., :din]
//   and, to rebuild x, xBC's first din columns with their three-row halo:
//     g   = (Y + D[h] * x) * silu(z)              (float32)
//     out = bf16(g * rsqrt(mean(g^2 over din) + eps) * norm_scale)
//   x is recomputed by the same device function as in_kernel's, so both see
//   the same bf16 x.  Writing x in in_kernel and reading it back would move
//   2 * B * S * din * 2 bytes; recomputing it reads B * S * din * 2 (plus
//   the halo, mostly from L2): the cheaper of the two.
//
// The plain path's rounding points stay: xbc, X and Adt are rounded to bf16
// where the plain path rounds them; the conv's sums, SiLU and the gated
// norm are taken in float32 where the plain path rounds each step to bf16,
// so the kernels are at least as precise.  Weights, bias and D come in the
// compute dtype (rounded as the plain path rounds them), dt_bias, A and
// norm_scale in float32.
//
// Bound: bytes.  Each kernel reads every operand once and writes every
// output once; a thread owns one 16-byte vector of 8 channels and walks a
// contiguous range of rows with the conv's last three input rows in
// registers, so the halo is read once a range, not once a row.  The grid is
// one wave: every block of the card's SMs x resident blocks gets an equal
// share of the B * S rows (rows of different batch rows restart the window
// at zero).  in_kernel splits a row's vectors over ceil(vectors / 256)
// blocks; out_kernel needs a whole row for the RMS, so a block holds a row
// (a vector a thread: d_inner at most 8 * 768) and sums g^2 over its warps
// through shared memory in a fixed order, one barrier a row.  Each thread
// streams its own operands through a private ring of rows in shared memory
// (cp.async): seven rows in flight in in_kernel, two in out_kernel (whose
// rows are three operands wide, and whose barrier a row would otherwise
// drain the memory pipe).  The conv taps stay in registers.  No atomics:
// two calls are bitwise equal.
//
// Built without --use_fast_math; the conv's sums use explicit fmaf so that
// both kernels compute x with the same instructions, and SiLU takes the fast
// exp and reciprocal explicitly (silu below).
//
// A float32 instance (in_kernel_f32, out_kernel_f32) serves float32 models
// and their training on the card: the same operations in the plain path's
// order (the conv tap by tap from 0, then the bias; SiLU and softplus by the
// accurate expf and log1pf; (g * rsqrt) * scale), a thread an element in
// in_kernel_f32 and a block a row in out_kernel_f32, which keeps the row's
// gated values in shared memory for the second pass (d_inner at most
// kMaxDinF32) and sums g^2 in a fixed order.  No vectors, no rings: float32
// runs only in checks and float32 training, where the products dominate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// Named (not anonymous), so profiler traces show the kernels as
// m2mix::in_kernel and m2mix::out_kernel.
namespace m2mix {

typedef __nv_bfloat16 bf16;

constexpr int kKW = 4;            // conv width (models.blocks.CONV_KW)
constexpr int kVec = 8;           // bf16 channels of a 16-byte vector
constexpr int kInThreads = 256;   // most threads of an in_kernel block
constexpr int kInStages = 8;      // rows of in_kernel's ring: seven in flight
constexpr int kOutThreads = 768;  // most threads of an out_kernel block
constexpr int kStages = 3;        // rows of out_kernel's ring: two in flight
constexpr int kOps = 3;           // out_kernel's operands a row: Y, z, x
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

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

__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x * sigmoid(x) through the hardware's exp2 and reciprocal (__expf,
// __fdividef: a few ulp in float32, far below a bf16 rounding): the
// kernels' SiLUs are most of their instructions.
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

// PyTorch's softplus (beta 1, threshold 20) in float32
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// Element j of 8 packed bf16 (element 2i is word i's low half), as float.
__device__ __forceinline__ float elem(uint4 v, int j) {
  const uint32_t w = (j >> 1) == 0 ? v.x : (j >> 1) == 1 ? v.y
                   : (j >> 1) == 2 ? v.z : v.w;
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// The conv taps of 8 channels c .. c + 7 from w (C, kKW) row-major, packed
// as they lie: taps[q] holds channels c + 2q and c + 2q + 1, four each.
struct Taps {
  uint4 w[kVec / 2];
  uint4 b;
};

__device__ __forceinline__ Taps load_taps(const bf16* w, const bf16* b,
                                          int c) {
  Taps t;
#pragma unroll
  for (int q = 0; q < kVec / 2; ++q)
    t.w[q] = ld16(w + (long long)c * kKW + q * kVec);
  t.b = ld16(b + c);
  return t;
}

// bf16(silu(conv)) of 8 channels from rows t-3, t-2, t-1 (h0..h2) and t.
__device__ __forceinline__ uint4 conv_silu(const Taps& t, uint4 h0, uint4 h1,
                                           uint4 h2, uint4 x) {
  float y[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const uint4 q = t.w[j >> 1];
    const uint32_t wa = (j & 1) ? q.z : q.x, wb = (j & 1) ? q.w : q.y;
    float acc = elem(h0, j) * __uint_as_float(wa << 16);
    acc = fmaf(elem(h1, j), __uint_as_float(wa & 0xffff0000u), acc);
    acc = fmaf(elem(h2, j), __uint_as_float(wb << 16), acc);
    acc = fmaf(elem(x, j), __uint_as_float(wb & 0xffff0000u), acc);
    y[j] = silu(acc + elem(t.b, j));
  }
  return pack(y);
}

struct InArgs {
  const bf16* zx;       // (B, S, Z) zxbcdt
  const bf16* w;        // (din + 2 GN, kKW)
  const bf16* b;        // (din + 2 GN,)
  const float* dt_bias; // (H,)
  const float* A;       // (H,), -exp(A_log)
  bf16* X;              // (B, S, H, P)
  bf16* Adt;            // (B, S, H)
  bf16* Bm;             // (B, S, G, N)
  bf16* Cm;
  int B, S, Z, din, H, P, GN, chunks;
};

// in_kernel's row `row` into ring stage `st`: the thread's 16 bytes of xBC
// and, for an x channel, the 4-byte word of dt_raw that holds its head (4-
// byte aligned: Z and 2 din + 2 GN are multiples of 8).  One commit group a
// row, empty past the range's end.
__device__ __forceinline__ void fetch_in(const bf16* col, const bf16* dtw,
                                        int Z, bool is_x, uint4* xring,
                                        uint32_t* dring, long long row,
                                        long long end, int st) {
  if (row < end) {
    cp_async16(xring + st * blockDim.x + threadIdx.x, col + row * Z);
    if (is_x) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       hopper::smem_u32(dring + st * blockDim.x
                                        + threadIdx.x)),
                   "l"(dtw + row * Z)
                   : "memory");
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kInThreads) in_kernel(InArgs a) {
  extern __shared__ uint4 in_ring[];  // [kInStages][blockDim.x], then dt
  uint4* xring = in_ring;
  uint32_t* dring = reinterpret_cast<uint32_t*>(xring + kInStages
                                                * blockDim.x);
  const int nvec = (a.din + 2 * a.GN) / kVec;
  const int chunk = blockIdx.x % a.chunks;
  const int part = blockIdx.x / a.chunks;
  const int parts = gridDim.x / a.chunks;
  const int v = chunk * blockDim.x + threadIdx.x;
  if (v >= nvec) return;  // no barrier in this kernel
  const long long rows = (long long)a.B * a.S;
  long long r = rows * part / parts;
  const long long end = rows * (part + 1) / parts;
  if (r >= end) return;

  const int c = v * kVec;  // channel of xBC
  const bool is_x = c < a.din;
  const int h = is_x ? c / a.P : 0;
  const bf16* col = a.zx + a.din + c;
  const bf16* dtw = a.zx + 2 * a.din + 2 * a.GN + (h & ~1);
#pragma unroll
  for (int i = 0; i < kInStages - 1; ++i)
    fetch_in(col, dtw, a.Z, is_x, xring, dring, r + i, end, i);

  const Taps taps = load_taps(a.w, a.b, c);
  const bool lead = is_x && c % a.P == 0;  // writes its head's Adt
  const float dtb = is_x ? a.dt_bias[h] : 0.0f;
  const float Ah = is_x ? a.A[h] : 0.0f;
  bf16* dst;
  int stride;
  if (is_x) {
    dst = a.X + c;
    stride = a.din;
  } else if (c < a.din + a.GN) {
    dst = a.Bm + (c - a.din);
    stride = a.GN;
  } else {
    dst = a.Cm + (c - a.din - a.GN);
    stride = a.GN;
  }

  // rows t-3 .. t-1 of the range's first row, zero before the batch row
  int t = (int)(r % a.S);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 win[kKW - 1];
#pragma unroll
  for (int i = 0; i < kKW - 1; ++i)
    win[i] = t - (kKW - 1) + i >= 0
                 ? ld16(col + (r - (kKW - 1) + i) * a.Z) : zero;

  int st = 0;
  for (; r < end; ++r) {
    fetch_in(col, dtw, a.Z, is_x, xring, dring, r + kInStages - 1, end,
             st == 0 ? kInStages - 1 : st - 1);
    cp_async_wait<kInStages - 1>();   // this thread's copies of row r
    if (t == 0) win[0] = win[1] = win[2] = zero;
    const uint4 raw = xring[st * blockDim.x + threadIdx.x];
    const uint4 y = conv_silu(taps, win[0], win[1], win[2], raw);
    win[0] = win[1];
    win[1] = win[2];
    win[2] = raw;
    if (is_x) {
      const uint32_t dw = dring[st * blockDim.x + threadIdx.x];
      const float dt = softplus(
          __uint_as_float((h & 1) ? (dw & 0xffff0000u) : (dw << 16)) + dtb);
      float xd[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) xd[j] = elem(y, j) * dt;
      st16(dst + r * stride, pack(xd));
      if (lead) a.Adt[r * a.H + h] = __float2bfloat16_rn(dt * Ah);
    } else {
      st16(dst + r * stride, y);
    }
    st = st == kInStages - 1 ? 0 : st + 1;
    if (++t == a.S) t = 0;
  }
  cp_async_wait<0>();
}

struct OutArgs {
  const bf16* zx;       // (B, S, Z) zxbcdt
  const bf16* Y;        // (B, S, H, P), the scan's output
  const bf16* w;        // (>= din, kKW): the x channels' taps first
  const bf16* b;
  const bf16* D;        // (H,)
  const float* scale;   // (din,) norm_scale
  bf16* out;            // (B, S, din)
  int B, S, Z, din, P;
  float eps;
};

// out_kernel's row `row` into ring stage `st`: the thread copies its own
// vector of Y, z and xBC's x channels (cp.async), so the ring is private to
// the thread and needs no barrier.  One commit group a row, empty past the
// range's end, so wait_group counts rows.
__device__ __forceinline__ void fetch_out(const OutArgs& a, uint4* ring,
                                         long long row, long long end,
                                         int st, int c, bool on) {
  if (on && row < end) {
    uint4* s = ring + st * kOps * blockDim.x + threadIdx.x;
    cp_async16(s, a.Y + row * a.din + c);
    cp_async16(s + blockDim.x, a.zx + row * a.Z + c);
    cp_async16(s + 2 * blockDim.x, a.zx + row * a.Z + a.din + c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kOutThreads) out_kernel(OutArgs a) {
  extern __shared__ uint4 ring[];   // [kStages][kOps][blockDim.x]
  __shared__ float red[2][kOutThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long rows = (long long)a.B * a.S;
  long long r = rows * blockIdx.x / gridDim.x;
  const long long end = rows * (blockIdx.x + 1) / gridDim.x;
  if (r >= end) return;  // the whole block: no barrier is left waiting

  const bool on = threadIdx.x < a.din / kVec;  // the rest only reduce
  const int c = on ? threadIdx.x * kVec : 0;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch_out(a, ring, r + i, end, i, c,
                                                  on);
  const Taps taps = load_taps(a.w, a.b, c);
  const float d = __bfloat162float(a.D[c / a.P]);
  const bf16* xcol = a.zx + a.din;  // xBC's x channels
  int t = (int)(r % a.S);
  uint4 win[kKW - 1];
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < kKW - 1; ++i)
    win[i] = on && t - (kKW - 1) + i >= 0
                 ? ld16(xcol + (r - (kKW - 1) + i) * a.Z + c) : zero;

  int st = 0, p = 0;
  for (; r < end; ++r) {
    fetch_out(a, ring, r + kStages - 1, end,
              st == 0 ? kStages - 1 : st - 1, c, on);
    cp_async_wait<kStages - 1>();   // this thread's copies of row r landed
    if (t == 0) win[0] = win[1] = win[2] = zero;
    float g[kVec];
    float ss = 0.0f;
    if (on) {
      const uint4* s = ring + st * kOps * blockDim.x + threadIdx.x;
      const uint4 y_in = s[0], z_in = s[blockDim.x], x_in = s[2 * blockDim.x];
      const uint4 x = conv_silu(taps, win[0], win[1], win[2], x_in);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        g[j] = fmaf(d, elem(x, j), elem(y_in, j)) * silu(elem(z_in, j));
        ss = fmaf(g[j], g[j], ss);
      }
      win[0] = win[1];
      win[1] = win[2];
      win[2] = x_in;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
    if (lane == 0) red[p][warp] = ss;
    __syncthreads();
    float total = 0.0f;
    for (int i = 0; i < nwarps; ++i) total += red[p][i];
    p ^= 1;  // the other buffer: one barrier a row suffices
    const float rs = rsqrtf(total / (float)a.din + a.eps);
    if (on) {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(a.scale + c));
      const float4 s1 =
          __ldg(reinterpret_cast<const float4*>(a.scale + c + 4));
      float o[kVec];
      o[0] = g[0] * rs * s0.x;
      o[1] = g[1] * rs * s0.y;
      o[2] = g[2] * rs * s0.z;
      o[3] = g[3] * rs * s0.w;
      o[4] = g[4] * rs * s1.x;
      o[5] = g[5] * rs * s1.y;
      o[6] = g[6] * rs * s1.z;
      o[7] = g[7] * rs * s1.w;
      st16(a.out + r * a.din + c, pack(o));
    }
    st = st == kStages - 1 ? 0 : st + 1;
    if (++t == a.S) t = 0;
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ float32 instance
constexpr int kMaxDinF32 = 12288;  // out_kernel_f32's row in 48 KB of smem
constexpr int kF32Threads = 256;

struct InArgsF32 {
  const float* zx;       // (B, S, Z) zxbcdt
  const float* w;        // (din + 2 GN, kKW)
  const float* b;        // (din + 2 GN,)
  const float* dt_bias;  // (H,)
  const float* A;        // (H,), -exp(A_log)
  float* X;              // (B, S, H, P)
  float* Adt;            // (B, S, H)
  float* Bm;             // (B, S, G, N)
  float* Cm;
  int B, S, Z, din, H, P, GN;
};

// silu(b + sum_i w[i] * x[t - 3 + i]) of one channel at row r (position t
// in its batch row), the plain path's order: taps from 0, then the bias.
// col points at the channel in row 0 of zxbcdt, w at its kKW taps.
__device__ __forceinline__ float conv_silu_f32(const float* col,
                                               const float* w, float b,
                                               long long r, int t, int Z) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kKW; ++i) {
    const float v = t - (kKW - 1) + i >= 0
                        ? col[(r - (kKW - 1) + i) * Z] : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(v, w[i]));
  }
  const float c = __fadd_rn(acc, b);
  return c / (1.0f + expf(-c));
}

__global__ void __launch_bounds__(kF32Threads) in_kernel_f32(InArgsF32 a) {
  const int C = a.din + 2 * a.GN;
  const long long n = (long long)a.B * a.S * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / C;
    const int c = (int)(i - r * C);
    const int t = (int)(r % a.S);
    const float y = conv_silu_f32(a.zx + a.din + c, a.w + (long long)c * kKW,
                                  a.b[c], r, t, a.Z);
    if (c < a.din) {
      const int h = c / a.P;
      const float dt = softplus(a.zx[r * a.Z + 2 * a.din + 2 * a.GN + h]
                                + a.dt_bias[h]);
      a.X[r * a.din + c] = y * dt;
      if (c % a.P == 0) a.Adt[r * a.H + h] = dt * a.A[h];
    } else if (c < a.din + a.GN) {
      a.Bm[r * a.GN + (c - a.din)] = y;
    } else {
      a.Cm[r * a.GN + (c - a.din - a.GN)] = y;
    }
  }
}

struct OutArgsF32 {
  const float* zx;      // (B, S, Z) zxbcdt
  const float* Y;       // (B, S, H, P), the scan's output
  const float* w;       // (>= din, kKW): the x channels' taps first
  const float* b;
  const float* D;       // (H,)
  const float* scale;   // (din,) norm_scale
  float* out;           // (B, S, din)
  int B, S, Z, din, P;
  float eps;
};

__global__ void __launch_bounds__(kF32Threads) out_kernel_f32(OutArgsF32 a) {
  extern __shared__ float gbuf[];   // [din]: the row's gated values
  __shared__ float red[kF32Threads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long rows = (long long)a.B * a.S;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const int t = (int)(r % a.S);
    float ss = 0.0f;
    for (int c = threadIdx.x; c < a.din; c += blockDim.x) {
      const float x = conv_silu_f32(a.zx + a.din + c,
                                    a.w + (long long)c * kKW, a.b[c], r, t,
                                    a.Z);
      const float z = a.zx[r * a.Z + c];
      const float g = (a.Y[r * a.din + c] + a.D[c / a.P] * x)
                      * (z / (1.0f + expf(-z)));
      gbuf[c] = g;
      ss = fmaf(g, g, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float total = 0.0f;
    for (int i = 0; i < nwarps; ++i) total += red[i];
    const float rs = rsqrtf(total / (float)a.din + a.eps);
    for (int c = threadIdx.x; c < a.din; c += blockDim.x)
      a.out[r * a.din + c] = gbuf[c] * rs * a.scale[c];
    __syncthreads();  // red and gbuf are the next row's
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// One wave: the SMs times the blocks of `threads` an SM holds.
template <typename K>
inline long long wave(K kernel, int threads, size_t smem = 0) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
}

inline int launch_in(InArgs a, cudaStream_t stream) {
  const int nvec = (a.din + 2 * a.GN) / kVec;
  a.chunks = (nvec + kInThreads - 1) / kInThreads;
  const int per_chunk = (nvec + a.chunks - 1) / a.chunks;
  const int threads = (per_chunk + 31) / 32 * 32;
  const size_t smem = (sizeof(uint4) + sizeof(uint32_t)) * kInStages
                      * threads;
  const long long rows = (long long)a.B * a.S;
  long long parts = wave(in_kernel, threads, smem) / a.chunks;
  parts = parts < 1 ? 1 : (parts > rows ? rows : parts);
  in_kernel<<<(unsigned)(parts * a.chunks), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_out(const OutArgs& a, cudaStream_t stream) {
  const int threads = (a.din / kVec + 31) / 32 * 32;
  const size_t smem = sizeof(uint4) * kStages * kOps * threads;
  const int rc = hopper::set_smem(out_kernel, smem);
  if (rc) return rc;
  const long long rows = (long long)a.B * a.S;
  long long blocks = wave(out_kernel, threads, smem);
  blocks = blocks > rows ? rows : blocks;
  out_kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_in_f32(const InArgsF32& a, cudaStream_t stream) {
  const long long n = (long long)a.B * a.S * (a.din + 2 * a.GN);
  long long blocks = wave(in_kernel_f32, kF32Threads);
  const long long need = (n + kF32Threads - 1) / kF32Threads;
  blocks = blocks > need ? need : blocks;
  in_kernel_f32<<<(unsigned)blocks, kF32Threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

inline int launch_out_f32(const OutArgsF32& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * a.din;
  const long long rows = (long long)a.B * a.S;
  long long blocks = wave(out_kernel_f32, kF32Threads, smem);
  blocks = blocks > rows ? rows : blocks;
  out_kernel_f32<<<(unsigned)blocks, kF32Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace m2mix

extern "C" {

// Each returns cudaGetLastError() after its launch: nonzero means the launch
// was refused.  The wrapper (ops.py) checks dtypes, shapes, contiguity, a
// conv width of 4 and din = H * P; for bf16 also din, G * N, P and the row
// width Z multiples of 8, din at most 8 * 768, and 16-byte aligned
// pointers; for float32 din at most kMaxDinF32.
int ksp_mamba2_mix_in_bf16(const void* zx, const void* w, const void* b,
                           const void* dt_bias, const void* A, void* X,
                           void* Adt, void* Bm, void* Cm, int B, int S, int Z,
                           int din, int H, int P, int GN,
                           cudaStream_t stream) {
  hopper::enter();
  m2mix::InArgs a{static_cast<const m2mix::bf16*>(zx),
                  static_cast<const m2mix::bf16*>(w),
                  static_cast<const m2mix::bf16*>(b),
                  static_cast<const float*>(dt_bias),
                  static_cast<const float*>(A),
                  static_cast<m2mix::bf16*>(X),
                  static_cast<m2mix::bf16*>(Adt),
                  static_cast<m2mix::bf16*>(Bm),
                  static_cast<m2mix::bf16*>(Cm),
                  B, S, Z, din, H, P, GN, 1};
  return m2mix::launch_in(a, stream);
}

int ksp_mamba2_mix_out_bf16(const void* zx, const void* Y, const void* w,
                            const void* b, const void* D, const void* scale,
                            void* out, int B, int S, int Z, int din, int P,
                            float eps, cudaStream_t stream) {
  hopper::enter();
  m2mix::OutArgs a{static_cast<const m2mix::bf16*>(zx),
                   static_cast<const m2mix::bf16*>(Y),
                   static_cast<const m2mix::bf16*>(w),
                   static_cast<const m2mix::bf16*>(b),
                   static_cast<const m2mix::bf16*>(D),
                   static_cast<const float*>(scale),
                   static_cast<m2mix::bf16*>(out),
                   B, S, Z, din, P, eps};
  return m2mix::launch_out(a, stream);
}

int ksp_mamba2_mix_in_f32(const void* zx, const void* w, const void* b,
                          const void* dt_bias, const void* A, void* X,
                          void* Adt, void* Bm, void* Cm, int B, int S, int Z,
                          int din, int H, int P, int GN,
                          cudaStream_t stream) {
  hopper::enter();
  m2mix::InArgsF32 a{static_cast<const float*>(zx),
                     static_cast<const float*>(w),
                     static_cast<const float*>(b),
                     static_cast<const float*>(dt_bias),
                     static_cast<const float*>(A), static_cast<float*>(X),
                     static_cast<float*>(Adt), static_cast<float*>(Bm),
                     static_cast<float*>(Cm), B, S, Z, din, H, P, GN};
  return m2mix::launch_in_f32(a, stream);
}

int ksp_mamba2_mix_out_f32(const void* zx, const void* Y, const void* w,
                           const void* b, const void* D, const void* scale,
                           void* out, int B, int S, int Z, int din, int P,
                           float eps, cudaStream_t stream) {
  hopper::enter();
  m2mix::OutArgsF32 a{static_cast<const float*>(zx),
                      static_cast<const float*>(Y),
                      static_cast<const float*>(w),
                      static_cast<const float*>(b),
                      static_cast<const float*>(D),
                      static_cast<const float*>(scale),
                      static_cast<float*>(out), B, S, Z, din, P, eps};
  return m2mix::launch_out_f32(a, stream);
}

}  // extern "C"
