// Causal / windowed GQA attention forward (online softmax) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel.  In the model layout, q (B,Sq,H,hd) and k, v
// (B,Skv,K,hd), query head h reading KV head h / (H/K):
//   out[b,q,h] = softmax_k(mask(q,k) ? scale * q.k : -1e30) @ v
//   mask: k < Skv and q < Sq; k <= q when causal (aligned top-left, as the
//   TPU kernel); k > q - window when a window is given (window > 0).
//
// Bound: operations.  A causal prefill of S tokens does about 2*S*S*hd
// flops per head against 4*S*hd elements of q, k, v and out: S/4 flops per
// bf16 byte, 512 at the model's S = 2048, above the card's ridge of ~295
// (989 TFLOP/s bf16 over 3.35 TB/s).  So the products belong on the tensor
// cores.  Two instances, chosen by dtype in the wrapper:
//
// bf16 (the serving path; namespace fa3), shaped like FlashAttention-3's
// forward: one block per (b, h, 128-row query tile), walked heaviest causal
// tile first; two consumer warpgroups of 64 query rows and one producer
// warp.  The producer loads the Q tile once and streams K and V tiles of BK
// keys into a 2-stage shared-memory ring with TMA, each stage completing
// on a "full" mbarrier and released on an "empty" one.  S = Q K^T is wgmma
// m64n{BK}k16 (both operands K-major in shared memory, hd / 16 k-steps: 5
// at zamba2's hd = 80).  BK is 128 up to hd 80 and 64 above: the largest
// tile whose scores, P and output fit a thread's 168 registers without
// spilling (a 288-thread wgmma kernel gets no more; 96-key tiles at hd 80
// ran slower than 128 on the card).  At Zamba2-2.7B's hd = 160 the output
// holds 80 floats a thread, the scores of a 64-key tile 32 and its bf16 P
// 16 words: 128 of the 168.  The softmax runs in registers on the
// accumulator layout, in the log2 domain; a row's max and sum are taken
// over the quad of threads that holds it.  Only tiles that straddle the
// causal diagonal, the window's edge or the end of the keys are masked;
// tiles above the frontier (and wholly below the window) are never loaded.
// P is rounded to bf16 in registers and is the register A operand of
// O += P V (wgmma m64n{hd}k16, V the MN-major B operand from shared memory,
// transpose bit set).  O and the running max and sum stay in float32
// registers until the epilogue, which stores rows < Sq.  Inside each
// warpgroup tile i's q.k and tile i-1's p.v are issued together, back to
// back on the tensor cores, and tile i's softmax follows; the two
// warpgroups take turns to issue (FlashAttention-3's "pingpong", on two
// named barriers), so one's softmax runs under the other's products.  q is
// taken as it is and the scale is applied to the float32 scores (the
// Pallas kernel scales q in float32).
//
// hd = 80: a row is 160 bytes, more than the 128 bytes a 128-byte-swizzled
// TMA box may span (hd = 160: 320 bytes, three boxes, the third filled
// past column 160 with zeros; 96 KB of K / V ring and 48 KB of Q a block).  Each tile is loaded as 64-column boxes (the shared
// layout of hopper.cuh), the second of which TMA fills past column 80 with
// zeros: the q.k k-steps stop at hd, and the p.v accumulator is hd wide,
// reading the second box through the descriptor's leading offset.  Chosen
// over a 64 + 16 split (a 32-byte-swizzled second box) because V, as the
// MN-major B operand of one m64n80 wgmma, needs one layout across all 80
// columns; the cost is 48 zero columns of shared memory per tile row
// (128 KB a block at hd = 80, one block per SM).  The model layout puts a
// tile's rows H * hd apart, so each tensor is a 4-d map (hd, heads, S, B),
// which also zero-fills ragged tails of S.
//
// float32 (parity checks only: held to 2e-5, which TF32 could not hold):
// the CUDA-core body below, one block of 256 threads per (b, h, 64-row
// query tile), looping over 64-row KV tiles up to the causal frontier.  Q
// (scaled in float32, as kernel.py:55), the K and V tiles and the
// probability tile are staged in shared memory as float32; both products
// run on the CUDA cores in float32.  Shared-memory rows have an odd float
// stride (hd + 1) so the threads of a warp read distinct banks.
//
// Both instances keep the TPU kernel's finite -1e30 mask: a row whose first
// visited tile is fully masked gets exp(0) = 1 weights that the next tile's
// correction exp(-1e30 - m) = 0 wipes out, where -inf would give NaN.
//
// Built without --use_fast_math: the float32 path is held to 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxHd = 128;
constexpr int kHdCols = kMaxHd / 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBq + kBk) * (hd + 1) +
                          (size_t)kBk * hd + (size_t)kBq * (kBk + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int Sq, int Skv, int H, int K, int hd,
              int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldq = hd + 1;
  const int ldp = kBk + 1;
  float* Qs = smem;              // kBq x ldq
  float* Ks = Qs + kBq * ldq;    // kBk x ldq
  float* Vs = Ks + kBk * ldq;    // kBk x hd
  float* Ps = Vs + kBk * hd;     // kBq x ldp

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int i = tid; i < kBq * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = q0 + r;
    float val = 0.f;
    if (s < Sq) val = to_f32(q[(((size_t)b * Sq + s) * H + h) * hd + d]) * scale;
    Qs[r * ldq + d] = val;
  }

  float m[4], l[4], acc[4][kHdCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) acc[i][j] = 0.f;
  }

  // Visit KV tiles whose first key is at or below the block's last query.
  const int kv_end = causal ? min(Skv, q0 + kBq) : Skv;
  const int n_tiles = (kv_end + kBk - 1) / kBk;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done
    for (int i = tid; i < kBk * hd; i += kThreads) {
      const int r = i / hd, d = i % hd, s = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (s < Skv) {
        const size_t off = (((size_t)b * Skv + s) * K + kvh) * hd + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r * ldq + d] = kk;
      Vs[r * hd + d] = vv;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

    // mask, then the online-softmax update of each row; a row's 64 keys
    // live on the 16 lanes of one half-warp, reduced with xor shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Skv && qp < Sq;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        if (!ok) sc[i][j] = kNegInf;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kHdCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's keys
    for (int c = 0; c < kBk; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kHdCols; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + s] = m[i] + logf(denom);
    T* row = out + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(row + d, acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int K, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBq - 1) / kBq, H, B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, K,
      hd, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------------ bf16
namespace fa3 {

using namespace hopper;

constexpr int kBq = 128;                    // query rows per block
constexpr int kStages = 2;                  // K / V ring
constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kQRegion = kBq * kRowBytes;   // 64 columns x 128 rows: 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Keys per K / V tile for a head dim rounded to HD: the largest tile whose
// scores (BK / 2 floats a thread), bf16 P (BK / 4 words) and output
// (HD / 2 floats) fit the 168 registers a thread of this 288-thread wgmma
// kernel gets without spilling: 128 up to hd 80, then 64 (hd 160 included:
// its products are wgmma m64n64 for q.k and m64n160 for p.v).
__host__ __device__ constexpr int keys_per_tile(int HD) {
  return HD <= 80 ? 128 : 64;
}

size_t smem_bytes(int regions, int BK) {
  // 1024 bytes of alignment slack, Q, the K and V rings, the barriers
  return 1024 +
         (size_t)regions * (kQRegion + 2 * kStages * BK * kRowBytes) + 64;
}

// S = Q K^T into sc: both operands K-major, one k-step per 16 columns of
// hd.  Issued and committed, not waited for.
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t qa,
                                         uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<BK, 0, 0>(
        sc, desc_sw128(qa + (kk / 4) * kQRegion + col, 16, 1024),
        desc_sw128(ka + (kk / 4) * BK * kRowBytes + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: P from registers, V the MN-major B operand.  Issued and
// committed, not waited for.
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<HD, 1>(
        o, pa[kk],
        desc_sw128(va + kk * 16 * kRowBytes, BK * kRowBytes, 1024), 1);
  wgmma_commit();
}

// The running max (log2 domain) and partial sum of a thread's two rows,
// and the correction the output has yet to take for the last tile.
struct Rows {
  float m0, m1, l0, l1, c0, c1;
};

// The keys a thread's two rows may see, [lo, hi), and the range every row
// of its warpgroup sees: a tile inside [all_lo, all_hi) needs no mask.
struct Keys {
  int lo0, hi0, lo1, hi1, all_lo, all_hi;
};

__device__ __forceinline__ int keys_lo(int q, int window) {
  return window > 0 ? max(0, q - window + 1) : 0;
}

__device__ __forceinline__ int keys_hi(int q, int Skv, int causal) {
  return causal ? min(Skv, q + 1) : Skv;
}

// Online softmax of the tile of keys k0 .. k0 + BK - 1 in sc: p replaces
// the scores and r is updated.  Only a tile that straddles the causal
// diagonal, the window's edge or the end of the keys is masked; a row
// lives on the quad of threads lane / 4.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], Rows& r,
                                             int k0, const Keys& ks, int t4,
                                             float scale_log2) {
  if (k0 < ks.all_lo || k0 + BK > ks.all_hi) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool ok = e < 2 ? kp >= ks.lo0 && kp < ks.hi0
                              : kp >= ks.lo1 && kp < ks.hi1;
        if (!ok) sc[4 * j + e] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
  }
  // the max of the raw scores, scaled (scale > 0 commutes with max)
  const float mn0 = fmaxf(r.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(r.m1, mx1 * scale_log2);
  r.c0 = exp2_ftz(r.m0 - mn0);
  r.c1 = exp2_ftz(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = exp2_ftz(fmaf(sc[4 * j], scale_log2, -mn0));
    sc[4 * j + 1] = exp2_ftz(fmaf(sc[4 * j + 1], scale_log2, -mn0));
    sc[4 * j + 2] = exp2_ftz(fmaf(sc[4 * j + 2], scale_log2, -mn1));
    sc[4 * j + 3] = exp2_ftz(fmaf(sc[4 * j + 3], scale_log2, -mn1));
    s0 += sc[4 * j] + sc[4 * j + 1];
    s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l0 = r.l0 * r.c0 + s0;  // per-thread partial sums, reduced at the end
  r.l1 = r.l1 * r.c1 + s1;
}

// HD: the head dim rounded up to 16 (the width of the output accumulator
// and the number of k-steps of q.k times 16); BK: keys per K / V tile.
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int Sq, int Skv, int H, int K, int hd, int causal,
                   int window, float scale_log2) {
  constexpr int kReg = (HD + kRegionCols - 1) / kRegionCols;
  constexpr int kQTile = kReg * kQRegion;
  constexpr int kKvRegion = BK * kRowBytes;
  constexpr int kTile = kReg * kKvRegion;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint8_t* q_s = smem;                    // kReg regions
  uint8_t* k_s = q_s + kQTile;             // kStages tiles
  uint8_t* v_s = k_s + kStages * kTile;   // kStages tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;

  // K / V tiles [t_begin, t_end): up to the causal frontier, from the
  // window's lower edge for the block's first row; at least one.
  const int kv_end = causal ? min(Skv, q0 + kBq) : Skv;
  const int t_end = (kv_end + BK - 1) / BK;
  int t_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  t_begin = min(t_begin, t_end - 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, kQTile);
      for (int r = 0; r < kReg; ++r)
        tma_load_4d(q_s + r * kQRegion, &tq, bar_q, r * kRegionCols, h, q0,
                    b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int r = 0; r < kReg; ++r) {
          tma_load_4d(k_s + s * kTile + r * kKvRegion, &tk, &full[s],
                      r * kRegionCols, kvh, t * BK, b);
          tma_load_4d(v_s + s * kTile + r * kKvRegion, &tv, &full[s],
                      r * kRegionCols, kvh, t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this
  // thread holds rows row0 and row0 + 8 of the accumulators
  const int wg = tid / 128;
  const int w = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t4 = lane % 4;
  const int qmin = q0 + wg * 64;
  const int row0 = qmin + w * 16 + lane / 4;
  const uint32_t qa = smem_u32(q_s) + wg * 64 * kRowBytes;
  const Keys ks{keys_lo(row0, window),     keys_hi(row0, Skv, causal),
                keys_lo(row0 + 8, window), keys_hi(row0 + 8, Skv, causal),
                keys_lo(qmin + 63, window), keys_hi(qmin, Skv, causal)};

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  Rows r{kNegInf, kNegInf, 0.f, 0.f, 0.f, 0.f};
  float sc[BK / 2];         // the scores of the newest tile
  uint32_t pa[BK / 16][4];  // P of the tile before it, bf16

  // Tile i's q.k and tile i-1's p.v are issued together and run back to
  // back on the tensor cores; tile i's softmax follows.  Letting the
  // softmax overlap this warpgroup's own p.v as well kept P and the scores
  // live at once, spilled at hd = 80 and ran slower on the card.
  //
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2, 256 threads each: one warpgroup waits, the other arrives), so
  // that one's softmax runs while the other's products occupy the tensor
  // cores.  Warpgroup 1 lets warpgroup 0 go first and skips its last
  // hand-over, which keeps both barriers' counts balanced.
  const int turns = t_end - t_begin + 1;  // q.k of the first tile, ...,
  int turn = 0;                           // ..., p.v of the last
  auto wait_turn = [&] { named_sync(1 + wg, kConsumers); };
  auto pass_turn = [&] {
    if (wg == 0 || ++turn < turns) named_arrive(2 - wg, kConsumers);
  };
  if (wg == 1) named_arrive(1, kConsumers);

  mbar_wait(bar_q, 0);
  mbar_wait(&full[0], 0);
  wait_turn();
  wgmma_fence();
  issue_qk<HD, BK>(sc, qa, smem_u32(k_s));
  pass_turn();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<BK>(sc, r, t_begin * BK, ks, t4, scale_log2);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) a_frag(sc, kk, pa[kk]);
  for (int t = t_begin + 1, i = 1; t < t_end; ++t, ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    fence_regs(o);
    wait_turn();
    wgmma_fence();
    issue_qk<HD, BK>(sc, qa, smem_u32(k_s + s * kTile));  // S_i
    issue_pv<HD, BK>(o, pa, smem_u32(v_s + sp * kTile));  // P_{i-1} V_{i-1}
    pass_turn();
    wgmma_wait<0>();  // both are in: stage i-1 is free
    fence_regs(sc);
    fence_regs(o);
    mbar_arrive(&empty[sp]);
    softmax_tile<BK>(sc, r, t * BK, ks, t4, scale_log2);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= r.c0;
      o[4 * j + 1] *= r.c0;
      o[4 * j + 2] *= r.c1;
      o[4 * j + 3] *= r.c1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_frag(sc, kk, pa[kk]);
  }
  const int last = (t_end - 1 - t_begin) % kStages;
  fence_regs(o);
  wait_turn();
  wgmma_fence();
  issue_pv<HD, BK>(o, pa, smem_u32(v_s + last * kTile));
  pass_turn();
  wgmma_wait<0>();
  fence_regs(o);
  mbar_arrive(&empty[last]);
  float l0 = r.l0, l1 = r.l1;

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  if (lse != nullptr && t4 == 0) {
    // the natural log-sum-exp of the scaled scores: m is in the log2 domain
    const float m[2] = {r.m0, r.m1}, l[2] = {l0, l1};
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < Sq)
        lse[((size_t)b * H + h) * Sq + row0 + 8 * i] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* row = out + (((size_t)b * Sq + qp) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Skv, int H, int K, int hd,
              int causal, int window, float scale, cudaStream_t stream) {
  // 4-d maps (hd, heads, S, B): a tile's rows are heads * hd apart in the
  // model layout, and TMA zero-fills the tails of hd and S
  constexpr int BK = keys_per_tile(HD);
  const cuuint32_t qbox[4] = {kRegionCols, 1, kBq, 1};
  const cuuint32_t kbox[4] = {kRegionCols, 1, BK, 1};
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t qdims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)Sq,
                               (cuuint64_t)B};
  const cuuint64_t qstr[3] = {hd * e, H * hd * e, (cuuint64_t)Sq * H * hd * e};
  const cuuint64_t kdims[4] = {(cuuint64_t)hd, (cuuint64_t)K,
                               (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {hd * e, K * hd * e,
                              (cuuint64_t)Skv * K * hd * e};
  CUtensorMap tq, tk, tv;
  int err = encode_bf16_map(&tq, q, 4, qdims, qstr, qbox);
  if (!err) err = encode_bf16_map(&tk, k, 4, kdims, kstr, kbox);
  if (!err) err = encode_bf16_map(&tv, v, 4, kdims, kstr, kbox);
  if (err) return err;
  const size_t smem =
      smem_bytes((HD + kRegionCols - 1) / kRegionCols, BK);
  err = set_smem(flash_fwd_bf16<HD, BK>, smem);
  if (err) return err;
  dim3 grid((Sq + kBq - 1) / kBq, H, B);
  flash_fwd_bf16<HD, BK><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, K, hd,
      causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int K, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
#define KSP_HD(n)                                                         \
  case n:                                                                 \
    return launch_hd<n>(q, k, v, out, lse, B, Sq, Skv, H, K, hd, causal,  \
                        window, scale, stream);
  switch (round_up(hd, 16)) {
    KSP_HD(16) KSP_HD(32) KSP_HD(48) KSP_HD(64)
    KSP_HD(80) KSP_HD(96) KSP_HD(112) KSP_HD(128) KSP_HD(160)
  }
#undef KSP_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace fa3

// --------------------------------------------------------------- backward
//
// The backward of both instances (no Pallas counterpart: the reference
// trains through the XLA form models/attention.py::chunked_gqa_attention
// and JAX's autodiff).  From the saved q, k, v, the output o, its gradient
// dO and the forward's row log-sum-exp lse (B, H, Sq) float32, with
// P = exp(scale q.k - lse) (zero where masked):
//   D  = rowsum(dO o O)
//   dS = P o (dO V^T - D), zero where masked
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K
// A row that sees no key (a window past the end of the keys: q >=
// Skv + window - 1) averages V with weights 1 / Skv in the plain version,
// which an lse of -1e30 cannot express; its P is set to 1 / Skv directly,
// and its dS is zero like every masked entry.  Every sum is taken by one
// block in a fixed order: no atomics, so the gradients do not depend on
// scheduling (resumed training runs repeat their losses bitwise).
//
// Bound: operations, as the forward (five products of the forward's size
// against its two).  Two instances, chosen by dtype in the wrapper:
//
// bf16 (training; namespace fbwd3), every product on the tensor cores in
// two kernels shaped like the forward, after a row pass (flash_bwd_rows:
// lse log2(e) and D per query row, zero-padded to 128 rows):
//   * flash_bwd_dq_bf16, one block per (b, h, 128 query rows), heaviest
//     causal tile first: two consumer warpgroups of 64 rows and a producer
//     warp; Q and dO are loaded once, K and V tiles of 64 keys stream
//     through a 2-stage TMA ring.  Per tile S = Q K^T and dP = dO V^T
//     (wgmma, K-major operands), P = exp2(S scale log2(e) - lse log2(e))
//     on the accumulator layout (lse is known: no online softmax),
//     dS = P o (dP - D) rounded to bf16 in registers, and dQ += dS K with
//     K the MN-major B operand; tile i's S and dP are issued together
//     with tile i-1's dS K (up to hd 80; one tile at a time above, where
//     both would not fit the registers).  dQ is scaled in the epilogue.
//   * flash_bwd_dkdv_bf16, one block per (b, KV head, 64 keys): one
//     consumer warpgroup whose K and V tiles stay in shared memory, and a
//     producer warp that streams Q and dO tiles of 64 rows (and their lse
//     and D slices, by bulk copy) for each of the G query heads of the KV
//     head, from the keys' diagonal down to the window's end, then the
//     key-less tail rows.  Per tile S^T = K Q^T and dP^T = V dO^T, P^T and
//     dS^T in registers with lse and D per column from shared memory, then
//     dV += bf16(P^T) dO and dK += bf16(dS^T) Q (dO and Q MN-major).  The
//     accumulators of dK and dV (2 x hd / 2 floats a thread) and the two
//     score tiles take ~200 registers: a 160-thread block gets them, and
//     two blocks share an SM.  (Two consumer warpgroups of 64 keys sharing
//     one Q / dO stream, with setmaxnreg handing the producer's registers
//     over, were tried: ptxas held the consumers to the 168 registers a
//     384-thread block starts with, spilled, and ran slower on the card;
//     issuing tile i's S^T with tile i-1's products needs more registers
//     than two blocks an SM leave, and ran slower too; so did waiting for
//     S^T and dP^T apart, to take P^T's exponentials under dP^T, in both
//     kernels.)
// The split costs seven products where FlashAttention-3's one kernel with
// a float32 atomicAdd into dQ costs five; the atomics would make dQ depend
// on scheduling.  P is rounded to bf16 before P^T dO, as the forward rounds
// it before P V (models/attention.py:82); dS is rounded to bf16 as the
// operand of dQ and dK (the CPU rehearsal in
// tests/test_torch_bwd_rehearsal.py holds both roundings within 2e-2).
// Only tiles that straddle the causal diagonal, the window's edge, a ragged
// end or the key-less rows are masked.  hd = 80 takes the forward's layout: 64-column boxes, the second
// zero-filled past column 80 by TMA, nothing padded in memory.
//
// float32 (parity checks; namespace fbwd): the CUDA-core body, one block of
// 256 threads per 64-key tile (dK, dV) or 64-row query tile (dQ), tiles
// staged in shared memory as float32 with odd row strides, each thread
// owning a 4 x 4 block of the score tile and 4 rows x hd/16 columns of its
// accumulators, as the float32 forward; q.k and dO.v are computed in both
// passes.  The dK/dV block walks the G query heads of its KV head and the
// query tiles that can see its keys (and the key-less tail rows).
namespace fbwd {

constexpr int kB = 64;         // query rows per q tile, keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kHdCols = kMaxHd / 16;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

struct Mask {
  int Sq, Skv, causal, window, dead;  // rows >= dead see no key
  __device__ __forceinline__ bool ok(int qp, int kp) const {
    bool r = qp < Sq && kp < Skv;
    if (causal) r = r && kp <= qp;
    if (window > 0) r = r && kp > qp - window;
    return r;
  }
};

// rows [r0, r0 + 64) of a (B, S, heads, hd) tensor at (b, head) into a
// 64 x ld float32 tile, times mul; rows past S read as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src, int b,
                                          int r0, int S, int heads, int head,
                                          int hd, float mul) {
  for (int i = threadIdx.x; i < kB * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = r0 + r;
    dst[r * ld + d] =
        s < S ? f32(src[(((size_t)b * S + s) * heads + head) * hd + d]) * mul
              : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two 64 x ld tiles
__device__ __forceinline__ void tile_dots(float (&acc)[4][4],
                                          const float* A, const float* Bt,
                                          int ld, int hd, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// D[b, h, q] = sum_d dO o O: one warp per (b, q, h) row
template <typename T>
__global__ void flash_bwd_dot(const T* __restrict__ o,
                              const T* __restrict__ dout,
                              float* __restrict__ D, int rows, int Sq, int H,
                              int hd) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32)
    s = fmaf(f32(o[(size_t)row * hd + d]), f32(dout[(size_t)row * hd + d]),
             s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H, q = (row / H) % Sq, b = row / (H * Sq);
    D[((size_t)b * H + h) * Sq + q] = s;
  }
}

size_t dkdv_smem(int hd) {
  return sizeof(float) * (4 * (size_t)kB * (hd + 1) +
                          2 * (size_t)kB * (kB + 1) + 2 * kB);
}

// dK and dV of keys [k0, k0 + 64) of KV head kvh: grid (key tiles, K, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ D, T* __restrict__ dk,
                   T* __restrict__ dv, Mask mk, int H, int K, int hd,
                   float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1, ldp = kB + 1;
  float* Ks = smem;             // kB x ld
  float* Vs = Ks + kB * ld;     // kB x ld
  float* Qs = Vs + kB * ld;     // kB x ld, scaled
  float* dOs = Qs + kB * ld;    // kB x ld
  float* Ps = dOs + kB * ld;    // kB x ldp  P[q][key]
  float* dSs = Ps + kB * ldp;   // kB x ldp  dS[q][key]
  float* lse_s = dSs + kB * ldp;
  float* D_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float inv_skv = 1.f / mk.Skv;

  load_tile(Ks, ld, k, b, k0, mk.Skv, K, kvh, hd, 1.f);
  load_tile(Vs, ld, v, b, k0, mk.Skv, K, kvh, hd, 1.f);
  float adk[4][kHdCols], adv[4][kHdCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) adk[i][j] = adv[i][j] = 0.f;

  // query rows that see these keys: [lo, hi), and the key-less tail
  const int lo = mk.causal ? k0 : 0;
  const int hi = mk.window > 0 ? min(mk.Sq, k0 + kB - 1 + mk.window) : mk.Sq;
  const int n_qt = (mk.Sq + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t rowbase = ((size_t)b * H + h) * mk.Sq;
    for (int t = lo / kB; t < n_qt; ++t) {
      const int q0 = t * kB;
      if (q0 >= hi && q0 + kB <= mk.dead) continue;
      __syncthreads();  // the previous tile's reads are done
      load_tile(Qs, ld, q, b, q0, mk.Sq, H, h, hd, scale);
      load_tile(dOs, ld, dout, b, q0, mk.Sq, H, h, hd, 1.f);
      if (tid < kB) {
        const bool in = q0 + tid < mk.Sq;
        lse_s[tid] = in ? lse[rowbase + q0 + tid] : 0.f;
        D_s[tid] = in ? D[rowbase + q0 + tid] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      tile_dots(sc, Qs, Ks, ld, hd, tx, ty);   // rows q, columns keys
      tile_dots(dp, dOs, Vs, ld, hd, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, kp = k0 + c;
          const bool ok = mk.ok(qp, kp);
          const bool dead = qp < mk.Sq && kp < mk.Skv && qp >= mk.dead;
          const float p = dead ? inv_skv : ok ? expf(sc[i][j] - lse_s[r])
                                              : 0.f;
          Ps[r * ldp + c] = p;
          dSs[r * ldp + c] = ok ? p * (dp[i][j] - D_s[r]) : 0.f;
        }
      }
      __syncthreads();
      // dV[key][d] += P[q][key] dO[q][d]; dK[key][d] += dS[q][key] Q[q][d]
      for (int c = 0; c < kB; ++c) {
        float pa[4], sa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[c * ldp + ty + 16 * i];
          sa[i] = dSs[c * ldp + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kHdCols; ++j) {
          const int d = tx + 16 * j;
          if (d < hd) {
            const float o_ = dOs[c * ld + d], q_ = Qs[c * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              adv[i][j] = fmaf(pa[i], o_, adv[i][j]);
              adk[i][j] = fmaf(sa[i], q_, adk[i][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= mk.Skv) continue;
    const size_t off = (((size_t)b * mk.Skv + s) * K + kvh) * hd;
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        put(dk + off + d, adk[i][j]);  // Qs holds scale q: dK = dS^T (scale q)
        put(dv + off + d, adv[i][j]);
      }
    }
  }
}

size_t dq_smem(int hd) {
  return sizeof(float) * (4 * (size_t)kB * (hd + 1) +
                          (size_t)kB * (kB + 1) + 2 * kB);
}

// dQ of rows [q0, q0 + 64) of head h: grid (query tiles, H, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 T* __restrict__ dq, Mask mk, int H, int K, int hd,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1, ldp = kB + 1;
  float* Qs = smem;             // kB x ld, scaled
  float* dOs = Qs + kB * ld;    // kB x ld
  float* Ks = dOs + kB * ld;    // kB x ld
  float* Vs = Ks + kB * ld;     // kB x ld
  float* dSs = Vs + kB * ld;    // kB x ldp  dS[q][key]
  float* lse_s = dSs + kB * ldp;
  float* D_s = lse_s + kB;

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t rowbase = ((size_t)b * H + h) * mk.Sq;

  load_tile(Qs, ld, q, b, q0, mk.Sq, H, h, hd, scale);
  load_tile(dOs, ld, dout, b, q0, mk.Sq, H, h, hd, 1.f);
  if (tid < kB) {
    const bool in = q0 + tid < mk.Sq;
    lse_s[tid] = in ? lse[rowbase + q0 + tid] : 0.f;
    D_s[tid] = in ? D[rowbase + q0 + tid] : 0.f;
  }
  float adq[4][kHdCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) adq[i][j] = 0.f;

  // KV tiles the block's rows can see
  const int kv_end = mk.causal ? min(mk.Skv, q0 + kB) : mk.Skv;
  const int t_end = (kv_end + kB - 1) / kB;
  const int t_begin =
      mk.window > 0 ? min(max(0, q0 - mk.window + 1) / kB, t_end) : 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's reads are done
    load_tile(Ks, ld, k, b, k0, mk.Skv, K, kvh, hd, 1.f);
    load_tile(Vs, ld, v, b, k0, mk.Skv, K, kvh, hd, 1.f);
    __syncthreads();
    float sc[4][4], dp[4][4];
    tile_dots(sc, Qs, Ks, ld, hd, tx, ty);
    tile_dots(dp, dOs, Vs, ld, hd, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = mk.ok(qp, k0 + c);
        dSs[r * ldp + c] =
            ok ? expf(sc[i][j] - lse_s[r]) * (dp[i][j] - D_s[r]) : 0.f;
      }
    }
    __syncthreads();
    // dQ[q][d] += dS[q][key] K[key][d]
    for (int c = 0; c < kB; ++c) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = dSs[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < kHdCols; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float k_ = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) adq[i][j] = fmaf(sa[i], k_, adq[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= mk.Sq) continue;
    T* row = dq + (((size_t)b * mk.Sq + s) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) put(row + d, adq[i][j] * scale);
    }
  }
}

// Three launches on `stream`; D (B, H, Sq) float32 is the wrapper's scratch.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int H, int K, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tdo = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_dot<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), tdo, D, rows, Sq, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Mask mk{Sq, Skv, causal, window,
                window > 0 ? Skv + window - 1 : 0x7fffffff};
  size_t smem = dkdv_smem(hd);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<T><<<dim3((Skv + kB - 1) / kB, K, B), kThreads, smem,
                      stream>>>(tq, tk, tv, tdo, lse, D,
                                static_cast<T*>(dk), static_cast<T*>(dv), mk,
                                H, K, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = dq_smem(hd);
  err = cudaFuncSetAttribute(flash_bwd_dq<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T><<<dim3((Sq + kB - 1) / kB, H, B), kThreads, smem,
                    stream>>>(tq, tk, tv, tdo, lse, D, static_cast<T*>(dq),
                              mk, H, K, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace fbwd

// ----------------------------------------------------------- bf16 backward
namespace fbwd3 {

using namespace hopper;
using fa3::kBq;
using fa3::kLog2e;
using fa3::kQRegion;
using fbwd::Mask;

constexpr int kBt = 64;                    // keys (dQ) / query rows (dK, dV)
constexpr int kTRegion = kBt * kRowBytes;  // 64 columns x 64 rows: 8 KB
constexpr int kStages = 2;
constexpr int kDkdvConsumers = 128;       // the dK/dV kernel: one warpgroup
constexpr int kDkdvThreads = kDkdvConsumers + 32;  // and a producer warp

// rows (B, H, 2, Sqp) float32, Sqp = Sq rounded up to 128: lse log2(e) and
// D = rowsum(dO o O) of each query row, zero past Sq.  One warp a row.
__global__ void flash_bwd_rows(const __nv_bfloat16* __restrict__ o,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ rows, int Sq, int Sqp,
                               int H, int hd, int total) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= total) return;
  const int q = r % Sqp, bh = r / Sqp, h = bh % H, b = bh / H;
  float d = 0.f, l = 0.f;
  if (q < Sq) {
    const size_t off = (((size_t)b * Sq + q) * H + h) * hd;
    for (int c = lane; c < hd; c += 32)
      d = fmaf(__bfloat162float(o[off + c]), __bfloat162float(dout[off + c]),
               d);
    l = lse[(size_t)bh * Sq + q] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) {
    rows[(size_t)bh * 2 * Sqp + q] = l;
    rows[(size_t)bh * 2 * Sqp + Sqp + q] = d;
  }
}

// Every (query, key) pair of the 64 x 64 tile [q0, q0 + 64) x [k0, k0 + 64)
// is visible: the tile needs no mask.
__device__ __forceinline__ bool full_tile(const Mask& mk, int q0, int k0) {
  return q0 + kBt <= mk.Sq && k0 + kBt <= mk.Skv &&
         (!mk.causal || k0 + kBt - 1 <= q0) &&
         (mk.window <= 0 || k0 > q0 + kBt - 1 - mk.window);
}

// acc (64 x 64) = A B^T over HD columns: A rows `a` of a tile whose regions
// are `ra` bytes apart, B rows `b` of regions `rb` apart, both K-major.
template <int HD>
__device__ __forceinline__ void issue_nt(float (&acc)[kBt / 2], uint32_t a,
                                         int ra, uint32_t b, int rb) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<kBt, 0, 0>(acc, desc_sw128(a + (kk / 4) * ra + col, 16, 1024),
                        desc_sw128(b + (kk / 4) * rb + col, 16, 1024),
                        kk > 0);
  }
}

// acc (64 x HD) += A B over 64 rows of B: A in registers (bf16, 4 k-steps),
// B the MN-major tile at `b` of 64 rows (regions kTRegion apart).
template <int HD>
__device__ __forceinline__ void issue_nn(float (&acc)[HD / 2],
                                         const uint32_t (&a)[kBt / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBt / 16; ++kk)
    wgmma_rs<HD, 1>(acc, a[kk],
                    desc_sw128(b + kk * 16 * kRowBytes, kTRegion, 1024), 1);
}

// A 64 x hd accumulator (scaled) as bf16 rows of a (B, S, heads, hd)
// tensor: rows r0 and r0 + 8 of the thread, at or past `S` not stored.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2],
                                           float mul,
                                           __nv_bfloat16* __restrict__ dst,
                                           int b, int r0, int S, int heads,
                                           int head, int hd, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = r0 + 8 * r;
    if (s >= S) continue;
    __nv_bfloat16* row = dst + (((size_t)b * S + s) * heads + head) * hd;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(
            acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// dS = P o (dP - D) of the 64-key tile at k0 from its scores sc and dP,
// zero where masked, into the bf16 A operand fa (the dQ kernel's rows
// row0 and row0 + 8 of a warpgroup whose first row is qmin; l2, dd: their
// lse log2(e) and D).
__device__ __forceinline__ void grad_tile(float (&sc)[kBt / 2],
                                          const float (&dp)[kBt / 2],
                                          uint32_t (&fa)[kBt / 16][4],
                                          const Mask& mk, int k0, int qmin,
                                          int row0, int t4,
                                          const float (&l2)[2],
                                          const float (&dd)[2],
                                          float scale_log2) {
  const bool full = full_tile(mk, qmin, k0);
#pragma unroll
  for (int j = 0; j < kBt / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -l2[r]));
      const float g = p * (dp[4 * j + e] - dd[r]);
      sc[4 * j + e] =
          full || mk.ok(row0 + 8 * r, k0 + 8 * j + 2 * t4 + (e & 1)) ? g
                                                                     : 0.f;
    }
#pragma unroll
  for (int kk = 0; kk < kBt / 16; ++kk) a_frag(sc, kk, fa[kk]);
}

size_t dq_smem(int regions) {
  return 1024 + (size_t)regions * (2 * kQRegion + 2 * kStages * kTRegion) +
         64;
}

// dQ of rows [q0, q0 + 128) of head h: grid (query tiles, H, B), heaviest
// causal tile first.  HD: hd rounded up to 16.
template <int HD>
__global__ void __launch_bounds__(fa3::kThreads, 1)
    flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ rows,
                      __nv_bfloat16* __restrict__ dq, Mask mk, int Sqp,
                      int H, int K, int hd, float scale, float scale_log2) {
  constexpr int kReg = (HD + kRegionCols - 1) / kRegionCols;
  constexpr int kQTile = kReg * kQRegion;
  constexpr int kTile = kReg * kTRegion;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + kQTile;
  uint8_t* k_s = do_s + kQTile;          // kStages tiles
  uint8_t* v_s = k_s + kStages * kTile;  // kStages tiles
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(v_s + kStages * kTile);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;

  // key tiles [t_begin, t_end): the forward's, in tiles of 64 keys
  const int kv_end = mk.causal ? min(mk.Skv, q0 + kBq) : mk.Skv;
  const int t_end = (kv_end + kBt - 1) / kBt;
  int t_begin = mk.window > 0 ? max(0, q0 - mk.window + 1) / kBt : 0;
  t_begin = min(t_begin, t_end - 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], fa3::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= fa3::kConsumers) {  // producer warp: one thread issues loads
    if (tid == fa3::kConsumers) {
      mbar_expect_tx(bar_q, 2 * kQTile);
      for (int r = 0; r < kReg; ++r) {
        tma_load_4d(q_s + r * kQRegion, &tq, bar_q, r * kRegionCols, h, q0,
                    b);
        tma_load_4d(do_s + r * kQRegion, &tdo, bar_q, r * kRegionCols, h, q0,
                    b);
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int r = 0; r < kReg; ++r) {
          tma_load_4d(k_s + s * kTile + r * kTRegion, &tk, &full[s],
                      r * kRegionCols, kvh, t * kBt, b);
          tma_load_4d(v_s + s * kTile + r * kTRegion, &tv, &full[s],
                      r * kRegionCols, kvh, t * kBt, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread
  // holds rows row0 and row0 + 8 of the accumulators
  const int wg = tid / 128;
  const int w = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t4 = lane % 4;
  const int qmin = q0 + wg * 64;
  const int row0 = qmin + w * 16 + lane / 4;
  const uint32_t qa = smem_u32(q_s) + wg * 64 * kRowBytes;
  const uint32_t da = smem_u32(do_s) + wg * 64 * kRowBytes;
  const float* rw = rows + ((size_t)b * H + h) * 2 * Sqp;
  const float l2[2] = {rw[row0], rw[row0 + 8]};  // rows < Sqp
  const float dd[2] = {rw[Sqp + row0], rw[Sqp + row0 + 8]};

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[kBt / 2], dp[kBt / 2];  // S and dP of the newest tile
  uint32_t fa[kBt / 16][4];        // dS (of the tile before it), bf16

  mbar_wait(bar_q, 0);
  if constexpr (HD > 80) {
    // one tile at a time: S, dP, dS and the tile before's dS at once
    // would not fit the 168 registers at these widths
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      wgmma_fence();
      issue_nt<HD>(sc, qa, kQRegion, smem_u32(k_s + s * kTile), kTRegion);
      issue_nt<HD>(dp, da, kQRegion, smem_u32(v_s + s * kTile), kTRegion);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      grad_tile(sc, dp, fa, mk, t * kBt, qmin, row0, t4, l2, dd,
                scale_log2);
      fence_regs(acc);
      wgmma_fence();
      issue_nn<HD>(acc, fa, smem_u32(k_s + s * kTile));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }
  } else {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_nt<HD>(sc, qa, kQRegion, smem_u32(k_s), kTRegion);
    issue_nt<HD>(dp, da, kQRegion, smem_u32(v_s), kTRegion);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grad_tile(sc, dp, fa, mk, t_begin * kBt, qmin, row0, t4, l2, dd,
              scale_log2);
    for (int t = t_begin + 1, i = 1; t < t_end; ++t, ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue_nt<HD>(sc, qa, kQRegion, smem_u32(k_s + s * kTile), kTRegion);
      issue_nt<HD>(dp, da, kQRegion, smem_u32(v_s + s * kTile), kTRegion);
      issue_nn<HD>(acc, fa, smem_u32(k_s + sp * kTile));  // dS_i-1 K_i-1
      wgmma_commit();
      wgmma_wait<0>();  // all three are in: stage i-1 is free
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      mbar_arrive(&empty[sp]);
      grad_tile(sc, dp, fa, mk, t * kBt, qmin, row0, t4, l2, dd,
                scale_log2);
    }
    const int last = (t_end - 1 - t_begin) % kStages;
    fence_regs(acc);
    wgmma_fence();
    issue_nn<HD>(acc, fa, smem_u32(k_s + last * kTile));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[last]);
  }
  store_rows<HD>(acc, scale, dq, b, row0, mk.Sq, H, h, hd, t4);
}

size_t dkdv_smem(int regions) {
  return 1024 + (size_t)regions * (2 + 2 * kStages) * kTRegion +
         kStages * 2 * kBt * sizeof(float) + 64;
}

// The query tiles the dK/dV block of keys [k0, k0 + 64) visits, in order:
// for each of the G query heads of its KV head, the 64-row tiles from the
// keys' diagonal (causal) down to the window's end, and those holding rows
// that see no key.  next() steps to the next one (false past the last);
// g and q0 name the current one.
struct QWalk {
  int G, t0, n_qt, hi, dead, g, t;
  __device__ __forceinline__ QWalk(const Mask& mk, int k0, int G_)
      : G(G_),
        t0((mk.causal ? k0 : 0) / kBt),
        n_qt((mk.Sq + kBt - 1) / kBt),
        hi(mk.window > 0 ? min(mk.Sq, k0 + kBt - 1 + mk.window) : mk.Sq),
        dead(mk.dead),
        g(0),
        t(t0 - 1) {}
  __device__ __forceinline__ bool next() {
    for (;;) {
      if (++t >= n_qt) {
        t = t0;
        if (++g >= G) return false;
      }
      if (t < n_qt && !(t * kBt >= hi && t * kBt + kBt <= dead)) return true;
    }
  }
  __device__ __forceinline__ int q0() const { return t * kBt; }
};

// P^T and dS^T of a 64-key x 64-row tile from its S^T (st) and dP^T (dpt)
// into the bf16 A operands pa and sa: the keys key0 and key0 + 8 of the
// thread, rows q0 + the columns, lse log2(e) and D of the rows in rw.  A
// row that sees no key takes P = 1 / Skv and dS = 0.
__device__ __forceinline__ void grad_tile_t(
    float (&st)[kBt / 2], float (&dpt)[kBt / 2], uint32_t (&pa)[kBt / 16][4],
    uint32_t (&sa)[kBt / 16][4], const Mask& mk, int q0, int kmin, int key0,
    int t4, const float* rw, float scale_log2, float inv_skv) {
  const bool full = full_tile(mk, q0, kmin);
#pragma unroll
  for (int j = 0; j < kBt / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t4 + (e & 1);
      const float p = exp2_ftz(fmaf(st[4 * j + e], scale_log2, -rw[col]));
      const float ds = p * (dpt[4 * j + e] - rw[kBt + col]);
      const int qp = q0 + col, kp = key0 + 8 * (e >> 1);
      const bool ok = full || mk.ok(qp, kp);
      st[4 * j + e] = ok ? p
                      : qp >= mk.dead && qp < mk.Sq && kp < mk.Skv ? inv_skv
                                                                   : 0.f;
      dpt[4 * j + e] = ok ? ds : 0.f;
    }
#pragma unroll
  for (int kk = 0; kk < kBt / 16; ++kk) {
    a_frag(st, kk, pa[kk]);
    a_frag(dpt, kk, sa[kk]);
  }
}

// dK and dV of keys [k0, k0 + 64) of KV head kvh: grid (key tiles, K, B).
template <int HD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ rows,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, Mask mk, int Sqp,
                        int H, int K, int hd, float scale, float scale_log2) {
  constexpr int kReg = (HD + kRegionCols - 1) / kRegionCols;
  constexpr int kTile = kReg * kTRegion;  // 64 keys or 64 query rows
  constexpr int kStage = 2 * kTile;        // Q, dO
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + kTile;
  uint8_t* ring = v_s + kTile;                              // kStages
  float* rows_s = reinterpret_cast<float*>(ring + kStages * kStage);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(rows_s + kStages * 2 * kBt);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kBt;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDkdvConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kDkdvConsumers) {  // producer warp: one thread loads
    if (tid == kDkdvConsumers) {
      mbar_expect_tx(bar_kv, 2 * kTile);
      for (int r = 0; r < kReg; ++r) {
        tma_load_4d(k_s + r * kTRegion, &tk, bar_kv, r * kRegionCols, kvh, k0,
                    b);
        tma_load_4d(v_s + r * kTRegion, &tv, bar_kv, r * kRegionCols, kvh, k0,
                    b);
      }
      QWalk walk(mk, k0, G);
      for (int n = 0; walk.next(); ++n) {
        const int s = n % kStages, h = kvh * G + walk.g, q0 = walk.q0();
        mbar_wait(&empty[s], ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage + 2 * kBt * sizeof(float));
        uint8_t* st = ring + s * kStage;
        for (int r = 0; r < kReg; ++r) {
          tma_load_4d(st + r * kTRegion, &tq, &full[s], r * kRegionCols, h,
                      q0, b);
          tma_load_4d(st + kTile + r * kTRegion, &tdo, &full[s],
                      r * kRegionCols, h, q0, b);
        }
        const float* rw = rows + ((size_t)b * H + h) * 2 * Sqp + q0;
        bulk_load(rows_s + s * 2 * kBt, rw, kBt * sizeof(float), &full[s]);
        bulk_load(rows_s + s * 2 * kBt + kBt, rw + Sqp, kBt * sizeof(float),
                  &full[s]);
      }
    }
  } else {
    // this thread holds keys key0 and key0 + 8 of the accumulators
    const int w = tid / 32;
    const int lane = tid % 32;
    const int t4 = lane % 4;
    const int key0 = k0 + w * 16 + lane / 4;
    const uint32_t ka = smem_u32(k_s), va = smem_u32(v_s);
    const float inv_skv = 1.f / mk.Skv;

    float adk[HD / 2], adv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;
    mbar_wait(bar_kv, 0);
    QWalk walk(mk, k0, G);  // the producer's walk
    for (int n = 0; walk.next(); ++n) {
      const int s = n % kStages;
      mbar_wait(&full[s], (n / kStages) & 1);
      const uint32_t qt = smem_u32(ring + s * kStage), dt = qt + kTile;
      float st[kBt / 2], dpt[kBt / 2];  // S^T, dP^T: keys x query rows
      wgmma_fence();
      issue_nt<HD>(st, ka, kTRegion, qt, kTRegion);
      issue_nt<HD>(dpt, va, kTRegion, dt, kTRegion);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      uint32_t pa[kBt / 16][4], sa[kBt / 16][4];  // P^T, dS^T
      grad_tile_t(st, dpt, pa, sa, mk, walk.q0(), k0, key0, t4,
                  rows_s + s * 2 * kBt, scale_log2, inv_skv);
      fence_regs(adk);
      fence_regs(adv);
      wgmma_fence();
      issue_nn<HD>(adv, pa, dt);
      issue_nn<HD>(adk, sa, qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adk);
      fence_regs(adv);
      mbar_arrive(&empty[s]);
    }
    store_rows<HD>(adk, scale, dk, b, key0, mk.Skv, K, kvh, hd, t4);
    store_rows<HD>(adv, 1.f, dv, b, key0, mk.Skv, K, kvh, hd, t4);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* rows, void* dq,
              void* dk, void* dv, int B, int Sq, int Skv, int H, int K,
              int hd, int causal, int window, float scale,
              cudaStream_t stream) {
  const int Sqp = round_up(Sq, kBq);
  const int total = B * H * Sqp;
  flash_bwd_rows<<<(total + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, rows, Sq, Sqp, H, hd,
      total);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // 4-d maps (hd, heads, S, B) as the forward's, boxes of 128 and 64 rows
  const cuuint64_t e = 2;
  const cuuint64_t qdims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)Sq,
                               (cuuint64_t)B};
  const cuuint64_t qstr[3] = {hd * e, H * hd * e, (cuuint64_t)Sq * H * hd * e};
  const cuuint64_t kdims[4] = {(cuuint64_t)hd, (cuuint64_t)K,
                               (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {hd * e, K * hd * e,
                              (cuuint64_t)Skv * K * hd * e};
  const cuuint32_t box128[4] = {kRegionCols, 1, kBq, 1};
  const cuuint32_t box64[4] = {kRegionCols, 1, kBt, 1};
  CUtensorMap q128, do128, k64, v64, q64, do64;
  err = encode_bf16_map(&q128, q, 4, qdims, qstr, box128);
  if (!err) err = encode_bf16_map(&do128, dout, 4, qdims, qstr, box128);
  if (!err) err = encode_bf16_map(&q64, q, 4, qdims, qstr, box64);
  if (!err) err = encode_bf16_map(&do64, dout, 4, qdims, qstr, box64);
  if (!err) err = encode_bf16_map(&k64, k, 4, kdims, kstr, box64);
  if (!err) err = encode_bf16_map(&v64, v, 4, kdims, kstr, box64);
  if (err) return err;
  const Mask mk{Sq, Skv, causal, window,
                window > 0 ? Skv + window - 1 : 0x7fffffff};
  const int regions = (HD + kRegionCols - 1) / kRegionCols;
  const float scale_log2 = scale * kLog2e;
  size_t smem = dkdv_smem(regions);
  err = set_smem(flash_bwd_dkdv_bf16<HD>, smem);
  if (err) return err;
  flash_bwd_dkdv_bf16<HD>
      <<<dim3((Skv + kBt - 1) / kBt, K, B), kDkdvThreads, smem, stream>>>(
          k64, v64, q64, do64, rows, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), mk, Sqp, H, K, hd, scale,
          scale_log2);
  err = (int)cudaGetLastError();
  if (err) return err;
  smem = dq_smem(regions);
  err = set_smem(flash_bwd_dq_bf16<HD>, smem);
  if (err) return err;
  flash_bwd_dq_bf16<HD>
      <<<dim3((Sq + kBq - 1) / kBq, H, B), fa3::kThreads, smem, stream>>>(
          q128, do128, k64, v64, rows, static_cast<__nv_bfloat16*>(dq), mk,
          Sqp, H, K, hd, scale, scale_log2);
  return (int)cudaGetLastError();
}

// Three launches on `stream`; rows (B, H, 2, round_up(Sq, 128)) float32 is
// the wrapper's scratch.
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* rows, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int K, int hd,
           int causal, int window, float scale, cudaStream_t stream) {
#define KSP_HD(n)                                                          \
  case n:                                                                  \
    return launch_hd<n>(q, k, v, o, dout, lse, rows, dq, dk, dv, B, Sq,    \
                        Skv, H, K, hd, causal, window, scale, stream);
  switch (round_up(hd, 16)) {
    KSP_HD(16) KSP_HD(32) KSP_HD(48) KSP_HD(64)
    KSP_HD(80) KSP_HD(96) KSP_HD(112) KSP_HD(128)
  }
#undef KSP_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace fbwd3

extern "C" {

// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused (or a tensor map could not be encoded).  The wrapper (ops.py)
// checks shapes, dtypes, hd <= 128 (the bf16 forward also 152 and 160), and
// for bf16 hd % 8 == 0 and 16-byte aligned pointers (TMA's rules).  lse
// (B, H, Sq) float32 may be null.
int ksp_flash_attention_f32(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Skv,
                            int H, int K, int hd, int causal, int window,
                            float scale, cudaStream_t stream) {
  hopper::enter();
  return launch<float>(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv,
                       H, K, hd, causal, window, scale, stream);
}

int ksp_flash_attention_bf16(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int Sq, int Skv,
                             int H, int K, int hd, int causal, int window,
                             float scale, cudaStream_t stream) {
  hopper::enter();
  return fa3::launch(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H,
                     K, hd, causal, window, scale, stream);
}

// The backward: dq, dk, dv in the inputs' dtype from q, k, v, o, dO and
// the forward's lse; D is float32 scratch of B * H * 2 * round_up(Sq, 128)
// elements (the float32 instance uses the first B * H * Sq).  Same checks.
int ksp_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* D, void* dq, void* dk,
                                void* dv, int B, int Sq, int Skv, int H,
                                int K, int hd, int causal, int window,
                                float scale, cudaStream_t stream) {
  hopper::enter();
  return fbwd::launch<float>(q, k, v, o, dout, static_cast<const float*>(lse),
                             static_cast<float*>(D), dq, dk, dv, B, Sq, Skv,
                             H, K, hd, causal, window, scale, stream);
}

int ksp_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* D, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Skv,
                                 int H, int K, int hd, int causal, int window,
                                 float scale, cudaStream_t stream) {
  hopper::enter();
  return fbwd3::launch(q, k, v, o, dout, static_cast<const float*>(lse),
                       static_cast<float*>(D), dq, dk, dv, B, Sq, Skv, H, K,
                       hd, causal, window, scale, stream);
}

}  // extern "C"
