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
// (989 TFLOP/s bf16 over 3.35 TB/s).
//
// Design (simple and right first; tensor cores, TMA and pipelining are
// later work): one block of 256 threads per (b, h, 64-row query tile),
// looping over 64-row KV tiles up to the causal frontier (tiles above it are
// skipped, as the TPU kernel does).  Q (scaled in float32, as kernel.py:55),
// the K and V tiles and the probability tile are staged in shared memory as
// float32; both products run on the CUDA cores in float32 with a 4 x 4
// register tile per thread for the scores and 4 rows x hd/16 columns for the
// output.  The running max, normaliser and accumulator stay in registers
// in float32 across KV tiles.  Masked scores take the finite -1e30 of the
// TPU kernel: a row whose first visited tile is fully masked gets
// exp(0) = 1 weights that the next tile's correction exp(-1e30 - m) = 0
// wipes out, where -inf would give NaN.  The head dim is taken as it is
// (hd <= 128); shared-memory rows have an odd float stride (hd + 1) so the
// threads of a warp read distinct banks.
//
// Built without --use_fast_math: the float32 path is held to 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr int kMaxHd = 128;
constexpr int kHdCols = kMaxHd / 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kBq + kBk) * (hd + 1) +
                          (size_t)kBk * hd + (size_t)kBq * (kBk + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
              int H, int K, int hd, int causal, int window, float scale) {
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
    T* row = out + (((size_t)b * Sq + s) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kHdCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(row + d, acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int K, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBq - 1) / kBq, H, B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, K, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused.  The wrapper (ops.py) checks shapes, dtypes and hd <= 128.
int ksp_flash_attention_f32(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Skv, int H, int K,
                            int hd, int causal, int window, float scale,
                            cudaStream_t stream) {
  return launch<float>(q, k, v, out, B, Sq, Skv, H, K, hd, causal, window,
                       scale, stream);
}

int ksp_flash_attention_bf16(const void* q, const void* k, const void* v,
                             void* out, int B, int Sq, int Skv, int H, int K,
                             int hd, int causal, int window, float scale,
                             cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, K, hd, causal,
                               window, scale, stream);
}

}  // extern "C"
