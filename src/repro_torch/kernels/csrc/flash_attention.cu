// Flash attention for Hopper (sm_90a): online-softmax GQA attention with
// causal and sliding-window masks, fp32 math on the CUDA cores.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_bkgsd (pallas_call at :123) with _attn_kernel (:29) and
//   _attn_block (:64), reached through flash_attention (:146).
//
// What it computes, per (b, kv head) and query row (g, i) of its G rows:
//   s_j = (q . k_j) * scale, masked to -1e30 where k_j >= Sk, or causal and
//         j > i, or window > 0 and j <= i - window; with Sk < 64 the keys
//         k_j >= Sk are padding of the one tile and take -inf instead;
//   over the K tiles that hold a live key, in order:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); alpha = exp(m - m')
//     l = l * alpha + sum_j p_j;  acc = acc * alpha + sum_j p_j v_j
//   out = acc / max(l, 1e-30), in q's dtype.
// The mask constant is the TPU kernel's finite -1e30, not -inf: a row with no
// live key in its first processed tile accumulates exp(0) = 1 terms that the
// next tile's alpha = exp(-1e30 - m') = 0 wipes out exactly, where -inf would
// give exp(-inf + inf) = NaN.  Tiles with no live key are skipped as the TPU
// kernel skips them: K tiles strictly above the causal diagonal of the query
// tile, and K tiles entirely before the sliding window.  Padded keys are not
// masked keys: the plain version's key tile is min(64, Sk) wide, so with
// Sk < 64 a row with no live key averages the Sk real keys there.  Here the
// tile is 64 wide, so its keys past Sk take -inf (exp gives 0; m stays at
// least -1e30, so no -inf - -inf arises) and that row averages the same Sk
// keys.  With Sk >= 64 the plain version pads its last tile with -1e30 keys
// too, and so does the kernel.
//
// Work layout.  One thread block per (q tile, b * KV + kv).  A q tile is
// blk_q query positions of one KV head times its G query heads: the
// G * blk_q <= ROWS rows share each K/V tile, which the block reads once into
// shared memory (the TPU kernel's GQA fold).  The running (m, l, acc) of each
// row stay in registers across the loop over K tiles inside the block; that
// loop takes the place of the TPU grid's sequential kv axis, and nothing
// carries between blocks.  256 threads form a 16 x 16 grid: thread (ty, tx)
// owns rows ty + 16 i (i < 4), score columns tx + 16 j of each K tile
// (j < 4) and output dims tx + 16 j (j < D / 16).  The 16 threads of a row
// sit in one half-warp, so a row's max and sum are shuffles.  Shared rows are
// padded to D + 1 floats so the strided reads fall in distinct banks.
// Operands are read through element strides with a contiguous head dim, so
// both the (B, KV, G, S, D) layout and the model's (B, S, H, D) layout
// (head h = kv * G + g) launch without a copy; ragged Sq and Sk are masked
// in the kernel (zero rows loaded, never stored), not padded by the caller.
//
// Bound.  Operations: each live (query row, key) pair costs 2 D fused
// multiply-adds (q.k and p.v), against q/k/v/out bytes read or written
// once, so at a long sequence the work is ~10^4 flops per byte.  This first
// design does that arithmetic in fp32 on the CUDA cores (67 TFLOP/s on an
// H100 SXM), as the TPU kernel upcasts to fp32 for both products; it uses no
// tensor cores (bf16 P in mma/wgmma would change P.V's rounding) and no
// TMA, and it does not overlap the K/V loads with the arithmetic.  This file
// builds without -fmad=false: the kernel is held against its plain PyTorch
// version within a tolerance, not bitwise, so products and sums may fuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread grid
constexpr int ROWS = 64;       // query rows per block: G * blk_q <= ROWS
constexpr int BK = 64;         // keys per K/V tile
constexpr int RPT = ROWS / 16; // rows per thread
constexpr int CPT = BK / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;

struct Strides {   // element strides; the head dim is contiguous
  long long b, kv, g, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)ROWS * (D + 1) + 2 * (size_t)BK * (D + 1) +
                          (size_t)ROWS * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int KV, int G, int Sq,
             int Sk, int blk_q, int nq, float scale, int causal,
             int window) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 16;   // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // ROWS x LD
  float* Ks = Qs + ROWS * LD;    // BK x LD
  float* Vs = Ks + BK * LD;      // BK x LD
  float* Ps = Vs + BK * LD;      // ROWS x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qi = nq - 1 - (int)blockIdx.x;   // the longest causal tiles first
  const int b = (int)blockIdx.y / KV, kvh = (int)blockIdx.y % KV;
  const int q0 = qi * blk_q;
  const int q_hi = q0 + blk_q - 1;
  const int nrows = G * blk_q;
  const T* qb = q + b * qs.b + kvh * qs.kv;
  const T* kb = k + b * ks.b + kvh * ks.kv;
  const T* vb = v + b * vs.b + kvh * vs.kv;
  T* ob = o + b * os.b + kvh * os.kv;

  // the Q tile, zero in the rows past G * blk_q and past Sq
  for (int e = tid; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < nrows) {
      const int g = r / blk_q, qp = q0 + r % blk_q;
      if (qp < Sq) x = to_f(qb[g * qs.g + (long long)qp * qs.s + d]);
    }
    Qs[r * LD + d] = x;
  }

  int qpos[RPT];
  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    qpos[i] = q0 + (r < nrows ? r % blk_q : 0);
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  const int bk = Sk < BK ? Sk : BK;   // the plain version's key tile
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (causal && k0 > q_hi) break;                      // above the diagonal
    if (window > 0 && k0 + bk - 1 <= q0 - window) continue;  // before the window
    __syncthreads();   // the last tile's readers are done (and Q is stored)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const int kp = k0 + c;
      const bool in = kp < Sk;
      Ks[c * LD + d] = in ? to_f(kb[(long long)kp * ks.s + d]) : 0.f;
      Vs[c * LD + d] = in ? to_f(vb[(long long)kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] += a[i] * kk[j];
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool live = kp < Sk && (!causal || kp <= qpos[i]) &&
                          (window <= 0 || kp > qpos[i] - window);
        s[i][j] = live ? s[i][j] * scale
                       : (kp >= Sk && Sk < BK) ? -INFINITY : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - mn);
        ps += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows || qpos[i] >= Sq) continue;
    const int g = r / blk_q;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + g * os.g + (long long)qpos[i] * os.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(orow + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides* st, int B, int KV, int G, int Sq, int Sk,
           int blk_q, float scale, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + blk_q - 1) / blk_q;
  dim3 grid(nq, B * KV);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], KV, G, Sq, Sk, blk_q, nq, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(int D, const void* q, const void* k, const void* v, void* o,
               const Strides* st, int B, int KV, int G, int Sq, int Sk,
               int blk_q, float scale, int causal, int window,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, KV, G, Sq, Sk, blk_q, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, st, B, KV, G, Sq, Sk, blk_q, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, st, B, KV, G, Sq, Sk, blk_q, scale, causal, window, stream);
    case 112: return launch<T, 112>(q, k, v, o, st, B, KV, G, Sq, Sk, blk_q, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, KV, G, Sq, Sk, blk_q, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// strides: 16 element strides, (b, kv, g, s) for q, k, v and o in turn (g is
// unused for k and v); the head dim must be contiguous.  dtype: 0 = fp32,
// 1 = bf16 (q, k, v and o alike).  Returns the cudaError_t of the launch
// (0 = launched); cudaErrorInvalidValue for an unsupported D.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int KV,
                                   int G, int Sq, int Sk, int D, int dtype,
                                   int blk_q, float scale, int causal,
                                   int window, void* stream) {
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[4 * t], strides[4 * t + 1], strides[4 * t + 2],
                    strides[4 * t + 3]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(D, q, k, v, o, st, B, KV, G, Sq, Sk, blk_q,
                             scale, causal, window, s);
  return launch_dim<__nv_bfloat16>(D, q, k, v, o, st, B, KV, G, Sq, Sk,
                                   blk_q, scale, causal, window, s);
}

extern "C" int flash_attention_rows() { return ROWS; }
extern "C" int flash_attention_block_k() { return BK; }

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
