// Replay-ring update kernels for Hopper (sm_90a): one launch per update event.
//
// Replace the TPU megakernels in src/repro/kernels/replay_ring.py:
//   ring_apply        <- ring_apply / _apply_kernel / _tile_events
//   ring_apply_whatif <- ring_apply_whatif / _whatif_kernel
//
// One event, element by element over the flat (K, D) ring:
//   w = float(ring[prev, i]) (+ res[i])          read row prev, re-add residue
//   combine:    acc = sum_j coef[j] * g[j, i]     slot order 0..c-1
//               (w, s) = update_event(w, s, acc, lrs[0])
//   sequential: for j: (w, s) = update_event(w, s, coef[j] * g[j, i], lrs[j])
//   what-if:    g_j = a[i] * (float(ring[ts_j, i]) - wstar[i])  (in the kernel)
//   q = round(w) to the ring type; ring[slot, i] = q; res[i] = w - float(q)
//
// Bound: memory.  Per event the kernel moves D * (ring bytes read + 4c
// [staged g] + 8 [state r/w] + 8 [residue r/w] + ring bytes written); the
// arithmetic is a few fp32 operations per byte.  The design is the simple
// one: a 1-D grid-stride loop over D, each thread owning V contiguous
// elements (V = 4 with 16-byte vector loads when D % 4 == 0, so every row
// start is aligned; V = 1 on a ragged D).  The ragged edge is masked by the
// loop bound.  prev / slot / ts come from a device int32 array (no host
// sync; graph-capturable), and coef / lrs / ts are staged once per block in
// shared memory.  The what-if kernel re-reads a repeated ts_j row from
// L1/L2 rather than HBM: the c reads of element i by one thread hit the same
// cache lines.  Each element is read and written by the same thread, and
// every read of element i precedes its write, so prev == slot (K = 1) and
// slot in ts are safe.
//
// Numerics: the update math (update_event, the slot-order combine, the
// sequential events) lives in update_event.cuh, shared with ps_update.cu, so
// kernel == plain version bitwise for both.  bf16 rounding is
// round-to-nearest-even (__float2bfloat16_rn), as torch's .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "update_event.cuh"

namespace {

using namespace update_math;

// Quantize w into the ring row at p; q receives float(quantized w).
template <int V>
__device__ __forceinline__ void quantize_store(float* p, const float* w,
                                               float* q) {
  st<V>(p, w);
#pragma unroll
  for (int v = 0; v < V; ++v) q[v] = w[v];
}
template <int V>
__device__ __forceinline__ void quantize_store(__nv_bfloat16* p,
                                               const float* w, float* q) {
  __nv_bfloat16 b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    b[v] = __float2bfloat16_rn(w[v]);
    q[v] = __bfloat162float(b[v]);
  }
  if constexpr (V == 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __halves2bfloat162(b[0], b[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __halves2bfloat162(b[2], b[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = b[v];
  }
}

// Read row prev (+ residue) and the state; shared by both kernels.
template <typename T, int OPT, bool EF, int V>
__device__ __forceinline__ void load_event(const T* src, const float* s,
                                           const float* res, int64_t e,
                                           float* w, float* sv) {
  ld<V>(src + e, w);
  if (EF) {
    float r[V];
    ld<V>(res + e, r);
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = __fadd_rn(w[v], r[v]);
  }
  if (OPT != OPT_SGD) {
    ld<V>(s + e, sv);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) sv[v] = 0.f;
  }
}

// Write row slot, the state and the residue w - float(q).
template <typename T, int OPT, bool EF, int V>
__device__ __forceinline__ void store_event(T* dst, float* s, float* res,
                                            int64_t e, const float* w,
                                            const float* sv) {
  float q[V];
  quantize_store<V>(dst + e, w, q);
  if (OPT != OPT_SGD) st<V>(s + e, sv);
  if (EF) {
    float r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = __fsub_rn(w[v], q[v]);
    st<V>(res + e, r);
  }
}

// ---- ring_apply: staged gradients g (c, D) fp32 -----------------------------
// shared memory: coef[c], lrs[c]
template <typename T, int OPT, bool SEQ, bool EF, int V>
__global__ void __launch_bounds__(THREADS)
ring_apply_kernel(T* ring, float* s, float* res, const float* __restrict__ g,
                  const float* __restrict__ coef,
                  const float* __restrict__ lrs,
                  const int32_t* __restrict__ idx, int64_t D, int c, float m,
                  float eps) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* sl = smem + c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sc[j] = coef[j];
    sl[j] = lrs[j];
  }
  __syncthreads();
  const T* src = ring + (int64_t)idx[0] * D;
  T* dst = ring + (int64_t)idx[1] * D;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < D; e += stride) {
    float w[V], sv[V];
    load_event<T, OPT, EF, V>(src, s, res, e, w, sv);
    staged_events<OPT, SEQ, V>(w, sv, g, D, e, c, sc, sl, m, eps);
    store_event<T, OPT, EF, V>(dst, s, res, e, w, sv);
  }
}

// ---- ring_apply_whatif: g_j = a * (ring[ts_j] - wstar), combine mode -------
// shared memory: coef[c], ts rows[c]
template <typename T, int OPT, bool EF, int V>
__global__ void __launch_bounds__(THREADS)
ring_apply_whatif_kernel(T* ring, float* s, float* res,
                         const float* __restrict__ a,
                         const float* __restrict__ wstar,
                         const float* __restrict__ coef,
                         const float* __restrict__ lrs,
                         const int32_t* __restrict__ idx, int64_t D, int c,
                         float m, float eps) {
  extern __shared__ float smem[];
  float* sc = smem;
  int32_t* sts = reinterpret_cast<int32_t*>(smem + c);
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sc[j] = coef[j];
    sts[j] = idx[2 + j];
  }
  __syncthreads();
  const float lr = lrs[0];
  const T* src = ring + (int64_t)idx[0] * D;
  T* dst = ring + (int64_t)idx[1] * D;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < D; e += stride) {
    float av[V], wv[V], acc[V];
    ld<V>(a + e, av);
    ld<V>(wstar + e, wv);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
    for (int j = 0; j < c; ++j) {
      float r[V];
      ld<V>(ring + (int64_t)sts[j] * D + e, r);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = __fsub_rn(r[v], wv[v]);          // r - w*
        const float gj = __fmul_rn(av[v], t);             // a * t
        acc[v] = __fadd_rn(acc[v], __fmul_rn(sc[j], gj)); // acc + coef*g
      }
    }
    float w[V], sv[V];
    load_event<T, OPT, EF, V>(src, s, res, e, w, sv);
#pragma unroll
    for (int v = 0; v < V; ++v) update_event<OPT>(w[v], sv[v], acc[v], lr, m, eps);
    store_event<T, OPT, EF, V>(dst, s, res, e, w, sv);
  }
}

template <typename T, int OPT, bool SEQ, bool EF, int V>
void launch_apply(void* ring, void* s, void* res, const void* g,
                  const void* coef, const void* lrs, const void* idx,
                  int64_t D, int c, float m, float eps, cudaStream_t st) {
  ring_apply_kernel<T, OPT, SEQ, EF, V>
      <<<blocks_for(D, V), THREADS, 2 * c * sizeof(float), st>>>(
          static_cast<T*>(ring), static_cast<float*>(s),
          static_cast<float*>(res), static_cast<const float*>(g),
          static_cast<const float*>(coef), static_cast<const float*>(lrs),
          static_cast<const int32_t*>(idx), D, c, m, eps);
}

template <typename T, int OPT, bool EF, int V>
void launch_whatif(void* ring, void* s, void* res, const void* a,
                   const void* wstar, const void* coef, const void* lrs,
                   const void* idx, int64_t D, int c, float m, float eps,
                   cudaStream_t st) {
  ring_apply_whatif_kernel<T, OPT, EF, V>
      <<<blocks_for(D, V), THREADS, 2 * c * sizeof(float), st>>>(
          static_cast<T*>(ring), static_cast<float*>(s),
          static_cast<float*>(res), static_cast<const float*>(a),
          static_cast<const float*>(wstar), static_cast<const float*>(coef),
          static_cast<const float*>(lrs), static_cast<const int32_t*>(idx), D,
          c, m, eps);
}

// runtime flags -> template instantiation
template <typename T, int OPT, bool SEQ, bool EF>
void apply_v(int vec4, void* ring, void* s, void* res, const void* g,
             const void* coef, const void* lrs, const void* idx, int64_t D,
             int c, float m, float eps, cudaStream_t st) {
  if (vec4)
    launch_apply<T, OPT, SEQ, EF, 4>(ring, s, res, g, coef, lrs, idx, D, c, m,
                                     eps, st);
  else
    launch_apply<T, OPT, SEQ, EF, 1>(ring, s, res, g, coef, lrs, idx, D, c, m,
                                     eps, st);
}

template <typename T, int OPT>
void apply_mode(int seq, int ef, int vec4, void* ring, void* s, void* res,
                const void* g, const void* coef, const void* lrs,
                const void* idx, int64_t D, int c, float m, float eps,
                cudaStream_t st) {
  if (seq) {
    if (ef) apply_v<T, OPT, true, true>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
    else apply_v<T, OPT, true, false>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  } else {
    if (ef) apply_v<T, OPT, false, true>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
    else apply_v<T, OPT, false, false>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  }
}

template <typename T>
void apply_opt(int opt, int seq, int ef, int vec4, void* ring, void* s,
               void* res, const void* g, const void* coef, const void* lrs,
               const void* idx, int64_t D, int c, float m, float eps,
               cudaStream_t st) {
  if (opt == OPT_SGD)
    apply_mode<T, OPT_SGD>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  else if (opt == OPT_MOMENTUM)
    apply_mode<T, OPT_MOMENTUM>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  else
    apply_mode<T, OPT_ADAGRAD>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
}

template <typename T, int OPT>
void whatif_mode(int ef, int vec4, void* ring, void* s, void* res,
                 const void* a, const void* wstar, const void* coef,
                 const void* lrs, const void* idx, int64_t D, int c, float m,
                 float eps, cudaStream_t st) {
  if (ef) {
    if (vec4) launch_whatif<T, OPT, true, 4>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
    else launch_whatif<T, OPT, true, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  } else {
    if (vec4) launch_whatif<T, OPT, false, 4>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
    else launch_whatif<T, OPT, false, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  }
}

template <typename T>
void whatif_opt(int opt, int ef, int vec4, void* ring, void* s, void* res,
                const void* a, const void* wstar, const void* coef,
                const void* lrs, const void* idx, int64_t D, int c, float m,
                float eps, cudaStream_t st) {
  if (opt == OPT_SGD)
    whatif_mode<T, OPT_SGD>(ef, vec4, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  else if (opt == OPT_MOMENTUM)
    whatif_mode<T, OPT_MOMENTUM>(ef, vec4, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  else
    whatif_mode<T, OPT_ADAGRAD>(ef, vec4, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// Each returns the cudaError_t of its launch (0 = launched).
extern "C" int ring_apply(void* ring, int ring_bf16, void* s, void* res,
                          const void* g, const void* coef, const void* lrs,
                          const void* idx, long long D, int c, int opt,
                          int sequential, float momentum, float eps,
                          int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  if (ring_bf16)
    apply_opt<__nv_bfloat16>(opt, sequential, ef, vec4, ring, s, res, g, coef,
                             lrs, idx, D, c, momentum, eps, st);
  else
    apply_opt<float>(opt, sequential, ef, vec4, ring, s, res, g, coef, lrs,
                     idx, D, c, momentum, eps, st);
  return (int)cudaGetLastError();
}

extern "C" int ring_apply_whatif(void* ring, int ring_bf16, void* s,
                                 void* res, const void* a, const void* wstar,
                                 const void* coef, const void* lrs,
                                 const void* idx, long long D, int c, int opt,
                                 float momentum, float eps, int vec4,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  if (ring_bf16)
    whatif_opt<__nv_bfloat16>(opt, ef, vec4, ring, s, res, a, wstar, coef,
                              lrs, idx, D, c, momentum, eps, st);
  else
    whatif_opt<float>(opt, ef, vec4, ring, s, res, a, wstar, coef, lrs, idx,
                      D, c, momentum, eps, st);
  return (int)cudaGetLastError();
}

extern "C" const char* replay_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
