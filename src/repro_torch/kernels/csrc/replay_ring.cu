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
// Numerics: every operation is an explicitly rounded fp32 intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn), in the
// order of the plain PyTorch version (repro_torch/optim/spec.py,
// repro_torch/optim/backends.py), and the file is built with -fmad=false,
// so no multiply-add is contracted: kernel == plain version bitwise.  bf16
// rounding is round-to-nearest-even (__float2bfloat16_rn), as torch's
// .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OPT_SGD = 0, OPT_MOMENTUM = 1, OPT_ADAGRAD = 2 };
constexpr int THREADS = 256;

// ---- V-wide loads and stores, converting to / from fp32 -------------------
template <int V> __device__ __forceinline__ void ld(const float* p, float* o);
template <> __device__ __forceinline__ void ld<1>(const float* p, float* o) {
  o[0] = p[0];
}
template <> __device__ __forceinline__ void ld<4>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <int V>
__device__ __forceinline__ void ld(const __nv_bfloat16* p, float* o);
template <>
__device__ __forceinline__ void ld<1>(const __nv_bfloat16* p, float* o) {
  o[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void ld<4>(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}

template <int V> __device__ __forceinline__ void st(float* p, const float* v);
template <> __device__ __forceinline__ void st<1>(float* p, const float* v) {
  p[0] = v[0];
}
template <> __device__ __forceinline__ void st<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

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

// ---- THE update rule (repro_torch/optim/spec.py::update_event) ------------
template <int OPT>
__device__ __forceinline__ void update_event(float& w, float& s, float g,
                                             float lr, float m, float eps) {
  if (OPT == OPT_SGD) {
    w = __fsub_rn(w, __fmul_rn(lr, g));                 // w - lr*g
  } else if (OPT == OPT_MOMENTUM) {
    const float v = __fadd_rn(__fmul_rn(m, s), g);      // m*s + g
    w = __fsub_rn(w, __fmul_rn(lr, v));                 // w - lr*v
    s = v;
  } else {
    const float a = __fadd_rn(s, __fmul_rn(g, g));      // s + g*g
    const float d = __fadd_rn(__fsqrt_rn(a), eps);      // sqrt(a) + eps
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(lr, g), d));   // w - lr*g / d
    s = a;
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
    if (SEQ) {
      for (int j = 0; j < c; ++j) {
        float gj[V];
        ld<V>(g + (int64_t)j * D + e, gj);
#pragma unroll
        for (int v = 0; v < V; ++v)
          update_event<OPT>(w[v], sv[v], __fmul_rn(sc[j], gj[v]), sl[j], m,
                            eps);
      }
    } else {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
      for (int j = 0; j < c; ++j) {
        float gj[V];
        ld<V>(g + (int64_t)j * D + e, gj);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(sc[j], gj[v]));
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        update_event<OPT>(w[v], sv[v], acc[v], sl[0], m, eps);
    }
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

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int cache[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 1;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 1;
  }
  return cache[dev];
}

int blocks_for(int64_t D, int V) {
  const int64_t work = (D + V - 1) / V;
  int64_t b = (work + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sm_count() * 64;  // grid-stride beyond 64/SM
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
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
