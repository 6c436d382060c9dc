// The update math every kernel of the port shares: ONE place for it.
//
// The counterpart of src/repro/optim/spec.py::update_event, which the
// reference's Pallas kernels (ps_update.py, replay_ring.py) call as one
// function so their math cannot drift apart.  Here replay_ring.cu and
// ps_update.cu both include this header:
//
//   update_event<OPT>   one optimizer event on one fp32 element (sgd,
//                       momentum, adagrad), the plain version
//                       repro_torch/optim/spec.py::update_event
//   staged_events       the c staged gradients g (c, D) of one element:
//                       combine  acc = sum_j coef[j] * g[j, e] in slot
//                                order 0..c-1, then one event at lrs[0];
//                       sequential  c events of coef[j] * g[j, e] at lrs[j]
//                       (repro_torch/optim/backends.py::apply_event_flat)
//   ld / st             V-wide loads and stores (V = 4, 8: 16-byte vectors)
//   blocks_for          the 1-D grid over D both kernels launch
//
// Numerics: every operation is an explicitly rounded fp32 intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn) in the plain
// version's order, and the sources are built with -fmad=false, so no
// multiply-add is contracted: kernel == plain version bitwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace update_math {

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
template <> __device__ __forceinline__ void ld<8>(const float* p, float* o) {
  ld<4>(p, o);
  ld<4>(p + 4, o + 4);
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
template <>
__device__ __forceinline__ void ld<8>(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    o[2 * i] = __low2float(b);
    o[2 * i + 1] = __high2float(b);
  }
}

template <int V> __device__ __forceinline__ void st(float* p, const float* v);
template <> __device__ __forceinline__ void st<1>(float* p, const float* v) {
  p[0] = v[0];
}
template <> __device__ __forceinline__ void st<4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <> __device__ __forceinline__ void st<8>(float* p, const float* v) {
  st<4>(p, v);
  st<4>(p + 4, v + 4);
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

// ---- the c staged gradients of elements e .. e+V-1 -------------------------
// g: (c, D) fp32 rows; sc / sl: coef and lrs staged in shared memory.
template <int OPT, bool SEQ, int V>
__device__ __forceinline__ void staged_events(float* w, float* sv,
                                              const float* __restrict__ g,
                                              int64_t D, int64_t e, int c,
                                              const float* sc,
                                              const float* sl, float m,
                                              float eps) {
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
}

// ---- launch geometry --------------------------------------------------------
// Streaming multiprocessors of the current device, read once per device.
inline int sm_count() {
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

// Blocks of THREADS threads, each thread owning V contiguous elements per
// pass; beyond 64 blocks per SM the kernels loop grid-stride.
inline int blocks_for(int64_t D, int V) {
  const int64_t work = (D + V - 1) / V;
  int64_t b = (work + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sm_count() * 64;
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace update_math
