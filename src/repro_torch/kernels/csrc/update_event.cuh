// The update math and the event schedule every update kernel of the port
// shares: ONE place for both.
//
// The counterpart of src/repro/optim/spec.py::update_event, which the
// reference's Pallas kernels (ps_update.py, replay_ring.py) call as one
// function so their math cannot drift apart.  Here replay_ring.cu and
// ps_update.cu both include this header, and both launch the kernel below
// with their own per-element operands (an "Op": RingOp in replay_ring.cu,
// PsOp in ps_update.cu), so neither the math nor the schedule can drift
// apart either:
//
//   update_event<OPT>   one optimizer event on one fp32 element (sgd,
//                       momentum, adagrad), the plain version
//                       repro_torch/optim/spec.py::update_event
//   staged_events       the c staged gradients g (c, D) of V elements:
//                       combine  acc = sum_j coef[j] * g[j, e] in slot
//                                order 0..c-1, then one event at lrs[0];
//                       sequential  c events of coef[j] * g[j, e] at lrs[j]
//                       (repro_torch/optim/backends.py::apply_event_flat)
//   simple_kernel       the grid-stride schedule, lanes on gridDim.y
//   launch_events       the host side: one launch over B lanes
//
// Every event is one launch over B lanes (the lane axis of replay_batch;
// B = 1 otherwise): lane b reads g + b*c*ldg, coef + b * coef_stride and
// lrs + b * lrs_stride.
//
// Bound: memory.  At c slots an event moves 4c bytes of g per element
// against 2c fp32 operations, a few more bytes (w, s, the residue, the ring
// rows) and a few more operations.  The schedule: blocks of THREADS
// threads, each thread owning V contiguous elements (V = 4 with 16-byte
// loads when D % 4 == 0 and every base is aligned to 4 of its elements,
// kernels/build.py::vec4; else V = 1, the ragged edge masked by the loop
// bound), up to 64 blocks per SM, grid-stride.  Every warp reads 512 bytes
// from each of c rows.  On one H100 it reaches 0.92 of the bytes bound at
// D 10 M, on another 0.88.  A persistent bulk-copy pipeline of g through
// shared memory was within 1.4 % of this schedule on two cards and
// 1.3-3.6 % ahead on a third, inside the spread between runs, so it was
// not kept (PERF.md §6 row 1).
//
// coef / lrs (and ring_apply's idx) stay in device memory: the kernel reads
// them, the host never does, so a launch is graph-capturable.
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

// coef and lrs of a block's lane are staged in shared memory (8c bytes):
// the 48 KB a launch may take without opting in hold c <= MAX_SLOTS.
constexpr int MAX_SLOTS = 6144;

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

// ---- one slot of V elements ------------------------------------------------
// combine: acc += coef_j * g_j; sequential: one event of coef_j * g_j at lr_j
template <class Op, bool SEQ, int V>
__device__ __forceinline__ void fold_slot(const Op& op, float* w, float* sv,
                                          float* acc, const float* gj,
                                          float cj, float lj, float m,
                                          float eps) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (SEQ)
      op.event(w[v], sv[v], __fmul_rn(cj, gj[v]), lj, m, eps);
    else
      acc[v] = __fadd_rn(acc[v], __fmul_rn(cj, gj[v]));
  }
}

// ---- the c staged gradients of elements e .. e+V-1 -------------------------
// g: c fp32 rows ldg apart; sc / sl: coef and lrs staged in shared memory.
template <class Op, bool SEQ, int V>
__device__ __forceinline__ void staged_events(const Op& op, float* w,
                                              float* sv,
                                              const float* __restrict__ g,
                                              int64_t ldg, int64_t e, int c,
                                              const float* sc,
                                              const float* sl, float m,
                                              float eps) {
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if (SEQ) {
    for (int j = 0; j < c; ++j) {
      float gj[V];
      ld<V>(g + (int64_t)j * ldg + e, gj);
      fold_slot<Op, SEQ, V>(op, w, sv, acc, gj, sc[j], sl[j], m, eps);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < c; ++j) {
      float gj[V];
      ld<V>(g + (int64_t)j * ldg + e, gj);
      fold_slot<Op, SEQ, V>(op, w, sv, acc, gj, sc[j], sl[j], m, eps);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) op.event(w[v], sv[v], acc[v], sl[0], m, eps);
  }
}

// ---- the operands of one launch ---------------------------------------------
struct EventArgs {
  const float* g;      // (B, c, ldg) fp32 staged gradients
  const float* coef;   // lane b's c coefficients at coef + b * coef_stride
  const float* lrs;    // lane b's c learning rates at lrs + b * lrs_stride
  int64_t D;           // elements per lane
  int64_t ldg;         // row stride of g, >= D
  int B;               // lanes
  int c;               // slots
  int coef_stride;     // 0: one coef for every lane; c: a row per lane
  int lrs_stride;
  float m, eps;
};

// ---- the simple schedule: grid-stride, lanes on gridDim.y -------------------
// shared memory: coef[c], lrs[c] of the block's lane
template <class Op, bool SEQ, int V>
__global__ void __launch_bounds__(THREADS)
simple_kernel(Op op, EventArgs a) {
  extern __shared__ float simple_smem[];
  float* sc = simple_smem;
  float* sl = simple_smem + a.c;
  const int lane = blockIdx.y;
  for (int j = threadIdx.x; j < a.c; j += blockDim.x) {
    sc[j] = a.coef[(int64_t)lane * a.coef_stride + j];
    sl[j] = a.lrs[(int64_t)lane * a.lrs_stride + j];
  }
  __syncthreads();
  const float* g = a.g + (int64_t)lane * a.c * a.ldg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < a.D; e += stride) {
    float w[V], sv[V];
    op.template load<V>(lane, e, w, sv);
    staged_events<Op, SEQ, V>(op, w, sv, g, a.ldg, e, a.c, sc, sl, a.m,
                              a.eps);
    op.template store<V>(lane, e, w, sv);
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

// One launch of the event over a.B lanes; returns its cudaError_t.  vec4:
// the 4-wide loads (D % 4 == 0, every base aligned to 4 of its elements).
template <class Op, bool SEQ>
cudaError_t launch_events(const Op& op, const EventArgs& a, int vec4,
                          cudaStream_t st) {
  if (a.c < 1 || a.c > MAX_SLOTS || a.B < 1 || a.B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_for(a.D, vec4 ? 4 : 1), a.B);
  const size_t bytes = 2 * (size_t)a.c * sizeof(float);
  if (vec4)
    simple_kernel<Op, SEQ, 4><<<grid, THREADS, bytes, st>>>(op, a);
  else
    simple_kernel<Op, SEQ, 1><<<grid, THREADS, bytes, st>>>(op, a);
  return cudaGetLastError();
}

}  // namespace update_math
