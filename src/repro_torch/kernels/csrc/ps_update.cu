// Parameter-server update kernel for Hopper (sm_90a): one launch per update
// of the host PS, over the whole flattened model.
//
// Replaces the TPU kernel in src/repro/kernels/ps_update.py:
//   ps_apply <- ps_apply / _events / _stateless_kernel (sgd, :116) and
//               _stateful_kernel (momentum / adagrad, :128)
//
// Per element e of the flat (D,) buffers:
//   combine:    acc = sum_j coef[j] * g[j, e]     slot order 0..c-1
//               (w, s) = update_event(w, s, acc, lrs[0])
//   sequential: for j: (w, s) = update_event(w, s, coef[j] * g[j, e], lrs[j])
//   w_out[e] = w; s_out[e] = s
// The math and the schedule are update_event.cuh's, the same code
// ring_apply runs; this file gives them the PS's operands (PsOp).
//
// OUT OF PLACE: w / s are read and new w_out / s_out written, as the
// reference's pallas_call makes new arrays.  The host PS hands learners the
// weights it holds (views into the flat buffer); writing w in place would
// move every learner's stale snapshot to the current weights.
//
// Bound: memory.  Per update the kernel moves D * (4c [staged g] + 4 [w] +
// 4 [w_out] + 8 [s, s_out when stateful]) bytes for 2c + a few fp32
// operations per element.  The schedule is update_event.cuh's grid-stride
// loop, V = 4 with 16-byte loads when D % 4 == 0 and the bases are aligned,
// V = 1 on a ragged D (the paper's D 2 762, the cnn cell's 89 578), whose
// edge the loop bound masks.  coef / lrs are read from device tensors and
// staged in shared memory: the host never reads them back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "update_event.cuh"

namespace {

using namespace update_math;

// The per-element operands of one update (one lane): w and s in, w_out and
// s_out out (s / s_out null for sgd).
template <int OPT>
struct PsOp {
  const float* w;
  const float* s;
  float* w_out;
  float* s_out;

  template <int V>
  __device__ __forceinline__ void load(int, int64_t e, float* wv,
                                       float* sv) const {
    ld<V>(w + e, wv);
    if (OPT != OPT_SGD) {
      ld<V>(s + e, sv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) sv[v] = 0.f;
    }
  }
  template <int V>
  __device__ __forceinline__ void store(int, int64_t e, const float* wv,
                                        const float* sv) const {
    st<V>(w_out + e, wv);
    if (OPT != OPT_SGD) st<V>(s_out + e, sv);
  }
  __device__ __forceinline__ void event(float& w_, float& s_, float g,
                                        float lr, float m, float eps) const {
    update_event<OPT>(w_, s_, g, lr, m, eps);
  }
};

template <int OPT>
cudaError_t launch(int seq, int vec4, const void* w, const void* s,
                   void* w_out, void* s_out, const EventArgs& a,
                   cudaStream_t st) {
  const PsOp<OPT> op{static_cast<const float*>(w),
                     static_cast<const float*>(s), static_cast<float*>(w_out),
                     static_cast<float*>(s_out)};
  return seq ? launch_events<PsOp<OPT>, true>(op, a, vec4, st)
             : launch_events<PsOp<OPT>, false>(op, a, vec4, st);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// Returns the cudaError_t of the launch (0 = launched).  s / s_out are null
// for sgd; vec4: the 4-wide loads (kernels/build.py::vec4).
extern "C" int ps_apply(const void* w, const void* s, const void* g,
                        const void* coef, const void* lrs, void* w_out,
                        void* s_out, long long D, int c, int opt,
                        int sequential, float momentum, float eps, int vec4,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace update_math;
  const EventArgs a{static_cast<const float*>(g),
                    static_cast<const float*>(coef),
                    static_cast<const float*>(lrs), D, D, 1, c, 0, 0,
                    momentum, eps};
  cudaError_t err;
  if (opt == OPT_SGD)
    err = launch<OPT_SGD>(sequential, vec4, w, s, w_out, s_out, a, st);
  else if (opt == OPT_MOMENTUM)
    err = launch<OPT_MOMENTUM>(sequential, vec4, w, s, w_out, s_out, a, st);
  else
    err = launch<OPT_ADAGRAD>(sequential, vec4, w, s, w_out, s_out, a, st);
  return (int)err;
}

// The largest c the shared-memory plan takes (kernels/build.py checks it).
extern "C" int ps_update_max_slots() { return update_math::MAX_SLOTS; }

extern "C" const char* ps_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
