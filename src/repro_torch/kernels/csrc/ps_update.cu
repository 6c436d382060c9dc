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
// The math is update_event.cuh's, the same code ring_apply runs.
//
// OUT OF PLACE: w / s are read and new w_out / s_out written, as the
// reference's pallas_call makes new arrays.  The host PS hands learners the
// weights it holds (views into the flat buffer); writing w in place would
// move every learner's stale snapshot to the current weights.
//
// Bound: memory.  Per update the kernel moves D * (4c [staged g] + 4 [w] +
// 4 [w_out] + 8 [s, s_out when stateful]) bytes for 2c + a few fp32
// operations per element.  The design is the simple one: a 1-D
// grid-stride loop over D, each thread owning V contiguous elements (V = 4
// with 16-byte vector loads when D % 4 == 0 and the bases are aligned; V = 1
// on a ragged D, whose edge the loop bound masks).  coef / lrs are read from
// device tensors and staged once per block in shared memory: the host never
// reads them back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "update_event.cuh"

namespace {

using namespace update_math;

// shared memory: coef[c], lrs[c]
template <int OPT, bool SEQ, int V>
__global__ void __launch_bounds__(THREADS)
ps_apply_kernel(const float* __restrict__ w, const float* __restrict__ s,
                const float* __restrict__ g, const float* __restrict__ coef,
                const float* __restrict__ lrs, float* __restrict__ w_out,
                float* __restrict__ s_out, int64_t D, int c, float m,
                float eps) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* sl = smem + c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sc[j] = coef[j];
    sl[j] = lrs[j];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < D; e += stride) {
    float wv[V], sv[V];
    ld<V>(w + e, wv);
    if (OPT != OPT_SGD) {
      ld<V>(s + e, sv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) sv[v] = 0.f;
    }
    staged_events<OPT, SEQ, V>(wv, sv, g, D, e, c, sc, sl, m, eps);
    st<V>(w_out + e, wv);
    if (OPT != OPT_SGD) st<V>(s_out + e, sv);
  }
}

template <int OPT, bool SEQ, int V>
void launch(const void* w, const void* s, const void* g, const void* coef,
            const void* lrs, void* w_out, void* s_out, int64_t D, int c,
            float m, float eps, cudaStream_t st) {
  ps_apply_kernel<OPT, SEQ, V>
      <<<blocks_for(D, V), THREADS, 2 * c * sizeof(float), st>>>(
          static_cast<const float*>(w), static_cast<const float*>(s),
          static_cast<const float*>(g), static_cast<const float*>(coef),
          static_cast<const float*>(lrs), static_cast<float*>(w_out),
          static_cast<float*>(s_out), D, c, m, eps);
}

template <int OPT>
void launch_mode(int seq, int vec4, const void* w, const void* s,
                 const void* g, const void* coef, const void* lrs,
                 void* w_out, void* s_out, int64_t D, int c, float m,
                 float eps, cudaStream_t st) {
  if (seq) {
    if (vec4) launch<OPT, true, 4>(w, s, g, coef, lrs, w_out, s_out, D, c, m, eps, st);
    else launch<OPT, true, 1>(w, s, g, coef, lrs, w_out, s_out, D, c, m, eps, st);
  } else {
    if (vec4) launch<OPT, false, 4>(w, s, g, coef, lrs, w_out, s_out, D, c, m, eps, st);
    else launch<OPT, false, 1>(w, s, g, coef, lrs, w_out, s_out, D, c, m, eps, st);
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// Returns the cudaError_t of the launch (0 = launched).  s / s_out are null
// for sgd.
extern "C" int ps_apply(const void* w, const void* s, const void* g,
                        const void* coef, const void* lrs, void* w_out,
                        void* s_out, long long D, int c, int opt,
                        int sequential, float momentum, float eps, int vec4,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace update_math;
  if (opt == OPT_SGD)
    launch_mode<OPT_SGD>(sequential, vec4, w, s, g, coef, lrs, w_out, s_out,
                         D, c, momentum, eps, st);
  else if (opt == OPT_MOMENTUM)
    launch_mode<OPT_MOMENTUM>(sequential, vec4, w, s, g, coef, lrs, w_out,
                              s_out, D, c, momentum, eps, st);
  else
    launch_mode<OPT_ADAGRAD>(sequential, vec4, w, s, g, coef, lrs, w_out,
                             s_out, D, c, momentum, eps, st);
  return (int)cudaGetLastError();
}

extern "C" const char* ps_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
