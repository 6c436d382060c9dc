// RMSNorm over the rows of an activation in one pass, for Hopper (sm_90a):
// each row read once, normalised in fp32 and written once in its dtype
// (models/hybrid.py's full-sequence forward: the Mamba2 layers' input
// norm, the shared blocks' input and pre-MLP norms, the final norm).
//
// Replaces no TPU kernel: the reference leaves the norm to XLA, which fuses
// it.  The port's plain PyTorch (kernels/rms_norm.py::rms_norm_plain) runs
// it as ~8 launches a call through fp32 intermediates, ~40 bytes of device
// memory an element against the 4 a pass needs in bf16.
//
// rms_norm_kernel, per row of W = W1 + W2 elements of T (bf16 or fp32),
// the row given as two column pieces (x: W1 columns, tail: W2, W2 = 0 for
// one piece) so a concatenation is never materialised:
//   xf  = float(row)
//   var = (sum_W xf * xf) * (1 / W)        1 / W rounded to fp32, as
//                                          PyTorch's mean scales
//   r   = rsqrtf(var + eps)
//   out = T((xf * r) * float(scale))       -> (rows, W) T
// Each multiply and add is an explicit round-to-nearest intrinsic, so the
// output differs from the plain path's only through the order of the fp32
// sum of squares.  Built with -fmad=false all the same.
//
// Bound: bytes.  At the zamba2_7b.prefill cell (32 768 rows) a call reads
// and writes 2 bytes an element: W 3 584 is 470 MB, 0.140 ms at 3.35
// TB/s; W 2 x 3 584 is 940 MB, 0.281 ms.  The scale (W elements) stays in
// L1 / L2.
//
// Design.  One block a row, the whole row in registers, so device memory
// is read once: a thread holds NV raw 16-byte vectors (8 elements each,
// neighbouring threads on neighbouring vectors) and issues all their loads
// before any arithmetic; the sum of squares is reduced by warp shuffles and
// one shared word a warp (rows.cuh: block_sum).  NV follows the row width:
// the fewest vectors a thread that keep a block within MAX_THREADS, so one
// templated kernel adapts by shape (W 3 584: NV 2, 224 threads; 7 168: NV
// 4, 224 threads).  bf16 at NV 2 takes 32 registers, so 9 blocks fill an
// SM's 2 048 threads.
//
// Measured at the cell's 32 768 rows (H100 SXM, 700 W): W 3 584 0.159 ms,
// 0.88 of its bound; 2 x 3 584 0.314 ms, 0.89 (the plain path 1.86 / 3.99
// ms).  128 threads a block measured the same, 512 4 % slower at W 3 584.
// Against the plain version: bf16 within one ulp (3e-6 of the elements
// differ), fp32 within 4 ulps (the sum's order moves 1 / rms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_NV = 8;

struct Args {
  const void* x;      // (rows, W1), contiguous
  const void* tail;   // (rows, W - W1), contiguous; unread when W1 == W
  const void* scale;  // (W,)
  void* out;          // (rows, W)
  int W, W1;
  float inv_w, eps;   // 1 / W rounded to fp32
};

template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS) rms_norm_kernel(Args g) {
  const long long row = blockIdx.x;
  const int nv = g.W / V, n1 = g.W1 / V;
  const T* x = static_cast<const T*>(g.x) + row * g.W1;
  const T* tail = static_cast<const T*>(g.tail) + row * (g.W - g.W1);
  Row8<T> raw[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) raw[k] = load8(j < n1 ? x + j * V : tail + (j - n1) * V);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (threadIdx.x + k * blockDim.x < nv) {
      float f[V];
      unpack(raw[k], f);
#pragma unroll
      for (int v = 0; v < V; ++v) ss = __fadd_rn(ss, __fmul_rn(f[v], f[v]));
    }
  }
  const float r =
      rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), g.inv_w), g.eps));
  T* out = static_cast<T*>(g.out) + row * g.W;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
      float f[V], s[V], o[V];
      unpack(raw[k], f);
      load8(static_cast<const T*>(g.scale) + j * V, s);
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = __fmul_rn(__fmul_rn(f[v], r), s[v]);
      store8(out + j * V, o);
    }
  }
}

template <typename T, int NV>
int launch_nv(const Args& g, int rows, cudaStream_t stream) {
  const int threads = ((g.W / V + NV - 1) / NV + 31) / 32 * 32;
  rms_norm_kernel<T, NV><<<rows, threads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// the fewest vectors a thread that keep a block within MAX_THREADS
template <typename T>
int launch(const Args& g, int rows, cudaStream_t stream) {
  const int nv = g.W / V;
  if (nv <= MAX_THREADS) return launch_nv<T, 1>(g, rows, stream);
  if (nv <= 2 * MAX_THREADS) return launch_nv<T, 2>(g, rows, stream);
  if (nv <= 4 * MAX_THREADS) return launch_nv<T, 4>(g, rows, stream);
  return launch_nv<T, MAX_NV>(g, rows, stream);
}

}  // namespace

// the widest row the kernel takes
extern "C" int rms_norm_max_width() { return MAX_NV * MAX_THREADS * V; }

// x (rows, W1) and tail (rows, W - W1) contiguous (tail unread when W1 ==
// W), scale (W,), out (rows, W); dtype 0 fp32, 1 bf16
extern "C" int rms_norm_fwd(const void* x, const void* tail,
                            const void* scale, void* out, int rows, int W,
                            int W1, float eps, int dtype, void* stream) {
  if (rows < 1 || W1 < V || W1 > W || W % V || W1 % V ||
      W > rms_norm_max_width())
    return (int)cudaErrorInvalidValue;
  Args g{x, tail, scale, out, W, W1, 1.0f / (float)W, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, rows, s);
  return launch<__nv_bfloat16>(g, rows, s);
}

extern "C" const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
