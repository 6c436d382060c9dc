// The Mamba2 layer's elementwise chain around the SSD scan, for Hopper
// (sm_90a): a prologue from the fused input projection to the scan's
// operands, and an epilogue from the scan's output to the out projection's
// input (models/hybrid.py, mamba_forward).
//
// Replaces no TPU kernel: the reference leaves this chain to XLA, which
// fuses it.  The port's plain PyTorch ran it as ~25 launches a layer, each
// reading and writing a whole (B, S, ~7 000) tensor, many through strided
// views: 38.6 GB a layer at Zamba2-7B-Instruct's prefill of 8 x 4 096 tokens.
//
// mamba_in_kernel, from the strided x B C columns (B, S, C) and dt (B, S, H)
// of the projection, in its dtype T (bf16 or fp32):
//   out = silu(conv(xBC) + b)   depthwise causal convolution over K = 4 taps,
//         zeros before position 0; each product and each partial sum rounded
//         to T, summed in the order i = 0..K-1, + b in T, SiLU in fp32 and
//         rounded to T                               -> (B, S, C) T
//   dt  = softplus(float(dt) + dt_bias), PyTorch's threshold 20
//   a   = dt * -exp(A_log)                           -> (B, S, H) fp32
//   xdt = float(out[..., :Din]) * dt                 -> (B, S, H, P) fp32
// mamba_out_kernel, per (b, s, group of W = Din / G columns):
//   h   = (y + float(xs) * D) * silu(float(z))
//   out = T(h * rsqrt(mean_W(h * h) + eps) * float(gate_norm))
//                                                    -> (B, S, Din) T
// Each operation is the plain PyTorch path's, in its order, with PyTorch's
// formulas (silu x / (1 + expf(-x)), softplus log1pf(expf(x)), rsqrtf, the
// mean as the sum times 1/W), and every multiply, add and divide is an
// explicit round-to-nearest intrinsic, never contracted.  So the prologue is
// bitwise the plain path; the epilogue differs only by the order of its
// W-term fp32 sum of squares.  Built with -fmad=false all the same.
//
// Bound: bytes.  At the prefill's layer (B 8, S 4 096, C 7 424, Din 7 168,
// H 112, G 2) the prologue reads x B C (486.5 MB) and dt and writes out
// (486.5 MB), xdt (939.5 MB) and a: 1.93 GB, 0.58 ms at 3.35 TB/s; the
// epilogue reads y (939.5 MB), xs and z (469.8 MB each) and writes h
// (469.8 MB): 2.35 GB, 0.70 ms.  A few SFU calls an element, no reuse.
//
// Design.  Every row is read 16 bytes (8 elements) at a time, a warp's
// threads on 512 contiguous bytes, through the views' element strides, so
// the projection's column slices need no copy (16-byte aligned rows, which
// the wrapper ensures).  Prologue: a thread owns 8 columns of IN_ROWS = 32
// consecutive positions of one sequence and walks down them with the K - 1
// previous input rows raw in registers (a bf16 row is 4 registers, unpacked
// element by element; K - 1 extra row reads per 32, mostly from L2),
// issuing the loads of IN_AHEAD = 4 rows before their arithmetic; a thread
// of the first Din columns also forms its head's dt for each row (its 8
// columns lie in one head: P % 8 == 0) and writes xdt, and the head's first
// thread writes a.  Epilogue: one block per (b, s, group); a thread holds
// CH x 8 columns of h in registers across a block-wide sum of squares (warp
// shuffles, one shared word a warp), then scales and stores them;
// W = 3 584 is 448 threads of 8 columns, CH 1.
//
// Measured at that layer (H100 SXM, 700 W): the prologue 1.09-1.10 ms,
// 0.53 of its bound, the epilogue 0.75 ms, 0.93.  The prologue issues ~55
// instructions an element at the plain path's rounding points (five bf16
// roundings, expf and an IEEE divide), about as long as its bytes take;
// 64-80 registers for more blocks an SM, 2 or 8 rows a batch, 16 or 64
// rows a thread, and each batch's loads issued a batch ahead all measured
// within 2 % of this or slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int K = 4;               // convolution taps
constexpr int IN_THREADS = 128;
constexpr int IN_ROWS = 32;        // positions a prologue thread walks
constexpr int IN_AHEAD = 4;        // rows whose loads are issued together
constexpr int OUT_MAX_THREADS = 512;

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

// x rounded to T, as a float
__device__ __forceinline__ float rnd(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float rnd(float x, const float*) { return x; }

// PyTorch's fp32 SiLU
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

struct InArgs {
  const void* x;        // (B, S, C) x B C, element strides x_b, x_s
  const void* dt;       // (B, S, H), element strides dt_b, dt_s
  const void* w;        // (K, C)
  const void* bias;     // (C,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  void* out;            // (B, S, C)
  float* xdt;           // (B, S, Din)
  float* a;             // (B, S, H)
  long long x_b, x_s, dt_b, dt_s;
  int S, C, Din, H, P, tiles;   // tiles: IN_ROWS-position tiles a sequence
};

// element v of a raw row, as a float (v a constant once unrolled)
__device__ __forceinline__ float elem(const Row8<__nv_bfloat16>& r, int v) {
  const unsigned w = v < 2 ? r.u[0].x : v < 4 ? r.u[0].y
                                      : v < 6 ? r.u[0].z : r.u[0].w;
  return __uint_as_float(v & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ float elem(const Row8<float>& r, int v) {
  const uint4& q = r.u[v >> 2];
  const int k = v & 3;
  return __uint_as_float(k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w);
}

template <typename T>
__device__ __forceinline__ Row8<T> zero_row() {
  Row8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.u[i] = make_uint4(0, 0, 0, 0);
  return r;
}

// Rows, weights and bias stay raw in registers (a bf16 row is 4 registers)
// and are unpacked element by element as the arithmetic reads them.
template <typename T>
__global__ void __launch_bounds__(IN_THREADS) mamba_in_kernel(InArgs g) {
  const int c0 = (blockIdx.y * IN_THREADS + threadIdx.x) * V;
  if (c0 >= g.C) return;
  const T* tag = nullptr;
  const long long b = blockIdx.x / g.tiles;
  const int s0 = (blockIdx.x % g.tiles) * IN_ROWS;
  const int s1 = min(s0 + IN_ROWS, g.S);
  const T* x = static_cast<const T*>(g.x) + b * g.x_b + c0;
  Row8<T> w[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    w[i] = load8(static_cast<const T*>(g.w) + i * g.C + c0);
  const Row8<T> bias = load8(static_cast<const T*>(g.bias) + c0);
  const bool inner = c0 < g.Din;
  const int h = inner ? c0 / g.P : 0;
  const bool first = inner && c0 % g.P == 0;
  float dtb = 0.f, nega = 0.f;
  if (inner) {
    dtb = g.dt_bias[h];
    nega = -expf(g.A_log[h]);
  }
  const T* dtp = static_cast<const T*>(g.dt) + b * g.dt_b + h;
  // the K - 1 input rows before the current one, zeros before position 0
  Row8<T> win[K - 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int s = s0 - (K - 1) + j;
    win[j] = s >= 0 ? load8(x + s * g.x_s) : zero_row<T>();
  }
  const long long row0 = b * g.S;
  T* out = static_cast<T*>(g.out) + row0 * g.C + c0;
  float* xdt = g.xdt + row0 * g.Din + c0;
  float* a = g.a + row0 * g.H + h;
  for (int s = s0; s < s1; s += IN_AHEAD) {
    Row8<T> raw[IN_AHEAD];
    float dtr[IN_AHEAD];
#pragma unroll
    for (int r = 0; r < IN_AHEAD; ++r) {
      if (s + r < s1) {
        raw[r] = load8(x + (s + r) * g.x_s);
        if (inner) dtr[r] = load1(dtp + (s + r) * g.dt_s);
      }
    }
#pragma unroll
    for (int r = 0; r < IN_AHEAD; ++r) {
      if (s + r >= s1) break;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = rnd(__fmul_rn(elem(win[0], v), elem(w[0], v)), tag);
#pragma unroll
        for (int i = 1; i < K; ++i) {
          const float xi = elem(i < K - 1 ? win[i] : raw[r], v);
          acc = rnd(__fadd_rn(acc, rnd(__fmul_rn(xi, elem(w[i], v)), tag)),
                    tag);
        }
        acc = rnd(__fadd_rn(acc, elem(bias, v)), tag);
        o[v] = rnd(silu(acc), tag);
      }
      const long long t = s + r;
      store8(out + t * g.C, o);
      if (inner) {
        const float d = __fadd_rn(dtr[r], dtb);
        const float dt = d > 20.0f ? d : log1pf(expf(d));
        float xd[V];
#pragma unroll
        for (int v = 0; v < V; ++v) xd[v] = __fmul_rn(o[v], dt);
        store8(xdt + t * g.Din, xd);
        if (first) a[t * g.H] = __fmul_rn(dt, nega);
      }
#pragma unroll
      for (int j = 0; j < K - 2; ++j) win[j] = win[j + 1];
      win[K - 2] = raw[r];
    }
  }
}

struct OutArgs {
  const float* y;   // (B, S, Din)
  const void* xs;   // (B, S, Din), element strides xs_b, xs_s
  const void* z;    // (B, S, Din), element strides z_b, z_s
  const float* D;   // (H,)
  const void* gn;   // (Din,)
  void* out;        // (B, S, Din)
  long long xs_b, xs_s, z_b, z_s;
  int S, Din, P, G, W;
  float inv_w, eps;  // 1 / W rounded to fp32, as PyTorch's mean scales
};

template <typename T, int CH>
__global__ void __launch_bounds__(OUT_MAX_THREADS) mamba_out_kernel(
    OutArgs g) {
  const long long row = blockIdx.x / g.G;   // b * S + s
  const int grp = blockIdx.x % g.G;
  const long long b = row / g.S, s = row % g.S;
  const int nv = g.W / V;
  const T* xs = static_cast<const T*>(g.xs) + b * g.xs_b + s * g.xs_s;
  const T* z = static_cast<const T*>(g.z) + b * g.z_b + s * g.z_s;
  float hv[CH][V];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
      const int c = grp * g.W + j * V;
      float yv[V], xv[V], zv[V];
      load8(g.y + row * g.Din + c, yv);
      load8(xs + c, xv);
      load8(z + c, zv);
      const float d = g.D[c / g.P];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float t = __fadd_rn(yv[v], __fmul_rn(xv[v], d));
        hv[k][v] = __fmul_rn(t, silu(zv[v]));
        ss = __fadd_rn(ss, __fmul_rn(hv[k][v], hv[k][v]));
      }
    }
  }
  const float r =
      rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), g.inv_w), g.eps));
  T* out = static_cast<T*>(g.out) + row * g.Din;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nv) {
      const int c = grp * g.W + j * V;
      float gv[V], o[V];
      load8(static_cast<const T*>(g.gn) + c, gv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = __fmul_rn(__fmul_rn(hv[k][v], r), gv[v]);
      store8(out + c, o);
    }
  }
}

template <typename T>
int launch_in(const InArgs& g, int B, cudaStream_t stream) {
  const dim3 grid(B * g.tiles, (g.C / V + IN_THREADS - 1) / IN_THREADS);
  mamba_in_kernel<T><<<grid, IN_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int launch_out_ch(const OutArgs& g, int rows, cudaStream_t stream) {
  const int nv = g.W / V;
  const int threads = ((nv + CH - 1) / CH + 31) / 32 * 32;
  mamba_out_kernel<T, CH><<<rows * g.G, threads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// the fewest columns a thread (CH x 8) that keep a block within
// OUT_MAX_THREADS
template <typename T>
int launch_out(const OutArgs& g, int rows, cudaStream_t stream) {
  const int nv = g.W / V;
  if (nv <= OUT_MAX_THREADS) return launch_out_ch<T, 1>(g, rows, stream);
  if (nv <= 2 * OUT_MAX_THREADS) return launch_out_ch<T, 2>(g, rows, stream);
  if (nv <= 4 * OUT_MAX_THREADS) return launch_out_ch<T, 4>(g, rows, stream);
  if (nv <= 8 * OUT_MAX_THREADS) return launch_out_ch<T, 8>(g, rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: x_b, x_s, dt_b, dt_s (elements); dtype 0 fp32, 1 bf16
extern "C" int mamba_in_fwd(const void* x, const void* dt, const void* w,
                            const void* bias, const void* dt_bias,
                            const void* A_log, void* out, void* xdt, void* a,
                            const long long* strides, int B, int S, int C,
                            int Din, int H, int P, int taps, int dtype,
                            void* stream) {
  if (taps != K || C % V || P % V || Din != H * P || Din > C || B < 1 ||
      S < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (S + IN_ROWS - 1) / IN_ROWS;
  InArgs g{x, dt, w, bias, static_cast<const float*>(dt_bias),
           static_cast<const float*>(A_log), out, static_cast<float*>(xdt),
           static_cast<float*>(a), strides[0], strides[1], strides[2],
           strides[3], S, C, Din, H, P, tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_in<float>(g, B, s);
  return launch_in<__nv_bfloat16>(g, B, s);
}

// strides: xs_b, xs_s, z_b, z_s (elements); dtype 0 fp32, 1 bf16
extern "C" int mamba_out_fwd(const void* y, const void* xs, const void* z,
                             const void* D, const void* gn, void* out,
                             const long long* strides, int B, int S, int Din,
                             int P, int G, float eps, int dtype,
                             void* stream) {
  if (G < 1 || Din % G || (Din / G) % V || P % V || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int W = Din / G;
  OutArgs g{static_cast<const float*>(y), xs, z,
            static_cast<const float*>(D), gn, out, strides[0], strides[1],
            strides[2], strides[3], S, Din, P, G, W, 1.0f / (float)W, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_out<float>(g, B * S, s);
  return launch_out<__nv_bfloat16>(g, B * S, s);
}

extern "C" const char* mamba_glue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
