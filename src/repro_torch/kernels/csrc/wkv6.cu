// RWKV6 WKV recurrence for Hopper (sm_90a): the chunked closed form with
// data-dependent per-channel decay, fp32 math on the CUDA cores.
//
// Replaces the TPU kernel in src/repro/kernels/wkv6.py:
//   wkv6 (pallas_call at :106) with _wkv_kernel (:36).
//
// What it computes, per (b, head h), from a zero (P, P) state S (rows key p,
// columns value q), over chunks of Q <= 32 steps (rows past the sequence end
// read as zero, w = 0 there):
//   cum_i  = w_0 + ... + w_i  (per key channel p),   cx_i = cum_i - w_i
//   out_i  = (r_i * exp(cx_i)) . S
//            + sum_{j < i} [sum_p r_ip k_jp exp(cx_ip - cum_jp)] v_j
//            + (sum_p r_ip u_p k_ip) v_i
//   S'     = diag(exp(cum_{Q-1})) S + sum_j (k_j * exp(cum_{Q-1} - cum_j)) (x) v_j
// and writes out (B, S, H, P) fp32 and the final S (B, H, P, P) fp32.  Every
// exponent used is <= 0.  The TPU kernel builds the (Q, Q, P) tensor
// E = exp(cx_i - cum_j) for all (i, j) and selects zero for j >= i, where
// the argument is >= 0 and can overflow; here the pair term is formed for
// j < i only, with a loop over p, and E is never materialized (at Q = 32,
// P = 64 it would be 256 KB, over the 227 KB a block may have).
//
// Work layout.  Hopper has no sequential grid axis: one thread block owns one
// (b, h, tile of 32 value columns q) and loops over the chunks itself, its
// (P, 32) slice of the state in shared memory; the slice reaches global
// memory only after the last chunk.  The value columns of the state and the
// output are independent, so the tiles need nothing from each other; each
// recomputes the chunk's pair term A_ij, which needs every key channel.  At
// B = 1 that is H * P / 32 blocks (128 at rwkv6's width for 132 SMs, where
// one block per (b, h) would leave half the card idle).  A chunk is at most
// 32 rows so its cumulative sums are warp scans (lane = row).  Per chunk:
//   1. load r, k, w (Q x P) and the v tile (Q x 32) into shared memory;
//   2. the warps scan w down the rows for the key channels (one channel per
//      warp at a time) and store cum, cx, r * exp(cx) and
//      k * exp(cum_{Q-1} - cum), and exp(cum_{Q-1});
//   3. A_ij for the pairs j < i, spread over all threads (a loop over p),
//      and the bonus term on the diagonal A_ii = sum_p r_ip u_p k_ip;
//   4. out_i = (r_i * exp(cx_i)) . S + sum_{j <= i} A_ij v_j  (lane = q);
//   5. the state update (lane = q, warps over p).
// Shared rows are padded to P + 1 floats so the row-strided reads of step 3
// fall in distinct banks.  Shared memory at P = 64: six 32 x 65 row arrays,
// the v tile 32 x 32, A 32 x 33, the state slice 64 x 32, u and
// exp(cum_{Q-1}): 66 944 bytes.  Operands are read through element strides
// (b, s, h) with a contiguous P.
//
// Bound.  Per (b, h) and chunk: the pair term's Q (Q - 1) / 2 x P multiply-
// adds and exponentials, the inter-chunk and state terms 2 Q P^2 multiply-
// adds; against r, k, v (2 bytes each in bf16), w and out (4 each) read or
// written once.  At the path's shape the operations and the bytes bound it
// about equally (fp32 on the CUDA cores at 67 TFLOP/s; 3.35 TB/s).  This
// first design recomputes the pair term per value tile (its exponentials are
// the kernel's largest cost; they use the fast __expf, ex2.approx after a
// product with log2 e: a few ulps plus the rounding of that product, an
// error of the same form as the cumulative decay's own rounding, which the
// tolerance allows for), uses no tensor cores and does not overlap the
// loads with the arithmetic.  It builds without -fmad=false: it is held
// against its plain PyTorch version within a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 32;             // chunk rows: one warp
constexpr int PV = 32;                // value columns per block: one warp
constexpr int LDA = MAX_Q + 1;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  float* out;
  float* state;
  long long st[4][3];   // element strides (b, s, h) of r, k, v, w
  int S, H, Q;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (6 * (size_t)MAX_Q * (P + 1) + MAX_Q * PV +
                          MAX_Q * LDA + (size_t)P * PV + 2 * P);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS) wkv_kernel(Args g) {
  constexpr int LD = P + 1;
  constexpr int NT = P / PV;   // value tiles per head
  extern __shared__ float smem[];
  float* Rs = smem;              // MAX_Q x LD: r
  float* Ks = Rs + MAX_Q * LD;   // k
  float* Cm = Ks + MAX_Q * LD;   // w, then cum (inclusive)
  float* Cx = Cm + MAX_Q * LD;   // cum - w
  float* Re = Cx + MAX_Q * LD;   // r * exp(cx)
  float* Kw = Re + MAX_Q * LD;   // k * exp(cum_{Q-1} - cum)
  float* Vs = Kw + MAX_Q * LD;   // MAX_Q x PV: the v tile
  float* As = Vs + MAX_Q * PV;   // MAX_Q x LDA: pair and bonus terms
  float* St = As + MAX_Q * LDA;  // P x PV: the state slice
  float* Us = St + P * PV;       // P: u
  float* Dk = Us + P;            // P: exp(cum_{Q-1})

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = (int)blockIdx.x / NT, q0 = ((int)blockIdx.x % NT) * PV;
  const int b = blockIdx.y;
  const int S = g.S, Q = g.Q;
  const T* rb = static_cast<const T*>(g.r) + b * g.st[0][0] + h * g.st[0][2];
  const T* kb = static_cast<const T*>(g.k) + b * g.st[1][0] + h * g.st[1][2];
  const T* vb = static_cast<const T*>(g.v) + b * g.st[2][0] + h * g.st[2][2];
  const float* wb = g.w + b * g.st[3][0] + h * g.st[3][2];
  float* ob = g.out + ((long long)b * S * g.H + h) * P + q0;   // contiguous

  for (int e = tid; e < P * PV; e += THREADS) St[e] = 0.f;
  for (int p = tid; p < P; p += THREADS) Us[p] = g.u[h * P + p];
  const int nc = (S + Q - 1) / Q;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the last chunk's readers are done
    // 1. the chunk's rows, zero past Q and past S
    for (int e = tid; e < MAX_Q * P; e += THREADS) {
      const int i = e / P, p = e % P, t = t0 + i;
      const bool in = i < Q && t < S;
      Rs[i * LD + p] = in ? to_f(rb[(long long)t * g.st[0][1] + p]) : 0.f;
      Ks[i * LD + p] = in ? to_f(kb[(long long)t * g.st[1][1] + p]) : 0.f;
      Cm[i * LD + p] = in ? wb[(long long)t * g.st[3][1] + p] : 0.f;
    }
    for (int e = tid; e < MAX_Q * PV; e += THREADS) {
      const int i = e / PV, q = e % PV, t = t0 + i;
      Vs[e] = (i < Q && t < S)
                  ? to_f(vb[(long long)t * g.st[2][1] + q0 + q]) : 0.f;
    }
    __syncthreads();

    // 2. cumulative log decay down the rows, one key channel per warp
    for (int p = warp; p < P; p += WARPS) {
      const float wv = Cm[lane * LD + p];
      float cs = wv;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, cs, off);
        if (lane >= off) cs += n;
      }
      const float last = __shfl_sync(0xffffffffu, cs, Q - 1);
      const float cx = cs - wv;
      Cm[lane * LD + p] = cs;
      Cx[lane * LD + p] = cx;
      Re[lane * LD + p] = Rs[lane * LD + p] * expf(cx);
      Kw[lane * LD + p] = Ks[lane * LD + p] * expf(last - cs);
      if (lane == 0) Dk[p] = expf(last);
    }
    __syncthreads();

    // 3. A_ij = sum_p r_ip k_jp exp(cx_ip - cum_jp) for the Q (Q - 1) / 2
    // pairs j < i, spread over all threads (pair e is row i, column
    // j = e - i (i - 1) / 2); the bonus term on the diagonal.  Above the
    // diagonal As is never read.
    const int npair = Q * (Q - 1) / 2;
    for (int e = tid; e < npair; e += THREADS) {
      int i = (int)(0.5f * (1.f + sqrtf(1.f + 8.f * (float)e)));
      while (i * (i - 1) / 2 > e) --i;
      while (i * (i + 1) / 2 <= e) ++i;
      const int j = e - i * (i - 1) / 2;
      float a = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p)
        a += Rs[i * LD + p] * Ks[j * LD + p] *
             __expf(Cx[i * LD + p] - Cm[j * LD + p]);
      As[i * LDA + j] = a;
    }
    for (int i = tid; i < Q; i += THREADS) {
      float a = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) a += Rs[i * LD + p] * Us[p] * Ks[i * LD + p];
      As[i * LDA + i] = a;
    }
    __syncthreads();

    // 4. out_i = (r_i * exp(cx_i)) . S + sum_{j <= i} A_ij v_j (lane = q)
    for (int i = warp; i < Q; i += WARPS) {
      float acc = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) acc += Re[i * LD + p] * St[p * PV + lane];
      for (int j = 0; j <= i; ++j) acc += As[i * LDA + j] * Vs[j * PV + lane];
      const int t = t0 + i;
      if (t < S) ob[(long long)t * g.H * P + lane] = acc;
    }
    __syncthreads();   // every reader of the old state is done

    // 5. S' = diag(exp(cum_{Q-1})) S + sum_j Kw_j (x) v_j (lane = q)
    for (int p = warp; p < P; p += WARPS) {
      float s = Dk[p] * St[p * PV + lane];
      for (int j = 0; j < Q; ++j) s += Kw[j * LD + p] * Vs[j * PV + lane];
      St[p * PV + lane] = s;
    }
  }
  __syncthreads();
  float* sb = g.state + ((long long)b * g.H + h) * P * P + q0;
  for (int e = tid; e < P * PV; e += THREADS)
    sb[(e / PV) * P + e % PV] = St[e];
}

template <typename T, int P>
int launch(const Args& g, int B, cudaStream_t stream) {
  auto kern = wkv_kernel<T, P>;
  const size_t smem = smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(g.H * (P / PV), B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(int P, const Args& g, int B, cudaStream_t stream) {
  switch (P) {
    case 32: return launch<T, 32>(g, B, stream);
    case 64: return launch<T, 64>(g, B, stream);
    case 128: return launch<T, 128>(g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// strides: 12 element strides, (b, s, h) for r, k, v and w in turn; the head
// dim P is contiguous in each, and u (H, P), out (B, S, H, P) and state
// (B, H, P, P) are contiguous fp32.  dtype: 0 = fp32, 1 = bf16 (r, k and v
// alike; w and u are fp32).  Returns the cudaError_t of the launch
// (0 = launched); cudaErrorInvalidValue for an unsupported P or chunk.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* out, void* state,
                        const long long* strides, int B, int S, int H, int P,
                        int Q, int dtype, void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  Args g;
  g.r = r;
  g.k = k;
  g.v = v;
  g.w = static_cast<const float*>(w);
  g.u = static_cast<const float*>(u);
  g.out = static_cast<float*>(out);
  g.state = static_cast<float*>(state);
  for (int t = 0; t < 4; ++t)
    for (int d = 0; d < 3; ++d) g.st[t][d] = strides[3 * t + d];
  g.S = S;
  g.H = H;
  g.Q = Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_p<float>(P, g, B, s);
  return launch_p<__nv_bfloat16>(P, g, B, s);
}

extern "C" int wkv6_max_chunk() { return MAX_Q; }

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
