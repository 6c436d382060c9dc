// Mamba2 SSD chunked scan for Hopper (sm_90a): fp32 math on the CUDA cores.
//
// Replaces the TPU kernel in src/repro/kernels/ssm_scan.py:
//   ssm_scan (pallas_call at :85) with _ssd_kernel (:27).
//
// What it computes, per (b, head h), from a zero (N, P) state S, over chunks
// of Q <= 256 steps (rows past the sequence end read as zero):
//   cum_i  = a_0 + ... + a_i                      (inclusive, within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x_j
//            + exp(cum_i) C_i . S                  (x_j, y_i: P-vectors)
//   S'     = exp(cum_{Q-1}) S + sum_j B_j (x) exp(cum_{Q-1} - cum_j) x_j
// and writes y (B, S, H, P) fp32 and the final S (B, H, N, P) fp32.  The decay
// exp(cum_i - cum_j) is formed only for j <= i, where its argument is <= 0:
// above the diagonal it reaches the chunk's whole log decay (about +2 800 at
// zamba2's A = -(1..112) and dt up to 0.1), whose exp is inf, and the TPU
// kernel's select-after-exp would be inf * 0 = NaN in a product here.
//
// Work layout.  Hopper has no sequential grid axis: one thread block owns one
// (b, h) and loops over the chunks itself, the running (N, P) state in shared
// memory; it reaches global memory only after the last chunk.  At B = 1 that
// is H blocks (112 at zamba2's width for 132 SMs).  A split of P over blocks
// would fill the card, but every block would then recompute the chunk's
// C . B^T scores, as much work as the P-wide product they feed, so each block
// does its whole head.  The chunk's Q x Q product does not fit in shared
// memory (256 KB in fp32 at Q = 256), so it is tiled like attention: for each
// 64-row block I of the chunk, y_I starts as exp(cum) C_I . S, then for each
// 64-row block J <= I the 64 x 64 tile (C_I B_J^T) * decay goes through
// shared memory into y_I += tile . x_J; the last block I, which visits every
// J, also accumulates the state update B_J^T (w * x_J) in registers.
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns rows ty + 16 r of a
// block (r < 4), tile columns tx + 16 c (c < 4), output columns tx + 16 c
// (c < P / 16) and state rows ty + 16 r (r < N / 16).  Shared rows of C and
// B are padded to N + 1 floats so the strided reads fall in distinct banks.
// Shared memory at N = P = 64: C and B tiles 2 x 64 x 65, x tile 64 x 64,
// score tile 64 x 65, state 64 x 64, and 3 x 256 per-row scalars (cum,
// exp(cum), exp(cum_{Q-1} - cum)): 85 760 bytes.
// Operands are read through element strides: x (b, s, h) and a (b, s, h)
// with a contiguous P; B and C (b, s) with a contiguous N, so the mamba
// block's column slices of one (B, S, 2N) tensor need no copy.
//
// Bound.  Operations: per (b, h) and chunk, the lower triangle of the Q x Q
// decayed product against x (Q^2 P / 2 multiply-adds) plus the inter-chunk
// and state terms (2 Q N P), with C . B^T needed once per (b, chunk) since
// B and C are shared by all heads; against x and y read or written once
// (8 bytes per element of x), so at the path's shape it is bound by fp32
// operations on the CUDA cores (67 TFLOP/s on an H100 SXM).  This first
// design recomputes the scores per head and computes whole 64 x 64 tiles on
// the diagonal (about 1.7 x the bound's operations), uses no tensor cores
// (tf32 or bf16 products would change the rounding the plain version is held
// to) and does not overlap the tile loads with the arithmetic.  It builds
// without -fmad=false: it is held against its plain PyTorch version within a
// tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread grid
constexpr int TR = 64;         // rows of a chunk block (I or J)
constexpr int RPT = TR / 16;   // block rows (and tile columns) per thread
constexpr int MAX_Q = 256;     // chunk rows: one block-wide scan

struct Args {
  const float* x;
  const float* a;
  const void* bm;
  const void* cm;
  float* y;
  float* state;
  long long xs_b, xs_s, xs_h;   // element strides; P contiguous
  long long as_b, as_s, as_h;
  long long bs_b, bs_s;         // N contiguous
  long long cs_b, cs_s;
  int S, H, Q;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, int P>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * (size_t)TR * (N + 1) + (size_t)TR * P +
                          (size_t)TR * (TR + 1) + (size_t)N * P + 3 * MAX_Q);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(THREADS) ssd_kernel(Args g) {
  constexpr int LDN = N + 1;
  constexpr int LDP = TR + 1;
  constexpr int PPT = P / 16;   // output columns per thread
  constexpr int NPT = N / 16;   // state rows per thread
  extern __shared__ float smem[];
  float* Cs = smem;              // TR x LDN: C rows of block I
  float* Bs = Cs + TR * LDN;     // TR x LDN: B rows of block J
  float* Xs = Bs + TR * LDN;     // TR x P:   x rows of block J
  float* Ps = Xs + TR * P;       // TR x LDP: the decayed score tile
  float* St = Ps + TR * LDP;     // N x P:    the carried state
  float* cum = St + N * P;       // MAX_Q: inclusive cumsum of a
  float* ecum = cum + MAX_Q;     // MAX_Q: exp(cum_i), 0 past Q
  float* wq = ecum + MAX_Q;      // MAX_Q: exp(cum_{Q-1} - cum_j), 0 past Q
  __shared__ float warp_sum[THREADS / 32];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = g.S, Q = g.Q;
  const float* xb = g.x + b * g.xs_b + h * g.xs_h;
  const float* ab = g.a + b * g.as_b + h * g.as_h;
  const T* bb = static_cast<const T*>(g.bm) + b * g.bs_b;
  const T* cb = static_cast<const T*>(g.cm) + b * g.cs_b;
  float* yb = g.y + ((long long)b * S * g.H + h) * P;   // y is contiguous

  for (int e = tid; e < N * P; e += THREADS) St[e] = 0.f;
  const int nc = (S + Q - 1) / Q;
  const int nblk = (Q + TR - 1) / TR;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();   // the last chunk's readers of cum, ecum and wq are done
    // inclusive scan of a over the chunk: warp scans, then the warps' sums
    float v = 0.f;
    if (tid < Q && t0 + tid < S) v = ab[(long long)(t0 + tid) * g.as_s];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_sum[w];
    cum[tid] = v;
    __syncthreads();
    const float total = cum[Q - 1];
    ecum[tid] = tid < Q ? expf(v) : 0.f;
    wq[tid] = tid < Q ? expf(total - v) : 0.f;

    for (int I = 0; I < nblk; ++I) {
      const int i0 = I * TR;
      const bool last = I == nblk - 1;
      __syncthreads();   // the last block's readers of Cs are done
      for (int e = tid; e < TR * N; e += THREADS) {
        const int r = e / N, n = e % N;
        const int i = i0 + r, t = t0 + i;
        Cs[r * LDN + n] =
            (i < Q && t < S) ? to_f(cb[(long long)t * g.cs_s + n]) : 0.f;
      }
      __syncthreads();   // Cs and (at I = 0) ecum / wq are stored

      // inter-chunk term: y_i = exp(cum_i) C_i . S
      float acc[RPT][PPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < PPT; ++q) acc[r][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[RPT], sv[PPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) cv[r] = Cs[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int q = 0; q < PPT; ++q) sv[q] = St[n * P + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int q = 0; q < PPT; ++q) acc[r][q] += cv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < MAX_Q ? ecum[i] : 0.f;
#pragma unroll
        for (int q = 0; q < PPT; ++q) acc[r][q] *= e;
      }

      float st[NPT][PPT];   // the last block's state update
#pragma unroll
      for (int r = 0; r < NPT; ++r)
#pragma unroll
        for (int q = 0; q < PPT; ++q) st[r][q] = 0.f;

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * TR;
        __syncthreads();   // the last tile's readers of Bs, Xs and Ps are done
        for (int e = tid; e < TR * N; e += THREADS) {
          const int r = e / N, n = e % N;
          const int j = j0 + r, t = t0 + j;
          Bs[r * LDN + n] =
              (j < Q && t < S) ? to_f(bb[(long long)t * g.bs_s + n]) : 0.f;
        }
        for (int e = tid; e < TR * P; e += THREADS) {
          const int r = e / P, p = e % P;
          const int j = j0 + r, t = t0 + j;
          Xs[e] = (j < Q && t < S) ? xb[(long long)t * g.xs_s + p] : 0.f;
        }
        __syncthreads();

        // the score tile (C_I B_J^T) * decay, zero above the diagonal
        float s[RPT][RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int q = 0; q < RPT; ++q) s[r][q] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[RPT], bv[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) cv[r] = Cs[(ty + 16 * r) * LDN + n];
#pragma unroll
          for (int q = 0; q < RPT; ++q) bv[q] = Bs[(tx + 16 * q) * LDN + n];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int q = 0; q < RPT; ++q) s[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            const int j = j0 + tx + 16 * q;
            // mask before the exponential: cum_i - cum_j <= 0 for j <= i
            const float d = (j <= i && i < Q) ? expf(cum[i] - cum[j]) : 0.f;
            Ps[(ty + 16 * r) * LDP + tx + 16 * q] = s[r][q] * d;
          }
        }
        __syncthreads();

        // y_I += tile . x_J
#pragma unroll 4
        for (int jj = 0; jj < TR; ++jj) {
          float pv[RPT], xv[PPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) pv[r] = Ps[(ty + 16 * r) * LDP + jj];
#pragma unroll
          for (int q = 0; q < PPT; ++q) xv[q] = Xs[jj * P + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int q = 0; q < PPT; ++q) acc[r][q] += pv[r] * xv[q];
        }
        if (last) {   // S' += B_J^T (w * x_J)
#pragma unroll 4
          for (int jj = 0; jj < TR; ++jj) {
            const float wj = wq[j0 + jj];
            float bv[NPT], xv[PPT];
#pragma unroll
            for (int r = 0; r < NPT; ++r)
              bv[r] = Bs[jj * LDN + ty + 16 * r] * wj;
#pragma unroll
            for (int q = 0; q < PPT; ++q) xv[q] = Xs[jj * P + tx + 16 * q];
#pragma unroll
            for (int r = 0; r < NPT; ++r)
#pragma unroll
              for (int q = 0; q < PPT; ++q) st[r][q] += bv[r] * xv[q];
          }
        }
      }

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty + 16 * r, t = t0 + i;
        if (i >= Q || t >= S) continue;
        float* yrow = yb + (long long)t * g.H * P;
#pragma unroll
        for (int q = 0; q < PPT; ++q) yrow[tx + 16 * q] = acc[r][q];
      }
      if (last) {
        // every thread read St (the inter-chunk term) before the J loop's
        // barriers, and each thread updates only its own entries
        const float et = expf(total);
#pragma unroll
        for (int r = 0; r < NPT; ++r)
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            float* sp = St + (ty + 16 * r) * P + tx + 16 * q;
            *sp = et * *sp + st[r][q];
          }
      }
    }
  }
  __syncthreads();
  float* sb = g.state + ((long long)b * g.H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) sb[e] = St[e];
}

template <typename T, int N, int P>
int launch(const Args& g, int B, cudaStream_t stream) {
  auto kern = ssd_kernel<T, N, P>;
  const size_t smem = smem_bytes<N, P>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(g.H, B), THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_n(int N, const Args& g, int B, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16, P>(g, B, stream);
    case 32: return launch<T, 32, P>(g, B, stream);
    case 64: return launch<T, 64, P>(g, B, stream);
    case 128: return launch<T, 128, P>(g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_np(int N, int P, const Args& g, int B, cudaStream_t stream) {
  switch (P) {
    case 32: return launch_n<T, 32>(N, g, B, stream);
    case 64: return launch_n<T, 64>(N, g, B, stream);
    case 128: return launch_n<T, 128>(N, g, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// strides: 10 element strides — x (b, s, h), a (b, s, h), Bm (b, s),
// Cm (b, s); x's P and Bm / Cm's N are contiguous.  y (B, S, H, P) and
// state (B, H, N, P) are contiguous fp32.  bc_dtype: 0 = fp32, 1 = bf16 (Bm
// and Cm alike).  Returns the cudaError_t of the launch (0 = launched);
// cudaErrorInvalidValue for an unsupported N, P or chunk.
extern "C" int ssm_scan_fwd(const void* x, const void* a, const void* bm,
                            const void* cm, void* y, void* state,
                            const long long* strides, int B, int S, int H,
                            int P, int N, int Q, int bc_dtype, void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  Args g{static_cast<const float*>(x), static_cast<const float*>(a), bm, cm,
         static_cast<float*>(y), static_cast<float*>(state),
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         S, H, Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch_np<float>(N, P, g, B, s);
  return launch_np<__nv_bfloat16>(N, P, g, B, s);
}

extern "C" int ssm_scan_max_chunk() { return MAX_Q; }

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
