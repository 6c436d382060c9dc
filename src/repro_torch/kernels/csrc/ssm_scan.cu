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
// B and C come in G groups (Mamba2's n_groups): head h reads group
// h / (H / G), so C . B^T is formed once per (b, group, chunk) and shared by
// the group's H / G heads.  G = 1 is the same arithmetic at offset zero.
//
// Bound.  Operations: per (b, group, chunk) the lower triangle of C . B^T;
// per (b, h, chunk) the decayed
// Q x Q product against x (Q^2 P / 2 multiply-adds), the inter-chunk term and
// the chunk's state contribution (Q N P each); against x and y read or
// written once (8 bytes per element of x).  At the path's shape (B 1, S 8 192,
// H 112, P = N = 64, Q 256) that is ~31 Gflop against ~0.5 GB: bound by fp32
// operations on the CUDA cores (67 TFLOP/s on an H100 SXM), 0.46 ms.
//
// Design.  A block per (b, h) walking its chunks in series would give 112
// blocks for 132 SMs at B = 1 and form C . B^T once per head.  So the work
// is taken apart along chunks, as Mamba2's own GPU SSD does, in four
// launches on one stream (scratch from the wrapper, torch.empty):
//   1. ssd_cb_kernel, per (b, group, chunk, 64 x 64 tile J <= I): G^T =
//      B_J C_I^T into cb (B, G, nc, Q, ldq), j-major so step 4 reads it row
//      by row; only tiles on or below the diagonal are formed or read.
//   2. ssd_state_kernel, per (b, h, chunk): the inclusive cumulative sum of
//      a into cum (B, H, nc, Q), then dS_c = B^T diag(exp(cum_{Q-1} - cum)) x
//      into st (B, nc, H, N, P), chunk-major: step 3's threads of all heads
//      then walk one contiguous region per chunk.
//   3. ssd_pass_kernel, per (b, h), a thread per entry of the (N, P) state,
//      in chunk order: S_c = exp(cum_{Q-1}) S_{c-1} + dS_c; st[c] is
//      overwritten by S_{c-1}, the state entering chunk c (so the scratch is
//      one (N, P) per chunk, not two), and the last S is the final state.
//      Its loads go eight chunks at a time, so the serial chain waits on
//      memory once per eight chunks.
//   4. ssd_out_kernel, per (b, h, chunk, 64-row block I), longest first:
//      y_I = exp(cum_I) C_I . S_{c-1} + sum_{J <= I} (G_IJ o decay) x_J, the
//      decay masked to zero above the diagonal BEFORE the exponential (then
//      exp by the fast exp2 unit, __expf: its argument is <= 0 there, and its
//      error, ~6e-8 |argument| relative, stays far inside the tolerance's
//      2^-20 * chunk decay term); y is written once.
// At B = 1 that is 3 584 blocks in step 2 and 14 336 in step 4, not 112.
// Every product is tile_mma: a thread owns an 8 x 8 register tile (rows
// 8 ty + {0..7}, so a warp's rows are one band; columns 4 tx + {0..3} and
// C/2 + 4 tx + {0..3}), and each step of the reduction reads two float4 of
// each operand from shared memory, laid out k-major (a quarter-warp reads
// one broadcast address of A and 128 contiguous bytes of B): 64 FMAs per
// four 16-byte loads.  On a diagonal tile of step 4 a warp stops the
// reduction at its band's last row, past which the decayed tile is zero.  Every global tile is read with 16-byte loads, several in
// flight per thread before their shared-memory stores; the
// operands that must be transposed into shared memory (C and B rows) go
// through a row pitch of 68 floats (a 4-way bank conflict on the store, none
// on the float4 reads).  Loads are not overlapped with the arithmetic inside
// a block; several blocks per SM do that.  No tensor cores: tf32 or bf16
// products would change the rounding the plain version is held to.
// Operands are read through element strides: x (b, s, h) and a (b, s, h)
// with a contiguous P (x 16-byte aligned, which the wrapper ensures); B and
// C (b, s) with a contiguous N, so the mamba block's column slices of one
// (B, S, 2N) tensor need no copy; their rows are read 16 bytes at a time
// (16-byte aligned, which the wrapper ensures).  It builds without -fmad=false: it is held
// against its plain PyTorch version within a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;          // rows of a chunk tile (i or j)
constexpr int LDT = TR + 4;     // row pitch of a transposed tile in shared memory
constexpr int MAX_Q = 256;      // chunk rows
constexpr int PASS_THREADS = 256;

struct Args {
  const float* x;
  const float* a;
  const void* bm;
  const void* cm;
  float* y;
  float* state;
  float* cb;    // (B, G, nc, Q, ldq): cb[j][i] = C_i . B_j for tiles J <= I
  float* cum;   // (B, H, nc, Q): inclusive cumulative sum of a per chunk
  float* st;    // (B, nc, H, N, P): dS_c, then the state entering chunk c
  long long xs_b, xs_s, xs_h;   // element strides; P contiguous
  long long as_b, as_s, as_h;
  long long bs_b, bs_s;         // N contiguous
  long long cs_b, cs_s;
  long long bs_g, cs_g;         // the group's stride (0 when G = 1)
  int S, H, Q, nc, ldq;   // ldq: Q rounded up to a multiple of 4
  int G, hpg;             // B / C groups, heads per group
};

// A thread (ty, tx) of a product owns the 8 rows 8 ty + r (a warp's rows
// are one band) and the 8 columns tile_col(q, tx, CH): 4 tx + {0..3} and
// CH + 4 tx + {0..3}, so a quarter-warp reads 128 contiguous bytes of B.
__device__ __forceinline__ int tile_col(int q, int tx, int half) {
  return (q < 4 ? 0 : half) + 4 * tx + (q & 3);
}

// acc[r][q] += sum_{k < K} A[k][row r] * B[k][col q], A and B k-major in
// shared memory (pitches lda, ldb).
template <int CH>
__device__ __forceinline__ void tile_mma(float (&acc)[8][8], const float* As,
                                         int lda, const float* Bs, int ldb,
                                         int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * lda + 8 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * lda + 8 * ty + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * ldb + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * ldb + CH + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
}

// 16 bytes of a B / C row as floats: 4 fp32 or 8 bf16 elements
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};
__device__ __forceinline__ void ld16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[k]);
    o[2 * k] = __low2float(b);
    o[2 * k + 1] = __high2float(b);
  }
}

// TR rows of an (S, N) operand from chunk row r0, zero past the chunk (Q) or
// the sequence (S), into shared memory: transposed dst[n * LDT + r] (TRANS)
// or as they are, dst[r * N + n].  16-byte loads, UB of them in flight per
// thread before their stores.
template <typename T, int N, int NT, bool TRANS>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int t0, int r0,
                                          int Q, int S) {
  constexpr int VN = Vec<T>::n, PER = N / VN, UB = 4;
  for (int e0 = threadIdx.x; e0 < TR * PER; e0 += UB * NT) {
    float v[UB][VN];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int e = e0 + u * NT, r = e / PER, n0 = VN * (e % PER);
      const int i = r0 + r, t = t0 + i;
      if (e < TR * PER && i < Q && t < S) {
        ld16(src + (long long)t * ss + n0, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VN; ++k) v[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int e = e0 + u * NT, r = e / PER, n0 = VN * (e % PER);
      if (e >= TR * PER) break;
      if (TRANS) {
#pragma unroll
        for (int k = 0; k < VN; ++k) dst[(n0 + k) * LDT + r] = v[u][k];
      } else {
#pragma unroll
        for (int k = 0; k < VN; k += 4)
          *reinterpret_cast<float4*>(dst + r * N + n0 + k) =
              make_float4(v[u][k], v[u][k + 1], v[u][k + 2], v[u][k + 3]);
      }
    }
  }
}

// TR rows of x (P floats each) from chunk row r0 into dst[r * P + p], each
// row times wr[r0 + r] when wr is given; zero past the chunk or the sequence.
// 16-byte loads, UB in flight per thread.
template <int P, int NT>
__device__ __forceinline__ void load_x(float* dst, const float* xb,
                                       long long xs, int t0, int r0, int Q,
                                       int S, const float* wr) {
  constexpr int PER = P / 4, UB = 4;
  for (int e0 = threadIdx.x; e0 < TR * PER; e0 += UB * NT) {
    float4 v[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int e = e0 + u * NT, r = e / PER, p = 4 * (e % PER);
      const int j = r0 + r, t = t0 + j;
      v[u] = (e < TR * PER && j < Q && t < S)
                 ? *reinterpret_cast<const float4*>(xb + (long long)t * xs + p)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int e = e0 + u * NT, r = e / PER;
      if (e >= TR * PER) break;
      if (wr != nullptr && r0 + r < Q) {
        const float wj = wr[r0 + r];
        v[u].x *= wj; v[u].y *= wj; v[u].z *= wj; v[u].w *= wj;
      }
      reinterpret_cast<float4*>(dst)[e] = v[u];
    }
  }
}

// ---- 1. C . B^T per (b, group, chunk), lower-triangle tiles ---------------
template <typename T, int N>
__global__ void __launch_bounds__(64) ssd_cb_kernel(Args g) {
  extern __shared__ float4 smem4[];
  float* BsT = reinterpret_cast<float*>(smem4);   // N x LDT
  float* CsT = BsT + N * LDT;                     // N x LDT
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int tile = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / g.G, grp = bg % g.G;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  const int J = tile - I * (I + 1) / 2;
  const int Q = g.Q, t0 = c * Q;
  load_rows<T, N, 64, true>(
      BsT, static_cast<const T*>(g.bm) + b * g.bs_b + grp * g.bs_g, g.bs_s,
      t0, J * TR, Q, g.S);
  load_rows<T, N, 64, true>(
      CsT, static_cast<const T*>(g.cm) + b * g.cs_b + grp * g.cs_g, g.cs_s,
      t0, I * TR, Q, g.S);
  __syncthreads();
  float acc[8][8];
  zero(acc);
  tile_mma<TR / 2>(acc, BsT, LDT, CsT, LDT, N, ty, tx);
  float* out = g.cb + ((long long)bg * g.nc + c) * Q * g.ldq;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = J * TR + 8 * ty + r;
    if (j >= Q) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = I * TR + tile_col(q, tx, TR / 2);
      if (i < Q) out[(long long)j * g.ldq + i] = acc[r][q];
    }
  }
}

// ---- 2. cum and dS per (b, h, chunk) ---------------------------------------
template <int N, int P>
__host__ __device__ constexpr int state_threads() { return (N / 8) * (P / 8); }

template <int N, int P>
__host__ __device__ constexpr size_t state_smem() {
  return sizeof(float) * ((size_t)TR * N + (size_t)TR * P + 2 * MAX_Q +
                          state_threads<N, P>());
}

template <typename T, int N, int P>
__global__ void __launch_bounds__((N / 8) * (P / 8))
ssd_state_kernel(Args g) {
  constexpr int NT = (N / 8) * (P / 8);
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // TR x N: B rows, k-major
  float* Ws = Bs + TR * N;                       // TR x P: w_j x_j
  float* cum = Ws + TR * P;                      // MAX_Q
  float* w = cum + MAX_Q;                        // MAX_Q
  float* part = w + MAX_Q;                       // NT
  const int tid = threadIdx.x, ty = tid / (P / 8), tx = tid % (P / 8);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = g.Q, S = g.S, t0 = c * Q;
  const long long bh = (long long)b * g.H + h;
  const float* ab = g.a + b * g.as_b + h * g.as_h;

  // inclusive scan of a over the chunk: a segment per thread, then the
  // segments' totals across the block (a warp scan, then the warps' sums)
  const int L = (Q + NT - 1) / NT;
  float run = 0.f;
  for (int k = 0; k < L; ++k) {
    const int i = tid * L + k;
    if (i < Q) {
      const int t = t0 + i;
      run += t < S ? ab[(long long)t * g.as_s] : 0.f;
      cum[i] = run;
    }
  }
  {
    constexpr unsigned MASK = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
    const int lane = tid & 31, warp = tid >> 5;
    float inc = run;
#pragma unroll
    for (int off = 1; off < 32 && off < NT; off <<= 1) {
      const float n = __shfl_up_sync(MASK, inc, off);
      if (lane >= off) inc += n;
    }
    float before = __shfl_up_sync(MASK, inc, 1);   // exclusive, in its warp
    if (lane == 0) before = 0.f;
    if (lane == 31 || tid == NT - 1) part[warp] = inc;
    __syncthreads();
    for (int k = 0; k < warp; ++k) before += part[k];
    __syncthreads();           // every thread has read the warps' sums
    part[tid] = before;
  }
  __syncthreads();
  float* cumg = g.cum + (bh * g.nc + c) * Q;
  for (int k = 0; k < L; ++k) {
    const int i = tid * L + k;
    if (i < Q) {
      const float v = cum[i] + part[tid];
      cum[i] = v;
      cumg[i] = v;
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int i = tid; i < Q; i += NT) w[i] = expf(total - cum[i]);

  const T* bb = static_cast<const T*>(g.bm) + b * g.bs_b +
                (h / g.hpg) * g.bs_g;
  const float* xb = g.x + b * g.xs_b + h * g.xs_h;
  float acc[8][8];
  zero(acc);
  for (int j0 = 0; j0 < Q; j0 += TR) {
    __syncthreads();   // w is stored; the last tile's readers are done
    load_rows<T, N, NT, false>(Bs, bb, g.bs_s, t0, j0, Q, S);
    load_x<P, NT>(Ws, xb, g.xs_s, t0, j0, Q, S, w);
    __syncthreads();
    tile_mma<P / 2>(acc, Bs, N, Ws, P, TR, ty, tx);
  }
  float* out = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = 8 * ty + r;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      *reinterpret_cast<float4*>(out + n * P + h2 * (P / 2) + 4 * tx) =
          make_float4(acc[r][4 * h2], acc[r][4 * h2 + 1], acc[r][4 * h2 + 2],
                      acc[r][4 * h2 + 3]);
  }
}

// ---- 3. the state pass per (b, h), in chunk order --------------------------
template <int N, int P>
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass_kernel(Args g) {
  constexpr int UB = 8;   // chunks whose loads are in flight together
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= N * P) return;
  const int b = blockIdx.z, h = blockIdx.y;
  const long long bh = (long long)b * g.H + h;
  const long long cs = (long long)g.H * N * P;   // one chunk of st
  float* sp = g.st + ((long long)b * g.nc * g.H + h) * N * P + e;
  const float* tot = g.cum + bh * g.nc * g.Q + (g.Q - 1);
  float s = 0.f;
  for (int c0 = 0; c0 < g.nc; c0 += UB) {
    float d[UB], f[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int c = c0 + u;
      d[u] = c < g.nc ? sp[c * cs] : 0.f;
      f[u] = c < g.nc ? tot[(long long)c * g.Q] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int c = c0 + u;
      if (c >= g.nc) break;
      sp[c * cs] = s;   // the state entering chunk c
      s = fmaf(expf(f[u]), s, d[u]);
    }
  }
  g.state[bh * N * P + e] = s;
}

// ---- 4. y per (b, h, chunk, 64-row block) ----------------------------------
template <int N, int P>
constexpr size_t out_smem() {
  constexpr size_t inter = (size_t)N * LDT + (size_t)N * P;
  constexpr size_t intra = (size_t)TR * TR + (size_t)TR * P;
  return sizeof(float) * ((inter > intra ? inter : intra) + 2 * TR);
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(P) ssd_out_kernel(Args g) {
  constexpr int NT = P;   // (TR / 8) x (P / 8) threads
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  float* CsT = buf;                 // N x LDT: C rows of block I, transposed
  float* Ss = buf + N * LDT;        // N x P: the state entering the chunk
  float* AsT = buf;                 // TR x TR: (G o decay)^T of tile (I, J)
  float* Xs = buf + TR * TR;        // TR x P: x rows of tile J
  constexpr size_t inter = (size_t)N * LDT + (size_t)N * P;
  constexpr size_t intra = (size_t)TR * TR + (size_t)TR * P;
  float* cumI = buf + (inter > intra ? inter : intra);
  float* ecumI = cumI + TR;
  const int tid = threadIdx.x, ty = tid / (P / 8), tx = tid % (P / 8);
  // one past the last row of this warp's band
  const int warp_rows = 8 * (((tid | 31) < NT ? (tid | 31) : NT - 1) / (P / 8) + 1);
  const int diag_k = warp_rows < TR ? warp_rows : TR;
  const int Q = g.Q, S = g.S;
  const int nb = (Q + TR - 1) / TR;
  const int I = nb - 1 - (int)(blockIdx.x % nb);   // longest blocks first
  const int c = blockIdx.x / nb, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, i0 = I * TR, grp = h / g.hpg;
  const long long bh = (long long)b * g.H + h;
  const float* cumg = g.cum + (bh * g.nc + c) * Q;
  const float* xb = g.x + b * g.xs_b + h * g.xs_h;

  for (int r = tid; r < TR; r += NT) {
    const bool in = i0 + r < Q;
    const float v = in ? cumg[i0 + r] : 0.f;
    cumI[r] = v;
    ecumI[r] = in ? expf(v) : 0.f;
  }
  load_rows<T, N, NT, true>(
      CsT, static_cast<const T*>(g.cm) + b * g.cs_b + grp * g.cs_g, g.cs_s,
      t0, i0, Q, S);
  const float* sg = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
#pragma unroll 4
  for (int e = tid; e < N * P / 4; e += NT)
    reinterpret_cast<float4*>(Ss)[e] = reinterpret_cast<const float4*>(sg)[e];
  __syncthreads();

  // inter-chunk term: exp(cum_i) C_i . S
  float acc[8][8];
  zero(acc);
  tile_mma<P / 2>(acc, CsT, LDT, Ss, P, N, ty, tx);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float e = ecumI[8 * ty + r];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] *= e;
  }

  // intra-chunk term over the tiles J <= I
  const float* cbc =
      g.cb + (((long long)b * g.G + grp) * g.nc + c) * Q * g.ldq;
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * TR;
    __syncthreads();   // the last product's readers are done
    // (G o decay)^T of the tile: 16-byte loads of cb rows, UB in flight with
    // their rows' cum_j; the decay masked before the exponential (cum_i -
    // cum_j <= 0 for j <= i), the unwritten entries (j > i past the diagonal
    // tile's, i >= Q) selected away, never multiplied
    constexpr int PER = TR / 4, UB = 8;
    for (int e0 = tid; e0 < TR * PER; e0 += UB * NT) {
      float4 v[UB];
      float cj[UB];
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int e = e0 + u * NT, jj = e / PER, ii = 4 * (e % PER);
        const int j = j0 + jj;
        const bool in = e < TR * PER && j < Q;
        v[u] = (in && i0 + ii < g.ldq)
                   ? *reinterpret_cast<const float4*>(
                         cbc + (long long)j * g.ldq + i0 + ii)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        cj[u] = in ? cumg[j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int e = e0 + u * NT, jj = e / PER, ii = 4 * (e % PER);
        if (e >= TR * PER) break;
        const int j = j0 + jj;
        const float gv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = i0 + ii + k;
          o[k] = (j <= i && i < Q) ? gv[k] * __expf(cumI[ii + k] - cj[u])
                                   : 0.f;
        }
        *reinterpret_cast<float4*>(AsT + jj * TR + ii) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    load_x<P, NT>(Xs, xb, g.xs_s, t0, j0, Q, S, nullptr);
    __syncthreads();
    // on the diagonal tile the decayed product is zero for j > i: a warp
    // stops at its band's last row
    tile_mma<P / 2>(acc, AsT, TR, Xs, P, J == I ? diag_k : TR, ty, tx);
  }

  float* yb = g.y + (long long)b * S * g.H * P + (long long)h * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 8 * ty + r, t = t0 + i;
    if (i >= Q || t >= S) continue;
    float* yrow = yb + (long long)t * g.H * P;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      *reinterpret_cast<float4*>(yrow + h2 * (P / 2) + 4 * tx) =
          make_float4(acc[r][4 * h2], acc[r][4 * h2 + 1], acc[r][4 * h2 + 2],
                      acc[r][4 * h2 + 3]);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int N, int P>
int launch(const Args& g, int B, cudaStream_t stream) {
  const int nb = (g.Q + TR - 1) / TR;
  cudaError_t err;
  {
    auto kern = ssd_cb_kernel<T, N>;
    const size_t smem = sizeof(float) * 2 * N * LDT;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(nb * (nb + 1) / 2, g.nc, B * g.G), 64, smem, stream>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  {
    auto kern = ssd_state_kernel<T, N, P>;
    const size_t smem = state_smem<N, P>();
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(g.nc, g.H, B), state_threads<N, P>(), smem, stream>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_pass_kernel<N, P><<<dim3((N * P + PASS_THREADS - 1) / PASS_THREADS,
                               g.H, B), PASS_THREADS, 0, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  {
    auto kern = ssd_out_kernel<T, N, P>;
    const size_t smem = out_smem<N, P>();
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(g.nc * nb, g.H, B), P, smem, stream>>>(g);
  }
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
// strides: 12 element strides — x (b, s, h), a (b, s, h), Bm (b, s),
// Cm (b, s), Bm's group, Cm's group; x's P and Bm / Cm's N are contiguous,
// x is 16-byte aligned with strides that are multiples of 4.  G groups of
// B / C, H a multiple of G.  y (B, S, H, P) and state (B, H, N, P)
// are contiguous fp32; scratch: cb (B, G, nc, Q, ldq), cum (B, H, nc, Q) and
// st (B, nc, H, N, P) fp32, nc = ceil(S / Q), ldq = Q rounded up to a
// multiple of 4.  bc_dtype: 0 = fp32, 1 = bf16 (Bm
// and Cm alike).  Launches four kernels on the stream; returns the first
// cudaError_t (0 = all launched); cudaErrorInvalidValue for an unsupported
// N, P, chunk or group count.
extern "C" int ssm_scan_fwd(const void* x, const void* a, const void* bm,
                            const void* cm, void* y, void* state, void* cb,
                            void* cum, void* st, const long long* strides,
                            int B, int S, int H, int P, int N, int Q, int G,
                            int bc_dtype, void* stream) {
  if (Q < 1 || Q > MAX_Q || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  Args g{static_cast<const float*>(x), static_cast<const float*>(a), bm, cm,
         static_cast<float*>(y), static_cast<float*>(state),
         static_cast<float*>(cb), static_cast<float*>(cum),
         static_cast<float*>(st),
         strides[0], strides[1], strides[2], strides[3], strides[4],
         strides[5], strides[6], strides[7], strides[8], strides[9],
         strides[10], strides[11],
         S, H, Q, (S + Q - 1) / Q, (Q + 3) / 4 * 4, G, H / G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch_np<float>(N, P, g, B, s);
  return launch_np<__nv_bfloat16>(N, P, g, B, s);
}

extern "C" int ssm_scan_max_chunk() { return MAX_Q; }

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
