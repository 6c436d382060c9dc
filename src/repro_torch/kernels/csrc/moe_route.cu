// A dropless top-k MoE layer's routing and its combine, for Hopper
// (sm_90a): the memory-bound ends of models/granite.py's expert layer.
//
// Replaces no TPU kernel: the reference's MoE (repro/models/moe.py) is a
// capacity MoE in plain jnp, and the port's copy of it (models/moe.py)
// stays bitwise with it.  A dropless prefill routes every (token, k) pair
// to its expert; in plain PyTorch that is a sort, a histogram, a scatter,
// a gather of T·k rows and, after the experts, an index_add_ (atomics, so
// the sum's order changes from run to run) and three elementwise passes
// over (T, M).
//
// moe_dispatch (three launches, counted as one call):
//   moe_dispatch_route_kernel    one warp a token: the top k of the
//       token's E fp32 router logits (larger first, ties to the lower
//       expert), the softmax over those k (m = the first, e_j =
//       expf(l_j - m), s = e_0 + e_1 + ... in order, gate_j = e_j / s);
//       each block a tile of TILE tokens marks, per expert, which of its
//       tokens chose it (a bit mask in shared memory, OR is order-free),
//       so each pair's rank among the tile's pairs of its expert is a
//       popcount, and the tile's count per expert is written.
//   moe_dispatch_offsets_kernel  one block: per expert, the tiles' counts
//       summed in tile order -> each tile's first row among the expert's,
//       the expert's count and the end of its rows (ends, the cumulative
//       counts, int32: what a grouped product reads on the device).
//   moe_dispatch_gather_kernel   one block a token: each of its k pairs'
//       row, pos = the expert's first row + the tile's first row among
//       them + the pair's rank (a stable permutation: within an expert,
//       rows in token order), and the token's row of x copied, read
//       once, to its k rows of xs.
// moe_combine (one launch), per token and column, in fp32, in k order:
//   acc = sum_j gate_j * rows[pos_j];  out = T(((acc + shared) * mult) +
//   residual)                          rounded once to the model dtype;
// no atomics, so the result does not depend on the run.  Every multiply
// and add is an explicit round-to-nearest intrinsic (built with
// -fmad=false as well), so the combine is bitwise its plain version
// (kernels/moe_route.py::moe_combine_plain) given the same gates.
//
// Bound: bytes.  At the granite_4_0_h_small.prefill_16k cell (T 16 384, M
// 4 096, E 72, k 10, bf16) the dispatch reads logits (4.7 MB) and x (134
// MB) once and writes xs (1 342 MB) and three (T, k) int32 / fp32 arrays
// (0.66 MB each: experts, gates, pos): 1.48 GB, 0.44 ms at 3.35 TB/s.  The combine reads the T·k
// rows (1 342 MB), shared and residual (134 MB each), the gates and pos
// (0.66 MB each) and writes out (134 MB): 1.74 GB, 0.52 ms.
//
// Design.  The gather and the combine move 16-byte vectors, neighbouring
// threads on neighbouring vectors (rows.cuh), each block a token: the
// gather loads a vector of x once and stores it k times; the combine
// issues its k row loads before any arithmetic.  The routing holds a
// tile's marks in shared memory (E x TILE/32 words) and the warp's top-k
// in registers (E <= MAX_EXPERTS, k <= MAX_TOPK).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int MAX_EXPERTS = 128;
constexpr int MAX_TOPK = 16;
constexpr int TILE = 64;               // tokens a routing block takes
constexpr int WORDS = TILE / 32;       // mask words an expert a tile
constexpr int ROUTE_WARPS = 8;
constexpr int MAX_THREADS = 512;

struct RouteArgs {
  const float* logits;  // (T, E)
  int* experts;         // (T, k)
  float* gates;         // (T, k)
  int* rank;            // (T, k) rank within (tile, expert)
  int* tile_rows;       // (tiles, E) the tile's count per expert
  int T, E, K;
};

// (v, e) before (w, f): larger value first, the lower expert on ties
__device__ __forceinline__ bool before(float v, int e, float w, int f) {
  return v > w || (v == w && e < f);
}

__global__ void __launch_bounds__(ROUTE_WARPS * 32)
    moe_dispatch_route_kernel(RouteArgs g) {
  __shared__ unsigned mask[MAX_EXPERTS][WORDS];
  __shared__ int chosen[TILE][MAX_TOPK];
  const int tile = blockIdx.x, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < MAX_EXPERTS * WORDS; i += blockDim.x)
    (&mask[0][0])[i] = 0u;
  __syncthreads();
  for (int j = warp; j < TILE; j += ROUTE_WARPS) {
    const long long t = (long long)tile * TILE + j;
    if (t >= g.T) break;
    const float* row = g.logits + t * g.E;
    float v[MAX_EXPERTS / 32];
    unsigned taken = 0u;
#pragma unroll
    for (int c = 0; c < MAX_EXPERTS / 32; ++c) {
      const int e = lane + 32 * c;
      v[c] = e < g.E ? row[e] : -INFINITY;
      if (isnan(v[c])) v[c] = -INFINITY;   // NaN ranks as -inf
    }
    float top[MAX_TOPK];
    int sel[MAX_TOPK];
#pragma unroll
    for (int k = 0; k < MAX_TOPK; ++k) {
      top[k] = 0.f;
      sel[k] = 0;
      if (k < g.K) {
        float bv = -INFINITY;
        int be = 0x7fffffff;
#pragma unroll
        for (int c = 0; c < MAX_EXPERTS / 32; ++c) {
          const int e = lane + 32 * c;
          if (e < g.E && !((taken >> c) & 1u) && before(v[c], e, bv, be)) {
            bv = v[c];
            be = e;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oe = __shfl_xor_sync(0xffffffffu, be, o);
          if (before(ov, oe, bv, be)) {
            bv = ov;
            be = oe;
          }
        }
        if ((be & 31) == lane) taken |= 1u << (be >> 5);
        top[k] = bv;
        sel[k] = be;
      }
    }
    // the softmax over the k chosen logits, in k order (every lane alike)
    float ex[MAX_TOPK];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_TOPK; ++k) {
      ex[k] = 0.f;
      if (k < g.K) {
        ex[k] = expf(__fsub_rn(top[k], top[0]));
        s = __fadd_rn(s, ex[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_TOPK; ++k) {
      if (k < g.K && k == lane) {
        g.experts[t * g.K + k] = sel[k];
        g.gates[t * g.K + k] = __fdiv_rn(ex[k], s);
        chosen[j][k] = sel[k];
        atomicOr(&mask[sel[k]][j >> 5], 1u << (j & 31));
      }
    }
  }
  __syncthreads();
  const long long first = (long long)tile * TILE;
  const int n = (int)min((long long)TILE, g.T - first);
  for (int i = threadIdx.x; i < n * g.K; i += blockDim.x) {
    const int j = i / g.K, e = chosen[j][i % g.K];
    int r = __popc(mask[e][j >> 5] & ((1u << (j & 31)) - 1u));
    for (int w = 0; w < (j >> 5); ++w) r += __popc(mask[e][w]);
    g.rank[(first + j) * g.K + i % g.K] = r;
  }
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) c += __popc(mask[e][w]);
    g.tile_rows[(long long)tile * g.E + e] = c;
  }
}

// one block of MAX_EXPERTS threads: tile_rows becomes each tile's first
// row for the expert among the expert's rows (the tiles' counts before it,
// read 8 tiles at a time so the loads overlap); counts and ends per expert
__global__ void __launch_bounds__(MAX_EXPERTS) moe_dispatch_offsets_kernel(
    int* tile_rows, int* counts, int* ends, int tiles, int E) {
  __shared__ int cnt[MAX_EXPERTS];
  const int e = threadIdx.x;
  int run = 0;
  if (e < E) {
    for (int t0 = 0; t0 < tiles; t0 += 8) {
      int c[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        c[q] = t0 + q < tiles ? tile_rows[(long long)(t0 + q) * E + e] : 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (t0 + q < tiles) tile_rows[(long long)(t0 + q) * E + e] = run;
        run += c[q];
      }
    }
    cnt[e] = run;
  }
  __syncthreads();
  if (e < E) {
    int start = 0;
    for (int f = 0; f < e; ++f) start += cnt[f];
    counts[e] = run;
    ends[e] = start + run;
  }
}

struct GatherArgs {
  const void* x;         // (T, M)
  const int* experts;    // (T, k)
  const int* rank;       // (T, k)
  const int* tile_rows;  // (tiles, E) each tile's first row in its expert
  const int* counts;     // (E,)
  const int* ends;       // (E,)
  int* pos;              // (T, k)
  void* xs;              // (T·k, M)
  int E, K, M;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    moe_dispatch_gather_kernel(GatherArgs g) {
  __shared__ long long rows[MAX_TOPK];
  const long long t = blockIdx.x;
  if (threadIdx.x < g.K) {
    const long long i = t * g.K + threadIdx.x;
    const int e = g.experts[i];
    const int p = g.ends[e] - g.counts[e] + g.tile_rows[(t / TILE) * g.E + e] +
                  g.rank[i];
    g.pos[i] = p;
    rows[threadIdx.x] = p;
  }
  __syncthreads();
  const T* x = static_cast<const T*>(g.x) + t * g.M;
  T* xs = static_cast<T*>(g.xs);
  for (int j = threadIdx.x; j < g.M / V; j += blockDim.x) {
    const Row8<T> r = load8(x + j * V);
    for (int k = 0; k < g.K; ++k) {
      uint4* d = reinterpret_cast<uint4*>(xs + rows[k] * g.M + j * V);
#pragma unroll
      for (int q = 0; q < (int)(sizeof(T) / 2); ++q) d[q] = r.u[q];
    }
  }
}

struct CombineArgs {
  const void* rows;      // (T·k, M)
  const float* gates;    // (T, k)
  const int* pos;        // (T, k)
  const void* shared;    // (T, M)
  const void* residual;  // (T, M)
  void* out;             // (T, M)
  int K, M;
  float mult;
};

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    moe_combine_kernel(CombineArgs g) {
  const long long t = blockIdx.x;
  const T* rows = static_cast<const T*>(g.rows);
  const long long base = t * g.M;
  for (int j = threadIdx.x; j < g.M / V; j += blockDim.x) {
    Row8<T> raw[MAX_TOPK];
#pragma unroll
    for (int k = 0; k < MAX_TOPK; ++k)
      if (k < g.K)
        raw[k] = load8(rows + (long long)__ldg(g.pos + t * g.K + k) * g.M +
                       j * V);
    float acc[V], f[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_TOPK; ++k) {
      if (k < g.K) {
        const float w = __ldg(g.gates + t * g.K + k);
        unpack(raw[k], f);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(w, f[v]));
      }
    }
    float sh[V], res[V], o[V];
    load8(static_cast<const T*>(g.shared) + base + j * V, sh);
    load8(static_cast<const T*>(g.residual) + base + j * V, res);
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = __fadd_rn(__fmul_rn(__fadd_rn(acc[v], sh[v]), g.mult), res[v]);
    store8(static_cast<T*>(g.out) + base + j * V, o);
  }
}

int threads_for(int M) {
  const int nv = M / V;
  return nv >= MAX_THREADS ? MAX_THREADS : (nv + 31) / 32 * 32;
}

}  // namespace

extern "C" int moe_route_max_experts() { return MAX_EXPERTS; }
extern "C" int moe_route_max_topk() { return MAX_TOPK; }
extern "C" int moe_route_tile() { return TILE; }

// logits (T, E) fp32, x (T, M); experts, rank, pos (T, k) int32, gates
// (T, k) fp32, tile_rows (ceil(T / TILE), E) int32 scratch, counts, ends
// (E,) int32, xs (T·k, M); dtype 0 fp32, 1 bf16
extern "C" int moe_dispatch_fwd(const float* logits, const void* x,
                                int* experts, float* gates, int* rank,
                                int* tile_rows, int* counts, int* ends,
                                int* pos, void* xs, int T, int E, int K,
                                int M, int dtype, void* stream) {
  if (T < 1 || E < 1 || E > MAX_EXPERTS || K < 1 || K > MAX_TOPK || K > E ||
      M < V || M % V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (T + TILE - 1) / TILE;
  RouteArgs r{logits, experts, gates, rank, tile_rows, T, E, K};
  moe_dispatch_route_kernel<<<tiles, ROUTE_WARPS * 32, 0, s>>>(r);
  int err = (int)cudaGetLastError();
  if (err) return err;
  moe_dispatch_offsets_kernel<<<1, MAX_EXPERTS, 0, s>>>(tile_rows, counts,
                                                      ends, tiles, E);
  err = (int)cudaGetLastError();
  if (err) return err;
  GatherArgs ga{x, experts, rank, tile_rows, counts, ends, pos, xs,
                E, K, M};
  if (dtype == 0)
    moe_dispatch_gather_kernel<float><<<T, threads_for(M), 0, s>>>(ga);
  else
    moe_dispatch_gather_kernel<__nv_bfloat16><<<T, threads_for(M), 0, s>>>(ga);
  return (int)cudaGetLastError();
}

// rows (T·k, M), gates (T, k) fp32, pos (T, k) int32, shared, residual
// and out (T, M); dtype 0 fp32, 1 bf16
extern "C" int moe_combine_fwd(const void* rows, const float* gates,
                               const int* pos, const void* shared,
                               const void* residual, void* out, int T, int K,
                               int M, float mult, int dtype, void* stream) {
  if (T < 1 || K < 1 || K > MAX_TOPK || M < V || M % V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CombineArgs c{rows, gates, pos, shared, residual, out, K, M, mult};
  if (dtype == 0)
    moe_combine_kernel<float><<<T, threads_for(M), 0, s>>>(c);
  else
    moe_combine_kernel<__nv_bfloat16><<<T, threads_for(M), 0, s>>>(c);
  return (int)cudaGetLastError();
}

extern "C" const char* moe_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
