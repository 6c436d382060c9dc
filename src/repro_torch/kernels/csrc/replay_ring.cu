// Replay-ring update kernels for Hopper (sm_90a): one launch per update event.
//
// Replace the TPU megakernels in src/repro/kernels/replay_ring.py:
//   ring_apply        <- ring_apply / _apply_kernel / _tile_events
//   ring_apply_whatif <- ring_apply_whatif / _whatif_kernel
//
// One event, element by element over the flat (K, D) ring:
//   w = float(ring[prev, i]) (+ res[i])          read row prev, re-add residue
//   combine:    acc = sum_j coef[j] * g[j, i]     slot order 0..c-1
//               (w, s) = update_event(w, s, acc, lrs[0])
//   sequential: for j: (w, s) = update_event(w, s, coef[j] * g[j, i], lrs[j])
//   what-if:    g_j = a[i] * (float(ring[ts_j, i]) - wstar[i])  (in the kernel)
//   q = round(w) to the ring type; ring[slot, i] = q; res[i] = w - float(q)
//
// Bound, ring_apply: memory.  Per event the kernel moves D * (ring bytes
// read + 4c [staged g] + 8 [state r/w] + 8 [residue r/w] + ring bytes
// written); the arithmetic is a few fp32 operations per byte.  The design is
// the simple one: a 1-D grid-stride loop over D, each thread owning V
// contiguous elements (V = 4 with 16-byte vector loads when D % 4 == 0, so
// every row start is aligned; V = 1 on a ragged D).  The ragged edge is
// masked by the loop bound.  prev / slot / ts come from a device int32 array
// (no host sync; graph-capturable), and coef / lrs / ts are staged once per
// block in shared memory.  Each element is read and written by the same
// thread, and every read of element i precedes its write, so prev == slot
// (K = 1) and slot in ts are safe.
//
// Bound, ring_apply_whatif: operations.  The slot-order sum is a multiply
// and an add per slot and element (2c of them, separately rounded, so each
// takes an fp32 issue slot), against D * (distinct rows + 1 ring rows, a,
// w*, the residue and the state) bytes: at the what-if lane (c = 128, bf16)
// 256 operations against ~20 bytes per element.  Forming g_j = a *
// (ring[ts_j] - w*) per slot would cost 4 rounded operations, a row load
// and its index arithmetic per slot and element, ~5x the bound.  But a
// trace pulls from few rows (K is the staleness bound + 1), and equal rows
// give equal g_j, so the kernel:
//   - builds, per block in shared memory (one thread, no host sync), the
//     distinct pulled rows in order of first appearance and the runs of
//     consecutive slots that pull the same row;
//   - per element, reads each distinct row once and forms t_k = a * (r_k -
//     w*) once, in registers (up to WHATIF_ROWS rows);
//   - walks the slots choosing t_k by a block-uniform branch once per run
//     when runs are long (16 slots or more on average), else by a select
//     per element (one for two rows, three for four; a branch per slot
//     costs more in latency), so a slot costs acc + coef_j * t_k, a
//     broadcast shared-memory load and at most that select, shared by the
//     V elements a thread owns (V = 8: one 16-byte load of a bf16 row,
//     two of an fp32 one, when D % 8 == 0 and every base is 16-byte
//     aligned; V = 1 otherwise).
// An event with more than WHATIF_ROWS distinct rows forms g_j per slot
// (whatif_slots), chosen inside the same launch.  Equal rows give bitwise
// equal t_k, so both variants round exactly as the plain version does.
//
// Numerics: the update math (update_event, the slot-order combine, the
// sequential events) lives in update_event.cuh, shared with ps_update.cu, so
// kernel == plain version bitwise for both.  bf16 rounding is
// round-to-nearest-even (__float2bfloat16_rn), as torch's .to(torch.bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "update_event.cuh"

namespace {

using namespace update_math;

// Quantize w into the ring row at p; q receives float(quantized w).
template <int V>
__device__ __forceinline__ void quantize_store(float* p, const float* w,
                                               float* q) {
  st<V>(p, w);
#pragma unroll
  for (int v = 0; v < V; ++v) q[v] = w[v];
}
template <int V>
__device__ __forceinline__ void quantize_store(__nv_bfloat16* p,
                                               const float* w, float* q) {
  __nv_bfloat16 b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    b[v] = __float2bfloat16_rn(w[v]);
    q[v] = __bfloat162float(b[v]);
  }
  if constexpr (V == 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __halves2bfloat162(b[0], b[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __halves2bfloat162(b[2], b[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (V == 8) {
    uint4 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __halves2bfloat162(b[0], b[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __halves2bfloat162(b[2], b[3]);
    *reinterpret_cast<__nv_bfloat162*>(&u.z) = __halves2bfloat162(b[4], b[5]);
    *reinterpret_cast<__nv_bfloat162*>(&u.w) = __halves2bfloat162(b[6], b[7]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = b[v];
  }
}

// Read row prev (+ residue) and the state; shared by both kernels.
template <typename T, int OPT, bool EF, int V>
__device__ __forceinline__ void load_event(const T* src, const float* s,
                                           const float* res, int64_t e,
                                           float* w, float* sv) {
  ld<V>(src + e, w);
  if (EF) {
    float r[V];
    ld<V>(res + e, r);
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = __fadd_rn(w[v], r[v]);
  }
  if (OPT != OPT_SGD) {
    ld<V>(s + e, sv);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) sv[v] = 0.f;
  }
}

// Write row slot, the state and the residue w - float(q).
template <typename T, int OPT, bool EF, int V>
__device__ __forceinline__ void store_event(T* dst, float* s, float* res,
                                            int64_t e, const float* w,
                                            const float* sv) {
  float q[V];
  quantize_store<V>(dst + e, w, q);
  if (OPT != OPT_SGD) st<V>(s + e, sv);
  if (EF) {
    float r[V];
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = __fsub_rn(w[v], q[v]);
    st<V>(res + e, r);
  }
}

// ---- ring_apply: staged gradients g (c, D) fp32 -----------------------------
// shared memory: coef[c], lrs[c]
template <typename T, int OPT, bool SEQ, bool EF, int V>
__global__ void __launch_bounds__(THREADS)
ring_apply_kernel(T* ring, float* s, float* res, const float* __restrict__ g,
                  const float* __restrict__ coef,
                  const float* __restrict__ lrs,
                  const int32_t* __restrict__ idx, int64_t D, int c, float m,
                  float eps) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* sl = smem + c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sc[j] = coef[j];
    sl[j] = lrs[j];
  }
  __syncthreads();
  const T* src = ring + (int64_t)idx[0] * D;
  T* dst = ring + (int64_t)idx[1] * D;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < D; e += stride) {
    float w[V], sv[V];
    load_event<T, OPT, EF, V>(src, s, res, e, w, sv);
    staged_events<OPT, SEQ, V>(w, sv, g, D, e, c, sc, sl, m, eps);
    store_event<T, OPT, EF, V>(dst, s, res, e, w, sv);
  }
}

// ---- ring_apply_whatif: g_j = a * (ring[ts_j] - wstar), combine mode -------
// Distinct pulled rows whose t_k = a * (ring[row_k] - wstar) a thread holds
// in registers; an event with more takes the per-slot variant.
constexpr int WHATIF_ROWS = 4;

// acc + coef * t, one multiply and one add per element
template <int V>
__device__ __forceinline__ void add_slot(float* acc, const float* t,
                                         float cj) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(cj, t[v]));
}

// The slots j0 .. j1-1 of one run, all pulled from the same row (t).
template <int V>
__device__ __forceinline__ void add_run(float* acc, const float* t,
                                        const float2* scm, int j0, int j1) {
#pragma unroll 4
  for (int j = j0; j < j1; ++j) add_slot<V>(acc, t, scm[j].x);
}

// The slots 0 .. c-1, each picking its t_k by selects, no branch: one level
// (rows 0, 1) or two (rows 0 .. 3).
template <int V, int LEVELS>
__device__ __forceinline__ void add_selected(float* acc,
                                             const float (&t)[WHATIF_ROWS][V],
                                             const float2* scm, int c) {
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    const float2 cm = scm[j];   // (coef_j, distinct-row index as bits)
    const int k = __float_as_int(cm.y);
    float tk[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float lo = (k & 1) ? t[1][v] : t[0][v];
      tk[v] = LEVELS == 1 ? lo : (k & 2) ? ((k & 1) ? t[3][v] : t[2][v]) : lo;
    }
    add_slot<V>(acc, tk, cm.x);
  }
}

// Variant 1 (at most WHATIF_ROWS distinct rows): each distinct row read once
// per element and t_k formed once.  When runs of equal rows are long (16
// slots or more on average) the slot loop walks the runs, picking t_k by a
// block-uniform branch once per run; otherwise by selects per slot and
// element, since a branch per slot or per pair of slots costs more in
// latency than a select (1 per element for two rows, 3 for four).
template <typename T, int V>
__device__ __forceinline__ void whatif_rows(const T* ring, const float* a,
                                            const float* wstar, int64_t e,
                                            const int64_t* roff, int nd,
                                            const float2* scm,
                                            const int2* runs, int nruns,
                                            int c, float* acc) {
  static_assert(WHATIF_ROWS == 4, "the selections below pick 1 of 4 rows");
  float t[WHATIF_ROWS][V];
  {
    float av[V], wv[V];
    ld<V>(a + e, av);
    ld<V>(wstar + e, wv);
#pragma unroll
    for (int k = 0; k < WHATIF_ROWS; ++k) {
      if (k < nd) {
        float r[V];
        ld<V>(ring + roff[k] + e, r);
#pragma unroll
        for (int v = 0; v < V; ++v)
          t[k][v] = __fmul_rn(av[v], __fsub_rn(r[v], wv[v]));   // a*(r-w*)
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) t[k][v] = 0.f;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if (16 * nruns <= c) {
    int j = 0;
    for (int u = 0; u < nruns; ++u) {
      const int2 run = runs[u];   // (distinct-row index, end slot)
      if (run.x < 2) {
        if (run.x == 0) add_run<V>(acc, t[0], scm, j, run.y);
        else add_run<V>(acc, t[1], scm, j, run.y);
      } else {
        if (run.x == 2) add_run<V>(acc, t[2], scm, j, run.y);
        else add_run<V>(acc, t[3], scm, j, run.y);
      }
      j = run.y;
    }
  } else if (nd <= 2) {
    add_selected<V, 1>(acc, t, scm, c);
  } else {
    add_selected<V, 2>(acc, t, scm, c);
  }
}

// Variant 2 (more distinct rows): every slot re-reads its row (from L1/L2
// when rows repeat) and forms g_j itself.
template <typename T, int V>
__device__ __forceinline__ void whatif_slots(const T* ring, const float* a,
                                             const float* wstar, int64_t D,
                                             int64_t e, const float2* scm,
                                             const int32_t* sts, int c,
                                             float* acc) {
  float av[V], wv[V];
  ld<V>(a + e, av);
  ld<V>(wstar + e, wv);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (int j = 0; j < c; ++j) {
    float r[V];
    ld<V>(ring + (int64_t)sts[j] * D + e, r);
    const float cj = scm[j].x;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float gj = __fmul_rn(av[v], __fsub_rn(r[v], wv[v]));  // a*(r-w*)
      acc[v] = __fadd_rn(acc[v], __fmul_rn(cj, gj));              // acc+coef*g
    }
  }
}

// shared memory: (coef, row index)[c] as float2, runs[c] as int2, ts[c]
template <typename T, int OPT, bool EF, int V>
__global__ void __launch_bounds__(THREADS)
ring_apply_whatif_kernel(T* ring, float* s, float* res,
                         const float* __restrict__ a,
                         const float* __restrict__ wstar,
                         const float* __restrict__ coef,
                         const float* __restrict__ lrs,
                         const int32_t* __restrict__ idx, int64_t D, int c,
                         float m, float eps) {
  extern __shared__ float2 smem2[];
  float2* scm = smem2;                                 // (coef_j, map_j)
  int2* runs = reinterpret_cast<int2*>(smem2 + c);     // (map, end) per run
  int32_t* sts = reinterpret_cast<int32_t*>(runs + c);
  __shared__ int32_t rows[WHATIF_ROWS];
  __shared__ int n_rows, n_runs;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    scm[j].x = coef[j];
    sts[j] = idx[2 + j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the distinct rows in order of first appearance, each slot's index
    // among them, and the runs of consecutive slots that pull the same row;
    // stop past WHATIF_ROWS rows
    int nd = 0, nr = 0;
    for (int j = 0; j < c; ++j) {
      const int r = sts[j];
      int k = 0;
      while (k < nd && rows[k] != r) ++k;
      if (k == nd) {
        if (nd == WHATIF_ROWS) { ++nd; break; }
        rows[nd++] = r;
      }
      scm[j].y = __int_as_float(k);
      if (nr > 0 && runs[nr - 1].x == k) {
        runs[nr - 1].y = j + 1;
      } else {
        runs[nr++] = make_int2(k, j + 1);
      }
    }
    n_rows = nd;
    n_runs = nr;
  }
  __syncthreads();
  const int nd = n_rows, nruns = n_runs;
  int64_t roff[WHATIF_ROWS];
#pragma unroll
  for (int k = 0; k < WHATIF_ROWS; ++k)
    roff[k] = k < nd && nd <= WHATIF_ROWS ? (int64_t)rows[k] * D : 0;
  const float lr = lrs[0];
  const T* src = ring + (int64_t)idx[0] * D;
  T* dst = ring + (int64_t)idx[1] * D;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
       e < D; e += stride) {
    float w[V], sv[V], acc[V];
    load_event<T, OPT, EF, V>(src, s, res, e, w, sv);
    if (nd <= WHATIF_ROWS)
      whatif_rows<T, V>(ring, a, wstar, e, roff, nd, scm, runs, nruns, c,
                        acc);
    else
      whatif_slots<T, V>(ring, a, wstar, D, e, scm, sts, c, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) update_event<OPT>(w[v], sv[v], acc[v], lr, m, eps);
    store_event<T, OPT, EF, V>(dst, s, res, e, w, sv);
  }
}

template <typename T, int OPT, bool SEQ, bool EF, int V>
void launch_apply(void* ring, void* s, void* res, const void* g,
                  const void* coef, const void* lrs, const void* idx,
                  int64_t D, int c, float m, float eps, cudaStream_t st) {
  ring_apply_kernel<T, OPT, SEQ, EF, V>
      <<<blocks_for(D, V), THREADS, 2 * c * sizeof(float), st>>>(
          static_cast<T*>(ring), static_cast<float*>(s),
          static_cast<float*>(res), static_cast<const float*>(g),
          static_cast<const float*>(coef), static_cast<const float*>(lrs),
          static_cast<const int32_t*>(idx), D, c, m, eps);
}

template <typename T, int OPT, bool EF, int V>
void launch_whatif(void* ring, void* s, void* res, const void* a,
                   const void* wstar, const void* coef, const void* lrs,
                   const void* idx, int64_t D, int c, float m, float eps,
                   cudaStream_t st) {
  ring_apply_whatif_kernel<T, OPT, EF, V>
      <<<blocks_for(D, V), THREADS, 5 * c * sizeof(float), st>>>(
          static_cast<T*>(ring), static_cast<float*>(s),
          static_cast<float*>(res), static_cast<const float*>(a),
          static_cast<const float*>(wstar), static_cast<const float*>(coef),
          static_cast<const float*>(lrs), static_cast<const int32_t*>(idx), D,
          c, m, eps);
}

// runtime flags -> template instantiation
template <typename T, int OPT, bool SEQ, bool EF>
void apply_v(int vec4, void* ring, void* s, void* res, const void* g,
             const void* coef, const void* lrs, const void* idx, int64_t D,
             int c, float m, float eps, cudaStream_t st) {
  if (vec4)
    launch_apply<T, OPT, SEQ, EF, 4>(ring, s, res, g, coef, lrs, idx, D, c, m,
                                     eps, st);
  else
    launch_apply<T, OPT, SEQ, EF, 1>(ring, s, res, g, coef, lrs, idx, D, c, m,
                                     eps, st);
}

template <typename T, int OPT>
void apply_mode(int seq, int ef, int vec4, void* ring, void* s, void* res,
                const void* g, const void* coef, const void* lrs,
                const void* idx, int64_t D, int c, float m, float eps,
                cudaStream_t st) {
  if (seq) {
    if (ef) apply_v<T, OPT, true, true>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
    else apply_v<T, OPT, true, false>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  } else {
    if (ef) apply_v<T, OPT, false, true>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
    else apply_v<T, OPT, false, false>(vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  }
}

template <typename T>
void apply_opt(int opt, int seq, int ef, int vec4, void* ring, void* s,
               void* res, const void* g, const void* coef, const void* lrs,
               const void* idx, int64_t D, int c, float m, float eps,
               cudaStream_t st) {
  if (opt == OPT_SGD)
    apply_mode<T, OPT_SGD>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  else if (opt == OPT_MOMENTUM)
    apply_mode<T, OPT_MOMENTUM>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
  else
    apply_mode<T, OPT_ADAGRAD>(seq, ef, vec4, ring, s, res, g, coef, lrs, idx, D, c, m, eps, st);
}

template <typename T, int OPT>
void whatif_mode(int ef, int vec8, void* ring, void* s, void* res,
                 const void* a, const void* wstar, const void* coef,
                 const void* lrs, const void* idx, int64_t D, int c, float m,
                 float eps, cudaStream_t st) {
  if (ef) {
    if (vec8) launch_whatif<T, OPT, true, 8>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
    else launch_whatif<T, OPT, true, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  } else {
    if (vec8) launch_whatif<T, OPT, false, 8>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
    else launch_whatif<T, OPT, false, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  }
}

template <typename T>
void whatif_opt(int opt, int ef, int vec8, void* ring, void* s, void* res,
                const void* a, const void* wstar, const void* coef,
                const void* lrs, const void* idx, int64_t D, int c, float m,
                float eps, cudaStream_t st) {
  if (opt == OPT_SGD)
    whatif_mode<T, OPT_SGD>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  else if (opt == OPT_MOMENTUM)
    whatif_mode<T, OPT_MOMENTUM>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
  else
    whatif_mode<T, OPT_ADAGRAD>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, st);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// Each returns the cudaError_t of its launch (0 = launched).
extern "C" int ring_apply(void* ring, int ring_bf16, void* s, void* res,
                          const void* g, const void* coef, const void* lrs,
                          const void* idx, long long D, int c, int opt,
                          int sequential, float momentum, float eps,
                          int vec4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  if (ring_bf16)
    apply_opt<__nv_bfloat16>(opt, sequential, ef, vec4, ring, s, res, g, coef,
                             lrs, idx, D, c, momentum, eps, st);
  else
    apply_opt<float>(opt, sequential, ef, vec4, ring, s, res, g, coef, lrs,
                     idx, D, c, momentum, eps, st);
  return (int)cudaGetLastError();
}

extern "C" int ring_apply_whatif(void* ring, int ring_bf16, void* s,
                                 void* res, const void* a, const void* wstar,
                                 const void* coef, const void* lrs,
                                 const void* idx, long long D, int c, int opt,
                                 float momentum, float eps, int vec8,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  if (ring_bf16)
    whatif_opt<__nv_bfloat16>(opt, ef, vec8, ring, s, res, a, wstar, coef,
                              lrs, idx, D, c, momentum, eps, st);
  else
    whatif_opt<float>(opt, ef, vec8, ring, s, res, a, wstar, coef, lrs, idx,
                      D, c, momentum, eps, st);
  return (int)cudaGetLastError();
}

// The distinct pulled rows the what-if kernel holds in registers.
extern "C" int ring_apply_whatif_rows() { return WHATIF_ROWS; }

extern "C" const char* replay_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
