// Replay-ring update kernels for Hopper (sm_90a): one launch per update event.
//
// Replace the TPU megakernels in src/repro/kernels/replay_ring.py:
//   ring_apply        <- ring_apply / _apply_kernel / _tile_events
//   ring_apply_whatif <- ring_apply_whatif / _whatif_kernel
//
// One event, element by element over the flat (K, D) ring (ring_apply: of
// each of B lanes, a (B, K, D) ring in one launch):
//   w = float(ring[prev, i]) (+ res[i])          read row prev, re-add residue
//   combine:    acc = sum_j coef[j] * g[j, i]     slot order 0..c-1
//               (w, s) = update_event(w, s, acc, lrs[0])
//   sequential: for j: (w, s) = update_event(w, s, coef[j] * g[j, i], lrs[j])
//   what-if:    g_j = a[i] * (float(ring[ts_j, i]) - wstar[i])  (in the kernel)
//   q = round(w) to the ring type; ring[slot, i] = q; res[i] = w - float(q)
//
// Bound, ring_apply: memory.  Per event and lane the kernel moves D * (ring
// bytes read + 4c [staged g] + 8 [state r/w] + 8 [residue r/w] + ring bytes
// written); the arithmetic is a few fp32 operations per byte.  Its
// schedule is update_event.cuh's, shared with ps_update.cu; this file gives
// it the ring's operands (RingOp): a grid-stride loop, V = 4 elements a
// thread with 16-byte loads when D % 4 == 0 and the bases are aligned, else
// V = 1 with the ragged edge masked by the loop bound (the paper's D 2 762).
// The B lanes are gridDim.y; coef is one (c,) row for every lane or a
// (B, c) row per lane (elastic masks), lrs a (B, c) row per lane.  prev /
// slot come from a device int32 array (no host sync; graph-capturable),
// shared by every lane.  Each element is read and written by the same thread, and every
// read of element i precedes its write, so prev == slot (K = 1) is safe.
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
//     distinct pulled rows in order of first appearance and the plan of
//     the slot walk below;
//   - per element, reads each distinct row once and forms t_k = a * (r_k -
//     w*) once, in registers (up to WHATIF_ROWS rows);
//   - walks the slots in order choosing t_k by block-uniform control flow,
//     never by a per-element select (three selects per slot and element
//     for three or four rows cost more issue slots than the multiply and
//     add they feed): the plan codes each group of 4 slots by its slots'
//     rows, merges consecutive groups that pull one row into a stretch
//     walked by one branch, and takes each mixed group by warp-uniform
//     16-way switches into straight-line code with the rows fixed: one
//     over its 4 slots when the event pulls at most 2 rows (1 bit a slot;
//     2 rows held in registers), else one over each pair of slots (2 bits
//     a slot; 4 rows held), the last c % 4 slots by a branch each.  So a
//     slot costs acc + coef_j * t_k and a quarter of a broadcast 16-byte
//     shared-memory load of the coefficients, shared by the V elements a
//     thread owns (V = 8: one 16-byte load of a bf16 row, two of an fp32
//     one, when D % 8 == 0 and every base is 16-byte aligned; V = 1
//     otherwise), and a mixed group one or two switches.
// An event with more than WHATIF_ROWS distinct rows forms g_j per slot
// (whatif_slots), chosen inside the same launch; block 0 adds 1 to the
// device tally's entry of the variant taken (the whatif_path counters).
// Equal rows give bitwise equal t_k, and every slot adds
// __fmul_rn(coef_j, t_k) in slot order 0..c-1, so both variants round
// exactly as the plain version does.
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

// ---- ring_apply: staged gradients g (B, c, D) fp32 -------------------------
// The per-element operands of one event on lane ``lane`` of a (B, K, D)
// ring: row prev (+ residue) and the state in, row slot, the state and the
// residue out (update_event.cuh's schedules call load, event, store).  Each
// element is read and written by the same thread, every read of element i
// before its write, so prev == slot (K = 1) is safe.
template <typename T, int OPT, bool EF>
struct RingOp {
  T* ring;
  float* s;
  float* res;
  const int32_t* idx;   // [prev, slot], shared by every lane
  int64_t D;
  int K;

  template <int V>
  __device__ __forceinline__ void load(int lane, int64_t e, float* w,
                                       float* sv) const {
    const int64_t l = (int64_t)lane * D;
    load_event<T, OPT, EF, V>(ring + ((int64_t)lane * K + idx[0]) * D,
                              OPT != OPT_SGD ? s + l : s,
                              EF ? res + l : res, e, w, sv);
  }
  template <int V>
  __device__ __forceinline__ void store(int lane, int64_t e, const float* w,
                                        const float* sv) const {
    const int64_t l = (int64_t)lane * D;
    store_event<T, OPT, EF, V>(ring + ((int64_t)lane * K + idx[1]) * D,
                               OPT != OPT_SGD ? s + l : s,
                               EF ? res + l : res, e, w, sv);
  }
  __device__ __forceinline__ void event(float& w, float& s_, float g,
                                        float lr, float m, float eps) const {
    update_event<OPT>(w, s_, g, lr, m, eps);
  }
};

// ---- ring_apply_whatif: g_j = a * (ring[ts_j] - wstar), combine mode -------
// Distinct pulled rows whose t_k = a * (ring[row_k] - wstar) a thread holds
// in registers; an event with more takes the per-slot variant.
constexpr int WHATIF_ROWS = 4;
// The walk's groups: slots GROUP*g .. GROUP*g+3.
constexpr int GROUP = 4;
// A step of the plan, (code, end group): a stretch of groups that all pull
// one row (code: the row's index) or one mixed group (code: MIXED, each
// slot's distinct-row index in 2 bits of bits 0-7 and its low bit in 1 bit
// of bits 9-12, the first slot lowest).
constexpr int MIXED = 1 << 8;
constexpr int MASK_SHIFT = 9;
// The device tally's entries: launches by the variant they took.
enum { PATH_WALK = 0, PATH_SLOTS = 1 };

// acc + coef * t, one multiply and one add per element
template <int V>
__device__ __forceinline__ void add_slot(float* acc, const float* t,
                                         float cj) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(cj, t[v]));
}

// The groups g0 .. g1-1, every slot pulled from the same row (t): one
// 16-byte shared load of four coefficients a group, 4 groups an iteration
// (2.5 % faster than 2 on a one-row event, tools/whatif_probe.py).
template <int V>
__device__ __forceinline__ void add_stretch(float* acc, const float* t,
                                            const float4* sc4, int g0,
                                            int g1) {
#pragma unroll 4
  for (int g = g0; g < g1; ++g) {
    const float4 cf = sc4[g];
    add_slot<V>(acc, t, cf.x);
    add_slot<V>(acc, t, cf.y);
    add_slot<V>(acc, t, cf.z);
    add_slot<V>(acc, t, cf.w);
  }
}

// A mixed group of an event with at most 2 rows: its 4 slots' rows are
// the low 4 bits of m; one warp-uniform switch into straight-line code
// with the rows fixed.
template <int V>
__device__ __forceinline__ void add_quad(float* acc, const float (&t)[2][V],
                                         const float4& cf, int m) {
  switch (m & 15) {
#define QUAD(q)                                   \
  case q:                                         \
    add_slot<V>(acc, t[(q) & 1], cf.x);           \
    add_slot<V>(acc, t[(q) >> 1 & 1], cf.y);      \
    add_slot<V>(acc, t[(q) >> 2 & 1], cf.z);      \
    add_slot<V>(acc, t[(q) >> 3 & 1], cf.w);      \
    break;
    QUAD(0) QUAD(1) QUAD(2) QUAD(3) QUAD(4) QUAD(5) QUAD(6) QUAD(7)
    QUAD(8) QUAD(9) QUAD(10) QUAD(11) QUAD(12) QUAD(13) QUAD(14) QUAD(15)
#undef QUAD
  }
}

// Two slots of an event with 3 or 4 rows, their rows in the low 4 bits of
// p (2 bits a slot): one warp-uniform switch as add_quad's.
template <int V>
__device__ __forceinline__ void add_pair(float* acc, const float (&t)[4][V],
                                         float c0, float c1, int p) {
  switch (p & 15) {
#define PAIR(k0, k1)                      \
  case (k0) | (k1) << 2:                  \
    add_slot<V>(acc, t[k0], c0);          \
    add_slot<V>(acc, t[k1], c1);          \
    break;
    PAIR(0, 0) PAIR(1, 0) PAIR(2, 0) PAIR(3, 0)
    PAIR(0, 1) PAIR(1, 1) PAIR(2, 1) PAIR(3, 1)
    PAIR(0, 2) PAIR(1, 2) PAIR(2, 2) PAIR(3, 2)
    PAIR(0, 3) PAIR(1, 3) PAIR(2, 3) PAIR(3, 3)
#undef PAIR
  }
}

// The groups g0 .. g1-1, a stretch of row k: one block-uniform branch to
// the row (each t[k] in registers, so every index is a constant).
template <int R, int V>
__device__ __forceinline__ void add_stretch_of(float* acc,
                                               const float (&t)[R][V],
                                               const float4* sc4, int g0,
                                               int g1, int k) {
  if (k == 0) {
    add_stretch<V>(acc, t[0], sc4, g0, g1);
  } else if (R == 2 || k == 1) {
    add_stretch<V>(acc, t[1], sc4, g0, g1);
  } else if constexpr (R == 4) {
    if (k == 2) add_stretch<V>(acc, t[2], sc4, g0, g1);
    else add_stretch<V>(acc, t[3], sc4, g0, g1);
  }
}

// One slot of row k, as add_stretch_of.
template <int R, int V>
__device__ __forceinline__ void add_one(float* acc, const float (&t)[R][V],
                                        float cj, int k) {
  if (k == 0) {
    add_slot<V>(acc, t[0], cj);
  } else if (R == 2 || k == 1) {
    add_slot<V>(acc, t[1], cj);
  } else if constexpr (R == 4) {
    if (k == 2) add_slot<V>(acc, t[2], cj);
    else add_slot<V>(acc, t[3], cj);
  }
}

// The slots 0 .. c-1 in order, each t_k chosen by block-uniform control
// flow from the block's plan, never by a per-element select: a stretch of
// groups of one row by one branch, a mixed group by one switch over its 4
// slots (R = 2 rows held) or two over its pairs (R = 4), the last
// c % GROUP slots by a branch each.
template <int R, int V>
__device__ __forceinline__ void walk(float* acc, const float (&t)[R][V],
                                     const float* sc, const int2* steps,
                                     int nsteps, int tail, int c) {
  const float4* sc4 = reinterpret_cast<const float4*>(sc);
  int g = 0;
  for (int u = 0; u < nsteps; ++u) {
    const int2 st = steps[u];
    if (st.x & MIXED) {
      const float4 cf = sc4[g];
      if constexpr (R == 2) {
        add_quad<V>(acc, t, cf, st.x >> MASK_SHIFT);
      } else {
        float c0 = cf.x, c1 = cf.y;
        int p = st.x;
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {   // one copy of the switch, run twice
          add_pair<V>(acc, t, c0, c1, p);
          c0 = cf.z;
          c1 = cf.w;
          p >>= 4;
        }
      }
    } else {
      add_stretch_of<R, V>(acc, t, sc4, g, st.y, st.x);
    }
    g = st.y;
  }
#pragma unroll 1
  for (int j = GROUP * g; j < c; ++j, tail >>= 2)
    add_one<R, V>(acc, t, sc[j], tail & 3);
}

// Variant 1 (at most WHATIF_ROWS distinct rows): each distinct row read once
// per element and t_k formed once, in registers (R of them: 2 when the
// event pulls at most 2 rows, else 4), then the slot walk.
template <typename T, int R, int V>
__device__ __forceinline__ void whatif_rows(const T* ring, const float* a,
                                            const float* wstar, int64_t e,
                                            const int64_t* roff, int nd,
                                            const float* sc,
                                            const int2* steps, int nsteps,
                                            int tail, int c, float* acc) {
  static_assert(R == 2 || R == WHATIF_ROWS, "the walk holds 2 or 4 rows");
  float t[R][V];
  {
    float av[V], wv[V];
    ld<V>(a + e, av);
    ld<V>(wstar + e, wv);
#pragma unroll
    for (int k = 0; k < R; ++k) {
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
  walk<R, V>(acc, t, sc, steps, nsteps, tail, c);
}

// Variant 2 (more distinct rows): every slot re-reads its row (from L1/L2
// when rows repeat) and forms g_j itself.
template <typename T, int V>
__device__ __forceinline__ void whatif_slots(const T* ring, const float* a,
                                             const float* wstar, int64_t D,
                                             int64_t e, const float* sc,
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
    const float cj = sc[j];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float gj = __fmul_rn(av[v], __fsub_rn(r[v], wv[v]));  // a*(r-w*)
      acc[v] = __fadd_rn(acc[v], __fmul_rn(cj, gj));              // acc+coef*g
    }
  }
}

// Shared memory of a launch with c slots: coef[c] padded to whole groups,
// the plan's steps (at most one a group) and the pulled rows ts[c].
inline size_t whatif_smem(int c) {
  const size_t groups = (c + GROUP - 1) / GROUP;
  return groups * sizeof(float4) + groups * sizeof(int2) +
         (size_t)c * sizeof(int32_t);
}

template <typename T, int OPT, bool EF, int V>
__global__ void __launch_bounds__(THREADS)
ring_apply_whatif_kernel(T* ring, float* s, float* res,
                         const float* __restrict__ a,
                         const float* __restrict__ wstar,
                         const float* __restrict__ coef,
                         const float* __restrict__ lrs,
                         const int32_t* __restrict__ idx, int64_t D, int c,
                         float m, float eps, int* tally) {
  extern __shared__ float4 smem4[];
  const int groups = (c + GROUP - 1) / GROUP;
  float* sc = reinterpret_cast<float*>(smem4);               // coef_j
  int2* steps = reinterpret_cast<int2*>(smem4 + groups);     // the plan
  int32_t* sts = reinterpret_cast<int32_t*>(steps + groups); // ts_j
  __shared__ int32_t rows[WHATIF_ROWS];
  __shared__ int n_rows, n_steps, tail_code;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    sc[j] = coef[j];
    sts[j] = idx[2 + j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the distinct rows in order of first appearance and the plan: each
    // group's slots coded by their rows' indices, a run of groups that all
    // pull one row merged into one stretch; stop past WHATIF_ROWS rows
    int nd = 0, ns = 0, code = 0, mask = 0;
    for (int j = 0; j < c; ++j) {
      const int r = sts[j];
      int k = 0;
      while (k < nd && rows[k] != r) ++k;
      if (k == nd) {
        if (nd == WHATIF_ROWS) { ++nd; break; }
        rows[nd++] = r;
      }
      code |= k << 2 * (j % GROUP);
      mask |= (k & 1) << (j % GROUP);
      if (j % GROUP == GROUP - 1) {
        const int end = j / GROUP + 1;
        if (code != k * 0x55)   // not k in all four fields: mixed
          steps[ns++] = make_int2(MIXED | mask << MASK_SHIFT | code, end);
        else if (ns > 0 && steps[ns - 1].x == k)
          steps[ns - 1].y = end;
        else
          steps[ns++] = make_int2(k, end);
        code = mask = 0;
      }
    }
    n_rows = nd;
    n_steps = ns;
    tail_code = code;
    if (blockIdx.x == 0)
      atomicAdd(tally + (nd <= WHATIF_ROWS ? PATH_WALK : PATH_SLOTS), 1);
  }
  __syncthreads();
  const int nd = n_rows, nsteps = n_steps, tail = tail_code;
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
    if (nd <= 2)
      whatif_rows<T, 2, V>(ring, a, wstar, e, roff, nd, sc, steps, nsteps,
                           tail, c, acc);
    else if (nd <= WHATIF_ROWS)
      whatif_rows<T, WHATIF_ROWS, V>(ring, a, wstar, e, roff, nd, sc, steps,
                                     nsteps, tail, c, acc);
    else
      whatif_slots<T, V>(ring, a, wstar, D, e, sc, sts, c, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) update_event<OPT>(w[v], sv[v], acc[v], lr, m, eps);
    store_event<T, OPT, EF, V>(dst, s, res, e, w, sv);
  }
}

template <typename T, int OPT, bool EF, int V>
void launch_whatif(void* ring, void* s, void* res, const void* a,
                   const void* wstar, const void* coef, const void* lrs,
                   const void* idx, int64_t D, int c, float m, float eps,
                   void* tally, cudaStream_t st) {
  ring_apply_whatif_kernel<T, OPT, EF, V>
      <<<blocks_for(D, V), THREADS, whatif_smem(c), st>>>(
          static_cast<T*>(ring), static_cast<float*>(s),
          static_cast<float*>(res), static_cast<const float*>(a),
          static_cast<const float*>(wstar), static_cast<const float*>(coef),
          static_cast<const float*>(lrs), static_cast<const int32_t*>(idx), D,
          c, m, eps, static_cast<int*>(tally));
}

// runtime flags -> template instantiation
template <typename T, int OPT, bool EF>
cudaError_t apply_seq(int seq, int vec4, void* ring, void* s, void* res,
                      const void* idx, int64_t D, int K,
                      const EventArgs& a, cudaStream_t st) {
  const RingOp<T, OPT, EF> op{static_cast<T*>(ring), static_cast<float*>(s),
                              static_cast<float*>(res),
                              static_cast<const int32_t*>(idx), D, K};
  return seq ? launch_events<RingOp<T, OPT, EF>, true>(op, a, vec4, st)
             : launch_events<RingOp<T, OPT, EF>, false>(op, a, vec4, st);
}

template <typename T>
cudaError_t apply_opt(int opt, int seq, int ef, int vec4, void* ring,
                      void* s, void* res, const void* idx, int64_t D, int K,
                      const EventArgs& a, cudaStream_t st) {
  if (opt == OPT_SGD)
    return ef ? apply_seq<T, OPT_SGD, true>(seq, vec4, ring, s, res, idx, D, K, a, st)
              : apply_seq<T, OPT_SGD, false>(seq, vec4, ring, s, res, idx, D, K, a, st);
  if (opt == OPT_MOMENTUM)
    return ef ? apply_seq<T, OPT_MOMENTUM, true>(seq, vec4, ring, s, res, idx, D, K, a, st)
              : apply_seq<T, OPT_MOMENTUM, false>(seq, vec4, ring, s, res, idx, D, K, a, st);
  return ef ? apply_seq<T, OPT_ADAGRAD, true>(seq, vec4, ring, s, res, idx, D, K, a, st)
            : apply_seq<T, OPT_ADAGRAD, false>(seq, vec4, ring, s, res, idx, D, K, a, st);
}

template <typename T, int OPT>
void whatif_mode(int ef, int vec8, void* ring, void* s, void* res,
                 const void* a, const void* wstar, const void* coef,
                 const void* lrs, const void* idx, int64_t D, int c, float m,
                 float eps, void* tally, cudaStream_t st) {
  if (ef) {
    if (vec8) launch_whatif<T, OPT, true, 8>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
    else launch_whatif<T, OPT, true, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
  } else {
    if (vec8) launch_whatif<T, OPT, false, 8>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
    else launch_whatif<T, OPT, false, 1>(ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
  }
}

template <typename T>
void whatif_opt(int opt, int ef, int vec8, void* ring, void* s, void* res,
                const void* a, const void* wstar, const void* coef,
                const void* lrs, const void* idx, int64_t D, int c, float m,
                float eps, void* tally, cudaStream_t st) {
  if (opt == OPT_SGD)
    whatif_mode<T, OPT_SGD>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
  else if (opt == OPT_MOMENTUM)
    whatif_mode<T, OPT_MOMENTUM>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
  else
    whatif_mode<T, OPT_ADAGRAD>(ef, vec8, ring, s, res, a, wstar, coef, lrs, idx, D, c, m, eps, tally, st);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// Each returns the cudaError_t of its launch (0 = launched).
// ring (B, K, D), s / res (B, D) or null, g (B, c, D), coef (c,) shared
// (coef_stride 0) or (B, c) (coef_stride c), lrs (B, c), idx (2,) [prev,
// slot] shared by every lane; vec4: the 4-wide loads (kernels/build.py::vec4).
extern "C" int ring_apply(void* ring, int ring_bf16, void* s, void* res,
                          const void* g, const void* coef, const void* lrs,
                          const void* idx, long long D, int K, int B, int c,
                          int coef_stride, int opt, int sequential,
                          float momentum, float eps, int vec4,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  const EventArgs a{static_cast<const float*>(g),
                    static_cast<const float*>(coef),
                    static_cast<const float*>(lrs), D, D, B, c, coef_stride,
                    c, momentum, eps};
  cudaError_t err =
      ring_bf16 ? apply_opt<__nv_bfloat16>(opt, sequential, ef, vec4, ring, s,
                                           res, idx, D, K, a, st)
                : apply_opt<float>(opt, sequential, ef, vec4, ring, s, res,
                                   idx, D, K, a, st);
  return (int)err;
}

extern "C" int ring_apply_whatif(void* ring, int ring_bf16, void* s,
                                 void* res, const void* a, const void* wstar,
                                 const void* coef, const void* lrs,
                                 const void* idx, long long D, int c, int opt,
                                 float momentum, float eps, int vec8,
                                 void* tally, void* stream) {
  // tally: (2,) int32 on the device, [walk, slots]; block 0 adds 1 to the
  // entry of the variant the launch took
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ef = res != nullptr;
  if (ring_bf16)
    whatif_opt<__nv_bfloat16>(opt, ef, vec8, ring, s, res, a, wstar, coef,
                              lrs, idx, D, c, momentum, eps, tally, st);
  else
    whatif_opt<float>(opt, ef, vec8, ring, s, res, a, wstar, coef, lrs, idx,
                      D, c, momentum, eps, tally, st);
  return (int)cudaGetLastError();
}

// The distinct pulled rows the what-if kernel holds in registers.
extern "C" int ring_apply_whatif_rows() { return WHATIF_ROWS; }

// The largest c the shared-memory plan takes (kernels/build.py checks it).
extern "C" int ring_apply_max_slots() { return MAX_SLOTS; }

extern "C" const char* replay_ring_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
