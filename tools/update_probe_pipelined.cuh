// A bulk-copy pipelined schedule for update_event.cuh's event, built only
// by tools/update_probe.py to time it against the kernels' grid-stride
// schedule (simple_kernel).  The port does not ship it: at D 10 000 004,
// c 128 it measured within 1.4 % of simple_kernel on two H100s and
// 1.3-3.6 % ahead on a third, inside the spread between runs, so the
// kernels keep the one schedule (PERF.md section 6).
//
// One block per SM (persistent).  The B lanes' columns are cut in tiles
// of PIPE_T = PIPE_CONSUMERS * 4 * PIPE_VECS columns that never cross a
// lane, dealt round robin to the blocks (PIPE_INTERLEAVE; 0: a span of
// equal width per block), so all blocks work in one band of columns at a
// time.  A producer warp streams each tile's c rows of g through
// PIPE_STAGES stages of PIPE_R rows in shared memory: one cp.async.bulk
// per row that takes whole 128-byte lines (PIPE_ALIGN; 0: the tile's bytes
// alone), completing on the stage's "full" mbarrier (expect-tx), marked
// evict-first in L2 with PIPE_EVICT_FIRST.  PIPE_CONSUMERS = 256 threads
// own PIPE_VECS groups of 4 columns each: they issue the 16-byte loads of
// w / s / residue before the first wait, fold each stage's rows in slot
// order from shared memory (each row at its line skew), release the stage
// on its "empty" mbarrier, then finish the event and store.  The bytes in
// flight are set by the stages, not by registers.
//
// The plan's constants are macros, so the probe builds its variants with
// -D flags: PROBE_PIPE_VECS, _R, _STAGES, _BLOCKS, _EVICT_FIRST,
// _INTERLEAVE, _ALIGN and _MAX_SLOTS.  Needs D % 4 == 0 and a 16-byte
// aligned g.

#pragma once

#include "update_event.cuh"

#ifndef PROBE_PIPE_VECS
#define PROBE_PIPE_VECS 4
#endif
#ifndef PROBE_PIPE_R
#define PROBE_PIPE_R 2
#endif
#ifndef PROBE_PIPE_STAGES
#define PROBE_PIPE_STAGES 3
#endif
#ifndef PROBE_PIPE_BLOCKS
#define PROBE_PIPE_BLOCKS 1
#endif
#ifndef PROBE_PIPE_EVICT_FIRST
#define PROBE_PIPE_EVICT_FIRST 0
#endif
#ifndef PROBE_PIPE_INTERLEAVE
#define PROBE_PIPE_INTERLEAVE 1
#endif
#ifndef PROBE_PIPE_ALIGN
#define PROBE_PIPE_ALIGN 1
#endif
#ifndef PROBE_PIPE_MAX_SLOTS
#define PROBE_PIPE_MAX_SLOTS 6144
#endif

namespace update_probe {

using namespace update_math;

constexpr int PIPE_CONSUMERS = 256;               // consumer threads a block
constexpr int PIPE_VECS = PROBE_PIPE_VECS;        // 4-column groups a thread
constexpr int PIPE_T = PIPE_CONSUMERS * 4 * PIPE_VECS;   // columns a tile
constexpr int PIPE_R = PROBE_PIPE_R;              // rows of g per stage
constexpr int PIPE_STAGES = PROBE_PIPE_STAGES;
constexpr int PIPE_BLOCKS = PROBE_PIPE_BLOCKS;    // blocks per SM
constexpr int PIPE_EVICT_FIRST = PROBE_PIPE_EVICT_FIRST;
constexpr int PIPE_INTERLEAVE = PROBE_PIPE_INTERLEAVE;
constexpr int PIPE_ALIGN = PROBE_PIPE_ALIGN;
constexpr int PIPE_MAX_SLOTS = PROBE_PIPE_MAX_SLOTS;
constexpr int PIPE_THREADS = PIPE_CONSUMERS + 32; // + one producer warp
// a stage row holds a tile's columns and, aligned, up to 112 bytes of its
// row's 128-byte lines on either side
constexpr int PIPE_PITCH = PIPE_T + 64 * PIPE_ALIGN;     // floats
constexpr int PIPE_STAGE_BYTES = PIPE_R * PIPE_PITCH * 4;
constexpr int PIPE_BAR_BYTES = 16 * PIPE_STAGES;  // a full and an empty each

inline size_t pipe_smem_bytes(int c) {
  return (size_t)PIPE_STAGES * PIPE_STAGE_BYTES + PIPE_BAR_BYTES +
         8 * (size_t)c;
}
// 227 KB a block; 228 KB an SM, less 1 KB the hardware keeps per block
static_assert(PIPE_STAGES * PIPE_STAGE_BYTES + PIPE_BAR_BYTES +
                      8 * PIPE_MAX_SLOTS <= 232448 &&
                  PIPE_BLOCKS * (PIPE_STAGES * PIPE_STAGE_BYTES +
                                 PIPE_BAR_BYTES + 8 * PIPE_MAX_SLOTS +
                                 1024) <= 233472,
              "the pipelined plan exceeds the shared memory");

// ---- PTX: mbarriers, the 1-D bulk copy, a named barrier ---------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the barrier's phase of this parity to complete.  A wait of more
// than ~2^36 cycles (tens of seconds) can only be a fault of the pipeline:
// it traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 36)) __trap();
  }
}

// bytes (a multiple of 16) from 16-byte aligned global memory to shared
// memory, completing on the mbarrier's transaction count; with
// PIPE_EVICT_FIRST, marked first to leave L2 (g is read once)
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  if (PIPE_EVICT_FIRST) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// the consumer threads only (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PIPE_CONSUMERS) : "memory");
}

// ---- the pipelined schedule ----------------------------------------------------
// This block's tiles of the B lanes' columns, up to PIPE_T columns each
// within one lane: every gridDim.x-th tile (PIPE_INTERLEAVE), or a span of
// the B * D columns cut in tiles.  Tiles and spans start on multiples of 4
// columns and D % 4 == 0, so every tile starts 16-byte aligned and is 16n
// bytes.
__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

struct PipeSpan {
  int64_t t, hi, D, tpl;
  __device__ __forceinline__ PipeSpan(int B, int64_t D_) : D(D_) {
    if (PIPE_INTERLEAVE) {       // tile t = blockIdx.x + k * gridDim.x
      tpl = (D_ + PIPE_T - 1) / PIPE_T;
      t = blockIdx.x;
      hi = (int64_t)B * tpl;
      return;
    }
    const int64_t total = (int64_t)B * D_;
    const int64_t per =
        ((total + gridDim.x - 1) / gridDim.x + 3) & ~(int64_t)3;
    t = min64((int64_t)blockIdx.x * per, total);
    hi = min64(t + per, total);
  }
  __device__ __forceinline__ bool next(int& lane, int64_t& col, int& n) {
    if (t >= hi) return false;
    if (PIPE_INTERLEAVE) {
      lane = (int)(t / tpl);
      col = (t - (int64_t)lane * tpl) * PIPE_T;
      n = (int)min64(PIPE_T, D - col);
      t += gridDim.x;
      return true;
    }
    lane = (int)(t / D);
    col = t - (int64_t)lane * D;
    const int64_t end = min64(min64(t + PIPE_T, hi), (int64_t)(lane + 1) * D);
    n = (int)(end - t);
    t = end;
    return true;
  }
};

// Where row ``row`` (a global address) of a tile starting at column ``col``
// lies in its stage row: the bytes before column ``col`` that the copy
// takes (PIPE_ALIGN: down to its 128-byte line, never before the row).
__device__ __forceinline__ uint32_t pipe_skew(const float* row, int64_t col) {
  if (!PIPE_ALIGN) return 0;
  const uint32_t lo = (uint32_t)reinterpret_cast<uintptr_t>(row + col) & 127;
  return col * 4 < lo ? (uint32_t)(col * 4) : lo;
}

// shared memory: PIPE_STAGES stages of PIPE_R x PIPE_PITCH fp32, the full
// and empty mbarriers, coef[c] and lrs[c] of the current lane
template <class Op, bool SEQ>
__global__ void __launch_bounds__(PIPE_THREADS, PIPE_BLOCKS)
pipelined_kernel(Op op, EventArgs a) {
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  float* stages = reinterpret_cast<float*>(pipe_smem);
  unsigned char* bars = pipe_smem + PIPE_STAGES * PIPE_STAGE_BYTES;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * PIPE_STAGES;
  float* sc = reinterpret_cast<float*>(bars + PIPE_BAR_BYTES);
  float* sl = sc + a.c;
  if (threadIdx.x == 0) {
    for (int s = 0; s < PIPE_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, PIPE_CONSUMERS / 32);   // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = (a.c + PIPE_R - 1) / PIPE_R;   // stages per tile
  PipeSpan span(a.B, a.D);
  int lane, n;
  int64_t col;
  uint32_t it = 0;                                   // stages used so far

  if (threadIdx.x >= PIPE_CONSUMERS) {
    // ---- producer: one thread streams g ----
    if (threadIdx.x == PIPE_CONSUMERS) {
      while (span.next(lane, col, n)) {
        const float* gl = a.g + (int64_t)lane * a.c * a.ldg + col;
        for (int k = 0; k < chunks; ++k, ++it) {
          const int s = it % PIPE_STAGES;
          if (it >= PIPE_STAGES)
            mbar_wait(empty0 + 8 * s, ((it / PIPE_STAGES) - 1) & 1);
          const int j0 = k * PIPE_R;
          const int rows = min(PIPE_R, a.c - j0);
          const uint32_t full = full0 + 8 * s;
          const uint32_t dst = smem_u32(stages + s * PIPE_R * PIPE_PITCH);
          uint32_t from[PIPE_R], bytes[PIPE_R], total = 0;
#pragma unroll
          for (int r = 0; r < PIPE_R; ++r) {
            if (r < rows) {
              // the row's bytes [col, col + n) and, aligned, the rest of
              // their first and last 128-byte lines within the row
              const float* row = gl - col + (int64_t)(j0 + r) * a.ldg;
              from[r] = pipe_skew(row, col);
              uint32_t end = (uint32_t)(n * 4);
              if (PIPE_ALIGN) {
                const uint32_t lo = (uint32_t)reinterpret_cast<uintptr_t>(
                                        row + col + n) & 127;
                const int64_t left = (a.D - col - n) * 4;
                end += lo ? (uint32_t)min64(128 - lo, left) : 0;
              }
              bytes[r] = from[r] + end;
              total += bytes[r];
            }
          }
          mbar_expect_tx(full, total);
          for (int r = 0; r < rows; ++r)
            bulk_g2s(dst + r * PIPE_PITCH * 4,
                     reinterpret_cast<const char*>(
                         gl + (int64_t)(j0 + r) * a.ldg) - from[r],
                     bytes[r], full);
        }
      }
    }
    return;
  }

  // ---- consumers: PIPE_VECS groups of 4 columns a thread ----
  const int tid = threadIdx.x;
  int cur = -1;
  while (span.next(lane, col, n)) {
    if (lane != cur) {       // this lane's coef / lrs (a uniform branch)
      consumers_sync();
      for (int j = tid; j < a.c; j += PIPE_CONSUMERS) {
        sc[j] = a.coef[(int64_t)lane * a.coef_stride + j];
        sl[j] = a.lrs[(int64_t)lane * a.lrs_stride + j];
      }
      consumers_sync();
      cur = lane;
    }
    // group q: columns col + 4 (tid + q PIPE_CONSUMERS) .. + 3, so a warp
    // reads 512 contiguous bytes of a stage row (no bank conflict)
    bool active[PIPE_VECS];
    float w[PIPE_VECS][4], sv[PIPE_VECS][4], acc[PIPE_VECS][4];
#pragma unroll
    for (int q = 0; q < PIPE_VECS; ++q) {
      const int x = 4 * (tid + q * PIPE_CONSUMERS);
      active[q] = x < n;
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[q][v] = 0.f;
      if (active[q]) op.template load<4>(lane, col + x, w[q], sv[q]);
    }
    for (int k = 0; k < chunks; ++k, ++it) {
      const int s = it % PIPE_STAGES;
      mbar_wait(full0 + 8 * s, (it / PIPE_STAGES) & 1);
      const float* buf = stages + s * PIPE_R * PIPE_PITCH + 4 * tid;
      const int j0 = k * PIPE_R;
      const int rows = min(PIPE_R, a.c - j0);
      const float* g_row = a.g + ((int64_t)lane * a.c + j0) * a.ldg;
#pragma unroll
      for (int r = 0; r < PIPE_R; ++r) {
        if (r < rows) {
          const float* row = buf + r * PIPE_PITCH +
                             pipe_skew(g_row + (int64_t)r * a.ldg, col) / 4;
#pragma unroll
          for (int q = 0; q < PIPE_VECS; ++q) {
            if (active[q]) {
              float gj[4];
              ld<4>(row + 4 * q * PIPE_CONSUMERS, gj);
              fold_slot<Op, SEQ, 4>(op, w[q], sv[q], acc[q], gj,
                                    sc[j0 + r], sl[j0 + r], a.m, a.eps);
            }
          }
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
    }
#pragma unroll
    for (int q = 0; q < PIPE_VECS; ++q) {
      if (active[q]) {
        if (!SEQ) {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            op.event(w[q][v], sv[q][v], acc[q][v], sl[0], a.m, a.eps);
        }
        op.template store<4>(lane, col + 4 * (tid + q * PIPE_CONSUMERS),
                             w[q], sv[q]);
      }
    }
  }
}

// One launch on the pipelined schedule; cudaErrorInvalidValue for what its
// bulk copies cannot take (D % 4 != 0, a g not 16-byte aligned) or a c
// beyond the plan.
template <class Op, bool SEQ>
cudaError_t launch_pipelined(const Op& op, const EventArgs& a,
                             cudaStream_t st) {
  if (a.c < 1 || a.c > PIPE_MAX_SLOTS || a.B < 1 || a.D % 4 || a.ldg % 4 ||
      reinterpret_cast<uintptr_t>(a.g) % 16)
    return cudaErrorInvalidValue;
  const size_t bytes = pipe_smem_bytes(a.c);
  cudaError_t err = cudaFuncSetAttribute(
      pipelined_kernel<Op, SEQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  pipelined_kernel<Op, SEQ>
      <<<PIPE_BLOCKS * sm_count(), PIPE_THREADS, bytes, st>>>(op, a);
  return cudaGetLastError();
}

}  // namespace update_probe
