// Flash attention for Hopper (sm_90a), bf16 operands: online-softmax GQA
// attention with causal and sliding-window masks, both products on the
// tensor cores (wgmma), K/V tiles fed by TMA through a ring in shared memory.
//
// Replaces, for bf16 operands, the TPU kernel in
// src/repro/kernels/flash_attention.py: flash_attention_bkgsd (pallas_call at
// :123) with _attn_kernel (:29) and _attn_block (:64).  fp32 operands keep the
// CUDA-core kernel in flash_attention.cu (fp32 products, as the TPU kernel's
// upcast); kernels/flash_attention.py dispatches by dtype.
//
// What it computes, per (b, head h = kv * G + g) and query row i:
//   s_j = (q . k_j) * scale, masked to -1e30 where (causal and j > i) or
//         (window > 0 and j <= i - window), and where j >= Sk (to -inf when
//         Sk < 128, see below);
//   over the K tiles that hold a live key, in order:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); alpha = exp(m - m')
//     l = l * alpha + sum_j p_j;  acc = acc * alpha + sum_j bf16(p_j) v_j
//   out = acc / max(l, 1e-30), rounded to bf16.
// The mask constant is the TPU kernel's finite -1e30: a row with no live key
// in its first processed tile accumulates exp(0) = 1 terms that the next
// tile's alpha = exp(-1e30 - m') = 0 wipes out exactly (-inf would give
// exp(-inf + inf) = NaN).  Tiles with no live key are skipped as the TPU kernel
// and the plain version skip them, at the plain version's tiles: a query tile
// is min(128, Sq) positions, a K tile min(128, Sk) keys.  When Sk < 128 the
// plain version's one K tile has exactly Sk keys, so the kernel's padded keys
// take -inf (p = 0) rather than -1e30 and a row with no live key at all
// averages the same keys in both.  The exponentials are base 2, the scale
// folded with log2(e).
//
// Work layout.  One block per (b * H + h, query tile); the query tile index
// is blockIdx.y, walked from the last (the longest causal row range) to the
// first, and blockIdx.x puts the G heads of one KV head side by side, so that
// their K/V reads meet in L2 (qwen2_1_5b's whole K/V at S 32 768 is 33.5 MB,
// the L2 50 MB).  A query tile is 128 positions of one head: the TPU kernel's
// GQA fold (G heads x blk_q positions as the rows of one tile) is dropped,
// because G * blk_q does not make a multiple of wgmma's 64 rows at G = 6.
// 384 threads in three warpgroups:
//   warpgroup 0, the producer: one thread issues every TMA load — the Q
//     tile once, then the K and V tiles of 128 keys into a ring of STAGES = 3
//     stages, each guarded by a "full" mbarrier (TMA bytes landed) and an
//     "empty" one (every consumer warp done).  It gives its registers away
//     (setmaxnreg.dec to 24).
//   warpgroups 1 and 2, the consumers: 64 query rows each (setmaxnreg.inc to
//     240).  S = Q K^T is wgmma m64n128k16 with both operands in shared
//     memory.  The scores are scaled, and masked only on a tile that crosses
//     the causal diagonal, the window's edge or Sk; the online softmax works
//     on the accumulator fragments (a row lives in the 4 lanes of a quad: two
//     shuffles for its max; l is summed per lane, across the quad once at the
//     end).  P is converted to bf16 in registers, where the accumulator's
//     fragment is already wgmma's A fragment, and O += P V is wgmma m64nDk16
//     with A from registers and V straight from shared memory in its natural
//     (keys, D) layout (MN-major, the transpose bit set).  O accumulates in
//     fp32 registers; out = O / max(l, 1e-30) is converted to bf16 and stored
//     through the strides, masked at Sq and D.
//   The schedule hides the softmax under the tensor cores twice over.  A
//   consumer issues S of tile t and O += P V of tile t - 1 together, waits
//   for S alone and runs tile t's softmax while its P V still runs; and the
//   two consumers take turns to issue (named barriers 1 and 2), so that one's
//   softmax runs under the other's products.  A tile's stage is released
//   when its P V is done, one step after its K was read: hence 3 stages, so
//   that the load of tile t + 1 overlaps step t.
// Shared memory.  TMA boxes of 64 columns (128 bytes of bf16) x 128 rows with
// the 128-byte swizzle, which wgmma reads without bank conflicts.  D = 112
// takes two boxes whose second runs past the tensor's inner dimension: TMA
// fills those columns with zeros, which pads D to 128 at no cost in
// correctness; D = 16, 32 pad to 64 the same way.  Ragged Sq and Sk come in as
// zero rows too.  At D 128: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB
// of the 227 KB a block may hold.
// Tensor maps are built on the host per call from the operands' own strides
// (passed as __grid_constant__ CUtensorMap), so the model's (B, S, H, D)
// layout and the (B, KV, G, S, D) entry launch without a copy; the wrapper
// checks the TMA's alignment rules first.
//
// Bound.  Each live (query row, key) pair of the mask costs 4 D flops (q.k
// and p.v); at 989 TFLOP/s dense bf16 that bounds the kernel at a long
// sequence (the bytes, each operand read once, are ~10^-4 of the work).  The
// CUDA-core design it replaces for bf16 ran that arithmetic in fp32 at
// 67 TFLOP/s, reached 37 % of it, used no tensor cores, no TMA, did not
// overlap a K/V load with the arithmetic, and read padded fp32 shared-memory
// rows one scalar per FMA.  Here the tensor cores do both products, TMA loads
// the next K/V tiles while the consumers compute on this one, and shared
// memory is read by wgmma's own swizzled path.  Not done yet: the G blocks of
// one KV head each read its K/V tiles from L2 (a cluster with TMA multicast
// would share them), a persistent grid, and a wider K tile.
//
// Rounding this adds.  P is rounded to bf16 before P V (as every Hopper flash
// kernel and scaled_dot_product_attention do; the TPU kernel keeps P in fp32):
// each p moves by at most 2^-8 p, so the output by at most 2^-8 max|v| over
// the (b, kv head)'s keys.  The plain version is held to that plus one bf16
// ulp of the larger output plus 2e-5.  Built with FMAs allowed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;        // query positions per block, keys per K/V tile
constexpr int STAGES = 3;       // K/V ring depth
constexpr int THREADS = 384;    // producer + two consumer warpgroups
constexpr int BOX = 64;         // columns per TMA box: 128 bytes of bf16
constexpr int BOX_BYTES = BLK * BOX * 2;   // one box of 128 rows: 16 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// launch errors beyond cudaError_t's range
constexpr int ERR_NO_ENCODE = 30000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 30001;      // + CUresult: a tensor map refused

struct Params {
  __nv_bfloat16* o;
  long long os_b, os_kv, os_g, os_s;   // element strides of the output
  int H, G, Sq, Sk, D, nq;
  float scale_log2;
  int causal, window;
};

// byte offsets in the (1024-aligned) dynamic shared memory
template <int DP>
struct Smem {
  static constexpr int NB = DP / BOX;                       // boxes per row
  static constexpr int Q = 0;
  static constexpr int K = NB * BOX_BYTES;
  static constexpr int V = K + STAGES * NB * BOX_BYTES;
  static constexpr int BAR = V + STAGES * NB * BOX_BYTES;   // 8 bytes each:
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);  // q, full, empty
};

// ---- PTX wrappers ----------------------------------------------------------
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
// K-major (Q, K): rows 128 bytes apart, 8-row groups SBO = 1024 bytes apart,
// LBO unused.  MN-major (V): 8-key groups SBO = 1024 bytes apart, the next
// 64 columns of D (the next box) LBO = BOX_BYTES apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// named barriers 1 and 2 (0 is __syncthreads) over the 256 consumer threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving register reads or writes across a wgmma
// fence or wait (the asm operands alone do not order them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(d, i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
#define ACC64(d) ACC32(d), ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
#define REGS32                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define REGS64                                                           \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
         "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
         "%56, %57, %58, %59, %60, %61, %62, %63"

// S (64 x 128, fp32) (+)= Q (64 x 16) K^T: both from shared memory, K-major.
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// O (64 x N, fp32) += P (64 x 16, bf16 registers) V (16 x N): V from shared
// memory, MN-major (transpose bit set).
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the consumers' steps --------------------------------------------------
// S = Q K^T of one K tile: 16 columns of D per wgmma, 32 bytes into a box.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t qaddr,
                                         uint32_t kaddr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    mma_qk(sc, sw128_desc(qaddr + off, 16, 1024),
           sw128_desc(kaddr + off, 16, 1024), kk);
  }
}

// O += P V of one V tile: 16 keys (16 rows of 128 bytes) per wgmma.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[32],
                                         uint32_t vaddr) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    mma_pv(o, &pa[4 * kk],
           sw128_desc(vaddr + kk * 16 * 128, BOX_BYTES, 1024));
}

// The scores of the K tile at key k0, in place: scaled, masked where the
// tile crosses Sk, the diagonal or the window (edge), then p = exp(s - m')
// with m and l updated; alpha = exp(m - m') per row.  sc[4 j + e] holds row
// row0 + 8 (e >> 1), key k0 + 8 j + colq + (e & 1); a row's 32 keys of this
// lane and the other three lanes of its quad make the tile's 128.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int row0, int colq, bool edge,
                                             float pad) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * p.scale_log2;
      if (edge) {
        const int kp = k0 + 8 * j + colq + (e & 1);
        const int qp = row0 + 8 * (e >> 1);
        if (kp >= p.Sk)
          x = pad;
        else if ((p.causal && kp > qp) ||
                 (p.window > 0 && kp <= qp - p.window))
          x = NEG_INF;
      }
      sc[4 * j + e] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float pe = ex2(sc[4 * j + e] - mn);
        sc[4 * j + e] = pe;
        sum += pe;
      }
    }
    l[r] = l[r] * alpha[r] + sum;   // this lane's share; the quad's at the end
  }
}

// P in bf16: the accumulator fragment of keys 16 kk .. 16 kk + 15 is
// wgmma's A fragment of k-step kk.
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[32],
                                        const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[4 * kk + x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// ---- the kernel ------------------------------------------------------------
// DP: the head dim padded to whole TMA boxes (64 for D <= 64, else 128).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<DP>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int bh = (int)blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kv = h / p.G, g = h % p.G;
  const int q0 = (p.nq - 1 - (int)blockIdx.y) * BLK;   // longest tiles first
  // the K tiles holding a live key, at the plain version's tiles
  const int bq = min(BLK, p.Sq), bk = min(BLK, p.Sk);
  const int nk = (p.Sk + BLK - 1) / BLK;
  const int t_hi = p.causal ? min(nk, (q0 + bq - 1) / BLK + 1) : nk;
  int t_lo = 0;
  if (p.window > 0) {   // live iff t * 128 + bk - 1 > q0 - window
    const int x = q0 - p.window - bk + 1;
    t_lo = x < 0 ? 0 : x / BLK + 1;
  }
  const int n = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = (int)threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NB * BOX_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load_5d(base + L::Q + c * BOX_BYTES, &tq, q_full, c * BOX, q0, g,
                    kv, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * NB * BOX_BYTES);
        const int k0 = (t_lo + i) * BLK;
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(base + L::K + (s * NB + c) * BOX_BYTES, &tk, full,
                      c * BOX, k0, kv, b);
          tma_load_4d(base + L::V + (s * NB + c) * BOX_BYTES, &tv, full,
                      c * BOX, k0, kv, b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int tid = (int)threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int wg_lo = q0 + 64 * cw, wg_hi = wg_lo + 63;
  const int row0 = wg_lo + 16 * warp + lane / 4;   // rows row0, row0 + 8
  const int colq = 2 * (lane % 4);                 // first of 2 columns / 8
  const uint32_t qaddr = base + L::Q + cw * 64 * 128;
  const float pad = p.Sk < BLK ? -INFINITY : NEG_INF;

  // S of tile t is computed with O += P V of tile t - 1, so a tile's stage
  // is released one step after its K was read
  const auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  };
  const auto edge = [&](int k0) {
    return k0 + BLK > p.Sk || (p.causal && k0 + BLK - 1 > wg_lo) ||
           (p.window > 0 && k0 <= wg_hi - p.window);
  };
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[64];
  uint32_t pa[32];
  mbar_wait(q_full, 0);

  if (n > 0) {
    // Ping-pong: consumer cw issues its wgmmas after named barrier 1 + cw,
    // then lets the other one issue; its softmax runs under the other's
    // products.  Consumer 1 opens the first turn for consumer 0 and skips
    // the last hand-over, so every arrival is waited for.
    if (cw == 1) bar_arrive(1);
    mbar_wait(full0, 0);
    bar_sync(1 + cw);
    wg_fence();
    issue_qk<DP>(sc, qaddr, base + L::K);
    wg_commit();
    bar_arrive(2 - cw);
    wg_wait0();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, p, t_lo * BLK, row0, colq,
                 edge(t_lo * BLK), pad);
    to_bf16(pa, sc);

    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      const int k0 = (t_lo + i) * BLK;
      mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      bar_sync(1 + cw);
      fence_regs(o);
      fence_regs(pa);
      wg_fence();
      issue_qk<DP>(sc, qaddr, base + L::K + s * NB * BOX_BYTES);
      wg_commit();
      issue_pv(o, pa, base + L::V + sp * NB * BOX_BYTES);
      wg_commit();
      bar_arrive(2 - cw);
      wg_wait1();                 // S of tile i; P V of tile i - 1 runs on
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, p, k0, row0, colq, edge(k0), pad);
      wg_wait0();
      fence_regs(o);
      release(sp);
      rescale(o, alpha);
      to_bf16(pa, sc);
    }

    const int sl = (n - 1) % STAGES;
    bar_sync(1 + cw);
    fence_regs(o);
    fence_regs(pa);
    wg_fence();
    issue_pv(o, pa, base + L::V + sl * NB * BOX_BYTES);
    wg_commit();
    if (cw == 0) bar_arrive(2);
    wg_wait0();
    fence_regs(o);
    release(sl);
  }

  // out = O / max(l, 1e-30) in bf16, masked at Sq and D
  __nv_bfloat16* ob = p.o + b * p.os_b + kv * p.os_kv + g * p.os_g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = row0 + 8 * r;
    if (qp >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)qp * p.os_s;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + colq;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                  o[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---- host: tensor maps and launch ------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: found through the runtime, so the
// library links against nothing but cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims, innermost (the head dim, contiguous)
// first; strides in elements for dims 1..rank-1.  Boxes of 64 x 128 x 1...,
// 128-byte swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, const long long* strides) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  cuuint64_t gstride[4];
  cuuint32_t box[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    box[i] = i == 0 ? BOX : (i == 1 ? BLK : 1);
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                     const_cast<void*>(ptr), dims, gstride, box, estride,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)res;
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& prm, int BH,
           cudaStream_t stream) {
  auto kern = flash_sm90_kernel<DP>;
  const int smem = Smem<DP>::BYTES + 1024;   // + room to align to 1024
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, prm.nq);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// q: (B, KV, G, Sq, D), k/v: (B, KV, Sk, D), o like q, all bf16 with a
// contiguous head dim.  strides: 14 element strides — q (b, kv, g, s),
// k (b, kv, s), v (b, kv, s), o (b, kv, g, s); every one a multiple of 8
// elements (16 bytes) and q/k/v 16-byte aligned (the TMA's rules, checked by
// the wrapper).  D in {16, 32, 64, 112, 128}.  Returns 0 when launched, a
// cudaError_t, or ERR_NO_ENCODE / ERR_ENCODE + CUresult.
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int B,
                                        int KV, int G, int Sq, int Sk, int D,
                                        float scale, int causal, int window,
                                        void* stream) {
  if (D != 16 && D != 32 && D != 64 && D != 112 && D != 128)
    return (int)cudaErrorInvalidValue;
  const long long *qs = strides, *ks = strides + 4, *vs = strides + 7,
                  *os = strides + 10;
  CUtensorMap tq, tk, tv;
  const cuuint64_t qdims[5] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)G,
                               (cuuint64_t)KV, (cuuint64_t)B};
  const long long qst[4] = {qs[3], qs[2], qs[1], qs[0]};
  const cuuint64_t kdims[4] = {(cuuint64_t)D, (cuuint64_t)Sk, (cuuint64_t)KV,
                               (cuuint64_t)B};
  const long long kst[3] = {ks[2], ks[1], ks[0]};
  const long long vst[3] = {vs[2], vs[1], vs[0]};
  int err = make_map(&tq, q, 5, qdims, qst);
  if (!err) err = make_map(&tk, k, 4, kdims, kst);
  if (!err) err = make_map(&tv, v, 4, kdims, vst);
  if (err) return err;
  Params prm;
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.os_b = os[0];
  prm.os_kv = os[1];
  prm.os_g = os[2];
  prm.os_s = os[3];
  prm.H = KV * G;
  prm.G = G;
  prm.Sq = Sq;
  prm.Sk = Sk;
  prm.D = D;
  prm.nq = (Sq + BLK - 1) / BLK;
  prm.scale_log2 = scale * LOG2E;
  prm.causal = causal;
  prm.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(tq, tk, tv, prm, B * KV * G, s);
  return launch<128>(tq, tk, tv, prm, B * KV * G, s);
}

extern "C" int flash_attention_sm90_block() { return BLK; }

extern "C" const char* flash_attention_sm90_error_string(int err) {
  if (err == ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled not found in libcuda";
  if (err > ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - "
           "30001)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
