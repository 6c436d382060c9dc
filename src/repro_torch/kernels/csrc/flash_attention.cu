// Flash attention for Hopper (sm_90a), fp32 operands: online-softmax GQA
// attention with causal and sliding-window masks, both products on the
// tensor cores as 3xTF32 (wgmma), K/V tiles fed by TMA.
//
// Replaces, for fp32 operands, the TPU kernel in
// src/repro/kernels/flash_attention.py: flash_attention_bkgsd (pallas_call at
// :123) with _attn_kernel (:29) and _attn_block (:64), which upcast both
// products to fp32.  bf16 operands take flash_attention_sm90.cu;
// kernels/flash_attention.py dispatches by dtype.
//
// What it computes, per (b, head h = kv * G + g) and query row i:
//   s_j = (q . k_j) * scale, masked to -1e30 where (causal and j > i) or
//         (window > 0 and j <= i - window), and where j >= Sk (to -inf when
//         Sk < 32, see below);
//   over the K tiles that hold a live key, in order:
//     m' = max(m, max_j s_j); p_j = exp(s_j - m'); alpha = exp(m - m')
//     l = l * alpha + sum_j p_j;  acc = acc * alpha + sum_j p_j v_j
//   out = acc / max(l, 1e-30), in fp32.
// The mask constant is the TPU kernel's finite -1e30: a row with no live key
// in its first processed tile accumulates exp(0) = 1 terms that the next
// tile's alpha = exp(-1e30 - m') = 0 wipes out exactly.  Tiles with no live
// key are skipped as the TPU kernel and the plain version skip them, at the
// plain version's tiles: a query tile is min(128, Sq) positions, a K tile
// min(32, Sk) keys.  When Sk < 32 the plain version's one K tile has exactly
// Sk keys, so the kernel's padded keys take -inf (p = 0) and a row with no
// live key averages the same Sk keys in both.  Exponentials are base 2, the
// scale folded with log2(e).
//
// 3xTF32.  A tensor core reads 19 of an fp32 operand's 32 bits (TF32: 10
// mantissa bits).  Each operand x is split into big = rna_tf32(x) and
// small = rna_tf32(x - big) (x - big is exact in fp32), and a.b is
// a_small.b_big + a_big.b_small + a_big.b_big, the small.small term
// (<= 2^-22 |a b|) dropped: about fp32's accuracy, where big.big alone errs
// by ~2^-11 per product (~1e-3 in the output at D 128, against the 2e-5 the
// kernel is held to).  The big parts are rounded (cvt.rna) and written where
// the operand lies, so the tensor core reads them exactly; the small parts
// get copies of their own.
// The tensor cores' fp32 accumulation does not round to nearest: it loses
// up to an ulp of the running sum per instruction.  O accumulated in one
// wgmma accumulator across all of a row's K tiles (12 instructions a tile,
// ~12 000 at 32 768 keys) was 1.56e-5 from the plain version at the
// prefill_32k layer, against 1.55e-6 when each tile's P V goes into a fresh
// accumulator and is added to O in registers (measured on an H100).  So P V
// is promoted per tile, in two halves of D for the registers' sake.  S needs
// no promotion: 3 D / 8 instructions per tile into a fresh accumulator.
//
// Work layout.  One block per (b * H + h, query tile of 128 positions); the
// query tile index is blockIdx.y, walked from the last (the longest causal
// row range) to the first, and blockIdx.x puts the G heads of one KV head
// side by side, so that their K/V reads meet in L2.  384 threads in three
// warpgroups:
//   warpgroup 0, the converter (setmaxnreg.dec to 40): thread 0 issues every
//     TMA load — Q once, then each K/V tile of 32 keys into one raw stage.
//     All 128 threads then convert the raw tile into one of two converted
//     stages: K big (rounded, same swizzled layout) and K small; V
//     transposed into V^T big and V^T small (below).  K is signalled ready
//     before V, so the consumers start S while V converts.  When every
//     thread has read the raw stage (named barrier 3), thread 0 issues the
//     next tile's load into it, so the load overlaps the consumers' work.
//   warpgroups 1 and 2, the consumers (setmaxnreg.inc to 232): 64 query rows
//     each.  Q is split once: big into registers as wgmma A fragments, small
//     written back in place for the small.big product (A from shared
//     memory).  S = Q K^T is 3 x D/8 wgmma m64n32k8; the scores are scaled,
//     masked only on a tile that crosses the diagonal, the window's edge or
//     Sk, and the online softmax runs on the accumulator fragments.  P is
//     split into big and small in registers; P V is, for each half of D,
//     3 x 4 wgmma m64n(D/2)k8 into a fresh accumulator, A from registers,
//     V^T from shared memory, added to O in registers.  A consumer issues
//     the first half of P V of tile t - 1 with S of tile t, adds it to O and
//     issues the second half while S runs, runs tile t's softmax while the
//     second half runs; the two consumers take turns to issue (named
//     barriers 1 and 2) so one's softmax runs under the other's products.
//
// Why V^T.  A TF32 wgmma reads only K-major operands (the transpose bit is
// for 16-bit types).  Q K^T has D, its K dimension, contiguous in both.  In
// P V the K dimension is keys, and V arrives from the TMA as (keys, D): the
// converter writes it transposed, as rows of D holding 32 keys (128 bytes,
// 128-byte swizzle).  P's A fragment is the S accumulator's: lane quad t of
// a row holds keys 2t, 2t + 1 of each 8-key step, where the TF32 A fragment
// wants columns t, t + 4; so each 8-key step of V^T stores its keys in the
// order 0 2 4 6 1 3 5 7 and the accumulator is the A fragment as it stands.
// Cost: per tile and block the converter reads 2 x 32 D floats and writes
// 4 x 32 D (16 + 32 KB at D 128), ~1/3 of the shared-memory traffic of the
// consumers' wgmmas on that tile.
//
// Budget at D 128 (D 112 takes the same; D <= 64 half or a quarter).
// Shared memory, TMA boxes of 32 fp32 columns (128 bytes, the swizzle's
// width): Q 128 x 128 x 4 = 64 KB (its small part after the split), one raw
// K/V stage 2 x 16 KB, two converted stages of K big, K small, V^T big and
// V^T small, 4 x 16 KB each: 64 + 32 + 128 = 224 KB of the 227 KB a block
// may hold.  Registers per consumer thread: Q big 64, O 64, a half of P V
// 32, S 16, P big 16, P small 16 = 208 of 232 (ptxas spills 36 bytes at
// D 128, none at D <= 112); the converter's 40; 2 x 128 x 232 + 128 x 40 =
// 64 512 = 384 x 168, the block's allocation that setmaxnreg redistributes
// (an increase beyond it waits forever).  D 112 pads Q and K boxes to 128
// columns with the TMA's zeros (never read: 14 k-steps of 8) and runs P V
// at N = 56 a half; D 16 and 32 pad to one box.  Ragged Sq and Sk come in
// as zero rows.  Tensor maps are built on the host per call from the
// operands' own strides, so the model's (B, S, H, D) layout and the
// (B, KV, G, S, D) entry launch without a copy; the wrapper checks the
// TMA's alignment rules.
//
// Bound.  Each live (query row, key) pair of the mask costs 4 D flops (q.k
// and p.v); 3xTF32 runs each three times on the tensor cores, so the kernel
// is bounded by 3 x 4 D flops per pair at 495 TFLOP/s (dense TF32): 19.99 ms
// at one prefill_32k layer, where the bytes (each operand read once) take
// 0.14 ms.  The CUDA-core design this replaces did the same arithmetic in
// fp32 at 67 TFLOP/s (a 49.2 ms bound) and reached 0.37 of it.  Built with
// FMAs allowed.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLK_Q = 128;      // query positions per block
constexpr int BK = 32;          // keys per K/V tile
constexpr int THREADS = 384;    // converter + two consumer warpgroups
constexpr int BOX = 32;         // fp32 columns per TMA box: 128 bytes
constexpr int QBOX = BLK_Q * 128;   // one Q box: 16 KB
constexpr int KBOX = BK * 128;      // one K/V box: 4 KB
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// launch errors beyond cudaError_t's range
constexpr int ERR_NO_ENCODE = 30000;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 30001;      // + CUresult: a tensor map refused

struct Params {
  float* o;
  long long os_b, os_kv, os_g, os_s;   // element strides of the output
  int H, G, Sq, Sk, nq;
  float scale_log2;
  int causal, window;
};

// byte offsets in the (1024-aligned) dynamic shared memory
template <int D>
struct Smem {
  static constexpr int NB = (D + BOX - 1) / BOX;      // boxes per row
  static constexpr int TILE = NB * KBOX;              // one K/V/V^T tile
  static constexpr int Q = 0;
  static constexpr int RAW_K = NB * QBOX;
  static constexpr int RAW_V = RAW_K + TILE;
  static constexpr int CONV = RAW_V + TILE;           // 2 stages of:
  static constexpr int KB = 0, KS = TILE, VTB = 2 * TILE, VTS = 3 * TILE;
  static constexpr int STAGE = 4 * TILE;
  static constexpr int BAR = CONV + 2 * STAGE;        // 8 bytes each:
  static constexpr int BYTES = BAR + 8 * 8;   // q, raw, kready[2], vready[2],
                                              // empty[2]
  static_assert(D * 128 <= TILE, "V^T must fit a tile");
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

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma, TMA) that reads or overwrites them next.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address, LBO (unused here), SBO = 1024 bytes between
// 8-row groups, layout 1 = B128.  Rows are 128 bytes (32 fp32 values); a
// k-step of 8 values starts 32 bytes further into the row.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

// named barriers: 1 and 2 the consumers' turns (256 threads), 3 the
// converter's, 4 and 5 each consumer's own (128 threads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = big + small, both TF32 (small holds the rounding remainder of big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define ACC8(d, i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define ACC16(d) ACC8(d, 0), ACC8(d, 8)
#define ACC28(d) \
  ACC16(d), ACC8(d, 16), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
#define ACC32(d) ACC16(d), ACC8(d, 16), ACC8(d, 24)
#define REGS4 "%0, %1, %2, %3"
#define REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REGS16 REGS8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define REGS28 \
  REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
#define REGS32                                                           \
  REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
         "%28, %29, %30, %31"

// S (64 x 32, fp32) (+)= A (64 x 8) K^T: A and K from shared memory.
__device__ __forceinline__ void mma_s(float (&d)[16], uint64_t a, uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" REGS16
      "}, %16, %17, p, 1, 1;\n}\n"
      : ACC16(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// S (64 x 32, fp32) += A (64 x 8, TF32 registers) K^T: K from shared memory.
__device__ __forceinline__ void mma_s(float (&d)[16], const uint32_t* a,
                                      uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" REGS16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O_half (64 x N, fp32) (+)= P (64 x 8, TF32 registers) V (8 x N): V^T from
// shared memory, N = D / 2, one instruction shape per head dim.
#define MMA_PV(N, NACC, ACC, REGS, A0, A1, A2, A3, B, P)                    \
  __device__ __forceinline__ void mma_pv(float (&d)[NACC],                 \
                                         const uint32_t* a, uint64_t b,    \
                                         int accumulate) {                 \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " P ", 0;\n"          \
                 " wgmma.mma_async.sync.aligned.m64n" #N                   \
                 "k8.f32.tf32.tf32 {" REGS "}, {" A0 ", " A1 ", " A2 ", " A3 \
                 "}, " B ", p, 1, 1;\n}\n"                                  \
                 : ACC(d)                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                   "r"(accumulate));                                        \
  }
#define ACC8_0(d) ACC8(d, 0)
MMA_PV(8, 4, ACC4, REGS4, "%4", "%5", "%6", "%7", "%8", "%9")
MMA_PV(16, 8, ACC8_0, REGS8, "%8", "%9", "%10", "%11", "%12", "%13")
MMA_PV(32, 16, ACC16, REGS16, "%16", "%17", "%18", "%19", "%20", "%21")
MMA_PV(56, 28, ACC28, REGS28, "%28", "%29", "%30", "%31", "%32", "%33")
MMA_PV(64, 32, ACC32, REGS32, "%32", "%33", "%34", "%35", "%36", "%37")

// ---- the consumers' steps --------------------------------------------------
// S = Q K^T of one K tile as 3xTF32, the small products first:
// Q_small K_big (A from shared memory), Q_big K_small, Q_big K_big (A from
// registers).  k-step kk reads 8 columns of D, 32 bytes into box kk / 4.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[16],
                                        const uint32_t (&qa)[D / 2],
                                        uint32_t qs, uint32_t kb,
                                        uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_s(sc, desc(qs + (kk / 4) * QBOX + (kk % 4) * 32),
          desc(kb + (kk / 4) * KBOX + (kk % 4) * 32), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_s(sc, &qa[4 * kk], desc(ks + (kk / 4) * KBOX + (kk % 4) * 32));
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_s(sc, &qa[4 * kk], desc(kb + (kk / 4) * KBOX + (kk % 4) * 32));
}

// P V of one V^T tile for D / 2 columns (rows half * D / 2 of V^T) as
// 3xTF32 into a fresh accumulator: k-step kk is 8 keys, 32 bytes into
// every row of V^T.
template <int D>
__device__ __forceinline__ void issue_pv(float (&ot)[D / 4],
                                         const uint32_t (&pb)[16],
                                         const uint32_t (&ps)[16],
                                         uint32_t vtb, uint32_t vts) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    mma_pv(ot, &ps[4 * kk], desc(vtb + kk * 32), kk);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    mma_pv(ot, &pb[4 * kk], desc(vts + kk * 32), 1);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    mma_pv(ot, &pb[4 * kk], desc(vtb + kk * 32), 1);
}

// o's columns of one half += ot, in fp32 registers (rounded to nearest)
template <int D>
__device__ __forceinline__ void add_half(float (&o)[D / 2],
                                         const float (&ot)[D / 4], int half) {
#pragma unroll
  for (int i = 0; i < D / 4; ++i) o[half * (D / 4) + i] += ot[i];
}

// The scores of the K tile at key k0, in place: scaled, masked where the
// tile crosses Sk, the diagonal or the window (edge), then p = exp(s - m')
// with m and l updated; alpha = exp(m - m') per row.  sc[4 j + e] holds row
// row0 + 8 (e >> 1), key k0 + 8 j + colq + (e & 1); a row's 8 keys of this
// lane and the other three lanes of its quad make the tile's 32.
__device__ __forceinline__ void softmax_tile(float (&sc)[16], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int row0, int colq, bool edge,
                                             float pad) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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

// P as TF32 A fragments, big and small.  In k-step kk this lane holds keys
// 2t, 2t + 1 (t = lane % 4) of rows r, r + 8; the A fragment's registers are
// (r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4), and V^T stores key
// 2t in column t and key 2t + 1 in column t + 4 of each step.
__device__ __forceinline__ void split_p(uint32_t (&pb)[16], uint32_t (&ps)[16],
                                        const float (&sc)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(sc[4 * kk + 0], pb[4 * kk + 0], ps[4 * kk + 0]);
    split(sc[4 * kk + 2], pb[4 * kk + 1], ps[4 * kk + 1]);
    split(sc[4 * kk + 1], pb[4 * kk + 2], ps[4 * kk + 2]);
    split(sc[4 * kk + 3], pb[4 * kk + 3], ps[4 * kk + 3]);
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

// Byte offset of (row, col) in a tile of 128-byte rows with the 128-byte
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)); col counts
// fp32 values within the row.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// ---- the converter's steps -------------------------------------------------
__device__ __forceinline__ float4 split4(float4 x, float4& small) {
  uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
  split(x.x, b0, s0);
  split(x.y, b1, s1);
  split(x.z, b2, s2);
  split(x.w, b3, s3);
  small = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                      __uint_as_float(s2), __uint_as_float(s3));
  return make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(b2), __uint_as_float(b3));
}

// K: the raw tile's 16-byte chunks into K big and K small at the same
// (swizzled) offsets.
template <int D>
__device__ __forceinline__ void convert_k(uint8_t* g, int raw, int kb,
                                          int ks, int tid) {
  constexpr int CHUNKS = Smem<D>::TILE / 16;
#pragma unroll
  for (int c = tid; c < CHUNKS; c += 128) {
    float4 small;
    const float4 big =
        split4(*reinterpret_cast<const float4*>(g + raw + 16 * c), small);
    *reinterpret_cast<float4*>(g + kb + 16 * c) = big;
    *reinterpret_cast<float4*>(g + ks + 16 * c) = small;
  }
}

// V: item (d, step) reads the 8 keys 8 step .. 8 step + 7 of column d (a
// warp reads 32 columns of one row: no bank conflict) and writes row d of
// V^T big and small, keys in the order 0 2 4 6 | 1 3 5 7 (two 16-byte
// chunks; a warp's 32 rows spread over all banks).
template <int D>
__device__ __forceinline__ void convert_v(uint8_t* g, int raw, int vtb,
                                          int vts, int tid) {
  for (int it = tid; it < D * (BK / 8); it += 128) {
    const int d = it % D, step = it / D;
    const uint8_t* col = g + raw + (d >> 5) * KBOX;
#pragma unroll
    for (int half = 0; half < 2; ++half) {   // keys 0 2 4 6, then 1 3 5 7
      uint32_t b[4], s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(*reinterpret_cast<const float*>(
                  col + swz(8 * step + 2 * e + half, d & 31)),
              b[e], s[e]);
      const int off = swz(d, 8 * step + 4 * half);
      *reinterpret_cast<uint4*>(g + vtb + off) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(g + vts + off) =
          make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
}

// One K/V tile of 32 keys at key k0 into the raw stage.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        uint32_t raw_full, int k0, int kv,
                                        int b) {
  using L = Smem<D>;
  mbar_expect_tx(raw_full, 2 * L::TILE);
  for (int c = 0; c < L::NB; ++c) {
    tma_load_4d(base + L::RAW_K + c * KBOX, tk, raw_full, c * BOX, k0, kv, b);
    tma_load_4d(base + L::RAW_V + c * KBOX, tv, raw_full, c * BOX, k0, kv, b);
  }
}

// ---- the kernel ------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<D>;
  constexpr int NB = L::NB;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* g = smem_raw + (base - smem_u32(smem_raw));   // generic pointer
  const uint32_t q_full = base + L::BAR, raw_full = q_full + 8;
  const uint32_t kready0 = raw_full + 8, vready0 = kready0 + 16,
                 empty0 = vready0 + 16;

  const int bh = (int)blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kv = h / p.G, gh = h % p.G;
  const int q0 = (p.nq - 1 - (int)blockIdx.y) * BLK_Q;   // longest first
  // the K tiles holding a live key, at the plain version's tiles
  const int bq = min(BLK_Q, p.Sq), bk = min(BK, p.Sk);
  const int nk = (p.Sk + BK - 1) / BK;
  const int t_hi = p.causal ? min(nk, (q0 + bq - 1) / BK + 1) : nk;
  int t_lo = 0;
  if (p.window > 0) {   // live iff t * 32 + bk - 1 > q0 - window
    const int x = q0 - p.window - bk + 1;
    t_lo = x < 0 ? 0 : x / BK + 1;
  }
  const int n = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(raw_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(kready0 + 8 * s, 128);   // every converter thread
      mbar_init(vready0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = (int)threadIdx.x / 128;
  const int tid = (int)threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  if (wg == 0) {
    // ---- converter: TMA loads, then K / V^T big and small per tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, NB * QBOX);
      for (int c = 0; c < NB; ++c)
        tma_load_5d(base + L::Q + c * QBOX, &tq, q_full, c * BOX, q0, gh, kv,
                    b);
      if (n > 0) load_kv<D>(base, &tk, &tv, raw_full, t_lo * BK, kv, b);
    }
    for (int i = 0; i < n; ++i) {
      const int s = i & 1;
      const int st = L::CONV + s * L::STAGE;
      mbar_wait(raw_full, i & 1);
      if (i >= 2) mbar_wait(empty0 + 8 * s, ((i >> 1) - 1) & 1);
      convert_k<D>(g, L::RAW_K, st + L::KB, st + L::KS, tid);
      fence_async();
      mbar_arrive(kready0 + 8 * s);
      convert_v<D>(g, L::RAW_V, st + L::VTB, st + L::VTS, tid);
      fence_async();
      mbar_arrive(vready0 + 8 * s);
      bar_sync(3, 128);   // every thread has read the raw stage
      if (tid == 0 && i + 1 < n)
        load_kv<D>(base, &tk, &tv, raw_full, (t_lo + i + 1) * BK, kv, b);
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int wg_lo = q0 + 64 * cw, wg_hi = wg_lo + 63;
  const int r = 16 * warp + lane / 4;      // local rows r, r + 8
  const int row0 = wg_lo + r;
  const int t = lane % 4, colq = 2 * t;
  const float pad = p.Sk < BK ? -INFINITY : NEG_INF;
  const uint32_t qs = base + L::Q + cw * 64 * 128;

  // Q: big into this lane's A fragments, small back in place
  uint32_t qa[D / 2];
  mbar_wait(q_full, 0);
  {
    uint8_t* qg = g + L::Q + cw * 64 * 128;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = r + 8 * (x & 1), col = 8 * kk + t + 4 * (x >> 1);
        float* e = reinterpret_cast<float*>(qg + (col >> 5) * QBOX +
                                            swz(row, col & 31));
        uint32_t small;
        split(*e, qa[4 * kk + x], small);
        *e = __uint_as_float(small);
      }
    }
    fence_async();
    bar_sync(4 + cw, 128);
  }

  const auto stage = [&](int s) { return base + L::CONV + s * L::STAGE; };
  const auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };
  const auto edge = [&](int k0) {
    return k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wg_lo) ||
           (p.window > 0 && k0 <= wg_hi - p.window);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[16], ot[D / 4];
  uint32_t pb[16], ps[16];
  const auto vhalf = [&](int s, int part, int half) {
    return stage(s) + part + half * (D / 2) * 128;
  };

  if (n > 0) {
    // Ping-pong: consumer cw issues its wgmmas after named barrier 1 + cw,
    // then lets the other one issue; its softmax runs under the other's
    // products.  Consumer 1 opens the first turn for consumer 0 and skips
    // the last hand-over, so every arrival is waited for.
    if (cw == 1) bar_arrive(1, 256);
    mbar_wait(kready0, 0);
    bar_sync(1 + cw, 256);
    wg_fence();
    issue_s<D>(sc, qa, qs, stage(0) + L::KB, stage(0) + L::KS);
    wg_commit();
    bar_arrive(2 - cw, 256);
    wg_wait0();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, p, t_lo * BK, row0, colq, edge(t_lo * BK),
                 pad);
    split_p(pb, ps, sc);

    for (int i = 1; i < n; ++i) {
      const int s = i & 1, sp = s ^ 1;
      const int k0 = (t_lo + i) * BK;
      mbar_wait(kready0 + 8 * s, (i >> 1) & 1);
      mbar_wait(vready0 + 8 * sp, ((i - 1) >> 1) & 1);
      bar_sync(1 + cw, 256);
      fence_regs(ot);
      fence_regs(pb);
      fence_regs(ps);
      wg_fence();
      issue_pv<D>(ot, pb, ps, vhalf(sp, L::VTB, 0), vhalf(sp, L::VTS, 0));
      wg_commit();
      issue_s<D>(sc, qa, qs, stage(s) + L::KB, stage(s) + L::KS);
      wg_commit();
      bar_arrive(2 - cw, 256);
      wg_wait1();                 // P V of tile i - 1, first half
      fence_regs(ot);
      add_half<D>(o, ot, 0);
      fence_regs(ot);
      wg_fence();
      issue_pv<D>(ot, pb, ps, vhalf(sp, L::VTB, 1), vhalf(sp, L::VTS, 1));
      wg_commit();
      wg_wait1();                 // S of tile i; the second half runs on
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, p, k0, row0, colq, edge(k0), pad);
      wg_wait0();
      fence_regs(ot);
      add_half<D>(o, ot, 1);
      release(sp);
      rescale(o, alpha);
      split_p(pb, ps, sc);
    }

    const int sl = (n - 1) & 1;
    mbar_wait(vready0 + 8 * sl, ((n - 1) >> 1) & 1);
    bar_sync(1 + cw, 256);
    fence_regs(ot);
    fence_regs(pb);
    fence_regs(ps);
    wg_fence();
    issue_pv<D>(ot, pb, ps, vhalf(sl, L::VTB, 0), vhalf(sl, L::VTS, 0));
    wg_commit();
    if (cw == 0) bar_arrive(2, 256);
    wg_wait0();
    fence_regs(ot);
    add_half<D>(o, ot, 0);
    fence_regs(ot);
    wg_fence();
    issue_pv<D>(ot, pb, ps, vhalf(sl, L::VTB, 1), vhalf(sl, L::VTS, 1));
    wg_commit();
    wg_wait0();
    fence_regs(ot);
    add_half<D>(o, ot, 1);
    release(sl);
  }

  // out = O / max(l, 1e-30), masked at Sq
  float* ob = p.o + b * p.os_b + kv * p.os_kv + gh * p.os_g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int qp = row0 + 8 * e;
    if (qp >= p.Sq) continue;
    const float den = fmaxf(l[e], 1e-30f);
    float* orow = ob + (long long)qp * p.os_s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + colq) =
          make_float2(o[4 * j + 2 * e] / den, o[4 * j + 2 * e + 1] / den);
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

// An fp32 tensor map of `rank` dims, innermost (the head dim, contiguous)
// first; strides in elements for dims 1..rank-1.  Boxes of 32 x rows x 1...,
// 128-byte swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, const long long* strides, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  cuuint64_t gstride[4];
  cuuint32_t box[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    box[i] = i == 0 ? BOX : (i == 1 ? rows : 1);
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = (cuuint64_t)strides[i - 1] * 4;
  }
  CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                     const_cast<void*>(ptr), dims, gstride, box, estride,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)res;
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& prm, int BH,
           cudaStream_t stream) {
  auto kern = flash_tf32x3_kernel<D>;
  const int smem = Smem<D>::BYTES + 1024;   // + room to align to 1024
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, prm.nq);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- plain C interface (loaded with ctypes) --------------------------------
// q: (B, KV, G, Sq, D), k/v: (B, KV, Sk, D), o like q, all fp32 with a
// contiguous head dim.  strides: 14 element strides — q (b, kv, g, s),
// k (b, kv, s), v (b, kv, s), o (b, kv, g, s); every one a multiple of 4
// elements (16 bytes) and q/k/v 16-byte aligned (the TMA's rules, checked by
// the wrapper).  D in {16, 32, 64, 112, 128}.  Returns 0 when launched, a
// cudaError_t, or ERR_NO_ENCODE / ERR_ENCODE + CUresult.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* strides, int B, int KV,
                                   int G, int Sq, int Sk, int D, float scale,
                                   int causal, int window, void* stream) {
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
  int err = make_map(&tq, q, 5, qdims, qst, BLK_Q);
  if (!err) err = make_map(&tk, k, 4, kdims, kst, BK);
  if (!err) err = make_map(&tv, v, 4, kdims, vst, BK);
  if (err) return err;
  Params prm;
  prm.o = static_cast<float*>(o);
  prm.os_b = os[0];
  prm.os_kv = os[1];
  prm.os_g = os[2];
  prm.os_s = os[3];
  prm.H = KV * G;
  prm.G = G;
  prm.Sq = Sq;
  prm.Sk = Sk;
  prm.nq = (Sq + BLK_Q - 1) / BLK_Q;
  prm.scale_log2 = scale * LOG2E;
  prm.causal = causal;
  prm.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * KV * G;
  switch (D) {
    case 16: return launch<16>(tq, tk, tv, prm, BH, s);
    case 32: return launch<32>(tq, tk, tv, prm, BH, s);
    case 64: return launch<64>(tq, tk, tv, prm, BH, s);
    case 112: return launch<112>(tq, tk, tv, prm, BH, s);
    default: return launch<128>(tq, tk, tv, prm, BH, s);
  }
}

extern "C" int flash_attention_block_q() { return BLK_Q; }
extern "C" int flash_attention_block_k() { return BK; }

extern "C" const char* flash_attention_error_string(int err) {
  if (err == ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled not found in libcuda";
  if (err > ERR_NO_ENCODE)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - "
           "30001)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
