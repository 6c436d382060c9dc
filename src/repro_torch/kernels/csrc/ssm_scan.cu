// Mamba2 SSD chunked scan for Hopper (sm_90a): every tile product on the
// tensor cores as split TF32 (fp32-accurate), fp32 everywhere else.
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
// Algorithm.  A block per (b, h) walking its chunks in series would give 112
// blocks for 132 SMs at B = 1 and form C . B^T once per head.  So the work
// is taken apart along chunks, as Mamba2's own GPU SSD does, in four
// launches on one stream (scratch from the wrapper, torch.empty):
//   1. ssd_cb_kernel, per (b, group, chunk, 64 x 64 tile J <= I): G^T =
//      B_J C_I^T into cb (B, G, nc, Q, ldq), j-major; only tiles on or below
//      the diagonal are formed or read.
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
//   4. ssd_out_kernel, per (b, h, chunk, 128-row block), longest first; for
//      each 64-row tile I of its rows
//      y_I = exp(cum_I) C_I . S_{c-1} + sum_{J <= I} (G_IJ o decay) x_J, the
//      decay masked to zero above the diagonal BEFORE it multiplies (exp by
//      the fast exp2 unit, __expf: its argument is <= 0 there, and its error,
//      ~6e-8 |argument| relative, stays far inside the tolerance's 2^-20 *
//      chunk decay term); y is written once.
// At B = 1 that is 3 584 blocks in step 2 and 7 168 in step 4, not 112.
//
// Split TF32.  A tensor core reads 19 of an fp32 operand's 32 bits (TF32,
// 10 mantissa bits): one pass errs by ~2^-11 a product.  So each fp32
// operand v is split once into big = rna_tf32(v) and small =
// rna_tf32(v - big) (v - big is exact in fp32), and a.b is taken as
// big.small + small.big + big.big, the small.small term (<= 2^-22 |a b|)
// dropped: fp32's accuracy, as flash_attention.cu's 3xTF32 products (on an
// H100 within 1e-6 to 4e-6 of max |y| from the plain version where a
// chunk's decay span is small; at the cells' layers the rounding of the
// cumulative decay, which both share, dominates).  An operand born in bf16
// (B and C when bc_dtype = 1) is exact in TF32 and is not split, so its
// products take two passes, or one where both operands are (C . B^T): the
// template's T decides, so it follows the input.  x, S, w o x and the
// decayed G are fp32 and always split; nothing is narrowed below fp32.  A split operand's parts are formed once, where it
// is written to shared memory (the B operands: S, x, w o x, and C in step
// 1) or where a warp forms it in registers (the A operands: each warp owns
// its rows).  rna_tf32 rounds to nearest, ties away, by two integer
// operations: cvt.rna.tf32.f32's rounding of a finite value, without the
// range check and select the instruction expands to.
//
// The product.  One helper, product<SPLIT_A, SPLIT_B>, over one k-step of
// mma.sync m16n8k8 TF32 with fp32 accumulation: a warp owns 16 rows of the
// output across all its columns (n-tiles of 8); A fragments in registers
// (lane (g, t) holds rows g and g + 8, columns t and t + 4 of the k-step),
// B fragments from shared memory at a row pitch of (columns + 8) floats,
// which puts the 32 lanes' words in 32 banks.  mma.sync and not wgmma: the
// A operand of step 4's products is formed in registers per warp (the
// decayed G, 16 rows a warp), the tiles are 64 rows, and k runs over 64
// rows a tile: a warpgroup's 64-row wgmma would make one warp's decay and
// split the whole group's, and its TF32 operands must be K-major in shared
// memory, which x and S are not.
//
// Work per kernel.  Every tile of 64 k-rows goes through one pipeline: its
// B operand's rows (raw fp32) and its A operand's rows (as stored) are
// copied by cp.async while the block multiplies the tile before; then,
// between two barriers, the block splits the B rows into big and small and
// each thread copies its A values from the stage into registers; then the
// products.  ssd_out_kernel: 256 threads (eight warps, 16 rows of the
// 128-row block each, so each tile's copy and split serve 128 rows: 64 rows
// a block took 9 % longer at both cells' layers on an H100).  The B operand
// walks N / 64 tiles of S (N 16, 32: one tile of N rows), then x_J up to the
// block's last 64-row tile; the A operand is C's rows for S's tiles (exact
// when bf16) and, for x_J, G_IJ o exp(cum_i - cum_j) formed in registers
// from the staged cb rows and cum and split there, masked on the diagonal
// tile (rows past Q are formed from whatever the stage holds and never
// written: a product's row depends on its own row of A alone).  After S's
// tiles the rows are scaled by exp(cum_i).  A warp takes the x tiles J <=
// its own tile I; on the diagonal one it skips the k-steps wholly above its
// rows; the block's last tile is its second half's diagonal, so no barrier
// waits on a warp that skips it.  ssd_state_kernel: N / 16 warps (at least four; warps share
// the columns when N < 64), A = B^T from the staged B rows (split when
// fp32), B = w o x split into shared memory.  ssd_cb_kernel: B_J rows (the A
// operand, split in registers when fp32) and C_I rows (split once into
// shared memory when fp32).  Shared memory: ssd_out 4 (256 + 64 P + 2 * 64
// (P + 8)) + 34 816 bytes, 89 088 at P 64 whatever N: two blocks (16 warps)
// an SM (at P 128 138 240, one); ssd_state at N 128, P 64 56 320 + 18 432
// (bf16 B), two blocks of eight warps, at most 128 registers (P <= 64).  No
// atomics, no split-k: two calls on the same input are bitwise equal.
//
// Bound.  The yardstick counts fp32 operations: per (b, group, chunk) the
// lower triangle of C . B^T; per (b, h, chunk) the decayed Q x Q product
// against x (Q^2 P / 2 multiply-adds), the inter-chunk term and the chunk's
// state contribution (Q N P each); against x and y read or written once (8
// bytes per element of x).  At the zamba2_7b.prefill layer (B 8, S 4 096,
// H 112, P = N = 64, G 2, Q 256) that is ~122 Gflop, 1.816 ms at the CUDA
// cores' 67 TFLOP/s, where the CUDA-core design this replaces reached 0.30
// of it (bound by fp32 FMAs under the power cap, two warps a block, no load
// overlap in a block).  On the tensor cores the same products cost 3 TF32
// passes (2 with a bf16 operand): ~302 Gflop of TF32 at that layer, 0.61 ms
// at the dense 495 TFLOP/s, which mma.sync does not reach.  The exps (Q^2 /
// 2 per (b, h, chunk)), the split pass and the shared-memory reads of the B
// fragments (each warp reads the whole tile) sit beside the products: no
// one of them bounds it (on an H100, dropping the exps, a third of the
// decayed product's MMAs or half the B reads each saved 4-8 % of ssd_out;
// the split pass 19 %, with 64-row blocks).  Built with FMAs allowed: held
// against the plain version within a tolerance, not bitwise.
//
// Operands are read through element strides: x (b, s, h) and a (b, s, h)
// with a contiguous P (x 16-byte aligned, which the wrapper ensures); B and
// C (b, s) with a contiguous N, so the mamba block's column slices of one
// (B, S, 2N) tensor need no copy; their rows are read 16 bytes at a time
// into shared memory (16-byte aligned, which the wrapper ensures).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 64;          // rows of a chunk tile (i or j)
constexpr int MAX_Q = 256;      // chunk rows
constexpr int PASS_THREADS = 256;
constexpr int OUT_ROWS = 128;      // rows of y a ssd_out block forms
constexpr int OUT_THREADS = 2 * OUT_ROWS;   // a warp per 16 rows
constexpr int CB_THREADS = 128;    // ssd_cb: four warps of 16 rows

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

// fp32 operands are split; bf16 ones are exact in TF32
template <typename T>
struct Split {
  static constexpr bool value = true;
};
template <>
struct Split<__nv_bfloat16> {
  static constexpr bool value = false;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- the one product: split TF32 on mma.sync m16n8k8 ----------------------
// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// cvt.rna.tf32.f32's rounding of a finite v in two integer operations (the
// instruction itself expands to a range check and a select besides)
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// big = rna_tf32(v), small = rna_tf32(v - big)
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  big = rna_tf32(v);
  small = rna_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A k-step's A fragment: its TF32 big part and, when split, its small part.
// From four fp32 values v (rows g, g + 8 at column t; then at column t + 4).
template <bool SPLIT>
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit FragA(const float (&v)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (SPLIT) {
        split(v[q], big[q], small[q]);
      } else {
        big[q] = __float_as_uint(v[q]);   // exact in TF32 already
        small[q] = 0u;
      }
    }
  }
};

// d += A . B over one k-step: big.small + small.big + big.big, each term
// only where its operand is split (3, 2 or 1 MMAs).  The B fragment (rows
// t and t + 4 of the k-step at column g) lies in shared memory at offsets
// o0 and o1 of bbig (and bsml when split).
template <bool SA, bool SB>
__device__ __forceinline__ void product(float (&d)[4], const FragA<SA>& a,
                                        const float* bbig, const float* bsml,
                                        int o0, int o1) {
  const uint32_t b0 = __float_as_uint(bbig[o0]), b1 = __float_as_uint(bbig[o1]);
  if (SB) mma(d, a.big, __float_as_uint(bsml[o0]), __float_as_uint(bsml[o1]));
  if (SA) mma(d, a.small, b0, b1);
  mma(d, a.big, b0, b1);
}

// product over a B operand stored k by rows at pitch ldb: rows k0 + t and
// k0 + t + 4, column col
template <bool SA, bool SB>
__device__ __forceinline__ void product_rows(float (&d)[4],
                                             const FragA<SA>& a,
                                             const float* bbig,
                                             const float* bsml, int ldb,
                                             int k0, int col, int tig) {
  const int o0 = (k0 + tig) * ldb + col;
  product<SA, SB>(d, a, bbig, bsml, o0, o0 + 4 * ldb);
}

// ---- copies -----------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ROWS rows of CH 16-byte pieces (row r at src + r * spitch bytes, 16-byte
// aligned) into dst at dpitch bytes a row, by cp.async; rows r >= nrows and
// pieces c >= nch are zero-filled (their copies name base, a valid address,
// and read nothing).
template <int ROWS, int CH, int NT>
__device__ __forceinline__ void fetch_tile(void* dst, int dpitch,
                                           const void* src, long long spitch,
                                           int nrows, int nch,
                                           const void* base) {
  for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < nrows && c < nch;
    cp_async16(static_cast<char*>(dst) + r * dpitch + 16 * c,
               ok ? static_cast<const char*>(src) + r * spitch + 16 * c
                  : base,
               ok);
  }
}

// ROWS rows of COLS fp32 (row r at src + r * stride) into dst[r * COLS + c]
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src,
                                           long long stride, int nvalid,
                                           const float* base) {
  fetch_tile<ROWS, COLS / 4, NT>(dst, 4 * COLS, src, 4 * stride, nvalid,
                                 COLS / 4, base);
}

// row pitch (elements) of a staged tile of T whose lanes read rows t, t + 4
// of a k-step at 8 consecutive columns g: 8 words apart in the banks
template <typename T, int COLS>
__host__ __device__ constexpr int kpitch() {
  return sizeof(T) == 4 ? COLS + 8 : COLS + 16;
}
// row pitch of a staged tile of T whose lanes read rows g, g + 8 at
// columns t, t + 4: 4 words apart in the banks
template <typename T, int COLS>
__host__ __device__ constexpr int rpitch() {
  return sizeof(T) == 4 ? COLS + 4 : COLS + 8;
}

// The staged raw rows split into big and small parts at pitch COLS + 8,
// each row first times w[r] where w is given (rows r < wn only).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void split_rows(float* big, float* small,
                                           const float* raw, const float* w,
                                           int wn) {
  constexpr int PER = COLS / 4, LD = COLS + 8;
  for (int e = threadIdx.x; e < ROWS * PER; e += NT) {
    const int r = e / PER, c = 4 * (e % PER);
    float4 v = *reinterpret_cast<const float4*>(raw + r * COLS + c);
    if (w != nullptr && r < wn) {
      const float wr = w[r];
      v.x *= wr; v.y *= wr; v.z *= wr; v.w *= wr;
    }
    uint32_t b[4], s[4];
    split(v.x, b[0], s[0]);
    split(v.y, b[1], s[1]);
    split(v.z, b[2], s[2]);
    split(v.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(big + r * LD + c) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + r * LD + c) = make_uint4(s[0], s[1], s[2], s[3]);
  }
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
// the sequence (S), into shared memory at pitch N + 4: as fp32 into big, or
// split into big and small when small is given.  16-byte loads, UB of them
// in flight per thread before their stores.
template <typename T, int N, int NT>
__device__ __forceinline__ void load_rows(float* big, float* small,
                                          const T* src, long long ss, int t0,
                                          int r0, int Q, int S) {
  constexpr int VN = Vec<T>::n, PER = N / VN, UB = 4, LD = N + 4;
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
#pragma unroll
      for (int k = 0; k < VN; k += 4) {
        float* dst = big + r * LD + n0 + k;
        if (small == nullptr) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              v[u][k], v[u][k + 1], v[u][k + 2], v[u][k + 3]);
        } else {
          uint32_t b[4], s[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split(v[u][k + q], b[q], s[q]);
          *reinterpret_cast<uint4*>(dst) = make_uint4(b[0], b[1], b[2], b[3]);
          *reinterpret_cast<uint4*>(small + r * LD + n0 + k) =
              make_uint4(s[0], s[1], s[2], s[3]);
        }
      }
    }
  }
}

// ---- 1. C . B^T per (b, group, chunk), lower-triangle tiles ---------------
// cb[j][i] = B_j . C_i: M = j (a warp's 16 rows of B_J), n = i (C_I's rows,
// eight n-tiles), k = the state index.  bf16: one exact pass; fp32: three.
template <int N>
__host__ __device__ constexpr size_t cb_smem(bool split_c) {
  return sizeof(float) * (size_t)TR * (N + 4) * (split_c ? 3 : 2);
}

template <typename T, int N>
__global__ void __launch_bounds__(CB_THREADS) ssd_cb_kernel(Args g) {
  constexpr bool SP = Split<T>::value;
  constexpr int LD = N + 4;
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);    // TR x LD: B_J rows
  float* Cb = Bs + TR * LD;                        // TR x LD: C_I rows, big
  float* Cs = Cb + TR * LD;                        // TR x LD: small (fp32)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x, c = blockIdx.y, bg = blockIdx.z;
  const int b = bg / g.G, grp = bg % g.G;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  const int J = tile - I * (I + 1) / 2;
  const int Q = g.Q, t0 = c * Q;
  load_rows<T, N, CB_THREADS>(
      Bs, nullptr, static_cast<const T*>(g.bm) + b * g.bs_b + grp * g.bs_g,
      g.bs_s, t0, J * TR, Q, g.S);
  load_rows<T, N, CB_THREADS>(
      Cb, SP ? Cs : nullptr,
      static_cast<const T*>(g.cm) + b * g.cs_b + grp * g.cs_g, g.cs_s, t0,
      I * TR, Q, g.S);
  __syncthreads();
  const int ra = 16 * warp + gid;   // this thread's rows ra, ra + 8 of B_J
  float acc[TR / 8][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < N; k0 += 8) {
    const float v[4] = {Bs[ra * LD + k0 + tig], Bs[(ra + 8) * LD + k0 + tig],
                        Bs[ra * LD + k0 + tig + 4],
                        Bs[(ra + 8) * LD + k0 + tig + 4]};
    const FragA<SP> fa(v);
    // B[k][n] = C_I[n][k]: C's rows are the columns, read transposed
#pragma unroll
    for (int nt = 0; nt < TR / 8; ++nt) {
      const int o0 = (8 * nt + gid) * LD + k0 + tig;
      product<SP, SP>(acc[nt], fa, Cb, Cs, o0, o0 + 4);
    }
  }
  float* out = g.cb + ((long long)bg * g.nc + c) * Q * g.ldq;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = J * TR + ra + 8 * h2;
    if (j >= Q) continue;
#pragma unroll
    for (int nt = 0; nt < TR / 8; ++nt) {
      const int i = I * TR + 8 * nt + 2 * tig;
      if (i < Q) out[(long long)j * g.ldq + i] = acc[nt][2 * h2];
      if (i + 1 < Q) out[(long long)j * g.ldq + i + 1] = acc[nt][2 * h2 + 1];
    }
  }
}

// ---- 2. cum and dS per (b, h, chunk) ---------------------------------------
// dS[n][p] = sum_j B_j[n] w_j x_j[p]: M = n (16 rows a warp), n-tiles of p,
// k = j over the chunk's 64-row tiles.  N / 16 warps, at least four: with
// fewer row tiles the warps of one row tile share its columns.
template <int N, int P>
struct StateLayout {
  static constexpr int mt = N / 16;                  // 16-row tiles of n
  static constexpr int warps = mt >= 4 ? mt : 4;
  static constexpr int cols = P / (warps / mt);      // columns a warp owns
  static constexpr int threads = 32 * warps;
};

template <typename T, int N, int P>
__host__ __device__ constexpr size_t state_smem() {
  return sizeof(float) * (2 * MAX_Q + StateLayout<N, P>::threads +
                          (size_t)TR * P + 2 * (size_t)TR * (P + 8)) +
         sizeof(T) * (size_t)TR * kpitch<T, N>();
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(StateLayout<N, P>::threads, P <= 64 ? 2 : 1)
ssd_state_kernel(Args g) {
  using L = StateLayout<N, P>;
  constexpr int NT = L::threads, LDB = P + 8, NBW = L::cols / 8;
  constexpr int LDA = kpitch<T, N>();
  constexpr bool SA = Split<T>::value;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // TR x P: x rows, cp.async
  float* xbig = raw + TR * P;                    // TR x LDB: w o x, big
  float* xsml = xbig + TR * LDB;                 // TR x LDB: small
  T* bst = reinterpret_cast<T*>(xsml + TR * LDB);   // TR x LDA: B rows
  float* cum = reinterpret_cast<float*>(bst + TR * LDA);   // MAX_Q
  float* w = cum + MAX_Q;                        // MAX_Q
  float* part = w + MAX_Q;                       // NT
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = g.Q, S = g.S, t0 = c * Q;
  const long long bh = (long long)b * g.H + h;
  const float* ab = g.a + b * g.as_b + h * g.as_h;
  const float* xb = g.x + b * g.xs_b + h * g.xs_h;
  const T* bb = static_cast<const T*>(g.bm) + b * g.bs_b +
                (h / g.hpg) * g.bs_g;
  // the chunk's 64-row tile at row j0: x rows raw and B rows, by cp.async
  auto fetch = [&](int j0) {
    const int lim = min(Q - j0, S - t0 - j0), rows = lim < TR ? lim : TR;
    fetch_rows<TR, P, NT>(raw, xb + (long long)(t0 + j0) * g.xs_s, g.xs_s,
                          rows, xb);
    fetch_tile<TR, N * sizeof(T) / 16, NT>(
        bst, LDA * sizeof(T), bb + (long long)(t0 + j0) * g.bs_s,
        g.bs_s * sizeof(T), rows, N * sizeof(T) / 16, bb);
    cp_async_commit();
  };
  // the first tile is in flight while the chunk's cum is formed
  fetch(0);

  // inclusive scan of a over the chunk: a segment per thread, then the
  // segments' totals across the block (a warp scan, then the warps' sums)
  const int L_ = (Q + NT - 1) / NT;
  float run = 0.f;
  for (int k = 0; k < L_; ++k) {
    const int i = tid * L_ + k;
    if (i < Q) {
      const int t = t0 + i;
      run += t < S ? ab[(long long)t * g.as_s] : 0.f;
      cum[i] = run;
    }
  }
  {
    float inc = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += n;
    }
    float before = __shfl_up_sync(0xffffffffu, inc, 1);   // exclusive
    if (lane == 0) before = 0.f;
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    for (int k = 0; k < warp; ++k) before += part[k];
    __syncthreads();           // every thread has read the warps' sums
    part[tid] = before;
  }
  __syncthreads();
  float* cumg = g.cum + (bh * g.nc + c) * Q;
  for (int k = 0; k < L_; ++k) {
    const int i = tid * L_ + k;
    if (i < Q) {
      const float v = cum[i] + part[tid];
      cum[i] = v;
      cumg[i] = v;
    }
  }
  __syncthreads();
  const float total = cum[Q - 1];
  for (int i = tid; i < Q; i += NT) w[i] = expf(total - cum[i]);

  // this warp's rows na, na + 8 of the state and its columns from pc
  const int na = 16 * (warp % L::mt) + gid, pc = (warp / L::mt) * L::cols;
  float acc[NBW][4] = {};
  for (int j0 = 0; j0 < Q; j0 += TR) {
    cp_async_wait_all();
    __syncthreads();   // the tile landed (and w is stored); products done
    split_rows<TR, P, NT>(xbig, xsml, raw, w + j0, Q - j0);
    // A = B^T of the tile, ac[4 s + q] for k-step s: rows j = 8 s + t
    // (+ 4 for q >= 2) of the staged B rows, columns na (+ 8 for odd q)
    float ac[32];
#pragma unroll
    for (int s = 0; s < TR / 8; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ac[4 * s + q] = to_float(
            bst[(8 * s + tig + 4 * (q >> 1)) * LDA + na + 8 * (q & 1)]);
    __syncthreads();
    if (j0 + TR < Q) fetch(j0 + TR);
#pragma unroll
    for (int s = 0; s < TR / 8; ++s) {
      const float v[4] = {ac[4 * s], ac[4 * s + 1], ac[4 * s + 2],
                          ac[4 * s + 3]};
      const FragA<SA> fa(v);
#pragma unroll
      for (int nt = 0; nt < NBW; ++nt)
        product_rows<SA, true>(acc[nt], fa, xbig, xsml, LDB, 8 * s,
                               pc + 8 * nt + gid, tig);
    }
  }
  float* out = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
#pragma unroll
  for (int nt = 0; nt < NBW; ++nt) {
    const int p = pc + 8 * nt + 2 * tig;
    *reinterpret_cast<float2*>(out + na * P + p) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (na + 8) * P + p) =
        make_float2(acc[nt][2], acc[nt][3]);
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

// ---- 4. y per (b, h, chunk, block of OUT_ROWS rows) ------------------------
// the A operand's stage: cb rows (TR x kpitch<float, OUT_ROWS>) or rows of C
// (OUT_ROWS x rpitch<T, TR>), whichever is larger
constexpr int ASTAGE = 4 * (TR * (OUT_ROWS + 8) > OUT_ROWS * (TR + 4)
                                ? TR * (OUT_ROWS + 8)
                                : OUT_ROWS * (TR + 4));

template <int P>
__host__ __device__ constexpr size_t out_smem() {
  return sizeof(float) * (MAX_Q + (size_t)TR * P + 2 * (size_t)TR * (P + 8)) +
         ASTAGE;
}

template <typename T, int N, int P>
__global__ void __launch_bounds__(OUT_THREADS) ssd_out_kernel(Args g) {
  constexpr int KR = N < TR ? N : TR;   // rows of a tile of S
  constexpr int NS = N / KR;            // tiles of S
  constexpr int LDB = P + 8, NB = P / 8;
  constexpr int LDG = kpitch<float, OUT_ROWS>(), LDC = rpitch<T, KR>();
  constexpr bool SC = Split<T>::value;
  static_assert(TR * LDG * 4 <= ASTAGE &&
                    OUT_ROWS * LDC * sizeof(T) <= ASTAGE,
                "the A stage holds the cb rows and the rows of C");
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // TR x P: cp.async target
  float* bbig = raw + TR * P;                    // TR x LDB: S or x, big
  float* bsml = bbig + TR * LDB;                 // TR x LDB: small
  float* cumc = bsml + TR * LDB;                 // MAX_Q: the chunk's cum
  float* gst = cumc + MAX_Q;                     // TR x LDG: cb rows (A)
  T* cst = reinterpret_cast<T*>(gst);      // OUT_ROWS x LDC: C rows (A)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int Q = g.Q, S = g.S;
  const int nb = (Q + TR - 1) / TR, no = (Q + OUT_ROWS - 1) / OUT_ROWS;
  const int ob = no - 1 - (int)(blockIdx.x % no);   // longest blocks first
  const int c = blockIdx.x / no, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, i0 = ob * OUT_ROWS, grp = h / g.hpg;
  const long long bh = (long long)b * g.H + h;
  const float* cumg = g.cum + (bh * g.nc + c) * Q;
  const float* xb = g.x + b * g.xs_b + h * g.xs_h;
  const float* sg = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
  const T* cmb = static_cast<const T*>(g.cm) + b * g.cs_b + grp * g.cs_g;
  const float* cbc =
      g.cb + (((long long)b * g.G + grp) * g.nc + c) * Q * g.ldq;
  // the x tiles J = 0..I_last: up to the 64-row tile of the block's last
  // row inside the chunk
  const int last = (i0 + OUT_ROWS - 1) / TR;
  const int ntiles = NS + (last < nb - 1 ? last : nb - 1) + 1;
  // this thread's chunk rows ra and rb = ra + 8 (the warp's 16 rows, in
  // the 64-row tile I; a warp whose rows all lie past Q forms nothing;
  // other rows past Q are formed from whatever the stage holds and never
  // written: a product's row depends on its own row of A alone)
  const int ra = i0 + 16 * warp + gid, rb = ra + 8;
  const int I = (i0 + 16 * warp) / TR;
  const bool live = i0 + 16 * warp < Q;
  const float ca = ra < Q ? cumg[ra] : 0.f, cbv = rb < Q ? cumg[rb] : 0.f;
  const float ea = expf(ca), eb = expf(cbv);

  // tile t by cp.async: the B operand's rows raw (S rows t KR.., then x_J,
  // J = t - NS) and the A operand's (C_I's columns t KR.., then the cb rows
  // j of G_IJ, columns i0..: pieces past the row's ldq entries zero)
  auto fetch = [&](int t) {
    const int rows_i = min(Q, S - t0) - i0;   // C rows inside the sequence
    if (t < NS) {
      fetch_rows<KR, P, OUT_THREADS>(raw, sg + t * KR * P, P, KR, sg);
      fetch_tile<OUT_ROWS, KR * sizeof(T) / 16, OUT_THREADS>(
          cst, LDC * sizeof(T), cmb + (long long)(t0 + i0) * g.cs_s + t * KR,
          g.cs_s * sizeof(T), rows_i, KR * sizeof(T) / 16, cmb);
    } else {
      const int j0 = (t - NS) * TR, lim = min(Q - j0, S - t0 - j0);
      fetch_rows<TR, P, OUT_THREADS>(raw, xb + (long long)(t0 + j0) * g.xs_s,
                                     g.xs_s, lim < TR ? lim : TR, xb);
      fetch_tile<TR, OUT_ROWS / 4, OUT_THREADS>(
          gst, LDG * 4, cbc + (long long)j0 * g.ldq + i0, g.ldq * 4LL,
          Q - j0, (g.ldq - i0) / 4, cbc);
    }
    cp_async_commit();
  };

  fetch(0);
  for (int i = tid; i < Q; i += OUT_THREADS) cumc[i] = cumg[i];
  float acc[NB][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed (and cum is staged); products done
    // the A operand's values, ac[4 s + q] for k-step s: rows ra (even q)
    // and rb (odd q), k columns 8 s + t (+ 4 for q >= 2)
    float ac[32];
    if (t < NS) {
      split_rows<KR, P, OUT_THREADS>(bbig, bsml, raw, nullptr, 0);
#pragma unroll
      for (int s = 0; s < KR / 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ac[4 * s + q] = to_float(cst[(16 * warp + gid + 8 * (q & 1)) * LDC +
                                       8 * s + tig + 4 * (q >> 1)]);
    } else {
      split_rows<TR, P, OUT_THREADS>(bbig, bsml, raw, nullptr, 0);
#pragma unroll
      for (int s = 0; s < TR / 8; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          ac[4 * s + q] = gst[(8 * s + tig + 4 * (q >> 1)) * LDG +
                              16 * warp + gid + 8 * (q & 1)];
    }
    __syncthreads();
    if (t + 1 < ntiles) fetch(t + 1);
    if (!live) continue;
    if (t < NS) {
      // exp(cum_i) C_I . S: C exact when bf16
#pragma unroll
      for (int s = 0; s < KR / 8; ++s) {
        const float v[4] = {ac[4 * s], ac[4 * s + 1], ac[4 * s + 2],
                            ac[4 * s + 3]};
        const FragA<SC> fa(v);
#pragma unroll
        for (int nt = 0; nt < NB; ++nt)
          product_rows<SC, true>(acc[nt], fa, bbig, bsml, LDB, 8 * s,
                                 8 * nt + gid, tig);
      }
      if (t == NS - 1) {
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          acc[nt][0] *= ea; acc[nt][1] *= ea;
          acc[nt][2] *= eb; acc[nt][3] *= eb;
        }
      }
    } else {
      // (G_IJ o decay) x_J for J <= I; on the diagonal tile the k-steps
      // past this warp's last row are zero and skipped
      const int J = t - NS, j0 = J * TR;
      if (J > I) continue;
      const int ks = J == I ? 2 * (warp % 4) + 2 : TR / 8;
#pragma unroll
      for (int s = 0; s < TR / 8; ++s) {
        if (s < ks) {
          const int ja = j0 + 8 * s + tig, jb = ja + 4;
          const float cja = cumc[ja], cjb = cumc[jb];
          float v[4] = {ac[4 * s] * __expf(ca - cja),
                        ac[4 * s + 1] * __expf(cbv - cja),
                        ac[4 * s + 2] * __expf(ca - cjb),
                        ac[4 * s + 3] * __expf(cbv - cjb)};
          if (J == I) {   // masked before it multiplies: j <= i only
            v[0] = ja <= ra ? v[0] : 0.f;
            v[1] = ja <= rb ? v[1] : 0.f;
            v[2] = jb <= ra ? v[2] : 0.f;
            v[3] = jb <= rb ? v[3] : 0.f;
          }
          const FragA<true> fa(v);
#pragma unroll
          for (int nt = 0; nt < NB; ++nt)
            product_rows<true, true>(acc[nt], fa, bbig, bsml, LDB, 8 * s,
                                     8 * nt + gid, tig);
        }
      }
    }
  }

  float* yb = g.y + (long long)b * S * g.H * P + (long long)h * P;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = h2 ? rb : ra, t = t0 + i;
    if (i >= Q || t >= S) continue;
    float* yrow = yb + (long long)t * g.H * P;
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
      *reinterpret_cast<float2*>(yrow + 8 * nt + 2 * tig) =
          make_float2(acc[nt][2 * h2], acc[nt][2 * h2 + 1]);
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
    const size_t smem = cb_smem<N>(Split<T>::value);
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(nb * (nb + 1) / 2, g.nc, B * g.G), CB_THREADS, smem,
           stream>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  {
    auto kern = ssd_state_kernel<T, N, P>;
    const size_t smem = state_smem<T, N, P>();
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(g.nc, g.H, B), StateLayout<N, P>::threads, smem, stream>>>(
        g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  ssd_pass_kernel<N, P><<<dim3((N * P + PASS_THREADS - 1) / PASS_THREADS,
                               g.H, B), PASS_THREADS, 0, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  {
    auto kern = ssd_out_kernel<T, N, P>;
    const size_t smem = out_smem<P>();
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<dim3(g.nc * ((g.Q + OUT_ROWS - 1) / OUT_ROWS), g.H, B),
           OUT_THREADS, smem, stream>>>(g);
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
