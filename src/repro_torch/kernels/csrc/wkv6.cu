// RWKV6 WKV recurrence for Hopper (sm_90a): the chunked closed form with
// data-dependent per-channel decay, fp32 math on the CUDA cores, staged by
// groups of chunks so that the sequence runs in parallel across the card.
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
// and writes out (B, S, H, P) fp32 and the final S (B, H, P, P) fp32.  The
// TPU kernel builds the (Q, Q, P) tensor exp(cx_i - cum_j) for all (i, j)
// and selects zero for j >= i, where the argument is >= 0 and can overflow;
// here the pair term is formed so that no exponential can overflow (below).
//
// Bound.  Per (b, h) and chunk: the pair term's Q (Q - 1) / 2 x P terms
// (a difference, an exp, two products and a sum each), the inter-chunk and
// state terms 2 Q P^2 multiply-adds, the pair and bonus terms against v; r,
// k, v (2 bytes each in bf16), w and out (4 each) read or written once.  At
// the path's shape (B 1, S 8 192, H 64, P 64, Q 32, bf16 r/k/v) that is
// 12.70 Gflop against 0.471 GB: operations bound it, 0.190 ms at 67 TFLOP/s
// fp32 on the CUDA cores of an H100 SXM, against 0.141 ms for the bytes at
// 3.35 TB/s (chip_smoke.wkv_cost).
//
// Design.  The state is carried along the sequence, and one block per
// (b, h) walking every chunk would give 64 blocks for 132 SMs at B = 1,
// each waiting on its loads and barriers chunk after chunk.  So the chunks
// are cut into groups of GROUP = 16 (512 steps at Q 32; of 4, 8, 16 and 32
// chunks a group, timed at the path's shape on an NVIDIA H100 80GB HBM3 at
// 700.00 W, 16 was the fastest or level with it) and one call is three
// launches on one stream (scratch from the wrapper, torch.empty):
//   1. wkv_group_kernel, per (b, h, group): the group's own state
//      contribution dS_g from a zero state and its decay d_g = prod
//      exp(cum_{Q-1}), chained chunk by chunk as the plain version chains
//      its state (every exponent spans one chunk), into st (B, ng, H, P, P)
//      and dg (B, ng, H, P);
//   2. wkv_pass_kernel, per (b, h), one thread per state entry, in group
//      order: S_{g+1} = diag(d_g) S_g + dS_g; st[g] is overwritten by S_g,
//      the state entering group g, and the last S is the final state; its
//      loads go eight groups at a time;
//   3. wkv_out_kernel, per (b, h, group): the entering state into shared
//      memory and registers, then the group's chunks in order, as one block
//      per head would run them; out is written once.
// At B = 1, S 8 192 that is 1 024 blocks in steps 1 and 3 and 17 MB of
// scratch; the cost is reading k, v and w twice (+0.27 GB with bf16 k, v)
// and the scratch written, passed over and read (~0.07 GB): ~0.10 ms at
// 3.35 TB/s.  Step 3 repeats step 1's state update for GROUP - 1 of its
// GROUP chunks (the update after a group's last chunk is step 2's), so the
// kernels do 17.6 Gflop at the path's shape where the bound counts 12.7.
//
// A chunk in a block of 2P threads (P = 64: four warps; Map below):
//   a. its rows of r, k, v and w are copied to shared memory with cp.async
//      (16-byte pieces, zero filled past the chunk or the sequence).  The
//      group kernel double-buffers them: chunk c + 1's copies are in
//      flight while chunk c computes (a single buffer where two would not
//      fit).  The out kernel keeps one buffer and starts chunk c + 1's
//      copies once chunk c's pair term, the stage's last reader, is
//      formed: they fly during A . v and the state update, and three
//      blocks fit an SM (~76 KB a block at P 64, bf16);
//   b. two threads per key channel (the rows' halves) each sum all Q rows
//      of w in registers, in the same order, and keep exp(cum_{Q-1}) and
//      the midpoint m of cum's range (0 included); the range's largest
//      value over the channels is the chunk's decay span (a barrier);
//   c. from the registers: k * exp(cum_{Q-1} - cum), v in fp32, the bonus
//      r u k summed per row, and d's operands;
//   d. out = (r * exp(cx)) . S + A . v, A the Q x Q pair term with the bonus
//      on its diagonal, formed once per (b, h, chunk) for all P value
//      columns.  Where the span is at most FACTOR_SPAN (60), exp(cx_i -
//      cum_j) = exp(cx_i - m) exp(m - cum_j): A is a Q x Q x P product of
//      r * exp(cx - m) and k * exp(m - cum), every factor within e^+-30, and
//      only 2 Q P exponentials (the model's decay, ~0.1 a chunk, always
//      takes this form); the terms j >= i of the product, finite, are
//      selected away; r * exp(cx) is r * exp(cx - m) times exp(m).  Else
//      (phase 3's strong decay, ~700 a chunk) each term j < i is formed
//      directly from the staged r and k, cx_i = cum_{i-1} and cum_j, its
//      argument <= 0.  The test is uniform over the block.  The factored
//      form's extra error is a few ulps of the factors' arguments,
//      <= span * 2^-24 relative, inside the tolerance's 2^-20 * span;
//   e. the state update S' = diag(exp(cum_{Q-1})) S + (k * exp(..))^T v in
//      registers, then into shared memory for the next chunk's product.
// Every product is a register tile on float4 shared-memory loads (4 x 4
// outputs a thread for out, P/8 x 4 for the state, 2 x 4 for A at P 64),
// laid out so that each load of a warp reads distinct banks; their loops
// are unrolled twice or four times, not fully, which keeps the kernel's
// code small.  The per-element exponentials are __expf (ex2.approx after a
// product with log2 e: ~6e-8 |argument| relative, inside the tolerance's
// 2^-20 * span), the per-channel ones expf.  No tensor cores: tf32 or bf16
// products would break the 1e-5 tolerance, and error-compensated 3xTF32
// ones hardly paid in a probe (the kernel waits on latency more than on
// its multiply-adds).  Operands are read through element strides
// (b, s, h) with a contiguous P; every row starts on 16 bytes (the wrapper
// ensures it).  It builds without -fmad=false: it is held against its
// plain PyTorch version within a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_Q = 32;               // chunk rows
constexpr int GROUP = 16;               // chunks a group
constexpr int LDA = MAX_Q + 4;          // row pitch of the pair term A
constexpr float FACTOR_SPAN = 60.f;     // factored pair term up to this span
constexpr int PASS_THREADS = 256;
constexpr size_t SMEM_MAX = 232448;     // dynamic shared memory of a block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  float* out;
  float* state;
  float* st;    // (B, ng, H, P, P): dS_g, then the state entering group g
  float* dg;    // (B, ng, H, P): the group's decay prod_c exp(cum_{Q-1})
  long long st_[4][3];   // element strides (b, s, h) of r, k, v, w
  int S, H, Q, nc, ng;
};

// A block's threads and their tiles at head dim P: two threads per key
// channel, NT = 2P (four warps at P 64).
// - steps b and c: thread tid takes the channel tid % P and the rows
//   16 (tid / P) + {0..15}.
// - out (Q x P): thread (oy, ox) owns the rows oy + 8 a (a < 4) and the
//   columns 4 ox + {0..3}; a warp is 4 consecutive oy by 8 consecutive ox,
//   so each float4 load of a product reads distinct banks (rows pitch
//   P + 4).
// - the state (P x P): thread (ty, tx) owns the rows SR ty + {0..SR-1} and
//   the columns 4 tx + {0..3}; a warp is 4 ty by 8 tx.
// - the pair term A (Q x Q): thread (ty2, tx2) owns the rows ty2 + 16 a
//   (a < 2) and the columns tx2 + CG2 c (c < TN2); a warp is RY2 ty2 by
//   LX2 tx2.
template <int P>
struct Map {
  static constexpr int NT = 2 * P, NW = NT / 32, RPQ = MAX_Q / 2;
  static constexpr int OWC = P / 32;   // warps along out's columns
  static constexpr int TX = P / 4, SR = P / 8, SWC = TX / 8;
  static constexpr int TN2 = 256 / P, CG2 = MAX_Q / TN2;
  static constexpr int LX2 = CG2 >= 16 ? 4 : CG2, RY2 = 32 / LX2,
                       WC2 = CG2 / LX2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive floats of shared memory (N = 2 or a multiple of 4)
template <int N>
__device__ __forceinline__ void ldn(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int m = 0; m < N; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + m);
      o[m] = v.x; o[m + 1] = v.y; o[m + 2] = v.z; o[m + 3] = v.w;
    }
  } else {
    static_assert(N == 2, "ldn: 2 or a multiple of 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One chunk's rows in shared memory, as they are in global memory: r (only
// in step 3), k, v of type T and w, MAX_Q x P each.
template <typename T, int P, bool WITH_R>
struct Stage {
  static constexpr size_t rows = (size_t)MAX_Q * P;
  static constexpr size_t bytes =
      (WITH_R ? 3 : 2) * rows * sizeof(T) + rows * sizeof(float);
  T* r;
  T* k;
  T* v;
  float* w;
  __device__ Stage(char* base) {
    T* t = reinterpret_cast<T*>(base);
    r = WITH_R ? t : nullptr;
    k = t + (WITH_R ? rows : 0);
    v = k + rows;
    w = reinterpret_cast<float*>(v + rows);
  }
};

struct Rows {   // one (b, h)'s operand rows in global memory
  const void* r;
  const void* k;
  const void* v;
  const float* w;
};

template <typename T>
__device__ __forceinline__ Rows rows_of(const Args& g, int b, int h) {
  return {static_cast<const T*>(g.r) + b * g.st_[0][0] + h * g.st_[0][2],
          static_cast<const T*>(g.k) + b * g.st_[1][0] + h * g.st_[1][2],
          static_cast<const T*>(g.v) + b * g.st_[2][0] + h * g.st_[2][2],
          g.w + b * g.st_[3][0] + h * g.st_[3][2]};
}

// Start the copies of chunk c's MAX_Q rows into st: zero filled past the
// chunk (Q) or the sequence (S).
template <int NT, typename T, int P, bool WITH_R>
__device__ __forceinline__ void issue_chunk(const Stage<T, P, WITH_R>& st,
                                            const Args& g, const Rows& src,
                                            int c) {
  constexpr int CT = P * (int)sizeof(T) / 16, ET = 16 / (int)sizeof(T);
  constexpr int CW = P / 4;
  const int Q = g.Q, t0 = c * Q;
  for (int e = threadIdx.x; e < MAX_Q * CT; e += NT) {
    const int i = e / CT, o = (e % CT) * ET, t = t0 + i;
    const bool in = i < Q && t < g.S;
    const long long tt = in ? t : 0;
    if (WITH_R)
      cp16(st.r + i * P + o,
           static_cast<const T*>(src.r) + tt * g.st_[0][1] + o, in);
    cp16(st.k + i * P + o,
         static_cast<const T*>(src.k) + tt * g.st_[1][1] + o, in);
    cp16(st.v + i * P + o,
         static_cast<const T*>(src.v) + tt * g.st_[2][1] + o, in);
  }
  for (int e = threadIdx.x; e < MAX_Q * CW; e += NT) {
    const int i = e / CW, o = (e % CW) * 4, t = t0 + i;
    const bool in = i < Q && t < g.S;
    cp16(st.w + i * P + o, src.w + (in ? (long long)t : 0) * g.st_[3][1] + o,
         in);
  }
  cp_commit();
}

// Where steps b and c leave a chunk's operands (shared memory); the out
// kernel's arrays are null in the group kernel.
struct Prep {
  float* Dk;   // P: exp(cum_{Q-1})
  float* Kw;   // MAX_Q x P: k * exp(cum_{Q-1} - cum)
  float* Vs;   // MAX_Q x P: v in fp32
  float* Em;   // P: exp(m) (factored form), or 1
  float* Rs;   // MAX_Q x (P + 4): r * exp(cx - m), or r * exp(cx) (direct)
  float* Ks;   // MAX_Q x (P + 4): k * exp(m - cum), or cum (direct)
  float* Bp;   // MAX_Q x 4: the bonus partials, one per warp of a half
  float* Wm;   // NW: each warp's largest range of cum
};

// A chunk's key channel in registers: thread tid owns the channel
// p = tid % P and the half H = tid / P of the rows (RPQ H + n, n < RPQ),
// so a warp's 32 lanes read and write 32 consecutive channels of one row.
template <int RPQ>
struct Chan {
  float cum[MAX_Q];   // the cumulative sums of every row (rows past the
                      // chunk carry w = 0: their cum is cum_{Q-1})
  float r[RPQ], k[RPQ];   // the thread's rows
  float m;            // the midpoint of cum's range (0 included)
};

// Step b for the half H: every row's w summed down in order (both halves
// form bitwise the same sums), the half's r and k, v in fp32 into Vs;
// exp(cum_{Q-1}) into Dk; the range of cum into Wm (each warp's largest).
// Returns exp(cum_{Q-1}).
template <int RPQ, typename T, int P, bool OUT>
__device__ __forceinline__ float prep_scan(const Stage<T, P, OUT>& cur,
                                           const Prep& o, Chan<RPQ>& ch) {
  const int p = threadIdx.x % P, H = threadIdx.x / P;
#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) ch.cum[i] = cur.w[i * P + p];
#pragma unroll
  for (int n = 0; n < RPQ; ++n) {
    const int e = (RPQ * H + n) * P + p;
    ch.k[n] = to_f(cur.k[e]);
    ch.r[n] = OUT ? to_f(cur.r[e]) : 0.f;
    o.Vs[e] = to_f(cur.v[e]);
  }
  float lo = fminf(0.f, ch.cum[0]), hi = fmaxf(0.f, ch.cum[0]);
#pragma unroll
  for (int i = 1; i < MAX_Q; ++i) {
    ch.cum[i] += ch.cum[i - 1];
    lo = fminf(lo, ch.cum[i]);
    hi = fmaxf(hi, ch.cum[i]);
  }
  const float d = expf(ch.cum[MAX_Q - 1]);
  if (H == 0) o.Dk[p] = d;
  if (OUT) {
    ch.m = 0.5f * (lo + hi);
    float rg = hi - lo;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rg = fmaxf(rg, __shfl_xor_sync(FULL, rg, off));
    if ((threadIdx.x & 31) == 0) o.Wm[threadIdx.x >> 5] = rg;
  }
  return d;
}

// Step c for the half H: k * exp(cum_{Q-1} - cum) into Kw; with OUT, the
// operands into Rs, Ks and Em (factored: r * exp(cx - m), k * exp(m - cum)
// and exp(m); direct: r * exp(cx), cum and 1), the bonus r u k summed over
// the warp's channels into Bp.
template <int P, bool OUT, int RPQ>
__device__ __forceinline__ void prep_store(const Prep& o, const Chan<RPQ>& ch,
                                           bool fac, float u) {
  constexpr int LDP = P + 4;
  const int p = threadIdx.x % P, H = threadIdx.x / P;
  const float last = ch.cum[MAX_Q - 1];
  float fr = 0.f, fk = 0.f;
  if (OUT && fac) {
    fr = expf(-ch.m);
    fk = expf(ch.m - last);
  }
  if (OUT && H == 0) o.Em[p] = fac ? expf(ch.m) : 1.f;
  float bo[RPQ];
#pragma unroll
  for (int n = 0; n < RPQ; ++n) {
    // the half's rows by selects, so that ch.cum stays in registers
    const int i = RPQ * H + n;
    const float cum = H ? ch.cum[RPQ + n] : ch.cum[n];
    const float cx = n > 0 ? (H ? ch.cum[RPQ + n - 1] : ch.cum[n - 1])
                           : (H ? ch.cum[RPQ - 1] : 0.f);
    const float kw = ch.k[n] * __expf(last - cum);
    o.Kw[i * P + p] = kw;
    if (OUT) {
      const float re = ch.r[n] * __expf(cx);
      o.Rs[i * LDP + p] = fac ? re * fr : re;
      o.Ks[i * LDP + p] = fac ? kw * fk : cum;
      bo[n] = ch.r[n] * u * ch.k[n];
    }
  }
  if (OUT) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int n = 0; n < RPQ; ++n)
        bo[n] += __shfl_xor_sync(FULL, bo[n], off);
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int n = 0; n < RPQ; ++n)
        o.Bp[(RPQ * H + n) * 4 + (p >> 5)] = bo[n];
  }
}

// Step e: acc = diag(Dk) acc + Kw^T v over the MAX_Q rows j (zero past the
// chunk), for the state rows SR ty + {0..SR-1} and the columns
// 4 tx + {0..3}.  Kw (j, p) and v (j, q) fp32, row-major in shared memory,
// pitch P.
template <int P, int SR>
__device__ __forceinline__ void state_update(float (&acc)[SR][4],
                                             const float* Kw, const float* V,
                                             const float* Dk, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < SR; ++a) {
    const float d = Dk[SR * ty + a];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] *= d;
  }
#pragma unroll 4
  for (int j = 0; j < MAX_Q; ++j) {
    float x[SR], y[4];
    ldn<SR>(Kw + j * P + SR * ty, x);
    ldn<4>(V + j * P + 4 * tx, y);
#pragma unroll
    for (int a = 0; a < SR; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(x[a], y[q], acc[a][q]);
  }
}

// ---- 1. the group's state contribution, per (b, h, group) ------------------
template <typename T, int P>
struct GroupCfg {
  static constexpr size_t stage = Stage<T, P, false>::bytes;
  static constexpr size_t rest =
      sizeof(float) * (2 * (size_t)MAX_Q * P + P);
  static constexpr int NSTAGE = 2 * stage + rest <= SMEM_MAX ? 2 : 1;
  static constexpr size_t bytes = NSTAGE * stage + rest;
};

template <typename T, int P>
__global__ void __launch_bounds__(Map<P>::NT) wkv_group_kernel(Args g) {
  using C = GroupCfg<T, P>;
  using M = Map<P>;
  constexpr int SR = M::SR;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  Prep o{};
  o.Kw = reinterpret_cast<float*>(base + C::NSTAGE * C::stage);
  o.Dk = o.Kw + MAX_Q * P;
  o.Vs = o.Dk + P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = 4 * (warp / M::SWC) + (lane >> 3);
  const int tx = 8 * (warp % M::SWC) + (lane & 7);
  const int grp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = grp * GROUP, c1 = min(c0 + GROUP, g.nc);
  const Rows src = rows_of<T>(g, b, h);

  float acc[SR][4];
#pragma unroll
  for (int a = 0; a < SR; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
  float dprod = 1.f;   // for the channel tid (tid < P)

  if (C::NSTAGE == 2)
    issue_chunk<M::NT>(Stage<T, P, false>(base), g, src, c0);
  for (int c = c0; c < c1; ++c) {
    const Stage<T, P, false> cur(base + (C::NSTAGE == 2 ? (c - c0) & 1 : 0) *
                                            C::stage);
    if (C::NSTAGE == 1) {
      __syncthreads();   // the last chunk's readers are done
      issue_chunk<M::NT>(cur, g, src, c);
    }
    cp_wait_all();
    __syncthreads();     // chunk c is in; the last chunk's readers are done
    if (C::NSTAGE == 2 && c + 1 < c1)
      issue_chunk<M::NT>(
          Stage<T, P, false>(base + ((c + 1 - c0) & 1) * C::stage), g, src,
          c + 1);
    {   // b, c. cumulative sums, k * exp(cum_{Q-1} - cum), v in fp32
      Chan<M::RPQ> ch;
      const float d = prep_scan<M::RPQ>(cur, o, ch);
      if (tid < P) dprod *= d;
      prep_store<P, false>(o, ch, false, 0.f);
    }
    __syncthreads();
    state_update<P, SR>(acc, o.Kw, o.Vs, o.Dk, ty, tx);
  }
  const long long slot = ((long long)b * g.ng + grp) * g.H + h;
  float* so = g.st + slot * P * P;
#pragma unroll
  for (int a = 0; a < SR; ++a)
    *reinterpret_cast<float4*>(so + (SR * ty + a) * P + 4 * tx) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  if (tid < P) g.dg[slot * P + tid] = dprod;
}

// ---- 2. the state pass per (b, h), in group order --------------------------
template <int P>
__global__ void __launch_bounds__(PASS_THREADS) wkv_pass_kernel(Args g) {
  constexpr int UB = 8;   // groups whose loads are in flight together
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= P * P) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long gs = (long long)g.H * P * P;   // one group of st
  float* sp = g.st + ((long long)b * g.ng * g.H + h) * P * P + e;
  const float* dp = g.dg + ((long long)b * g.ng * g.H + h) * P + e / P;
  float s = 0.f;
  for (int g0 = 0; g0 < g.ng; g0 += UB) {
    float ds[UB], d[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int gi = g0 + u;
      ds[u] = gi < g.ng ? sp[gi * gs] : 0.f;
      d[u] = gi < g.ng ? dp[(long long)gi * g.H * P] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      const int gi = g0 + u;
      if (gi >= g.ng) break;
      sp[gi * gs] = s;   // the state entering group gi
      s = fmaf(d[u], s, ds[u]);
    }
  }
  g.state[((long long)b * g.H + h) * P * P + e] = s;
}

// ---- 3. out per (b, h, group) ----------------------------------------------
template <typename T, int P>
struct OutCfg {
  static constexpr int LDP = P + 4;   // pitch of the pair term's operands
  static constexpr size_t stage = Stage<T, P, true>::bytes;
  static constexpr size_t rest =
      sizeof(float) * ((size_t)MAX_Q * P + 2 * (size_t)MAX_Q * LDP +
                       (size_t)P * P + MAX_Q * LDA + (size_t)MAX_Q * P +
                       2 * P + 4 * MAX_Q + Map<P>::NW);
  static constexpr size_t bytes = stage + rest;   // one staging buffer
  static_assert(bytes <= SMEM_MAX, "out kernel: shared memory");
};

template <typename T, int P>
__global__ void __launch_bounds__(Map<P>::NT) wkv_out_kernel(Args g) {
  using C = OutCfg<T, P>;
  using M = Map<P>;
  constexpr int LDP = C::LDP, SR = M::SR, TN2 = M::TN2, CG2 = M::CG2;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  Prep o;
  o.Kw = reinterpret_cast<float*>(base + C::stage);
  o.Rs = o.Kw + MAX_Q * P;
  o.Ks = o.Rs + MAX_Q * LDP;
  float* Ss = o.Ks + MAX_Q * LDP;  // P x P: the state entering the chunk
  float* As = Ss + P * P;          // MAX_Q x LDA: the pair term, bonus
  o.Vs = As + MAX_Q * LDA;
  o.Dk = o.Vs + MAX_Q * P;
  o.Em = o.Dk + P;
  o.Bp = o.Em + P;
  o.Wm = o.Bp + 4 * MAX_Q;
  const float* Rs = o.Rs;
  const float* Ks = o.Ks;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = 4 * (warp / M::SWC) + (lane >> 3);
  const int tx = 8 * (warp % M::SWC) + (lane & 7);
  const int ty2 = M::RY2 * (warp / M::WC2) + lane / M::LX2;
  const int tx2 = M::LX2 * (warp % M::WC2) + lane % M::LX2;
  const int oy = 4 * (warp / M::OWC) + (lane >> 3);
  const int ox = 8 * (warp % M::OWC) + (lane & 7);
  const int grp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = g.Q, S = g.S, Kr = (Q + 3) & ~3;
  const int c0 = grp * GROUP, c1 = min(c0 + GROUP, g.nc);
  const Rows src = rows_of<T>(g, b, h);
  const float u = g.u[h * P + tid % P];   // u of the prep's channel

  // one staging buffer: chunk c + 1's copies start once chunk c's pair term,
  // the stage's last reader, is formed
  const Stage<T, P, true> cur(base);
  issue_chunk<M::NT>(cur, g, src, c0);
  // the entering state: in registers (the update) and shared memory
  float sacc[SR][4];
  {
    const float* si =
        g.st + (((long long)b * g.ng + grp) * g.H + h) * P * P;
#pragma unroll
    for (int a = 0; a < SR; ++a) {
      const int row = SR * ty + a;
      const float4 v =
          *reinterpret_cast<const float4*>(si + row * P + 4 * tx);
      sacc[a][0] = v.x; sacc[a][1] = v.y; sacc[a][2] = v.z; sacc[a][3] = v.w;
      *reinterpret_cast<float4*>(Ss + row * P + 4 * tx) = v;
    }
  }
  float* ob = g.out + (long long)h * P;

  for (int c = c0; c < c1; ++c) {
    cp_wait_all();
    __syncthreads();     // chunk c is in; the last chunk's readers are done
    // b, c. cumulative sums, the chunk's operands, the bonus
    bool fac;
    {
      Chan<M::RPQ> ch;
      prep_scan<M::RPQ>(cur, o, ch);
      __syncthreads();
      float span = o.Wm[0];
#pragma unroll
      for (int k = 1; k < M::NW; ++k) span = fmaxf(span, o.Wm[k]);
      fac = span <= FACTOR_SPAN;   // uniform over the block
      prep_store<P, true>(o, ch, fac, u);
    }
    __syncthreads();

    // d1. out = (r * exp(cx)) . S (rows oy + 8 a, columns 4 ox + q), from
    // Rs: r * exp(cx - m) times exp(m) (factored form), r * exp(cx) times 1
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
#pragma unroll 2
    for (int k = 0; k < P; k += 4) {
      float x[4][4], y[4][4], em[4];
      ldn<4>(o.Em + k, em);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ldn<4>(Rs + (oy + 8 * a) * LDP + k, x[a]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) x[a][kk] *= em[kk];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldn<4>(Ss + (k + kk) * P + 4 * ox, y[kk]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[a][q] = fmaf(x[a][kk], y[kk][q], acc[a][q]);
    }

    // d2. the pair term A_ij (j < i), the bonus on the diagonal, zero above
    {
      float a2[2][TN2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < TN2; ++q) a2[a][q] = 0.f;
      if (fac) {
#pragma unroll 2
        for (int k = 0; k < P; k += 4) {
          float x[2][4], y[TN2][4];
#pragma unroll
          for (int a = 0; a < 2; ++a)
            ldn<4>(Rs + (ty2 + 16 * a) * LDP + k, x[a]);
#pragma unroll
          for (int q = 0; q < TN2; ++q)
            ldn<4>(Ks + (tx2 + CG2 * q) * LDP + k, y[q]);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int q = 0; q < TN2; ++q)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                a2[a][q] = fmaf(x[a][kk], y[q][kk], a2[a][q]);
        }
      } else {
        bool live[2][TN2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < TN2; ++q) {
            const int i = ty2 + 16 * a, j = tx2 + CG2 * q;
            live[a][q] = j < i && i < Q;
          }
        for (int pp = 0; pp < P; ++pp) {   // Ks: cum; cx_i = cum_{i-1}
          float ri[2], ci[2], kj[TN2], cj[TN2];
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int i = ty2 + 16 * a;
            ri[a] = to_f(cur.r[i * P + pp]);
            ci[a] = i > 0 ? Ks[(i - 1) * LDP + pp] : 0.f;   // cx = cum_{i-1}
          }
#pragma unroll
          for (int q = 0; q < TN2; ++q) {
            const int j = tx2 + CG2 * q;
            kj[q] = to_f(cur.k[j * P + pp]);
            cj[q] = Ks[j * LDP + pp];
          }
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int q = 0; q < TN2; ++q)
              if (live[a][q])
                a2[a][q] += ri[a] * kj[q] * __expf(ci[a] - cj[q]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = ty2 + 16 * a;
        float bonus = 0.f;
#pragma unroll
        for (int k = 0; k < P / 32; ++k) bonus += o.Bp[i * 4 + k];
#pragma unroll
        for (int q = 0; q < TN2; ++q) {
          const int j = tx2 + CG2 * q;
          As[i * LDA + j] = j < i ? a2[a][q] : (j == i ? bonus : 0.f);
        }
      }
    }
    __syncthreads();   // A is stored; every reader of Ss and the stage done
    if (c + 1 < c1) issue_chunk<M::NT>(cur, g, src, c + 1);

    // d3. out += A . v; write out
#pragma unroll 2
    for (int k = 0; k < Kr; k += 4) {
      float x[4][4], y[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ldn<4>(As + (oy + 8 * a) * LDA + k, x[a]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldn<4>(o.Vs + (k + kk) * P + 4 * ox, y[kk]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[a][q] = fmaf(x[a][kk], y[kk][q], acc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = oy + 8 * a, t = c * Q + i;
      if (i < Q && t < S)
        *reinterpret_cast<float4*>(ob + ((long long)b * S + t) * g.H * P +
                                   4 * ox) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }

    // e. the state entering the next chunk of the group
    if (c + 1 < c1) {
      state_update<P, SR>(sacc, o.Kw, o.Vs, o.Dk, ty, tx);
#pragma unroll
      for (int a = 0; a < SR; ++a)
        *reinterpret_cast<float4*>(Ss + (SR * ty + a) * P + 4 * tx) =
            make_float4(sacc[a][0], sacc[a][1], sacc[a][2], sacc[a][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int P>
int launch(const Args& g, int B, cudaStream_t stream) {
  cudaError_t err;
  const dim3 groups(g.ng, g.H, B);
  {
    auto kern = wkv_group_kernel<T, P>;
    const size_t smem = GroupCfg<T, P>::bytes;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<groups, Map<P>::NT, smem, stream>>>(g);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  wkv_pass_kernel<P><<<dim3((P * P + PASS_THREADS - 1) / PASS_THREADS, g.H, B),
                       PASS_THREADS, 0, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  {
    auto kern = wkv_out_kernel<T, P>;
    const size_t smem = OutCfg<T, P>::bytes;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<groups, Map<P>::NT, smem, stream>>>(g);
  }
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
// dim P is contiguous in each and every row starts on 16 bytes; u (H, P),
// out (B, S, H, P) and state (B, H, P, P) are contiguous fp32; scratch: st
// (B, ng, H, P, P) and dg (B, ng, H, P) fp32, nc = ceil(S / Q) chunks in
// ng = ceil(nc / GROUP) groups.  dtype: 0 = fp32, 1 = bf16 (r, k and v alike;
// w and u are fp32).  Launches three kernels on the stream; returns the
// first cudaError_t (0 = all launched); cudaErrorInvalidValue for an
// unsupported P or chunk.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* out, void* state,
                        void* st, void* dg, const long long* strides, int B,
                        int S, int H, int P, int Q, int dtype,
                        void* stream) {
  if (Q < 1 || Q > MAX_Q) return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.out = static_cast<float*>(out);
  a.state = static_cast<float*>(state);
  a.st = static_cast<float*>(st);
  a.dg = static_cast<float*>(dg);
  for (int t = 0; t < 4; ++t)
    for (int d = 0; d < 3; ++d) a.st_[t][d] = strides[3 * t + d];
  a.S = S;
  a.H = H;
  a.Q = Q;
  a.nc = (S + Q - 1) / Q;
  a.ng = (a.nc + GROUP - 1) / GROUP;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_p<float>(P, a, B, s);
  return launch_p<__nv_bfloat16>(P, a, B, s);
}

extern "C" int wkv6_max_chunk() { return MAX_Q; }

extern "C" int wkv6_group() { return GROUP; }

extern "C" float wkv6_factor_span() { return FACTOR_SPAN; }

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
