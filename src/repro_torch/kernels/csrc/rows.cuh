// Row access shared by the elementwise kernels that read activations
// 16 bytes at a time and reduce a row across a block: mamba_glue.cu (the
// Mamba2 layer's prologue and epilogue) and rms_norm.cu.
//
//   Row8<T>      8 elements of T (bf16 or fp32) as raw 16-byte words
//   load8        8 elements through the read-only path, raw or as floats
//   unpack       raw words to 8 floats (bf16 widened exactly)
//   store8       8 floats rounded to T (round to nearest even) and stored
//   block_sum    the sum of one float over a block (warp shuffles, one
//                shared word a warp), every thread gets it
//
// Every pointer handed to load8 / store8 is 16-byte aligned: the wrappers
// check or ensure it (kernels/build.py::aligned16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 8;               // elements a thread loads from a row

// 8 elements of T as raw 16-byte words (one for bf16, two for fp32)
template <typename T>
struct Row8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Row8<T> load8(const T* p) {
  Row8<T> r;
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = __ldg(q + i);
  return r;
}

__device__ __forceinline__ void bf16x2(unsigned v, float& lo, float& hi) {
  lo = __uint_as_float(v << 16);
  hi = __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ void unpack(const Row8<__nv_bfloat16>& r,
                                       float (&f)[V]) {
  bf16x2(r.u[0].x, f[0], f[1]);
  bf16x2(r.u[0].y, f[2], f[3]);
  bf16x2(r.u[0].z, f[4], f[5]);
  bf16x2(r.u[0].w, f[6], f[7]);
}

__device__ __forceinline__ void unpack(const Row8<float>& r, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(r.u[i].x);
    f[4 * i + 1] = __uint_as_float(r.u[i].y);
    f[4 * i + 2] = __uint_as_float(r.u[i].z);
    f[4 * i + 3] = __uint_as_float(r.u[i].w);
  }
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[V]) {
  unpack(load8(p), f);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&f)[V]) {
  uint4 u;
  u.x = bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
  u.y = bf16_bits(f[2]) | (bf16_bits(f[3]) << 16);
  u.z = bf16_bits(f[4]) | (bf16_bits(f[5]) << 16);
  u.w = bf16_bits(f[6]) | (bf16_bits(f[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[V]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// the block's sum of v (blockDim.x a multiple of 32)
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

}  // namespace
