// The scalar helpers every kernel shares: conversion into the accumulator
// type (to_acc), rounding stores (store, store4), vector loads (load4) and
// the float-reciprocal division (div_fast), with the limits of the kernels'
// launches.  The kernels themselves (chain_fwd.cu, chain_bwd.cu, grad.cu,
// sliced.cu, sliced_t.cu) build on kron_async.cuh, which includes this file.
//
// dtype codes shared with the Python wrappers: 0 float32 (acc float32),
// 1 bfloat16 (acc float32), 2 float64 (acc float64).  Intermediates stay in
// the accumulator type inside a block; only stores to device memory round
// to the input type.  Every global offset is 64-bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace kron {

constexpr int kMaxFactors = 16;
constexpr int kRQ = 4;  // factor-panel columns of one vector
constexpr size_t kMaxSmemBytes = 232448;  // 227 KB: one Hopper block's limit
// A block that leaves room for a second on its SM: half of the SM's 228 KB,
// less the 1 KB the runtime holds for each resident block.
constexpr size_t kTwoBlockSmemBytes = 233472 / 2 - 1024;

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
// Four consecutive elements in one (float, double: two) vector store; the
// address is 16-byte aligned for float and double, 8-byte for bfloat16.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v[0], v[1]);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// n / d for 0 <= n < 2^22 and d >= 1, given rd = 1.0f / d.  The float
// estimate is off by at most one and is corrected; a few instructions
// instead of an integer division.
__device__ __forceinline__ int div_fast(int n, int d, float rd) {
  int q = __float2int_rz(__int2float_rn(n) * rd);
  const int r = n - q * d;
  if (r < 0) {
    --q;
  } else if (r >= d) {
    ++q;
  }
  return q;
}

}  // namespace kron
