// Correctly rounded arithmetic in a kernel's real type: float, with the _rn
// intrinsics the float32 kernels always used, or double, with their float64
// twins, for integrate(dtype=torch.float64).  The float64 instantiations of
// vegas_sample.cu, vegas_reduce.cu, vegas_mixed.cu and vplus_*.cu take their
// tables, coordinates, densities and real weights in double and keep the
// uniforms and complex weights float32, as the JAX package's float64 mode
// does (mcintegration_tpu/ops/grid.py:153-162, main.py:341).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// The weights' non-finite guard, where a kernel loads w: a value is kept
// only if it is finite, else read as +0 (torch.where(torch.isfinite(w), w,
// 0)); a complex value is kept only if both of its parts are finite
// (chain_common.cuh: Weight::finite).  |a| < inf is false for an infinity
// and for a NaN: one comparison and one select a value.
__device__ __forceinline__ bool is_finite(float a) { return fabsf(a) < CUDART_INF_F; }
__device__ __forceinline__ bool is_finite(double a) { return fabs(a) < CUDART_INF; }
template <typename R> __device__ __forceinline__ R finite_or_zero(R a) {
  return is_finite(a) ? a : (R)0;
}

// The element of w (and of a measure's output m) beside tables of R: R for
// real weights, float for complex64 ones, read as (re, im) float pairs
template <bool kCplx, typename R>
using elem_t = typename std::conditional<kCplx, float, R>::type;

// A sample's bits in x: an int beside a float, a long long beside a double
// (a Discrete value's int32, sign-extended: ops/vplus_kernels.py:leaf_values
// reads the low word)
template <typename R>
using bits_t = typename std::conditional<sizeof(R) == 4, int, long long>::type;
__device__ __forceinline__ int as_bits(float v) { return __float_as_int(v); }
__device__ __forceinline__ long long as_bits(double v) { return __double_as_longlong(v); }

template <typename T> struct Same { using type = T; };   // keeps a parameter out of deduction

}  // namespace
