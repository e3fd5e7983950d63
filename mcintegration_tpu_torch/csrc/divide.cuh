// Floor division by a runtime divisor as a multiply and a shift, shared by
// the kernels that index by quotients (vegas_sample.cu, vplus_sample.cu,
// chain_propose.cu).  The launcher forms (mul, shift) once on the host; a
// kernel then spends two instructions where an integer division by a
// runtime divisor costs about twenty (I2F.U32.RP and its Newton step).
//
// divisor(n): shift = 31 + l, l = ceil(log2 n), mul = ceil(2^shift / n) <
// 2^32.  With e = mul*n - 2^shift < n, x*mul / 2^shift = x/n + x*e / (n
// 2^shift), and for 0 <= x < 2^31 the second term is below 2^31 * n /
// (n 2^(31+l)) = 2^-l <= 1/n, too little to carry x/n past the next
// integer.  So divide(x, mul, shift) = floor(x / n) for every 0 <= x < 2^31
// (held to floor division in tests/test_torch_sample_reduce.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// floor(x / n) for 0 <= x < 2^31 as (x * mul) >> shift (divisor below).
__device__ __forceinline__ uint32_t divide(uint32_t x, uint32_t mul, int shift) {
  return (uint32_t)(((unsigned long long)x * mul) >> shift);
}

// (mul, shift) of n >= 1 for divide, on the host.
inline void divisor(uint32_t n, uint32_t& mul, int& shift) {
  int l = 0;
  while ((1ull << l) < n) ++l;
  shift = 31 + l;
  mul = (uint32_t)(((1ull << shift) + n - 1) / n);
}

}  // namespace
