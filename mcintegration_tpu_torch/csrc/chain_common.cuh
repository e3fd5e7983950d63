// Helpers shared by chain_propose.cu and chain_accept.cu.
//
// Random bits: the counter hash of ops/rng.py (lowbias32, as
// mcintegration_tpu/ops/pallas_vegas.py:_mix32), with the step t in place of
// the chunk and the walker's index j within its block as the flat index:
//   k1 = mix32(kd[b,0] ^ t*0x9E3779B9), k2 = mix32(kd[b,1] + t),
//   draw c = mix32(mix32(j ^ k1) + k2 + c*0x85EBCA6B),
// and a uniform in (0, 1) is ((bits >> 8) + 0.5) * 2^-24, the grain of
// mcintegration_tpu/ops/grid.py:uniform_open01.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeafFields = 8;   // kind, nb, tab_off, sm_off, lower, slot0, hist_off, group

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// mix32(j ^ k1) + k2 for walker w of block b = w / wb at step t.
__device__ __forceinline__ uint32_t walker_base(const uint32_t* kd, uint32_t t,
                                                int w, int wb) {
  const int b = w / wb;
  const uint32_t j = (uint32_t)(w - b * wb);
  const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
  const uint32_t k2 = mix32(kd[2 * b + 1] + t);
  return mix32(j ^ k1) + k2;
}

__device__ __forceinline__ float uniform(uint32_t base, uint32_t c) {
  const uint32_t bits = mix32(base + c * 0x85EBCA6Bu);
  return __fmul_rn(__fadd_rn((float)(bits >> 8), 0.5f), 5.9604644775390625e-08f);
}

int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

}  // namespace
