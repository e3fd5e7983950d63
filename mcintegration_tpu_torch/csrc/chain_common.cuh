// Helpers shared by the chain kernels (chain_*.cu) and the :mcmc kernels
// (mcmc_*.cu, through mcmc_common.cuh).
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

// #{k < n: c[k] <= u} for a non-decreasing c (upper-bound binary search).
__device__ __forceinline__ int count_le(const float* c, int n, float u) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (c[lo + half] <= u) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The first fields of a leaf row, the same in both layouts
// (ops/chain_kernels.py:LEAF_FIELDS, ops/mcmc_kernels.py:LEAF_FIELDS).
constexpr int kKind = 0, kNb = 1, kTab = 2, kSm = 3, kLower = 4;
constexpr int kDisc = 1;

// Leaf f's map draw at uniform u (Continuous or Discrete): val's bits,
// gidx, prob (ops/grid.py:sample_continuous, sample_discrete).
//   Continuous: iy = clip(int(u*nb)), x = grid[iy] + (u*nb - iy)*inc[iy],
//               prob = 1/(nb*inc[iy])
//   Discrete:   gidx = #{k: u >= cdf[k+1]}, clamped to nbin-1, prob = dist[gidx]
// A Discrete CDF is read from shared memory when the leaf has one staged
// there (sm >= 0), else from the table in device memory.
__device__ __forceinline__ void map_draw(const int* f, const float* tab,
                                         const float* smem, float u, int& val,
                                         int& gidx, float& prob) {
  const int nb = f[kNb];
  const float* t = tab + f[kTab];
  if (f[kKind] == kDisc) {   // t = cdf [nb+1], then dist [nb]
    const float* c = f[kSm] >= 0 ? smem + f[kSm] : t + 1;
    const int g = min(count_le(c, nb, u), nb - 1);
    gidx = g;
    prob = t[nb + 1 + g];
    val = f[kLower] + g;
  } else {                   // t = grid [nb], then inc [nb]
    const float s = __fmul_rn(u, (float)nb);
    const int iy = min(max((int)s, 0), nb - 1);
    const float dy = __fsub_rn(s, (float)iy);
    const float dx = t[nb + iy];
    gidx = iy;
    prob = __fdiv_rn(1.0f, __fmul_rn((float)nb, dx));
    val = __float_as_int(__fadd_rn(t[iy], __fmul_rn(dy, dx)));
  }
}

// Stage the leaves' small Discrete CDFs (sm >= 0) in shared memory; leaf
// rows are ``fields`` ints apart.
__device__ __forceinline__ void stage_cdfs(const int* leaf, int L, int fields,
                                           const float* tab, float* smem) {
  for (int d = 0; d < L; ++d) {
    const int* f = leaf + fields * d;
    if (f[kKind] == kDisc && f[kSm] >= 0)
      for (int q = threadIdx.x; q < f[kNb]; q += blockDim.x)
        smem[f[kSm] + q] = tab[f[kTab] + 1 + q];
  }
  __syncthreads();
}

// A walker's weight (pallas_chain.py:459-471, pallas_mcmc.py:526-551):
// float32, or with kCplx a complex64 value, read and written as an
// interleaved (re, im) float2 (torch.view_as_real of the complex64 tensor,
// no copy).  Its algebra is written out on the pair with _rn intrinsics:
//   |w|   = sqrt(re*re + im*im)   (not hypot: sqrt(fl(x*x)) = |x| for a
//                                  real x, so w + 0i gives the real run's |w|)
//   |w|^2 = re*re + im*im
//   w*f   = (re*f, im*f)           for a real factor f
// The real weight's operations are the ones the real kernels always ran.
template <bool kCplx> struct Weight;

template <> struct Weight<false> {
  float v;
  static __device__ __forceinline__ Weight load(const float* p, long long i) {
    return {p[i]};
  }
  __device__ __forceinline__ void store(float* p, long long i) const { p[i] = v; }
  __device__ __forceinline__ float abs() const { return fabsf(v); }
  __device__ __forceinline__ float abs2() const { return __fmul_rn(v, v); }
  __device__ __forceinline__ Weight scale(float f) const { return {__fmul_rn(v, f)}; }
  // obs[i] += w, walker w of the [ncomp, W] float64 accumulators
  __device__ __forceinline__ void add_to(double* obs, int i, int W, int w) const {
    obs[(long long)i * W + w] += (double)v;
  }
};

template <> struct Weight<true> {
  float re, im;
  static __device__ __forceinline__ Weight load(const float* p, long long i) {
    const float2 z = reinterpret_cast<const float2*>(p)[i];
    return {z.x, z.y};
  }
  __device__ __forceinline__ void store(float* p, long long i) const {
    reinterpret_cast<float2*>(p)[i] = make_float2(re, im);
  }
  __device__ __forceinline__ float abs2() const {
    return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
  __device__ __forceinline__ float abs() const { return __fsqrt_rn(abs2()); }
  __device__ __forceinline__ Weight scale(float f) const {
    return {__fmul_rn(re, f), __fmul_rn(im, f)};
  }
  // obs[2i] += re, obs[2i+1] += im: the components of complex value i
  __device__ __forceinline__ void add_to(double* obs, int i, int W, int w) const {
    obs[(long long)(2 * i) * W + w] += (double)re;
    obs[(long long)(2 * i + 1) * W + w] += (double)im;
  }
};

// The lanes of mask that hold the same key merge their values: the lowest
// lane of each key gets true and, in v, the sum of its key's values (its
// own first, then the others' in lane order); the others get false.  Every
// lane of mask calls it.  So one lane per key adds into a histogram bin,
// and no two lanes of a warp add to one bin at once: a hot bin costs a
// warp one add, not 32.
__device__ __forceinline__ bool merge_by_key(unsigned mask, int key, double& v) {
  const unsigned peers = __match_any_sync(mask, key);
  const int lane = threadIdx.x & 31;
  const bool lead = (peers & ((1u << lane) - 1u)) == 0u;
  unsigned rest = lead ? peers & ~(1u << lane) : 0u;
  const double mine = v;
  while (__any_sync(mask, rest != 0u)) {
    const double t = __shfl_sync(mask, mine, rest ? __ffs(rest) - 1 : lane);
    if (rest) {
      v += t;
      rest &= rest - 1u;
    }
  }
  return lead;
}

// Ask for the line holding p in L1 (prefetch_l1) or in L2 (prefetch_l2),
// ahead of the load that needs it.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return n;
}

// Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared memory
// that one SM of the current device holds for ``kernel``, into *per_sm;
// above 48 KiB the kernel is first allowed that much.  Returns a
// cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem, int* per_sm) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidConfiguration;
  return (int)e;
}

}  // namespace
