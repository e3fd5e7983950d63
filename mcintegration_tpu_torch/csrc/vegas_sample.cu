// vegas_sample: the stratified Vegas draw of the :vegas solver.
//
// Replaces the draw half of mcintegration_tpu/ops/pallas_vegas.py:build_run_all
// (lines 396-441): per (slot, block, chunk) a random strata permutation
// perm(p) = (a*p + s) mod nb, the map lookup, and x = grid[perm] + dy*inc[perm]
// for every stratum p and sample q; per (slot, block, chunk, p) also
// invp = nb*inc[perm] (1/probability) and perm itself, which vegas_reduce
// needs for the Jacobian and the histogram.
//
// Random bits: the counter hash of pallas_vegas.py:_make_rng's interpret path
// (lines 79-91), bit for bit, so a given kd reproduces the JAX kernel run in
// interpret mode and the plain torch version in ops/rng.py.
//
// What bounds it on the card: device-memory bytes.  Each sample costs one
// 4-byte store of x (the grid tables, 8 bytes per bin, stay in L1/L2), and
// two lowbias32 hashes of arithmetic.  The design keeps the per-(slot, block,
// chunk) work (keys, s, a) once per thread and strides each thread over a few
// samples of one chunk, with neighbouring threads on neighbouring addresses.
//
// Deliberately simple: a plain gather replaces the TPU's one-hot MXU lookup;
// wgmma and TMA have no role here (no matrix product, no tile reuse).  Fusing
// the draw with the integrand, so x never reaches device memory, is later work.
//
// Built with --fmad=false (ops/_build.py); the explicit _rn intrinsics below
// pin the rounding anyway, so x matches the plain torch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNMult = 64;       // multiplier-table width (solvers/vegas.py)
constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t draw(uint32_t k1, uint32_t k2,
                                         uint32_t idx, uint32_t c) {
  return mix32(mix32(idx ^ k1) + k2 + c * 0x85EBCA6Bu);
}

// grid: x = (nslots*B*T groups, chunk splits); one group = one
// (slot k, block b, chunk t) with nb*m samples laid out [nb, m].
__global__ void vegas_sample_kernel(const uint32_t* __restrict__ kd, int t0,
                                    int B, int T, int nb, int m,
                                    const int32_t* __restrict__ atab,
                                    const float* __restrict__ grid,
                                    const float* __restrict__ inc,
                                    const int32_t* __restrict__ slot_leaf,
                                    float* __restrict__ x,
                                    float* __restrict__ invp,
                                    int32_t* __restrict__ perm_out) {
  const long long g = blockIdx.x;
  const int tl = (int)(g % T);
  const int b = (int)((g / T) % B);
  const int k = (int)(g / ((long long)T * B));
  const uint32_t t = (uint32_t)(t0 + tl);
  const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
  const uint32_t k2 = mix32(kd[2 * b + 1] + t);
  const uint32_t c = 3u * (uint32_t)k;
  const int s = (int)(draw(k1, k2, 0u, c + 1u) & 0x7FFFFFFFu) % nb;
  const int j = (int)(draw(k1, k2, 0u, c + 2u) & 0x7FFFFFFFu) % kNMult;
  const int a = atab[k * kNMult + j];
  const float* gr = grid + (long long)slot_leaf[k] * nb;
  const float* ic = inc + (long long)slot_leaf[k] * nb;
  const float fnb = (float)nb;

  const uint32_t chunk = (uint32_t)nb * (uint32_t)m;
  float* xg = x + g * (long long)chunk;
  float* ig = invp + g * nb;
  int32_t* pg = perm_out + g * nb;
  for (uint32_t e = blockIdx.y * blockDim.x + threadIdx.x; e < chunk;
       e += gridDim.y * blockDim.x) {
    const uint32_t p = e / (uint32_t)m;
    const uint32_t q = e - p * (uint32_t)m;
    const int pm = (a * (int)p + s) % nb;   // int32 as the reference; nb <= 32768
    const float dx = ic[pm];
    const uint32_t u = draw(k1, k2, e, c + 3u);   // flat index p*m + q
    const float dy = __fmul_rn(__fadd_rn((float)(u & 0xFFFFFFu), 0.5f),
                               5.9604644775390625e-08f);   // 2^-24
    xg[e] = __fadd_rn(gr[pm], __fmul_rn(dy, dx));
    if (q == 0) {
      ig[p] = __fmul_rn(fnb, dx);
      pg[p] = pm;
    }
  }
}

}  // namespace

extern "C" int mci_vegas_sample(const void* kd, int t0, int B, int T, int nb,
                                int m, int nslots, const void* atab,
                                const void* grid, const void* inc,
                                const void* slot_leaf, void* x, void* invp,
                                void* perm, void* stream) {
  const long long groups = (long long)nslots * B * T;
  const long long chunk = (long long)nb * m;
  long long splits = (chunk + kThreads * kItemsPerThread - 1) /
                     (kThreads * kItemsPerThread);
  if (splits > 65535) splits = 65535;
  dim3 grid_dim((unsigned)groups, (unsigned)splits);
  vegas_sample_kernel<<<grid_dim, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, t0, B, T, nb, m, (const int32_t*)atab,
      (const float*)grid, (const float*)inc, (const int32_t*)slot_leaf,
      (float*)x, (float*)invp, (int32_t*)perm);
  return (int)cudaGetLastError();
}

extern "C" const char* mci_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
