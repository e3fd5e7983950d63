// vplus_sample: the draw of the :vegasplus solver.
//
// Replaces the sampling half of mcintegration_tpu/ops/pallas_vplus.py:
// build_vplus_run_all (lines 251-272), with the law of the JAX package's XLA
// route (mcintegration_tpu/solvers/vegasplus.py:184-212).  Sample s of chunk
// t of block b lies in the hypercube cube[s] (the samples of a chunk are
// cube-major, the same layout in every chunk).  Per kernel slot k, with u the
// slot's uniform from the counter hash:
//   Continuous (stratified dim d, stride = nstrat^d):
//     coord = (cube / stride) % nstrat,  y = (coord + u) / nstrat,
//     iy = clip(int(y*ninc)),  x = grid[iy] + (y*ninc - iy)*inc[iy]
//   Discrete (a passenger, not stratified): gidx = #{j: u >= cdf[j+1]},
//     clamped to nbin-1, x = lower + gidx (int32 bits)
// and the outputs are x[k, b, t, s] and the bin gidx[k, b, t, s]; the reduce
// kernel reads the densities back from the tables at gidx.  y*ninc may land
// one bin into the neighbouring cube at a cube's edge (ninc need not be a
// multiple of nstrat); the density uses the bin actually hit, so the
// estimator stays unbiased, as in the reference.
//
// The TPU kernel gives each 128-wide lane one cube and picks the bin by an
// R-way select on a coarsened map, because a TPU has no gather; here the
// full map is gathered and any nstrat and any counts are served.
//
// Random bits (ops/rng.py): k1 = mix32(kd[b,0] ^ t*0x9E3779B9),
// k2 = mix32(kd[b,1] + t), draw of slot k = mix32(mix32(s ^ k1) + k2 +
// salt_k*0x85EBCA6B), uniform = ((bits >> 8) + 0.5) * 2^-24.
//
// What bounds it on the card: device-memory bytes, 8 bytes written per
// sample and slot (x and gidx); the tables and cube[] stay in cache.  It runs
// at about twice that bound: per slot a hash, two integer divisions for the
// cube's coordinate, a float division and the map's two gathers.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding, so x and gidx match the plain version bit for bit.

#include "vplus_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;    // samples of a chunk per thread

// blockIdx.y strides over the (block, chunk) pairs, blockIdx.x over the
// samples of a chunk: no 64-bit division per sample.
__global__ void vplus_sample_kernel(const uint32_t* __restrict__ kd, int t0,
                                    int B, int T, int c, int S, int nstrat,
                                    const int* __restrict__ cube,
                                    const int* __restrict__ meta,
                                    const float* __restrict__ tab,
                                    int* __restrict__ x, int* __restrict__ gidx) {
  const int BT = B * T;
  const long long plane = (long long)BT * c;     // one slot's samples
  const float fns = (float)nstrat;
  for (int bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const int b = bt / T;
    const uint32_t t = (uint32_t)(t0 + bt - b * T);
    const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
    const uint32_t k2 = mix32(kd[2 * b + 1] + t);
    for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < c;
         s += gridDim.x * blockDim.x) {
      const uint32_t base = mix32((uint32_t)s ^ k1) + k2;
      const int cb = cube[s];
      const long long q = (long long)bt * c + s;
      for (int k = 0; k < S; ++k) {
        const int* f = meta + kSlotFields * k;
        float u = uniform(base, (uint32_t)f[kSalt]);
        if (f[kStride] > 0) {
          const int coord = (cb / f[kStride]) % nstrat;
          u = __fdiv_rn(__fadd_rn((float)coord, u), fns);
        }
        int val, g;
        float prob;
        map_draw(f, tab, nullptr, u, val, g, prob);
        x[k * plane + q] = val;
        gidx[k * plane + q] = g;
      }
    }
  }
}

}  // namespace

extern "C" int mci_vplus_sample(const void* kd, int t0, int B, int T, int c,
                                int S, int nstrat, const void* cube,
                                const void* meta, const void* tab, void* x,
                                void* gidx, void* stream) {
  if (B < 1 || T < 1 || c < 1 || (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads * kPerThread;
  long long bx = ((long long)c + per_block - 1) / per_block;
  long long by = (long long)B * T;
  if (bx > 65535) bx = 65535;
  if (by > 65535) by = 65535;
  dim3 grid((unsigned)bx, (unsigned)by);
  vplus_sample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, t0, B, T, c, S, nstrat, (const int*)cube,
      (const int*)meta, (const float*)tab, (int*)x, (int*)gidx);
  return (int)cudaGetLastError();
}
