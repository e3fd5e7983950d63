// mcmc_measure: a sector's custom measurement into the :mcmc accumulators.
//
// Replaces the custom-measure accumulation of
// mcintegration_tpu/ops/pallas_mcmc.py:build_mcmc_run_all (lines 1240-1274):
// on a measured step the user's measure of sector i runs as torch ops on
// every walker's current state (its output m [ncomp, W], the observable
// pytree's components), and this kernel adds it into the walkers' float64
// accumulators where curr == i: obs[c, w] += m[c, w].  Walkers elsewhere
// (another sector, or the normalization sector) add nothing, whatever m
// holds there.  The TPU kernel kept these sums as Kahan float32 pairs.
//
// What bounds it on the card: device-memory bytes, 4 + 20*ncomp per walker
// (read curr and m, read and write obs); one thread per (component, walker).

#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void mcmc_measure_kernel(int i, int ncomp, int W, const float* __restrict__ m,
                                    const int* __restrict__ curr,
                                    double* __restrict__ obs) {
  const long long n = (long long)ncomp * W;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < n;
       q += (long long)gridDim.x * blockDim.x)
    if (curr[q % W] == i) obs[q] += (double)m[q];
}

}  // namespace

extern "C" int mci_mcmc_measure(int i, int ncomp, int W, const void* m, const void* curr,
                                void* obs, void* stream) {
  long long blocks = ((long long)ncomp * W + kThreads - 1) / kThreads;
  const long long cap = 8LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  mcmc_measure_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      i, ncomp, W, (const float*)m, (const int*)curr, (double*)obs);
  return (int)cudaGetLastError();
}
