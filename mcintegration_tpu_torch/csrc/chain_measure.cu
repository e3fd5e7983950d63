// chain_measure: the :vegasmc custom measurement into the walkers' accumulators.
//
// Replaces the accumulation of K2's custom-measure branch,
// mcintegration_tpu/ops/pallas_chain.py:build_chain_run_all (lines 829-842):
// on a measured step chain_accept.cu writes each walker's relative weights
// relw, the user's measure runs as torch ops on the state after the move
// (its output m [ncomp, W], the observable pytree's components), and this
// kernel adds it into the walkers' float64 accumulators:
// obs[c, w] += m[c, w].  The TPU kernel kept these sums as Kahan float32
// pairs.  It adds what mcmc_measure.cu adds without the sector gate, kept a
// kernel of its own so that each of the two is timed and counted on its own
// solver's path.
//
// What bounds it on the card: device-memory bytes, 20*ncomp per walker
// (read m, read and write obs); one thread per (component, walker), a
// grid-stride loop.  Written in CUDA rather than Triton: the port builds its
// kernels with nvcc alone (ops/_build.py), and a build path for Triton would
// outweigh a three-line elementwise add.

#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void chain_measure_kernel(long long n, const float* __restrict__ m,
                                     double* __restrict__ obs) {
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x; q < n;
       q += (long long)gridDim.x * blockDim.x)
    obs[q] += (double)m[q];
}

}  // namespace

extern "C" int mci_chain_measure(int ncomp, int W, const void* m, void* obs, void* stream) {
  const long long n = (long long)ncomp * W;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 8LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  chain_measure_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const float*)m, (double*)obs);
  return (int)cudaGetLastError();
}
