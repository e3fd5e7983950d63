// mcmc_measure: the sectors' custom measurements into the :mcmc accumulators.
//
// Replaces the custom-measure accumulation of
// mcintegration_tpu/ops/pallas_mcmc.py:build_mcmc_run_all (lines 1240-1274):
// on a measured step the user's measure of each sector i runs as torch ops on
// every walker's current state (its output m_i [ncomp, W], the observable
// pytree's components), and this kernel adds each walker's own sector's
// output into its float64 accumulators: obs[c, w] += m_{curr[w]}[c, w] for
// curr[w] < N.  Walkers in the normalization sector add nothing, whatever the
// outputs hold there.  The TPU kernel kept these sums as Kahan float32 pairs
// and looped over the sectors inside one body; so does this kernel, for up to
// kMaxSectors sectors a launch (the wrapper launches once per run of that
// many).  Each obs element gets at most one add, so the sums are those of the
// plain version's per-sector masked adds bit for bit (adding 0.0 leaves obs,
// which never holds -0.0, as it was).
//
// What bounds it on the card: device-memory bytes, 4 per walker (curr) and
// 20 per component of a walker outside the normalization sector (read m, read
// and write obs).  Walkers of a sector lie scattered among the others, so the
// 32-byte sectors of m and obs that a step touches are most of them; and a
// launch this short spends about two of its microseconds in launch and drain
// (PERF.md).  Design: one thread a walker reads curr, returns if the walker
// adds nothing, and otherwise loops over the components in runs of kComps
// whose loads of its own sector's m and of obs are issued together; 32-bit
// indices (ncomp * W < 2^31); one wave of blocks sized to the work, which
// needs the kernel at 32 registers or fewer.  The
// sectors' pointers travel in the launch's argument block
// (__grid_constant__): no device-side table is copied each step.
// tools/mcmc_variants.py times the other settings against this one: several
// adjacent walkers a thread with vector accesses, m or obs loaded before curr
// arrives, a kernel for one sector, other component and thread counts, the
// loop unrolled, streaming hints.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSectors = 32;   // sectors a launch takes (MAX_SECTORS in Python)
constexpr int kThreads = 256;     // threads a block
constexpr int kComps = 4;         // components whose loads are in flight together

struct MeasureArgs {
  const float* m[kMaxSectors];    // m[s]: sector lo + s's output [ncomp, W]
  const int* curr;                // [W]
  double* obs;                    // [ncomp, W]
  int lo, n, ncomp, W;            // sectors lo .. lo + n - 1
};

__global__ void __launch_bounds__(kThreads)
    mcmc_measure_kernel(const __grid_constant__ MeasureArgs a) {
  const int w = (int)(blockIdx.x * kThreads + threadIdx.x);
  if (w >= a.W) return;
  const int s = a.curr[w] - a.lo;
  if ((unsigned)s >= (unsigned)a.n) return;  // the normalization sector, or another launch's
  const float* m = a.m[s];
  // not unrolled: 32 registers, so eight blocks an SM and 2^18 walkers in one
  // wave on 132 SMs (unrolled, 40 registers and two waves)
#pragma unroll 1
  for (int k0 = 0; k0 < a.ncomp; k0 += kComps) {
    float x[kComps];
    double y[kComps];
#pragma unroll
    for (int j = 0; j < kComps; ++j) {
      if (k0 + j < a.ncomp) {
        const int q = (k0 + j) * a.W + w;
        x[j] = m[q];
        y[j] = a.obs[q];
      }
    }
#pragma unroll
    for (int j = 0; j < kComps; ++j)
      if (k0 + j < a.ncomp) a.obs[(k0 + j) * a.W + w] = y[j] + (double)x[j];
  }
}

}  // namespace

// Sectors lo .. lo + n - 1 (n <= kMaxSectors), their outputs' pointers in
// the host array m[0 .. n-1].
extern "C" int mci_mcmc_measure(int lo, int n, int ncomp, int W, const void* const* m,
                                const void* curr, void* obs, void* stream) {
  if (n < 1 || n > kMaxSectors || lo < 0 || ncomp < 1 || W < 1 ||
      (long long)ncomp * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  MeasureArgs a{};
  for (int s = 0; s < n; ++s) a.m[s] = (const float*)m[s];
  a.curr = (const int*)curr;
  a.obs = (double*)obs;
  a.lo = lo, a.n = n, a.ncomp = ncomp, a.W = W;
  mcmc_measure_kernel<<<(W + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
