// vegas_reduce: the observable sums and training histogram of the :vegas solver.
//
// Replaces the reduction half of mcintegration_tpu/ops/pallas_vegas.py:
// build_run_all (lines 454-532).  One thread block per stratum row
// r = (block b, chunk t, stratum p) of m samples computes, in the kernel's
// float32 order:
//   jac      = prod_k invp_k                              (:431-433)
//   factor_i = jac * prod over padded (group, slot) pairs of
//              prod over the group's leaves of 1/invp     (:434-441, :471-478)
//   obs_rows[r, i] = sum_q w_i * factor_i                 (float64 sum)
//   whsum_i  = sum_q min(|w_i| * jac, 1e17)^2             (:507, float64 sum)
//   hrow[k, b, t, perm_k[p]] = sum_{i used by slot k} whsum_i
// The permutation is a bijection of the strata, so each histogram bin of a
// (slot, block, chunk) is written by exactly one thread block: no atomics.
// The kernel writes per-row partials obs_rows [B, T, nb, N], not per-(b, t)
// sums: the wrapper's torch sum over p (giving obs [B, T, N]) is the first
// step of the fixed-order float64 reduction, and the solver then sums
// chunks, blocks and slots in a fixed order, so a fixed seed reproduces a run
// bit for bit.  This replaces the TPU kernel's Kahan carry in SMEM across the
// in-order grid.
//
// What bounds it on the card: device-memory bytes, one 4-byte load of w per
// (integrand, sample); the outputs are one double per row and integrand.
//
// Deliberately simple: a warp-shuffle block reduction per integrand, no
// wgmma or TMA (nothing to multiply, no tile reuse).  Fusing the integrand,
// so w never reaches device memory, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Sum (a, b) over the thread block; the totals land in thread 0.
// blockDim.x is a multiple of 32, at most 1024.
__device__ __forceinline__ void block_sum2(double& a, double& b,
                                           double* part) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part[warp] = a;
    part[32 + warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0;
    b = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      a += part[w];
      b += part[32 + w];
    }
  }
  __syncthreads();
}

// shared memory: whsum [N] double, part [64] double, factor [N] float
__global__ void vegas_reduce_kernel(const float* __restrict__ w,
                                    const float* __restrict__ invp,
                                    const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ pad,
                                    const int32_t* __restrict__ pair_slots,
                                    const int32_t* __restrict__ used,
                                    int N, int nslots, int npair, int maxmem,
                                    long long R, int nb, int m,
                                    double* __restrict__ obs_rows,
                                    double* __restrict__ hrow) {
  extern __shared__ double smem[];
  double* whsum = smem;
  double* part = smem + N;
  float* factor = (float*)(smem + N + 64);

  const long long r = blockIdx.x;
  const int p = (int)(r % nb);

  float jac = invp[r];
  for (int k = 1; k < nslots; ++k) jac = __fmul_rn(jac, invp[k * R + r]);

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float f = jac;
    for (int g = 0; g < npair; ++g) {
      if (!pad[i * npair + g]) continue;
      float gp = __fdiv_rn(1.0f, invp[pair_slots[g * maxmem] * R + r]);
      for (int mm = 1; mm < maxmem; ++mm) {
        const int k = pair_slots[g * maxmem + mm];
        if (k < 0) break;
        gp = __fmul_rn(gp, __fdiv_rn(1.0f, invp[k * R + r]));
      }
      f = __fmul_rn(f, gp);
    }
    factor[i] = f;
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    const float* wi = w + ((long long)i * R + r) * m;
    const float f = factor[i];
    double so = 0.0, sh = 0.0;
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const float v = wi[q];
      so += (double)__fmul_rn(v, f);
      float a = __fmul_rn(fabsf(v), jac);
      a = a > 1e17f ? 1e17f : a;   // NaN passes through, as torch.clamp
      sh += (double)__fmul_rn(a, a);
    }
    block_sum2(so, sh, part);
    if (threadIdx.x == 0) {
      obs_rows[r * N + i] = so;
      whsum[i] = sh;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nslots; k += blockDim.x) {
    double h = 0.0;
    for (int i = 0; i < N; ++i)
      if (used[k * N + i]) h += whsum[i];
    hrow[k * R + (r - p) + perm[k * R + r]] = h;
  }
}

}  // namespace

extern "C" int mci_vegas_reduce(const void* w, const void* invp,
                                const void* perm, const void* pad,
                                const void* pair_slots, const void* used,
                                int N, int nslots, int npair, int maxmem,
                                long long R, int nb, int m, void* obs_rows,
                                void* hrow, void* stream) {
  int threads = 32;
  while (threads < m && threads < 256) threads *= 2;
  const size_t smem = (size_t)(N + 64) * sizeof(double) + (size_t)N * sizeof(float);
  vegas_reduce_kernel<<<(unsigned)R, threads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)invp, (const int32_t*)perm,
      (const int32_t*)pad, (const int32_t*)pair_slots, (const int32_t*)used,
      N, nslots, npair, maxmem, R, nb, m, (double*)obs_rows, (double*)hrow);
  return (int)cudaGetLastError();
}
