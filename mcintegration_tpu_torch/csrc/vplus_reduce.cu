// vplus_reduce: the density, observable sums, per-cube second moments and
// training histograms of the :vegasplus solver.
//
// Replaces the reduction half of mcintegration_tpu/ops/pallas_vplus.py:
// build_vplus_run_all (lines 274-368), with the law of the JAX package's XLA
// route (mcintegration_tpu/solvers/vegasplus.py:214-300).  Per sample s of
// chunk (b, t), in float32 and in the reference's order:
//   prob   = prod over the Continuous slots of rho_k          (rho: slot_rho)
//   pass   = prod over the Discrete slots of rho_k
//   dens   = cfac[cube[s]] * prob (* pass),  jac = 1/dens,
//            cfac[cube] = counts[cube]*ncubes/c                (:215-220)
//   pad_i  = prod over integrand i's padded (group, slot) pairs of the
//            product of the pair's slots' rho                  (:231-250)
//   relw_i = w_i * (jac * pad_i)
//   obs[b, t, i]   += relw_i
//   sig[cube[s]]   += min(sum_i |w_i|*pad_i / (prob (* pass)), 1e17)^2  (:275-284)
//   hist[leaf of k][gidx_k] += min(|relw_i|, 1e17)^2  for every adaptive slot
//            k that integrand i uses                           (:286-300)
// with every square formed in float32 and every sum taken in float64 (these
// replace the TPU kernel's Kahan float32 pairs and its HIST_EVERY subsample:
// every sample feeds the histograms).
//
// Layout of the work.  The samples of a chunk are cube-major and every chunk
// has the same layout, so a thread keeps one sample position, its cube and
// the cube's factor, and walks over many chunks (blockIdx.y strides over the
// B*T chunks).  Warp j of block b takes the 32 samples of group j*nspan + b:
// the warps of a block work in parts of the chunk far apart.  Hence
//   sig:  a thread adds its sample's second moments of every chunk it walks
//         into a register; at the end a segmented warp sum over the sorted
//         cubes leaves one value per (warp, cube), added with a native
//         float64 atomic into device memory;
//   hist: privatised per thread block in shared memory as float64 (up to
//         SMEM_HIST_BINS bins, ops/vplus_kernels.py; a larger histogram is
//         added straight into device memory) and flushed once at the end.
//         This card runs a float64 add on shared memory as a compare-and-
//         swap loop, which retries when lanes meet on one bin: a warp's 32
//         consecutive samples share few cubes and so a narrow window of
//         bins, but the block's other warps are in other cubes, so a hot
//         bin costs retries within a warp only;
//   obs:  each warp sums its samples of a chunk by shuffles and writes one
//         partial per (chunk, span, warp, integrand); the wrapper adds the
//         partials in a fixed order, so the observables do not depend on the
//         order of any atomic.
// One sample per thread and chunk keeps the kernel at 32 registers, eight
// blocks to an SM; the grid is eight waves of them, so no SM idles long at
// the end.
//
// What bounds it on the card: device-memory bytes, 4 bytes of w per sample
// and integrand and 4 bytes of gidx per sample and slot; cube[], cfac[] and
// the tables stay in cache.  It runs at about a quarter of that rate: its
// time falls with each part of a sample's work taken out, and not with any
// change to how the bytes arrive, so it is held by the instructions each
// sample issues and their latency, at 64 warps to an SM.  The adds name
// their address space (a generic pointer made every add test it first, in
// three code paths).  Measured
// (tools/accept_reduce_variants.py, phase 6d's launch, NVIDIA H100 80GB
// HBM3 at 700 W): 1.37 ms against a bound of 0.32; without the histogram
// adds 1.11, without the integrand's part 0.55.  Slower there: merging the
// lanes of a warp per bin before the add (__match_any_sync), native
// float64 atomics into device memory (a small histogram's adds meet on few
// L2 lines), the warps of a block on consecutive samples (a hot bin), a
// prefetch of the next chunk.  No faster in this PR's trials: a float64
// copy of the histogram per warp with no atomics (the copies cost
// occupancy), the map tables staged in shared memory, each chunk copied
// into shared memory ahead (cp.async), two chunks per thread.
//
// The order of the float64 sums changes from run to run, so sig and hist,
// and the counts and maps made from them, reproduce only to rounding (rel
// 1e-12 against the plain version).
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding.

#include "vplus_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = kThreads;               // ops/vplus_kernels.py:SPAN
constexpr int kWarps = kThreads / 32;         // ops/vplus_kernels.py:WARPS
constexpr int kBlocksPerSm = 8;               // at most 32 registers a thread
constexpr int kWaves = 8;                     // the grid, in blocks the card holds at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) vplus_reduce_kernel(
    const float* __restrict__ w, const int* __restrict__ gidx,
    const int* __restrict__ cube, const float* __restrict__ cfac,
    const float* __restrict__ tab, const int* __restrict__ meta, int N, int S,
    int P, int M, long long BT, int c, int H, int hist_smem,
    double* __restrict__ obs_rows, double* __restrict__ sig,
    double* __restrict__ hist) {
  extern __shared__ double hist_s[];           // [H] when hist_smem
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* slots = meta;                     // [S, 8]
  const int* pad = slots + kSlotFields * S;    // [N, P]
  const int* pair_slots = pad + N * P;         // [P, M]
  const int* used = pair_slots + P * M;        // [S, N]
  const long long plane = BT * c;              // one slot's or integrand's samples

  if (hist_smem) {
    for (int q = threadIdx.x; q < H; q += blockDim.x) hist_s[q] = 0.0;
    __syncthreads();
  }

  // this thread's sample of every chunk: warp j of block b takes the 32
  // samples of group j*nspan + b, so the warps of a block work in parts of
  // the chunk far apart and rarely add into the same bins.  Its cube (-1
  // past the chunk's end: the lane then only takes part in the shuffles),
  // the cube's factor, and its second moments over the chunks
  const int s = (warp * gridDim.x + blockIdx.x) * 32 + lane;
  const int cb = s < c ? cube[s] : -1;
  const float cf = cb < 0 ? 1.0f : cfac[cb];
  double v2 = 0.0;

  for (long long bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const long long at = bt * c + s;
    float jac = 1.0f, denom = 1.0f, score = 0.0f;
    if (cb >= 0) {
      float prob = 1.0f, pass = 1.0f;
      bool any_pass = false;
      for (int k = 0; k < S; ++k) {
        const int* f = slots + kSlotFields * k;
        const float rho = slot_rho(f, tab, gidx[k * plane + at]);
        if (f[kKind] == kDisc) {
          pass = __fmul_rn(pass, rho);
          any_pass = true;
        } else {
          prob = __fmul_rn(prob, rho);
        }
      }
      float dens = __fmul_rn(cf, prob);
      denom = prob;
      if (any_pass) {
        dens = __fmul_rn(dens, pass);
        denom = __fmul_rn(prob, pass);
      }
      jac = __fdiv_rn(1.0f, dens);
    }

    for (int i = 0; i < N; ++i) {
      double so = 0.0, sq = 0.0;
      if (cb >= 0) {
        float pad_i = 1.0f;
        for (int g = 0; g < P; ++g) {
          if (!pad[i * P + g]) continue;
          float gp = 1.0f;
          for (int mm = 0; mm < M; ++mm) {
            const int k = pair_slots[g * M + mm];
            if (k < 0) break;
            gp = __fmul_rn(gp, slot_rho(slots + kSlotFields * k, tab,
                                        gidx[k * plane + at]));
          }
          pad_i = __fmul_rn(pad_i, gp);
        }
        const float wi = w[i * plane + at];
        const float relw = __fmul_rn(wi, __fmul_rn(jac, pad_i));
        score = __fadd_rn(score, __fmul_rn(fabsf(wi), pad_i));
        so = (double)relw;
        float a = fabsf(relw);
        a = a > 1e17f ? 1e17f : a;   // NaN passes through, as torch.clamp
        sq = (double)__fmul_rn(a, a);
      }
      for (int k = 0; k < S; ++k) {
        const int off = slots[kSlotFields * k + kHist];
        if (off < 0 || !used[k * N + i]) continue;
        const int bin = cb >= 0 ? off + gidx[k * plane + at] : -1;
        if (bin < 0) continue;
        if (hist_smem)   // two adds, each to an address space the compiler knows
          atomicAdd(hist_s + bin, sq);
        else
          atomicAdd(hist + bin, sq);
      }
      so = warp_sum(so);
      if (lane == 0)
        obs_rows[((bt * gridDim.x + blockIdx.x) * kWarps + warp) * N + i] = so;
    }

    float wj = __fdiv_rn(score, denom);
    wj = wj > 1e17f ? 1e17f : wj;
    if (cb >= 0) v2 += (double)__fmul_rn(wj, wj);
  }

  // per-cube second moments: a segmented sum over the warp's sorted cubes
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_down_sync(kFull, v2, o);
    const int kup = __shfl_down_sync(kFull, cb, o);
    if (lane + o < 32 && kup == cb) v2 += up;
  }
  const int kprev = __shfl_up_sync(kFull, cb, 1);
  if (cb >= 0 && (lane == 0 || kprev != cb)) atomicAdd(sig + cb, v2);

  if (hist_smem) {
    __syncthreads();
    for (int q = threadIdx.x; q < H; q += blockDim.x)
      if (hist_s[q] != 0.0) atomicAdd(hist + q, hist_s[q]);
  }
}

}  // namespace

extern "C" int mci_vplus_reduce(const void* w, const void* gidx,
                                const void* cube, const void* cfac,
                                const void* tab, const void* meta, int N,
                                int S, int P, int M, long long BT, int c,
                                int ncubes, int H, int hist_smem, int span,
                                int warps, void* obs_rows, void* sig,
                                void* hist, void* stream) {
  if (span != kSpan || warps != kWarps || c < 1 || ncubes < 1)
    return (int)cudaErrorInvalidValue;      // the wrapper sized obs_rows otherwise
  const int nspan = (c + kSpan - 1) / kSpan;
  const size_t smem = (hist_smem ? (size_t)H : 0) * sizeof(double);
  int per_sm = 0;
  const int err = blocks_per_sm(vplus_reduce_kernel, kThreads, smem, &per_sm);
  if (err) return err;
  long long groups = ((long long)kWaves * per_sm * num_sms() + nspan - 1) / nspan;
  if (groups > BT) groups = BT;
  if (groups > 65535) groups = 65535;
  if (groups < 1) groups = 1;
  dim3 grid((unsigned)nspan, (unsigned)groups);
  vplus_reduce_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const int*)gidx, (const int*)cube, (const float*)cfac,
      (const float*)tab, (const int*)meta, N, S, P, M, BT, c, H, hist_smem,
      (double*)obs_rows, (double*)sig, (double*)hist);
  return (int)cudaGetLastError();
}
