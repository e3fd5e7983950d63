// chain_propose: the proposal half of one :vegasmc Markov-chain step.
//
// Replaces the draw half of the step loop of
// mcintegration_tpu/ops/pallas_chain.py:build_chain_run_all (lines 585-626,
// 723-754), with the law of the JAX package's XLA route
// (mcintegration_tpu/solvers/vegasmc.py:287-336): each walker picks a group
// g among the eligible ones and a slot s < maxdof[g], redraws slot s of every
// leaf of g through the leaf's map with a fresh uniform of its own, and
// forms the Hastings factor prop = prod old_prob / new_prob.
// (chain_common.cuh:map_draw).
// The proposal goes into the mirror copy prp_* of the slot state, where the
// integrand reads it; cur_* keeps the current state.  With init = 1 the
// kernel draws every slot once into both copies instead.
//
// One thread per walker, fields [.., W] with walkers block-major.  The TPU
// kernel's lattice-roll draw and its power-of-two ninc rule (lines 16-32)
// were workarounds for a missing gather; here a gather is one load.
//
// What bounds it on the card: device-memory bytes, about 40 per walker per
// step for one leaf (read 4 of old prob and write 12 of new slot state,
// 4 of prop and 8 of move; the map tables stay in L1/L2), plus three to
// four lowbias32 hashes.  The design touches only the chosen slot of each
// walker, never the whole state, and stages the Discrete CDFs of up to 1024
// bins in shared memory, where the binary search's dependent loads are
// cheap; larger tables are searched in global memory, so nbin has no limit.
//
// Random bits (chain_common.cuh): salts 1 group, 2 slot, 4 + d for drawn
// leaf d, 2^20 + k for the first draw of kernel slot k (ops/chain_kernels.py).
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding, so the output matches the plain torch version bit for bit.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSaltGroup = 1u, kSaltSlot = 2u, kSaltLeaf = 4u;
constexpr uint32_t kSaltInit = 1u << 20;

__global__ void chain_propose_kernel(
    const uint32_t* __restrict__ kd, uint32_t t, int init, int W, int wb,
    int L, int S, int nvar, int nelig, const int* __restrict__ meta,
    const float* __restrict__ tab, int* __restrict__ cur_val,
    int* __restrict__ cur_gidx, float* __restrict__ cur_prob,
    int* __restrict__ prp_val, int* __restrict__ prp_gidx,
    float* __restrict__ prp_prob, float* __restrict__ prop_out,
    int* __restrict__ move) {
  extern __shared__ float smem[];
  const int* leaf = meta;                          // [L, 8]
  const int* grp = leaf + kLeafFields * L;         // [nvar, 3]: lo, hi, maxdof
  const int* elig = grp + 3 * nvar;                // [nelig]
  stage_cdfs(leaf, L, kLeafFields, tab, smem);

  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W;
       w += gridDim.x * blockDim.x) {
    const uint32_t base = walker_base(kd, t, w, wb);
    int val, gidx;
    float prob;
    if (init) {
      for (int d = 0; d < L; ++d) {
        const int* f = leaf + kLeafFields * d;
        const int nd = grp[3 * f[7] + 2];
        for (int s = 0; s < nd; ++s) {
          const int k = f[5] + s;
          map_draw(f, tab, smem, uniform(base, kSaltInit + (uint32_t)k), val, gidx, prob);
          const long long i = (long long)k * W + w;
          cur_val[i] = prp_val[i] = val;
          cur_gidx[i] = prp_gidx[i] = gidx;
          cur_prob[i] = prp_prob[i] = prob;
        }
      }
      continue;
    }
    const int e = min((int)__fmul_rn(uniform(base, kSaltGroup), (float)nelig), nelig - 1);
    const int g = elig[e];
    const int md = grp[3 * g + 2];
    const int s = min((int)__fmul_rn(uniform(base, kSaltSlot), (float)md), md - 1);
    float prop = 1.0f;
    for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d) {
      const int* f = leaf + kLeafFields * d;
      map_draw(f, tab, smem, uniform(base, kSaltLeaf + (uint32_t)d), val, gidx, prob);
      const long long i = (long long)(f[5] + s) * W + w;
      prop = __fmul_rn(prop, __fdiv_rn(cur_prob[i], prob));
      prp_val[i] = val;
      prp_gidx[i] = gidx;
      prp_prob[i] = prob;
    }
    prop_out[w] = prop;
    move[w] = g;
    move[W + w] = s;
  }
}

}  // namespace

extern "C" int mci_chain_propose(const void* kd, int t, int init, int W, int wb,
                                 int L, int S, int nvar, int nelig,
                                 const void* meta, const void* tab,
                                 int smem_floats, void* cur_val, void* cur_gidx,
                                 void* cur_prob, void* prp_val, void* prp_gidx,
                                 void* prp_prob, void* prop, void* move,
                                 void* stream) {
  long long blocks = ((long long)W + kThreads - 1) / kThreads;
  const long long cap = 8LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)smem_floats * sizeof(float);
  chain_propose_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, (uint32_t)t, init, W, wb, L, S, nvar, nelig,
      (const int*)meta, (const float*)tab, (int*)cur_val, (int*)cur_gidx,
      (float*)cur_prob, (int*)prp_val, (int*)prp_gidx, (float*)prp_prob,
      (float*)prop, (int*)move);
  return (int)cudaGetLastError();
}
