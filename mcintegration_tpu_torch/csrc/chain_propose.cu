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
// Fields are [.., W] with walkers block-major.  The TPU kernel's
// lattice-roll draw and its power-of-two ninc rule (lines 16-32) were
// workarounds for a missing gather; here a gather is one load.
//
// What bounds it on the card: device-memory bytes, about 28 per walker per
// step for one leaf (read 4 of old prob and write 12 of new slot state, 4 of
// prop and 8 of move; the map tables stay in L1/L2), then the integer work
// of its lowbias32 hashes.  But a walker's slot s is its own draw, so a
// warp's 4-byte accesses to the rows of the chosen slots fill each 32-byte
// sector only in part: the old probabilities come in as whole sectors of
// every slot row, and a sector written in part is filled from device memory
// before it is written back.  At maxdof = 2 that is about 68 bytes a walker
// for the 28 the function needs, and the kernel runs near the card's rate
// for those (every walker storing into the row of slot 0 halves its time:
// PERF.md).  The design keeps the rest of a walker's work short:
// - each thread block of kThreads walkers stages the layout (leaf rows,
//   group rows lo, hi, maxdof, and the eligible groups) in shared memory,
//   beside the Discrete CDFs of up to 1024 bins, where the binary search's
//   dependent loads are cheap; larger tables are searched in global memory,
//   so nbin has no limit;
// - a walker's block w / wb is a multiply and a shift (divide.cuh);
// - one walker a thread, one block per kThreads walkers, no grid-stride
//   loop.  Two walkers a thread side by side, and the block's keys k1, k2
//   formed once a block, measured no faster (PERF.md).
// Each walker touches only the chosen slot, never the whole state.
//
// Random bits (chain_common.cuh): salts 1 group, 2 slot, 4 + d for drawn
// leaf d, 2^20 + k for the first draw of kernel slot k (ops/chain_kernels.py).
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding, so the output matches the plain torch version bit for bit.

#include "chain_common.cuh"
#include "divide.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;       // at most 64 registers a thread
constexpr uint32_t kSaltGroup = 1u, kSaltSlot = 2u, kSaltLeaf = 4u;
constexpr uint32_t kSaltInit = 1u << 20;

// Ints of the staged layout: leaf rows [L, 8], groups [nvar, 3], elig.
__host__ __device__ constexpr int layout_ints(int L, int nvar, int nelig) {
  return kLeafFields * L + 3 * nvar + nelig;
}

// shared memory: the staged CDFs [smem_floats], then the layout's ints.
// (mulwb, shwb) divide by wb.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) chain_propose_kernel(
    const uint32_t* __restrict__ kd, uint32_t t, int init, int W, int wb, uint32_t mulwb,
    int shwb, int L, int nvar, int nelig, int smem_floats, const int* __restrict__ meta,
    const float* __restrict__ tab, int* __restrict__ cur_val,
    int* __restrict__ cur_gidx, float* __restrict__ cur_prob,
    int* __restrict__ prp_val, int* __restrict__ prp_gidx,
    float* __restrict__ prp_prob, float* __restrict__ prop_out,
    int* __restrict__ move) {
  extern __shared__ float smem[];
  int* leaf = reinterpret_cast<int*>(smem + smem_floats);   // [L, 8]
  const int nint = layout_ints(L, nvar, nelig);
  for (int q = threadIdx.x; q < nint; q += blockDim.x) leaf[q] = meta[q];
  for (int d = 0; d < L; ++d) {
    const int* f = meta + kLeafFields * d;
    if (f[kKind] == kDisc && f[kSm] >= 0)
      for (int q = threadIdx.x; q < f[kNb]; q += blockDim.x)
        smem[f[kSm] + q] = tab[f[kTab] + 1 + q];
  }
  __syncthreads();
  const int* grp = leaf + kLeafFields * L;         // [nvar, 3]: lo, hi, maxdof
  const int* elig = grp + 3 * nvar;                // [nelig]
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  // mix32(j ^ k1) + k2 of walker j of block b = w / wb at step t
  const int b = (int)divide((uint32_t)w, mulwb, shwb);
  const uint32_t j = (uint32_t)(w - b * wb);
  const uint32_t base =
      mix32(j ^ mix32(kd[2 * b] ^ (t * 0x9E3779B9u))) + mix32(kd[2 * b + 1] + t);

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
    return;
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

}  // namespace

extern "C" int mci_chain_propose(const void* kd, int t, int init, int W, int wb,
                                 int L, int S, int nvar, int nelig,
                                 const void* meta, const void* tab,
                                 int smem_floats, void* cur_val, void* cur_gidx,
                                 void* cur_prob, void* prp_val, void* prp_gidx,
                                 void* prp_prob, void* prop, void* move,
                                 void* stream) {
  if (W < 1 || wb < 1 || W % wb != 0 || L < 1 || nelig < 1 || smem_floats < 0)
    return (int)cudaErrorInvalidValue;
  uint32_t mulwb;
  int shwb;
  divisor((uint32_t)wb, mulwb, shwb);
  const size_t smem = ((size_t)smem_floats + layout_ints(L, nvar, nelig)) * sizeof(float);
  if (smem > 48 * 1024) {   // above 48 KiB a kernel must be allowed it first
    const cudaError_t e = cudaFuncSetAttribute(
        chain_propose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)W + kThreads - 1) / kThreads;
  chain_propose_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, (uint32_t)t, init, W, wb, mulwb, shwb, L, nvar, nelig,
      smem_floats, (const int*)meta, (const float*)tab, (int*)cur_val, (int*)cur_gidx,
      (float*)cur_prob, (int*)prp_val, (int*)prp_gidx, (float*)prp_prob,
      (float*)prop, (int*)move);
  return (int)cudaGetLastError();
}
