// chain_accept: the Metropolis half of one :vegasmc Markov-chain step.
//
// Replaces the accept, tally, histogram and measurement half of the step
// loop of mcintegration_tpu/ops/pallas_chain.py:build_chain_run_all (lines
// 756-846), with the law of the JAX package's XLA route
// (mcintegration_tpu/solvers/vegasmc.py:336-390).  Per walker, given the
// integrand's weights nw_i on the proposed state prp_*:
//   gp(g, s)  = prod over the leaves of group g of prob(leaf, slot s)
//   npad_i    = prod of gp over integrand i's padded (g, s) pairs  (1 if none)
//   new_p     = rw[norm]*npad[norm] + sum_i |nw_i|*rw_i*npad_i    (:668-672)
//   accept    = (u < prop*new_p/p) & (prop > 1e-38)
// then, in place: the changed slots move prp -> cur on accept and cur -> prp
// on reject (the two copies are equal again), and w, pad, p take the new
// values on accept; the group's tallies pc/ac count the move; the state
// after the move adds min(|w_i|^2/prob_i * pad_i/p, 1e34) for every
// integrand i that uses a slot into the slot's bin of its leaf's histogram
// (every step: no HIST_EVERY subsample); and on a measured step (t % mf == 0
// and t >= warmup, decided by the caller) obs_i += w_i*(pad_i/p),
// vis_i += |w_i|*pad_i*rw_i/p, nrm += pad_norm/p, vis_norm += rw_norm*
// pad_norm/p, all into per-walker float64 accumulators (these replace the
// TPU kernel's Kahan float32 pairs, lines 84-102).  With a custom measure
// (custom = 1, K2's branch at lines 829-842) a measured step writes
// relw_i = w_i*(pad_i/p) of the state after the move into relw in place of
// the obs adds; the user's measure then runs as torch ops on that state and
// chain_measure.cu adds its output into obs.  With init = 1 the kernel only
// takes the first state: w, pad, p.
//
// Complex weights (type=complex, K2's branch at lines 459-488 and 818-842)
// run the same kernel instantiated with kCplx (entry mci_chain_accept_complex):
// nw, w and relw are complex64, read and written as interleaved (re, im)
// float2; |w| = sqrt(re*re + im*im) in new_p and vis, the histogram weight
// takes |w|^2 = re*re + im*im with no square root, and relw_i = (re*f, im*f)
// with f = pad_i/p goes into obs[2i] and obs[2i+1] (the default measure) or
// relw (a custom one).  The real instantiation is the real kernel as it was.
//
// What bounds it on the card: device-memory bytes, about 40 + 20*N bytes per
// walker per step (read the slot probs, nw, w, pad, p, prop and move; write
// the changed slot, the new weights and pads; read and write the float64
// accumulators on measured steps; with complex weights 4 more per weight read
// or written and 16 more per measured integrand), plus one hash; and
// latency, at one thread per walker with dependent loads, so occupancy
// matters (launch bounds below).  Histograms are privatised
// per thread block in shared memory as float64 and flushed with atomics once
// per launch; blocks stride over many walkers so the flush stays small
// against the walkers.  A histogram larger than 48 KiB in all is added
// straight into device memory with atomics instead.
//
// The order of float64 atomics changes from run to run, so the histogram,
// and the map trained from it, is reproducible only to rounding (rel 1e-9
// against the plain version); everything else matches bit for bit.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kSaltAccept = 3u;

// Product, in (group, slot) order, of the slot probabilities over the pairs
// that mask[] marks; gp of a pair multiplies the group's leaves in order.
__device__ __forceinline__ float masked_prod(const int* leaf, const int* grp,
                                             int nvar, const int* mask,
                                             const float* prob, int W, int w) {
  float f = 1.0f;
  int q = 0;
  for (int g = 0; g < nvar; ++g) {
    const int md = grp[3 * g + 2];
    for (int s = 0; s < md; ++s, ++q) {
      if (!mask[q]) continue;
      float gp = 1.0f;
      for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d)
        gp = __fmul_rn(gp, prob[(long long)(leaf[kLeafFields * d + 5] + s) * W + w]);
      f = __fmul_rn(f, gp);
    }
  }
  return f;
}

// Two blocks of 512 threads per SM: the bound holds the kernel to 64
// registers, where it would take 72 and fit one block (1.6x slower, measured).
template <bool kCplx>
__global__ void __launch_bounds__(kThreads, 2) chain_accept_kernel(
    const uint32_t* __restrict__ kd, uint32_t t, int init, int measure, int W,
    int wb, int L, int S, int nvar, int nelig, int N,
    int custom, const int* __restrict__ meta, const float* __restrict__ rw, int H,
    int hist_smem, int* __restrict__ prp_val, int* __restrict__ prp_gidx,
    float* __restrict__ prp_prob, int* __restrict__ cur_val,
    int* __restrict__ cur_gidx, float* __restrict__ cur_prob,
    const float* __restrict__ nw, const float* __restrict__ prop,
    const int* __restrict__ move, float* __restrict__ wgt,
    float* __restrict__ pad, float* __restrict__ pj,
    double* __restrict__ obs, double* __restrict__ nrm,
    double* __restrict__ vis, int* __restrict__ pc, int* __restrict__ ac,
    double* __restrict__ hist, float* __restrict__ relw) {
  typedef Weight<kCplx> Wt;
  extern __shared__ double hs[];
  const int nd = N + 1, norm = N;
  const int* leaf = meta;                          // [L, 8]
  const int* grp = leaf + kLeafFields * L;         // [nvar, 3]: lo, hi, maxdof
  int P = 0;
  for (int g = 0; g < nvar; ++g) P += grp[3 * g + 2];
  const int* padm = grp + 3 * nvar + nelig;        // [nd, P]
  const int* usedm = padm + nd * P;                // [N, P]
  const int* hfeed = usedm + N * P;                // [S, N]
  const int* sleaf = hfeed + S * N;                // [S]
  double* hdst = hist_smem ? hs : hist;
  if (hist_smem) {
    for (int q = threadIdx.x; q < H; q += blockDim.x) hs[q] = 0.0;
    __syncthreads();
  }

  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W;
       w += gridDim.x * blockDim.x) {
    // ---- joint density of the proposal (pads recomputed where needed) ----
    float new_p = __fmul_rn(rw[norm], masked_prod(leaf, grp, nvar, padm + norm * P,
                                                  prp_prob, W, w));
    for (int i = 0; i < N; ++i) {
      const float npad = masked_prod(leaf, grp, nvar, padm + i * P, prp_prob, W, w);
      new_p = __fadd_rn(new_p, __fmul_rn(__fmul_rn(Wt::load(nw, (long long)i * W + w).abs(),
                                                    rw[i]), npad));
    }
    bool acc = true;
    if (!init) {
      const float u = uniform(walker_base(kd, t, w, wb), kSaltAccept);
      const float pr = prop[w];
      acc = (u < __fdiv_rn(__fmul_rn(pr, new_p), pj[w])) && (pr > 1e-38f);
    }
    if (acc) {
      for (int i = 0; i < N; ++i) {
        const long long q = (long long)i * W + w;
        Wt::load(nw, q).store(wgt, q);
      }
      for (int i = 0; i < nd; ++i)
        pad[(long long)i * W + w] = masked_prod(leaf, grp, nvar, padm + i * P, prp_prob, W, w);
      pj[w] = new_p;
    }
    if (init) continue;

    // ---- the changed slots: prp -> cur on accept, cur -> prp on reject ----
    const int g = move[w];
    const int s = move[W + w];
    for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d) {
      const long long i = (long long)(leaf[kLeafFields * d + 5] + s) * W + w;
      if (acc) {
        cur_val[i] = prp_val[i];
        cur_gidx[i] = prp_gidx[i];
        cur_prob[i] = prp_prob[i];
      } else {
        prp_val[i] = cur_val[i];
        prp_gidx[i] = cur_gidx[i];
        prp_prob[i] = cur_prob[i];
      }
    }
    pc[(long long)g * W + w] += 1;
    if (acc) ac[(long long)g * W + w] += 1;

    // ---- histogram weight of the state after the move ----
    const float p = pj[w];
    for (int i = 0; i < N; ++i) {
      bool feeds = false;
      for (int k = 0; k < S; ++k) feeds = feeds || hfeed[k * N + i];
      if (!feeds) continue;
      const float prob_i = masked_prod(leaf, grp, nvar, usedm + i * P, cur_prob, W, w);
      float a = __fdiv_rn(Wt::load(wgt, (long long)i * W + w).abs2(), prob_i);
      a = __fdiv_rn(__fmul_rn(a, pad[(long long)i * W + w]), p);
      a = a > 1e34f ? 1e34f : a;   // NaN passes through, as torch.clamp
      const double ad = (double)a;
      for (int k = 0; k < S; ++k) {
        if (!hfeed[k * N + i]) continue;
        const int off = leaf[kLeafFields * sleaf[k] + 6];
        atomicAdd(hdst + off + cur_gidx[(long long)k * W + w], ad);
      }
    }

    // ---- measurement ----
    if (measure) {
      for (int i = 0; i < N; ++i) {
        const long long q = (long long)i * W + w;
        const Wt wi = Wt::load(wgt, q);
        const float padi = pad[q];
        const Wt r = wi.scale(__fdiv_rn(padi, p));
        if (custom)
          r.store(relw, q);
        else
          r.add_to(obs, i, W, w);
        vis[q] += (double)__fdiv_rn(__fmul_rn(__fmul_rn(wi.abs(), padi), rw[i]), p);
      }
      const float norm_w = __fdiv_rn(pad[(long long)norm * W + w], p);
      nrm[w] += (double)norm_w;
      vis[(long long)norm * W + w] += (double)__fmul_rn(rw[norm], norm_w);
    }
  }

  if (hist_smem && !init) {
    __syncthreads();
    for (int q = threadIdx.x; q < H; q += blockDim.x)
      if (hs[q] != 0.0) atomicAdd(hist + q, hs[q]);
  }
}

template <bool kCplx>
int launch_accept(const void* kd, int t, int init, int measure, int custom, int W,
                  int wb, int L, int S, int nvar, int nelig, int N, const void* meta,
                  const void* rw, int H, int hist_smem, void* prp_val, void* prp_gidx,
                  void* prp_prob, void* cur_val, void* cur_gidx, void* cur_prob,
                  const void* nw, const void* prop, const void* move, void* w, void* pad,
                  void* p, void* obs, void* nrm, void* vis, void* pc, void* ac, void* hist,
                  void* relw, void* stream) {
  long long blocks = ((long long)W + kThreads - 1) / kThreads;
  const long long cap = 2LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = hist_smem ? (size_t)H * sizeof(double) : 0;
  chain_accept_kernel<kCplx><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, (uint32_t)t, init, measure, W, wb, L, S, nvar, nelig,
      N, custom, (const int*)meta, (const float*)rw, H, hist_smem, (int*)prp_val,
      (int*)prp_gidx, (float*)prp_prob, (int*)cur_val, (int*)cur_gidx,
      (float*)cur_prob, (const float*)nw, (const float*)prop, (const int*)move,
      (float*)w, (float*)pad, (float*)p, (double*)obs, (double*)nrm,
      (double*)vis, (int*)pc, (int*)ac, (double*)hist, (float*)relw);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCI_CHAIN_ACCEPT_ARGS                                                         \
  const void *kd, int t, int init, int measure, int custom, int W, int wb, int L,    \
      int S, int nvar, int nelig, int N, const void *meta, const void *rw, int H,    \
      int hist_smem, void *prp_val, void *prp_gidx, void *prp_prob, void *cur_val,   \
      void *cur_gidx, void *cur_prob, const void *nw, const void *prop,              \
      const void *move, void *w, void *pad, void *p, void *obs, void *nrm,           \
      void *vis, void *pc, void *ac, void *hist, void *relw, void *stream
#define MCI_CHAIN_ACCEPT_PASS                                                         \
  kd, t, init, measure, custom, W, wb, L, S, nvar, nelig, N, meta, rw, H, hist_smem, \
      prp_val, prp_gidx, prp_prob, cur_val, cur_gidx, cur_prob, nw, prop, move, w,   \
      pad, p, obs, nrm, vis, pc, ac, hist, relw, stream

// float32 weights
extern "C" int mci_chain_accept(MCI_CHAIN_ACCEPT_ARGS) {
  return launch_accept<false>(MCI_CHAIN_ACCEPT_PASS);
}

// complex64 weights: nw, w and relw interleaved (re, im); obs [2N, W] for the
// default measure
extern "C" int mci_chain_accept_complex(MCI_CHAIN_ACCEPT_ARGS) {
  return launch_accept<true>(MCI_CHAIN_ACCEPT_PASS);
}
