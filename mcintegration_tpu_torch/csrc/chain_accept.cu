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
// or written and 16 more per measured integrand), plus one hash.  At one
// thread per walker it runs at about half that rate: each walker's step is a
// chain of dependent reads (the proposal, then the moved slot, then the
// state after the move), and 32 warps to an SM do not keep enough of them in
// flight.  The design shortens the chain and moves less:
//   - every block stages the layout once in shared memory: each (group,
//     slot) pair's kernel slots, its group's first pair, the pad and use
//     masks, which slots feed which histogram, rw;
//   - a walker forms each pair's product of the proposal once, keeps the
//     first kCache of them and of its pads in registers and stores the kept
//     pads on accept; after the move only the moved pair's product can
//     differ (the mirror prp_* equals cur_* on every other slot), and the
//     slot copy forms it from the values it moves.  Pairs and pads beyond
//     kCache are formed again where needed, with the same operations;
//   - as soon as a walker's move is read, the lines it reads after its
//     decision (both copies of the moved slots, the weights, pads, gidx and
//     accumulators of the state after the move) are prefetched into L1, and
//     the next walker's first lines into L2;
//   - the lanes of a warp that add to one histogram bin merge their values
//     first (chain_common.cuh:merge_by_key), and one lane adds the sum into
//     the block's float64 histogram in shared memory, flushed once per
//     launch; so no two lanes of a warp retry on one bin, and a hot bin
//     costs a warp one add.  This card runs a float64 add on shared memory
//     as a compare-and-swap loop, which now runs once per bin and warp.  A
//     histogram larger than SMEM_HIST_BINS bins (ops/chain_kernels.py) takes
//     native float64 atomics in device memory after the same merge; those
//     cost more (a small histogram's adds meet on few L2 lines), so it is
//     the exception, not the rule.
// Measured (tools/accept_reduce_variants.py, phase 6b's shape, NVIDIA H100
// 80GB HBM3 at 700 W): 0.115 ms a step against a bound of 0.054; the slot
// copy takes 0.017 of it, the histogram adds 0.002, a measured step's
// accumulators 0.027.
//
// The order of the float64 histogram sums changes from run to run, so the
// histogram, and the map trained from it, is reproducible only to rounding
// (rel 1e-9 against the plain version); everything else matches bit for bit.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding.

#include "chain_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;       // at most 64 registers a thread
constexpr int kCache = 2;             // pair products and pads kept in registers
constexpr uint32_t kSaltAccept = 3u;

// The layout as a block reads it, staged in shared memory.
struct Tables {
  int P;               // (group, slot) pairs, group-major
  const int* pstart;   // [P + 1]: pair q's kernel slots are prow[pstart[q] ..
  const int* prow;     //   pstart[q + 1]), its group's leaves in order
  const int* gbase;    // [nvar]: the first pair of group g
  const int* padm;     // [nd, P]
  const int* usedm;    // [N, P]
  const int* hfeed;    // [S, N]
  const int* hoff;     // [S]: the histogram offset of kernel slot k's leaf
  const int* feeds;    // [N]: integrand i feeds some histogram
  const float* rw;     // [nd]
};

// Ints of the staged layout for S kernel slots (P <= S pairs), nvar groups
// and N integrands, before rw [N + 1] floats.
__host__ __device__ constexpr int table_ints(int S, int nvar, int N) {
  return (S + 1) + S + nvar + S + N + (N + 1) * S + N * S + S * N;
}

// gp of pair q: its leaves' slot probabilities multiplied in leaf order.
__device__ __forceinline__ float pair_prod(const Tables& tb, int q, const float* prob,
                                           int W, int w) {
  float gp = 1.0f;
  for (int n = tb.pstart[q]; n < tb.pstart[q + 1]; ++n)
    gp = __fmul_rn(gp, prob[(long long)tb.prow[n] * W + w]);
  return gp;
}

// Product in pair order of gp over the pairs that mask[] marks: gp from
// gpc for the first kCache pairs, else formed from prob; pair qs's product
// is gs (qs = -1: none).
__device__ __forceinline__ float masked_prod(const Tables& tb, const int* mask,
                                             const float (&gpc)[kCache], const float* prob,
                                             int W, int w, int qs, float gs) {
  float f = 1.0f;
#pragma unroll
  for (int q = 0; q < kCache; ++q)
    if (q < tb.P && mask[q]) f = __fmul_rn(f, q == qs ? gs : gpc[q]);
  for (int q = kCache; q < tb.P; ++q)
    if (mask[q]) f = __fmul_rn(f, q == qs ? gs : pair_prod(tb, q, prob, W, w));
  return f;
}

__device__ __forceinline__ void put(float (&c)[kCache], int i, float v) {
#pragma unroll
  for (int j = 0; j < kCache; ++j)
    if (i == j) c[j] = v;
}

__device__ __forceinline__ float get(const float (&c)[kCache], int i) {
  float v = c[0];
#pragma unroll
  for (int j = 1; j < kCache; ++j)
    if (i == j) v = c[j];
  return v;
}

template <bool kCplx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) chain_accept_kernel(
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
  extern __shared__ double hs[];       // [H] the block's histogram (hist_smem), then the layout
  const int nd = N + 1, norm = N;
  int* ti = reinterpret_cast<int*>(hs + (hist_smem ? H : 0));

  // ---- stage the layout ----
  const int* leaf = meta;                          // [L, 8]
  const int* grp = leaf + kLeafFields * L;         // [nvar, 3]: lo, hi, maxdof
  int P = 0;
  for (int g = 0; g < nvar; ++g) P += grp[3 * g + 2];
  const int* masks = grp + 3 * nvar + nelig;       // padm [nd, P], usedm [N, P], hfeed [S, N]
  const int nmask = nd * P + N * P + S * N;
  const int* sleaf = masks + nmask;                // [S]
  int* pstart = ti;
  int* prow = pstart + S + 1;
  int* gbase = prow + S;
  int* hoff = gbase + nvar;
  int* feeds = hoff + S;
  int* smask = feeds + N;
  float* srw = reinterpret_cast<float*>(ti + table_ints(S, nvar, N));
  for (int q = threadIdx.x; q < nmask; q += blockDim.x) smask[q] = masks[q];
  for (int q = threadIdx.x; q < nd; q += blockDim.x) srw[q] = rw[q];
  for (int k = threadIdx.x; k < S; k += blockDim.x)
    hoff[k] = leaf[kLeafFields * sleaf[k] + 6];
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    int f = 0;
    for (int k = 0; k < S; ++k) f |= masks[nd * P + N * P + k * N + i];
    feeds[i] = f;
  }
  if (threadIdx.x == 0) {
    int q = 0, n = 0;
    for (int g = 0; g < nvar; ++g) {
      gbase[g] = q;
      for (int s = 0; s < grp[3 * g + 2]; ++s, ++q) {
        pstart[q] = n;
        for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d)
          prow[n++] = leaf[kLeafFields * d + 5] + s;
      }
    }
    pstart[q] = n;
  }
  if (hist_smem)
    for (int q = threadIdx.x; q < H; q += blockDim.x) hs[q] = 0.0;
  __syncthreads();
  const Tables tb{P, pstart, prow, gbase, smask, smask + nd * P, smask + nd * P + N * P,
                  hoff, feeds, srw};

  const int stride = gridDim.x * blockDim.x;
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W; w += stride) {
    // the lines this walker reads after its decision (both copies of the
    // moved slots; weights, pads, gidx and accumulators of the state after
    // the move), and the next walker's first ones, on their way while the
    // decision is made
    if (!init) {
      const int qm = tb.gbase[move[w]] + move[W + w];
      for (int n = tb.pstart[qm]; n < tb.pstart[qm + 1]; ++n) {
        const long long i = (long long)tb.prow[n] * W + w;
        prefetch_l1(cur_val + i);
        prefetch_l1(cur_gidx + i);
        prefetch_l1(cur_prob + i);
        prefetch_l1(prp_val + i);
        prefetch_l1(prp_gidx + i);
      }
      for (int i = 0; i < nd; ++i) {
        prefetch_l1(pad + (long long)i * W + w);
        if (measure) prefetch_l1(vis + (long long)i * W + w);
      }
      const int wf = kCplx ? 2 : 1;      // floats per weight, obs components per integrand
      for (int i = 0; i < N; ++i) {
        prefetch_l1(wgt + wf * ((long long)i * W + w));
        if (measure && !custom)
          for (int j = 0; j < wf; ++j) prefetch_l1(obs + (long long)(wf * i + j) * W + w);
      }
      for (int k = 0; k < S; ++k) prefetch_l1(cur_gidx + (long long)k * W + w);
      if (measure) prefetch_l1(nrm + w);
    }
    if (w + stride < W) {
      prefetch_l2(move + w + stride);
      prefetch_l2(move + W + w + stride);
      prefetch_l2(prop + w + stride);
      prefetch_l2(pj + w + stride);
      for (int k = 0; k < S; ++k) prefetch_l2(prp_prob + (long long)k * W + w + stride);
    }

    // ---- the proposal's pair products, pads and joint density ----
    float gpc[kCache], npc[kCache];
#pragma unroll
    for (int q = 0; q < kCache; ++q)
      gpc[q] = q < P ? pair_prod(tb, q, prp_prob, W, w) : 1.0f;
    float np = masked_prod(tb, tb.padm + norm * P, gpc, prp_prob, W, w, -1, 0.0f);
    put(npc, norm, np);
    float new_p = __fmul_rn(tb.rw[norm], np);
    for (int i = 0; i < N; ++i) {
      np = masked_prod(tb, tb.padm + i * P, gpc, prp_prob, W, w, -1, 0.0f);
      put(npc, i, np);
      new_p = __fadd_rn(new_p, __fmul_rn(__fmul_rn(Wt::load(nw, (long long)i * W + w).abs(),
                                                    tb.rw[i]), np));
    }
    bool acc = true;
    float p = new_p;
    if (!init) {
      const float u = uniform(walker_base(kd, t, w, wb), kSaltAccept);
      const float pr = prop[w];
      const float p_old = pj[w];
      acc = (u < __fdiv_rn(__fmul_rn(pr, new_p), p_old)) && (pr > 1e-38f);
      if (!acc) p = p_old;
    }
    // the pads of the state after the move: kept, formed again, or as they were
    auto pad_after = [&](int i) {
      return !acc ? pad[(long long)i * W + w] : i < kCache ? get(npc, i)
          : masked_prod(tb, tb.padm + i * P, gpc, prp_prob, W, w, -1, 0.0f);
    };
    if (acc) {
      for (int i = 0; i < N; ++i) {
        const long long q = (long long)i * W + w;
        Wt::load(nw, q).store(wgt, q);
      }
      for (int i = 0; i < nd; ++i) pad[(long long)i * W + w] = pad_after(i);
      pj[w] = new_p;
    }
    if (init) continue;

    // ---- the changed slots: prp -> cur on accept, cur -> prp on reject ----
    const int g = move[w];
    const int s = move[W + w];
    const int qm = tb.gbase[g] + s;
    float gm = 1.0f;              // the moved pair's product after the move
    for (int n = tb.pstart[qm]; n < tb.pstart[qm + 1]; ++n) {
      const long long i = (long long)tb.prow[n] * W + w;
      float pb;
      if (acc) {
        cur_val[i] = prp_val[i];
        cur_gidx[i] = prp_gidx[i];
        pb = prp_prob[i];
        cur_prob[i] = pb;
      } else {
        prp_val[i] = cur_val[i];
        prp_gidx[i] = cur_gidx[i];
        pb = cur_prob[i];
        prp_prob[i] = pb;
      }
      gm = __fmul_rn(gm, pb);
    }
    pc[(long long)g * W + w] += 1;
    if (acc) ac[(long long)g * W + w] += 1;

    // ---- histogram weights and measurement of the state after the move ----
    for (int i = 0; i < N; ++i) {
      const long long q = (long long)i * W + w;
      const Wt wi = Wt::load(acc ? nw : wgt, q);
      const float padi = pad_after(i);
      if (tb.feeds[i]) {
        const float prob_i = masked_prod(tb, tb.usedm + i * P, gpc, cur_prob, W, w, qm, gm);
        float a = __fdiv_rn(wi.abs2(), prob_i);
        a = __fdiv_rn(__fmul_rn(a, padi), p);
        a = a > 1e34f ? 1e34f : a;   // NaN passes through, as torch.clamp
        for (int k = 0; k < S; ++k) {
          if (!tb.hfeed[k * N + i]) continue;
          const int bin = tb.hoff[k] + cur_gidx[(long long)k * W + w];
          double v = (double)a;
          if (merge_by_key(__activemask(), bin, v)) {
            if (hist_smem)   // two adds, each to an address space the compiler knows
              atomicAdd(hs + bin, v);
            else
              atomicAdd(hist + bin, v);
          }
        }
      }
      if (measure) {
        const Wt r = wi.scale(__fdiv_rn(padi, p));
        if (custom)
          r.store(relw, q);
        else
          r.add_to(obs, i, W, w);
        vis[q] += (double)__fdiv_rn(__fmul_rn(__fmul_rn(wi.abs(), padi), tb.rw[i]), p);
      }
    }
    if (measure) {
      const float norm_w = __fdiv_rn(pad_after(norm), p);
      nrm[w] += (double)norm_w;
      vis[(long long)norm * W + w] += (double)__fmul_rn(tb.rw[norm], norm_w);
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
                  void* prp_prob,
                  void* cur_val, void* cur_gidx, void* cur_prob, const void* nw,
                  const void* prop, const void* move, void* w, void* pad, void* p,
                  void* obs, void* nrm, void* vis, void* pc, void* ac, void* hist,
                  void* relw, void* stream) {
  const size_t smem = (hist_smem ? (size_t)H * sizeof(double) : 0)
      + (size_t)table_ints(S, nvar, N) * sizeof(int) + (size_t)(N + 1) * sizeof(float);
  // the shape of the last launch on this device: every step repeats it
  static int last_dev = -1, per_sm = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != last_dev || smem != last_smem) {
    const int err = blocks_per_sm(chain_accept_kernel<kCplx>, kThreads, smem, &per_sm);
    if (err) return err;
    last_dev = dev;
    last_smem = smem;
  }
  long long blocks = ((long long)W + kThreads - 1) / kThreads;
  const long long cap = (long long)per_sm * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
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
      void *cur_gidx,                                                                \
      void *cur_prob, const void *nw, const void *prop, const void *move, void *w,   \
      void *pad, void *p, void *obs, void *nrm, void *vis, void *pc, void *ac,       \
      void *hist, void *relw, void *stream
#define MCI_CHAIN_ACCEPT_PASS                                                         \
  kd, t, init, measure, custom, W, wb, L, S, nvar, nelig, N, meta, rw, H, hist_smem, \
      prp_val,                                                                       \
      prp_gidx, prp_prob, cur_val, cur_gidx, cur_prob, nw, prop, move, w, pad, p,    \
      obs, nrm, vis, pc, ac, hist, relw, stream

// float32 weights
extern "C" int mci_chain_accept(MCI_CHAIN_ACCEPT_ARGS) {
  return launch_accept<false>(MCI_CHAIN_ACCEPT_PASS);
}

// complex64 weights: nw, w and relw interleaved (re, im); obs [2N, W] for the
// default measure
extern "C" int mci_chain_accept_complex(MCI_CHAIN_ACCEPT_ARGS) {
  return launch_accept<true>(MCI_CHAIN_ACCEPT_PASS);
}
