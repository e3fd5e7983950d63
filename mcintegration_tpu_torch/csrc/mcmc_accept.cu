// mcmc_accept: the Metropolis half of one :mcmc Markov-chain step.
//
// Replaces the accept, tally, commit and measurement half of the step loop
// of mcintegration_tpu/ops/pallas_mcmc.py:build_mcmc_run_all (lines
// 1119-1289).  Per walker, given nw, the weight of its block's sector j on
// the proposed state prp_*, and p_old = max(prob, 1e-38):
//   CV   accept if u < prop*|nw|*rcur/p_old and prop > 1e-38
//   SW   accept if u < |nw|*rcur/p_old
//   CI   accept if u < prop*(degc/deg_j)*|nw|*rw_j/p_old and prop > 1e-38
//   NJ   accept if u < prop*(degc/deg_norm)*rw_norm/p_old
// (the bare degree ratio: lines 1119-1141).  It counts visited[curr] at
// step start and the exact propose/accept tallies [3, nd, max(nd, nvar)]
// (rows CI, CV, swap; configuration.jl:345-465), commits the touched slots
// (CV/swap: prp -> cur on accept, cur -> prp on reject; CI: created slots
// prp -> cur always, sampler.jl:306) and curr, weight, prob, rcur, degc,
// picv and dof (lines 1170-1206).  On a measured step (decided by the
// caller: t >= nburnin and (t - nburnin) % mf == 0) it adds, per walker in
// float64, sign(weight)/rcur into obs[curr] (or, with a custom measure,
// writes relw = weight/prob for it), 1/rw_norm into nrm in the
// normalization sector, and 1.0 per used slot of an adaptive leaf into its
// histogram bin (lines 1208-1289: no HIST_EVERY or TALLY_EVERY subsample,
// no Kahan float32 pairs).  With init = 1 it takes retry t's weights of
// integrand 0 for the walkers still at prob 0, and starts every walker in
// integrand 0.
//
// Complex weights (type=complex, K3's branch at lines 526-551 and
// 1217-1252) run the same kernel instantiated with kCplx (entry
// mci_mcmc_accept_complex): nw, weight and relw are complex64, read and
// written as interleaved (re, im) float2 (chain_common.cuh: Weight).  Then
// |nw| = sqrt(re*re + im*im) in place of fabsf in every acceptance and in
// prob; a jump to the normalization sector zeroes both parts; the default
// measure adds the phase (re*inv_abs*invr, im*inv_abs*invr), inv_abs =
// 1/|w| (0 where |w| <= 1e-38), into obs[2*curr] and obs[2*curr + 1] in
// place of sign(w)/rcur; a custom measure gets relw = (re*invp, im*invp).
// The real instantiation is the real kernel as it was.
//
// What bounds it on the card: device-memory bytes, 8 per walker without a
// role (its role and sector; on a measured step also what its measurement
// reads and writes), 40 per walker with one (move, curr, the scalars and
// nw; 44 with a complex nw) and its commits.  At one thread per walker what costs more is (1) the
// counts: every walker adds one to visited[curr] and one or two to a tally
// cell, and with few sectors almost every walker of a warp
// hits the same counter (64-bit shared atomics, which the card runs as
// compare-and-swap loops); (2) divergence: a warp commits every kind of move
// any of its lanes made, one after the other.  So:
//   - counts are aggregated per warp: the lanes holding the same counter
//     (__match_any_sync) add their number once, through one lane, into the
//     block's 32-bit counters in shared memory (native atomics), flushed to
//     the 64-bit totals once per launch;
//   - histogram bins, which only ever receive exact 1.0s, are 32-bit integer
//     counts in shared memory, converted to float64 at the flush, so the
//     totals are bit-identical whatever the order; histograms too large for
//     shared memory take float64 atomics in device memory;
//   - walkers in tiles of kTile: the first pass counts every walker's visit
//     and measures the walkers without a role in place; the others are
//     sorted by branch class (CV or SW of each var group, CI, NJ; the
//     lanes of a warp in one class take one shared atomic between them),
//     and the second pass decides, tallies, commits and measures them, a
//     warp to a class;
//   - two blocks of kThreads on each SM, each zeroing and flushing its
//     counters and bins once per launch.  The tables (leaf rows, groups, dof
//     table, deg, rw) are read in device memory: staging them in shared
//     memory measured no faster (PERF.md).
// Every count is an integer, so the totals do not depend on the order of
// the atomics, and sorting changes which thread computes a walker, not what
// it computes.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding to the plain torch version's.

#include "mcmc_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWalkersPerThread = 2;
constexpr int kTile = kThreads * kWalkersPerThread;   // walkers sorted together
constexpr int kBlocksPerSm = 2;
typedef unsigned long long u64;

struct AcceptArgs {
  const uint32_t* kd;
  const int* sched;
  uint32_t t;
  int init, measure, custom, W, wb, L, nvar, nd, C;
  const int* meta;
  const float* deg;     // tab, which starts with deg [nd]
  const float* rw;
  const float* nw;
  int H, hist_smem, cnt_smem;   // histogram bins and counters in shared memory
  int* cur_val;
  int* cur_gidx;
  float* cur_prob;
  int* prp_val;
  int* prp_gidx;
  float* prp_prob;
  int* curr;
  float* weight;
  float* prob;
  float* rcur;
  float* degc;
  float* picv;
  int* dof;
  const float* prop;
  const int* move;
  float* relw;
  double* obs;
  double* nrm;
  u64* vis;
  u64* tally;
  double* hist;
};

// Add one per lane to counter key (-1: none): visited [nd], then propose
// and accept tallies [2, 3, nd, ncol].  The lanes of a warp holding the
// same key add their count once, into the block's shared counters or into
// device memory.  Every lane of the warp calls it.
__device__ __forceinline__ void count(uint32_t* cnt, u64* vis, u64* tally, int nd,
                                      int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key < 0 || (int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const unsigned n = __popc(peers);
  if (cnt) atomicAdd(cnt + key, n);
  else if (key < nd) atomicAdd(vis + key, (u64)n);
  else atomicAdd(tally + (key - nd), (u64)n);
}

// Slot s of leaf f: cur <- prp if take, else prp <- cur.
__device__ __forceinline__ void commit(const AcceptArgs& a, const int* f, int s, bool take,
                                       int w) {
  const int W = a.W;
  const long long k = ((long long)f[kSlot0] + s) * W + w;
  const long long r = f[kVrow0] + (long long)s * f[kWidth];
  for (int c = 0; c < f[kWidth]; ++c) {
    const long long i = (r + c) * W + w;
    if (take) a.cur_val[i] = a.prp_val[i]; else a.prp_val[i] = a.cur_val[i];
  }
  if (take) {
    a.cur_gidx[k] = a.prp_gidx[k];
    a.cur_prob[k] = a.prp_prob[k];
  } else {
    a.prp_gidx[k] = a.cur_gidx[k];
    a.prp_prob[k] = a.cur_prob[k];
  }
}

// Walker w's measurement on its state after the move (lines 1208-1289):
// sector c2, weight wt, prob p2, rcur rc2; histogram bins into hcnt
// (shared) or a.hist.
template <bool kCplx>
__device__ __forceinline__ void measure_walker(const AcceptArgs& a, const Tables& T,
                                               uint32_t* hcnt, int w, int c2,
                                               Weight<kCplx> wt, float p2, float rc2) {
  const int W = a.W, norm = a.nd - 1;
  const bool in_norm = c2 == norm;
  if (a.custom) {
    const bool ok = !in_norm && p2 > tiny();
    wt.scale(ok ? __fdiv_rn(1.0f, p2) : 0.0f).store(a.relw, w);
  } else if (!in_norm) {
    if constexpr (kCplx) {   // the phase w/|w| (lines 1217-1233)
      const float absw = wt.abs();
      const float inv_abs = absw > tiny() ? __fdiv_rn(1.0f, absw) : 0.0f;
      wt.scale(inv_abs).scale(__fdiv_rn(1.0f, rc2)).add_to(a.obs, c2, W, w);
    } else {
      const float sgn = wt.v > 0.0f ? 1.0f : (wt.v < 0.0f ? -1.0f : 0.0f);
      a.obs[(long long)c2 * W + w] += (double)__fmul_rn(sgn, __fdiv_rn(1.0f, rc2));
    }
  }
  if (in_norm) {
    a.nrm[w] += (double)__fdiv_rn(1.0f, a.rw[norm]);
    return;
  }
  for (int d = 0; d < a.L; ++d) {
    const int* f = T.leaf + kFields * d;
    if (f[kHist] < 0) continue;
    const int dg = a.dof[(long long)f[kGroup] * W + w];
    for (int s = 0; s < f[kNdraw] && s < dg; ++s) {
      const int bin = f[kHist] + a.cur_gidx[((long long)f[kSlot0] + s) * W + w];
      if (hcnt) atomicAdd(hcnt + bin, 1u);
      else atomicAdd(a.hist + bin, 1.0);
    }
  }
}

// Walker w's step after a proposal with a role: acceptance, its tally keys
// kp and ka (-1: none), commit, then its measurement on a measured step.
template <bool kCplx>
__device__ __forceinline__ void accept_walker(const AcceptArgs& a, const Tables& T,
                                              uint32_t* hcnt, int w, int& kp, int& ka) {
  typedef Weight<kCplx> Wt;
  const int W = a.W, nd = a.nd, nvar = a.nvar, norm = nd - 1;
  const int ncol = max(nd, nvar);
  // the walker's own fields first, then what depends on them
  const int role = a.move[w], vi = a.move[W + w];
  const int idx1 = a.move[2 * W + w], idx2 = a.move[3 * W + w];
  const int c = a.curr[w];
  const Wt nwv = Wt::load(a.nw, w);
  const float pr = a.prop[w], p_raw = a.prob[w];
  const float p_old = fmaxf(p_raw, tiny());
  const float rc = a.rcur[w], dc_ = a.degc[w];
  const int jt = a.sched[(long long)a.t * (W / a.wb) + w / a.wb] >> 1;
  const float u = uniform(walker_base(a.kd, a.t, w, a.wb), kSaltAccept);

  // ---- acceptance (pallas_mcmc.py:1119-1141) ----
  const float anw = nwv.abs();
  const float p_mv = __fmul_rn(anw, rc);
  const float r_jt = a.rw[jt], deg_jt = a.deg[jt];
  const float p_ci = __fmul_rn(anw, r_jt);
  bool acc = false;
  int cell = -1, row = 0;
  if (role == kRoleCv) {
    acc = u < __fdiv_rn(__fmul_rn(pr, p_mv), p_old) && pr > tiny();
    row = 1; cell = jt * ncol + vi;
  } else if (role == kRoleSw) {
    acc = u < __fdiv_rn(p_mv, p_old);
    row = 2; cell = jt * ncol + vi;
  } else if (role == kRoleCi) {
    const float x = __fmul_rn(__fmul_rn(pr, __fdiv_rn(dc_, deg_jt)), p_ci);
    acc = u < __fdiv_rn(x, p_old) && pr > tiny();
    cell = c * ncol + jt;
  } else if (role == kRoleNj) {
    const float x = __fmul_rn(__fmul_rn(pr, __fdiv_rn(dc_, a.deg[norm])), a.rw[norm]);
    acc = u < __fdiv_rn(x, p_old);
    cell = c * ncol + norm;
  }
  if (cell >= 0) {
    kp = nd + row * nd * ncol + cell;
    if (acc) ka = nd + (3 + row) * nd * ncol + cell;
  }

  // ---- commit (lines 1170-1206); c2, wt, p2, rc2: the state after it ----
  int c2 = c;
  Wt wt = nwv;
  float p2 = p_raw, rc2 = rc;
  bool took = false;                       // weight <- nw
  if (role == kRoleCv || role == kRoleSw) {
    for (int d = T.grp[3 * vi]; d < T.grp[3 * vi + 1]; ++d) {
      const int* f = T.leaf + kFields * d;
      commit(a, f, idx1, acc, w);
      if (role == kRoleSw) commit(a, f, idx2, acc, w);
    }
    if (acc) {
      nwv.store(a.weight, w);
      a.prob[w] = p_mv;
      took = true;
      p2 = p_mv;
    }
  } else if (role == kRoleCi) {
    for (int g = 0; g < nvar; ++g) {
      const int dcur = a.dof[(long long)g * W + w], dj = T.dof_tab[jt * nvar + g];
      for (int d = T.grp[3 * g]; d < T.grp[3 * g + 1]; ++d)
        for (int s = dcur; s < dj; ++s) commit(a, T.leaf + kFields * d, s, true, w);
    }
    if (acc) {
      nwv.store(a.weight, w);
      a.prob[w] = p_ci;
      a.curr[w] = jt;
      a.rcur[w] = r_jt;
      a.degc[w] = deg_jt;
      a.picv[w] = __fdiv_rn(1.0f, __fmul_rn(deg_jt, (float)a.C));
      for (int g = 0; g < nvar; ++g) a.dof[(long long)g * W + w] = T.dof_tab[jt * nvar + g];
      took = true;
      c2 = jt;
      p2 = p_ci;
      rc2 = r_jt;
    }
  } else if (role == kRoleNj && acc) {
    const float r_norm = a.rw[norm];
    wt = Wt::load(a.weight, w).scale(0.0f);
    wt.store(a.weight, w);
    a.prob[w] = r_norm;
    a.curr[w] = norm;
    a.rcur[w] = r_norm;
    a.degc[w] = a.deg[norm];
    a.picv[w] = __fdiv_rn(1.0f, __fmul_rn(a.deg[norm], (float)a.C));
    for (int g = 0; g < nvar; ++g) a.dof[(long long)g * W + w] = 0;
    took = true;
    c2 = norm;
    p2 = r_norm;
    rc2 = r_norm;
  }
  if (!a.measure) return;
  measure_walker<kCplx>(a, T, hcnt, w, c2, took ? wt : Wt::load(a.weight, w), p2, rc2);
}

template <bool kCplx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) mcmc_accept_kernel(
    const AcceptArgs a) {
  typedef Weight<kCplx> Wt;
  __shared__ int list[kTile];       // a tile's walkers with a role, by class
  extern __shared__ uint32_t sh[];  // [H] bins, [ncnt] counters, [K] counts, [K + 1] offsets
  const int nd = a.nd, nvar = a.nvar;
  const int ncnt = nd + 6 * nd * max(nd, nvar);
  const int K = 2 * nvar + 2;
  uint32_t* hcnt = a.hist_smem && a.measure && !a.init ? sh : nullptr;
  uint32_t* cnt = a.cnt_smem && !a.init ? sh + (a.hist_smem ? a.H : 0) : nullptr;
  int* ccnt = (int*)(sh + (a.hist_smem ? a.H : 0) + (a.cnt_smem ? ncnt : 0));
  int* coff = ccnt + K;
  if (hcnt) for (int q = threadIdx.x; q < a.H; q += blockDim.x) hcnt[q] = 0u;
  if (cnt) for (int q = threadIdx.x; q < ncnt; q += blockDim.x) cnt[q] = 0u;
  for (int q = threadIdx.x; q < K; q += blockDim.x) ccnt[q] = 0;
  __syncthreads();
  const Tables T = tables(a.meta, a.L, nvar, nd);
  const int W = a.W;
  const int stride = gridDim.x * blockDim.x;

  if (a.init) {
    const float r0 = a.rw[0], d0 = a.deg[0];
    const float p0 = __fdiv_rn(1.0f, __fmul_rn(d0, (float)a.C));
    for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W; w += stride) {
      if (a.prob[w] <= tiny()) {
        const Wt nwv = Wt::load(a.nw, w);
        nwv.store(a.weight, w);
        a.prob[w] = __fmul_rn(nwv.abs(), r0);
      }
      a.curr[w] = 0;
      a.rcur[w] = r0;
      a.degc[w] = d0;
      a.picv[w] = p0;
      for (int g = 0; g < nvar; ++g) a.dof[(long long)g * W + w] = T.dof_tab[g];
    }
    return;
  }

  // A tile's walkers count their visit, and the ones without a role are
  // measured in place; the others are sorted by branch class (CV or SW of
  // each var group, CI, NJ), so a warp of the second pass commits one kind
  // of move, not all of them in series.  Whole warps walk together, so every
  // lane reaches the warp-wide counts.
  const int lane = threadIdx.x & 31;
  for (int tile0 = blockIdx.x * kTile; tile0 < W; tile0 += gridDim.x * kTile) {
    int key[kWalkersPerThread];
    for (int q = 0; q < kWalkersPerThread; ++q) {
      const int w = tile0 + q * kThreads + threadIdx.x;
      int kv = -1;
      key[q] = -1;
      if (w < W) {
        const int role = a.move[w], c = a.curr[w];
        kv = c;
        if (role != kRoleNone) {
          const int vi = a.move[W + w];
          key[q] = branch_class(role, vi, nvar);
        } else if (a.measure) {
          measure_walker<kCplx>(a, T, hcnt, w, c, Wt::load(a.weight, w), a.prob[w], a.rcur[w]);
        }
      }
      count(cnt, a.vis, a.tally, nd, kv);
    }
    const int n = sort_tile(key, ccnt, coff, list, K);
    for (int s = threadIdx.x; s - lane < n; s += kThreads) {
      int kp = -1, ka = -1;
      if (s < n) accept_walker<kCplx>(a, T, hcnt, tile0 + list[s], kp, ka);
      count(cnt, a.vis, a.tally, nd, kp);
      count(cnt, a.vis, a.tally, nd, ka);
    }
    __syncthreads();
  }

  if (!hcnt && !cnt) return;
  __syncthreads();
  if (hcnt)
    for (int q = threadIdx.x; q < a.H; q += blockDim.x)
      if (hcnt[q]) atomicAdd(a.hist + q, (double)hcnt[q]);
  if (cnt)
    for (int q = threadIdx.x; q < ncnt; q += blockDim.x)
      if (cnt[q]) atomicAdd(q < nd ? a.vis + q : a.tally + (q - nd), (u64)cnt[q]);
}

template <bool kCplx>
int launch_accept(const void* kd, const void* sched, int t, int init, int measure, int custom,
                  int W, int wb, int L, int nvar, int nd, int C, const void* meta,
                  const void* tab, const void* rw, const void* nw, int H, int hist_smem,
                  int cnt_smem, void* cur_val, void* cur_gidx, void* cur_prob, void* prp_val,
                  void* prp_gidx, void* prp_prob, void* curr, void* weight, void* prob,
                  void* rcur, void* degc, void* picv, void* dof, const void* prop,
                  const void* move, void* relw, void* obs, void* nrm, void* vis, void* tally,
                  void* hist, void* stream) {
  const AcceptArgs a{(const uint32_t*)kd, (const int*)sched, (uint32_t)t, init, measure,
                     custom, W, wb, L, nvar, nd, C, (const int*)meta, (const float*)tab,
                     (const float*)rw, (const float*)nw, H, hist_smem, cnt_smem,
                     (int*)cur_val, (int*)cur_gidx, (float*)cur_prob, (int*)prp_val,
                     (int*)prp_gidx, (float*)prp_prob, (int*)curr, (float*)weight,
                     (float*)prob, (float*)rcur, (float*)degc, (float*)picv, (int*)dof,
                     (const float*)prop, (const int*)move, (float*)relw, (double*)obs,
                     (double*)nrm, (u64*)vis, (u64*)tally, (double*)hist};
  long long blocks = ((long long)W + kTile - 1) / kTile;
  const long long cap = (long long)kBlocksPerSm * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const int ncol = nd > nvar ? nd : nvar;
  const size_t words = (hist_smem ? (size_t)H : 0) + (cnt_smem ? (size_t)(nd + 6 * nd * ncol) : 0)
      + 2 * (2 * (size_t)nvar + 2) + 1;
  mcmc_accept_kernel<kCplx><<<(unsigned)blocks, kThreads, words * 4, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCI_MCMC_ACCEPT_ARGS                                                          \
  const void *kd, const void *sched, int t, int init, int measure, int custom, int W, \
      int wb, int L, int nvar, int nd, int C, const void *meta, const void *tab,      \
      const void *rw, const void *nw, int H, int hist_smem, int cnt_smem,             \
      void *cur_val, void *cur_gidx, void *cur_prob, void *prp_val, void *prp_gidx,   \
      void *prp_prob, void *curr, void *weight, void *prob, void *rcur, void *degc,   \
      void *picv, void *dof, const void *prop, const void *move, void *relw,          \
      void *obs, void *nrm, void *vis, void *tally, void *hist, void *stream
#define MCI_MCMC_ACCEPT_PASS                                                          \
  kd, sched, t, init, measure, custom, W, wb, L, nvar, nd, C, meta, tab, rw, nw, H,  \
      hist_smem, cnt_smem, cur_val, cur_gidx, cur_prob, prp_val, prp_gidx, prp_prob, \
      curr, weight, prob, rcur, degc, picv, dof, prop, move, relw, obs, nrm, vis,    \
      tally, hist, stream

// float32 weights
extern "C" int mci_mcmc_accept(MCI_MCMC_ACCEPT_ARGS) {
  return launch_accept<false>(MCI_MCMC_ACCEPT_PASS);
}

// complex64 weights: nw, weight and relw interleaved (re, im); obs [2N, W]
// for the default measure
extern "C" int mci_mcmc_accept_complex(MCI_MCMC_ACCEPT_ARGS) {
  return launch_accept<true>(MCI_MCMC_ACCEPT_PASS);
}
