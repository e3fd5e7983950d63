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
// What bounds it on the card: device-memory bytes, about 60 per walker per
// step on the main path (read nw, the scalars and move, write the commits;
// the float64 accumulators on measured steps), and latency at one thread
// per walker with dependent loads.  Counters and histograms are privatised
// per thread block in shared memory (64-bit counters, float64 bins) and
// flushed with atomics once per launch; larger ones go straight to device
// memory.  Every histogram increment is an exact 1.0 and every count an
// integer, so the totals do not depend on the order of the atomics.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding to the plain torch version's.

#include "mcmc_common.cuh"

namespace {

constexpr int kThreads = 512;
typedef unsigned long long u64;

// Add one to counter q: visited [nd], then propose and accept tallies
// [2, 3, nd, ncol]; into the block's shared counters, or device memory.
__device__ __forceinline__ void bump(u64* cnt, u64* vis, u64* tally, int nd, int q) {
  if (cnt) atomicAdd(cnt + q, 1ULL);
  else if (q < nd) atomicAdd(vis + q, 1ULL);
  else atomicAdd(tally + (q - nd), 1ULL);
}

// Slot s of leaf f: cur <- prp if take, else prp <- cur.
__device__ __forceinline__ void commit(const int* f, int s, bool take, int* cur_val,
                                       int* cur_gidx, float* cur_prob, int* prp_val,
                                       int* prp_gidx, float* prp_prob, int W, int w) {
  const long long k = ((long long)f[kSlot0] + s) * W + w;
  const long long r = f[kVrow0] + (long long)s * f[kWidth];
  for (int c = 0; c < f[kWidth]; ++c) {
    const long long i = (r + c) * W + w;
    if (take) cur_val[i] = prp_val[i]; else prp_val[i] = cur_val[i];
  }
  if (take) {
    cur_gidx[k] = prp_gidx[k];
    cur_prob[k] = prp_prob[k];
  } else {
    prp_gidx[k] = cur_gidx[k];
    prp_prob[k] = cur_prob[k];
  }
}

__global__ void __launch_bounds__(kThreads, 2) mcmc_accept_kernel(
    const uint32_t* __restrict__ kd, const int* __restrict__ sched, uint32_t t,
    int init, int measure, int custom, int W, int wb, int L, int nvar, int nd,
    int C, const int* __restrict__ meta, const float* __restrict__ tab,
    const float* __restrict__ rw, const float* __restrict__ nw, int H,
    int hist_smem, int cnt_smem, int* __restrict__ cur_val,
    int* __restrict__ cur_gidx, float* __restrict__ cur_prob,
    int* __restrict__ prp_val, int* __restrict__ prp_gidx,
    float* __restrict__ prp_prob, int* __restrict__ curr,
    float* __restrict__ weight, float* __restrict__ prob,
    float* __restrict__ rcur, float* __restrict__ degc,
    float* __restrict__ picv, int* __restrict__ dof,
    const float* __restrict__ prop, const int* __restrict__ move,
    float* __restrict__ relw, double* __restrict__ obs,
    double* __restrict__ nrm, u64* __restrict__ vis, u64* __restrict__ tally,
    double* __restrict__ hist) {
  extern __shared__ double sh[];
  const int* leaf = meta;                          // [L, kFields]
  const int* grp = leaf + kFields * L;             // [nvar, 3]: dlo, dhi, maxdof
  const int* dof_tab = grp + 3 * nvar;             // [nd, nvar]
  const float* deg = tab;                          // [nd]
  const int norm = nd - 1;
  const int ncol = max(nd, nvar);
  const int ncnt = nd + 6 * nd * ncol;
  const int B = W / wb;
  double* hdst = hist_smem ? sh : hist;
  u64* cnt = cnt_smem ? (u64*)(sh + (hist_smem ? H : 0)) : nullptr;
  if (hist_smem)
    for (int q = threadIdx.x; q < H; q += blockDim.x) sh[q] = 0.0;
  if (cnt)
    for (int q = threadIdx.x; q < ncnt; q += blockDim.x) cnt[q] = 0ULL;
  __syncthreads();

  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W;
       w += gridDim.x * blockDim.x) {
    if (init) {
      if (prob[w] <= tiny()) {
        weight[w] = nw[w];
        prob[w] = __fmul_rn(fabsf(nw[w]), rw[0]);
      }
      curr[w] = 0;
      rcur[w] = rw[0];
      degc[w] = deg[0];
      picv[w] = __fdiv_rn(1.0f, __fmul_rn(deg[0], (float)C));
      for (int g = 0; g < nvar; ++g) dof[(long long)g * W + w] = dof_tab[g];
      continue;
    }
    const int jt = sched[(long long)t * B + w / wb] >> 1;
    const int role = move[w], vi = move[W + w];
    const int idx1 = move[2 * W + w], idx2 = move[3 * W + w];
    const int c = curr[w];
    bump(cnt, vis, tally, nd, c);

    // ---- acceptance (pallas_mcmc.py:1119-1141) ----
    const float u = uniform(walker_base(kd, t, w, wb), kSaltAccept);
    const float p_old = fmaxf(prob[w], tiny());
    const float anw = fabsf(nw[w]);
    const float p_mv = __fmul_rn(anw, rcur[w]);
    const float r_jt = rw[jt], deg_jt = deg[jt];
    const float p_ci = __fmul_rn(anw, r_jt);
    const float pr = prop[w];
    const float dc_ = degc[w];
    bool acc = false;
    int cell = -1, row = 0;
    if (role == kRoleCv) {
      acc = u < __fdiv_rn(__fmul_rn(pr, p_mv), p_old) && pr > tiny();
      row = 1; cell = jt * ncol + vi;
    } else if (role == kRoleSw) {
      acc = u < __fdiv_rn(p_mv, p_old);
      row = 2; cell = jt * ncol + vi;
    } else if (role == kRoleCi) {
      const float a = __fmul_rn(__fmul_rn(pr, __fdiv_rn(dc_, deg_jt)), p_ci);
      acc = u < __fdiv_rn(a, p_old) && pr > tiny();
      cell = c * ncol + jt;
    } else if (role == kRoleNj) {
      const float a = __fmul_rn(__fmul_rn(pr, __fdiv_rn(dc_, deg[norm])), rw[norm]);
      acc = u < __fdiv_rn(a, p_old);
      cell = c * ncol + norm;
    }
    if (cell >= 0) {
      bump(cnt, vis, tally, nd, nd + row * nd * ncol + cell);
      if (acc) bump(cnt, vis, tally, nd, nd + (3 + row) * nd * ncol + cell);
    }

    // ---- commit (lines 1170-1206) ----
    if (role == kRoleCv || role == kRoleSw) {
      for (int d = grp[3 * vi]; d < grp[3 * vi + 1]; ++d) {
        const int* f = leaf + kFields * d;
        commit(f, idx1, acc, cur_val, cur_gidx, cur_prob, prp_val, prp_gidx, prp_prob, W, w);
        if (role == kRoleSw)
          commit(f, idx2, acc, cur_val, cur_gidx, cur_prob, prp_val, prp_gidx, prp_prob,
                 W, w);
      }
      if (acc) {
        weight[w] = nw[w];
        prob[w] = p_mv;
      }
    } else if (role == kRoleCi) {
      for (int g = 0; g < nvar; ++g) {
        const int dcur = dof[(long long)g * W + w], dj = dof_tab[jt * nvar + g];
        for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d)
          for (int s = dcur; s < dj; ++s)
            commit(leaf + kFields * d, s, true, cur_val, cur_gidx, cur_prob, prp_val,
                   prp_gidx, prp_prob, W, w);
      }
      if (acc) {
        weight[w] = nw[w];
        prob[w] = p_ci;
        curr[w] = jt;
        rcur[w] = r_jt;
        degc[w] = deg_jt;
        picv[w] = __fdiv_rn(1.0f, __fmul_rn(deg_jt, (float)C));
        for (int g = 0; g < nvar; ++g) dof[(long long)g * W + w] = dof_tab[jt * nvar + g];
      }
    } else if (role == kRoleNj && acc) {
      weight[w] = __fmul_rn(weight[w], 0.0f);
      prob[w] = rw[norm];
      curr[w] = norm;
      rcur[w] = rw[norm];
      degc[w] = deg[norm];
      picv[w] = __fdiv_rn(1.0f, __fmul_rn(deg[norm], (float)C));
      for (int g = 0; g < nvar; ++g) dof[(long long)g * W + w] = 0;
    }
    if (!measure) continue;

    // ---- measurement on the state after the move (lines 1208-1289) ----
    const int c2 = curr[w];
    const bool in_norm = c2 == norm;
    const float wt = weight[w];
    if (custom) {
      const float p = prob[w];
      const bool ok = !in_norm && p > tiny();
      relw[w] = __fmul_rn(wt, ok ? __fdiv_rn(1.0f, p) : 0.0f);
    } else if (!in_norm) {
      const float sgn = wt > 0.0f ? 1.0f : (wt < 0.0f ? -1.0f : 0.0f);
      obs[(long long)c2 * W + w] += (double)__fmul_rn(sgn, __fdiv_rn(1.0f, rcur[w]));
    }
    if (in_norm) {
      nrm[w] += (double)__fdiv_rn(1.0f, rw[norm]);
      continue;
    }
    for (int d = 0; d < L; ++d) {
      const int* f = leaf + kFields * d;
      if (f[kHist] < 0) continue;
      const int dg = dof[(long long)f[kGroup] * W + w];
      for (int s = 0; s < f[kNdraw] && s < dg; ++s)
        atomicAdd(hdst + f[kHist] + cur_gidx[((long long)f[kSlot0] + s) * W + w], 1.0);
    }
  }

  if (!init && (hist_smem || cnt)) {
    __syncthreads();
    for (int q = threadIdx.x; hist_smem && q < H; q += blockDim.x)
      if (sh[q] != 0.0) atomicAdd(hist + q, sh[q]);
    for (int q = threadIdx.x; cnt && q < ncnt; q += blockDim.x)
      if (cnt[q]) atomicAdd(q < nd ? vis + q : tally + (q - nd), cnt[q]);
  }
}

}  // namespace

extern "C" int mci_mcmc_accept(const void* kd, const void* sched, int t, int init,
                               int measure, int custom, int W, int wb, int L, int nvar,
                               int nd, int C, const void* meta, const void* tab,
                               const void* rw, const void* nw, int H, int hist_smem,
                               int cnt_smem, void* cur_val, void* cur_gidx,
                               void* cur_prob, void* prp_val, void* prp_gidx,
                               void* prp_prob, void* curr, void* weight, void* prob,
                               void* rcur, void* degc, void* picv, void* dof,
                               const void* prop, const void* move, void* relw,
                               void* obs, void* nrm, void* vis, void* tally,
                               void* hist, void* stream) {
  long long blocks = ((long long)W + kThreads - 1) / kThreads;
  const long long cap = 2LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const int ncol = nd > nvar ? nd : nvar;
  const size_t smem = (hist_smem ? (size_t)H * sizeof(double) : 0)
      + (cnt_smem ? (size_t)(nd + 6 * nd * ncol) * sizeof(u64) : 0);
  mcmc_accept_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, (const int*)sched, (uint32_t)t, init, measure, custom, W, wb,
      L, nvar, nd, C, (const int*)meta, (const float*)tab, (const float*)rw,
      (const float*)nw, H, hist_smem, cnt_smem, (int*)cur_val, (int*)cur_gidx,
      (float*)cur_prob, (int*)prp_val, (int*)prp_gidx, (float*)prp_prob, (int*)curr,
      (float*)weight, (float*)prob, (float*)rcur, (float*)degc, (float*)picv,
      (int*)dof, (const float*)prop, (const int*)move, (float*)relw, (double*)obs,
      (double*)nrm, (u64*)vis, (u64*)tally, (double*)hist);
  return (int)cudaGetLastError();
}
