// mcmc_propose: the proposal half of one :mcmc Markov-chain step.
//
// Replaces the draw half of the step loop of
// mcintegration_tpu/ops/pallas_mcmc.py:build_mcmc_run_all (lines 933-1114):
// the scheduled single-sector law.  Each walker reads its block's active
// sector j and swap flag for step t (sched [T, B], drawn on the host by
// ops/rng.py:schedule), draws one role uniform u against q = picv/N and
// takes at most one role (lines 957-991):
//   NJ  u < q, and curr neighbours the normalization sector: the jump there;
//       prop = product of the removal densities of curr's slots;
//   CV  u >= q and curr == j, swap flag clear: redraw slot idx1 of every
//       leaf of var group vi (a map draw, prop *= prob_old/prob_new; a
//       FermiK leaf takes the three-way scale/rotate/jitter shift);
//   SW  as CV with the swap flag set and idx1 != idx2: exchange two slots;
//   CI  q <= u < q + picv, and curr neighbours j: the jump to j, creating
//       slots [dof_curr, dof_j) (prop /= prob_new) and removing
//       [dof_j, dof_curr) (prop *= removal density), group by group.
// The proposal goes into the mirror prp_*, where the integrand of sector j
// reads it; prop and move (role, vi, idx1, idx2) go to mcmc_accept.  With
// init = 1 (retry r in place of t) the walkers still at prob 0 draw every
// slot afresh into both copies (lines 841-878).
//
// Fields [.., W] with walkers block-major.  The TPU kernel's lattice-roll
// draws (power-of-two ninc) and threshold-count CDF
// (nbin <= 1024) were workarounds for a missing gather; here a map draw is
// a gather and a Discrete draw a binary search of its CDF, of any size.
// Adjacency is an [nd, nd] table, so nd has no limit.
//
// What bounds it on the card: device-memory bytes, about 45 per walker per
// step on the main path (read curr, picv, dof and the touched slot; write
// the proposed slot, prop and move); its integer work (five to a dozen
// lowbias32 hashes per walker) and float work (two polynomial sin/cos
// evaluations for a FermiK draw) take a tenth of that time at the card's
// peak rates.  What the time goes to instead is divergence: a warp's 32
// walkers take different roles and var groups (the law fixes which), and a
// warp runs every branch any of its lanes takes, one after the other; with
// three var groups of different kinds that is every branch on almost every
// warp.  So a thread block walks its walkers in tiles of kTile: each thread
// chooses its walkers' roles in place and writes move (and prop = 1 for a
// walker without a role), then the walkers with a role are sorted by
// branch class (CV or SW of each var group, CI, NJ) through shared-memory
// counts, one atomic per class and warp, and a list, and a warp of the
// second pass runs one branch.  Sorting
// changes which thread computes a walker, not what it computes.  The tables
// (leaf rows, map grids, CDFs, FermiK constants) are read in device memory:
// staging them in shared memory measured no faster (PERF.md).
//
// Built with --fmad=false (ops/_build.py); with the _rn intrinsics every
// rounding matches the plain torch version in ops/mcmc_kernels.py.

#include "mcmc_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWalkersPerThread = 2;
constexpr int kTile = kThreads * kWalkersPerThread;   // walkers sorted together
constexpr int kBlocksPerSm = 2;

struct ProposeArgs {
  const uint32_t* kd;
  const int* sched;
  uint32_t t;
  int init, W, wb, L, nvar, nd, any_swap;
  const int* meta;
  const float* tab;
  int* cur_val;
  int* cur_gidx;
  float* cur_prob;
  int* prp_val;
  int* prp_gidx;
  float* prp_prob;
  const int* curr;
  const float* prob;
  const float* picv;
  const int* dof;
  float* prop;
  int* move;
};

// Slot s of leaf f: write value rows v, gidx and prob into prp.
__device__ __forceinline__ void put_slot(const int* f, int s, const int* v, int gidx,
                                         float prob, int* prp_val, int* prp_gidx,
                                         float* prp_prob, int W, int w) {
  const long long k = f[kSlot0] + s;
  const long long r = f[kVrow0] + (long long)s * f[kWidth];
  for (int c = 0; c < f[kWidth]; ++c) prp_val[(r + c) * W + w] = v[c];
  prp_gidx[k * W + w] = gidx;
  prp_prob[k * W + w] = prob;
}

// Walker w's role, var group and slots (pallas_mcmc.py:957-1015).
__device__ __forceinline__ void choose(const ProposeArgs& a, const Tables& T, uint32_t base,
                                       int code, int w, int& role, int& vi, int& idx1,
                                       int& idx2) {
  const int W = a.W, nvar = a.nvar, nd = a.nd, norm = nd - 1;
  const int c = a.curr[w];
  const float pv = a.picv[w];
  const int jt = code >> 1;
  const float u_role = uniform(base, kSaltRole);
  vi = nvar > 1 ? min((int)__fmul_rn(uniform(base, kSaltVi), (float)nvar), nvar - 1) : 0;
  const int dof_vi = a.dof[(long long)vi * W + w];
  const bool adjn = T.adj[c * nd + norm] != 0;
  const float qw = adjn ? __fmul_rn(pv, a.tab[nd]) : 0.0f;
  const bool nj = adjn && u_role < qw;
  const bool at_jt = c == jt && u_role >= qw;
  const bool ci = T.adj[c * nd + jt] != 0 && u_role >= qw && u_role < __fadd_rn(qw, pv);
  const float dvf = (float)dof_vi;
  const int top = max(dof_vi - 1, 0);
  idx1 = min((int)__fmul_rn(uniform(base, kSaltS1), dvf), top);
  const bool can_move = at_jt && dof_vi > 0;
  idx2 = 0;
  bool cv = can_move, sw = false;
  if (a.any_swap) {
    idx2 = min((int)__fmul_rn(uniform(base, kSaltS2), dvf), top);
    cv = can_move && !(code & 1);
    sw = can_move && (code & 1) && idx1 != idx2;
  }
  role = cv ? kRoleCv : sw ? kRoleSw : ci ? kRoleCi : nj ? kRoleNj : kRoleNone;
}

// Walker w's proposal into prp and its Hastings factor (lines 1017-1114).
__device__ __forceinline__ float propose_walker(const ProposeArgs& a, const Tables& T,
                                                uint32_t base, int jt, int role, int vi,
                                                int idx1, int idx2, int w) {
  const int W = a.W, nvar = a.nvar;
  int v[3], gidx;
  float pr, prop = 1.0f;
  if (role == kRoleCv) {
    for (int d = T.grp[3 * vi]; d < T.grp[3 * vi + 1]; ++d) {
      const int* f = T.leaf + kFields * d;
      if (f[kKind] == kFermiK) {
        const long long r = f[kVrow0] + (long long)idx1 * f[kWidth];
        float fv[3], uj[3];
        for (int q = 0; q < f[kWidth]; ++q) {
          fv[q] = __int_as_float(a.cur_val[(r + q) * W + w]);
          uj[q] = uniform(base, kSaltShift + 8u * d + 3u + q);
        }
        const float sp = fermik_shift(a.tab + f[kTab], f[kNb], fv,
                                      uniform(base, kSaltShift + 8u * d),
                                      uniform(base, kSaltShift + 8u * d + 1u),
                                      uniform(base, kSaltShift + 8u * d + 2u), uj);
        prop = __fmul_rn(prop, sp);
        for (int q = 0; q < f[kWidth]; ++q) a.prp_val[(r + q) * W + w] = __float_as_int(fv[q]);
      } else {
        const float p_old = a.cur_prob[(long long)(f[kSlot0] + idx1) * W + w];
        fresh_draw(f, a.tab, base, kSaltCv + 4u * d, v, gidx, pr);
        prop = __fmul_rn(prop, __fdiv_rn(p_old, pr));
        put_slot(f, idx1, v, gidx, pr, a.prp_val, a.prp_gidx, a.prp_prob, W, w);
      }
    }
  } else if (role == kRoleSw) {
    for (int d = T.grp[3 * vi]; d < T.grp[3 * vi + 1]; ++d) {
      const int* f = T.leaf + kFields * d;
      for (int h = 0; h < 2; ++h) {
        const int to = h ? idx2 : idx1, from = h ? idx1 : idx2;
        const long long kt = f[kSlot0] + to, kf = f[kSlot0] + from;
        const long long rt = f[kVrow0] + (long long)to * f[kWidth];
        const long long rf = f[kVrow0] + (long long)from * f[kWidth];
        for (int q = 0; q < f[kWidth]; ++q)
          a.prp_val[(rt + q) * W + w] = a.cur_val[(rf + q) * W + w];
        a.prp_gidx[kt * W + w] = a.cur_gidx[kf * W + w];
        a.prp_prob[kt * W + w] = a.cur_prob[kf * W + w];
      }
    }
  } else if (role == kRoleCi) {
    for (int g = 0; g < nvar; ++g) {
      const int md = T.grp[3 * g + 2];
      const int dc = a.dof[(long long)g * W + w], dj = T.dof_tab[jt * nvar + g];
      for (int d = T.grp[3 * g]; md > 0 && d < T.grp[3 * g + 1]; ++d) {
        const int* f = T.leaf + kFields * d;
          for (int s = 0; s < md; ++s) {
          const int k = f[kSlot0] + s;
          if (s >= dc && s < dj) {                 // created
            fresh_draw(f, a.tab, base, kSaltCi + 4u * (uint32_t)k, v, gidx, pr);
            if (f[kKind] == kFermiK)
              prop = pr > 0.0f ? __fdiv_rn(prop, fmaxf(pr, tiny())) : 0.0f;
            else
              prop = __fdiv_rn(prop, pr);
            put_slot(f, s, v, gidx, pr, a.prp_val, a.prp_gidx, a.prp_prob, W, w);
          } else if (s >= dj && s < dc) {          // removed
            prop = __fmul_rn(prop, old_density(f, a.tab, a.cur_val, a.cur_prob, k,
                                               f[kVrow0] + s * f[kWidth], W, w));
          }
        }
      }
    }
  } else if (role == kRoleNj) {
    for (int g = 0; g < nvar; ++g) {
      const int dc = a.dof[(long long)g * W + w];
      for (int d = T.grp[3 * g]; d < T.grp[3 * g + 1]; ++d) {
        const int* f = T.leaf + kFields * d;
          for (int s = 0; s < dc; ++s)
          prop = __fmul_rn(prop, old_density(f, a.tab, a.cur_val, a.cur_prob, f[kSlot0] + s,
                                             f[kVrow0] + s * f[kWidth], W, w));
      }
    }
  }
  return prop;
}

// Retry t of the start: the walkers still at prob 0 draw every slot afresh
// into both copies.
__device__ __forceinline__ void init_walker(const ProposeArgs& a, const Tables& T,
                                            uint32_t base, int w) {
  int v[3], gidx;
  float pr;
  for (int d = 0; d < a.L; ++d) {
    const int* f = T.leaf + kFields * d;
    for (int s = 0; s < f[kNdraw]; ++s) {
      fresh_draw(f, a.tab, base, kSaltInit + 4u * (uint32_t)(f[kSlot0] + s), v, gidx, pr);
      put_slot(f, s, v, gidx, pr, a.cur_val, a.cur_gidx, a.cur_prob, a.W, w);
      put_slot(f, s, v, gidx, pr, a.prp_val, a.prp_gidx, a.prp_prob, a.W, w);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) mcmc_propose_kernel(
    const ProposeArgs a) {
  __shared__ int list[kTile];                 // a tile's walkers with a role, by class
  __shared__ uint32_t sbase[kTile];           // per walker of the tile:
  __shared__ int srole[kTile], svi[kTile], sidx1[kTile], sidx2[kTile];
  extern __shared__ int cnt[];                // [K] counts, then [K + 1] offsets
  const int W = a.W, nvar = a.nvar, B = W / a.wb;
  const int K = 2 * nvar + 2;
  int* off = cnt + K;
  for (int q = threadIdx.x; q < K; q += blockDim.x) cnt[q] = 0;
  __syncthreads();
  const Tables T = tables(a.meta, a.L, nvar, a.nd);

  if (a.init) {
    for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W; w += gridDim.x * blockDim.x)
      if (a.prob[w] <= tiny()) init_walker(a, T, walker_base(a.kd, a.t, w, a.wb), w);
    return;
  }

  // A tile's walkers choose their roles in place, then the ones with work
  // are sorted by branch class (CV or SW of each var group, CI, NJ), so a
  // warp of the second pass runs one branch, not all of them in series.
  for (int tile0 = blockIdx.x * kTile; tile0 < W; tile0 += gridDim.x * kTile) {
    int key[kWalkersPerThread];
    for (int q = 0; q < kWalkersPerThread; ++q) {
      const int i = q * kThreads + threadIdx.x, w = tile0 + i;
      key[q] = -1;
      if (w >= W) continue;
      const uint32_t base = walker_base(a.kd, a.t, w, a.wb);
      int role, vi, idx1, idx2;
      choose(a, T, base, a.sched[(long long)a.t * B + w / a.wb], w, role, vi, idx1, idx2);
      a.move[w] = role;
      a.move[W + w] = vi;
      a.move[2 * W + w] = idx1;
      a.move[3 * W + w] = idx2;
      if (role == kRoleNone) {
        a.prop[w] = 1.0f;
        continue;
      }
      key[q] = branch_class(role, vi, nvar);
      sbase[i] = base;
      srole[i] = role;
      svi[i] = vi;
      sidx1[i] = idx1;
      sidx2[i] = idx2;
    }
    const int n = sort_tile(key, cnt, off, list, K);
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const int i = list[s], w = tile0 + i;
      a.prop[w] = propose_walker(a, T, sbase[i], a.sched[(long long)a.t * B + w / a.wb] >> 1,
                                 srole[i], svi[i], sidx1[i], sidx2[i], w);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int mci_mcmc_propose(const void* kd, const void* sched, int t, int init,
                                int W, int wb, int L, int nvar, int nd, int any_swap,
                                const void* meta, const void* tab, void* cur_val,
                                void* cur_gidx, void* cur_prob, void* prp_val,
                                void* prp_gidx, void* prp_prob, const void* curr,
                                const void* prob, const void* picv, const void* dof,
                                void* prop, void* move, void* stream) {
  const ProposeArgs a{(const uint32_t*)kd, (const int*)sched, (uint32_t)t, init, W, wb, L,
                      nvar, nd, any_swap, (const int*)meta, (const float*)tab,
                      (int*)cur_val, (int*)cur_gidx, (float*)cur_prob, (int*)prp_val,
                      (int*)prp_gidx, (float*)prp_prob, (const int*)curr,
                      (const float*)prob, (const float*)picv, (const int*)dof,
                      (float*)prop, (int*)move};
  long long blocks = ((long long)W + kTile - 1) / kTile;
  const long long cap = (long long)kBlocksPerSm * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = (2 * (2 * (size_t)nvar + 2) + 1) * sizeof(int);
  mcmc_propose_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
