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
// One thread per walker, fields [.., W] with walkers block-major.  The TPU
// kernel's lattice-roll draws (power-of-two ninc) and threshold-count CDF
// (nbin <= 1024) were workarounds for a missing gather; here a map draw is
// a gather, and a Discrete draw a binary search of a CDF staged in shared
// memory (up to 1024 bins per leaf) or read from device memory (any size).
// Adjacency is an [nd, nd] table, so nd has no limit.
//
// What bounds it on the card: device-memory bytes, about 40 per walker per
// step on the main path (read curr, picv, dof and the touched slot; write
// the proposed slot, prop and move), and a handful of lowbias32 hashes; a
// FermiK draw adds two polynomial sin/cos evaluations.  Only the slots a
// walker's role touches are read or written.
//
// Built with --fmad=false (ops/_build.py); with the _rn intrinsics every
// rounding matches the plain torch version in ops/mcmc_kernels.py.

#include "mcmc_common.cuh"

namespace {

constexpr int kThreads = 256;

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

__global__ void mcmc_propose_kernel(
    const uint32_t* __restrict__ kd, const int* __restrict__ sched, uint32_t t,
    int init, int W, int wb, int L, int nvar, int nd, int any_swap,
    const int* __restrict__ meta, const float* __restrict__ tab,
    int* __restrict__ cur_val, int* __restrict__ cur_gidx,
    float* __restrict__ cur_prob, int* __restrict__ prp_val,
    int* __restrict__ prp_gidx, float* __restrict__ prp_prob,
    const int* __restrict__ curr, const float* __restrict__ prob,
    const float* __restrict__ picv, const int* __restrict__ dof,
    float* __restrict__ prop_out, int* __restrict__ move) {
  extern __shared__ float smem[];
  const int* leaf = meta;                          // [L, kFields]
  const int* grp = leaf + kFields * L;             // [nvar, 3]: dlo, dhi, maxdof
  const int* dof_tab = grp + 3 * nvar;             // [nd, nvar]
  const int* adj = dof_tab + nd * nvar;            // [nd, nd]
  const int norm = nd - 1;
  const int B = W / wb;
  stage_cdfs(leaf, L, kFields, tab, smem);

  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < W;
       w += gridDim.x * blockDim.x) {
    const uint32_t base = walker_base(kd, t, w, wb);
    int v[3], gidx;
    float pr;
    if (init) {
      if (!(prob[w] <= tiny())) continue;
      for (int d = 0; d < L; ++d) {
        const int* f = leaf + kFields * d;
        for (int s = 0; s < f[kNdraw]; ++s) {
          fresh_draw(f, tab, smem, base, kSaltInit + 4u * (uint32_t)(f[kSlot0] + s), v,
                     gidx, pr);
          put_slot(f, s, v, gidx, pr, cur_val, cur_gidx, cur_prob, W, w);
          put_slot(f, s, v, gidx, pr, prp_val, prp_gidx, prp_prob, W, w);
        }
      }
      continue;
    }

    // ---- role (pallas_mcmc.py:957-1015) ----
    const int code = sched[(long long)t * B + w / wb];
    const int jt = code >> 1;
    const int c = curr[w];
    const float pv = picv[w];
    const bool adjn = adj[c * nd + norm] != 0;
    const float qw = adjn ? __fmul_rn(pv, tab[nd]) : 0.0f;
    const float u_role = uniform(base, kSaltRole);
    const bool nj = adjn && u_role < qw;
    const bool at_jt = c == jt && u_role >= qw;
    const bool ci = adj[c * nd + jt] != 0 && u_role >= qw && u_role < __fadd_rn(qw, pv);
    const int vi = nvar > 1
        ? min((int)__fmul_rn(uniform(base, kSaltVi), (float)nvar), nvar - 1) : 0;
    const int dof_vi = dof[(long long)vi * W + w];
    const float dvf = (float)dof_vi;
    const int top = max(dof_vi - 1, 0);
    const int idx1 = min((int)__fmul_rn(uniform(base, kSaltS1), dvf), top);
    const bool can_move = at_jt && dof_vi > 0;
    int idx2 = 0;
    bool cv = can_move, sw = false;
    if (any_swap) {
      idx2 = min((int)__fmul_rn(uniform(base, kSaltS2), dvf), top);
      cv = can_move && !(code & 1);
      sw = can_move && (code & 1) && idx1 != idx2;
    }
    const int role = cv ? kRoleCv : sw ? kRoleSw : ci ? kRoleCi : nj ? kRoleNj : kRoleNone;

    // ---- proposal and Hastings factor (lines 1017-1114) ----
    float prop = 1.0f;
    if (role == kRoleCv) {
      for (int d = grp[3 * vi]; d < grp[3 * vi + 1]; ++d) {
        const int* f = leaf + kFields * d;
        if (f[kKind] == kFermiK) {
          const long long r = f[kVrow0] + (long long)idx1 * f[kWidth];
          float fv[3], uj[3];
          for (int q = 0; q < f[kWidth]; ++q) {
            fv[q] = __int_as_float(cur_val[(r + q) * W + w]);
            uj[q] = uniform(base, kSaltShift + 8u * d + 3u + q);
          }
          const float sp = fermik_shift(tab + f[kTab], f[kNb], fv,
                                        uniform(base, kSaltShift + 8u * d),
                                        uniform(base, kSaltShift + 8u * d + 1u),
                                        uniform(base, kSaltShift + 8u * d + 2u), uj);
          prop = __fmul_rn(prop, sp);
          for (int q = 0; q < f[kWidth]; ++q) prp_val[(r + q) * W + w] = __float_as_int(fv[q]);
        } else {
          fresh_draw(f, tab, smem, base, kSaltCv + 4u * d, v, gidx, pr);
          const float p_old = cur_prob[(long long)(f[kSlot0] + idx1) * W + w];
          prop = __fmul_rn(prop, __fdiv_rn(p_old, pr));
          put_slot(f, idx1, v, gidx, pr, prp_val, prp_gidx, prp_prob, W, w);
        }
      }
    } else if (role == kRoleSw) {
      for (int d = grp[3 * vi]; d < grp[3 * vi + 1]; ++d) {
        const int* f = leaf + kFields * d;
        for (int h = 0; h < 2; ++h) {
          const int to = h ? idx2 : idx1, from = h ? idx1 : idx2;
          const long long kt = f[kSlot0] + to, kf = f[kSlot0] + from;
          const long long rt = f[kVrow0] + (long long)to * f[kWidth];
          const long long rf = f[kVrow0] + (long long)from * f[kWidth];
          for (int q = 0; q < f[kWidth]; ++q)
            prp_val[(rt + q) * W + w] = cur_val[(rf + q) * W + w];
          prp_gidx[kt * W + w] = cur_gidx[kf * W + w];
          prp_prob[kt * W + w] = cur_prob[kf * W + w];
        }
      }
    } else if (role == kRoleCi) {
      for (int g = 0; g < nvar; ++g) {
        const int md = grp[3 * g + 2];
        const int dc = dof[(long long)g * W + w], dj = dof_tab[jt * nvar + g];
        for (int d = grp[3 * g]; md > 0 && d < grp[3 * g + 1]; ++d) {
          const int* f = leaf + kFields * d;
          for (int s = 0; s < md; ++s) {
            const int k = f[kSlot0] + s;
            if (s >= dc && s < dj) {                 // created
              fresh_draw(f, tab, smem, base, kSaltCi + 4u * (uint32_t)k, v, gidx, pr);
              if (f[kKind] == kFermiK)
                prop = pr > 0.0f ? __fdiv_rn(prop, fmaxf(pr, tiny())) : 0.0f;
              else
                prop = __fdiv_rn(prop, pr);
              put_slot(f, s, v, gidx, pr, prp_val, prp_gidx, prp_prob, W, w);
            } else if (s >= dj && s < dc) {          // removed
              prop = __fmul_rn(prop, old_density(f, tab, cur_val, cur_prob, k,
                                                 f[kVrow0] + s * f[kWidth], W, w));
            }
          }
        }
      }
    } else if (role == kRoleNj) {
      for (int g = 0; g < nvar; ++g) {
        const int dc = dof[(long long)g * W + w];
        for (int d = grp[3 * g]; d < grp[3 * g + 1]; ++d) {
          const int* f = leaf + kFields * d;
          for (int s = 0; s < dc; ++s)
            prop = __fmul_rn(prop, old_density(f, tab, cur_val, cur_prob, f[kSlot0] + s,
                                               f[kVrow0] + s * f[kWidth], W, w));
        }
      }
    }
    prop_out[w] = prop;
    move[w] = role;
    move[W + w] = vi;
    move[2 * W + w] = idx1;
    move[3 * W + w] = idx2;
  }
}

}  // namespace

extern "C" int mci_mcmc_propose(const void* kd, const void* sched, int t, int init,
                                int W, int wb, int L, int nvar, int nd,
                                int any_swap, const void* meta, const void* tab,
                                int smem_floats, void* cur_val, void* cur_gidx,
                                void* cur_prob, void* prp_val, void* prp_gidx,
                                void* prp_prob, const void* curr, const void* prob,
                                const void* picv, const void* dof, void* prop,
                                void* move, void* stream) {
  long long blocks = ((long long)W + kThreads - 1) / kThreads;
  const long long cap = 8LL * num_sms();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)smem_floats * sizeof(float);
  mcmc_propose_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, (const int*)sched, (uint32_t)t, init, W, wb, L, nvar, nd, any_swap, (const int*)meta, (const float*)tab, (int*)cur_val, (int*)cur_gidx,
      (float*)cur_prob, (int*)prp_val, (int*)prp_gidx, (float*)prp_prob,
      (const int*)curr, (const float*)prob, (const float*)picv, (const int*)dof,
      (float*)prop, (int*)move);
  return (int)cudaGetLastError();
}
