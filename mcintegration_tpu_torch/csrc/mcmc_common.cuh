// Helpers shared by mcmc_propose.cu and mcmc_accept.cu: the layout of the
// :mcmc meta table (ops/mcmc_kernels.py:McmcLayout) beyond the fields it
// shares with the chain kernels' (chain_common.cuh), the FermiK momentum
// shell of ops/fermik.py, and the sort of a tile's walkers by branch class
// that both kernels run.
//
// Every function computes the same float32 operations in the same order as
// its plain torch version, with _rn intrinsics under --fmad=false, so the
// two agree bit for bit.  Constants are written as (float)<double>, the
// double rounded once to float32, as numpy's float32(<double>) rounds them.
#pragma once

#include "chain_common.cuh"

namespace {

// leaf row fields (ops/mcmc_kernels.py:LEAF_FIELDS)
constexpr int kFields = 11;
constexpr int kSlot0 = 5, kVrow0 = 6, kWidth = 7, kHist = 8, kGroup = 9, kNdraw = 10;
constexpr int kFermiK = 2;
constexpr int kRoleNone = 0, kRoleCv = 1, kRoleSw = 2, kRoleCi = 3, kRoleNj = 4;
constexpr uint32_t kSaltRole = 1u, kSaltVi = 2u, kSaltS1 = 3u, kSaltS2 = 4u,
                   kSaltAccept = 5u;
constexpr uint32_t kSaltCv = 1u << 12, kSaltShift = 1u << 14, kSaltCi = 1u << 16,
                   kSaltInit = 1u << 20;
constexpr int kFkFields = 6;   // kF, 2 dk, jacobian constant, kF - dk, kF + dk, dk

#define F32(x) ((float)(x))
constexpr double kPi = 3.141592653589793;

__device__ __forceinline__ float tiny() { return F32(1e-38); }

// (sin(2 pi t), cos(2 pi t)): exact reduction to the nearest quarter turn,
// then cephes' single-precision polynomials (ops/fermik.py:sincos_turns).
__device__ __forceinline__ void sincos_turns(float t, float& sn, float& cs) {
  const float q = floorf(__fadd_rn(__fmul_rn(t, 4.0f), 0.5f));
  const float x = __fmul_rn(__fsub_rn(t, __fmul_rn(q, 0.25f)), F32(2.0 * kPi));
  const float z = __fmul_rn(x, x);
  float s = __fadd_rn(__fmul_rn(F32(-1.9515295891e-4), z), F32(8.3321608736e-3));
  s = __fadd_rn(__fmul_rn(s, z), F32(-1.6666654611e-1));
  s = __fmul_rn(s, z);
  s = __fadd_rn(__fmul_rn(s, x), x);
  float c = __fadd_rn(__fmul_rn(F32(2.443315711809948e-5), z), F32(-1.388731625493765e-3));
  c = __fadd_rn(__fmul_rn(c, z), F32(4.166664568298827e-2));
  c = __fmul_rn(__fmul_rn(c, z), z);
  c = __fadd_rn(__fsub_rn(c, __fmul_rn(z, 0.5f)), 1.0f);
  switch (((int)q) & 3) {
    case 0: sn = s; cs = c; break;
    case 1: sn = c; cs = -s; break;
    case 2: sn = -s; cs = -c; break;
    default: sn = -c; cs = s; break;
  }
}

// Fresh shell draw (ops/fermik.py:fermik_draw): v[dim], prob (0 if kamp <= 0).
__device__ __forceinline__ void fermik_draw(const float* k, int dim, float u0,
                                            float u1, float u2, float* v,
                                            float& prob) {
  const float kamp = __fadd_rn(__fmul_rn(__fsub_rn(u0, 0.5f), k[1]), k[0]);
  float sp, cp, jac;
  sincos_turns(u1, sp, cp);
  if (dim == 3) {
    float st, ct;
    sincos_turns(__fmul_rn(u2, 0.5f), st, ct);
    v[0] = __fmul_rn(__fmul_rn(kamp, cp), st);
    v[1] = __fmul_rn(__fmul_rn(kamp, sp), st);
    v[2] = __fmul_rn(kamp, ct);
    jac = __fmul_rn(__fmul_rn(__fmul_rn(st, k[2]), kamp), kamp);
  } else {
    v[0] = __fmul_rn(kamp, cp);
    v[1] = __fmul_rn(kamp, sp);
    jac = __fmul_rn(kamp, k[2]);
  }
  prob = kamp <= 0.0f ? 0.0f : __fdiv_rn(1.0f, fmaxf(jac, F32(1e-30)));
}

__device__ __forceinline__ float fermik_norm(const float* v, int dim) {
  float k2 = __fmul_rn(v[0], v[0]);
  for (int c = 1; c < dim; ++c) k2 = __fadd_rn(k2, __fmul_rn(v[c], v[c]));
  return __fsqrt_rn(k2);
}

// Shell density of a stored value (ops/fermik.py:fermik_density).
__device__ __forceinline__ float fermik_density(const float* k, int dim,
                                                const float* v) {
  const float kamp = fermik_norm(v, dim);
  bool ok = (kamp > k[3]) && (kamp < k[4]);
  float jac;
  if (dim == 3) {
    const float rho = __fsqrt_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])));
    const float sin_t = __fdiv_rn(rho, fmaxf(kamp, F32(1e-30)));
    ok = ok && (sin_t >= F32(1e-15));
    jac = __fmul_rn(__fmul_rn(__fmul_rn(sin_t, k[2]), kamp), kamp);
  } else {
    jac = __fmul_rn(kamp, k[2]);
  }
  return ok ? __fdiv_rn(1.0f, fmaxf(jac, F32(1e-30))) : 0.0f;
}

// Three-way changeVariable move (ops/fermik.py:fermik_shift), in place on
// v[dim]; returns the Hastings factor.
__device__ __forceinline__ float fermik_shift(const float* k, int dim, float* v,
                                              float sel, float u1, float u2,
                                              const float* uj) {
  const float ratio = __fadd_rn(__fmul_rn(u1, F32(1.5 - 1.0 / 1.5)), F32(1.0 / 1.5));
  if (sel < F32(1.0 / 3.0)) {                       // radial scale
    for (int c = 0; c < dim; ++c) v[c] = __fmul_rn(v[c], ratio);
    return dim == 3 ? ratio : 1.0f;
  }
  if (sel < F32(2.0 / 3.0)) {                       // re-orientation at |K|
    const float kamp = fermik_norm(v, dim);
    float sp, cp;
    sincos_turns(u1, sp, cp);
    if (dim == 3) {
      const float ct = fminf(fmaxf(__fsub_rn(1.0f, __fmul_rn(u2, 2.0f)), -1.0f), 1.0f);
      const float st = __fsqrt_rn(fmaxf(__fsub_rn(1.0f, __fmul_rn(ct, ct)), 0.0f));
      v[0] = __fmul_rn(__fmul_rn(kamp, cp), st);
      v[1] = __fmul_rn(__fmul_rn(kamp, sp), st);
      v[2] = __fmul_rn(kamp, ct);
    } else {
      v[0] = __fmul_rn(kamp, cp);
      v[1] = __fmul_rn(kamp, sp);
    }
    return 1.0f;
  }
  for (int c = 0; c < dim; ++c)                     // component jitter
    v[c] = __fadd_rn(v[c], __fmul_rn(__fsub_rn(uj[c], 0.5f), k[5]));
  return 1.0f;
}

// Leaf f's fresh draw from uniforms salt + c: value rows v[width] as bits,
// gidx, prob.
__device__ __forceinline__ void fresh_draw(const int* f, const float* tab, uint32_t base,
                                           uint32_t salt, int* v, int& gidx,
                                           float& prob) {
  if (f[kKind] == kFermiK) {
    const int dim = f[kNb];
    const float u0 = uniform(base, salt), u1 = uniform(base, salt + 1u);
    const float u2 = dim == 3 ? uniform(base, salt + 2u) : u1;
    float fv[3];
    fermik_draw(tab + f[kTab], dim, u0, u1, u2, fv, prob);
    for (int c = 0; c < dim; ++c) v[c] = __float_as_int(fv[c]);
    gidx = 0;
    return;
  }
  map_draw(f, tab, nullptr, uniform(base, salt), v[0], gidx, prob);
}

// The removal density of slot k (value row r) of leaf f in the current
// state: its stored prob, or the FermiK shell density of its value.
__device__ __forceinline__ float old_density(const int* f, const float* tab,
                                             const int* cur_val,
                                             const float* cur_prob, int k,
                                             int r, int W, int w) {
  if (f[kKind] != kFermiK) return cur_prob[(long long)k * W + w];
  float v[3];
  for (int c = 0; c < f[kWidth]; ++c)
    v[c] = __int_as_float(cur_val[(long long)(r + c) * W + w]);
  return fermik_density(tab + f[kTab], f[kNb], v);
}

// The meta table's parts (ops/mcmc_kernels.py:McmcLayout).
struct Tables {
  const int* leaf;      // [L, kFields]
  const int* grp;       // [nvar, 3]: dlo, dhi, maxdof
  const int* dof_tab;   // [nd, nvar]
  const int* adj;       // [nd, nd]
};

__device__ __forceinline__ Tables tables(const int* meta, int L, int nvar, int nd) {
  Tables T;
  T.leaf = meta;
  T.grp = T.leaf + kFields * L;
  T.dof_tab = T.grp + 3 * nvar;
  T.adj = T.dof_tab + nd * nvar;
  return T;
}

// The branch class of a walker with a role, by which the kernels sort a
// tile's walkers: CV of var group vi, SW of var group vi, CI, NJ (2*nvar + 2
// classes).
__device__ __forceinline__ int branch_class(int role, int vi, int nvar) {
  return role == kRoleCv ? vi : role == kRoleSw ? nvar + vi
       : role == kRoleCi ? 2 * nvar : 2 * nvar + 1;
}

// Sorts a tile's walkers with a role by branch class.  key[q] is the class
// of the thread's walker q (-1: none), at tile index q * blockDim.x +
// threadIdx.x.  The lanes of a warp with the same class take one shared
// atomic between them, through their first lane, and their places in
// lane order.  Writes the tile indices into list in class order and returns
// their number.  ccnt [K] (zero on entry and on return) and coff [K + 1]
// are shared.  Every thread of the block calls it.
template <int kW>
__device__ __forceinline__ int sort_tile(const int (&key)[kW], int* ccnt, int* coff,
                                         int* list, int K) {
  const int lane = threadIdx.x & 31;
  int pos[kW];
  for (int q = 0; q < kW; ++q) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[q]);
    const int first = __ffs(peers) - 1;
    int base = 0;
    if (key[q] >= 0 && lane == first) base = atomicAdd(ccnt + key[q], __popc(peers));
    pos[q] = __shfl_sync(0xffffffffu, base, first) + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int k = 0; k < K; ++k) {
      coff[k] = n;
      n += ccnt[k];
      ccnt[k] = 0;
    }
    coff[K] = n;
  }
  __syncthreads();
  for (int q = 0; q < kW; ++q)
    if (key[q] >= 0) list[coff[key[q]] + pos[q]] = q * blockDim.x + threadIdx.x;
  __syncthreads();
  return coff[K];
}

}  // namespace
