// vegas_reduce: the observable sums and training histogram of the :vegas solver,
// and vegas_relw: the per-sample relative weights a custom measure reads.
//
// Replaces the reduction half of mcintegration_tpu/ops/pallas_vegas.py:
// build_run_all (lines 454-532), custom-measure branch (lines 488-503)
// included.  For each stratum row r = (block b, chunk t, stratum p) of m
// samples it computes, in the kernel's float32 order:
//   jac      = prod_k invp_k                              (:431-433)
//   factor_i = jac * prod over padded (group, slot) pairs of
//              prod over the group's leaves of 1/invp     (:434-441, :471-478)
//   obs_rows[r, i] = sum_q w_i * factor_i                 (float64 sum)
//   whsum_i  = sum_q min(|w_i| * jac, 1e17)^2             (:507, float64 sum)
//   hrow[k, b, t, perm_k[p]] = sum_{i used by slot k} whsum_i
// With a custom measure, vegas_relw first writes relw_i = w_i * factor_i
// per sample (the same float32 product), the user's measure runs as torch
// ops on the samples and relw, and vegas_reduce is given its output
// m [ncomp, B, T, nb, m]: then obs_rows[r, k] = sum_q m_k (float64, in the
// same column order, so the identity measure m_0 = relw_0 gives the default
// sums bit for bit), and the histogram still comes from w and jac.
// The JAX kernel also masks the strata rows that pad a chunk up to its L x L
// square (rowmask, :394 and :501); the port draws no padded rows.
// Both kernels guard each w they load: a non-finite value is read as 0 (a
// complex one with a non-finite part as 0 + 0i; real.cuh: finite_or_zero),
// the reference's guard of the integrand's output (mcintegration_tpu/
// solvers/engine.py:260-273), so the integrand's output reaches them as it
// comes; m, a measure's output, is summed as it comes.
//
// Two branches serve the reference's XLA route (mcintegration_tpu/solvers/
// vegas.py:201-357), which K1 never runs:
// - complex weights (kCplx): w is complex64 [N, B, T, nb, m], read as
//   interleaved (re, im) pairs; the default observables are Re and Im of
//   w_i * factor_i in components 2i and 2i+1, and the histogram term is
//   min(|w_i| * jac, 1e17)^2 with |w| = sqrt(re*re + im*im) (sqrt(fl(x*x)) =
//   |x|, so w + 0i gives the real run's bits); given m, w feeds the
//   histogram only and m stays real.  A complex "quad" is four samples (two
//   16-byte loads), so a lane adds the same samples in the same order as the
//   real kernel and the real parts of f + 0i are the real sums bit for bit.
//   vegas_relw's complex entry reads a sample's (re, im) pair at once, for
//   the guard, and scales each part alone.
// - measurefreq = mf > 1 (kMask): sample j of stratum row p of chunk t (t0
//   plus the chunk's index in the launch) counts in the observable sums, of
//   w or of m, only if (t*nb*m + p*m + j + 1) % mf == 0 (vegas.py:327-335);
//   the others add a zero there.  The histogram takes every sample.
// The permutation is a bijection of the strata, so each histogram bin of a
// (slot, block, chunk) is written by exactly one thread: no atomics.
// The kernel writes per-row partials obs_rows [B, T, nb, ncomp], not per-(b, t)
// sums: the wrapper's torch sum over p (giving obs [B, T, ncomp]) is the first
// step of the fixed-order float64 reduction, and the solver then sums
// chunks, blocks and slots in a fixed order, so a fixed seed reproduces a run
// bit for bit.  This replaces the TPU kernel's Kahan carry in SMEM across the
// in-order grid.
//
// What bounds it on the card: device-memory bytes, one 4-byte load of w per
// (integrand, sample), and of m per (component, sample) with a custom
// measure; the outputs are one double per row and column.  A row holds only
// m = 1024 floats (4 KB) a column at the main paths' shapes, so what keeps
// the card from its memory rate is the latency a row's loads wait out, not
// the arithmetic.  The design keeps many columns' loads in flight at once:
// - a column (one row of w_i or of m_k) is a unit of work for a group of
//   G lanes of a warp (G = 32 at m = 1024, fewer for short rows, so a warp
//   serves 32/G units side by side); each lane loads up to kUnroll quads of
//   the column (16-byte loads where m % 4 == 0 and the tensors are aligned,
//   scalar loads otherwise) before it adds any, and the group adds its
//   lanes' sums with shuffles: no __syncthreads between columns;
// - a block takes a tile of rows (eight at m = 1024), every (row, column)
//   unit of the tile spread over its warps: one block per tile, so a block
//   has a tile's columns to read, not one row's (a persistent grid that
//   walks the tiles measured no faster: PERF.md);
// - jac and factor_i are formed by the lanes of the unit that reads w_i,
//   after its loads have gone out; the m columns need neither;
// - whsum_i of a tile's rows meets in shared memory, where the threads of
//   the block then form the tile's histogram bins: one barrier a tile, not
//   two a column.  (At N = 1 the unit of w_0 could write its row's bins
//   itself, with no barrier; measured, that is no faster: PERF.md.)
// vegas_relw reads w and writes relw: 8 bytes per (integrand, sample).
//
// Summation order: lane l of a group adds quads l, l + G, l + 2G, ... of its
// column (quad j: elements 4j..4j+3, in order) and the group then adds its
// lanes' sums in a butterfly.  The order depends on m alone, the same in
// both modes and from run to run.
//
// float64 (integrate(dtype=torch.float64), the _f64 entry points): the same
// bodies with invp, jac and factor_i in double (__dmul_rn, __ddiv_rn), and
// real w, relw and m in double too; the reference's float64 law
// (mcintegration_tpu/solvers/vegas.py:300-356 under x64).  Complex w stays
// complex64 (mcintegration_tpu/main.py:341): relw_i = w_i * float(factor_i),
// the factor rounded to float32 as the reference casts it to the weights'
// dtype (solvers/vegas.py:324), and the histogram term is min(float64(|w_i|)
// * jac, 1e17)^2 in double, as jnp.abs(w) * jac promotes there; given m, a
// complex run's m stays float32.  A quad of doubles comes in two 16-byte
// loads; the float64 bodies may take 80 registers a thread (3 blocks an SM).

#include "real.cuh"

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
// at most 64 registers a thread (4 blocks an SM); the float64 bodies 80
template <typename Fp> constexpr int blocks_per_sm() { return sizeof(Fp) == 4 ? 4 : 3; }
constexpr int kUnroll = 4;                    // quads a lane loads before adding
constexpr int kSmemDoubles = 2048;            // whsum of a tile's rows: at most 16 KB

template <typename Fp>
__device__ __forceinline__ Fp row_jac(const Fp* __restrict__ invp, int nslots,
                                      long long R, long long r) {
  Fp jac = invp[r];
  for (int k = 1; k < nslots; ++k) jac = mul_rn(jac, invp[k * R + r]);
  return jac;
}

// factor_i of row r, in the plain version's order.
template <typename Fp>
__device__ __forceinline__ Fp integrand_factor(Fp jac, const Fp* __restrict__ invp,
                                               const int32_t* __restrict__ pad,
                                               const int32_t* __restrict__ pair_slots,
                                               int i, int npair, int maxmem,
                                               long long R, long long r) {
  Fp f = jac;
  for (int g = 0; g < npair; ++g) {
    if (!pad[i * npair + g]) continue;
    Fp gp = div_rn((Fp)1, invp[pair_slots[g * maxmem] * R + r]);
    for (int mm = 1; mm < maxmem; ++mm) {
      const int k = pair_slots[g * maxmem + mm];
      if (k < 0) break;
      gp = mul_rn(gp, div_rn((Fp)1, invp[k * R + r]));
    }
    f = mul_rn(f, gp);
  }
  return f;
}

// Quad j of a column of m floats (elements past m left 0).
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ col, int j, int m) {
  if (kVec) return __ldcs(reinterpret_cast<const float4*>(col) + j);   // read once: streaming
  const int q = 4 * j;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = col[q];
  if (q + 1 < m) v.y = col[q + 1];
  if (q + 2 < m) v.z = col[q + 2];
  if (q + 3 < m) v.w = col[q + 3];
  return v;
}

// Quad j of a column of m doubles: two 16-byte loads
struct DQuad {
  double x, y, z, w;
};

template <bool kVec>
__device__ __forceinline__ DQuad load_quad(const double* __restrict__ col, int j, int m) {
  if (kVec) {                                 // read once: streaming
    const double2* p = reinterpret_cast<const double2*>(col) + 2 * j;
    const double2 a = __ldcs(p), b = __ldcs(p + 1);
    return DQuad{a.x, a.y, b.x, b.y};
  }
  const int q = 4 * j;
  DQuad v = {0.0, 0.0, 0.0, 0.0};
  v.x = col[q];
  if (q + 1 < m) v.y = col[q + 1];
  if (q + 2 < m) v.z = col[q + 2];
  if (q + 3 < m) v.w = col[q + 3];
  return v;
}

template <typename E> struct QuadOf { using type = float4; };
template <> struct QuadOf<double> { using type = DQuad; };

// Quad j of a complex column of m samples: samples 4j..4j+3 as (re, im)
// pairs, lo the first two, hi the last two (samples past m left 0).
struct CQuad {
  float4 lo, hi;
};

template <bool kVec>
__device__ __forceinline__ CQuad load_cquad(const float* __restrict__ col, int j, int m) {
  CQuad c;
  if (kVec) {                                 // read once: streaming
    const float4* p = reinterpret_cast<const float4*>(col) + 2 * j;
    c.lo = __ldcs(p);
    c.hi = __ldcs(p + 1);
    return c;
  }
  const float2* z = reinterpret_cast<const float2*>(col);
  const int q = 4 * j;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 a = z[q], b = q + 1 < m ? z[q + 1] : zero;
  const float2 d = q + 2 < m ? z[q + 2] : zero, e = q + 3 < m ? z[q + 3] : zero;
  c.lo = make_float4(a.x, a.y, b.x, b.y);
  c.hi = make_float4(d.x, d.y, e.x, e.y);
  return c;
}

// What a unit adds per sample: kObs the column's values (an m column),
// kWeighted w * factor and the histogram term (w in the default mode),
// kHist the histogram term alone (w beside a measure).  v and f are of the
// column's type V, jac of the tables' J (a complex float64 run: float and
// double).
enum Terms { kObs, kWeighted, kHist };

template <int kTerms, typename V, typename J>
__device__ __forceinline__ void add_value(V v, V f, J jac, double& so, double& sh) {
  if (kTerms == kObs) {
    so += (double)v;
    return;
  }
  if (kTerms == kWeighted) so += (double)mul_rn(v, f);
  J a = mul_rn((J)abs_of(v), jac);
  a = a > (J)1e17 ? (J)1e17 : a;   // NaN passes through, as torch.clamp
  sh += (double)mul_rn(a, a);
}

// The measurement gate of sample e of a row: with kMask, a sample whose
// index in its block, rem + e modulo mf, is not 0 adds a zero to the
// observable sums (v of an m column, or w * f with f = 0), and its
// histogram term as always.
struct Gate {
  unsigned rem, mf;                           // (the row's first index) % mf, and mf
  __device__ __forceinline__ bool shut(int e) const { return (rem + (unsigned)e) % mf != 0u; }
};

template <int kTerms, bool kMask, typename V, typename J>
__device__ __forceinline__ void add_sample(V v, int e, const Gate& g, V f, J jac,
                                           double& so, double& sh) {
  if (kTerms != kObs) v = finite_or_zero(v);   // a w column: the guard
  if (kMask && g.shut(e)) {
    if (kTerms == kObs) v = (V)0;
    f = (V)0;
  }
  add_value<kTerms>(v, f, jac, so, sh);
}

// Add the quads j0, j0 + G, ... (kUnroll of them, those below nq) in order.
template <bool kVec, int kTerms, bool kMask, typename Q, typename V, typename J>
__device__ __forceinline__ void add_batch(const Q (&v)[kUnroll], int j0, int G, int nq,
                                          int m, const Gate& g, V f, J jac,
                                          double& so, double& sh) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = j0 + k * G;
    if (j >= nq) break;
    const int q = 4 * j;
    add_sample<kTerms, kMask>(v[k].x, q, g, f, jac, so, sh);
    if (kVec || q + 1 < m) add_sample<kTerms, kMask>(v[k].y, q + 1, g, f, jac, so, sh);
    if (kVec || q + 2 < m) add_sample<kTerms, kMask>(v[k].z, q + 2, g, f, jac, so, sh);
    if (kVec || q + 3 < m) add_sample<kTerms, kMask>(v[k].w, q + 3, g, f, jac, so, sh);
  }
}

// A complex sample (re, im), 0 + 0i unless both parts are finite (the
// guard): kWeighted adds Re and Im of w * f into so and si (a zero where
// the gate is shut), and both modes add the histogram term of |w|, as the
// real kernel adds that of |v|.
template <int kTerms, bool kMask, typename J>
__device__ __forceinline__ void add_csample(float re, float im, int e, const Gate& g, float f,
                                            J jac, double& so, double& si, double& sh) {
  if (!(is_finite(re) && is_finite(im))) re = im = 0.0f;
  if (kTerms == kWeighted) {
    const float fe = kMask && g.shut(e) ? 0.0f : f;
    so += (double)__fmul_rn(re, fe);
    si += (double)__fmul_rn(im, fe);
  }
  add_value<kHist>(__fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))), f, jac, so, sh);
}

// A complex column's unit: the quads j0 = lg, lg + G, ... (four samples
// each, added in the real kernel's order), kCUnroll in flight.
constexpr int kCUnroll = 2;

template <bool kVec, int kTerms, bool kMask, typename J>
__device__ __forceinline__ void add_ccolumn(const float* __restrict__ src, int lg, int G, int nq,
                                            int m, const Gate& g, float f, J jac,
                                            double& so, double& si, double& sh) {
  for (int j0 = lg; j0 < nq; j0 += kCUnroll * G) {
    CQuad v[kCUnroll];
#pragma unroll
    for (int k = 0; k < kCUnroll; ++k) {
      const int j = j0 + k * G;
      if (j < nq) v[k] = load_cquad<kVec>(src, j, m);
    }
#pragma unroll
    for (int k = 0; k < kCUnroll; ++k) {
      const int j = j0 + k * G;
      if (j >= nq) break;
      const int q = 4 * j;
      add_csample<kTerms, kMask>(v[k].lo.x, v[k].lo.y, q, g, f, jac, so, si, sh);
      if (kVec || q + 1 < m)
        add_csample<kTerms, kMask>(v[k].lo.z, v[k].lo.w, q + 1, g, f, jac, so, si, sh);
      if (kVec || q + 2 < m)
        add_csample<kTerms, kMask>(v[k].hi.x, v[k].hi.y, q + 2, g, f, jac, so, si, sh);
      if (kVec || q + 3 < m)
        add_csample<kTerms, kMask>(v[k].hi.z, v[k].hi.w, q + 3, g, f, jac, so, si, sh);
    }
  }
}

// shared memory: whsum [RT, N] double.
// A tile is RT rows; its units are (row, column) pairs, row-fastest, with
// columns 0..N-1 the integrands' w and, given m, N..N+ncomp-1 its components.
// kCplx: w complex (the default observables of w_i in components 2i, 2i+1);
// kMask: the gate of measurefreq mf, the chunks t0..t0+T-1 of each block.
// Fp: the type of invp, jac and factor_i; E = elem_t<kCplx, Fp>, of w's
// and m's elements.
template <typename Fp, bool kVec, bool kCplx, bool kMask>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<Fp>())
vegas_reduce_kernel(const elem_t<kCplx, Fp>* __restrict__ w, const Fp* __restrict__ invp,
                    const int32_t* __restrict__ perm, const int32_t* __restrict__ pad,
                    const int32_t* __restrict__ pair_slots, const int32_t* __restrict__ used,
                    int N, int nslots, int npair, int maxmem, long long R, int nb, int m,
                    const elem_t<kCplx, Fp>* __restrict__ mobs, int ncomp, int G, int RT, int mf,
                    int t0, int T, double* __restrict__ obs_rows, double* __restrict__ hrow) {
  using E = elem_t<kCplx, Fp>;
  extern __shared__ double whsum[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lg = lane & (G - 1);               // lane in its group
  const int per_warp = 32 / G;                 // units a warp serves side by side
  const int unit_in_warp = lane / G;
  const int nq = (m + 3) >> 2;
  const int ncol = mobs ? N + ncomp : N;
  const long long r0 = (long long)blockIdx.x * RT;
  const int rows = (int)(R - r0 < RT ? R - r0 : RT);
  const int p0 = (int)(r0 % nb);               // the stratum of row r0
  const int nunits = rows * ncol;
  for (int ub = warp * per_warp; ub < nunits; ub += kWarps * per_warp) {   // warp-uniform
    const int u = ub + unit_in_warp;
    const bool ok = u < nunits;
    const int row = ok ? u % rows : 0, col = ok ? u / rows : 0;
    const long long r = r0 + row;
    const bool wcol = col < N;
    const int terms = !wcol ? kObs : mobs ? kHist : kWeighted;
    const E* src = wcol ? w + ((long long)col * R + r) * m * (kCplx ? 2 : 1)
                        : mobs + ((long long)(col - N) * R + r) * m;
    Gate g = {0u, 1u};
    if (kMask) {   // the row's first sample: index (t0 + t)*nb*m + p*m + 1 in its block
      const long long t = t0 + (r / nb) % T;
      g = {(unsigned)(((t * nb + r % nb) * m + 1) % mf), (unsigned)mf};
    }
    double so = 0.0, sh = 0.0, si = 0.0;
    if (ok && kCplx && wcol) {
      const Fp jac = row_jac(invp, nslots, R, r);
      if (terms == kWeighted) {
        // the factor rounded to the weights' float32 (a no-op at Fp = float)
        const float f = (float)integrand_factor(jac, invp, pad, pair_slots, col, npair, maxmem,
                                                R, r);
        add_ccolumn<kVec, kWeighted, kMask>((const float*)src, lg, G, nq, m, g, f, jac, so,
                                            si, sh);
      } else {
        add_ccolumn<kVec, kHist, kMask>((const float*)src, lg, G, nq, m, g, 0.0f, jac, so, si,
                                        sh);
      }
    } else if (ok) {
      // E = Fp unless kCplx, where this branch reads only m's columns
      E jac = (E)0, f = (E)0;
      for (int j0 = lg; j0 < nq; j0 += kUnroll * G) {
        typename QuadOf<E>::type v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = j0 + k * G;
          if (j < nq) v[k] = load_quad<kVec>(src, j, m);
        }
        if (j0 == lg && wcol) {   // the factors, while the first loads are out
          jac = (E)row_jac(invp, nslots, R, r);
          if (terms == kWeighted)
            f = (E)integrand_factor((Fp)jac, invp, pad, pair_slots, col, npair, maxmem, R, r);
        }
        if (terms == kObs)
          add_batch<kVec, kObs, kMask>(v, j0, G, nq, m, g, f, jac, so, sh);
        else if (terms == kWeighted)
          add_batch<kVec, kWeighted, kMask>(v, j0, G, nq, m, g, f, jac, so, sh);
        else
          add_batch<kVec, kHist, kMask>(v, j0, G, nq, m, g, f, jac, so, sh);
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {   // the group's butterfly
      so += __shfl_xor_sync(0xffffffffu, so, o);
      sh += __shfl_xor_sync(0xffffffffu, sh, o);
      if (kCplx) si += __shfl_xor_sync(0xffffffffu, si, o);
    }
    if (!ok) continue;
    if (kCplx && wcol && lg == 0 && terms != kHist) {   // Re and Im of integrand col
      obs_rows[r * ncomp + 2 * col] = so;
      obs_rows[r * ncomp + 2 * col + 1] = si;
    } else if (lg == 0 && terms != kHist) {
      obs_rows[r * ncomp + (wcol ? col : col - N)] = so;
    }
    if (wcol && lg == 0) whsum[row * N + col] = sh;
  }
  __syncthreads();   // each (row, slot) bin from the tile's whsum
  for (int e = threadIdx.x; e < rows * nslots; e += kThreads) {
    const int row = e % rows, k = e / rows;
    const long long r = r0 + row;
    double h = 0.0;
    for (int i = 0; i < N; ++i)
      if (used[k * N + i]) h += whsum[row * N + i];
    hrow[k * R + (r - (p0 + row) % nb) + perm[k * R + r]] = h;
  }
}

// jac of stratum row r, returned to every thread, and factor_i into
// factor[i] in shared memory as E (rounded to float32 beside a complex64
// w), in the plain version's order.
template <typename Fp, typename E>
__device__ __forceinline__ Fp row_factors(const Fp* __restrict__ invp,
                                          const int32_t* __restrict__ pad,
                                          const int32_t* __restrict__ pair_slots,
                                          int N, int nslots, int npair, int maxmem,
                                          long long R, long long r, E* factor) {
  const Fp jac = row_jac(invp, nslots, R, r);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    factor[i] = (E)integrand_factor(jac, invp, pad, pair_slots, i, npair, maxmem, R, r);
  __syncthreads();
  return jac;
}

// shared memory: factor [N] of E = elem_t<kCplx, Fp>, the element of w and
// relw (a complex sample: an (re, im) pair of E, read and written at once)
template <typename Fp, bool kCplx>
__global__ void vegas_relw_kernel(const elem_t<kCplx, Fp>* __restrict__ w,
                                  const Fp* __restrict__ invp,
                                  const int32_t* __restrict__ pad,
                                  const int32_t* __restrict__ pair_slots,
                                  int N, int nslots, int npair, int maxmem,
                                  long long R, int m, elem_t<kCplx, Fp>* __restrict__ relw) {
  using E = elem_t<kCplx, Fp>;
  extern __shared__ __align__(8) unsigned char factor_bytes[];
  E* factor = reinterpret_cast<E*>(factor_bytes);
  const long long r = blockIdx.x;
  row_factors(invp, pad, pair_slots, N, nslots, npair, maxmem, R, r, factor);
  for (int i = 0; i < N; ++i) {
    const long long base = ((long long)i * R + r) * m;
    const E f = factor[i];
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      if constexpr (kCplx) {
        float2 z = reinterpret_cast<const float2*>(w)[base + q];
        if (!(is_finite(z.x) && is_finite(z.y))) z = make_float2(0.0f, 0.0f);
        reinterpret_cast<float2*>(relw)[base + q] = make_float2(mul_rn(z.x, f), mul_rn(z.y, f));
      } else {
        relw[base + q] = mul_rn(finite_or_zero(w[base + q]), f);
      }
    }
  }
}

int row_threads(int m) {
  int threads = 32;
  while (threads < m && threads < 256) threads *= 2;
  return threads;
}

// Lanes a column gets: the most, up to a warp, that leave each lane at
// least four quads (m = 1024: 32 lanes, eight quads each; m <= 28: one lane).
int group_lanes(int m) {
  const int nq = (m + 3) / 4;
  int g = 1;
  while (g < 32 && 8 * g <= nq) g *= 2;
  return g;
}

template <typename Fp, bool kVec, bool kCplx, bool kMask>
cudaError_t launch_reduce(const elem_t<kCplx, Fp>* w, const Fp* invp, const int32_t* perm,
                          const int32_t* pad, const int32_t* pair_slots, const int32_t* used,
                          int N, int nslots, int npair, int maxmem, long long R, int nb, int m,
                          const elem_t<kCplx, Fp>* mobs, int ncomp, int mf, int t0, int T,
                          double* obs_rows, double* hrow, cudaStream_t stream) {
  const int G = group_lanes(m);
  int RT = kWarps * (32 / G);                   // a row per group at one column
  if (RT * N > kSmemDoubles) RT = kSmemDoubles / N > 1 ? kSmemDoubles / N : 1;
  const size_t smem = (size_t)RT * N * sizeof(double);
  const long long ntiles = (R + RT - 1) / RT;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  vegas_reduce_kernel<Fp, kVec, kCplx, kMask><<<(unsigned)ntiles, kThreads, smem, stream>>>(
      w, invp, perm, pad, pair_slots, used, N, nslots, npair, maxmem, R, nb, m, mobs,
      mobs ? ncomp : (kCplx ? 2 * N : N), G, RT, mf, t0, T, obs_rows, hrow);
  return cudaGetLastError();
}

template <typename Fp, bool kCplx>
int reduce_entry(const void* w, const void* invp, const void* perm, const void* pad,
                 const void* pair_slots, const void* used, int N, int nslots, int npair,
                 int maxmem, long long R, int nb, int m, const void* mobs, int ncomp, int mf,
                 int t0, int T, void* obs_rows, void* hrow, void* stream) {
  if (N < 1 || nslots < 1 || R < 1 || nb < 1 || m < 1 || (mobs && ncomp < 1) || mf < 1 ||
      t0 < 0 || T < 1 || R % ((long long)nb * T) != 0)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: every row starts on a quad when m % 4 == 0
  const bool vec = m % 4 == 0 && (uintptr_t)w % 16 == 0 && (uintptr_t)mobs % 16 == 0;
  // the gate's kernel only where mf > 1: the mf = 1 kernels are the ungated ones
  using E = elem_t<kCplx, Fp>;
  auto run = launch_reduce<Fp, false, kCplx, false>;
  if (vec)
    run = mf > 1 ? launch_reduce<Fp, true, kCplx, true> : launch_reduce<Fp, true, kCplx, false>;
  else if (mf > 1) run = launch_reduce<Fp, false, kCplx, true>;
  return (int)run((const E*)w, (const Fp*)invp, (const int32_t*)perm,
                  (const int32_t*)pad, (const int32_t*)pair_slots, (const int32_t*)used,
                  N, nslots, npair, maxmem, R, nb, m, (const E*)mobs, ncomp, mf, t0, T,
                  (double*)obs_rows, (double*)hrow, (cudaStream_t)stream);
}

// relw of rows of m samples (a complex sample: two floats)
template <typename Fp, bool kCplx>
int relw_entry(const void* w, const void* invp, const void* pad, const void* pair_slots,
               int N, int nslots, int npair, int maxmem, long long R, int m, void* relw,
               void* stream) {
  using E = elem_t<kCplx, Fp>;
  vegas_relw_kernel<Fp, kCplx><<<(unsigned)R, row_threads(m), (size_t)N * sizeof(E),
                                 (cudaStream_t)stream>>>(
      (const E*)w, (const Fp*)invp, (const int32_t*)pad, (const int32_t*)pair_slots, N, nslots,
      npair, maxmem, R, m, (E*)relw);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCI_VEGAS_REDUCE(name, Fp, kCplx)                                                  \
  extern "C" int name(const void* w, const void* invp, const void* perm, const void* pad,   \
                      const void* pair_slots, const void* used, int N, int nslots, int npair, \
                      int maxmem, long long R, int nb, int m, const void* mobs, int ncomp,   \
                      int mf, int t0, int T, void* obs_rows, void* hrow, void* stream) {     \
    return reduce_entry<Fp, kCplx>(w, invp, perm, pad, pair_slots, used, N, nslots, npair,  \
                                   maxmem, R, nb, m, mobs, ncomp, mf, t0, T, obs_rows, hrow, \
                                   stream);                                                   \
  }

MCI_VEGAS_REDUCE(mci_vegas_reduce, float, false)
// w complex64 [N, B, T, nb, m], read as interleaved (re, im) float pairs
MCI_VEGAS_REDUCE(mci_vegas_reduce_complex, float, true)
// invp float64; real w and m float64, complex w complex64 (m float32)
MCI_VEGAS_REDUCE(mci_vegas_reduce_f64, double, false)
MCI_VEGAS_REDUCE(mci_vegas_reduce_complex_f64, double, true)
#undef MCI_VEGAS_REDUCE

#define MCI_VEGAS_RELW(name, Fp, kCplx)                                                    \
  extern "C" int name(const void* w, const void* invp, const void* pad,                      \
                      const void* pair_slots, int N, int nslots, int npair, int maxmem,      \
                      long long R, int m, void* relw, void* stream) {                        \
    return relw_entry<Fp, kCplx>(w, invp, pad, pair_slots, N, nslots, npair, maxmem, R, m,   \
                                 relw, stream);                                              \
  }

MCI_VEGAS_RELW(mci_vegas_relw, float, false)
// complex64 w and relw: each part scaled alone by the real factor
MCI_VEGAS_RELW(mci_vegas_relw_complex, float, true)
// invp, w and relw float64
MCI_VEGAS_RELW(mci_vegas_relw_f64, double, false)
// invp float64, w and relw complex64: the factor rounded to float32
MCI_VEGAS_RELW(mci_vegas_relw_complex_f64, double, true)
#undef MCI_VEGAS_RELW
