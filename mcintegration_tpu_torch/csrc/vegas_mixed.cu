// vegas_sample_mixed, vegas_reduce_mixed and vegas_relw_mixed: the :vegas
// solver on Discrete pools and on pools of different ninc.
//
// These extend the port of mcintegration_tpu/ops/pallas_vegas.py:
// build_run_all (K1) to the reference's XLA route, which serves what K1
// refuses (pallas_vegas.py:323-328): Discrete pools and drawn Continuous
// pools whose ninc differ (mcintegration_tpu/solvers/vegas.py:82-127,
// 218-262, 292-356).  The uniform route's kernels, vegas_sample.cu and
// vegas_reduce.cu, stay as they are.
//
// The plan (solvers/vegas.py:mixed_plan, ops/vegas_kernels.py:MixedLayout):
// a chunk of c samples; a slot of a Continuous pool whose ninc divides c is
// stratified on its nb = ninc strata, m_k = c / nb samples a stratum, and
// every other slot is drawn per sample through its map.  One int32 row per
// slot (kind, nb, tab_off, sm_off, lower, m_k, hist_off), whose first five
// fields are those chain_common.cuh:map_draw reads; one float32 table per
// drawn leaf (grid, inc or cdf, dist).
//
// vegas_sample_mixed writes x [S, B, T, c] (int32 bits for a Discrete slot)
// and the bin gidx [S, B, T, c].  Random bits are vegas_sample.cu's counter
// hash (ops/rng.py), not chain_common.cuh's uniform: for chunk t of block b,
// k1 = mix32(kd[b,0] ^ t*0x9E3779B9), k2 = mix32(kd[b,1] + t), and the c-th
// draw at index q is mix32(mix32(q ^ k1) + k2 + c*0x85EBCA6B).  Slot k:
//   stratified: s = (draw(0, 3k+1) & 0x7FFFFFFF) % nb, a = atab[k, (draw(0,
//     3k+2) & 0x7FFFFFFF) % 64], the row p = q / m_k and its stratum
//     pk = (a*p + s) mod nb, dy = ((draw(q, 3k+3) & 0xFFFFFF) + 0.5) * 2^-24,
//     x = grid[pk] + dy*inc[pk], gidx = pk: vegas_sample's draw at the same
//     flat index, so a spec the uniform route serves gives the same x;
//   per sample: map_draw (Continuous: the bin of u*ninc; Discrete: #{j: u >=
//     cdf[j+1]}, clamped to nbin-1, x = lower + gidx) at the uniform
//     u = ((draw(q, 3k+3) & 0xFFFFFF) + 0.5) * 2^-24.
// A Discrete CDF of up to 1,024 bins is staged in shared memory; a larger
// one is searched in device memory.
//
// vegas_reduce_mixed reads w and gidx and forms per sample, in float32 and
// in the plain version's order (ops/vegas_kernels.py:_row_factors):
//   invp_k   = nb * inc[g_k] (Continuous; vegas_sample's product, so a
//              stratified slot gives the uniform route's bits) or
//              1 / dist[g_k] (Discrete)
//   jac      = prod_k invp_k
//   factor_i = jac * prod over integrand i's padded (group, slot) pairs of
//              prod over the pair's slots of 1/invp_k
//   obs[b, t, i] += w_i * factor_i                     (float64)
//   hist[k][g_k] += min(|w_i| * jac, 1e17)^2 for every slot k that feeds a
//              histogram and that integrand i uses      (float64)
// and vegas_relw_mixed writes relw_i = w_i * factor_i for a custom measure.
// The histogram is a scatter by gidx for every slot: the strata rows of two
// stratified slots of different m_k no longer line up, so vegas_reduce.cu's
// one-writer-per-bin permutation does not hold here.
//
// Layout of the reduce's work: a thread takes kPerThread = 4 consecutive
// samples of a chunk and walks over the chunks (blockIdx.y strides over the
// B*T chunks); warp j of block b takes the 128 samples of group j*nspan + b,
// so the warps of a block work in parts of the chunk far apart and seldom meet
// on a bin.  Where c % 4 == 0 and the pointers are 16-byte aligned, w, each
// slot's gidx and each component of m arrive in 16-byte loads (relw leaves in
// 16-byte stores); else the same kernel loads them one by one.  The layout
// (the slots' rows, pad, pair_slots and used) is staged in shared memory per
// block.  Per (thread, chunk) each slot's bins are loaded once: jac is formed
// from them slot by slot, and the bins of the first kStash slots (fewer if the
// layout leaves no room) wait in shared memory, a thread's own int4 a slot,
// for the histogram and the padding factors, which form 1/invp only where a
// padded pair needs it.  The histogram is privatised per block in shared
// memory as float64: whole up to 4,096 bins, else in windows of 4,096, one per
// blockIdx.z (a block adds only its window's bins; window 0 also writes obs).
// A thread first merges the terms of its consecutive samples that share a bin
// (a stratified slot with m_k >= 4 gives one term a thread); then the lanes of
// a warp with the same bin merge theirs: by a butterfly when the whole warp
// has one bin (a stratified slot with m_k >= 128), else with
// chain_common.cuh:merge_by_key over the lanes that hold a bin; so a bin costs
// a warp one add.  The observables: a thread adds its samples' terms of a
// component in float64, then the warp sums them by shuffles, once per
// (component, chunk), and writes one partial per (component, chunk, span,
// warp), which the wrapper adds in a fixed order, each component's partials as
// one contiguous tensor, so the order of a component's sum does not depend on
// how many components there are (the real parts of w + 0i then sum as the real
// run's, given a measure too).
//
// Every mode reads w through the weights' non-finite guard (chain_common.cuh:
// Weight::finite): a value that is not finite, or a complex one with a part
// that is not, is read as 0, the reference's guard of the integrand's output
// (mcintegration_tpu/solvers/engine.py:260-273); m is summed as it comes.
//
// Instantiations of the one body: kCplx (w complex64, read as (re, im) pairs
// through chain_common.cuh:Weight, |w| = sqrt(re*re + im*im), Re and Im of
// w_i*factor_i in components 2i and 2i+1, so w + 0i gives the real run's
// bits); the mode (the default observables, the sums of a measure's output
// m [ncomp, B, T, c], or relw alone); kMask (measurefreq = mf > 1: sample q
// of chunk t counts in the observable sums only if (t*c + q + 1) % mf == 0,
// the reference's gate; the histogram takes every sample).  :vegas needs no
// random shift of the gate: its strata are permuted at random every chunk.
//
// What bounds them on the card: device-memory bytes.  The sample kernel
// writes 8 bytes a slot and sample (x and gidx); the reduce reads 4 bytes of
// w (8 complex) an integrand and 4 of gidx a slot per sample, and m given a
// measure; the tables stay in cache.  The sample kernel's integer divisions
// by m_k and nb are left as they are.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding, so x, gidx and relw match the plain versions bit for bit and the
// float64 sums to the order of their adds.
//
// float64 (integrate(dtype=torch.float64), the _f64 entry points): every
// kernel is templated on Fp, the type of tab, x and the densities, as the
// reference's XLA route takes them under x64 (mcintegration_tpu/solvers/
// vegas.py:218-356): tab, x (a Discrete value's int32 sign-extended to 64
// bits), invp_k, jac, factor_i and real w, relw and m are double, formed with
// the _rn intrinsics' float64 twins (real.cuh); the uniforms, u*nb and its
// fraction stay float32 (mcintegration_tpu/ops/grid.py:153-176), so a
// stratified or per-sample Continuous slot draws the float32 launch's bin
// for the same kd and only a Discrete slot's bin, compared with its float64
// CDF, may differ.  Complex w stays complex64: relw_i = w_i *
// float(factor_i) (solvers/vegas.py:324), and the histogram term is
// min(float64(|w_i|) * jac, 1e17)^2.  The staged CDFs double in bytes:
// ops/vegas_kernels.py stages at most SMEM_CDF_BYTES of them either way.

#include "chain_common.cuh"

namespace {

constexpr int kFields = 7;       // ops/vegas_kernels.py:MIXED_FIELDS
constexpr int kStrat = 2;        // ops/vegas_kernels.py:KIND_STRAT (kDisc = 1, map = 0)
constexpr int kMk = 5, kHistOff = 6;
constexpr int kNMult = 64;       // ops/vegas_kernels.py:N_MULT
constexpr int kThreads = 256;
constexpr int kPerThread = 4;    // consecutive samples of a chunk a thread takes
static_assert(kPerThread == kQuad, "a thread's samples: one quad (chain_common.cuh)");
constexpr int kSpan = kThreads * kPerThread;  // ops/vegas_kernels.py:SPAN, a reduce block's samples
constexpr int kWarps = kThreads / 32;
constexpr int kWaves = 8;        // the reduce's grid, in blocks the card holds at once
constexpr int kWindow = 4096;    // ops/vegas_kernels.py:SMEM_HIST_BINS
constexpr int kStash = 8;        // slots whose bins a reduce thread keeps in shared memory
constexpr int kSmemMax = 232448; // shared memory a block of sm_90 may have
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float unit24(uint32_t bits) {
  return __fmul_rn(__fadd_rn((float)(bits & 0xFFFFFFu), 0.5f), 5.9604644775390625e-08f);
}

// A stratified slot's permutation of the strata in the current chunk.
struct Perm {
  int a, s;
};

// blockIdx.y strides over the (block, chunk) pairs, blockIdx.x over the
// thread-sized groups of a chunk's samples.
// The ints of shared memory before the staged CDFs: Perm [S] and the slot
// rows, rounded up so that a CDF of doubles starts on 8 bytes
template <typename Fp>
__host__ __device__ constexpr int cdf_at(int S) {
  return sizeof(Fp) == 4 ? (2 + kFields) * S : ((2 + kFields) * S + 1) & ~1;
}

// shared memory: Perm [S], slot rows [S * kFields], staged CDFs [smem_floats] of Fp.
template <typename Fp>
__global__ void __launch_bounds__(kThreads)
vegas_sample_mixed_kernel(const uint32_t* __restrict__ kd, int t0, int B, int T, int c, int S,
                          const int* __restrict__ meta, const int* __restrict__ atab,
                          const Fp* __restrict__ tab, int vec, bits_t<Fp>* __restrict__ x,
                          int* __restrict__ gidx) {
  extern __shared__ int smem[];
  Perm* perm = reinterpret_cast<Perm*>(smem);
  int* rows = smem + 2 * S;
  Fp* cdfs = reinterpret_cast<Fp*>(smem + cdf_at<Fp>(S));
  for (int q = threadIdx.x; q < kFields * S; q += blockDim.x) rows[q] = meta[q];
  stage_cdfs(meta, S, kFields, tab, cdfs);              // ends in __syncthreads
  const int BT = B * T;
  const size_t plane = (size_t)BT * c;                  // one slot's samples
  const int groups = (c + kPerThread - 1) / kPerThread;
  for (int bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const int b = bt / T;
    const uint32_t t = (uint32_t)(t0 + bt - b * T);
    const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
    const uint32_t k2 = mix32(kd[2 * b + 1] + t);
    __syncthreads();                                    // the last chunk's perm is read
    for (int k = threadIdx.x; k < S; k += blockDim.x) {
      const int* f = rows + kFields * k;
      if (f[kKind] != kStrat) continue;
      const uint32_t base = mix32(k1) + k2;             // draw index 0
      const uint32_t salt = 3u * (uint32_t)k;
      const int s = (int)((mix32(base + (salt + 1u) * 0x85EBCA6Bu) & 0x7FFFFFFFu) %
                          (uint32_t)f[kNb]);
      const int j = (int)(mix32(base + (salt + 2u) * 0x85EBCA6Bu) & 0x7FFFFFFFu) % kNMult;
      perm[k] = Perm{atab[k * kNMult + j], s};
    }
    __syncthreads();
    for (int gi = blockIdx.x * blockDim.x + threadIdx.x; gi < groups;
         gi += gridDim.x * blockDim.x) {
      const int s0 = gi * kPerThread;
      const int n = min(kPerThread, c - s0);
      const bool full = vec && n == kPerThread;
      uint32_t base[kPerThread];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) base[v] = mix32((uint32_t)(s0 + v) ^ k1) + k2;
      for (int k = 0; k < S; ++k) {
        const int* f = rows + kFields * k;
        const uint32_t salt = (3u * (uint32_t)k + 3u) * 0x85EBCA6Bu;
        bits_t<Fp> val[kPerThread];
        int g[kPerThread];
        if (f[kKind] == kStrat) {
          const uint32_t nb = (uint32_t)f[kNb], m = (uint32_t)f[kMk];
          const Perm P = perm[k];
          const Fp* gr = tab + f[kTab];
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            const uint32_t p = (uint32_t)(s0 + v) / m;
            const int pk = (int)(((uint32_t)P.a * p + (uint32_t)P.s) % nb);
            const float dy = unit24(mix32(base[v] + salt));
            val[v] = as_bits(add_rn(gr[pk], mul_rn((Fp)dy, gr[nb + pk])));
            g[v] = pk;
          }
        } else {
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            Fp prob;                                    // unused: the reduce reads the tables
            map_draw(f, tab, cdfs, unit24(mix32(base[v] + salt)), val[v], g[v], prob);
          }
        }
        const size_t row = k * plane + (size_t)bt * c;  // slot k, chunk bt
        bits_t<Fp>* xk = x + row;
        int* gk = gidx + row;
        if (full) {
          store4(xk + s0, val[0], val[1], val[2], val[3]);
          *reinterpret_cast<int4*>(gk + s0) = make_int4(g[0], g[1], g[2], g[3]);
        } else {
#pragma unroll
          for (int v = 0; v < kPerThread; ++v)
            if (v < n) {
              xk[s0 + v] = val[v];
              gk[s0 + v] = g[v];
            }
        }
      }
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Slot k's 1/probability at bin g, from its staged row (kind, nb, table)
template <typename Fp>
__device__ __forceinline__ Fp slot_invp(int kind, int nb, const Fp* t, int g) {
  return kind == kDisc ? div_rn((Fp)1, t[nb + 1 + g]) : mul_rn((Fp)nb, t[nb + g]);
}

// Add v into bin key of the shared histogram (key < 0: nothing), one add
// per bin and warp: a butterfly when every lane has the same key, else
// the lanes with a key merge theirs (chain_common.cuh:merge_by_key).
// Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(double* hist_s, int key, double v) {
  const int k0 = __shfl_sync(kFull, key, 0);
  if (__all_sync(kFull, key == k0)) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && k0 >= 0) atomicAdd(hist_s + k0, v);
  } else {
    const unsigned act = __ballot_sync(kFull, key >= 0);
    if (key >= 0 && merge_by_key(act, key, v)) atomicAdd(hist_s + key, v);
  }
}

// A thread's samples' terms sq into their bins key (-1: none): the terms of
// consecutive samples in one bin first make one term, so a thread whose
// samples share a bin (a stratified slot's rows of m_k >= kPerThread) adds
// once, and the warp merges as hist_add does.  Every lane calls it.
__device__ __forceinline__ void hist_add_runs(double* hist_s, const int (&key)[kPerThread],
                                              const double (&sq)[kPerThread]) {
  double run[kPerThread];
  bool split = false;
  double acc = 0.0;
#pragma unroll
  for (int v = kPerThread - 1; v >= 0; --v) {
    acc += sq[v];
    const bool start = v == 0 || key[v] != key[v - 1];
    run[v] = start ? acc : 0.0;
    if (start) acc = 0.0;
    if (v > 0) split |= start;
  }
  hist_add(hist_s, key[0], run[0]);
  if (__any_sync(kFull, split)) {
#pragma unroll
    for (int v = 1; v < kPerThread; ++v)
      hist_add(hist_s, key[v] != key[v - 1] ? key[v] : -1, run[v]);
  }
}

// What a launch makes of w: the default observables, the sums of a
// measure's m, or relw alone (vegas_relw_mixed)
enum Mode { kDefault, kMeasure, kRelw };

template <typename Fp> __device__ __forceinline__ Fp re_of(const Weight<false, Fp>& z) {
  return z.v;
}
template <typename Fp> __device__ __forceinline__ float re_of(const Weight<true, Fp>& z) {
  return z.re;
}
template <typename Fp> __device__ __forceinline__ float im_of(const Weight<true, Fp>& z) {
  return z.im;
}

// meta: slots [S, kFields], pad [N, P], pair_slots [P, M], used [S, N]
// (nmeta ints).  Shared memory: this block's window of the histogram [HW]
// double (none for relw), each thread's bins of slots k < nstash [nstash,
// kThreads] int4, meta.
// Fp: tab's type and the densities'; E = elem_t<kCplx, Fp>, of w's, m's
// and relw's elements.
template <typename Fp, bool kCplx, int kMode, bool kMask>
__global__ void __launch_bounds__(kThreads) vegas_reduce_mixed_kernel(
    const elem_t<kCplx, Fp>* __restrict__ w, const int* __restrict__ gidx,
    const Fp* __restrict__ tab, const int* __restrict__ meta, int N, int S, int P, int M,
    long long BT, int c, int H, int hist_smem, int nstash, int nmeta, int vec,
    const elem_t<kCplx, Fp>* __restrict__ mobs, int ncomp, int mf, int t0, int T,
    double* __restrict__ obs_rows, double* __restrict__ hist,
    elem_t<kCplx, Fp>* __restrict__ relw_out) {
  using E = elem_t<kCplx, Fp>;
  extern __shared__ __align__(16) double hist_s[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int HW = kMode == kRelw ? 0 : hist_smem ? H : kWindow;
  int4* stash = reinterpret_cast<int4*>(hist_s + ((HW + 1) & ~1));
  int* slots = reinterpret_cast<int*>(stash + nstash * kThreads);
  for (int q = threadIdx.x; q < nmeta; q += blockDim.x) slots[q] = meta[q];
  for (int q = threadIdx.x; q < HW; q += blockDim.x) hist_s[q] = 0.0;
  __syncthreads();
  const int* pad = slots + kFields * S;
  const int* pair_slots = pad + N * P;
  const int* used = pair_slots + P * M;
  const long long plane = BT * c;
  const int hlo = blockIdx.z * HW;
  const bool first = blockIdx.z == 0;

  // warp j of block b takes the kPerThread * 32 samples of group j*nspan + b
  // (the warps of a block work in parts of the chunk far apart), a lane
  // kPerThread consecutive ones from s0: n of them in the chunk
  const int s0 = ((warp * gridDim.x + blockIdx.x) * 32 + lane) * kPerThread;
  const int n = max(min(c - s0, kPerThread), 0);
  // compared on s0, not on n: built from n (a predicate of the min and max
  // above), the test let a lane past the chunk's end store 16 bytes there
  const bool full = vec && s0 + kPerThread <= c;
  const long long cstride = BT * gridDim.x * kWarps;

  for (long long bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const long long at = bt * c + s0;
    // each slot's bins read once: jac from their invp, the bins kept for
    // the histogram and the padding factors
    Fp jac[kPerThread];
    for (int k = 0; k < S; ++k) {
      int g[kPerThread];
      load_quad(gidx + k * plane + at, n, full, g);
      if (k < nstash) stash[k * kThreads + threadIdx.x] = make_int4(g[0], g[1], g[2], g[3]);
      const int* f = slots + kFields * k;
      const int kind = f[kKind], nb = f[kNb];
      const Fp* t = tab + f[kTab];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        const Fp ip = slot_invp(kind, nb, t, g[v]);
        jac[v] = k == 0 ? ip : mul_rn(jac[v], ip);
      }
    }
    auto bins = [&](int k, int (&g)[kPerThread]) {
      if (k < nstash) {
        const int4 q = stash[k * kThreads + threadIdx.x];
        g[0] = q.x, g[1] = q.y, g[2] = q.z, g[3] = q.w;
      } else {
        load_quad(gidx + k * plane + at, n, full, g);
      }
    };
    // the gate: which of this thread's samples count in the observable sums
    bool on[kPerThread];
    const int base = kMask ? (int)(((t0 + bt % T) * (long long)c + s0 + 1) % mf) : 0;
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) on[v] = v < n && (!kMask || (base + v) % mf == 0);

    for (int i = 0; i < N; ++i) {
      Fp f[kPerThread];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) f[v] = jac[v];
      for (int pp = 0; pp < P; ++pp) {        // the padded pairs: 1/invp where needed
        if (!pad[i * P + pp]) continue;
        Fp gp[kPerThread] = {(Fp)1, (Fp)1, (Fp)1, (Fp)1};
        for (int mm = 0; mm < M; ++mm) {
          const int k = pair_slots[pp * M + mm];
          if (k < 0) break;
          int g[kPerThread];
          bins(k, g);
          const int* fk = slots + kFields * k;
          const int kind = fk[kKind], nb = fk[kNb];
          const Fp* t = tab + fk[kTab];
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            const Fp q = div_rn((Fp)1, slot_invp(kind, nb, t, g[v]));
            gp[v] = mm == 0 ? q : mul_rn(gp[v], q);
          }
        }
#pragma unroll
        for (int v = 0; v < kPerThread; ++v) f[v] = mul_rn(f[v], gp[v]);
      }
      Weight<kCplx, Fp> wi[kPerThread], relw[kPerThread];
      load_weights<kCplx>(w, i * plane + at, n, full, wi);
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        wi[v] = wi[v].finite();   // the guard: a non-finite weight is read as 0
        relw[v] = wi[v].scale(f[v]);
      }
      if constexpr (kMode == kRelw) {
        store_weights<kCplx>(relw_out, i * plane + at, n, full, relw);
      } else {
        double sq[kPerThread];
#pragma unroll
        for (int v = 0; v < kPerThread; ++v) {
          Fp a = mul_rn((Fp)wi[v].abs(), jac[v]);
          a = a > (Fp)1e17 ? (Fp)1e17 : a;   // NaN passes through, as torch.clamp
          sq[v] = v < n ? (double)mul_rn(a, a) : 0.0;
        }
        for (int k = 0; k < S; ++k) {        // warp-uniform: every lane adds or passes
          const int off = slots[kFields * k + kHistOff];
          if (off < 0 || !used[k * N + i]) continue;
          int g[kPerThread], key[kPerThread];
          bins(k, g);
#pragma unroll
          for (int v = 0; v < kPerThread; ++v) {
            const int bin = off + g[v] - hlo;
            key[v] = v < n && bin >= 0 && bin < HW ? bin : -1;
          }
          hist_add_runs(hist_s, key, sq);
        }
      }
      if constexpr (kMode == kDefault) {     // a thread's terms, then one warp sum
        double so = 0.0, si = 0.0;
#pragma unroll
        for (int v = 0; v < kPerThread; ++v) {
          if (!on[v]) continue;
          so += (double)re_of(relw[v]);
          if constexpr (kCplx) si += (double)im_of(relw[v]);
        }
        so = warp_sum(so);
        if (kCplx) si = warp_sum(si);
        const long long orow = (bt * gridDim.x + blockIdx.x) * kWarps + warp;
        if (lane == 0 && first) {
          if (kCplx) {
            obs_rows[2 * i * cstride + orow] = so;
            obs_rows[(2 * i + 1) * cstride + orow] = si;
          } else {
            obs_rows[i * cstride + orow] = so;
          }
        }
      }
    }
    if constexpr (kMode == kMeasure) {         // a measure's components, gated as relw would be
      const long long orow = (bt * gridDim.x + blockIdx.x) * kWarps + warp;
      for (int q = 0; q < ncomp; ++q) {
        E m[kPerThread];
        load_quad(mobs + q * plane + at, n, full, m);
        double v = 0.0;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) v += on[u] ? (double)m[u] : 0.0;
        v = warp_sum(v);
        if (lane == 0 && first) obs_rows[q * cstride + orow] = v;
      }
    }
  }
  if constexpr (kMode != kRelw) {
    __syncthreads();
    for (int q = threadIdx.x; q < HW && hlo + q < H; q += blockDim.x)
      if (hist_s[q] != 0.0) atomicAdd(hist + hlo + q, hist_s[q]);
  }
}

template <typename Fp, bool kCplx, int kMode, bool kMask>
int launch(const void* w, const void* gidx, const void* tab, const void* meta, int N, int S,
           int P, int M, long long BT, int c, int H, int hist_smem, const void* mobs,
           int ncomp, int mf, int t0, int T, void* obs_rows, void* hist, void* relw,
           void* stream) {
  const int nspan = (c + kSpan - 1) / kSpan;
  const int nwin = kMode == kRelw || hist_smem ? 1 : (H + kWindow - 1) / kWindow;
  const int HW = kMode == kRelw ? 0 : hist_smem ? H : kWindow;
  // the layout whole in shared memory, and as many slots' bins as fit beside it
  const long long nmeta = (long long)kFields * S + (long long)N * P + (long long)P * M +
                          (long long)S * N;
  const long long room = kSmemMax - (long long)((HW + 1) & ~1) * sizeof(double) -
                         nmeta * (long long)sizeof(int);
  if (room < 0) return (int)cudaErrorInvalidValue;
  const int nstash = (int)min((long long)min(S, kStash), room / (long long)(kThreads * sizeof(int4)));
  const uintptr_t any = (uintptr_t)w | (uintptr_t)gidx | (uintptr_t)mobs | (uintptr_t)relw;
  const int vec = c % kPerThread == 0 && any % 16 == 0;
  const size_t smem = (size_t)((HW + 1) & ~1) * sizeof(double) +
                      (size_t)nstash * kThreads * sizeof(int4) + (size_t)nmeta * sizeof(int);
  auto kernel = vegas_reduce_mixed_kernel<Fp, kCplx, kMode, kMask>;
  using E = elem_t<kCplx, Fp>;
  int per_sm = 0;
  const int err = blocks_per_sm(kernel, kThreads, smem, &per_sm);
  if (err) return err;
  long long groups = ((long long)kWaves * per_sm * num_sms() + (long long)nspan * nwin - 1) /
                     ((long long)nspan * nwin);
  if (groups > BT) groups = BT;
  if (groups > 65535) groups = 65535;
  if (groups < 1) groups = 1;
  const dim3 grid((unsigned)nspan, (unsigned)groups, (unsigned)nwin);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const E*)w, (const int*)gidx, (const Fp*)tab, (const int*)meta, N, S, P, M, BT, c, H,
      hist_smem, nstash, (int)nmeta, vec, (const E*)mobs, ncomp, mf, t0, T, (double*)obs_rows,
      (double*)hist, (E*)relw);
  return (int)cudaGetLastError();
}

template <typename Fp, bool kCplx>
int reduce_entry(const void* w, const void* gidx, const void* tab, const void* meta, int N,
                 int S, int P, int M, long long BT, int c, int H, int hist_smem, int span,
                 int warps, const void* mobs, int ncomp, int mf, int t0, int T,
                 void* obs_rows, void* hist, void* stream) {
  if (span != kSpan || warps != kWarps || N < 1 || S < 1 || P < 1 || M < 1 || BT < 1 ||
      c < 1 || H < 0 || mf < 1 || t0 < 0 || T < 1 || BT % T != 0 || ncomp < 1 ||
      (!mobs && ncomp != (kCplx ? 2 * N : N)))
    return (int)cudaErrorInvalidValue;       // the wrapper sized obs_rows otherwise
  auto run = launch<Fp, kCplx, kDefault, false>;
  if (mobs)
    run = mf > 1 ? launch<Fp, kCplx, kMeasure, true> : launch<Fp, kCplx, kMeasure, false>;
  else if (mf > 1) run = launch<Fp, kCplx, kDefault, true>;
  return run(w, gidx, tab, meta, N, S, P, M, BT, c, H, hist_smem, mobs, ncomp, mf, t0, T,
             obs_rows, hist, nullptr, stream);
}

template <typename Fp, bool kCplx>
int relw_entry(const void* w, const void* gidx, const void* tab, const void* meta, int N,
               int S, int P, int M, long long BT, int c, int span, int warps, void* relw,
               void* stream) {
  if (span != kSpan || warps != kWarps || N < 1 || S < 1 || P < 1 || M < 1 || BT < 1 || c < 1)
    return (int)cudaErrorInvalidValue;
  // no histogram, no observables
  return launch<Fp, kCplx, kRelw, false>(w, gidx, tab, meta, N, S, P, M, BT, c, 0, 1, nullptr,
                                         N, 1, 0, 1, nullptr, nullptr, relw, stream);
}

template <typename Fp>
int sample_entry(const void* kd, int t0, int B, int T, int c, int S, const void* meta,
                 const void* atab, const void* tab, int smem_floats, void* x, void* gidx,
                 void* stream) {
  if (B < 1 || T < 1 || c < 1 || S < 1 || t0 < 0 || smem_floats < 0 ||
      (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // 16-byte stores of x and gidx: every group of four samples starts on a
  // quad when c % 4 == 0
  const int vec = c % 4 == 0 && ((uintptr_t)x | (uintptr_t)gidx) % 16 == 0;
  const size_t smem = (size_t)cdf_at<Fp>(S) * sizeof(int) + (size_t)smem_floats * sizeof(Fp);
  int err = 0;
  if (smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(vegas_sample_mixed_kernel<Fp>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int per_block = kThreads * kPerThread;
  long long bx = ((long long)c + per_block - 1) / per_block;
  long long by = (long long)B * T;
  if (bx > 65535) bx = 65535;
  if (by > 65535) by = 65535;
  vegas_sample_mixed_kernel<Fp><<<dim3((unsigned)bx, (unsigned)by), kThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)kd, t0, B, T, c, S, (const int*)meta, (const int*)atab, (const Fp*)tab,
      vec, (bits_t<Fp>*)x, (int*)gidx);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCI_SAMPLE_MIXED(name, Fp)                                                        \
  extern "C" int name(const void* kd, int t0, int B, int T, int c, int S, const void* meta, \
                      const void* atab, const void* tab, int smem_floats, void* x,          \
                      void* gidx, void* stream) {                                           \
    return sample_entry<Fp>(kd, t0, B, T, c, S, meta, atab, tab, smem_floats, x, gidx,      \
                            stream);                                                        \
  }

#define MCI_REDUCE_MIXED(name, Fp, kCplx)                                                  \
  extern "C" int name(const void* w, const void* gidx, const void* tab, const void* meta,   \
                      int N, int S, int P, int M, long long BT, int c, int H, int hist_smem, \
                      int span, int warps, const void* mobs, int ncomp, int mf, int t0,      \
                      int T, void* obs_rows, void* hist, void* stream) {                   \
    return reduce_entry<Fp, kCplx>(w, gidx, tab, meta, N, S, P, M, BT, c, H, hist_smem,     \
                                   span, warps, mobs, ncomp, mf, t0, T, obs_rows, hist,    \
                                   stream);                                                \
  }

#define MCI_RELW_MIXED(name, Fp, kCplx)                                                    \
  extern "C" int name(const void* w, const void* gidx, const void* tab, const void* meta,   \
                      int N, int S, int P, int M, long long BT, int c, int span, int warps,  \
                      void* relw, void* stream) {                                          \
    return relw_entry<Fp, kCplx>(w, gidx, tab, meta, N, S, P, M, BT, c, span, warps, relw,  \
                                 stream);                                                  \
  }

// w complex64 [N, B, T, c] in the _complex entries, read as interleaved
// (re, im) float pairs; tab and x float64 in the _f64 entries, and real w,
// m and relw with them
MCI_SAMPLE_MIXED(mci_vegas_sample_mixed, float)
MCI_SAMPLE_MIXED(mci_vegas_sample_mixed_f64, double)
MCI_REDUCE_MIXED(mci_vegas_reduce_mixed, float, false)
MCI_REDUCE_MIXED(mci_vegas_reduce_mixed_complex, float, true)
MCI_REDUCE_MIXED(mci_vegas_reduce_mixed_f64, double, false)
MCI_REDUCE_MIXED(mci_vegas_reduce_mixed_complex_f64, double, true)
MCI_RELW_MIXED(mci_vegas_relw_mixed, float, false)
MCI_RELW_MIXED(mci_vegas_relw_mixed_complex, float, true)
MCI_RELW_MIXED(mci_vegas_relw_mixed_f64, double, false)
MCI_RELW_MIXED(mci_vegas_relw_mixed_complex_f64, double, true)
#undef MCI_SAMPLE_MIXED
#undef MCI_REDUCE_MIXED
#undef MCI_RELW_MIXED
