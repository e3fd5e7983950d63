// vplus_reduce: the density, observable sums, per-cube second moments and
// training histograms of the :vegasplus solver.
//
// Replaces the reduction half of mcintegration_tpu/ops/pallas_vplus.py:
// build_vplus_run_all (lines 274-368), with the law of the JAX package's XLA
// route (mcintegration_tpu/solvers/vegasplus.py:214-300).  Per sample s of
// chunk (b, t), in float32 and in the reference's order:
//   prob   = prod over the Continuous slots of rho_k          (rho: slot_rho)
//   pass   = prod over the Discrete slots of rho_k
//   dens   = cfac[cube[s]] * prob (* pass),  jac = 1/dens,
//            cfac[cube] = counts[cube]*ncubes/c                (:215-220)
//   pad_i  = prod over integrand i's padded (group, slot) pairs of the
//            product of the pair's slots' rho                  (:231-250)
//   relw_i = w_i * (jac * pad_i)
//   obs[b, t, i]   += relw_i
//   sig[cube[s]]   += min(sum_i |w_i|*pad_i / (prob (* pass)), 1e17)^2  (:275-284)
//   hist[leaf of k][gidx_k] += min(|relw_i|, 1e17)^2  for every adaptive slot
//            k that integrand i uses                           (:286-300)
// with every square formed in float32 and every sum taken in float64 (these
// replace the TPU kernel's Kahan float32 pairs and its HIST_EVERY subsample:
// every sample feeds the histograms).
//
// Layout of the work.  The samples of a chunk are cube-major and every chunk
// has the same layout, so a thread keeps one sample position, its cube and
// the cube's factor, and walks over many chunks (blockIdx.y strides over the
// B*T chunks).  Warp j of block b takes the 32 samples of group j*nspan + b:
// the warps of a block work in parts of the chunk far apart.  Hence
//   sig:  a thread adds its sample's second moments of every chunk it walks
//         into a register; at the end a segmented warp sum over the sorted
//         cubes leaves one value per (warp, cube), added with a native
//         float64 atomic into device memory;
//   hist: privatised per thread block in shared memory as float64 and
//         flushed once at the end.  A histogram of up to SMEM_HIST_BINS
//         bins (ops/vplus_kernels.py) fits whole; a larger one is cut into
//         windows of kWindow bins, one per blockIdx.z, and a block adds only
//         its window's bins (the blocks of window 0 also write obs and
//         sig).  So every bin is summed in two levels, over a block's
//         samples and then over the blocks, whatever its size: adding a
//         large histogram straight into device memory summed up to a
//         launch's samples into one bin in a chain, missed the plain
//         version by rel 3.6e-12 on phase 3d's all-branch spec with 5,071
//         bins and took 19 times as long as the windows (PERF.md).  The
//         windows read every sample once more for each window beyond the
//         first.
//         This card runs a float64 add on shared memory as a compare-and-
//         swap loop, which retries when lanes meet on one bin: a warp's 32
//         consecutive samples share few cubes and so a narrow window of
//         bins, but the block's other warps are in other cubes, so a hot
//         bin costs retries within a warp only;
//   obs:  each warp sums its samples of a chunk by shuffles and writes one
//         partial per (chunk, span, warp, integrand); the wrapper adds the
//         partials in a fixed order, so the observables do not depend on the
//         order of any atomic.
// One sample per thread and chunk keeps the kernel at 32 registers, eight
// blocks to an SM; the grid is eight waves of them, so no SM idles long at
// the end.
//
// What bounds it on the card: device-memory bytes, 4 bytes of w per sample
// and integrand and 4 bytes of gidx per sample and slot; cube[], cfac[] and
// the tables stay in cache.  It runs at about a quarter of that rate: its
// time falls with each part of a sample's work taken out, and not with any
// change to how the bytes arrive, so it is held by the instructions each
// sample issues and their latency, at 64 warps to an SM.  The histogram's
// adds name shared memory (a generic pointer made every add test its
// address space first).  Measured
// (tools/accept_reduce_variants.py, phase 6d's launch, NVIDIA H100 80GB
// HBM3 at 700 W): 1.37 ms against a bound of 0.32; without the histogram
// adds 1.11, without the integrand's part 0.55.  Slower there: merging the
// lanes of a warp per bin before the add (__match_any_sync), native
// float64 atomics into device memory (a small histogram's adds meet on few
// L2 lines), the warps of a block on consecutive samples (a hot bin), a
// prefetch of the next chunk.  No faster in this PR's trials: a float64
// copy of the histogram per warp with no atomics (the copies cost
// occupancy), the map tables staged in shared memory, each chunk copied
// into shared memory ahead (cp.async), two chunks per thread.
//
// The order of the float64 sums changes from run to run, so sig and hist,
// and the counts and maps made from them, reproduce only to rounding (rel
// 1e-12 against the plain version).
//
// The reference's XLA route (mcintegration_tpu/solvers/vegasplus.py:131-312)
// also serves what K4 never does, and so does this file:
// - complex weights: w complex64, read as (re, im) pairs (Weight of
//   chain_common.cuh); relw_i = (re*f, im*f) with f = jac*pad_i, the
//   default observables Re and Im of relw_i in components 2i and 2i+1,
//   score += |w_i|*pad_i and hist += min(|relw_i|, 1e17)^2, with |z| =
//   sqrt(re*re + im*im) (vegasplus.py:272-300), so w + 0i gives the real
//   run's bits.  |relw_i| is not formed from |w_i|: sqrt of the scaled
//   parts' squares rounds otherwise than |w_i|*f, so both roots stay.  The
//   complex default observables are a kernel of their own,
//   vplus_reduce_chunks_kernel (which also serves the float64 default
//   ones, below): the layout of the work above, but a
//   thread takes kCplxChunks = 4 of the chunks it walks at once (their
//   density's loads in flight together, the layout's fields read once for
//   the four), and a warp sums the Re and Im parts of the 4 chunks
//   together in warp_sum's tree (tree_sums: 9 float64 shuffles where two
//   warp_sums a chunk took 40), each partial in the row the real kernel's
//   layout gives it; 8 blocks an SM.  Measured at phase 6g's quarter disc
//   (tools/accept_reduce_variants.py, NVIDIA H100 80GB HBM3 at 700 W):
//   1.13 ms, from 1.86 in the real kernel's body, against a bound of 0.33;
//   6 blocks an SM 1.14, 4 blocks 1.40; 2 chunks at once 1.25, one 1.45.
//   What holds it: the histogram's compare-and-swap adds (0.27 ms), the
//   two square roots (0.15), the sums (0.07);
// - a custom measure: vplus_relw_kernel writes relw_i per sample for the
//   measure (the density formed as above) and nothing else, as a stream:
//   a thread takes a quad of 4 consecutive samples of one chunk (16-byte
//   loads of w and each slot's gidx, 16-byte stores of relw; scalar ones
//   where the quad leaves the chunk or the pointers are not aligned), 8
//   blocks an SM: 0.35 ms at phase 6g's histogram launch, from 0.82 in the
//   reduce's body, against a bound of 0.32 (scalar accesses 0.56, the
//   layout staged in shared memory 0.36, 6 blocks an SM 0.37); complex
//   0.53 from 0.90.  kMeasure sums the measure's float32 components m
//   [ncomp, B, T, c] in place of relw, and sig and hist come from w as
//   before.  Its sums wait for kChunks = 4 of the chunks a warp walks;
//   then lane 8u + j adds the terms j, j+8, j+16, j+24 of the warp's 32
//   samples in the u-th of them in registers, and 3 shuffle levels among 8
//   lanes finish each chunk's sum (measure_sums): the tree of the default
//   mode's warp_sum, so each partial is the default sum bit for bit (given
//   m = relw, the default observables), at 3 shuffles a component for 4
//   chunks where a warp_sum took 5 for one, with the loads of kBatch
//   components in flight together;
// - measurefreq = mf > 1 (kMask): sample s of chunk t (t0 plus the chunk's
//   index in the launch) counts in the observable sums only if
//   (t*c + (s + shift[b, t]) % c + 1) % mf == 0; sig and hist take every
//   sample.  The reference's gate (vegasplus.py:255-262) is this with no
//   shift: where mf divides c it measures the same positions of every
//   cube-major chunk, so a cube of n_c samples has floor or ceil(n_c/mf)
//   measured ones and the estimate weights it by mf*m_c/n_c, from 0 to 2
//   (ROADMAP.md, known faults in the reference).  A random cyclic shift of
//   the positions per (block, chunk) measures each cube at the rate 1/mf in
//   expectation and keeps the count of each chunk.
//
// Every kernel here reads w through the weights' non-finite guard
// (chain_common.cuh: Weight::finite), at each of its loads: a weight that is
// not finite, or a complex one with a part that is not, is read as 0, the
// reference's guard of the integrand's output (mcintegration_tpu/solvers/
// engine.py:260-273), so the relw a measure reads is guarded too; m is
// summed as it comes.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding.
//
// float64 (integrate(dtype=torch.float64), the _f64 entry points): every
// kernel is templated on Fp, the type of tab and the density, with the
// reference's float64 law (mcintegration_tpu/solvers/vegasplus.py:214-300
// under x64): rho, prob, pass, dens = float64(cfac)*prob (cfac stays the
// float32 factor of the counts, :159), jac, pad_i, score and wj are double
// (__dmul_rn, __ddiv_rn, __dadd_rn); so are real w, relw, m and the
// histogram term.  Complex w stays complex64: relw_i = w_i * float(jac *
// pad_i) (the factor cast to the weights' dtype, :252), its histogram term
// min(|relw_i|, 1e17)^2 stays float32 as the reference's abs of a complex64
// is, and score += float64(|w_i|) * pad_i.  Given m and vplus_relw at
// float64 have half their float32 twins' blocks an SM in their register
// bound (two of a double's registers).  The float64 default observables,
// real and complex, are vplus_reduce_chunks_kernel's, at kF64Chunks =
// kCplxF64Chunks = 2 chunks at once and 8 blocks an SM (32 registers; the
// real body spills 56 bytes, the complex 72), the fastest pair of 1, 2 or
// 4 chunks and 2 to 8 blocks (tools/accept_reduce_variants.py at phase
// 6i's launches, NVIDIA H100 80GB HBM3 at 700 W): singular_3d at 2^26
// samples 1.345 ms against a bound of 0.401 (the float32 body templated on
// double, 4 blocks: 2.156), gated 1.494 (3.08); the complex quarter disc
// 1.194 against 0.321 (1.461), gated 1.394 (1.654).  Warps an SM decide
// it, not chunks: 4 chunks at 3 blocks (80 registers, no spill) took
// 1.848 and 1.790, 2 chunks at 5 (48, no spill) 1.564 and 1.428.

#include "vplus_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = kThreads;               // ops/vplus_kernels.py:SPAN
constexpr int kWarps = kThreads / 32;         // ops/vplus_kernels.py:WARPS
constexpr int kBlocksPerSm = 8;               // at most 32 registers a thread
constexpr int kMeasureBlocks = 6;             // given m: at most 40
constexpr int kWaves = 8;                     // the grid, in blocks the card holds at once
constexpr int kWindow = 4096;                 // ops/vplus_kernels.py:SMEM_HIST_BINS
constexpr int kChunks = 4;                    // chunks whose measure sums a warp forms together
constexpr int kBatch = 4;                     // a measure's components loaded together
constexpr int kCplxChunks = 4;                // chunks the complex default takes at once
constexpr int kCplxBlocks = 8;                // the complex default: at most 32 registers
constexpr int kF64Chunks = 2;                 // the same of the real float64 default,
constexpr int kF64Blocks = 8;                 // at most 32 registers,
constexpr int kCplxF64Chunks = 2;             // and of the complex float64 default,
constexpr int kCplxF64Blocks = 8;             // at most 32
constexpr int kRelwThreads = 256;             // vplus_relw: a block's threads,
constexpr int kRelwSpan = kRelwThreads * kQuad;  // and samples (ops/vplus_kernels.py:RELW_SPAN)
constexpr int kRelwBlocks = 8;                // at most 32 registers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// What a launch of vplus_reduce_kernel makes of w: the default observables
// (real weights), or the sums of a measure's m
enum Mode { kDefault, kMeasure };

// The real, ungated, default-measure kernel keeps 32 registers (eight blocks
// an SM); given m, 40 (six blocks: a warp's measure sums wait on their
// loads, and more warps hide them: 1.89 ms at phase 6g against 2.35 at four
// blocks, PERF.md); the gated real default may take up to 64.  Given m at
// float64 (Fp = double), and vplus_relw's float64 body, get half as many
// blocks an SM; the default observables at float64 are
// vplus_reduce_chunks_kernel's.
template <typename Fp>
constexpr int min_blocks(int mode, bool mask) {
  return (mode == kMeasure ? kMeasureBlocks : mask ? kBlocksPerSm / 2 : kBlocksPerSm) /
         (int)(sizeof(Fp) / 4);
}
template <typename Fp> constexpr int f64_halved(int blocks) { return blocks / (int)(sizeof(Fp) / 4); }

// vplus_reduce_chunks_kernel's chunks taken at once and blocks an SM: the
// complex default at float32, and the real and complex defaults at float64
// (tools/accept_reduce_variants.py chose each pair, PERF.md)
template <typename Fp> __host__ __device__ constexpr int chunks_at_once(bool cplx) {
  return sizeof(Fp) == 4 ? kCplxChunks : cplx ? kCplxF64Chunks : kF64Chunks;
}
template <typename Fp> constexpr int chunk_blocks(bool cplx) {
  return sizeof(Fp) == 4 ? kCplxBlocks : cplx ? kCplxF64Blocks : kF64Blocks;
}

template <typename Fp> __device__ __forceinline__ Fp re_of(const Weight<false, Fp>& z) {
  return z.v;
}
template <typename Fp> __device__ __forceinline__ float re_of(const Weight<true, Fp>& z) {
  return z.re;
}

// A measure's components over the warp's 32 samples from s0 (group s0/32)
// in the nbt <= kChunks chunks bt0 + u*stride, u < nbt, in the order of
// the default sums: warp_sum adds a chunk's 32 terms by a butterfly whose
// first two levels add the terms 16 and then 8 apart; here lane 8u + j
// holds the terms j, j+8, j+16, j+24 of chunk u and adds them in that
// order in registers, and three shuffle levels among its 8 lanes finish the
// same tree.  A sample counts if it lies in the chunk and the gate lets it
// (the default mode's gate).  Every lane calls it; the partial of chunk bt
// goes to the row the default mode gives it.
template <bool kMask, typename E>
__device__ __forceinline__ void measure_sums(const E* __restrict__ mobs, int ncomp, int c,
                                             long long plane, long long bt0, int nbt,
                                             int stride, int s0, int t0, int T, int mf,
                                             const int* __restrict__ shift, bool first,
                                             double* __restrict__ obs_rows) {
  static_assert(kChunks * 8 == 32, "8 lanes a chunk, 4 terms a lane");
  const int lane = threadIdx.x & 31, j = lane & 7, u = lane >> 3;
  const long long bt = bt0 + (long long)u * stride;
  const bool live = u < nbt;
  bool in[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = s0 + j + 8 * r;
    in[r] = live && s < c && (!kMask || ((t0 + bt % T) * (long long)c +
                                         ((long long)s + (shift ? shift[bt] : 0)) % c + 1) %
                                            mf == 0);
  }
  const long long at = live ? bt * c + s0 + j : 0;
  const bool write = j == 0 && first && live;
  const long long row = (bt * gridDim.x + blockIdx.x) * kWarps + (threadIdx.x >> 5);
  for (int q0 = 0; q0 < ncomp; q0 += kBatch) {
    E t[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const E* m = mobs + min(q0 + b, ncomp - 1) * plane + at;
#pragma unroll
      for (int r = 0; r < 4; ++r) t[b][r] = q0 + b < ncomp && in[r] ? m[8 * r] : (E)0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (q0 + b >= ncomp) break;              // warp-uniform
      double a = ((double)t[b][0] + (double)t[b][2]) + ((double)t[b][1] + (double)t[b][3]);
      for (int o = 4; o > 0; o >>= 1) a += __shfl_down_sync(kFull, a, o, 8);
      if (write) obs_rows[row * ncomp + q0 + b] = a;
    }
  }
}

// Fp: tab's type and the density's; E = elem_t<kCplx, Fp>, of w's and m's
// elements.
template <typename Fp, bool kCplx, int kMode, bool kMask>
__global__ void __launch_bounds__(kThreads, min_blocks<Fp>(kMode, kMask)) vplus_reduce_kernel(
    const elem_t<kCplx, Fp>* __restrict__ w, const int* __restrict__ gidx,
    const int* __restrict__ cube, const float* __restrict__ cfac,
    const Fp* __restrict__ tab, const int* __restrict__ meta, int N, int S,
    int P, int M, long long BT, int c, int H, int hist_smem,
    const elem_t<kCplx, Fp>* __restrict__ mobs, int ncomp, int mf, int t0, int T,
    const int* __restrict__ shift, double* __restrict__ obs_rows, double* __restrict__ sig,
    double* __restrict__ hist) {
  static_assert(kMode == kMeasure || (!kCplx && sizeof(Fp) == 4),
                "the complex and float64 defaults: vplus_reduce_chunks_kernel");
  extern __shared__ double hist_s[];           // [HW] this block's window of the histogram
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* slots = meta;                     // [S, 8]
  const int* pad = slots + kSlotFields * S;    // [N, P]
  const int* pair_slots = pad + N * P;         // [P, M]
  const int* used = pair_slots + P * M;        // [S, N]
  const long long plane = BT * c;              // one slot's or integrand's samples

  // the window: bins [hlo, hlo + HW) of hist; window 0 also writes obs and sig
  const int HW = hist_smem ? H : kWindow;
  const int hlo = blockIdx.z * HW;
  const bool first = blockIdx.z == 0;
  for (int q = threadIdx.x; q < HW; q += blockDim.x) hist_s[q] = 0.0;
  __syncthreads();

  // this thread's sample of every chunk: warp j of block b takes the 32
  // samples of group j*nspan + b, so the warps of a block work in parts of
  // the chunk far apart and rarely add into the same bins.  Its cube (-1
  // past the chunk's end: the lane then only takes part in the shuffles),
  // the cube's factor, and its second moments over the chunks
  const int s = (warp * gridDim.x + blockIdx.x) * 32 + lane;
  const int cb = s < c ? cube[s] : -1;
  const float cf = cb < 0 ? 1.0f : cfac[cb];
  double v2 = 0.0;
  long long bt0 = blockIdx.y;                  // the first chunk whose measure sums wait
  int nbt = 0;

  for (long long bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const long long at = bt * c + s;
    Fp jac = (Fp)1, denom = (Fp)1, score = (Fp)0;
    if (cb >= 0) {
      Fp prob = (Fp)1, pass = (Fp)1;
      bool any_pass = false;
      for (int k = 0; k < S; ++k) {
        const int* f = slots + kSlotFields * k;
        const Fp rho = slot_rho(f, tab, gidx[k * plane + at]);
        if (f[kKind] == kDisc) {
          pass = mul_rn(pass, rho);
          any_pass = true;
        } else {
          prob = mul_rn(prob, rho);
        }
      }
      Fp dens = mul_rn((Fp)cf, prob);
      denom = prob;
      if (any_pass) {
        dens = mul_rn(dens, pass);
        denom = mul_rn(prob, pass);
      }
      jac = div_rn((Fp)1, dens);
    }
    // the gate: whether this sample counts in the observable sums
    const bool on = !kMask || ((t0 + bt % T) * (long long)c +
                               ((long long)s + (shift ? shift[bt] : 0)) % c + 1) % mf == 0;

    for (int i = 0; i < N; ++i) {
      double so = 0.0, sq = 0.0;
      if (cb >= 0) {
        Fp pad_i = (Fp)1;
        for (int g = 0; g < P; ++g) {
          if (!pad[i * P + g]) continue;
          Fp gp = (Fp)1;
          for (int mm = 0; mm < M; ++mm) {
            const int k = pair_slots[g * M + mm];
            if (k < 0) break;
            gp = mul_rn(gp, slot_rho(slots + kSlotFields * k, tab, gidx[k * plane + at]));
          }
          pad_i = mul_rn(pad_i, gp);
        }
        const Weight<kCplx, Fp> wi = Weight<kCplx, Fp>::load(w, i * plane + at).finite();
        const Weight<kCplx, Fp> relw = wi.scale(mul_rn(jac, pad_i));
        score = add_rn(score, mul_rn((Fp)wi.abs(), pad_i));
        if (kMode == kDefault && on) so = (double)re_of(relw);
        auto a = relw.abs();         // float for a complex relw, as the reference's
        a = a > (decltype(a))1e17 ? (decltype(a))1e17 : a;   // NaN passes through, as torch.clamp
        sq = (double)mul_rn(a, a);
      }
      for (int k = 0; k < S; ++k) {
        const int off = slots[kSlotFields * k + kHist];
        if (off < 0 || !used[k * N + i]) continue;
        const int bin = cb >= 0 ? off + gidx[k * plane + at] - hlo : -1;
        if (bin < 0 || bin >= HW) continue;
        atomicAdd(hist_s + bin, sq);
      }
      if (kMode != kDefault) continue;
      so = warp_sum(so);
      if (lane == 0 && first)
        obs_rows[((bt * gridDim.x + blockIdx.x) * kWarps + warp) * N + i] = so;
    }
    // a measure's components, gated as relw would be, every kChunks chunks
    if (kMode == kMeasure && (++nbt == kChunks || bt + gridDim.y >= BT)) {
      measure_sums<kMask>(mobs, ncomp, c, plane, bt0, nbt, gridDim.y, s - lane, t0, T, mf,
                          shift, first, obs_rows);
      bt0 = bt + gridDim.y;
      nbt = 0;
    }

    Fp wj = div_rn(score, denom);
    wj = wj > (Fp)1e17 ? (Fp)1e17 : wj;
    if (cb >= 0) v2 += (double)mul_rn(wj, wj);
  }

  // per-cube second moments: a segmented sum over the warp's sorted cubes
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_down_sync(kFull, v2, o);
    const int kup = __shfl_down_sync(kFull, cb, o);
    if (lane + o < 32 && kup == cb) v2 += up;
  }
  const int kprev = __shfl_up_sync(kFull, cb, 1);
  if (first && cb >= 0 && (lane == 0 || kprev != cb)) atomicAdd(sig + cb, v2);

  __syncthreads();
  for (int q = threadIdx.x; q < HW && hlo + q < H; q += blockDim.x)
    if (hist_s[q] != 0.0) atomicAdd(hist + hlo + q, hist_s[q]);
}

// The sums over a warp's lanes of kV values a lane (t[q], q < kV; float or
// double terms, each made a double), each in warp_sum's tree: log2(kV)
// butterfly levels (16, 8, ...) in which a lane keeps half of its values
// and trades the other half with its partner, then shuffles down among
// 32/kV lanes.  Lane l ends with value q = l / (32/kV); on lane
// l % (32/kV) == 0 its sum over the 32 lanes, bit for bit warp_sum's:
// every level adds the same pairs of partials as warp_sum's (a + b where
// warp_sum forms b + a on the upper lanes, and IEEE addition commutes).  kV
// values cost kV - 1 + log2(32/kV) shuffles where warp_sum took 5 each.
// Every lane calls it.
template <int kV, typename T>
__device__ __forceinline__ double tree_sums(const T (&t)[kV]) {
  static_assert(kV >= 1 && kV <= 32 && (kV & (kV - 1)) == 0, "a power of two up to 32");
  const int lane = threadIdx.x & 31;
  double v[kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) v[q] = (double)t[q];
#pragma unroll
  for (int n = kV, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool hi = lane & o;                  // keeps the upper half of its n values
#pragma unroll
    for (int q = 0; q < n / 2; ++q) {
      const double mine = hi ? v[q + n / 2] : v[q];
      v[q] = mine + __shfl_xor_sync(kFull, hi ? v[q] : v[q + n / 2], o);
    }
  }
  double a = v[0];
#pragma unroll
  for (int o = 16 / kV; o > 0; o >>= 1) a += __shfl_down_sync(kFull, a, o, 32 / kV);
  return a;
}

// Whether the gate of measurefreq mf lets sample s of chunk t count (the
// gate of vplus_reduce_kernel): (t*c + (s + sh) % c + 1) % mf == 0, for
// t < 2^31 and s, sh < c.  (s + sh) % c is one subtraction, and where mf <
// 2^16 the rest takes 32-bit remainders, t*c = (t % mf)*(c % mf) modulo
// mf, in place of three 64-bit ones.
__device__ __forceinline__ bool gate_open(unsigned t, unsigned s, unsigned sh, unsigned c,
                                          unsigned mf) {
  unsigned x = s + sh;
  x = x >= c ? x - c : x;
  if (mf < 65536u) return ((t % mf) * (c % mf) + x % mf + 1u) % mf == 0u;
  return ((unsigned long long)t * c + x + 1u) % mf == 0u;
}

// The default observables of complex w, and of real w at float64
// (vplus_reduce_kernel's law and layout of the work; see the head of the
// file).  A thread takes kU = chunks_at_once chunks bt0 + u*gridDim.y at
// once at its sample s: their gidx and w loads are in flight together, the
// layout's fields are read once for all of them, their divisions are issued
// back to back, and the partials of the kU chunks (Re, and for complex w
// Im, of each) are summed together (tree_sums), lane (32/kV)*q of a warp
// writing the row of value q: Re of chunk q, then Im of chunk q - kU.
// E = elem_t<kCplx, Fp> is the type of a partial's terms and of |relw|:
// float for complex64 w, double for real float64 w.
template <typename Fp, bool kCplx, bool kMask>
__global__ void __launch_bounds__(kThreads, chunk_blocks<Fp>(kCplx))
vplus_reduce_chunks_kernel(
    const elem_t<kCplx, Fp>* __restrict__ w, const int* __restrict__ gidx,
    const int* __restrict__ cube, const float* __restrict__ cfac,
    const Fp* __restrict__ tab, const int* __restrict__ meta, int N, int S,
    int P, int M, long long BT, int c, int H, int hist_smem, int mf, int t0, int T,
    const int* __restrict__ shift, double* __restrict__ obs_rows, double* __restrict__ sig,
    double* __restrict__ hist) {
  static_assert(kCplx || sizeof(Fp) == 8, "the real float32 default: vplus_reduce_kernel");
  using E = elem_t<kCplx, Fp>;
  constexpr int kU = chunks_at_once<Fp>(kCplx), kParts = kCplx ? 2 : 1, kV = kParts * kU;
  static_assert(kV <= 32, "a lane's values: Re (and Im) of each chunk");
  extern __shared__ double hist_s[];           // [HW] this block's window of the histogram
  const int warp = threadIdx.x >> 5;
  const int* slots = meta;                     // [S, 8]
  const int* pad = slots + kSlotFields * S;    // [N, P]
  const int* pair_slots = pad + N * P;         // [P, M]
  const int* used = pair_slots + P * M;        // [S, N]
  const long long plane = BT * c;
  const int HW = hist_smem ? H : kWindow;
  const int hlo = blockIdx.z * HW;
  const bool first = blockIdx.z == 0;
  for (int q = threadIdx.x; q < HW; q += blockDim.x) hist_s[q] = 0.0;
  __syncthreads();

  const int s = (warp * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
  const int cb = s < c ? cube[s] : -1;
  const float cf = cb < 0 ? 1.0f : cfac[cb];
  const long long step = gridDim.y;
  const unsigned sT = (unsigned)(step % T);   // the gate's chunk index t0 + bt % T, kept
  unsigned tb0 = (unsigned)(blockIdx.y % T);  // as bt0 % T and stepped in 32 bits
  double v2 = 0.0;

  for (long long bt0 = blockIdx.y; bt0 < BT; bt0 += kU * step, tb0 = (tb0 + kU * sT) % T) {
    // chunk u: bt0 + u*step, this thread's sample of it at at0 + u*cstep;
    // bit u of ok: the chunk lies in the launch and s in the chunk, of on:
    // the gate lets the sample count in the observable sums
    const long long at0 = bt0 * c + s, cstep = step * c;
    unsigned ok = 0, on = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long bt = bt0 + u * step;
      if (cb < 0 || bt >= BT) continue;
      ok |= 1u << u;
      if constexpr (kMask) {
        unsigned tb = tb0 + u * sT;
        while (tb >= (unsigned)T) tb -= T;
        if (gate_open(t0 + tb, s, shift ? shift[bt] : 0, c, mf)) on |= 1u << u;
      } else {
        on |= 1u << u;
      }
    }
    Fp prob[kU], pass[kU];
    bool any_pass = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) prob[u] = pass[u] = (Fp)1;
    for (int k = 0; k < S; ++k) {
      const int* f = slots + kSlotFields * k;
      const bool disc = f[kKind] == kDisc;
      any_pass |= disc;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!(ok >> u & 1)) continue;
        const Fp rho = slot_rho(f, tab, gidx[k * plane + at0 + u * cstep]);
        if (disc) pass[u] = mul_rn(pass[u], rho);
        else prob[u] = mul_rn(prob[u], rho);
      }
    }
    Fp jac[kU], denom[kU], score[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      Fp dens = mul_rn((Fp)cf, prob[u]);
      denom[u] = prob[u];
      if (any_pass) {
        dens = mul_rn(dens, pass[u]);
        denom[u] = mul_rn(prob[u], pass[u]);
      }
      jac[u] = div_rn((Fp)1, dens);
      score[u] = (Fp)0;
    }

    for (int i = 0; i < N; ++i) {
      Fp pad_i[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) pad_i[u] = (Fp)1;
      for (int g = 0; g < P; ++g) {
        if (!pad[i * P + g]) continue;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (!(ok >> u & 1)) continue;
          Fp gp = (Fp)1;
          for (int mm = 0; mm < M; ++mm) {
            const int k = pair_slots[g * M + mm];
            if (k < 0) break;
            gp = mul_rn(gp, slot_rho(slots + kSlotFields * k, tab,
                                     gidx[k * plane + at0 + u * cstep]));
          }
          pad_i[u] = mul_rn(pad_i[u], gp);
        }
      }
      E t[kV], sq[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        t[u] = sq[u] = (E)0;
        if constexpr (kCplx) t[kU + u] = (E)0;
        if (!(ok >> u & 1)) continue;
        const Weight<kCplx, Fp> wi =
            Weight<kCplx, Fp>::load(w, i * plane + at0 + u * cstep).finite();
        const Weight<kCplx, Fp> relw = wi.scale(mul_rn(jac[u], pad_i[u]));
        score[u] = add_rn(score[u], mul_rn((Fp)wi.abs(), pad_i[u]));
        if (on >> u & 1) {
          t[u] = re_of(relw);
          if constexpr (kCplx) t[kU + u] = relw.im;
        }
        E r = relw.abs();             // float for a complex relw, as the reference's
        r = r > (E)1e17 ? (E)1e17 : r;   // NaN passes through, as torch.clamp
        sq[u] = mul_rn(r, r);
      }
      // the sums first: t's registers are free for the histogram's CAS loops
      const double part = tree_sums(t);
      const int q = (threadIdx.x & 31) / (32 / kV);
      const long long bt = bt0 + (q % kU) * step;
      if ((threadIdx.x & (32 / kV - 1)) == 0 && first && bt < BT)
        obs_rows[((bt * gridDim.x + blockIdx.x) * kWarps + warp) * kParts * N + kParts * i +
                 q / kU] = part;
      for (int k = 0; k < S; ++k) {
        const int off = slots[kSlotFields * k + kHist];
        if (off < 0 || !used[k * N + i]) continue;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int bin = ok >> u & 1 ? off + gidx[k * plane + at0 + u * cstep] - hlo : -1;
          if (bin >= 0 && bin < HW) atomicAdd(hist_s + bin, (double)sq[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      Fp wj = div_rn(score[u], denom[u]);
      wj = wj > (Fp)1e17 ? (Fp)1e17 : wj;
      if (ok >> u & 1) v2 += (double)mul_rn(wj, wj);
    }
  }

  // per-cube second moments and the histogram's flush, as vplus_reduce_kernel's
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_down_sync(kFull, v2, o);
    const int kup = __shfl_down_sync(kFull, cb, o);
    if (lane + o < 32 && kup == cb) v2 += up;
  }
  const int kprev = __shfl_up_sync(kFull, cb, 1);
  if (first && cb >= 0 && (lane == 0 || kprev != cb)) atomicAdd(sig + cb, v2);
  __syncthreads();
  for (int q = threadIdx.x; q < HW && hlo + q < H; q += blockDim.x)
    if (hist_s[q] != 0.0) atomicAdd(hist + hlo + q, hist_s[q]);
}

// relw_i = w_i * (jac * pad_i) of every sample (vplus_reduce_kernel's
// density, in its order; see the head of the file).  Block x takes chunk
// x / nspan, its quads from (x % nspan) * kRelwSpan.  What bounds it:
// device-memory bytes, w and relw (4 or 8 bytes each an integrand) and gidx
// (4 a slot); cube, cfac, the tables and the layout stay in cache (staged
// in shared memory once a block, the layout made the kernel 3 % slower at
// phase 6g, PERF.md).
template <typename Fp, bool kCplx>
__global__ void __launch_bounds__(kRelwThreads, f64_halved<Fp>(kRelwBlocks)) vplus_relw_kernel(
    const elem_t<kCplx, Fp>* __restrict__ w, const int* __restrict__ gidx,
    const int* __restrict__ cube, const float* __restrict__ cfac,
    const Fp* __restrict__ tab, const int* __restrict__ meta, int N, int S,
    int P, int M, long long BT, int c, int nspan, int vec, elem_t<kCplx, Fp>* __restrict__ relw) {
  const int* slots = meta;                     // [S, 8]
  const int* pad = slots + kSlotFields * S;    // [N, P]
  const int* pair_slots = pad + N * P;         // [P, M]
  const long long plane = BT * c;
  const long long bt = blockIdx.x / nspan;
  const int s0 = ((int)(blockIdx.x % nspan) * kRelwThreads + threadIdx.x) * kQuad;
  if (s0 >= c) return;
  const int n = min(c - s0, kQuad);
  // compared on s0, not on n (vegas_mixed.cu: a test built from n let a
  // lane past the chunk's end store there)
  const bool full = vec && s0 + kQuad <= c;
  const long long at = bt * c + s0;

  int cb[kQuad];
  load_quad(cube + s0, n, full, cb);
  Fp prob[kQuad], pass[kQuad];
  bool any_pass = false;
#pragma unroll
  for (int v = 0; v < kQuad; ++v) prob[v] = pass[v] = (Fp)1;
  for (int k = 0; k < S; ++k) {
    const int* f = slots + kSlotFields * k;
    const bool disc = f[kKind] == kDisc;
    any_pass |= disc;
    int g[kQuad];
    load_quad(gidx + k * plane + at, n, full, g);
#pragma unroll
    for (int v = 0; v < kQuad; ++v) {
      const Fp rho = slot_rho(f, tab, g[v]);
      if (disc) pass[v] = mul_rn(pass[v], rho);
      else prob[v] = mul_rn(prob[v], rho);
    }
  }
  Fp jac[kQuad];
#pragma unroll
  for (int v = 0; v < kQuad; ++v) {
    Fp dens = mul_rn((Fp)cfac[cb[v]], prob[v]);
    if (any_pass) dens = mul_rn(dens, pass[v]);
    jac[v] = div_rn((Fp)1, dens);
  }
  for (int i = 0; i < N; ++i) {
    Fp pad_i[kQuad];
#pragma unroll
    for (int v = 0; v < kQuad; ++v) pad_i[v] = (Fp)1;
    for (int g = 0; g < P; ++g) {
      if (!pad[i * P + g]) continue;
      Fp gp[kQuad];
#pragma unroll
      for (int v = 0; v < kQuad; ++v) gp[v] = (Fp)1;
      for (int mm = 0; mm < M; ++mm) {
        const int k = pair_slots[g * M + mm];
        if (k < 0) break;
        int b[kQuad];
        load_quad(gidx + k * plane + at, n, full, b);
#pragma unroll
        for (int v = 0; v < kQuad; ++v)
          gp[v] = mul_rn(gp[v], slot_rho(slots + kSlotFields * k, tab, b[v]));
      }
#pragma unroll
      for (int v = 0; v < kQuad; ++v) pad_i[v] = mul_rn(pad_i[v], gp[v]);
    }
    Weight<kCplx, Fp> r[kQuad];
    load_weights(w, i * plane + at, n, full, r);
#pragma unroll
    for (int v = 0; v < kQuad; ++v) r[v] = r[v].finite().scale(mul_rn(jac[v], pad_i[v]));
    store_weights(relw, i * plane + at, n, full, r);
  }
}

// The reduce's grid: (nspan, groups, nwin), groups of chunks enough for
// kWaves waves of the blocks the card holds at once
template <typename Kernel>
int reduce_grid(Kernel kernel, long long BT, int c, int H, int hist_smem, dim3* grid,
                size_t* smem) {
  const int nspan = (c + kSpan - 1) / kSpan;
  const int nwin = hist_smem ? 1 : (H + kWindow - 1) / kWindow;
  *smem = (size_t)(hist_smem ? H : kWindow) * sizeof(double);
  int per_sm = 0;
  const int err = blocks_per_sm(kernel, kThreads, *smem, &per_sm);
  if (err) return err;
  long long groups = ((long long)kWaves * per_sm * num_sms() + nspan * nwin - 1) /
                     ((long long)nspan * nwin);
  if (groups > BT) groups = BT;
  if (groups > 65535) groups = 65535;
  if (groups < 1) groups = 1;
  *grid = dim3((unsigned)nspan, (unsigned)groups, (unsigned)nwin);
  return 0;
}

template <typename Fp, bool kCplx, int kMode, bool kMask>
int launch(const void* w, const void* gidx, const void* cube, const void* cfac,
           const void* tab, const void* meta, int N, int S, int P, int M, long long BT,
           int c, int H, int hist_smem, const void* mobs, int ncomp, int mf, int t0, int T,
           const void* shift, void* obs_rows, void* sig, void* hist, void* stream) {
  auto kernel = vplus_reduce_kernel<Fp, kCplx, kMode, kMask>;
  using E = elem_t<kCplx, Fp>;
  dim3 grid;
  size_t smem = 0;
  const int err = reduce_grid(kernel, BT, c, H, hist_smem, &grid, &smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const E*)w, (const int*)gidx, (const int*)cube, (const float*)cfac,
      (const Fp*)tab, (const int*)meta, N, S, P, M, BT, c, H, hist_smem,
      (const E*)mobs, ncomp, mf, t0, T, (const int*)shift, (double*)obs_rows, (double*)sig,
      (double*)hist);
  return (int)cudaGetLastError();
}

template <typename Fp, bool kCplx, bool kMask>
int launch_chunks(const void* w, const void* gidx, const void* cube, const void* cfac,
                  const void* tab, const void* meta, int N, int S, int P, int M, long long BT,
                  int c, int H, int hist_smem, const void*, int, int mf, int t0, int T,
                  const void* shift, void* obs_rows, void* sig, void* hist, void* stream) {
  auto kernel = vplus_reduce_chunks_kernel<Fp, kCplx, kMask>;
  dim3 grid;
  size_t smem = 0;
  const int err = reduce_grid(kernel, BT, c, H, hist_smem, &grid, &smem);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const elem_t<kCplx, Fp>*)w, (const int*)gidx, (const int*)cube, (const float*)cfac,
      (const Fp*)tab, (const int*)meta, N, S, P, M, BT, c, H, hist_smem, mf, t0, T,
      (const int*)shift, (double*)obs_rows, (double*)sig, (double*)hist);
  return (int)cudaGetLastError();
}

template <typename Fp, bool kCplx>
int reduce_entry(const void* w, const void* gidx, const void* cube, const void* cfac,
                 const void* tab, const void* meta, int N, int S, int P, int M, long long BT,
                 int c, int ncubes, int H, int hist_smem, int span, int warps,
                 const void* mobs, int ncomp, int mf, int t0, int T, const void* shift,
                 void* obs_rows, void* sig, void* hist, void* stream) {
  if (span != kSpan || warps != kWarps || c < 1 || ncubes < 1 || mf < 1 || t0 < 0 ||
      T < 1 || BT % T != 0 || ncomp < 1 || (!mobs && ncomp != (kCplx ? 2 * N : N)))
    return (int)cudaErrorInvalidValue;      // the wrapper sized obs_rows otherwise
  // the default observables: vplus_reduce_kernel for real w at float32,
  // vplus_reduce_chunks_kernel for complex w and at float64
  auto run = launch<Fp, kCplx, kMeasure, false>;
  if (mobs) {
    if (mf > 1) run = launch<Fp, kCplx, kMeasure, true>;
  } else if constexpr (kCplx || sizeof(Fp) == 8) {
    run = mf > 1 ? launch_chunks<Fp, kCplx, true> : launch_chunks<Fp, kCplx, false>;
  } else {
    run = mf > 1 ? launch<Fp, false, kDefault, true> : launch<Fp, false, kDefault, false>;
  }
  return run(w, gidx, cube, cfac, tab, meta, N, S, P, M, BT, c, H, hist_smem, mobs, ncomp,
             mf, t0, T, shift, obs_rows, sig, hist, stream);
}

template <typename Fp, bool kCplx>
int relw_entry(const void* w, const void* gidx, const void* cube, const void* cfac,
               const void* tab, const void* meta, int N, int S, int P, int M, long long BT,
               int c, int span, int warps, void* relw, void* stream) {
  if (span != kRelwSpan || warps != kRelwThreads / 32 || c < 1 || BT < 1)
    return (int)cudaErrorInvalidValue;
  const int nspan = (c + kRelwSpan - 1) / kRelwSpan;
  if (BT * nspan > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = c % kQuad == 0 &&
                  ((uintptr_t)w | (uintptr_t)gidx | (uintptr_t)cube | (uintptr_t)relw) % 16 == 0;
  using E = elem_t<kCplx, Fp>;
  vplus_relw_kernel<Fp, kCplx>
      <<<(unsigned)(BT * nspan), kRelwThreads, 0, (cudaStream_t)stream>>>(
          (const E*)w, (const int*)gidx, (const int*)cube, (const float*)cfac, (const Fp*)tab,
          (const int*)meta, N, S, P, M, BT, c, nspan, vec, (E*)relw);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCI_VPLUS_REDUCE(name, Fp, kCplx)                                                  \
  extern "C" int name(const void* w, const void* gidx, const void* cube, const void* cfac,   \
                      const void* tab, const void* meta, int N, int S, int P, int M,          \
                      long long BT, int c, int ncubes, int H, int hist_smem, int span,        \
                      int warps, const void* mobs, int ncomp, int mf, int t0, int T,          \
                      const void* shift, void* obs_rows, void* sig, void* hist, void* stream) { \
    return reduce_entry<Fp, kCplx>(w, gidx, cube, cfac, tab, meta, N, S, P, M, BT, c, ncubes, \
                                   H, hist_smem, span, warps, mobs, ncomp, mf, t0, T, shift,  \
                                   obs_rows, sig, hist, stream);                              \
  }

#define MCI_VPLUS_RELW(name, Fp, kCplx)                                                    \
  extern "C" int name(const void* w, const void* gidx, const void* cube, const void* cfac,   \
                      const void* tab, const void* meta, int N, int S, int P, int M,          \
                      long long BT, int c, int span, int warps, void* relw, void* stream) {   \
    return relw_entry<Fp, kCplx>(w, gidx, cube, cfac, tab, meta, N, S, P, M, BT, c, span,    \
                                 warps, relw, stream);                                        \
  }

// w complex64 [N, B, T, c] in the _complex entries, read as interleaved
// (re, im) float pairs; tab float64 in the _f64 entries, and real w, m and
// relw with it
MCI_VPLUS_REDUCE(mci_vplus_reduce, float, false)
MCI_VPLUS_REDUCE(mci_vplus_reduce_complex, float, true)
MCI_VPLUS_REDUCE(mci_vplus_reduce_f64, double, false)
MCI_VPLUS_REDUCE(mci_vplus_reduce_complex_f64, double, true)
MCI_VPLUS_RELW(mci_vplus_relw, float, false)
MCI_VPLUS_RELW(mci_vplus_relw_complex, float, true)
MCI_VPLUS_RELW(mci_vplus_relw_f64, double, false)
MCI_VPLUS_RELW(mci_vplus_relw_complex_f64, double, true)
#undef MCI_VPLUS_REDUCE
#undef MCI_VPLUS_RELW
