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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;               // at most 64 registers a thread
constexpr int kUnroll = 4;                    // quads a lane loads before adding
constexpr int kSmemDoubles = 2048;            // whsum of a tile's rows: at most 16 KB

__device__ __forceinline__ float row_jac(const float* __restrict__ invp, int nslots,
                                         long long R, long long r) {
  float jac = invp[r];
  for (int k = 1; k < nslots; ++k) jac = __fmul_rn(jac, invp[k * R + r]);
  return jac;
}

// factor_i of row r, in the plain version's float32 order.
__device__ __forceinline__ float integrand_factor(float jac, const float* __restrict__ invp,
                                                  const int32_t* __restrict__ pad,
                                                  const int32_t* __restrict__ pair_slots,
                                                  int i, int npair, int maxmem,
                                                  long long R, long long r) {
  float f = jac;
  for (int g = 0; g < npair; ++g) {
    if (!pad[i * npair + g]) continue;
    float gp = __fdiv_rn(1.0f, invp[pair_slots[g * maxmem] * R + r]);
    for (int mm = 1; mm < maxmem; ++mm) {
      const int k = pair_slots[g * maxmem + mm];
      if (k < 0) break;
      gp = __fmul_rn(gp, __fdiv_rn(1.0f, invp[k * R + r]));
    }
    f = __fmul_rn(f, gp);
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

// What a unit adds per sample: kObs the column's values (an m column),
// kWeighted w * factor and the histogram term (w in the default mode),
// kHist the histogram term alone (w beside a measure).
enum Terms { kObs, kWeighted, kHist };

template <int kTerms>
__device__ __forceinline__ void add_value(float v, float f, float jac, double& so, double& sh) {
  if (kTerms == kObs) {
    so += (double)v;
    return;
  }
  if (kTerms == kWeighted) so += (double)__fmul_rn(v, f);
  float a = __fmul_rn(fabsf(v), jac);
  a = a > 1e17f ? 1e17f : a;   // NaN passes through, as torch.clamp
  sh += (double)__fmul_rn(a, a);
}

// Add the quads j0, j0 + G, ... (kUnroll of them, those below nq) in order.
template <bool kVec, int kTerms>
__device__ __forceinline__ void add_batch(const float4 (&v)[kUnroll], int j0, int G, int nq,
                                          int m, float f, float jac, double& so, double& sh) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = j0 + k * G;
    if (j >= nq) break;
    const int q = 4 * j;
    add_value<kTerms>(v[k].x, f, jac, so, sh);
    if (kVec || q + 1 < m) add_value<kTerms>(v[k].y, f, jac, so, sh);
    if (kVec || q + 2 < m) add_value<kTerms>(v[k].z, f, jac, so, sh);
    if (kVec || q + 3 < m) add_value<kTerms>(v[k].w, f, jac, so, sh);
  }
}

// shared memory: whsum [RT, N] double.
// A tile is RT rows; its units are (row, column) pairs, row-fastest, with
// columns 0..N-1 the integrands' w and, given m, N..N+ncomp-1 its components.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
vegas_reduce_kernel(const float* __restrict__ w, const float* __restrict__ invp,
                    const int32_t* __restrict__ perm, const int32_t* __restrict__ pad,
                    const int32_t* __restrict__ pair_slots, const int32_t* __restrict__ used,
                    int N, int nslots, int npair, int maxmem, long long R, int nb, int m,
                    const float* __restrict__ mobs, int ncomp, int G, int RT,
                    double* __restrict__ obs_rows, double* __restrict__ hrow) {
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
    const float* src = wcol ? w + ((long long)col * R + r) * m
                            : mobs + ((long long)(col - N) * R + r) * m;
    double so = 0.0, sh = 0.0;
    if (ok) {
      float jac = 0.0f, f = 0.0f;
      for (int j0 = lg; j0 < nq; j0 += kUnroll * G) {
        float4 v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int j = j0 + k * G;
          if (j < nq) v[k] = load_quad<kVec>(src, j, m);
        }
        if (j0 == lg && wcol) {   // the factors, while the first loads are out
          jac = row_jac(invp, nslots, R, r);
          if (terms == kWeighted)
            f = integrand_factor(jac, invp, pad, pair_slots, col, npair, maxmem, R, r);
        }
        if (terms == kObs)
          add_batch<kVec, kObs>(v, j0, G, nq, m, f, jac, so, sh);
        else if (terms == kWeighted)
          add_batch<kVec, kWeighted>(v, j0, G, nq, m, f, jac, so, sh);
        else
          add_batch<kVec, kHist>(v, j0, G, nq, m, f, jac, so, sh);
      }
    }
    for (int o = G >> 1; o > 0; o >>= 1) {   // the group's butterfly
      so += __shfl_xor_sync(0xffffffffu, so, o);
      sh += __shfl_xor_sync(0xffffffffu, sh, o);
    }
    if (!ok) continue;
    if (lg == 0 && terms != kHist) obs_rows[r * ncomp + (wcol ? col : col - N)] = so;
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
// factor[i] in shared memory, in the plain version's float32 order.
__device__ __forceinline__ float row_factors(const float* __restrict__ invp,
                                             const int32_t* __restrict__ pad,
                                             const int32_t* __restrict__ pair_slots,
                                             int N, int nslots, int npair, int maxmem,
                                             long long R, long long r, float* factor) {
  const float jac = row_jac(invp, nslots, R, r);
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    factor[i] = integrand_factor(jac, invp, pad, pair_slots, i, npair, maxmem, R, r);
  __syncthreads();
  return jac;
}

// shared memory: factor [N] float
__global__ void vegas_relw_kernel(const float* __restrict__ w,
                                  const float* __restrict__ invp,
                                  const int32_t* __restrict__ pad,
                                  const int32_t* __restrict__ pair_slots,
                                  int N, int nslots, int npair, int maxmem,
                                  long long R, int m, float* __restrict__ relw) {
  extern __shared__ float factor[];
  const long long r = blockIdx.x;
  row_factors(invp, pad, pair_slots, N, nslots, npair, maxmem, R, r, factor);
  for (int i = 0; i < N; ++i) {
    const long long base = ((long long)i * R + r) * m;
    const float f = factor[i];
    for (int q = threadIdx.x; q < m; q += blockDim.x)
      relw[base + q] = __fmul_rn(w[base + q], f);
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

template <bool kVec>
cudaError_t launch_reduce(const float* w, const float* invp, const int32_t* perm,
                          const int32_t* pad, const int32_t* pair_slots, const int32_t* used,
                          int N, int nslots, int npair, int maxmem, long long R, int nb, int m,
                          const float* mobs, int ncomp, double* obs_rows, double* hrow,
                          cudaStream_t stream) {
  const int G = group_lanes(m);
  int RT = kWarps * (32 / G);                   // a row per group at one column
  if (RT * N > kSmemDoubles) RT = kSmemDoubles / N > 1 ? kSmemDoubles / N : 1;
  const size_t smem = (size_t)RT * N * sizeof(double);
  const long long ntiles = (R + RT - 1) / RT;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  vegas_reduce_kernel<kVec><<<(unsigned)ntiles, kThreads, smem, stream>>>(
      w, invp, perm, pad, pair_slots, used, N, nslots, npair, maxmem, R, nb, m, mobs,
      mobs ? ncomp : N, G, RT, obs_rows, hrow);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mci_vegas_reduce(const void* w, const void* invp,
                                const void* perm, const void* pad,
                                const void* pair_slots, const void* used,
                                int N, int nslots, int npair, int maxmem,
                                long long R, int nb, int m, const void* mobs,
                                int ncomp, void* obs_rows, void* hrow, void* stream) {
  if (N < 1 || nslots < 1 || R < 1 || nb < 1 || m < 1 || (mobs && ncomp < 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads: every row starts on a quad when m % 4 == 0
  const bool vec = m % 4 == 0 && (uintptr_t)w % 16 == 0 && (uintptr_t)mobs % 16 == 0;
  auto run = launch_reduce<false>;
  if (vec) run = launch_reduce<true>;
  return (int)run((const float*)w, (const float*)invp, (const int32_t*)perm,
                  (const int32_t*)pad, (const int32_t*)pair_slots, (const int32_t*)used,
                  N, nslots, npair, maxmem, R, nb, m, (const float*)mobs, ncomp,
                  (double*)obs_rows, (double*)hrow, (cudaStream_t)stream);
}

extern "C" int mci_vegas_relw(const void* w, const void* invp, const void* pad,
                              const void* pair_slots, int N, int nslots, int npair,
                              int maxmem, long long R, int m, void* relw, void* stream) {
  vegas_relw_kernel<<<(unsigned)R, row_threads(m), (size_t)N * sizeof(float),
                      (cudaStream_t)stream>>>(
      (const float*)w, (const float*)invp, (const int32_t*)pad,
      (const int32_t*)pair_slots, N, nslots, npair, maxmem, R, m, (float*)relw);
  return (int)cudaGetLastError();
}
