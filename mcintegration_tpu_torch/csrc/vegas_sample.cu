// vegas_sample: the stratified Vegas draw of the :vegas solver.
//
// Replaces the draw half of mcintegration_tpu/ops/pallas_vegas.py:build_run_all
// (lines 396-441): per (slot, block, chunk) a random strata permutation
// perm(p) = (a*p + s) mod nb, the map lookup, and x = grid[perm] + dy*inc[perm]
// for every stratum p and sample q; per (slot, block, chunk, p) also
// invp = nb*inc[perm] (1/probability) and perm itself, which vegas_reduce
// needs for the Jacobian and the histogram.
//
// Random bits: the counter hash of pallas_vegas.py:_make_rng's interpret path
// (lines 79-91), bit for bit, so a given kd reproduces the JAX kernel run in
// interpret mode and the plain torch version in ops/rng.py:
//   k1 = mix32(kd[b,0] ^ t*0x9E3779B9), k2 = mix32(kd[b,1] + t),
//   draw(i, c) = mix32(mix32(i ^ k1) + k2 + c*0x85EBCA6B),
//   s = (draw(0, 3k+1) & 0x7FFFFFFF) % nb, a = atab[k, (draw(0, 3k+2) & ...) % 64],
//   dy = ((draw(p*m + q, 3k+3) & 0xFFFFFF) + 0.5) * 2^-24.
//
// What bounds it on the card: device-memory bytes, one 4-byte store of x per
// sample (the grid tables, 8 bytes per bin, stay in L1/L2), and close behind
// them the integer work of the two lowbias32 hashes of every draw (19
// operations a value against 4 bytes: at the card's INT32 rate that is 0.95
// of the time the bytes take).  So the design cuts every instruction a draw
// does not need:
// - a thread block belongs to one (slot, block, chunk) group: one thread
//   forms the group's keys, s, a, salt term and map rows once and shares
//   them through shared memory (the group's index decoded in 32 bits);
// - where m % 4 == 0 a thread takes kQuads quads of four consecutive draws
//   of one stratum row: p and the permuted stratum come once a quad, x
//   leaves in a 16-byte streaming store (the integrand reads it from device
//   memory, after far more than L2 holds), and neighbouring threads store
//   neighbouring quads (scalar draws, one a thread at a time, where
//   m % 4 != 0);
// - e / m and (a*p + s) mod nb are a multiply and a shift each (divide.cuh),
//   with the constants formed by the launcher: a*p + s < nb^2 <= 2^30 under
//   MAX_STRATA (ops/vegas_kernels.py), inside the divisor's exact range;
// - invp and perm are written by the thread whose quad starts a row, so
//   only the quads at q = 0 take that branch.
//
// Deliberately simple: a plain gather replaces the TPU's one-hot MXU lookup;
// wgmma and TMA have no role here (no matrix product, no tile reuse).  Fusing
// the draw with the integrand, so x never reaches device memory, is later work.
//
// Built with --fmad=false (ops/_build.py); the explicit _rn intrinsics below
// pin the rounding anyway, so x matches the plain torch version bit for bit.
//
// float64 (integrate(dtype=torch.float64), mci_vegas_sample_f64): the same
// body with grid, inc, x and invp of double, the reference's float64 law
// (mcintegration_tpu/solvers/vegas.py:227-236 under x64): dy stays the
// float32 uniform above (ops/grid.py:153-162 of the JAX package), and x =
// grid + double(dy)*inc and invp = nb*inc are formed in float64 with
// __dadd_rn and __dmul_rn.  The bits drawn, s, a and so perm are the float32
// launch's for the same kd.  A quad of x leaves in two 16-byte stores, and
// the instantiation may take 64 registers a thread (4 blocks an SM).

#include "chain_common.cuh"
#include "divide.cuh"

namespace {

constexpr int kNMult = 64;       // multiplier-table width (solvers/vegas.py)
constexpr int kThreads = 256;
// at most 32 registers a thread (8 blocks an SM); the float64 body 64
template <typename R> constexpr int blocks_per_sm() { return sizeof(R) == 4 ? 8 : 4; }
constexpr int kQuads = 8;        // quads of draws (or 4 scalar draws) a thread takes a tile

// What a group's draws share, formed once per thread block.
struct Group {
  uint32_t k1, kc;   // kc = k2 + (3k + 3)*0x85EBCA6B: the draw's salt term
  int a, s, leaf;
};

// The draw of flat index i: its x from the stratum's map row (g, dx).
template <typename R>
__device__ __forceinline__ R draw_x(uint32_t i, const Group& G, R g, R dx) {
  const uint32_t u = mix32(mix32(i ^ G.k1) + G.kc);
  const float dy = __fmul_rn(__fadd_rn((float)(u & 0xFFFFFFu), 0.5f),
                             5.9604644775390625e-08f);   // 2^-24
  return add_rn(g, mul_rn((R)dy, dx));
}

// Quad Q of the chunk's x, in streaming stores: one float4, or two double2
__device__ __forceinline__ void store_x(float* xg, uint32_t Q, float a, float b, float c,
                                        float d) {
  __stcs(reinterpret_cast<float4*>(xg) + Q, make_float4(a, b, c, d));
}
__device__ __forceinline__ void store_x(double* xg, uint32_t Q, double a, double b, double c,
                                        double d) {
  __stcs(reinterpret_cast<double2*>(xg) + 2 * Q, make_double2(a, b));
  __stcs(reinterpret_cast<double2*>(xg) + 2 * Q + 1, make_double2(c, d));
}

// blockIdx.x is the group (slot k, block b, chunk t) with nb*m draws laid
// out [nb, m]; blockIdx.y strides over the group's tiles of kThreads*kQuads
// quads (kVec) or scalar quads of draws.  (mulm, shm) divide by m/4 (kVec)
// or by m, (mulnb, shnb) by nb.
template <typename R, bool kVec>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<R>())
vegas_sample_kernel(const uint32_t* __restrict__ kd, int t0, uint32_t B, uint32_t T, int nb,
                    int m, uint32_t mulm, int shm, uint32_t mulnb, int shnb,
                    const int32_t* __restrict__ atab, const R* __restrict__ grid,
                    const R* __restrict__ inc, const int32_t* __restrict__ slot_leaf,
                    R* __restrict__ x, R* __restrict__ invp,
                    int32_t* __restrict__ perm_out) {
  __shared__ Group sg;
  const uint32_t g = blockIdx.x;
  if (threadIdx.x == 0) {
    const uint32_t bt = g % (B * T);
    const uint32_t k = g / (B * T), b = bt / T;
    const uint32_t t = (uint32_t)t0 + (bt - b * T);
    const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
    const uint32_t k2 = mix32(kd[2 * b + 1] + t);
    const uint32_t base = mix32(k1) + k2;     // draw index 0
    const uint32_t c = 3u * k;
    const int s = (int)((mix32(base + (c + 1u) * 0x85EBCA6Bu) & 0x7FFFFFFFu) % (uint32_t)nb);
    const int j = (int)(mix32(base + (c + 2u) * 0x85EBCA6Bu) & 0x7FFFFFFFu) % kNMult;
    sg = Group{k1, k2 + (c + 3u) * 0x85EBCA6Bu, atab[k * kNMult + j], s, slot_leaf[k]};
  }
  __syncthreads();
  const Group G = sg;
  const R* gr = grid + (long long)G.leaf * nb;
  const R* ic = inc + (long long)G.leaf * nb;
  const R fnb = (R)nb;
  const uint32_t chunk = (uint32_t)nb * (uint32_t)m;
  R* xg = x + (long long)g * chunk;
  R* ig = invp + (long long)g * nb;
  int32_t* pg = perm_out + (long long)g * nb;

  if (kVec) {
    const uint32_t nq = chunk / 4u, qrow = (uint32_t)m / 4u;
    for (uint32_t q0 = blockIdx.y * (kThreads * kQuads); q0 < nq;
         q0 += gridDim.y * (kThreads * kQuads)) {
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        const uint32_t Q = q0 + i * kThreads + threadIdx.x;
        if (Q >= nq) break;
        const uint32_t p = divide(Q, mulm, shm);
        const uint32_t r = (uint32_t)G.a * p + (uint32_t)G.s;
        const int pm = (int)(r - divide(r, mulnb, shnb) * (uint32_t)nb);
        const R gv = gr[pm], dx = ic[pm];
        const uint32_t e = 4u * Q;
        store_x(xg, Q, draw_x(e, G, gv, dx), draw_x(e + 1u, G, gv, dx),
                draw_x(e + 2u, G, gv, dx), draw_x(e + 3u, G, gv, dx));
        if (Q == p * qrow) {   // this quad starts row p
          ig[p] = mul_rn(fnb, dx);
          pg[p] = pm;
        }
      }
    }
  } else {
    for (uint32_t e0 = blockIdx.y * (kThreads * kQuads * 4); e0 < chunk;
         e0 += gridDim.y * (kThreads * kQuads * 4)) {
#pragma unroll
      for (int i = 0; i < 4 * kQuads; ++i) {
        const uint32_t e = e0 + i * kThreads + threadIdx.x;
        if (e >= chunk) break;
        const uint32_t p = divide(e, mulm, shm);
        const uint32_t r = (uint32_t)G.a * p + (uint32_t)G.s;
        const int pm = (int)(r - divide(r, mulnb, shnb) * (uint32_t)nb);
        const R dx = ic[pm];
        xg[e] = draw_x(e, G, gr[pm], dx);
        if (e == p * (uint32_t)m) {
          ig[p] = mul_rn(fnb, dx);
          pg[p] = pm;
        }
      }
    }
  }
}

template <typename R>
int sample_entry(const void* kd, int t0, int B, int T, int nb, int m, int nslots,
                 const void* atab, const void* grid, const void* inc, const void* slot_leaf,
                 void* x, void* invp, void* perm, void* stream) {
  const long long groups = (long long)nslots * B * T;
  const long long chunk = (long long)nb * m;
  // 16-byte stores of x: every quad of a row lies in it when m % 4 == 0
  const bool vec = m % 4 == 0 && (uintptr_t)x % 16 == 0;
  // the divisor is exact below 2^31: the scalar path's flat index, and the
  // group index in 32 bits
  if (B < 1 || T < 1 || nb < 1 || m < 1 || nslots < 1 || groups > 0x7fffffffLL ||
      chunk >= (vec ? (1LL << 32) : (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  uint32_t mulm, mulnb;
  int shm, shnb;
  divisor((uint32_t)(vec ? m / 4 : m), mulm, shm);
  divisor((uint32_t)nb, mulnb, shnb);
  const long long per_tile = (long long)kThreads * kQuads * (vec ? 1 : 4);
  long long tiles = ((vec ? chunk / 4 : chunk) + per_tile - 1) / per_tile;
  if (tiles > 65535) tiles = 65535;
  const dim3 grid_dim((unsigned)groups, (unsigned)tiles);
  const cudaStream_t s = (cudaStream_t)stream;
#define MCI_VEGAS_SAMPLE_ARGS                                                          \
  (const uint32_t*)kd, t0, (uint32_t)B, (uint32_t)T, nb, m, mulm, shm, mulnb, shnb,   \
      (const int32_t*)atab, (const R*)grid, (const R*)inc,                             \
      (const int32_t*)slot_leaf, (R*)x, (R*)invp, (int32_t*)perm
  if (vec)
    vegas_sample_kernel<R, true><<<grid_dim, kThreads, 0, s>>>(MCI_VEGAS_SAMPLE_ARGS);
  else
    vegas_sample_kernel<R, false><<<grid_dim, kThreads, 0, s>>>(MCI_VEGAS_SAMPLE_ARGS);
#undef MCI_VEGAS_SAMPLE_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mci_vegas_sample(const void* kd, int t0, int B, int T, int nb,
                                int m, int nslots, const void* atab,
                                const void* grid, const void* inc,
                                const void* slot_leaf, void* x, void* invp,
                                void* perm, void* stream) {
  return sample_entry<float>(kd, t0, B, T, nb, m, nslots, atab, grid, inc, slot_leaf, x, invp,
                             perm, stream);
}

// grid, inc, x and invp float64
extern "C" int mci_vegas_sample_f64(const void* kd, int t0, int B, int T, int nb,
                                    int m, int nslots, const void* atab,
                                    const void* grid, const void* inc,
                                    const void* slot_leaf, void* x, void* invp,
                                    void* perm, void* stream) {
  return sample_entry<double>(kd, t0, B, T, nb, m, nslots, atab, grid, inc, slot_leaf, x, invp,
                              perm, stream);
}

extern "C" const char* mci_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
