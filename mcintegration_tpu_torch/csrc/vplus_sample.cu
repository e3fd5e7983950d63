// vplus_sample: the draw of the :vegasplus solver.
//
// Replaces the sampling half of mcintegration_tpu/ops/pallas_vplus.py:
// build_vplus_run_all (lines 251-272), with the law of the JAX package's XLA
// route (mcintegration_tpu/solvers/vegasplus.py:184-212).  Sample s of chunk
// t of block b lies in the hypercube cube[s] (the samples of a chunk are
// cube-major, the same layout in every chunk).  Per kernel slot k, with u the
// slot's uniform from the counter hash:
//   Continuous (stratified dim d, stride = nstrat^d):
//     coord = (cube / stride) % nstrat,  y = (coord + u) / nstrat,
//     iy = clip(int(y*ninc)),  x = grid[iy] + (y*ninc - iy)*inc[iy]
//   Discrete (a passenger, not stratified): gidx = #{j: u >= cdf[j+1]},
//     clamped to nbin-1, x = lower + gidx (int32 bits)
// and the outputs are x[k, b, t, s] and the bin gidx[k, b, t, s]; the reduce
// kernel reads the densities back from the tables at gidx.  y*ninc may land
// one bin into the neighbouring cube at a cube's edge (ninc need not be a
// multiple of nstrat); the density uses the bin actually hit, so the
// estimator stays unbiased, as in the reference.
//
// The TPU kernel gives each 128-wide lane one cube and picks the bin by an
// R-way select on a coarsened map, because a TPU has no gather; here the
// full map is gathered and any nstrat and any counts are served.
//
// Random bits (ops/rng.py): k1 = mix32(kd[b,0] ^ t*0x9E3779B9),
// k2 = mix32(kd[b,1] + t), draw of slot k = mix32(mix32(s ^ k1) + k2 +
// salt_k*0x85EBCA6B), uniform = ((bits >> 8) + 0.5) * 2^-24.
//
// What bounds it on the card: device-memory bytes, 8 bytes written per
// sample and slot (x and gidx); the tables and cube[] stay in cache.  But a
// draw's instructions come close to that bound too: at the card's issue rate
// the bytes leave about 70 instructions a draw, and a draw needs a hash, an
// IEEE division for y and the map's gathers.  So the design cuts every
// instruction a draw does not need:
// - a thread takes kPerThread consecutive samples of a chunk: their cube
//   indices come in one 16-byte load, and x and gidx leave in 16-byte stores
//   (scalar loads and stores where c % 4 != 0);
// - a sample's stratified coordinates come from one pass of successive
//   divisions of its cube index by nstrat, each a multiply and a shift by
//   constants the launch computes on the host (divide.cuh), not two
//   runtime integer divisions per slot: the layout gives the d-th stratified
//   slot the stride nstrat^d, in slot order (ops/vplus_kernels.py:
//   VplusLayout.build);
// - the slot rows are staged in shared memory once per block (one generic
//   slot loop: unrolled for 3 slots it was no faster, PERF.md);
// - the map draw forms no density (the reduce kernel reads it from the
//   tables), so the IEEE division map_draw spends on prob is gone;
// - index math inside a chunk is 32-bit; a (slot, chunk) row's offset is
//   formed once, in 64 bits.
//
// Built with --fmad=false (ops/_build.py); the _rn intrinsics pin every
// rounding, so x and gidx match the plain version bit for bit.
//
// float64 (integrate(dtype=torch.float64), mci_vplus_sample_f64): the body
// templated on Fp, the type of tab and x, with the reference's float64 law
// (mcintegration_tpu/solvers/vegasplus.py:184-212 under x64): y = (coord +
// u)/nstrat, y*ninc and its fraction dy stay float32 as there (:190), x =
// grid[iy] + double(dy)*inc[iy] in float64, a Discrete passenger's CDF is
// compared in float64 and its int32 value is stored sign-extended in 64
// bits.  So a Continuous slot's bin is the float32 launch's for the same
// kd.  Four samples' x leave in two 16-byte stores; the float64 body's
// bound allows 80 registers a thread (3 blocks an SM).

#include "divide.cuh"
#include "vplus_common.cuh"

namespace {

constexpr int kThreads = 256;
// at most 64 registers a thread (4 blocks an SM); the float64 body 80
template <typename Fp> constexpr int blocks_per_sm() { return sizeof(Fp) == 4 ? 4 : 3; }
constexpr int kPerThread = 4;      // consecutive samples of a chunk per thread

// A slot's row as a draw reads it.
struct Slot {
  int kind, nb, tab, lower;
  float fnb;             // (float)nb
  uint32_t salt;
  int strat;             // 1 for a stratified (Continuous) slot
};

// Slot f's map draw at uniform u: val's bits and the bin, as
// chain_common.cuh:map_draw forms them, without the density.
template <typename Fp>
__device__ __forceinline__ void draw(const Slot& f, const Fp* __restrict__ tab, float u,
                                     bits_t<Fp>& val, int& g) {
  const Fp* t = tab + f.tab;
  if (f.kind == kDisc) {     // t = cdf [nb+1], then dist [nb]
    g = min(count_le(t + 1, f.nb, (Fp)u), f.nb - 1);
    val = f.lower + g;
  } else {                   // t = grid [nb], then inc [nb]
    const float s = __fmul_rn(u, f.fnb);
    const int iy = min(max((int)s, 0), f.nb - 1);
    const float dy = __fsub_rn(s, (float)iy);
    g = iy;
    val = as_bits(add_rn(t[iy], mul_rn((Fp)dy, t[f.nb + iy])));
  }
}

// blockIdx.y strides over the (block, chunk) pairs, blockIdx.x over the
// thread-sized groups of a chunk's samples.
// shared memory: slot rows [S] (Slot).
template <typename Fp>
__global__ void __launch_bounds__(kThreads, blocks_per_sm<Fp>())
vplus_sample_kernel(const uint32_t* __restrict__ kd, int t0, int B, int T, int c, int S,
                    uint32_t nstrat, uint32_t mul, int shift, int vec,
                    const int* __restrict__ cube, const int* __restrict__ meta,
                    const Fp* __restrict__ tab, bits_t<Fp>* __restrict__ x,
                    int* __restrict__ gidx) {
  extern __shared__ Slot slot[];
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    const int* f = meta + kSlotFields * k;
    slot[k] = Slot{f[kKind], f[kNb], f[kTab], f[kLower], (float)f[kNb],
                   (uint32_t)f[kSalt], f[kStride] > 0};
  }
  __syncthreads();
  const int BT = B * T;
  const size_t plane = (size_t)BT * c;     // one slot's samples
  const float fns = (float)nstrat;
  const int groups = (c + kPerThread - 1) / kPerThread;
  for (int bt = blockIdx.y; bt < BT; bt += gridDim.y) {
    const int b = bt / T;
    const uint32_t t = (uint32_t)(t0 + bt - b * T);
    const uint32_t k1 = mix32(kd[2 * b] ^ (t * 0x9E3779B9u));
    const uint32_t k2 = mix32(kd[2 * b + 1] + t);
    for (int gi = blockIdx.x * blockDim.x + threadIdx.x; gi < groups;
         gi += gridDim.x * blockDim.x) {
      const int s0 = gi * kPerThread;
      const int n = min(kPerThread, c - s0);
      const bool full = vec && n == kPerThread;
      uint32_t base[kPerThread], q[kPerThread];
      if (full) {
#pragma unroll
        for (int v = 0; v < kPerThread; v += 4) {
          const int4 cb = *reinterpret_cast<const int4*>(cube + s0 + v);
          q[v] = cb.x, q[v + 1] = cb.y, q[v + 2] = cb.z, q[v + 3] = cb.w;
        }
      } else {
#pragma unroll
        for (int v = 0; v < kPerThread; ++v) q[v] = v < n ? cube[s0 + v] : 0;
      }
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) base[v] = mix32((uint32_t)(s0 + v) ^ k1) + k2;
      for (int k = 0; k < S; ++k) {
        const Slot f = slot[k];
        bits_t<Fp> val[kPerThread];
        int g[kPerThread];
#pragma unroll
        for (int v = 0; v < kPerThread; ++v) {
          float u = uniform(base[v], f.salt);
          if (f.strat) {
            const uint32_t next = divide(q[v], mul, shift);
            const int coord = (int)(q[v] - next * nstrat);
            q[v] = next;
            u = __fdiv_rn(__fadd_rn((float)coord, u), fns);
          }
          draw(f, tab, u, val[v], g[v]);
        }
        const size_t row = k * plane + (size_t)bt * c;   // slot k, chunk bt
        bits_t<Fp>* xk = x + row;
        int* gk = gidx + row;
        if (full) {
#pragma unroll
          for (int v = 0; v < kPerThread; v += 4) {
            store4(xk + s0 + v, val[v], val[v + 1], val[v + 2], val[v + 3]);
            *reinterpret_cast<int4*>(gk + s0 + v) = make_int4(g[v], g[v + 1], g[v + 2], g[v + 3]);
          }
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

template <typename Fp>
int sample_entry(const void* kd, int t0, int B, int T, int c, int S, int nstrat,
                 const void* cube, const void* meta, const void* tab, void* x, void* gidx,
                 void* stream) {
  if (B < 1 || T < 1 || c < 1 || S < 1 || nstrat < 1 || (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  uint32_t mul;
  int shift;
  divisor((uint32_t)nstrat, mul, shift);
  // 16-byte loads of cube and stores of x and gidx: every group of four
  // samples starts on a quad when c % 4 == 0
  const int vec = c % 4 == 0 && ((uintptr_t)cube | (uintptr_t)x | (uintptr_t)gidx) % 16 == 0;
  const int per_block = kThreads * kPerThread;
  long long bx = ((long long)c + per_block - 1) / per_block;
  long long by = (long long)B * T;
  if (bx > 65535) bx = 65535;
  if (by > 65535) by = 65535;
  const dim3 grid((unsigned)bx, (unsigned)by);
  const size_t smem = (size_t)S * sizeof(Slot);
  vplus_sample_kernel<Fp><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)kd, t0, B, T, c, S, (uint32_t)nstrat, mul, shift, vec,
      (const int*)cube, (const int*)meta, (const Fp*)tab, (bits_t<Fp>*)x, (int*)gidx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mci_vplus_sample(const void* kd, int t0, int B, int T, int c,
                                int S, int nstrat, const void* cube,
                                const void* meta, const void* tab, void* x,
                                void* gidx, void* stream) {
  return sample_entry<float>(kd, t0, B, T, c, S, nstrat, cube, meta, tab, x, gidx, stream);
}

// tab and x float64
extern "C" int mci_vplus_sample_f64(const void* kd, int t0, int B, int T, int c,
                                    int S, int nstrat, const void* cube,
                                    const void* meta, const void* tab, void* x,
                                    void* gidx, void* stream) {
  return sample_entry<double>(kd, t0, B, T, c, S, nstrat, cube, meta, tab, x, gidx, stream);
}
