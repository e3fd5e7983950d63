// Helpers shared by the :vegasplus kernels (vplus_*.cu).
//
// A kernel slot's row of the layout (ops/vplus_kernels.py:VplusLayout) starts
// with the fields chain_common.cuh:map_draw reads (kind, nb, tab_off, -1 for
// "no staged CDF", lower), then the slot's stride nstrat^d in the cube index
// (0 for a Discrete passenger), its leaf's offset in the histogram (-1 if
// the leaf does not adapt) and its salt in the counter hash.
#pragma once

#include "chain_common.cuh"

namespace {

constexpr int kSlotFields = 8;
constexpr int kStride = 5, kHist = 6, kSalt = 7;

// The map density of a slot at bin g (solvers/vegasplus.py:196, 210): a
// Continuous leaf's table is grid [nb], inc [nb] and rho [nb] = 1/(nb*inc),
// made once per iteration; a Discrete leaf's is cdf [nb+1] and the bins'
// masses dist [nb].
__device__ __forceinline__ float slot_rho(const int* f, const float* tab, int g) {
  const int nb = f[kNb];
  const float* t = tab + f[kTab];
  return f[kKind] == kDisc ? t[nb + 1 + g] : t[2 * nb + g];
}

}  // namespace
