"""The FermiK momentum shell in plain tensor arithmetic.

Counterparts of the FermiK branches of
``mcintegration_tpu/ops/pallas_mcmc.py:build_mcmc_run_all`` (the draw,
lines 732-751; the density, 668-687; the three-way shift, 689-724), which
follow ``Dist.FermiK`` (sampler.jl:109-244).  A value is ``[D, *batch]``
float32 (D = 2 or 3 components).

Every function is a fixed sequence of float32 operations on float32
tensors: ``csrc/mcmc_common.cuh`` computes the same sequence with ``_rn``
intrinsics under ``--fmad=false``, so the kernels and these functions agree
bit for bit, on the CPU as on the card.  That is why sine and cosine are
the polynomial ``sincos_turns`` here and not ``torch.sin``: a library's
``sinf`` is not correctly rounded and differs between devices.  Constants
are float32 values (``f32``), so a product or sum rounds once whatever
precision a backend computes it in.

The leaf's constants come from :func:`constants`, rounded to float32 from
float64 once, as the TPU kernel folds ``float(leaf.kF)`` into its trace.
"""

from __future__ import annotations

import numpy as np
import torch

FK_FIELDS = 6               # kF, 2 dk, jacobian constant, kF - dk, kF + dk, dk
DENS_FLOOR = 1e-30          # common.DENS_FLOOR_F32
LAMBDA = 1.5                # radial scale range [1/lambda, lambda] (sampler.jl:196)


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


TWO_PI = f32(2.0 * np.pi)
_S = (f32(-1.6666654611e-1), f32(8.3321608736e-3), f32(-1.9515295891e-4))
_C = (f32(4.166664568298827e-2), f32(-1.388731625493765e-3), f32(2.443315711809948e-5))
INV_LAMBDA = f32(1.0 / LAMBDA)
LAMBDA_SPAN = f32(LAMBDA - 1.0 / LAMBDA)
THIRD, TWO_THIRDS = f32(1.0 / 3.0), f32(2.0 / 3.0)
DENS_FLOOR_F = f32(DENS_FLOOR)
TINY = f32(1e-38)


def constants(kF: float, dk: float, dim: int) -> np.ndarray:
    """The float32 constants of a leaf: kF, 2 dk, the shell Jacobian's
    constant (4 pi^2 dk in 3-D, 4 pi dk in 2-D), kF - dk, kF + dk, dk."""
    jac = 4 * np.pi * np.pi * dk if dim == 3 else 4 * np.pi * dk
    return np.asarray([kF, 2.0 * dk, jac, kF - dk, kF + dk, dk], np.float32)


def sincos_turns(t: torch.Tensor):
    """``(sin(2 pi t), cos(2 pi t))`` for float32 ``t`` in [0, 1].

    Reduction to the nearest quarter turn is exact (``t - q/4``), then
    cephes' single-precision minimax polynomials on [-pi/4, pi/4] (about
    1 ulp) and the quadrant's symmetry."""
    q = torch.floor(t * 4.0 + 0.5)
    x = (t - q * 0.25) * TWO_PI
    z = x * x
    s = (((_S[2] * z + _S[1]) * z + _S[0]) * z) * x + x
    c = ((((_C[2] * z + _C[1]) * z + _C[0]) * z) * z - z * 0.5) + 1.0
    k = q.to(torch.int32) & 3
    sin = torch.where(k == 0, s, torch.where(k == 1, c, torch.where(k == 2, -s, -c)))
    cos = torch.where(k == 0, c, torch.where(k == 1, -s, torch.where(k == 2, -c, s)))
    return sin, cos


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as CUDA's ``__fsqrt_rn``:
    torch's vectorised float32 ``sqrt`` on the CPU is off by an ulp on about
    one value in 160; through float64 the result rounds once."""
    return torch.sqrt(x.double()).float()


def fermik_draw(u0, u1, u2, const, dim: int):
    """Fresh draw in the shell from three uniforms (u2 unused in 2-D):
    ``(value [D, *batch], prob)``; prob is 0 where kamp <= 0 (a reject)."""
    kF, two_dk, jac_c = (f32(c) for c in const[:3])
    kamp = (u0 - 0.5) * two_dk + kF
    sp, cp = sincos_turns(u1)
    if dim == 3:
        st, ct = sincos_turns(u2 * 0.5)           # theta = pi * u2
        value = torch.stack([kamp * cp * st, kamp * sp * st, kamp * ct])
        jac = st * jac_c * kamp * kamp
    else:
        value = torch.stack([kamp * cp, kamp * sp])
        jac = kamp * jac_c
    prob = torch.where(kamp <= 0.0, 0.0, 1.0 / torch.clamp(jac, min=DENS_FLOOR_F))
    return value, prob


def _norm(value):
    k2 = value[0] * value[0]
    for c in value[1:]:
        k2 = k2 + c * c
    return sqrt(k2)


def fermik_density(value, const, dim: int):
    """Shell density of a stored value (0 outside |K| in (kF-dk, kF+dk))."""
    jac_c, lo, hi = (f32(c) for c in const[2:5])
    kamp = _norm(value)
    ok = (kamp > lo) & (kamp < hi)
    if dim == 3:
        rho = sqrt(value[0] * value[0] + value[1] * value[1])
        sin_t = rho / torch.clamp(kamp, min=DENS_FLOOR_F)
        ok = ok & (sin_t >= f32(1e-15))
        jac = sin_t * jac_c * kamp * kamp
    else:
        jac = kamp * jac_c
    return torch.where(ok, 1.0 / torch.clamp(jac, min=DENS_FLOOR_F), 0.0)


def fermik_shift(value, sel, u1, u2, uj, const, dim: int):
    """The three-way changeVariable move of a stored value: a radial scale
    (sel < 1/3), a re-orientation at fixed |K| (sel < 2/3), else a jitter
    of each component by ``(uj[c] - 0.5) * dk``.  Returns ``(new value,
    Hastings factor)``: the scale ratio in 3-D, else 1."""
    dk = f32(const[5])
    ratio = u1 * LAMBDA_SPAN + INV_LAMBDA
    kamp = _norm(value)
    sp, cp = sincos_turns(u1)
    if dim == 3:
        ct = torch.clamp(1.0 - u2 * 2.0, -1.0, 1.0)
        st = sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        rot = [kamp * cp * st, kamp * sp * st, kamp * ct]
        prop_scale = ratio
    else:
        rot = [kamp * cp, kamp * sp]
        prop_scale = torch.ones_like(ratio)
    b1 = sel < THIRD
    b2 = ~b1 & (sel < TWO_THIRDS)
    new = [torch.where(b1, value[c] * ratio,
                       torch.where(b2, rot[c], value[c] + (uj[c] - 0.5) * dk))
           for c in range(dim)]
    return torch.stack(new), torch.where(b1, prop_scale, 1.0)
