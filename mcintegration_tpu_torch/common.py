"""Shared constants and small helpers.

Counterparts in the reference implementation (MCIntegration.jl):
- ``TINY``/``EPSILON`` constants: MCIntegration.jl, src/MCIntegration.jl:10-12.

The framework splits math across two precision domains:

- **Host domain** (numpy, float64): everything sequential and tiny — grid
  training, reweighting, per-iteration statistics, chi^2 pooling.  This is
  where the reference's accuracy-sensitive scalar math lives, and float64 is
  free on the host.
- **Device domain** (PyTorch, float32 samples and weights): the
  embarrassingly parallel sampling / integrand-evaluation path.  Block and
  histogram sums accumulate in float64, so float32 block sums at 1e8+
  samples lose no precision and no compensated summation is needed.
"""

from __future__ import annotations

import numpy as np
import torch

# Reference: TINY = eps(Float64(0)) * 1e50 ≈ 4.94e-274 (MCIntegration.jl:11)
# used as a *positive* floor for probabilities on the host side.
# eps(Float64(0)) is the smallest subnormal (5e-324 = np.nextafter(0, 1)).
TINY = float(np.nextafter(np.float64(0.0), np.float64(1.0)) * 1e50)
assert TINY > 0.0  # a zero floor would make every `p > TINY` guard a no-op
EPSILON = np.finfo(np.float64).eps

# Device-side float32 floors.  The reference floors float64 probabilities
# at TINY ≈ 4.94e-274 (MCIntegration.jl:11) — vanishingly small but
# positive.  In the float32 device domain the equivalent probability floor
# sits just above the smallest normal (1.18e-38); density denominators
# (1/prob Jacobians) use a larger guard so the reciprocal cannot overflow.
TINY_F32 = 1e-38        # probability floor in Metropolis accept guards
DENS_FLOOR_F32 = 1e-30  # denominator guard for 1/density Jacobians

# Default pool size, mirrors Dist.MaxOrder (distribution.jl).
MAX_ORDER = 16


def asarray_f64(x):
    return np.asarray(x, dtype=np.float64)


def onehot(idx, lo, hi, dtype=None, *, like=None):
    """Batch-safe one-hot over an inclusive integer range [lo, hi].

    The canonical custom-measure pattern scatters a sample's contribution
    into an observable bin chosen by a Discrete variable (the reference
    writes ``obs[ext] += weight``, e.g. test/bubble.jl:63-66).  Written as
    ``(torch.arange(lo, hi+1) == ext) * relw`` that only broadcasts when
    ``ext`` is a per-sample scalar; on batched sample tensors the leading
    bin axis must be prepended instead.  This helper inserts trailing
    singleton axes to match the batch rank of ``idx`` (or of ``like=relw``
    when ``idx`` is a scalar, e.g. the integrand index), so the same
    measure code is correct per-sample AND batched.
    """
    idx = torch.as_tensor(idx)
    ref = idx
    if like is not None and torch.as_tensor(like).ndim > idx.ndim:
        ref = torch.as_tensor(like)
    rng = torch.arange(int(lo), int(hi) + 1, device=idx.device)
    oh = (rng.reshape((-1,) + (1,) * ref.ndim) == idx).expand(
        (rng.numel(),) + tuple(ref.shape))
    return oh.to(dtype) if dtype is not None else oh


# ----------------------------------------------------------------------
# weight algebra over float32 or complex64 weights, as the kernels form it
# (csrc/chain_common.cuh: Weight): a complex weight is an (re, im) pair of
# float32, and every operation is written out on the pair
# (pallas_chain.py:459-471, pallas_mcmc.py:526-551)
# ----------------------------------------------------------------------

def finite_guard(w: torch.Tensor) -> torch.Tensor:
    """Zero out non-finite integrand values.

    In float32 a singular integrand can overflow to inf within ~1 ulp of its
    singular point; an inf/NaN weight would poison every accumulator.  The
    zeroed region is O(ulp)-measure, far below the statistical error.  A
    complex value is kept only if both parts are finite (``torch.isfinite``
    of a complex tensor; ``mcintegration_tpu/solvers/engine.py:260-271``).
    The :vegas and :vegasplus kernels guard each weight as they load it
    (``csrc/real.cuh``: ``finite_or_zero``) and their plain versions call
    this on ``w``; the Markov solvers call it on the integrand's output.
    """
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def weight_abs(w: torch.Tensor) -> torch.Tensor:
    """``|w|``: a real weight's ``abs``; a complex weight's ``sqrt(re*re +
    im*im)``, correctly rounded as ``__fsqrt_rn`` (through float64, which
    rounds once), not ``torch.abs``' hypot."""
    if not w.is_complex():
        return torch.abs(w)
    re, im = torch.view_as_real(w).unbind(-1)
    return torch.sqrt((re * re + im * im).double()).float()


def weight_abs2(w: torch.Tensor) -> torch.Tensor:
    """``|w|^2`` with no square root: ``w*w``, or ``re*re + im*im``."""
    if not w.is_complex():
        return w * w
    re, im = torch.view_as_real(w).unbind(-1)
    return re * re + im * im


def weight_parts(w: torch.Tensor):
    """A weight's real components: ``(w,)``, or the real and imaginary
    parts of a complex one (the default observables' components ``2i`` and
    ``2i+1``)."""
    return torch.view_as_real(w).unbind(-1) if w.is_complex() else (w,)


def weight_scale(w: torch.Tensor, f) -> torch.Tensor:
    """``w*f`` for a real factor ``f``; a complex weight scales each part
    alone (a complex product would add ``im*0`` terms, which can flip the
    sign of a zero), by ``f`` rounded to float32: complex weights stay
    complex64 at float64, and the reference casts the factor to their dtype
    (``mcintegration_tpu/solvers/vegas.py:324``)."""
    if not w.is_complex():
        return w * f
    f = f.to(torch.float32)[..., None] if isinstance(f, torch.Tensor) else f
    return torch.view_as_complex(torch.view_as_real(w) * f)
