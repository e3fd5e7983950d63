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
    import torch

    idx = torch.as_tensor(idx)
    ref = idx
    if like is not None and torch.as_tensor(like).ndim > idx.ndim:
        ref = torch.as_tensor(like)
    rng = torch.arange(int(lo), int(hi) + 1, device=idx.device)
    oh = (rng.reshape((-1,) + (1,) * ref.ndim) == idx).expand(
        (rng.numel(),) + tuple(ref.shape))
    return oh.to(dtype) if dtype is not None else oh
