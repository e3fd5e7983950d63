"""Adaptive-map (Vegas grid) math.

Host-side training math (numpy, float64, verbatim from the JAX package so
the two agree bit for bit) and the device-side inverse-CDF draw (PyTorch).
The formulas reproduce the reference semantics exactly:

- ``locate``    : bisection CDF inversion    (reference src/distribution/common.jl:8-36)
- ``smooth``    : 1:factor:1 neighbor kernel (reference src/distribution/common.jl:43-54)
- ``rescale``   : ((1-d)/log(1/d))^alpha damping (reference src/distribution/common.jl:67-100)
- ``train_grid``: equal-probability-mass grid refinement, Lepage 2021
  Eq.(20)-(22) with the reference's corrected denominator ``len(grid)-1``
  (reference src/distribution/variable.jl:206-239)
- ``sample_continuous`` : inverse-CDF Vegas-map draw, y∈[0,1) → bin
  iy=floor(y·N), linear interpolation, prob = 1/(N·Δx_iy)
  (reference src/distribution/sampler.jl:293-305)
- ``sample_discrete``   : CDF-inversion draw of a Discrete bin
  (reference src/distribution/sampler.jl:13-22)

The training functions run on the host in float64 — they are O(ninc) with
ninc≈1000, far too small to benefit from a GPU — while the sampling
primitives are plain gathers over large sample batches on device; they are
the plain versions of the chain kernel's draws (``ops/chain_kernels.py``).
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# Host-side training math (numpy, float64)
# --------------------------------------------------------------------------

def locate(accumulation: np.ndarray, p: float) -> int:
    """Index ``i`` (0-based) such that accumulation[i] <= p < accumulation[i+1].

    Bisection CDF inversion; raises if ``p`` is outside
    ``[accumulation[0], accumulation[-1])``.
    Reference: src/distribution/common.jl:8-36 (1-based).
    """
    acc = np.asarray(accumulation)
    if acc[0] > p or acc[-1] <= p:
        raise ValueError(f"{p} is not in [{acc[0]}, {acc[-1]})")
    # numpy searchsorted(side='right') returns first index with acc[idx] > p
    return int(np.searchsorted(acc, p, side="right")) - 1


def smooth(dist: np.ndarray, factor: float = 6.0) -> np.ndarray:
    """Neighbor-average smoothing with ratio 1 : factor : 1.

    Endpoints use (factor+1) : 1 weighting.
    Reference: src/distribution/common.jl:43-54.
    """
    dist = np.asarray(dist, dtype=np.float64)
    n = dist.shape[0]
    if n <= 1:
        return dist.copy()
    out = np.empty_like(dist)
    out[0] = (dist[0] * (factor + 1) + dist[1]) / (factor + 2)
    out[-1] = (dist[-1] * (factor + 1) + dist[-2]) / (factor + 2)
    if n > 2:
        out[1:-1] = (dist[:-2] + dist[1:-1] * factor + dist[2:]) / (factor + 2)
    return out


def rescale(dist: np.ndarray, alpha: float = 1.5) -> np.ndarray:
    """Damp the distribution to avoid over-reacting to outliers.

    Normalizes to sum 1, then maps d -> ((1-d)/log(1/d))^alpha for
    d <= 0.99999999 (values ≈1 are left unchanged).
    Reference: src/distribution/common.jl:67-100 (Lepage 2021 Eq.(19)).
    """
    dist = np.asarray(dist, dtype=np.float64)
    if dist.shape[0] == 1:
        return dist.copy()
    if not np.all(dist > 0):
        raise ValueError(f"distribution should be all positive and non-zero, got {dist}")
    dist = dist / dist.sum()
    mask = (dist > 0) & (dist <= 0.99999999)
    out = dist.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        out[mask] = (-(1.0 - dist[mask]) / np.log(dist[mask])) ** alpha
    if not np.all(np.isfinite(out)):
        raise ValueError(f"rescaled distribution is not finite: {out}")
    return out


def train_grid(grid: np.ndarray, histogram: np.ndarray, alpha: float,
               smooth_factor: float = 6.0) -> np.ndarray:
    """Rebuild the Vegas grid so each new increment holds equal smoothed mass.

    Vectorized inverse of the reference's sequential prefix-walk
    (src/distribution/variable.jl:206-239): the m-th interior node sits at the
    inverse CDF of m·(total/N) of the piecewise-constant smoothed+rescaled
    histogram, linearly interpolated within the source bin.  Uses the
    corrected denominator ``len(grid)-1`` (the reference notes Lepage's
    Eq.(20) denominator is wrong, variable.jl:224-226).
    """
    grid = np.asarray(grid, dtype=np.float64)
    hist = np.asarray(histogram, dtype=np.float64)
    ninc = grid.shape[0] - 1
    assert hist.shape[0] == ninc, (hist.shape, grid.shape)
    if not np.all(np.isfinite(hist)):
        raise ValueError("histogram should be all finite")
    if not np.all(hist > 0):
        raise ValueError("histogram should be all positive and non-zero")

    avg_f = rescale(smooth(hist, smooth_factor), alpha)
    cum = np.cumsum(avg_f)
    f_ninc = cum[-1] / ninc

    targets = f_ninc * np.arange(1, ninc, dtype=np.float64)
    # first bin j (0-based) with cum[j] >= target  (the reference's
    # `while acc_f < f_ninc` strict-inequality walk)
    j = np.searchsorted(cum, targets, side="left")
    j = np.minimum(j, ninc - 1)
    excess = cum[j] - targets  # == acc_f after the reference subtracts f_ninc
    newgrid = np.empty_like(grid)
    newgrid[0] = grid[0]
    newgrid[-1] = grid[-1]
    newgrid[1:-1] = grid[j + 1] - (excess / avg_f[j]) * (grid[j + 1] - grid[j])
    return newgrid


def train_discrete(histogram: np.ndarray, alpha: float):
    """Rebuild a discrete distribution + CDF from its histogram.

    Returns (distribution, accumulation) with accumulation[0]=0,
    accumulation[-1]=1.  Reference: src/distribution/variable.jl:369-382.
    """
    dist = rescale(np.asarray(histogram, dtype=np.float64), alpha)
    dist = dist / dist.sum()
    acc = np.concatenate([[0.0], np.cumsum(dist)])
    acc[-1] = 1.0
    return dist, acc


def build_cdf(distribution: np.ndarray):
    """Normalize a non-negative distribution and build its CDF (length K+1)."""
    dist = np.asarray(distribution, dtype=np.float64)
    assert np.all(dist >= 0), "distribution should be all non-negative"
    dist = dist / dist.sum()
    acc = np.concatenate([[0.0], np.cumsum(dist)])
    acc[-1] = 1.0
    return dist, acc


# --------------------------------------------------------------------------
# Device-side sampling primitive (PyTorch, batched)
# --------------------------------------------------------------------------

def sample_continuous(y: torch.Tensor, grid: torch.Tensor, inc: torch.Tensor):
    """Vegas-map inverse-CDF draw for a batch of uniforms ``y`` ∈ [0,1).

    Returns ``(x, gidx, prob)`` where ``prob = 1/(N·Δx_iy)`` is the sampling
    density (inverse Jacobian).  Reference: src/distribution/sampler.jl:293-305.

    ``inc`` [N] = grid[1:] - grid[:-1], precomputed in float64 on the host
    and cast, so adjacent-node cancellation never happens in float32;
    ``grid`` has shape [N+1] or [N] (only its first N nodes are read).  The
    per-bin lookup is a plain gather.
    """
    n = inc.shape[0]
    t = y * n
    iy = torch.clamp(t.to(torch.int32), 0, n - 1)
    dy = t - iy.to(t.dtype)
    dx = inc[iy.long()]
    x = grid[iy.long()] + dy * dx
    prob = 1.0 / (n * dx)
    return x, iy, prob


def sample_discrete(u: torch.Tensor, cdf: torch.Tensor, dist: torch.Tensor):
    """Discrete draw by CDF inversion for a batch of uniforms ``u``.

    ``gidx = #{k: u >= cdf[k+1]}`` (``mcintegration_tpu/ops/grid.py:
    sample_discrete_cdf``, reference sampler.jl:13-22), found by a binary
    search over the non-decreasing ``cdf [nbin+1]``, then clamped into the
    last real bin: when float32 rounding leaves ``cdf[nbin] < 1``, a ``u``
    above it would otherwise index past the table
    (``pallas_chain.py:137-144``).  Returns ``(gidx, prob)`` with gidx int32
    (value = lower + gidx) and ``prob = dist[gidx]``, the bin's mass.
    """
    nbin = dist.shape[0]
    gidx = torch.searchsorted(cdf[1:], u, right=True).clamp_(max=nbin - 1)
    return gidx.to(torch.int32), dist[gidx]
