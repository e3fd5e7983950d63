"""The comparison that decides ``correct``.

Every ``integrate`` call of the window is an answer: an estimate of each
observable component with its error bar and reduced chi2, after ``niter``
iterations of ``neval`` evaluations, and the adapted maps it leaves.  Once
the window has closed, the plain reference (``reference/plain_vegas.py``)
integrates the problem once at the cell's own ``neval``, ``block`` and
``niter`` (:func:`reference`), and each answer is held against it and
against the configuration's exact values (``configs/<name>.py:EXACT``,
worked out by ``reference/exact.py``).  The numbers compared, each with the
limit the cell's file gives it (``workloads/<cell>.json``, ``"limits"``):

- ``z_max``: the largest |mean - exact| / stdev over every call and
  component.  A wrong draw density or Jacobian, integrand, measure, reduce
  or statistics moves the mean off the exact value by many error bars at
  these sizes; a stdev too small for the spread inflates it.
- ``z_rms``: the root mean square of those z.  A small bias on every call,
  or error bars too small by a common factor, move it before ``z_max``.
- ``evals_missing``: evaluations the answers claim (``Result.neval``) that
  the integrand did not receive, or received beyond the claim, summed over
  the calls; exact, limit 0.  Half of a launch left out shows here.
- ``stats_gap``: the largest gap between a call's mean, stdev and chi2 and
  those the reference's statistics (``plain_vegas.combine``, the law of
  MCIntegration.jl ``src/statistics.jl``) give from the call's own
  iterations; the mean's and the stdev's gap over the stdev, the chi2's
  over the larger of 1 and the chi2.  A wrong combination of the
  iterations, or a wrong chi2, shows here.
- ``chi2_median``, a lower limit: the median of every call's and
  component's reduced chi2.  The iterations' estimates scatter about their
  mean as their error bars say, so error bars overstated by a factor k
  divide it by k^2 (an understated one shows in ``z_rms``).
- ``map_gap``: the median over calls of the largest over Continuous
  variables of the mean distance between the call's trained map and the
  reference's, edge by edge, over the variable's range.  Maps left
  untrained, or trained by another law, show here.
- ``stdev_ratio``, where the cell's limits name it: the median over calls
  of the largest over components of the call's stdev over the reference's.

A call that returns a non-finite mean or stdev, or a stdev of 0, fails.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from reference import plain_vegas  # noqa: E402

REFERENCE_SEED_OFFSET = 2 ** 41      # the reference's seed, apart from every call's
LOWER = {"chi2_median"}              # numbers whose limit is a lower one


def reference(cell: dict, cfg, seed: int, device: str) -> dict:
    """One call of the plain reference at float64 at the cell's size: its
    ``mean``, ``stdev``, ``chi2`` and trained ``grids``."""
    return plain_vegas.run(cfg, neval=cell["neval"], niter=cell["niter"], block=cell["block"],
                           seed=seed + REFERENCE_SEED_OFFSET, device=device)


def call_numbers(mean, stdev, exact):
    """z of each component of one call's answer."""
    mean, stdev = np.ravel(mean).astype(np.float64), np.ravel(stdev).astype(np.float64)
    exact = np.ravel(exact).astype(np.float64)
    if mean.shape != exact.shape:
        raise ValueError(f"{mean.size} components, {exact.size} exact values")
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (mean - exact) / stdev
    return np.where(np.isfinite(z) & (stdev > 0), np.abs(z), np.inf)


def stats_gap(call) -> float:
    """How far a call's mean, stdev and chi2 lie from the reference's
    statistics of its own iterations."""
    with np.errstate(divide="ignore", invalid="ignore"):
        mean, stdev, chi2 = plain_vegas.combine(call["it_means"], call["it_stds"],
                                                call["ignore"])
        gaps = np.concatenate([np.abs(np.ravel(call["mean"]) - mean) / stdev,
                               np.abs(np.ravel(call["stdev"]) - stdev) / stdev,
                               np.abs(np.ravel(call["chi2"]) - chi2) / np.maximum(chi2, 1.0)])
    return float(np.max(np.where(np.isfinite(gaps), gaps, np.inf)))


def map_gap(grids, ref_grids) -> float:
    """The largest over variables of the mean edge-by-edge distance of two
    maps over the variable's range."""
    if len(grids) != len(ref_grids):
        return math.inf
    gaps = [np.mean(np.abs(np.asarray(g, np.float64) - r)) / (r[-1] - r[0]) if
            np.shape(g) == np.shape(r) else math.inf for g, r in zip(grids, ref_grids)]
    return float(max(gaps, default=0.0))


def judge(calls, exact, limits: dict, ref: dict = None):
    """``(correct, failed, numbers)``: ``numbers`` lists ``(name, value,
    limit)`` in a fixed order; ``calls`` are dicts with ``mean``,
    ``stdev``, ``chi2``, ``it_means``, ``it_stds``, ``ignore``, ``grids``,
    ``neval`` and ``seen`` (the integrand's evaluations); ``ref`` is
    :func:`reference`'s answer, without which the numbers held against it
    are left out."""
    z = [call_numbers(c["mean"], c["stdev"], exact) for c in calls]
    failed = sum(1 for zc in z if not np.all(np.isfinite(zc)))
    allz = np.concatenate(z) if z else np.array([np.inf])
    numbers = [
        ("z_max", float(allz.max()), limits["z_max"]),
        ("z_rms", float(math.sqrt(np.mean(allz ** 2))), limits["z_rms"]),
        ("evals_missing", int(sum(abs(int(c["neval"]) - int(c["seen"])) for c in calls)), 0),
    ]
    if calls:
        numbers += [
            ("stats_gap", max(stats_gap(c) for c in calls), limits["stats_gap"]),
            ("chi2_median", float(np.median(np.concatenate([np.ravel(c["chi2"])
                                                             for c in calls]))),
             limits["chi2_median"]),
        ]
    if calls and ref is not None:
        numbers.append(("map_gap", float(np.median([map_gap(c["grids"], ref["grids"])
                                                    for c in calls])), limits["map_gap"]))
        if "stdev_ratio" in limits:
            ratio = [np.max(np.ravel(c["stdev"]) / ref["stdev"]) for c in calls]
            numbers.append(("stdev_ratio", float(np.median(ratio)), limits["stdev_ratio"]))
    holds = all((v >= lim) if n in LOWER else (v <= lim) for n, v, lim in numbers)
    correct = bool(calls) and failed == 0 and holds
    return correct, failed, numbers


def line(numbers) -> str:
    """The numbers compared beside their limits, for standard error."""
    return "; ".join(f"{n} {v!r} ({'at least' if n in LOWER else 'limit'} {lim!r})"
                     for n, v, lim in numbers)
