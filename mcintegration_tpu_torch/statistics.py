"""Result container and cross-iteration statistics.

Counterpart of ``mcintegration_tpu/statistics.py`` (numpy, near verbatim).
Reproduces the reference's statistics layer (MCIntegration.jl, src/statistics.jl):

- ``Result``: inverse-variance-weighted mean across iterations, skipping the
  first ``ignore`` iterations, with per-integral reduced chi^2
  (statistics.jl:16-63, 186-220);
- complex observables are treated as independent real/imag channels
  (statistics.jl:207-214);
- ``mean_std``: per-iteration block statistics — mean over ``block``
  independent estimates and stderr of the mean (src/main.jl:296-320);
- error strings formatted to 2 significant digits of the stderr
  (statistics.jl:74-102).

All of this is host-side float64 numpy — it is O(niter x N) scalar math.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np

from .utils.color import green, yellow


# ----------------------------------------------------------------------
# per-iteration block statistics (reference src/main.jl:296-320)
# ----------------------------------------------------------------------

def mean_std(obs_sum, obs_squared_sum, block: int):
    """Block-average mean and stderr-of-mean for each observable component.

    ``obs_sum[o]`` is the sum over blocks of (obs/normalization) and
    ``obs_squared_sum[o]`` the sum of elementwise squares (complex: re and im
    squared independently, stored as re + im*1j).
    """
    def _sqrt(x):
        return np.sqrt(np.maximum(x, 0.0))

    means, stds = [], []
    for osum, osq in zip(obs_sum, obs_squared_sum):
        osum = np.asarray(osum)
        osq = np.asarray(osq)
        m = osum / block
        if block > 1:
            if np.iscomplexobj(osq):
                r_std = _sqrt((osq.real / block - m.real**2) / (block - 1))
                i_std = _sqrt((osq.imag / block - m.imag**2) / (block - 1))
                s = r_std + 1j * i_std
            else:
                s = _sqrt((osq / block - m**2) / (block - 1))
        else:
            s = np.zeros_like(osq)
        means.append(m)
        stds.append(s)
    return means, stds


# ----------------------------------------------------------------------
# cross-iteration weighted average (reference statistics.jl:186-220)
# ----------------------------------------------------------------------

def average(history, idx: int, init: int = 0, max_iter: Optional[int] = None):
    """Inverse-variance-weighted average of history[init:max_iter] for
    integral ``idx``.  Returns (mean, err, reduced_chi2), elementwise for
    array observables; complex handled as independent re/im channels.

    ``history`` is a list of (means, stds, config) tuples; indices 0-based
    (the reference is 1-based, statistics.jl:186).
    """
    if max_iter is None:
        max_iter = len(history)
    assert max_iter > 0
    if max_iter <= init + 1:
        m = np.asarray(history[init if init < len(history) else 0][0][idx])
        e = np.asarray(history[init if init < len(history) else 0][1][idx])
        return m, e, np.zeros_like(m)

    nsample = max_iter - init

    def _stat(data, weight):
        wsum = sum(weight)
        mea = sum(d * w for d, w in zip(data, weight)) / wsum
        err = 1.0 / np.sqrt(wsum)
        chi2 = sum(w * (d - mea) ** 2 for d, w in zip(data, weight))
        return mea, err, chi2 / (nsample - 1)

    sample = np.asarray(history[max_iter - 1][0][idx])
    if np.iscomplexobj(sample):
        dataR = [np.asarray(history[i][0][idx]).real for i in range(init, max_iter)]
        dataI = [np.asarray(history[i][0][idx]).imag for i in range(init, max_iter)]
        wR = [1.0 / (np.asarray(history[i][1][idx]).real + 1e-10) ** 2 for i in range(init, max_iter)]
        wI = [1.0 / (np.asarray(history[i][1][idx]).imag + 1e-10) ** 2 for i in range(init, max_iter)]
        mR, eR, cR = _stat(dataR, wR)
        mI, eI, cI = _stat(dataI, wI)
        return mR + 1j * mI, eR + 1j * eI, cR + 1j * cI
    data = [np.asarray(history[i][0][idx]) for i in range(init, max_iter)]
    weight = [1.0 / (np.asarray(history[i][1][idx]) + 1e-10) ** 2 for i in range(init, max_iter)]
    return _stat(data, weight)


# ----------------------------------------------------------------------
# error-string formatting (reference statistics.jl:74-102)
# ----------------------------------------------------------------------

def sig_digits(err: float) -> int:
    if err == 0 or not math.isfinite(err):
        return 0
    return max(0, 2 - int(math.floor(math.log10(abs(err)))))


def tostring(mval, merr, pm="±") -> str:
    if np.iscomplexobj(np.asarray(mval)):
        re = tostring(np.real(mval), np.real(merr), pm)
        im = tostring(np.imag(mval), np.imag(merr), pm)
        return f"({re}) + ({im})im"
    mval = float(np.asarray(mval).reshape(-1)[0]) if np.ndim(mval) else float(mval)
    merr = float(np.asarray(merr).reshape(-1)[0]) if np.ndim(merr) else float(merr)
    if math.isfinite(mval) and math.isfinite(merr):
        nd = sig_digits(merr)
        return f"{mval:.{nd}f} {pm} {merr:.{nd}f}"
    return f"{mval} {pm} {merr}"


# ----------------------------------------------------------------------
# Result (reference statistics.jl:16-63)
# ----------------------------------------------------------------------

class Result:
    """The returned result of an MC integration.

    Members mirror the reference ``Result{O,C}``: ``mean``, ``stdev``,
    ``chi2`` (reduced), ``neval``, ``ignore``, ``config`` and the full
    per-iteration ``iterations`` history.

    Port extensions: ``backend`` records which compute path produced the
    result ('cuda' = the hand-written kernels ran, 'torch' = their plain
    PyTorch versions on the CPU, None = constructed outside ``integrate``);
    ``backend_reason`` is a one-line note when the integrand runs under
    ``torch.func.vmap`` instead of batched.  ``wall_time`` (seconds),
    ``evals_per_s`` and ``iteration_times`` (seconds per iteration) record
    the timing of the producing ``integrate`` call; the first iteration
    includes the kernels' build on a first call.
    """

    backend = None          # set by integrate()
    backend_reason = ""
    wall_time = None
    evals_per_s = None
    iteration_times = None

    def __init__(self, history_or_result, ignore: int = 0, config=None):
        if isinstance(history_or_result, Result):
            prev = history_or_result
            if ignore == prev.ignore:
                self.__dict__.update(prev.__dict__)
                return
            if config is None:
                config = prev.config
            self.backend = prev.backend
            self.backend_reason = prev.backend_reason
            self.wall_time = prev.wall_time
            self.evals_per_s = prev.evals_per_s
            self.iteration_times = prev.iteration_times
            history_or_result = prev.iterations
        history = list(history_or_result)
        assert len(history) > 0
        init = ignore
        self.config = config if config is not None else history[-1][2]
        self.neval = sum(h[2].neval for h in history)
        self.ignore = ignore
        self.iterations = history
        n = len(history[-1][0])
        res = [average(history, o, init=init, max_iter=len(history)) for o in range(n)]
        self.mean = [r[0] for r in res]
        self.stdev = [r[1] for r in res]
        self.chi2 = [r[2] for r in res]

    def dof(self) -> int:
        return len(self.iterations) - self.ignore - 1

    def __getitem__(self, idx: int):
        return self.mean[idx], self.stdev[idx], self.chi2[idx]

    def __repr__(self):
        out = []
        for i in range(self.config.N):
            m = np.asarray(self.mean[i]).reshape(-1)[0]
            e = np.asarray(self.stdev[i]).reshape(-1)[0]
            c = np.asarray(self.chi2[i]).reshape(-1)[0]
            if self.dof() == 0:
                out.append(green(f"Integral {i} = {m} ± {e}"))
            else:
                out.append(green(
                    f"Integral {i} = {m} ± {e}   (reduced chi2 = {_round3(c)})"))
        return "\n".join(out)


def _round3(c):
    c = complex(c) if np.iscomplexobj(np.asarray(c)) else float(np.real(c))
    if isinstance(c, complex):
        return c
    if c == 0 or not math.isfinite(c):
        return c
    from decimal import Decimal
    return float(f"{c:.3g}")


def report(result, ignore: Optional[int] = None, pick=None, name=None,
           verbose: int = 0, io=None):
    """Print the iteration-history table with running weighted average and
    reduced chi^2 (reference statistics.jl:137-172)."""
    import sys
    io = io or sys.stdout
    if isinstance(result, Result):
        if ignore is None:
            ignore = result.ignore
        if pick is None:
            pick = lambda obs: np.asarray(obs).reshape(-1)[0]
        for i in range(result.config.N):
            info = f"{i}" if name is None else f"{name[i]}"
            if verbose >= 0:
                barbar = "=" * 48 + f"     Integral {info}    " + "=" * 48
                bar = "-" * len(barbar)
                print(barbar, file=io)
                print(yellow(f"{'iter':>6s}          {'integral':^32s} "
                             f"{'wgt average':^36s} {'reduced chi2':>16s}"), file=io)
                print(bar, file=io)
                for it in range(len(result.iterations)):
                    m0 = pick(result.iterations[it][0][i])
                    e0 = pick(result.iterations[it][1][i])
                    m, e, chi2 = average(result.iterations, i, init=ignore,
                                         max_iter=it + 1)
                    m, e, chi2 = pick(m), pick(e), pick(chi2)
                    iterstr = "ignore" if it < ignore else f"{it + 1}"
                    print(f"{iterstr:>6s} {tostring(m0, e0):>36s} "
                          f"{tostring(m, e):>36s} {abs(chi2):16.4f}", file=io)
                print(bar, file=io)
            else:
                m, e, c = pick(result.mean[i]), pick(result.stdev[i]), pick(result.chi2[i])
                print(green(f"Integral {info} = {m} ± {e}   "
                            f"(reduced chi2 = {_round3(c)})"), file=io)
        return None
    # a Configuration
    return result.report()
