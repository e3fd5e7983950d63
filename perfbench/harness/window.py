"""One process's part of a run: set-up, the measured window, the traced
calls.

The loop is closed: one caller makes ``integrate`` calls back to back, each
from fresh variable pools, ``niter`` iterations of ``neval`` evaluations
in ``block`` blocks, as a user integrating one problem does.  Call ``k`` of
the window has the seed ``seed + k``.  The window runs whole calls until
``seconds`` have passed; the call running at that moment is finished and
counted.

Set-up is everything before the window: importing the port, its kernel
library (loaded from ``build/torch_kernels/`` in the checkout, built there
by a checkout's first run), and one warm call of two iterations at the
cell's own shapes.  A traced run profiles whole calls from the steady part
of the window (:data:`PROFILED`), inside spans of its own
(``trace.spans``).  Once the window has closed and the peak is read, the
port's state is freed, so that the reference that follows on the same card
sets no peak of the port's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

PROFILED = (1, 2)        # the calls a traced run profiles
WARM_SEED_OFFSET = 2 ** 40


def _flat(values):
    return np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in values])


def answer(res) -> dict:
    """What the check holds of one ``Result``: its mean, stdev and chi2
    over every component, each iteration's estimates, and the Continuous
    variables' maps as the call left them."""
    return dict(mean=_flat(res.mean), stdev=_flat(res.stdev), chi2=_flat(res.chi2),
                it_means=[_flat(h[0]) for h in res.iterations],
                it_stds=[_flat(h[1]) for h in res.iterations], ignore=int(res.ignore),
                grids=[np.asarray(leaf.grid, np.float64) for _, leaf in res.config.var_leaves()
                       if type(leaf).__name__ == "Continuous"])


def run(cell: dict, cfg, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """Set up, run the window and, with ``trace``, profile calls
    :data:`PROFILED`; returns what the process measured."""
    marks = {"start": time.time()}
    import torch

    import mcintegration_tpu_torch as mt
    import mcintegration_tpu_torch.main as tmain

    from . import trace as tr
    marks["imported"] = time.time()

    dev = tmain._resolve_device(device, None)          # the device integrate picks
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
        marks["context"] = time.time()
        from mcintegration_tpu_torch.ops import _build
        _build.load()
        marks["kernels"] = time.time()
    integrand = cfg.port_integrand(dev)
    common = dict(solver=cell["solver"], neval=cell["neval"], block=cell["block"],
                  dtype=getattr(torch, cell.get("dtype", "float32")), verbose=-2,
                  device=device)
    mt.integrate(integrand, niter=2, seed=seed + WARM_SEED_OFFSET,
                 **common, **cfg.port_kwargs(mt, dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks["warm"] = time.time()
    t_ready = time.time()
    calls, prof, profiled_evals, profiled_iters = [], None, 0, 0
    t_start = time.perf_counter()
    k = 0
    with tr.spans() if trace else contextlib.nullcontext():
        while True:
            profiling = trace and k in PROFILED
            if profiling and prof is None:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
            kw = cfg.port_kwargs(mt, dev)
            cfg.EVALS[0] = 0
            t0 = time.perf_counter()
            if profiling:
                from torch.profiler import record_function
                with record_function(tr.CALL_SPAN):
                    res = mt.integrate(integrand, niter=cell["niter"], seed=seed + k,
                                       **common, **kw)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            else:
                res = mt.integrate(integrand, niter=cell["niter"], seed=seed + k,
                                   **common, **kw)
            t1 = time.perf_counter()
            calls.append(dict(answer(res), t0=t0, t1=t1, iter_times=list(res.iteration_times),
                              neval=int(res.neval), seen=int(cfg.EVALS[0]),
                              profiled=profiling, seed=seed + k))
            if profiling:
                profiled_evals += int(cfg.EVALS[0])
                profiled_iters += len(res.iteration_times)
                if k == max(PROFILED):
                    prof.__exit__(None, None, None)
            k += 1
            if not (t1 - t_start < seconds or (trace and k <= max(PROFILED))):
                break
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del res, kw
    tmain.clear_kernel_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks["ready"] = t_ready
    out = dict(calls=calls, t_ready=t_ready, marks=marks, peak=peak, device=str(dev),
               profile=None, profiled_evals=profiled_evals, profiled_iters=profiled_iters)
    if prof is not None:
        out["profile"] = tr.summarize(*tr.events(prof))
    return out
