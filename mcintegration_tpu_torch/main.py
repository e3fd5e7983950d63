"""``integrate`` — the user entry point of the PyTorch port.

Counterpart of ``mcintegration_tpu/main.py:214-600`` for ``solver="vegas"``,
``solver="vegasmc"``, ``solver="mcmc"`` and ``solver="vegasplus"`` and of the
reference's ``integrate`` (src/main.jl:71-218): niter rounds of (blocks -> reduce -> reweight ->
train), on one device.  Host-side per-iteration math (block statistics
src/main.jl:296-320, reweighting, grid training) runs in float64 numpy.
"""

from __future__ import annotations

import copy
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .configuration import Configuration
from .ops.rng import block_keys
from .solvers.engine import Spec, tree_map
from .solvers.mcmc import MCMCIteration
from .solvers.vegas import make_vegas_iteration
from .solvers.vegasmc import VegasMCIteration
from .solvers.vegasplus import VegasPlusIteration
from .statistics import Result, mean_std, report
from .utils import ProgressBar, StopWatch, red, yellow


def _standardize_block(neval, nblock, nworker=1):
    """Round block count to a multiple of the worker count.

    Reference: _standardize_block (src/main.jl:220-234); the port runs on
    one device, so ``nworker`` is 1.
    """
    neval = int(neval)
    nblock = int(nblock)
    if neval <= nblock:
        raise ValueError(f"neval={neval} should be larger than block={nblock}")
    if nblock > nworker:
        nblock = (nblock // nworker) * nworker
    else:
        nblock = nworker
    nevalperblock = neval // nblock
    return nevalperblock, nblock


def do_reweight(config: Configuration, gamma: float, reweight_goal):
    """Visited-count reweighting (src/main.jl:322-346)."""
    avgstep = float(np.sum(config.visited))
    for vi in range(len(config.visited)):
        v = config.visited[vi]
        if v <= 1:
            config.reweight[vi] *= avgstep**gamma
        else:
            config.reweight[vi] *= (avgstep / v) ** gamma
    if reweight_goal is not None:
        goal = np.asarray(reweight_goal, dtype=np.float64)
        config.reweight *= goal / goal.sum()
    config.reweight /= config.reweight.sum()


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run the kernels' plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to mcintegration_tpu_torch yet (ROADMAP.md, "
        f"queue 1, item {item}); mcintegration_tpu serves it")


def _check_keywords(dtype, backend, cache, parallel):
    """The reference's ``dtype``, ``backend``, ``cache`` and ``parallel``
    keywords: their defaults are served, any other value raises."""
    if dtype is not torch.float32:
        try:
            f32 = np.dtype(dtype) == np.float32
        except TypeError:
            f32 = False
        if not f32:
            _not_ported(f"dtype={dtype} (only float32)", 22)
    if backend != "auto":
        raise NotImplementedError(
            f"backend={backend!r}: mcintegration_tpu_torch has one route per device, "
            "the CUDA kernels on device='cuda' and their plain PyTorch versions on "
            "device='cpu'; pass device= instead")
    if cache is not True:
        _not_ported(f"cache={cache!r} (the kernel cache)", 17)
    if parallel != "auto":
        _not_ported(f"parallel={parallel!r} (multi-device runs)", 15)


def integrate(integrand: Callable, *,
              solver: str = "vegasmc",
              config: Optional[Configuration] = None,
              neval=1e4,
              niter: int = 10,
              block: int = 16,
              verbose: int = -1,
              gamma: float = 1.0,
              adapt: bool = True,
              debug: bool = False,
              reweight_goal=None,
              ignore: Optional[int] = None,
              measure: Optional[Callable] = None,
              measurefreq: int = 1,
              thermal_ratio: float = 0.1,
              inplace: bool = False,
              parallel: str = "auto",
              print: int = -1,  # legacy alias of verbose (src/main.jl:92-93)
              timer=None,
              mesh=None,
              nwalkers: Optional[int] = None,
              min_steps_per_walker: int = 256,
              warmup: Optional[float] = None,
              dtype=torch.float32,
              backend: str = "auto",
              cache: bool = True,
              device="cuda",
              **kwargs):
    """Calculate the integrals; returns a :class:`Result`.

    Mirrors ``mcintegration_tpu.integrate`` (and the reference keyword
    surface, src/main.jl:71-90) for ``solver="vegasmc"`` (the default) on
    ``Continuous`` and ``Discrete`` pools, for ``solver="mcmc"`` on those and
    ``FermiK`` pools, for ``solver="vegas"`` on ``Continuous`` and ``Discrete``
    pools of any ``ninc`` (the uniform route for Continuous pools of one
    ``ninc``, the mixed route of the reference's XLA path otherwise), and for
    ``solver="vegasplus"`` (or ``"vegas+"``) on ``Continuous`` pools with
    ``Discrete`` pools riding along unstratified;
    ``Continuous`` and ``Discrete`` pools may be bundled in a
    ``CompositeVar``.  ``device`` names the device explicitly: ``"cuda"``
    (the default) runs the hand-written kernels and raises when no card is
    present; ``"cpu"`` runs their plain PyTorch versions.  The integrand is
    a torch function ``f(x, c)``, or ``f(idx, x, c)`` for integrand ``idx``
    on :mcmc; ``x[k]`` is slot ``k``'s values as a tensor of any batch shape
    (int32 for a Discrete pool, ``[D, *batch]`` for a FermiK pool).
    ``nwalkers``, ``min_steps_per_walker`` and ``warmup`` (the burn-in
    fraction of each chain, default 0.01) shape the :vegasmc chains as in
    the JAX package; ``nwalkers``, ``min_steps_per_walker`` and
    ``thermal_ratio`` (burn-in steps as a fraction of the measured ones,
    default 0.1) the :mcmc chains.  A custom measure returns the
    observables' contributions, shaped like ``obs``: ``measure(x, relw, c)``
    on :vegas, :vegasmc and :vegasplus, with ``relw [N, *batch]`` the
    integrands' relative weights (``relw[0]`` reads as it does per sample),
    and ``measure(idx, x, relw, c)`` on :mcmc.  ``measurefreq = k`` measures
    a k-th of the samples on every solver: every k-th step of a chain on the
    Markov solvers, every k-th sample of a block on :vegas, and on
    :vegasplus a k-th of each chunk at positions shifted at random per
    chunk; a custom measure's output is summed over the measured samples
    only.

    Weights are float32, or complex64 with ``type=complex`` on every
    solver: the integrand may return complex values, ``|w|`` (``sqrt(re^2 +
    im^2)``) drives the chains, reweighting, histograms and hypercube
    allocation, ``relw`` reaches a custom measure as complex64, observables
    may have complex leaves, and the result's means and error bars are
    complex, real and imaginary parts estimated as independent channels
    (src/statistics.jl:24-55).

    ``dtype``, ``backend``, ``cache`` and ``parallel`` are the reference's
    keywords; the port serves their defaults (float32, ``"auto"``, True,
    ``"auto"``) and raises on any other value.  Inputs the port does not
    serve yet raise ``NotImplementedError`` naming the ROADMAP.md item that
    will port them: ``mesh`` and ``debug``.  Complex observables on a real-weight
    run raise (the reference drops their imaginary part), and FermiK pools
    raise on every solver but :mcmc, as in the reference.

    ``result.backend`` is ``"cuda"`` or ``"torch"``; ``backend_reason``
    says why, when the integrand or the measure runs per sample under
    ``torch.func.vmap``.
    """
    solver = str(solver).lstrip(":")
    if solver == "vegas+":
        solver = "vegasplus"
    if solver not in ("vegas", "vegasmc", "mcmc", "vegasplus"):
        raise ValueError(f"Solver {solver} is not supported!")
    _check_keywords(dtype, backend, cache, parallel)
    if mesh is not None:
        _not_ported("mesh (multi-device runs)", 15)
    if debug:
        _not_ported("debug=True (integrand probes)", 16)
    dev = _resolve_device(device)

    verbose = max(print, verbose)
    if config is None:
        config = Configuration(**kwargs)
    if gamma > 1.0 and verbose >= 0:
        sys.stderr.write(red("learning rate gamma should be less than 1.0") + "\n")
    if ignore is None:
        ignore = 1 if adapt else 0

    timers = list(timer) if timer is not None else []
    if verbose > 0:
        timers.append(StopWatch(verbose, lambda cfg, *_: cfg.report()))

    nevalperblock, block = _standardize_block(neval, block)
    spec = Spec(config, dev)
    if solver == "mcmc":
        it_kernel = MCMCIteration(
            spec, integrand, measure=measure, obs_proto=config.observable,
            measurefreq=measurefreq, block=block, nevalperblock=nevalperblock,
            nwalkers=nwalkers, min_steps_per_walker=min_steps_per_walker,
            thermal_ratio=thermal_ratio)
    elif solver == "vegasmc":
        it_kernel = VegasMCIteration(
            spec, integrand, measure=measure, obs_proto=config.observable,
            inplace=inplace, measurefreq=measurefreq,
            block=block, nevalperblock=nevalperblock, nwalkers=nwalkers,
            min_steps_per_walker=min_steps_per_walker,
            warmup=0.01 if warmup is None else warmup)
    elif solver == "vegasplus":
        it_kernel = VegasPlusIteration(spec, integrand, measure=measure,
                                       obs_proto=config.observable, inplace=inplace,
                                       measurefreq=measurefreq, block=block,
                                       nevalperblock=nevalperblock)
    else:
        it_kernel = make_vegas_iteration(spec, integrand, measure=measure,
                                         obs_proto=config.observable, inplace=inplace,
                                         measurefreq=measurefreq, block=block,
                                         nevalperblock=nevalperblock)
    backend_reason = it_kernel.backend_reason
    if verbose >= 0 and backend_reason:
        sys.stdout.write(yellow(f"{solver}: {backend_reason}\n"))

    progress = ProgressBar(niter * block, desc="iters x blocks: ",
                           enabled=(verbose >= -1))
    start = time.time()
    results, iter_times = [], []
    for it in range(niter):
        t_it = time.time()
        # one iteration shape whatever the timers: they are polled between
        # iterations, so a progress report never changes the numbers
        kd = block_keys(config.seed, it, 0, block)
        stats = it_kernel.run(spec.device_params(), kd)
        # ---- merge device statistics into the host config (the
        # reference's addConfig!/MPIreduceConfig!, configuration.jl:238-299)
        config.neval += stats["neval"]
        for lidx, (_, leaf) in enumerate(config.var_leaves()):
            leaf.add_statistics(stats["hists"][lidx])
        if "visited" in stats:
            config.visited += stats["visited"]
            config.propose += stats["propose"]
            config.accept += stats["accept"]

        norm_b = stats["norm_blocks"]
        if not np.all(norm_b > 0):
            raise RuntimeError(
                f"Block normalization = {norm_b.min()} is not positively defined!")
        config.normalization += float(norm_b.sum())

        # ---- block statistics (src/main.jl:275-287, 296-320) ----
        obs_sum, obs_sq = [], []
        for o in range(config.N):
            m = _divide_norm(_component(stats["obs_blocks"], o), norm_b)
            obs_sum.append(tree_map(lambda a: a.sum(axis=0), m))
            obs_sq.append(tree_map(_sq_sum_blocks, m))
        means, stds = mean_std(obs_sum, obs_sq, block)

        # ---- self-learning (src/main.jl:183-199) ----
        if solver in ("mcmc", "vegasmc"):
            do_reweight(config, gamma, reweight_goal)
        if adapt:
            for v in config.var:
                v.train()

        results.append((means, stds, _snapshot_config(config, stats["neval"])))
        iter_times.append(time.time() - t_it)
        progress.update(block, evals=stats["neval"])
        for t in timers:
            t.check(config)

    result = Result(results, ignore, config=config)
    result.backend = it_kernel.backend
    result.backend_reason = backend_reason
    result.wall_time = time.time() - start
    result.evals_per_s = result.neval / max(result.wall_time, 1e-12)
    result.iteration_times = iter_times
    if verbose >= 0:
        report(result)
        if verbose > 0:
            sys.stdout.write(yellow(
                f"Total time: {time.time() - start:.2f} seconds.\n"))
    return result


def _component(obs_blocks, o: int):
    """Integrand ``o``'s observable from the per-block observables: a pytree
    with a leading [block] axis (custom measure) or an array [block, N]."""
    if isinstance(obs_blocks, (list, tuple)):
        return obs_blocks[o]
    return np.asarray(obs_blocks)[:, o]


def _divide_norm(ob, norm_b):
    def f(a):
        a = np.asarray(a, dtype=np.complex128 if np.iscomplexobj(a) else np.float64)
        return a / norm_b.reshape((-1,) + (1,) * (a.ndim - 1))
    return tree_map(f, ob)


def _sq_sum_blocks(a):
    """Sum over blocks of the squares (complex: re and im squared apart)."""
    if np.iscomplexobj(a):
        return (a.real ** 2 + 1j * a.imag ** 2).sum(axis=0)
    return (a ** 2).sum(axis=0)


def _snapshot_config(config, iter_neval: int):
    """Full per-iteration config snapshot for the Result history.

    A deep copy of the Configuration — trained grids, reweight, tallies —
    like the reference's per-iteration deep-copied configs
    (src/main.jl:296-320).  ``neval`` is THIS iteration's eval count so
    ``Result.neval`` sums correctly.  ``userdata`` is shared by reference.
    """
    ud = config.userdata
    config.userdata = None
    try:
        snap = copy.deepcopy(config)
    finally:
        config.userdata = ud
    snap.userdata = ud
    snap.neval = int(iter_neval)
    return snap
